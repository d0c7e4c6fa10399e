"""Vertex partitioning (paper §III/§IV).

Partitions are contiguous vertex-ID ranges: node v belongs to partition
``v // part_size`` — identical to the paper's ``u/m`` binning. The
partition size is the cache-residency knob: at the paper's 65536 nodes a
d = 1 float32 partition accumulator is 256 KB.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partitioning:
    num_nodes: int
    part_size: int

    @property
    def num_partitions(self) -> int:
        return -(-self.num_nodes // self.part_size)

    @property
    def padded_nodes(self) -> int:
        return self.num_partitions * self.part_size

    def part_of(self, node_ids: np.ndarray) -> np.ndarray:
        return node_ids // self.part_size

    def local_of(self, node_ids: np.ndarray) -> np.ndarray:
        return node_ids % self.part_size


def partition_for_vmem(num_nodes: int, *, value_bytes: int = 4,
                       vmem_budget_bytes: int = 8 * 2 ** 20) -> Partitioning:
    """Pick the largest power-of-two partition size whose rank
    accumulator fits the budget (the paper's 256 KB LLC heuristic; the
    JAX package scales it to a TPU core's VMEM, and the same budget
    gives the same ``Partitioning`` here). On the card, kernel B1's
    tile size comes from shared memory instead
    (``kernels/pcpm_spmv/ops.py::tile_size``).
    """
    part = 1 << max(8, (vmem_budget_bytes // value_bytes).bit_length() - 1)
    part = min(part, max(256, 1 << (num_nodes - 1).bit_length()))
    return Partitioning(num_nodes, part)

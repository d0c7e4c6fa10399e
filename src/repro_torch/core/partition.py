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

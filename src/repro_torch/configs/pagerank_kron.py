"""The paper's own workload: PageRank on the Graph500 kron graph
(scale 25, |E| ~ 1.07e9, partition size 256 KB = 64K nodes).

A copy of the JAX package's ``configs/pagerank_kron.py``: the port imports
nothing of that package."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    name: str = "pagerank-kron"
    family: str = "pagerank"
    scale: int = 25
    edge_factor: int = 31
    part_size: int = 65536           # 256 KB / 4 B values (paper VI-C)
    method: str = "pcpm"
    num_iterations: int = 20
    damping: float = 0.85

    def scaled(self, scale: int = 12, edge_factor: int = 8,
               part_size: int = 512):
        return dataclasses.replace(
            self, name=self.name + "-smoke", scale=scale,
            edge_factor=edge_factor, part_size=part_size)


CONFIG = PageRankConfig()

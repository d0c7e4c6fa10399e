"""GraphCast encoder-processor-decoder mesh GNN [arXiv:2212.12794]."""
from .base import GNNConfig, register

CONFIG = GNNConfig(
    name="graphcast", n_layers=16, d_hidden=512, flavor="mpnn",
    mesh_refinement=6, aggregator="sum", n_vars=227,
    source="arXiv:2212.12794")
register(CONFIG)

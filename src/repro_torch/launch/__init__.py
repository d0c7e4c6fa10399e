"""Launchers of the port: ``python -m repro_torch.launch.train`` trains an
LM on one card, and ``launch.specs`` gives each (architecture, shape)
cell's model flops, layer trip count and skip reason.

The card's peaks, for rooflines and model-flops shares: NVIDIA's
datasheet for the H100 80GB HBM3 (SXM5, 700 W). They are not
measurements. The reference's mesh constructors, sharding rules and
interconnect rates (``make_production_mesh``, ``make_host_mesh``,
``sharding``, ``ICI_BW_PER_LINK``, ``DCN_BW``) are left to the TPU
(README.md, "Left to the TPU").
"""
PEAK_FLOPS_BF16 = 989e12        # dense bfloat16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
HBM_BYTES = 80e9                # HBM3 capacity, bytes

__all__ = ["PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES"]

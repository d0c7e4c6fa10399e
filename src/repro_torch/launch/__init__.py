"""Launchers of the port: ``python -m repro_torch.launch.train`` trains an
LM on one card. The JAX package's mesh constructors, sharding rules and
TPU constants (``make_production_mesh``, ``sharding``, ...) have no
counterpart yet (ROADMAP.md, A11.5)."""

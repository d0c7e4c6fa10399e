"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``bench/run.py`` runs one cell of ``BENCHMARK.json`` once. Everything a
cell needs is found by name: its configuration in
``bench/configs/<config>.json``, its traffic mix in
``bench/traffic/<traffic>.json`` (run by ``bench/loadgen/<loadgen>.py``),
its graph by ``bench/gen/<generator>.py`` and every metric by a reader
``bench/metrics/<metric>.py``. A new configuration, mix or metric is new
files and new entries, never an edit. Nothing here imports ``jax`` or
the JAX package; the plain reference (``bench/reference/``) imports
nothing of ``repro_torch`` either.
"""

"""The benchmark of the PyTorch and CUDA port (``tpu_cc_manager_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
one JSON line. Everything is found by name: a cell's configuration in
``configs/``, its traffic mix in ``traffic/<traffic>.json``, the driver
that mix names in ``drivers/<driver>.py``, each per-layer metric's reader
in ``metrics/<metric>.py``, each kernel's cost in ``costs/`` and the
cell's limits in ``limits/<cell>.json``. The plain float32 reference is
``reference/<family>.py``. Nothing here imports ``jax`` or the JAX package.
"""

"""The node bench of the port: copies of the repository's ``bench.py``
(drain→CC-on→ready through the real pipeline, the spare prestage flip, the
drain handshake's cost, cold vs warm smoke across a bounce),
``bench_ab.py`` (the CC-off/on A/B) and ``hack/smoke_cache_bench.py``,
each run as ``python -m tpu_cc_manager_torch.bench.<name>``."""

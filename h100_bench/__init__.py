"""The H100 benchmark of the PyTorch port: one cell run once per call.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``configs/<config>.json``,
``workloads/<cell>.json``, ``drivers/<driver>.py`` and, for each per-layer
metric of ``BENCHMARK.json``, ``metrics/<metric>.py``.  ``reference/`` holds
the plain PyTorch versions that decide ``correct``; ``common/`` the traffic
generators, the operation and byte counts, the peaks and the trace reduction.
"""

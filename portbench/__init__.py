"""The benchmark of ``amg_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Cells, configurations, traffic mixes and per-layer metrics are
data: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``drivers/<driver>.py`` and
``operators/<kind>.py``, found by the names that ``BENCHMARK.json`` and
the configurations give. The plain reference that decides
``correct`` is ``reference/``.
"""

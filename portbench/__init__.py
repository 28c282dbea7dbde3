"""The benchmark of ``mmlspark_tpu_torch`` on one NVIDIA card.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell
needs is found by name: its configuration file, ``traffic/<mix>.json``,
``drivers/<kind>.py``, ``datasets/<kind>.py``, ``reference/<kind>.py``,
``metrics/<metric>.py`` and ``work/<kernel>.py``.
"""

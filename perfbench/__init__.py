"""The benchmark of the PyTorch/H100 port (``climsr_tpu_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything a cell is made of is found by
name: its configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json`` (whose ``entry`` names the module under
``entries/``), each per-layer metric's reader in ``metrics/<name>.py`` and the
limits of its correctness check in ``limits/<cell>.json``. The plain
reference that decides ``correct`` lives under ``reference/`` and imports
nothing of the port.
"""

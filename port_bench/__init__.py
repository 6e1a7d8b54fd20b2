"""The benchmark of the PyTorch/CUDA port (``dasr_tpu_torch``) on NVIDIA
H100s, driven by ``BENCHMARK.json`` at the checkout's root.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is found by its name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``), its traffic kind
(``traffic/<kind>.py``) with that kind's parameters, and the limits of its
comparison; each per-layer metric is read by ``metrics/<metric>.py``. A new
cell, configuration or metric is a new file. ``reference/`` holds the plain
PyTorch reference and the cost arithmetic, frozen; ``controls.py`` reads
the numbers that the limits were set from. The CPU tests:
``python -m pytest port_bench/tests``; on a card, ``-m cuda`` runs the
control at a cell's own size.
"""

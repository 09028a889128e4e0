"""The benchmark of the PyTorch and CUDA port (``livelyspeaker_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Everything that belongs to one configuration, one
traffic mix or one per-layer quantity is a file of its own under
``benchmark/configs``, ``benchmark/workloads`` and ``benchmark/metrics``,
found by the name ``BENCHMARK.json`` gives it (a metric's reader is
``metrics/<name>.py``, or ``metrics/<stem>.py`` for every metric of that
stem, as ``idle.py`` reads ``idle.serve`` and ``idle.train``).
"""

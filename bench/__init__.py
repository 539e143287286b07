"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
H100: ``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.

Everything about one cell, configuration, traffic mix or metric sits in
files of its own, found by name: ``configs/<config>.json`` (sizes,
limits, the driver that runs them), ``traffic/<traffic>.json`` (the
mix's parameters), ``drivers/<driver>.py`` (builds the port's graph,
makes the inputs from the seed, drives the timed calls and checks the
outputs against ``reference/``), ``metrics/<metric>.py`` (one reader a
metric).  ``roofline.py`` holds the published peaks and the byte counts,
``profile.py`` reads the profiler's trace; neither imports the port."""

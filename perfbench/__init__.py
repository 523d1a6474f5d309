"""The benchmark of ``mmvae_tpu_torch`` on NVIDIA cards.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a configuration, a traffic mix, a cell or a
per-layer metric needs sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` (the cell's limits), ``metrics/<metric>.py``,
``drivers/<driver>.py``, ``models/<model>.py`` (how the program is
built for a model family) and ``reference/<model>.py`` (its plain
reference)."""

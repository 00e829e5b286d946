"""The benchmark of ``turbojax_torch`` on one NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line last. Everything that belongs to one configuration, one
traffic mix or one per-layer metric is a file of its own, found by its
name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json``, ``metrics/<metric>.py``, and the code those
files name: ``entries/<entry>.py``, ``objectives/<objective>.py`` and
``reference/kernels/<kernel>.py`` (see ``manifest``).
"""

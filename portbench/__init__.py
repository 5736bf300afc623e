"""The benchmark of ``csvplus_tpu_torch`` on NVIDIA GPUs.

``python3 -m portbench --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output (see :mod:`portbench.run`).
"""

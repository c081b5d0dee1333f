"""The benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON result line.  The
cells, configurations and metrics are data: ``workloads/<cell>.json``,
``configs/<config>.json`` and one reader a metric in ``metrics/``.
Nothing here imports ``jax`` or the JAX package ``repro``.
"""

"""The benchmark of the port ``sph_tpu_torch`` on one NVIDIA H100.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; ``README.md``
says how a cell, a traffic mix or a per-layer metric is added.  Nothing
here imports JAX or the JAX package ``sph_tpu``, and nothing under
``reference/`` imports the port.
"""

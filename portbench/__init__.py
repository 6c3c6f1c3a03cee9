"""The benchmark of ``petastorm_tpu_torch`` on NVIDIA H100s.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; everything a cell needs is a file found
by its name (``run.py``'s docstring lists them).  Nothing here imports JAX or
the JAX package ``petastorm_tpu``; ``reference/`` imports nothing of the port.
"""

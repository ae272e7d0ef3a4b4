"""The benchmark of ``netsdb_tpu_torch``, the PyTorch and CUDA port.

``python3 -m perfbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and
prints one JSON line (``run.py``). Everything the benchmark measures
with lives here, where a change to the program cannot move it: the
traffic generator, the data made from the seed, the plain references,
the operation counts and peaks, and the readers of the per-layer
metrics. It imports neither JAX nor the JAX package ``netsdb_tpu``.
"""

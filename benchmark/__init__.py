"""The benchmark of the PyTorch/CUDA port (``a_nice_rag_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one CUDA
device and prints one JSON line. Nothing here imports the JAX package.
"""

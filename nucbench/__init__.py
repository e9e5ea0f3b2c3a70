"""The benchmark of ``cute_nucleotides_tpu_torch`` on NVIDIA cards.

One command runs one cell (a configuration under a traffic mix) once:
``python -m nucbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``.  The cells, configurations and metrics are named in
``BENCHMARK.json`` at the repository's root, and each lives in files of its
own here (:mod:`nucbench.cells`).  The plain reference that decides
``correct`` is :mod:`nucbench.reference`; it imports nothing of the port.
Nothing here imports JAX or the JAX package.
"""

"""The benchmark of ``ultranest_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs converged nested-sampling fits back to back and
prints one JSON line (``portbench/README.md``). Every configuration,
cell, per-layer metric and kernel bound is a file of its own here, found
by the name that ``BENCHMARK.json`` gives it.
"""

"""One reader a per-layer metric, named as in ``BENCHMARK.json`` (which
gives its unit, layer, source and the end-to-end metric it moves):
``read(run)`` returns the number, or None where the traced window holds
nothing to read it from. *run* has ``fits`` (the records of the window's
fits), ``trace`` (``portbench.trace.Trace``), ``config`` and
``workload``."""

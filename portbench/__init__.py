"""The benchmark of ``cmf_tpu_torch`` on NVIDIA H100s: ``run.py`` runs one
cell of ``BENCHMARK.json`` once. See ``PERF.md`` at the repository's root
for the cells, the metrics and the limits."""

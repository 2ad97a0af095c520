"""The benchmark of automerge_tpu_torch on one NVIDIA H100: cells of a
configuration and a traffic mix, run by `run.py` from the data files
under `configs/`, `traffic/` and `metrics/` that BENCHMARK.json names."""

"""The benchmark of glc_tpu_torch: `python3 glcbench/run.py --workload <cell> ...`."""

"""The benchmark of delay_enc_tpu_torch on an NVIDIA card.

`python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of the repository's BENCHMARK.json once and prints one
JSON line.  Configurations (`configs/`), traffic mixes (`traffic/`) and
metrics (`metrics/`) are files found by the names BENCHMARK.json gives; the
plain reference that decides `correct` is `reference/`.
"""

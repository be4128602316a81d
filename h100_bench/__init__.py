"""The benchmark of the PyTorch and CUDA port (`sift_features_tpu_torch`) on
one NVIDIA H100.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints one JSON line. Everything a
cell needs is found by name: its configuration file (`configs/`), its
traffic mix (`traffic/<name>.json`, whose `kind` names its generator in
`kinds/`), the limits of its correctness readings (`limits/<cell>.json`),
and one reader per per-layer metric (`metrics/<metric>.py`). The yardstick
lives here too: the input generators, the plain reference (`reference/`),
the kernels' bound arithmetic (`rooflines/`) and the trace reduction
(`trace.py`).
"""

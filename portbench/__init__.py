"""portbench: the benchmark of x264_tpu_torch (the PyTorch/CUDA port).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on one CUDA card and prints
its result as one JSON line. See run.py.
"""

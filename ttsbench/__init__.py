"""The benchmark of the PyTorch/CUDA port (`pocket_tts_tpu_torch`).

`python3 ttsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints its result line.
"""

"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
of ``BENCHMARK.json`` a run, ``python3 bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``."""

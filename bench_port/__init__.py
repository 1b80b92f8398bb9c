"""The benchmark of the PyTorch and CUDA port (``wlsqm_tpu_torch``) on an
NVIDIA card: ``python3 bench_port/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""

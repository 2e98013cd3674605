"""The benchmark of the PyTorch/CUDA port (`coda_neurips2023_tpu_torch`):
one cell a run, `python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`.  See README.md."""

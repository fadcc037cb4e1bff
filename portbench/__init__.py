"""The benchmark of the PyTorch/CUDA port (``aligator_tpu_torch``) on one
NVIDIA H100: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. See README.md."""

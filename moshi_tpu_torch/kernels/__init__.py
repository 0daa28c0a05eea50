"""Build and load the CUDA kernels under ``moshi_tpu_torch/csrc``."""

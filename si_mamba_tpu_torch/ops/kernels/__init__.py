"""CUDA kernels (sources in ``si_mamba_tpu_torch/csrc``), each with its plain
PyTorch version and a launch counter."""

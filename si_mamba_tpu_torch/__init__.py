"""PyTorch + CUDA port of si_mamba_tpu for NVIDIA Hopper (H100).

The JAX package ``si_mamba_tpu`` is the reference; this package imports
nothing of it. Slice 1 holds the PointMamba eval forward and its serving
surface (``si_mamba_tpu_torch.serving.Predictor``), with the causal conv and
the selective scan as CUDA kernels written for sm_90a (``csrc/``).
"""

"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

- ``fused_basis``: the fused B-spline KAN forward (``csrc/bspline_kan.cu``)
  for the patch embedder and the grouped q/k/v projection.
- ``flash_attention``: lanes-layout attention (``csrc/attention_lanes.cu``).

``_build`` compiles ``csrc/*.cu`` with nvcc at first use. Every kernel has a
plain PyTorch version in ``kanvit_torch.ops``; the wrappers run it for CPU
tensors and launch the kernel for CUDA tensors. Importing this package
builds nothing.
"""

"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

- ``fused_basis``: the fused KAN layers, forward and backward, of the
  B-spline, Chebyshev and Fourier families (``csrc/kan_basis.cu``) for the
  patch embedder and the grouped q/k/v projection.
- ``flash_attention``: the lanes-layout attention (``csrc/attention_lanes.cu``)
  and the tiled flash attention (``csrc/flash_attention.cu``), forward and
  backward.

``_build`` compiles ``csrc/*.cu`` with nvcc at first use. Every kernel has a
plain PyTorch version in ``kanvit_torch.ops``; the wrappers run it for CPU
tensors and launch the kernel for CUDA tensors. Importing this package
builds nothing.
"""

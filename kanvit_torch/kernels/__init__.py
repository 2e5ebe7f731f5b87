"""Hand-written CUDA kernels for Hopper (sm_90a), bound with ctypes.

- ``fused_basis``: the fused KAN layers, forward and backward, of the
  B-spline, Chebyshev and Fourier families (``csrc/kan_basis.cu``) and the
  RBF and sine families (``csrc/kan_rbf_sine.cu``) for the patch embedder
  and the grouped q/k/v projection; the Fourier and sine embedders' forward
  and weight gradient on the tensor cores (``csrc/kan_basis_tc.cuh``), and
  every family's bf16 forward and backward there (``Bf16`` operand type,
  ``mma.sync.m16n8k16``).
- ``flash_attention``: the lanes-layout attention (``csrc/attention_lanes.cu``)
  and the tiled flash attention (``csrc/flash_attention.cu``), forward and
  backward.
- ``fused_ffn``: the pre-LN feed-forward (``csrc/fused_ffn.cu``), forward
  and backward.
- ``int8_matmul``: the W8A8 linear layer of int8 serving
  (``csrc/int8_matmul.cu``), forward.

``_build`` compiles ``csrc/*.cu`` with nvcc at first use. Every kernel has a
plain PyTorch version in ``kanvit_torch.ops``; the wrappers run it for CPU
tensors and launch the kernel for CUDA tensors. Importing this package
builds nothing.
"""

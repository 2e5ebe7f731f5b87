"""kanvit_torch — the PyTorch / CUDA port of kanvit for NVIDIA Hopper.

The JAX package ``kanvit`` is the reference; this package mirrors its module
paths and names so each counterpart is found at once:

- ``kanvit_torch.ops``      plain PyTorch math (the kernels' plain versions)
- ``kanvit_torch.kernels``  hand-written CUDA C++ kernels for sm_90a, built
                            with nvcc at first use and bound with ctypes
- ``kanvit_torch.layers``   ``nn.Module`` layers (KAN layers, MSA, blocks)
- ``kanvit_torch.models``   VisionTransformer and CausalDecoder assembly
- ``kanvit_torch.utils``    torch-convention init and weight conversion
- ``kanvit_torch.infer``    the batched serving ``Predictor``
- ``kanvit_torch.train``    ``make_optimizer``, the train and eval steps
- ``kanvit_torch.bench``    the training throughput bench (one JSON line)

Ported so far, in f32, serving and the training step (forward and backward
kernels, Adam): every ViT variant (``vanilla``, ``efficientkan``, ``fast``,
``sine``, ``fourier``, ``cheby``, ``flash-attn``), the opt-in fused pre-LN
FF (``fused_ff=True``), int8 serving (``Predictor(quant="int8")``, with the
W8A8 ``int8_linear`` kernel on request), and the ``CausalDecoder`` on the
tiled flash attention. In bf16 (kanvit's ``--bf16`` policy), serving (float
or int8) and the training step of every ViT variant, with or without the
fused FF, and the decoder's step, on hand-written bf16 kernels; bf16
attention at the generic head dims, export and the trainer surface are
listed in ``ROADMAP.md``. This package imports torch and numpy only, never
jax.
"""

__version__ = "0.1.0"

VARIANTS = (
    "vanilla",
    "efficientkan",
    "fast",
    "sine",
    "fourier",
    "cheby",
    "flash-attn",
)

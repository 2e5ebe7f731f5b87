"""W8A8 int8 linear layer on the card (counterpart of
``kanvit/kernels/int8_matmul.py``), forward only: it backs int8 serving.

:func:`int8_linear` computes ``int32(q(x) q(W)^T) * s_x[row] * s_w[col] +
b`` in f32, the activations quantized per row inside the kernel of
``csrc/int8_matmul.cu``, the weight per output channel from its f32 cast
outside it (plain torch, as kanvit quantizes it outside its kernel), and
returns it in x's dtype, as kanvit's kernel does: f32 for f32 x, and for
bf16 x (with bf16 W and bias) the f32 result rounded once to bf16 (the bf16
kernel, launches under ``int8_linear_bf16``). A CPU tensor runs the plain
version, ``kanvit_torch.ops.quant.qdot_rowwise`` rounded once to x's dtype:
the kernel's bits, not kanvit's twin, which returns f32 for bf16 x too. A
CUDA tensor launches the kernel or raises. x, W and the bias share one
dtype on both routes; a layer that meets f32 activations with bf16
parameters widens them first (``kanvit_torch.utils.precision.promote``).

:func:`applicable` is kanvit's predicate (K and out multiples of 128). It
decides semantics, not speed: the kernel quantizes x per row, the ``qdot``
that ``TorchLinear`` runs elsewhere per tensor, so the two give different
numbers.

:func:`rows_per_block` is the kernel's one shape rule: the rows a block
quantizes into shared memory, from K alone (``ROW_TIERS``), passed to the
kernel's entry, which takes those four and refuses the rest; ``MAX_K`` is
the deepest K whose 16-row blocks fit beside the kernel's W ring
(:func:`shared_bytes`, the kernel's own sum).

``LAUNCHES["int8_linear"]`` and ``LAUNCHES["int8_linear_bf16"]`` count
kernel launches on f32 and bf16 x; the CPU path never counts.
"""

from __future__ import annotations

import torch

from kanvit_torch.ops import dispatch
from kanvit_torch.ops import quant

LAUNCHES = {"int8_linear": 0, "int8_linear_bf16": 0}
DTYPES = (torch.float32, torch.bfloat16)
LANE = 128          # kanvit's eligibility: K and out multiples of 128
MAX_SHARED = 227 * 1024
# As in csrc/int8_matmul.cu: outputs a tile, K bytes a stage of W and the
# stages of its ring, bytes after each quantized row (and each W row's 16).
BN, KC, STAGES, XPAD = 128, 128, 2, 16
# (deepest K, rows a block): the rows of a block shrink as K grows, so its
# quantized rows fit beside the W ring; rows_per_block(k) reads it. 48
# rows keep two blocks an SM up to K 1,536 and one wave of blocks at
# vit-s's 12,608 tokens (263 blocks).
ROW_TIERS = ((3968, 48), (6016, 32))
DEEP_ROWS = 16      # past the last tier


def shared_bytes(rows: int, k: int) -> int:
    """A block's shared memory in the kernel: the row scales, ``rows``
    quantized rows of ``K + XPAD`` bytes, the W ring."""
    return rows * 4 + rows * (k + XPAD) + STAGES * BN * (KC + 16)


MAX_K = max(k for k in range(LANE, 32768, LANE) if shared_bytes(DEEP_ROWS, k) <= MAX_SHARED)


def rows_per_block(k: int) -> int:
    """The rows a block of the kernel quantizes and multiplies, from K."""
    return next((rows for deepest, rows in ROW_TIERS if k <= deepest), DEEP_ROWS)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def applicable(k: int, out: int) -> bool:
    """True where kanvit's ``int8_linear`` runs its kernel: K and out
    multiples of 128."""
    return k % LANE == 0 and out % LANE == 0


def check_dtypes(x: torch.Tensor, w: torch.Tensor, bias) -> None:
    """Raise unless x is f32 or bf16 and ``w`` and ``bias`` (or None) share
    its dtype: the wrapper never casts behind its caller."""
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.dtype != x.dtype:
            raise TypeError(f"{name} must be {str(x.dtype)[6:]} as x is, got {t.dtype}")


def check_args(x2d: torch.Tensor, w: torch.Tensor, bias) -> None:
    """Raise on anything the kernel does not take (device aside): ``x2d (N,
    K)`` f32 or bf16 with a unit column stride, ``w (out, K)`` and ``bias
    (out,)`` (or None) of x's dtype, K and out multiples of 128, K at most
    ``MAX_K``."""
    check_dtypes(x2d, w, bias)
    if x2d.dim() != 2 or w.dim() != 2 or x2d.shape[1] != w.shape[1]:
        raise ValueError(f"expected x (N, K) and w (out, K), got "
                         f"{tuple(x2d.shape)}, {tuple(w.shape)}")
    k, out = x2d.shape[1], w.shape[0]
    if not applicable(k, out):
        raise ValueError(f"K {k} and out {out} must be multiples of {LANE}")
    if k > MAX_K:
        raise ValueError(f"K {k} exceeds the kernel's {MAX_K} (a block's "
                         "quantized rows live in shared memory)")
    if bias is not None and tuple(bias.shape) not in ((out,), (1, out)):
        raise ValueError(f"bias must be ({out},), got {tuple(bias.shape)}")
    if x2d.stride(1) != 1:
        raise ValueError("x must have a unit column stride")


def _launch(x2d, wq, sw, bias) -> torch.Tensor:
    """``y (N, out)`` in x's dtype from the kernel of that dtype; ``wq (out,
    K)`` int8 and ``sw (out,)`` the weight quantized per output channel,
    ``bias (out,)`` f32 or None."""
    from kanvit_torch.kernels import _build

    n, k = x2d.shape
    out = wq.shape[0]
    y = torch.empty(n, out, dtype=x2d.dtype, device=x2d.device)
    if n == 0:
        return y
    if bias is not None and bias.data_ptr() % 8:
        bias = bias.clone()  # the epilogue reads two columns' bias at once
    bf16 = x2d.dtype == torch.bfloat16
    lib = _build.load()
    entry = lib.kanvit_int8_linear_fwd_bf16 if bf16 else lib.kanvit_int8_linear_fwd
    with torch.cuda.device(x2d.device):
        err = entry(
            x2d.data_ptr(), x2d.stride(0), wq.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), n, k, out,
            rows_per_block(k), torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_linear: kernel launch failed with CUDA error {err}")
    LAUNCHES["int8_linear_bf16" if bf16 else "int8_linear"] += 1
    return y


def int8_linear(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 ``x @ w.T (+ bias)``, ``(..., K) -> (..., out)`` in x's dtype
    (f32 or bf16; ``w (out, K)`` and ``bias`` of the same), x quantized per
    row and ``w`` per output channel: ``kanvit_torch.ops.quant.qdot_rowwise``
    rounded once to x's dtype. Not differentiable."""
    check_dtypes(x, w, bias)
    if not dispatch.use_kernel(x):
        return quant.qdot_rowwise(x, w, bias).to(x.dtype)
    lead, k = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, k)
    check_args(x2d, w, bias)
    if {t.device for t in (x2d, w) + (() if bias is None else (bias,))} != {x.device}:
        raise ValueError("int8_linear: x, w and bias must be on one device")
    wq, sw = quant._quantize(w, dim=-1)
    # the epilogue adds an f32 bias (kanvit's brow = bias.astype(f32))
    b = None if bias is None else bias.reshape(-1).float().contiguous()
    y = _launch(x2d, wq.contiguous(), sw.reshape(-1).contiguous(), b)
    return y.reshape(*lead, w.shape[0])

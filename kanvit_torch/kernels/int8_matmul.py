"""W8A8 int8 linear layer on the card (counterpart of
``kanvit/kernels/int8_matmul.py``), forward only: it backs int8 serving.

:func:`int8_linear` computes ``int32(q(x) q(W)^T) * s_x[row] * s_w[col] +
b`` in f32, the activations quantized per row inside the kernel of
``csrc/int8_matmul.cu``, the weight per output channel outside it (plain
torch, as kanvit quantizes it outside its kernel). A CPU tensor runs the
plain version, ``kanvit_torch.ops.quant.qdot_rowwise``; a CUDA tensor
launches the kernel or raises. Both return f32 whatever the input dtype
(kanvit's kernel returns the input dtype and its twin f32; the port, f32
throughout, holds both to f32).

:func:`applicable` is kanvit's predicate (K and out multiples of 128). It
decides semantics, not speed: the kernel quantizes x per row, the ``qdot``
that ``TorchLinear`` runs elsewhere per tensor, so the two give different
numbers.

:func:`rows_per_block` is the kernel's one shape rule: the rows a block
quantizes into shared memory, from K alone (``ROW_TIERS``), passed to the
kernel's entry, which takes those four and refuses the rest; ``MAX_K`` is
the deepest K whose 16-row blocks fit beside the kernel's W ring
(:func:`shared_bytes`, the kernel's own sum).

``LAUNCHES["int8_linear"]`` counts kernel launches; the CPU path never
counts.
"""

from __future__ import annotations

import torch

from kanvit_torch.ops import dispatch
from kanvit_torch.ops import quant

LAUNCHES = {"int8_linear": 0}
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


def check_args(x2d: torch.Tensor, w: torch.Tensor, bias) -> None:
    """Raise on anything the kernel does not take (device aside): ``x2d (N,
    K)`` f32 with a unit column stride, ``w (out, K)`` f32, ``bias (out,)``
    f32 or None, K and out multiples of 128, K at most ``MAX_K``."""
    for name, t in (("x", x2d), ("w", w), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
    """``y (N, out)`` from the kernel; ``wq (out, K)`` int8 and ``sw (out,)``
    the weight quantized per output channel."""
    from kanvit_torch.kernels import _build

    n, k = x2d.shape
    out = wq.shape[0]
    y = torch.empty(n, out, dtype=torch.float32, device=x2d.device)
    if n == 0:
        return y
    if bias is not None and bias.data_ptr() % 8:
        bias = bias.clone()  # the epilogue reads two columns' bias at once
    with torch.cuda.device(x2d.device):
        err = _build.load().kanvit_int8_linear_fwd(
            x2d.data_ptr(), x2d.stride(0), wq.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), n, k, out,
            rows_per_block(k), torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_linear: kernel launch failed with CUDA error {err}")
    LAUNCHES["int8_linear"] += 1
    return y


def int8_linear(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 ``x @ w.T (+ bias)``, ``(..., K) -> (..., out)`` f32, x
    quantized per row and ``w (out, K)`` per output channel. Same function
    as ``kanvit_torch.ops.quant.qdot_rowwise``; not differentiable."""
    if not dispatch.use_kernel(x):
        return quant.qdot_rowwise(x, w, bias)
    lead, k = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, k)
    check_args(x2d, w, bias)
    if {t.device for t in (x2d, w) + (() if bias is None else (bias,))} != {x.device}:
        raise ValueError("int8_linear: x, w and bias must be on one device")
    wq, sw = quant._quantize(w, dim=-1)
    b = None if bias is None else bias.reshape(-1).contiguous()
    y = _launch(x2d, wq.contiguous(), sw.reshape(-1).contiguous(), b)
    return y.reshape(*lead, w.shape[0])

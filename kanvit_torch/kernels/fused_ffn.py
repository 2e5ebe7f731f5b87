"""The fused pre-LN feed-forward on the card, forward and backward
(counterpart of ``kanvit/kernels/fused_ffn.py``).

:func:`ffn_pre_ln` computes ``x + relu(LN(x) W1^T + b1) W2^T + b2``. f32
tensors go through the kernels of ``csrc/fused_ffn.cu``, every product on
the tensor cores in 3xTF32: the forward keeps the (rows, F) hidden block
out of device memory; the backward recomputes LN and the first product from
x and returns all seven gradients, the weight gradients summed over the
rows in a fixed order (no atomics). bf16 tensors (all seven: kanvit's bf16
policy, ``_dot_dtype``) go through the kernels of ``csrc/fused_ffn_bf16.cu``
on bf16 ``mma.sync`` with f32 accumulation, with kanvit's roundings: LN,
r and dh rounded to bf16 at their dots, every sum in f32, each output
rounded once. A CPU tensor runs the plain version: f32
``kanvit_torch.ops.kan_bases.ffn_pre_ln``, which autograd differentiates,
or, on bf16, the bf16 kernels' twins ``K.ffn_pre_ln_bf16`` /
``K.ffn_pre_ln_bwd_bf16`` through :class:`_FfnBf16Plain`; a CUDA tensor
goes through :class:`_FfnFn`, whose forward and backward launch the
kernels of its dtype or raise. Any D >= 1 and F >= 1: D at most
``FUSED_MAX_D`` (512; vit-s's is 384) runs the fused forward, whose 48-row
tiles keep LN and y on chip over all of D; past it (vit-b's 768, vit-l's
1,024, any larger D) the forward and the backward's dln run as tiled
products through device-memory scratch, r (N, F) and dln (N, D), and take
any D device memory holds.

It is ``TransformerBlock``'s opt-in FF (``fused_ff=True``), off by default
as kanvit's ``KANVIT_FF=1`` is.

``LAUNCHES`` counts kernel launches (``ffn_pre_ln`` forward,
``ffn_pre_ln_bwd`` backward, ``ffn_pre_ln_bf16`` and
``ffn_pre_ln_bwd_bf16`` the bf16 ones); the CPU path never counts.
"""

from __future__ import annotations

import torch

from kanvit_torch.ops import dispatch
from kanvit_torch.ops import kan_bases as K

LAUNCHES = {"ffn_pre_ln": 0, "ffn_pre_ln_bwd": 0, "ffn_pre_ln_bf16": 0,
            "ffn_pre_ln_bwd_bf16": 0}
# A 48-row tile's LN stays in shared memory over all of D, and its y (the
# backward's dln) in registers: 100 KB and 96 accumulators a thread at D 512.
# Past it the tiled route (csrc/fused_ffn.cu, "Past D 512").
FUSED_MAX_D = 512
WIDE_TILE = 128      # columns a block of the tiled route's products
ROWS_PER_BLOCK = 48  # rows a block of the forward and dx kernels
HIDDEN_TILE = 128    # hidden units a block of the backward's hidden kernel
DW_TILE = 128        # (M, P) tile of the weight-gradient kernel
DW_TARGET_BLOCKS = 264  # 2 blocks of the weight-gradient kernel per SM of 132
# Past FUSED_MAX_D: four such waves (vit-b's 144 tiles of 128 x 128 ran as
# one split, half the card's block slots, 3.69 ms of the 7.28 ms backward on
# the H100; probe_qkv.py)
DW_TARGET_BLOCKS_WIDE = 4 * DW_TARGET_BLOCKS
DW_MIN_ROWS_PER_SPLIT = 256
HIDDEN_ROWS_BF16 = 64  # rows a block of the bf16 hidden kernel: db1's partials


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check_args(x2d, gamma, beta, w1, b1, w2, b2) -> None:
    """Raise on anything the kernels do not take (device aside): ``x2d (N,
    D)``, ``gamma, beta, b2 (D,)``, ``w1 (F, D)``, ``b1 (F,)``, ``w2 (D, F)``,
    all f32 or all bf16, ``D >= 1`` and ``F >= 1``."""
    named = (("x", x2d), ("gamma", gamma), ("beta", beta), ("w1", w1),
             ("b1", b1), ("w2", w2), ("b2", b2))
    dtype = x2d.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    for name, t in named[1:]:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {str(dtype)[6:]} as x is, got {t.dtype} "
                            "(all seven tensors float32, or all bfloat16)")
    if x2d.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"expected x (N, D) and w1 (F, D), got {tuple(x2d.shape)}, "
                         f"{tuple(w1.shape)}")
    d, f = x2d.shape[1], w1.shape[0]
    want = {"gamma": (d,), "beta": (d,), "w1": (f, d), "b1": (f,),
            "w2": (d, f), "b2": (d,)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    if d < 1 or f < 1:
        raise ValueError(f"D {d}, F {f}: the kernels take D >= 1 and F >= 1")


def dw_splits(n: int, d: int, f: int) -> int:
    """Row splits of the weight-gradient reduction: as many (D/128 x F/128)
    tiles times splits as the card runs at once (four times that past
    ``FUSED_MAX_D``), each split at least ``DW_MIN_ROWS_PER_SPLIT`` rows. A
    function of the shape only, so a run repeats its bits."""
    tiles = -(-d // DW_TILE) * -(-f // DW_TILE)
    target = DW_TARGET_BLOCKS if d <= FUSED_MAX_D else DW_TARGET_BLOCKS_WIDE
    return max(1, min(target // tiles, n // DW_MIN_ROWS_PER_SPLIT, 65535))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {err}")


def _round(v: int, m: int) -> int:
    return -(-v // m) * m


def _pitch(cols: int, dtype: torch.dtype = torch.float32) -> int:
    """The row pitch the kernels stage with 16-byte copies: ``cols`` rounded
    up to 16 bytes of ``dtype`` (4 floats, 8 bf16)."""
    return _round(cols, 16 // dtype.itemsize)


def _pitched(t: torch.Tensor, ld: int) -> torch.Tensor:
    """``t (rows, cols)`` as row-major rows of ``ld`` floats starting on 16
    bytes, zero in the pad columns: ``t`` itself where it is one, else a
    copy."""
    if t.shape[1] == ld and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros(t.shape[0], ld)
    out[:, :t.shape[1]] = t
    return out


def _launch(x2d, gamma, beta, w1, b1, w2, b2, relu_mask=None) -> torch.Tensor:
    """``y (N, D)`` from the forward kernel; given ``relu_mask``, a uint8
    ``(N, F)`` tensor, the kernel also writes its ReLU pattern (h > 0)
    there. ``relu_mask`` is for checks only (``chip_smoke.py`` holds the
    backward and a model's gradients against references on the kernel's own
    pattern, after bounding how far it is from the plain version's); the
    model path never passes it."""
    from kanvit_torch.kernels import _build

    n, d = x2d.shape
    f = w1.shape[0]
    y = torch.empty_like(x2d)
    if n == 0:
        return y
    ldd, ldf = _pitch(d), _pitch(f)
    w1p, w2p = _pitched(w1, ldd), _pitched(w2, ldf)
    args = (x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1p.data_ptr(),
            b1.data_ptr(), w2p.data_ptr(), b2.data_ptr(), y.data_ptr(),
            None if relu_mask is None else relu_mask.data_ptr())
    lib = _build.load()
    with torch.cuda.device(x2d.device):
        if d <= FUSED_MAX_D:
            err = lib.kanvit_ffn_fwd(*args, n, d, f, ldd, ldf, _stream(x2d.device))
        else:
            # the tiled route's scratch: LN and its row stats, r, and W1, W2
            # split once into TF32 words (bpairs tiles of 16 by 128 columns)
            f32 = dict(dtype=torch.float32, device=x2d.device)
            i32 = dict(dtype=torch.int32, device=x2d.device)
            ln, stats = torch.empty(n, ldd, **f32), torch.empty(n, 2, **f32)
            r = torch.empty(n, ldf, **f32)
            w1s = torch.empty(-(-d // 16) * _round(f, WIDE_TILE) * 32, **i32)
            w2s = torch.empty(-(-f // 16) * _round(d, WIDE_TILE) * 32, **i32)
            err = lib.kanvit_ffn_fwd_wide(
                *args, *(t.data_ptr() for t in (ln, stats, r, w1s, w2s)), n, d, f,
                ldd, ldf, _stream(x2d.device))
    _check_err(err, "ffn_pre_ln")
    LAUNCHES["ffn_pre_ln"] += 1
    return y


def _launch_bwd(x2d, gamma, beta, w1, b1, w2, g):
    """``(dx, dgamma, dbeta, dw1, db1, dw2, db2)`` from the backward kernels;
    ``g`` is the gradient of the forward's output."""
    from kanvit_torch.kernels import _build

    n, d = x2d.shape
    f = w1.shape[0]
    dev = x2d.device
    g = g.contiguous()
    dx = torch.empty_like(x2d)
    f32 = dict(dtype=torch.float32, device=dev)
    dgb = torch.empty(2, d, **f32)
    dw1, db1 = torch.empty_like(w1), torch.empty(f, **f32)
    dw2, db2 = torch.empty_like(w2), torch.empty(d, **f32)
    if n == 0:
        return (dx, dgb[0].zero_(), dgb[1].zero_(), dw1.zero_(), db1.zero_(),
                dw2.zero_(), db2.zero_())
    splits = dw_splits(n, d, f)
    ldd, ldf = _pitch(d), _pitch(f)
    gp, w1p, w2p = _pitched(g, ldd), _pitched(w1, ldd), _pitched(w2, ldf)
    # device-memory scratch: LN(x) and each row's (mean, rstd), r and dh, the
    # row blocks' dgamma/dbeta partials and, with splits > 1, the weight
    # gradients' split partials
    ln, stats = torch.empty(n, ldd, **f32), torch.empty(n, 2, **f32)
    r, dh = torch.empty(n, ldf, **f32), torch.empty(n, ldf, **f32)
    # W1 and W2 split once into TF32 words, 32 words a 16-deep tile and
    # column: for the hidden kernel, tiles of D by F rounded up to
    # HIDDEN_TILE; W1 for the dx kernel, tiles of F by D rounded up to 128
    i32 = dict(dtype=torch.int32, device=dev)
    w_hidden = torch.empty(2, -(-d // 16) * -(-f // HIDDEN_TILE) * HIDDEN_TILE * 32,
                           **i32)
    w_dx = torch.empty(-(-f // 16) * -(-d // 128) * 128 * 32, **i32)
    dgb_part = torch.empty(-(-n // ROWS_PER_BLOCK), 2, d, **f32)
    dln = torch.empty(n, ldd, **f32) if d > FUSED_MAX_D else None
    parts = ([torch.empty(splits, *shape, **f32)
              for shape in ((f, d), (f,), (d, f), (d,))] if splits > 1
             else [None] * 4)
    with torch.cuda.device(dev):
        err = _build.load().kanvit_ffn_bwd(
            *(t.data_ptr() for t in (x2d, gp, gamma, beta, w1p, w2p, b1, dx, dgb,
                                     dw1, db1, dw2, db2, ln, stats, r, dh,
                                     w_hidden[0], w_hidden[1], w_dx, dgb_part)),
            *(None if p is None else p.data_ptr() for p in (dln, *parts)),
            n, d, f, ldd, ldf, splits, _stream(dev))
    _check_err(err, "ffn_pre_ln_bwd")
    LAUNCHES["ffn_pre_ln_bwd"] += 1
    return dx, dgb[0], dgb[1], dw1, db1, dw2, db2


def _launch_bf16(x2d, gamma, beta, w1, b1, w2, b2, relu_mask=None) -> torch.Tensor:
    """``y (N, D)`` bf16 from the bf16 forward kernel (all seven tensors
    bf16); given ``relu_mask``, a uint8 ``(N, F)`` tensor, the kernel also
    writes its ReLU pattern (h > 0) there, for checks only, as
    :func:`_launch`'s."""
    from kanvit_torch.kernels import _build

    n, d = x2d.shape
    f = w1.shape[0]
    y = torch.empty_like(x2d)
    if n == 0:
        return y
    bf16, dev = torch.bfloat16, x2d.device
    ldd, ldf = _pitch(d, bf16), _pitch(f, bf16)
    w1p, w2p = _pitched(w1, ldd), _pitched(w2, ldf)
    args = (x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1p.data_ptr(),
            b1.data_ptr(), w2p.data_ptr(), b2.data_ptr(), y.data_ptr(),
            None if relu_mask is None else relu_mask.data_ptr())
    lib = _build.load()
    with torch.cuda.device(dev):
        if d <= FUSED_MAX_D:
            err = lib.kanvit_ffn_fwd_bf16(*args, n, d, f, ldd, ldf, _stream(dev))
        else:
            # the tiled route's scratch: LN (bf16) and its row stats, r (bf16)
            ln = torch.empty(n, ldd, dtype=bf16, device=dev)
            stats = torch.empty(n, 2, dtype=torch.float32, device=dev)
            r = torch.empty(n, ldf, dtype=bf16, device=dev)
            err = lib.kanvit_ffn_fwd_wide_bf16(
                *args, ln.data_ptr(), stats.data_ptr(), r.data_ptr(), n, d, f, ldd, ldf,
                _stream(dev))
    _check_err(err, "ffn_pre_ln (bf16)")
    LAUNCHES["ffn_pre_ln_bf16"] += 1
    return y


def _launch_bwd_bf16(x2d, gamma, beta, w1, b1, w2, g):
    """``(dx, dgamma, dbeta, dw1, db1, dw2, db2)``, bf16, from the bf16
    backward kernels; ``g`` (bf16) is the gradient of the forward's output."""
    from kanvit_torch.kernels import _build

    n, d = x2d.shape
    f = w1.shape[0]
    dev, bf16 = x2d.device, torch.bfloat16
    g = g.contiguous()
    dx = torch.empty_like(x2d)
    dgb = torch.empty(2, d, dtype=bf16, device=dev)
    dw1, db1 = torch.empty_like(w1), torch.empty(f, dtype=bf16, device=dev)
    dw2, db2 = torch.empty_like(w2), torch.empty(d, dtype=bf16, device=dev)
    if n == 0:
        return (dx, dgb[0].zero_(), dgb[1].zero_(), dw1.zero_(), db1.zero_(),
                dw2.zero_(), db2.zero_())
    splits = dw_splits(n, d, f)
    ldd, ldf = _pitch(d, bf16), _pitch(f, bf16)
    gp, w1p, w2p = _pitched(g, ldd), _pitched(w1, ldd), _pitched(w2, ldf)
    f32 = dict(dtype=torch.float32, device=dev)
    # device-memory scratch: LN(x) (bf16) and each row's (mean, rstd), r and
    # dh (bf16), the f32 partials of dgamma/dbeta (48-row blocks), db1
    # (64-row blocks) and the weight gradients' row splits, and past
    # FUSED_MAX_D the f32 dln
    ln = torch.empty(n, ldd, dtype=bf16, device=dev)
    stats = torch.empty(n, 2, **f32)
    r, dh = (torch.empty(n, ldf, dtype=bf16, device=dev) for _ in range(2))
    dgb_part = torch.empty(-(-n // ROWS_PER_BLOCK), 2, d, **f32)
    db1_part = torch.empty(-(-n // HIDDEN_ROWS_BF16), f, **f32)
    dln = torch.empty(n, ldd, **f32) if d > FUSED_MAX_D else None
    parts = [torch.empty(splits, *shape, **f32) for shape in ((f, d), (d, f), (d,))]
    with torch.cuda.device(dev):
        err = _build.load().kanvit_ffn_bwd_bf16(
            *(t.data_ptr() for t in (x2d, gp, gamma, beta, w1p, w2p, b1, dx, dgb, dw1, db1,
                                     dw2, db2, ln, stats, r, dh, dgb_part, db1_part)),
            None if dln is None else dln.data_ptr(), *(p.data_ptr() for p in parts),
            n, d, f, ldd, ldf, splits, _stream(dev))
    _check_err(err, "ffn_pre_ln_bwd (bf16)")
    LAUNCHES["ffn_pre_ln_bwd_bf16"] += 1
    return dx, dgb[0], dgb[1], dw1, db1, dw2, db2


class _FfnFn(torch.autograd.Function):
    """The fused FF on the card. Saves its inputs only (kanvit's residuals,
    ``fused_ffn.py:197-199``); the backward recomputes LN and h. bf16
    tensors take the bf16 kernels, forward and backward, and so return bf16
    y and gradients."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, w1, b1, w2, b2):
        ctx.save_for_backward(x2d, gamma, beta, w1, b1, w2)
        launch = _launch_bf16 if x2d.dtype == torch.bfloat16 else _launch
        return launch(x2d, gamma, beta, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x2d = ctx.saved_tensors[0]
        launch = _launch_bwd_bf16 if x2d.dtype == torch.bfloat16 else _launch_bwd
        return launch(*ctx.saved_tensors, g.to(x2d.dtype))


class _FfnBf16Plain(torch.autograd.Function):
    """The CPU route of the bf16 fused FF: the plain twins of the bf16
    kernels, ``K.ffn_pre_ln_bf16`` forward and ``K.ffn_pre_ln_bwd_bf16``
    backward over kanvit's 512-row blocks."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, w1, b1, w2, b2):
        ctx.save_for_backward(x2d, gamma, beta, w1, b1, w2)
        return K.ffn_pre_ln_bf16(x2d, gamma, beta, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return K.ffn_pre_ln_bwd_bf16(*ctx.saved_tensors, g.to(torch.bfloat16))


def ffn_pre_ln(x, gamma, beta, w1, b1, w2, b2):
    """``x + relu(LN(x) @ w1.T + b1) @ w2.T + b2``, ``(..., D) -> (..., D)``,
    differentiable in every argument, in the tensors' dtype: all f32, or all
    bf16 with kanvit's bf16 roundings (mixed dtypes raise ``TypeError``).
    Same signature as ``kanvit_torch.ops.kan_bases.ffn_pre_ln``."""
    tensors = (x, gamma, beta, w1, b1, w2, b2)
    on_card = dispatch.use_kernel(x)
    if not on_card and all(t.dtype != torch.bfloat16 for t in tensors):
        return K.ffn_pre_ln(*tensors)
    d = x.shape[-1]
    args = [t.contiguous() for t in (x.reshape(-1, d), *tensors[1:])]
    check_args(*args)
    if not on_card:
        return _FfnBf16Plain.apply(*args).reshape(x.shape)
    if {t.device for t in args} != {x.device}:
        raise ValueError("ffn_pre_ln: every tensor must be on one device")
    return _FfnFn.apply(*args).reshape(x.shape)

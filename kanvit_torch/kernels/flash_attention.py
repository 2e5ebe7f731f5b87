"""Attention on the card, forward and backward (counterpart of
``kanvit/kernels/flash_attention.py``).

:func:`flash_attention_lanes` runs attention over head-concatenated
``(B, T, H*dh)`` tensors through the CUDA kernels of
``csrc/attention_lanes.cu``. :func:`flash_attention` runs it over
``(B, H, T, dh)`` tensors in kanvit's two tiers: the single-tile tier on the
same lanes kernels, the tiled tier on those of ``csrc/flash_attention.cu``.
Dispatch is by device: a CPU tensor runs the plain version
(``kanvit_torch.ops.attention.lanes_attention`` or
``flash_attention_reference``), which autograd differentiates; a CUDA tensor
goes through :class:`_LanesFn` or :class:`_FlashFn`, whose forward and
backward launch the kernels or raise. f32 only, dh in {16, 32, 64}.

``LAUNCHES`` counts kernel launches (``flash_attention_lanes`` forward and
``flash_attention_lanes_bwd`` backward; ``flash_attention`` tiled forward,
``flash_attention_dq`` and ``flash_attention_dkv`` its backward); the CPU
path never counts.
"""

from __future__ import annotations

import warnings

import torch

from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch

HEAD_DIMS = (16, 32, 64)

LAUNCHES = {"flash_attention_lanes": 0, "flash_attention_lanes_bwd": 0,
            "flash_attention": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}

# kanvit's tier predicates at f32 (flash_attention.py:293-309, :537-543 and
# the bucket guard :682-688). They decide semantics, not only speed: the
# single-tile and lanes kernels clamp the row max at -1e30, so a row that
# sees no valid key outputs 0, while the tiled kernel keeps the finite
# float32 min and gives it the uniform mean of v over every valid key. The
# port takes each tier exactly where kanvit does, so both agree on such rows.
LANE = 128
SMALL_MAX_T = 512
_VMEM_LIMIT = 10 * 1024 * 1024
_F32 = 4


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def use_small(tq: int, tk: int, d: int, h: int, q_block: int,
              k_block: int) -> bool:
    """True where :func:`flash_attention` takes the single-tile tier
    (kanvit's ``_use_small``)."""
    tp, dp = _round_up(tq, LANE), _round_up(d, LANE)
    vmem = 2 * (5 + 3) * h * tp * dp * _F32 + 4 * tp * tp * 4
    return (tq == tk and tp <= SMALL_MAX_T and tp <= q_block
            and tp <= k_block and vmem <= _VMEM_LIMIT)


def lanes_applicable(t: int, tk: int, dm: int, h: int, q_block: int,
                     k_block: int) -> bool:
    """True where kanvit's ``FlashAttentionBlock`` takes the lanes tier on
    its head-concatenated projections (``_lanes_ok`` and the bucket guard)."""
    if t != tk or dm % h:
        return False
    tp8 = _round_up(t, 8)
    vmem = 2 * 8 * tp8 * _round_up(dm, LANE) * _F32 + 4 * tp8 * tp8 * 4
    tp = _round_up(t, LANE)
    return ((dm // h) % 8 == 0 and tp8 <= SMALL_MAX_T and vmem <= _VMEM_LIMIT
            and tp <= q_block and tp <= k_block)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def check_args(q, k, v, n_heads, mask):
    """Raise on anything the kernel does not take (device aside); return
    ``q, k, v`` as ``(B, T, H, dh)`` views.

    ``q, k, v``: f32 ``(B, T, H*dh)`` or ``(B, T, H, dh)``, one shape;
    ``mask``: ``(B, T)`` or None.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} "
                            "(bf16 is not ported yet)")
    if not (q.shape == k.shape == v.shape) or q.dim() not in (3, 4):
        raise ValueError(f"q, k, v must share one (B, T, H*dh) or (B, T, H, dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    q4, k4, v4 = (A.split_lanes(a, n_heads) for a in (q, k, v))
    b, t, _, dh = q4.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in the kernel's {HEAD_DIMS}")
    if b > 65535 or n_heads > 65535:
        raise ValueError(f"batch {b} x heads {n_heads} exceed the launch grid")
    if mask is not None and tuple(mask.shape) != (b, t):
        raise ValueError(f"mask must be (B, T) = {(b, t)}, got {tuple(mask.shape)}")
    return q4, k4, v4


def _unit_inner(a: torch.Tensor, name: str) -> torch.Tensor:
    if a.stride(-1) == 1:
        return a
    warnings.warn(f"attention: {name} has no unit stride inside a head; "
                  "copying it to a contiguous tensor", stacklevel=3)
    return a.contiguous()


def _strides(*views: torch.Tensor) -> list[int]:
    return [st for a in views for st in a.stride()[:3]]


def _launch(q4, k4, v4, maskb, causal, with_stats):
    """Forward kernel: ``o (B, T, H*dh)`` and, when asked, each row's
    ``(m, l)`` as ``stats (B, H, T, 2)``."""
    from kanvit_torch.kernels import _build

    dev = q4.device
    b, t, h, dh = q4.shape
    o = torch.empty(b, t, h * dh, dtype=torch.float32, device=dev)
    stats = (torch.empty(b, h, t, 2, dtype=torch.float32, device=dev)
             if with_stats else None)
    if b == 0 or t == 0:
        return o, stats
    with torch.cuda.device(dev):
        err = _build.load().kanvit_attention_lanes_fwd(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), *_strides(q4, k4, v4),
            None if maskb is None else maskb.data_ptr(), o.data_ptr(),
            None if stats is None else stats.data_ptr(),
            b, t, h, dh, int(causal), dh ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_lanes: kernel launch failed with CUDA error {err}")
    LAUNCHES["flash_attention_lanes"] += 1
    return o, stats


def _launch_bwd(q4, k4, v4, maskb, o, stats, do, causal):
    """Backward kernels: ``dq, dk, dv``, each ``(B, T, H, dh)`` contiguous."""
    from kanvit_torch.kernels import _build

    dev = q4.device
    b, t, h, dh = q4.shape
    grads = [torch.empty(b, t, h, dh, dtype=torch.float32, device=dev)
             for _ in range(3)]
    if b == 0 or t == 0:
        return grads
    do = do.reshape(b, t, h * dh).contiguous()
    delta = torch.empty(b, h, t, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.load().kanvit_attention_lanes_bwd(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), *_strides(q4, k4, v4),
            None if maskb is None else maskb.data_ptr(), o.data_ptr(),
            do.data_ptr(), stats.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), b, t, h, dh, int(causal),
            dh ** -0.5, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_lanes: backward kernel launch failed with CUDA "
            f"error {err}")
    LAUNCHES["flash_attention_lanes_bwd"] += 1
    return grads


class _LanesFn(torch.autograd.Function):
    """Lanes attention on the card. Saves q, k, v, the mask and o (kanvit's
    residual, ``flash_attention.py:591-593``) and the forward's per-row
    ``(m, l)``, which the backward reads instead of recomputing."""

    @staticmethod
    def forward(ctx, q4, k4, v4, maskb, causal, for_grad):
        # needs_input_grad holds under no_grad too: the caller says whether
        # autograd will ask for the backward, and only then are (m, l) kept.
        o, stats = _launch(q4, k4, v4, maskb, causal, for_grad)
        if for_grad:
            ctx.causal = causal
            ctx.save_for_backward(q4, k4, v4, maskb, o, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        q4, k4, v4, maskb, o, stats = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q4, k4, v4, maskb, o, stats, do, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention_lanes(q, k, v, n_heads, causal=False, mask=None):
    """Attention over head-concatenated tensors, ``(B, T, H*dh)`` out,
    differentiable in ``q``, ``k`` and ``v``.

    ``q, k, v``: ``(B, T, H*dh)``, or ``(B, T, H, dh)`` strided views (the
    q/k/v slices of the grouped projection's output, read without a copy);
    ``mask``: optional ``(B, T)`` key mask (> 0.5 = attend). Masked keys add
    exactly 0 and a fully masked row outputs 0 and gets gradients of exactly
    0, as on the TPU.
    """
    if not dispatch.use_kernel(q):
        return A.lanes_attention(q, k, v, n_heads, causal=causal, mask=mask)
    q4, k4, v4 = check_args(q, k, v, n_heads, mask)
    q4, k4, v4 = (_unit_inner(a, n) for a, n in ((q4, "q"), (k4, "k"), (v4, "v")))
    dev = q.device
    devices = {t.device for t in (q4, k4, v4)}
    if mask is not None:
        devices.add(mask.device)
    if devices != {dev}:
        raise ValueError("flash_attention_lanes: q, k, v and mask must be on "
                         "one device")
    b, t = q4.shape[:2]
    maskb = (None if mask is None
             else A.key_valid(mask, b, t, dev).to(torch.uint8).contiguous())
    for_grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (q4, k4, v4))
    return _LanesFn.apply(q4, k4, v4, maskb, bool(causal), for_grad)


def check_flash_args(q, k, v, mask):
    """Raise on anything the tiled kernels do not take (device aside).

    ``q``: f32 ``(B, H, Tq, dh)``; ``k, v``: f32 ``(B, H, Tk, dh)``, any
    strides; ``mask``: ``(B, Tk)`` or None.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype} "
                            "(bf16 is not ported yet)")
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or (q.shape[0], q.shape[1], q.shape[3])
            != (k.shape[0], k.shape[1], k.shape[3])):
        raise ValueError(f"q must be (B, H, Tq, dh) and k, v one (B, H, Tk, dh) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, dh = q.shape
    tk = k.shape[2]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in the kernel's {HEAD_DIMS}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} x heads {h} exceed the launch grid")
    if tk == 0:
        raise ValueError("flash_attention needs at least one key")
    if mask is not None and tuple(mask.shape) != (b, tk):
        raise ValueError(f"mask must be (B, Tk) = {(b, tk)}, got {tuple(mask.shape)}")


def _tiled_strides(*views: torch.Tensor) -> list[int]:
    """(batch, token, head) strides of ``(B, H, T, dh)`` tensors."""
    return [st for a in views for st in (a.stride(0), a.stride(2), a.stride(1))]


def _tiled_call(name, q, k, v, maskb, causal, *ptrs):
    """Call the C entry ``kanvit_flash_attention_<name>`` with the shared
    leading and trailing arguments; raise on a launch error."""
    from kanvit_torch.kernels import _build

    dev = q.device
    b, h, tq, dh = q.shape
    with torch.cuda.device(dev):
        err = getattr(_build.load(), f"kanvit_flash_attention_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *_tiled_strides(q, k, v),
            None if maskb is None else maskb.data_ptr(), *ptrs,
            b, tq, k.shape[2], h, dh, int(causal), dh ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: {name} kernel launch failed with "
                           f"CUDA error {err}")


def _launch_tiled(q, k, v, maskb, causal, with_stats):
    """Tiled forward kernel: ``o (B, Tq, H, dh)`` contiguous and, when
    asked, each row's ``(m, l)`` as ``stats (B, H, Tq, 2)``."""
    b, h, tq, dh = q.shape
    o = torch.empty(b, tq, h, dh, dtype=torch.float32, device=q.device)
    stats = (torch.empty(b, h, tq, 2, dtype=torch.float32, device=q.device)
             if with_stats else None)
    if b == 0 or tq == 0:
        return o, stats
    _tiled_call("fwd", q, k, v, maskb, causal, o.data_ptr(),
                None if stats is None else stats.data_ptr())
    LAUNCHES["flash_attention"] += 1
    return o, stats


def _launch_tiled_dq(q, k, v, maskb, o, stats, do, causal):
    """dq kernel: ``dq (B, Tq, H, dh)`` contiguous and ``delta (B, H, Tq)``
    = rowsum(do * o). ``o`` and ``do``: ``(B, Tq, H, dh)`` contiguous."""
    b, h, tq, dh = q.shape
    dq = torch.empty(b, tq, h, dh, dtype=torch.float32, device=q.device)
    delta = torch.empty(b, h, tq, dtype=torch.float32, device=q.device)
    _tiled_call("dq", q, k, v, maskb, causal, o.data_ptr(), do.data_ptr(),
                stats.data_ptr(), delta.data_ptr(), dq.data_ptr())
    LAUNCHES["flash_attention_dq"] += 1
    return dq, delta


def _launch_tiled_dkv(q, k, v, maskb, stats, do, delta, causal):
    """dk/dv kernel: ``dk, dv (B, Tk, H, dh)`` contiguous."""
    b, h, _, dh = q.shape
    dk, dv = (torch.empty(b, k.shape[2], h, dh, dtype=torch.float32,
                          device=q.device) for _ in range(2))
    _tiled_call("dkv", q, k, v, maskb, causal, do.data_ptr(), stats.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    LAUNCHES["flash_attention_dkv"] += 1
    return dk, dv


def _launch_tiled_bwd(q, k, v, maskb, o, stats, do, causal):
    """Backward kernels, dq (which writes delta) then dk/dv: ``dq, dk, dv``
    as ``(B, T, H, dh)`` contiguous."""
    b, h, tq, dh = q.shape
    if b == 0 or tq == 0:
        return (torch.empty(b, tq, h, dh, device=q.device),
                *(torch.zeros(b, k.shape[2], h, dh, device=q.device)
                  for _ in range(2)))
    dq, delta = _launch_tiled_dq(q, k, v, maskb, o, stats, do, causal)
    return (dq, *_launch_tiled_dkv(q, k, v, maskb, stats, do, delta, causal))


class _FlashFn(torch.autograd.Function):
    """Tiled attention on the card. Saves q, k, v, the mask, o and the
    forward's per-row ``(m, l)`` (kanvit's residuals, ``flash_attention.py:
    771-772``); the backward reads them and recomputes the scores."""

    @staticmethod
    def forward(ctx, q, k, v, maskb, causal, for_grad):
        o4, stats = _launch_tiled(q, k, v, maskb, causal, for_grad)
        o = o4.transpose(1, 2)  # (B, H, Tq, dh) over the (B, Tq, H, dh) buffer
        if for_grad:
            ctx.causal = causal
            ctx.save_for_backward(q, k, v, maskb, o, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, maskb, o, stats = ctx.saved_tensors
        grads = _launch_tiled_bwd(q, k, v, maskb, o.transpose(1, 2),
                                  stats, do.transpose(1, 2).contiguous(),
                                  ctx.causal)
        return (*(g.transpose(1, 2) for g in grads), None, None, None)


def flash_attention(q, k, v, causal=False, q_block=512, k_block=1024,
                    mask=None):
    """Attention over ``(B, H, T, dh)`` tensors, differentiable in ``q``,
    ``k`` and ``v``; ``(B, H, Tq, dh)`` out.

    ``q, k, v`` may be ``(B, T, H, dh)`` strided views transposed to
    ``(B, H, T, dh)``, read without a copy. ``mask``: optional ``(B, Tk)``
    key mask (> 0.5 = attend). Where kanvit's ``_use_small`` holds (one
    tile of the buckets covers ``tq == tk``) this is the lanes attention, a
    fully masked row giving 0; elsewhere the tiled attention with
    ``flash_attention_reference``'s semantics: causal rows at
    ``row - max(tk - tq, 0)``, and a row that sees no valid key gets the
    mean of v over the valid keys.
    """
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    if use_small(tq, tk, dh, h, q_block, k_block):
        o = flash_attention_lanes(*(a.transpose(1, 2) for a in (q, k, v)), h,
                                  causal=causal, mask=mask)
        return o.view(b, tq, h, dh).transpose(1, 2)
    keys = None if mask is None else A.key_valid(mask, b, tk, mask.device)
    if not dispatch.use_kernel(q):
        return A.flash_attention_reference(q, k, v, causal, q_block, k_block,
                                           keys)[0]
    check_flash_args(q, k, v, mask)
    q, k, v = (_unit_inner(a, n) for a, n in ((q, "q"), (k, "k"), (v, "v")))
    devices = {t.device for t in (q, k, v)}
    if mask is not None:
        devices.add(mask.device)
    if devices != {q.device}:
        raise ValueError("flash_attention: q, k, v and mask must be on one device")
    maskb = None if keys is None else keys.to(torch.uint8).contiguous()
    for_grad = torch.is_grad_enabled() and any(
        a.requires_grad for a in (q, k, v))
    return _FlashFn.apply(q, k, v, maskb, bool(causal), for_grad)

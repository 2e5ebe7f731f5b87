"""Lanes-layout attention on the card, forward and backward (counterpart of
``kanvit/kernels/flash_attention.py::flash_attention_lanes``).

:func:`flash_attention_lanes` runs attention over head-concatenated
``(B, T, H*dh)`` tensors through the CUDA kernels of
``csrc/attention_lanes.cu``. Dispatch is by device: a CPU tensor runs the
plain version ``kanvit_torch.ops.attention.lanes_attention``, which autograd
differentiates; a CUDA tensor goes through :class:`_LanesFn`, whose forward
and backward launch the kernels or raise. f32 only, dh in {16, 32, 64}.

``LAUNCHES`` counts kernel launches (``flash_attention_lanes`` forward,
``flash_attention_lanes_bwd`` backward); the CPU path never counts.
"""

from __future__ import annotations

import warnings

import torch

from kanvit_torch.ops import attention as A
from kanvit_torch.ops import dispatch

HEAD_DIMS = (16, 32, 64)

LAUNCHES = {"flash_attention_lanes": 0, "flash_attention_lanes_bwd": 0}


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
    warnings.warn(f"flash_attention_lanes: {name} has no unit stride inside a "
                  "head; copying it to a contiguous tensor", stacklevel=3)
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

"""Attention math in plain PyTorch (counterpart of ``kanvit/ops/attention.py``).

``multi_head_attention`` is the plain softmax attention of the JAX package.
``lanes_attention`` is the plain version of the lanes attention kernel
(``kanvit_torch.kernels.flash_attention.flash_attention_lanes``): the same
head-concatenated layout and the same edge semantics as the TPU kernel
(``kanvit/kernels/flash_attention.py:312-341``), which differ from
``multi_head_attention`` on a fully masked row: there the kernel outputs 0
where plain softmax gives a uniform row; on bf16 operands it follows the
bf16 kernel's policy, kanvit's (``flash_attention.py:482-495``). ``flash_attention_reference`` is the
plain version of the tiled attention kernels
(``kanvit_torch.kernels.flash_attention.flash_attention``), a copy of
``kanvit/ops/attention.py::flash_attention_reference``;
``flash_attention_bf16`` and ``flash_attention_bwd_bf16`` are the plain
versions of the tiled kernels on bf16 operands, kanvit's bf16 policy
(``kanvit/kernels/flash_attention.py:66-123``, ``:176-272``).
"""

from __future__ import annotations

import torch

EPSILON = 1e-10
NEG = torch.finfo(torch.float32).min
# Row-max clamp: with every key masked the max stays here, exp() of the
# masked scores underflows to exactly 0 and the row sum clamps to EPSILON.
MAX_CLAMP = -1e30


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False) -> torch.Tensor:
    """Plain softmax attention over pre-projected heads, ``(..., T, d_head)``.

    Score scale ``d_head ** -0.5`` (reference ``attention.py:199``); no
    output projection and no dropout.
    """
    d_head = q.shape[-1]
    scores = (q @ k.transpose(-1, -2)) * (d_head ** -0.5)
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(tk - tq)
        scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
    return torch.softmax(scores, dim=-1) @ v


def split_lanes(a: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``(B, T, H*dh)`` or a ``(B, T, H, dh)`` view -> ``(B, T, H, dh)``."""
    if a.dim() == 4:
        if a.shape[2] != n_heads:
            raise ValueError(f"expected {n_heads} heads, got shape {tuple(a.shape)}")
        return a
    b, t, dm = a.shape
    if dm % n_heads:
        raise ValueError(f"width {dm} not divisible by n_heads={n_heads}")
    return a.reshape(b, t, n_heads, dm // n_heads)


def key_valid(mask: torch.Tensor | None, b: int, t: int,
              device: torch.device) -> torch.Tensor:
    """``(B, T)`` bool: True where a key may be attended (mask value > 0.5,
    the TPU kernel's rule for a bool or float mask)."""
    if mask is None:
        return torch.ones(b, t, dtype=torch.bool, device=device)
    if tuple(mask.shape) != (b, t):
        raise ValueError(f"mask must be (B, T) = {(b, t)}, got {tuple(mask.shape)}")
    return mask.to(torch.float32) > 0.5


def bf16_scale(dh: int) -> float:
    """``dh ** -0.5`` rounded to bf16, as kanvit's bf16 kernel scales q
    (``jnp.asarray(scale, bf16)``): exact at dh 64, not at 32 or 8."""
    return float(torch.tensor(dh ** -0.5, dtype=torch.bfloat16))


def lanes_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_heads: int, causal: bool = False,
                    mask: torch.Tensor | None = None, exact: bool = False) -> torch.Tensor:
    """Attention over head-concatenated tensors, plain version.

    ``q, k, v``: ``(B, T, H*dh)`` (or ``(B, T, H, dh)`` views); optional key
    mask ``(B, T)``. Per head:
    ``softmax(q_h k_h^T * dh^-1/2 + key bias + causal bias) v_h`` with the
    row max clamped at -1e30 and the row sum at 1e-10, so masked keys add
    exactly 0 and a fully masked row outputs 0. Returns ``(B, T, H*dh)``.

    bf16 ``q, k, v``: the bf16 kernel's policy, kanvit's: q scaled in bf16
    by :func:`bf16_scale`, the scores and softmax in f32, ``l`` the sum of
    the f32 ``p``, the PV product on ``p`` rounded to bf16 with f32
    accumulation (f32 products of bf16 values, exact), and ``pv * (1 / l)``
    rounded to bf16. ``exact`` (bf16 operands): the reference a kernel's
    distance is measured from, q scaled and rounded as above, the rest in
    f64 and unrounded.
    """
    qh, kh, vh = (split_lanes(a, n_heads).transpose(1, 2) for a in (q, k, v))
    b, h, t, dh = qh.shape
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        ft = torch.float64 if exact else torch.float32
        qs = qh * torch.tensor(bf16_scale(dh), dtype=torch.bfloat16, device=q.device)
        s = qs.to(ft) @ kh.to(ft).transpose(-1, -2)
    else:
        s = (qh * dh ** -0.5) @ kh.transpose(-1, -2)  # (B, H, T, T)
    valid = key_valid(mask, b, t, q.device)[:, None, None, :]
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~valid, NEG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(MAX_CLAMP)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(EPSILON)
    if bf16 and exact:
        o = (p @ vh.to(p.dtype)) * (1.0 / l)
    elif bf16:
        o = ((p.to(torch.bfloat16).float() @ vh.float()) * (1.0 / l)).to(torch.bfloat16)
    else:
        o = (p @ vh) * (1.0 / l)
    return o.transpose(1, 2).reshape(b, t, h * dh)


def lanes_attention_bwd_bf16(q, k, v, o, do, n_heads: int, causal: bool = False,
                             mask: torch.Tensor | None = None, exact: bool = False,
                             spread: bool = False):
    """The bf16 lanes attention's backward as kanvit's bf16 kernel computes
    it (``_lanes_bwd_kernel``, ``kanvit/kernels/flash_attention.py:498-535``),
    plain version. ``q, k, v`` bf16 as :func:`lanes_attention` takes them;
    ``o`` its bf16 output and ``do`` the gradient of it, ``(B, T, H*dh)``.
    Per head:

    - ``qs = q * bf16_scale(dh)`` in bf16; ``s = qs k^T`` in f32, masked,
      ``p = exp(s - m)`` against the row max clamped at -1e30, ``l`` the
      f32 sum of p clamped at 1e-10, ``pn = p * (1 / l)`` in f32;
    - ``dv = bf16(pn)^T do``, f32 accumulation, rounded once;
    - ``delta = sum(f32(do) * f32(o))`` over dh, from the bf16 o;
    - ``dp = do v^T`` in f32, ``dsc = bf16(pn * (dp - delta))``;
    - ``dq = bf16((dsc k) * dh^-1/2)``, this scale the f32 one, not
      ``bf16_scale``;
    - ``dk = bf16(dsc^T qs)``.

    Returns ``(dq, dk, dv)``, each ``(B, T, H*dh)`` bf16. ``exact``: the
    same rounded operands (q, k, v, o, do and qs) with every sum in f64 and
    nothing else rounded, the reference a kernel's distance is measured
    from. ``spread``: instead, in f32, what each gradient moves by, times
    2^8, when every rounded intermediate rounds to its neighbouring bf16
    value, weighted as the next product weighs it: ``(|dsc| |k|) *
    dh^-1/2``, ``|dsc|^T |qs|`` and ``|pn|^T |do|`` (a different f32 sum
    order can flip those roundings); the gates' second term."""
    qh, kh, vh, oh, doh = (split_lanes(a, n_heads).transpose(1, 2)
                           for a in (q, k, v, o, do))
    b, h, t, dh = qh.shape
    ft = torch.float64 if exact else torch.float32
    bf16 = torch.bfloat16

    def rnd(a):
        return a if exact else a.to(bf16).to(ft)

    qs = qh * torch.tensor(bf16_scale(dh), dtype=bf16, device=q.device)
    kf, vf, dof = kh.to(ft), vh.to(ft), doh.to(ft)
    s = qs.to(ft) @ kf.transpose(-1, -2)
    valid = key_valid(mask, b, t, q.device)[:, None, None, :]
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~valid, NEG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(MAX_CLAMP)
    p = torch.exp(s - m)
    pn = p * (1.0 / p.sum(dim=-1, keepdim=True).clamp_min(EPSILON))
    delta = (dof * oh.to(ft)).sum(dim=-1, keepdim=True)
    dsc = rnd(pn * (dof @ vf.transpose(-1, -2) - delta))
    if spread:
        pn, dsc, kf, dof, qs = (a.abs() for a in (rnd(pn), dsc, kf, dof, qs.to(ft)))
    dv = rnd(pn).transpose(-1, -2) @ dof
    dq = (dsc @ kf) * dh ** -0.5
    dk = dsc.transpose(-1, -2) @ qs.to(ft)
    if spread:
        return tuple(g.transpose(1, 2).reshape(b, t, h * dh) for g in (dq, dk, dv))
    return tuple((g if exact else g.to(bf16)).transpose(1, 2).reshape(b, t, h * dh)
                 for g in (dq, dk, dv))


def kanvit_key_block(tk: int, k_block: int) -> int:
    """kanvit's tiled key block (``_plan``, ``flash_attention.py:713-722``):
    the bucket rounded up to 128, capped at ``tk`` rounded up to 128."""
    return min(-(-k_block // 128) * 128, -(-tk // 128) * 128)


def _tiled_masks(b, tq, tk, causal, mask, device):
    """``(valid (B, 1, 1, Tk), seen (Tq, Tk))``: valid keys, and the keys
    each query sees causally at ``qpos = row - max(tk - tq, 0)``."""
    valid = key_valid(mask, b, tk, device)[:, None, None, :]
    qpos = torch.arange(tq, device=device) - max(tk - tq, 0)
    seen = (qpos[:, None] >= torch.arange(tk, device=device)[None, :] if causal
            else torch.ones(tq, tk, dtype=torch.bool, device=device))
    return valid, seen


def flash_attention_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = False, block: int = 1024,
                         mask: torch.Tensor | None = None, exact: bool = False):
    """The tiled attention on bf16 operands as kanvit's tiled kernel
    computes it (``_fwd_kernel``, ``kanvit/kernels/flash_attention.py:
    66-123``), plain version; returns ``(o, m, l)``.

    ``q`` ``(B, H, Tq, dh)``, ``k, v`` ``(B, H, Tk, dh)`` bf16; optional key
    mask ``(B, Tk)``. The edge semantics are ``flash_attention_reference``'s
    (a row that sees no valid key gets the mean of v over the valid keys).
    Per query row, over key blocks of ``block`` keys, which decide every
    rounding of p (kanvit's kernel: :func:`kanvit_key_block` of its bucket):

    - ``s = (q k^T) * dh^-1/2``: f32 sums of bf16 products, the f32 scale
      after the product; masked scores the finite f32 min;
    - ``m`` the running max over the blocks, ``p = exp(s - m)`` zeroed on
      invalid keys, each block's sum of the unrounded ``p`` clamped at
      1e-10, ``l = l * exp(m_old - m) + sum``;
    - ``acc = acc * exp(m_old - m) + bf16(p) v``, f32 accumulation;
    - ``o = bf16(acc / max(l, 1e-10))``, a true division.

    ``m`` and ``l`` ``(B, H, Tq)`` f32 are the kernel's residuals.
    ``exact``: the reference a kernel's distance is measured from, the same
    bf16 operands with everything after them in f64 and unrounded.
    """
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    ft = torch.float64 if exact else torch.float32
    scale = torch.tensor(dh ** -0.5, dtype=ft)
    vf = v.to(ft)
    valid, seen = _tiled_masks(b, tq, tk, causal, mask, q.device)
    s = (q.to(ft) @ k.to(ft).transpose(-1, -2)) * scale
    s = s.masked_fill(~(valid & seen), NEG)
    m = torch.full((b, h, tq, 1), NEG, dtype=ft, device=q.device)
    l = torch.zeros(b, h, tq, 1, dtype=ft, device=q.device)
    acc = torch.zeros(b, h, tq, dh, dtype=ft, device=q.device)
    for k0 in range(0, tk, block):
        sb = s[..., k0:k0 + block]
        m_new = torch.maximum(m, sb.amax(dim=-1, keepdim=True))
        p = torch.exp(sb - m_new).masked_fill(~valid[..., k0:k0 + block], 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True).clamp_min(EPSILON)
        pr = p if exact else p.to(torch.bfloat16).to(ft)
        acc = acc * corr + pr @ vf[:, :, k0:k0 + block]
        m = m_new
    l = l.clamp_min(EPSILON)
    o = acc / l
    return (o if exact else o.to(torch.bfloat16)), m[..., 0], l[..., 0]


def flash_attention_bwd_bf16(q, k, v, o, do, m, l, causal: bool = False,
                             mask: torch.Tensor | None = None, spread: bool = False,
                             exact: bool = False):
    """The tiled attention's backward on bf16 operands as kanvit's dq and
    dk/dv kernels compute it (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``,
    ``kanvit/kernels/flash_attention.py:176-272``), plain version.

    ``q, k, v`` as :func:`flash_attention_bf16` takes them, ``o`` its bf16
    output and ``do`` the gradient of it ``(B, H, Tq, dh)``, ``m, l`` its
    residuals ``(B, H, Tq)``. Per head, with the final ``(m, l)`` (no tiling
    enters):

    - ``s = (q k^T) * dh^-1/2`` in f32, the finite f32 min where causally
      unseen; ``p = exp(s - m) * (1 / l)`` zeroed on invalid keys;
    - ``delta = sum(f32(do) * f32(o))`` over dh, from the bf16 o;
    - ``ds = (p * dh^-1/2) * (do v^T - delta)`` in f32, 0 where causally
      unseen, rounded to bf16 at both of its products, the scale inside;
    - ``dq = bf16(bf16(ds) k)``, no scale after it;
      ``dk = bf16(bf16(ds)^T q)``, q unscaled; ``dv = bf16(bf16(p)^T do)``.

    Returns ``(dq, dk, dv)`` bf16 in the shapes of q, k, v. ``spread``:
    instead, in f32, what each gradient moves by, times 2^8,
    when every rounded ds and p rounds to its neighbouring bf16 value,
    weighted as the next product weighs it: ``|ds| |k|``, ``|ds|^T |q|``
    and ``|p|^T |do|`` (the gates' second term). ``exact``: instead, the
    same function on the same operands in f64 with nothing rounded (the
    reference the kernels' gradients are held to, no further from it than
    twice the twin), f64."""
    b, h, tq, dh = q.shape
    tk = k.shape[2]
    dt = torch.float64 if exact else torch.float32
    scale = torch.tensor(dh ** -0.5, dtype=dt)
    qf, kf, vf, dof = (a.to(dt) for a in (q, k, v, do))
    valid, seen = _tiled_masks(b, tq, tk, causal, mask, q.device)
    s = ((qf @ kf.transpose(-1, -2)) * scale).masked_fill(~seen, NEG)
    p = (torch.exp(s - m.to(dt)[..., None])
         * (1.0 / l.to(dt))[..., None]).masked_fill(~valid, 0.0)
    delta = (dof * o.to(dt)).sum(dim=-1, keepdim=True)
    ds = ((p * scale) * (dof @ vf.transpose(-1, -2) - delta)).masked_fill(~seen, 0.0)
    if exact:
        return ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof
    ds, p = (a.to(torch.bfloat16).float() for a in (ds, p))
    if spread:
        ds, p, qf, kf, dof = (a.abs() for a in (ds, p, qf, kf, dof))
    grads = (ds @ kf, ds.transpose(-1, -2) @ qf, p.transpose(-1, -2) @ dof)
    if spread:
        return grads
    return tuple(g.to(torch.bfloat16) for g in grads)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = False, q_block: int = 512,
                              k_block: int = 1024,
                              mask: torch.Tensor | None = None):
    """Blocked online-softmax attention; returns ``(o, lse)``.

    ``q`` ``(B, H, Tq, D)``; ``k, v`` ``(B, H, Tk, D)``; optional key mask
    ``(B, Tk)`` (True = attend). For each ``q_block`` tile the ``k_block``
    tiles stream through a running row max ``m`` and row sum ``l``; blocks
    are capped at the 8-aligned sequence length. The edge semantics are the
    TPU tiled kernel's, and differ from ``lanes_attention``'s:
    - masked scores are the finite float32 min, not -inf, and ``p`` is
      re-zeroed only on invalid (masked or padded) keys, so a row that sees
      no valid key causally gets ``exp(min - min) = 1`` on every valid key:
      the uniform mean of v over the valid keys, later keys included;
    - causal rows sit at ``qpos = row - max(tk - tq, 0)`` (the reference's
      sign, the opposite of ``multi_head_attention``'s ``tril(tk - tq)``);
    - each block's row sum, and the final ``l``, is clamped at 1e-10.
    Autograd differentiates it.
    """
    q, k, v = (t.to(torch.float32) for t in (q, k, v))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    scale = d ** -0.5
    qk_len_diff = max(tk - tq, 0)
    q_block = min(q_block, -(-tq // 8) * 8)
    k_block = min(k_block, -(-tk // 8) * 8)
    keys = (torch.ones(b, tk, dtype=torch.bool, device=q.device) if mask is None
            else mask.to(torch.bool))
    outs, lses = [], []
    for q0 in range(0, tq, q_block):
        qc = q[:, :, q0:q0 + q_block]
        qpos = torch.arange(q0, q0 + qc.shape[2], device=q.device) - qk_len_diff
        o = torch.zeros_like(qc)
        m = torch.full((b, h, qc.shape[2], 1), NEG, device=q.device)
        l = torch.zeros(b, h, qc.shape[2], 1, device=q.device)
        for k0 in range(0, tk, k_block):
            kc, vc = k[:, :, k0:k0 + k_block], v[:, :, k0:k0 + k_block]
            s = (qc @ kc.transpose(-1, -2)) * scale
            key_valid = keys[:, None, None, k0:k0 + k_block]
            s = torch.where(key_valid, s, NEG)
            if causal:
                kpos = torch.arange(k0, k0 + kc.shape[2], device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG)
            m_new = torch.maximum(s.amax(dim=-1, keepdim=True), m)
            p = torch.where(key_valid, torch.exp(s - m_new), 0.0)
            block_sum = p.sum(dim=-1, keepdim=True).clamp_min(EPSILON)
            correction = torch.exp(m - m_new)
            l = correction * l + block_sum
            o = o * correction + p @ vc
            m = m_new
        l = l.clamp_min(EPSILON)
        outs.append(o / l)
        lses.append((torch.log(l) + m)[..., 0])
    # The last tile of each axis may be short where the JAX reference pads
    # it: padded keys are invalid there (p = 0) and padded rows are dropped.
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)

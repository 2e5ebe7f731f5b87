"""Attention math in plain PyTorch (counterpart of ``kanvit/ops/attention.py``).

``multi_head_attention`` is the plain softmax attention of the JAX package.
``lanes_attention`` is the plain version of the lanes attention kernel
(``kanvit_torch.kernels.flash_attention.flash_attention_lanes``): the same
head-concatenated layout and the same edge semantics as the TPU kernel
(``kanvit/kernels/flash_attention.py:312-341``), which differ from
``multi_head_attention`` on a fully masked row: there the kernel outputs 0
where plain softmax gives a uniform row. ``flash_attention_reference`` is the
plain version of the tiled attention kernels
(``kanvit_torch.kernels.flash_attention.flash_attention``), a copy of
``kanvit/ops/attention.py::flash_attention_reference``.
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


def lanes_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_heads: int, causal: bool = False,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over head-concatenated tensors, plain version.

    ``q, k, v``: ``(B, T, H*dh)`` (or ``(B, T, H, dh)`` views); optional key
    mask ``(B, T)``. Per head:
    ``softmax(q_h k_h^T * dh^-1/2 + key bias + causal bias) v_h`` with the
    row max clamped at -1e30 and the row sum at 1e-10, so masked keys add
    exactly 0 and a fully masked row outputs 0. Returns ``(B, T, H*dh)``.
    """
    qh, kh, vh = (split_lanes(a, n_heads).transpose(1, 2) for a in (q, k, v))
    b, h, t, dh = qh.shape
    s = (qh * dh ** -0.5) @ kh.transpose(-1, -2)  # (B, H, T, T)
    valid = key_valid(mask, b, t, q.device)[:, None, None, :]
    if causal:
        valid = valid & torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~valid, NEG)
    m = s.amax(dim=-1, keepdim=True).clamp_min(MAX_CLAMP)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(EPSILON)
    o = (p @ vh) * (1.0 / l)
    return o.transpose(1, 2).reshape(b, t, h * dh)


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

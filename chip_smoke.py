"""Drive the kanvit_torch serving and training paths on one NVIDIA GPU and
check them.

Run from the root of a kanvit checkout on a machine with a CUDA device and
the CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero:

1. toolchain and card: torch, CUDA and nvcc versions, the card's name and
   power limit; no CUDA device is an error, never a fall-back to the CPU;
2. build the CUDA kernels from ``kanvit_torch/kernels/csrc`` (nvcc, one
   process per source, all started together);
3. each forward kernel against its plain PyTorch version on the card, at
   the vit-s path's shapes (batch 64) and at a ragged narrow shape, with
   error and time (CUDA events) of both;
4. each backward kernel against autograd through its plain version on the
   card, at the same shapes (the attention also causal, masked and with a
   fully masked row), with error and time of both;
5. the tiled attention's forward, dq and dk/dv kernels against
   ``flash_attention_reference`` and autograd through it, at the causal
   decoder's shapes (B 16, H 4, T 2048 and B 4, H 4, T 8192, dh 64) and at
   ragged masked shapes whose rows see no valid key (``tq < tk`` and keys
   0-3 masked), with error and time of both; then ``flash_attention``'s
   single-tile route against ``lanes_attention``;
6. the Chebyshev and Fourier kernels (forward, dx and dW) against their
   plain versions and autograd through them on the card: ``chebykan`` and
   ``fourierkan`` (grid 28) at the vit-s embedder's shapes (12,544 x 768
   -> 384), ``cheby_qkv_grouped`` at the vit-s q/k/v (12,608 tokens, 6
   heads of 64 -> 192), ragged narrow shapes of each, inputs where tanh
   saturates (|x| >= 9.5) and Fourier inputs up to |x| = 10; the backward's
   bits repeated; error and time of both;
7. the RBF and sine kernels (forward, and the backward: dx, dW, the
   LayerNorm's dgamma and dbeta, sine's dfreq) against their plain versions
   and autograd through them: ``fastkan`` and ``sinekan`` (grid 28) at the
   vit-s embedder's shapes, ``fastkan_qkv_grouped`` and
   ``sinekan_qkv_grouped`` (grid 4) at one vit-s q/k/v projection, ragged
   narrow shapes of each (nin 16, d_head 32, odd N), inputs where silu, the
   RBF and the LayerNorm saturate (|x| up to 60, a constant row) and sine
   arguments of several pi; the sine embedder's gradients also against f64;
   the backward's bits repeated; error and time of both;
8. serving, through ``Predictor(batch_size=64, device="cuda")`` for three
   requests (64, 64 and 37 images), of the vit-s ``efficientkan`` (1 + 12
   + 12 launches a batch), ``flash-attn`` (12 lanes), ``cheby`` (1
   ``chebykan`` + 12 ``cheby_qkv_grouped`` + 12 lanes), ``fourier`` (1
   ``fourierkan`` + 12 lanes; q/k/v on cuBLAS), ``fast`` (1 ``fastkan`` +
   36 ``fastkan_qkv_grouped`` + 12 lanes), ``sine`` (1 ``sinekan`` + 36
   ``sinekan_qkv_grouped`` + 12 lanes) and ``vanilla`` (12 lanes)
   models: exact launch counts and no backward launch, the logits of two
   images against the same model's CPU forward, the steady-state images/s;
9. training of the vit-s ``efficientkan``, ``cheby``, ``fourier``, ``fast``
   and ``sine`` models, batch 64, 6 Adam steps on one fixed batch through
   ``kanvit_torch.train``: loss finite and falling, exact forward and
   backward launch counts a step, the embedder's backward computing no dx,
   the gradients of a 4-image batch against the same model's CPU
   gradients, the steady-state step time and images/s, and a
   ``torch.profiler`` breakdown;
10. decoder training through ``kanvit_torch.bench_decoder`` at
   ``benchmarks/causal_decoder.py``'s configs (d 256, 4 heads, 4 blocks,
   vocab 1024; seq 2048 batch 16 and seq 8192 batch 4): 6 Adam steps (loss
   finite and falling, exactly 4 tiled forward, 4 dq and 4 dk/dv launches a
   step and no lanes launch), the gradients of a 1-sequence batch at seq
   2048 against the CPU, tokens/s and ms a step of the kernel impl and, at
   seq 2048, of the plain impl, and a ``torch.profiler`` breakdown;
11. the reference MNIST preset (batch 128) through ``kanvit_torch.bench``,
    whose JSON line is printed;
12. one JSON line of per-kernel results (each kernel's launches on its main
    path, and by path; its error, time and plain version's time; its bound,
    the least time the card could take for the same work, and, for the
    attention kernels, ``scaled_dot_product_attention``'s time on the same
    inputs), the card's ``nvidia-smi`` line, and last the result line
    ``{"ok": true, "device": {...}}``.

It imports torch, numpy and kanvit_torch only (no jax).
"""

from __future__ import annotations

import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BATCH = 64
REQUESTS = (64, 64, 37)
TOL_BSPLINE = 1e-4   # x max(1, max|y|): f32 sums of depth 6912 / 576 in another order
# Chebyshev and Fourier forwards, x max(1, max|y|): f32 sums of depth 3840
# (Chebyshev) and 43,008 (Fourier G 28) in another order, CUDA's sincosf and
# tanhf against the CPU's (each within 2 ulp).
TOL_KAN = 1e-4
TOL_ATTN = 1e-5      # x max(1, max|y|): f32 softmax, reduction depth 197
TOL_LOGITS = 1e-3    # GPU against CPU logits, 12 blocks deep
# Backward kernels, x max(1, max|g|) per gradient: f32 sums of depth up to
# 12,608 rows (dW), 3,456 (dx) and 197 (attention) in another order than
# cuBLAS / autograd, and probabilities recomputed from the forward's (m, l).
TOL_BWD = 1e-4
# GPU parameter gradients of a 4-image step against the CPU's in f64, x max|g|
# of each tensor: f32 through 12 blocks. The reference is f64 because f32
# rounding, on either side, flips ReLUs whose input lies within it of 0, and
# one flip in an early block moves that block's FF gradient by ~2e-3 of its
# max: the vit-s fourier model's CPU f32 gradients are 1.98e-3 from f64.
TOL_GRADS = 1e-3
# The card's published peaks (NVIDIA H100 SXM data sheet) for bound_ms: f32
# outside the tensor cores (every kernel here is f32 on the CUDA cores) and
# HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TRAIN_STEPS = 6
GRAD_IMAGES = 4
SEED = 0
# benchmarks/causal_decoder.py's model and its (seq, batch) configs
DECODER = dict(dim=256, heads=4, n_blocks=4, vocab=1024)
DECODER_CONFIGS = ((2048, 16), (8192, 4))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------
# Phase 1: toolchain and card
# --------------------------------------------------------------------------

def phase_toolchain():
    if not (HERE / "kanvit_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure(f"{HERE} is not a kanvit checkout: kanvit_torch/ "
                           "is missing beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: chip_smoke.py "
                           "runs on an NVIDIA GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kanvit_torch.kernels import _build

    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[toolchain] python {sys.version.split()[0]}  torch {torch.__version__}"
          f"  torch.version.cuda {torch.version.cuda}  nvcc: {nvcc[-1]}")
    print(f"[card] {smi}  (cuda:0 of {torch.cuda.device_count()})")
    return torch, smi


# --------------------------------------------------------------------------
# Phase 2: build
# --------------------------------------------------------------------------

def phase_build():
    from kanvit_torch.kernels import _build

    t0 = time.perf_counter()
    path, log = _build.build(ptxas_info=True)
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.2f} s -> {path.relative_to(HERE)}")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    return secs


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def spline_inputs(rng, shape, knots):
    """Normal inputs, with some entries exactly on knots and some beyond
    every knot span (|x| > 2.2)."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 16, replace=False)
    flat[idx[: idx.size // 2]] = knots[idx[: idx.size // 2] % knots.size]
    flat[idx[idx.size // 2:]] = rng.choice(
        np.float32([-3.5, -2.6, -2.2, 2.2, 2.6, 3.5]), idx.size - idx.size // 2)
    return x


def compare(name, got, want, tol):
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    ok = bool(got.isfinite().all()) and err <= tol * scale
    print(f"[kernel] {name}: max|err| {err:.3e}  limit {tol * scale:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version "
              f"({err:.3e} > {tol * scale:.3e}) or is not finite")
    return err


def bound(flops, nbytes, library_ms=None):
    """The least time the card could take for ``flops`` f32 operations on
    ``nbytes`` of inputs read once and outputs written once: the larger of
    the two over the published peaks, and which one binds. ``library_ms``
    is one PyTorch call's time for the same function, or None."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def kan_bound(n, groups, slices, nin, out, backward=False, extra_floats=0):
    """A KAN pass over x (n, G*nin) and the packed weight (G, S, nin, out):
    2 n G S nin out FLOPs a contraction, one forward, two backward (gW for
    dx, and dW); bytes of x, W and y (backward: x, W, gy, dx and dW), plus
    ``extra_floats`` (the LayerNorm's, sine's freq and phase tables)."""
    flops = 2.0 * n * groups * slices * nin * out * (2 if backward else 1)
    floats = n * groups * nin + groups * slices * nin * out + n * groups * out
    if backward:
        floats += n * groups * nin + groups * slices * nin * out
    return bound(flops, 4.0 * (floats + extra_floats))


def attention_bound(b, h, tq, tk, dh, causal, part, library_ms=None):
    """Attention over b*h heads: 2 tq tk dh FLOPs a product, of which the
    forward does 2 (q k^T, p v), dq 3 (s, dp, dq), dk/dv 4 (s, dp, dv, dk)
    and a joint backward 5; causal counts only the keys at or before each
    query (tq == tk). Bytes: q, k, v (+ o and do backward) in, o (dq, dk, dv)
    out, and the per-row (m, l) where the kernel reads them."""
    pairs = tk * (tk + 1) / 2 if causal else tq * tk
    products = {"fwd": 2, "dq": 3, "dkv": 4, "bwd": 5}[part]
    row, col = b * h * tq * dh, b * h * tk * dh
    floats = {"fwd": 2 * row + 2 * col,
              "dq": 3 * row + 2 * col + 3 * b * h * tq,
              "dkv": 2 * row + 4 * col + 3 * b * h * tq,
              "bwd": 4 * row + 4 * col + 2 * b * h * tq}[part]
    return bound(2.0 * b * h * pairs * dh * products, 4.0 * floats, library_ms)


def sdpa_ms(torch, q, k, v, causal, mask, backward=None, iters=20):
    """``scaled_dot_product_attention`` on (B, H, T, dh) views with the same
    key mask and causality (query row r at position r - max(tk - tq, 0), as
    the port's kernels), forward alone, or its backward through autograd to
    the inputs in ``backward`` ("q", "kv" or "qkv"): the yardstick call,
    never used by the port."""
    import torch.nn.functional as F

    b, _, tq, _ = q.shape
    tk = k.shape[2]
    attn_mask = None if mask is None else mask.bool().reshape(b, 1, 1, tk)
    if causal and (attn_mask is not None or tq != tk):
        seen = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(
            -max(tk - tq, 0))
        attn_mask = seen if attn_mask is None else attn_mask & seen
    causal_arg = causal and attn_mask is None
    if backward is None:
        with torch.inference_mode():
            return time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=causal_arg), iters)
    leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                         is_causal=causal_arg)
    g = torch.randn_like(out)
    want = {"q": leaves[:1], "kv": leaves[1:], "qkv": leaves}[backward]
    return time_ms(torch, lambda: torch.autograd.grad(out, want, g, retain_graph=True),
                   iters)


def check_bspline(torch, rng, n, nin, nout, label):
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.layers import KANLinear
    from kanvit_torch.ops import kan_bases as K

    layer = KANLinear(nin, nout, generator=torch.Generator().manual_seed(SEED)).cuda()
    knots = layer.grid[0].cpu().numpy()
    x = torch.from_numpy(spline_inputs(rng, (n, nin), knots)).cuda()
    p = (layer.grid, layer.base_weight, layer.spline_weight, layer.spline_scaler)
    with torch.inference_mode():
        y = FB.bspline_kan(x, *p)
        ref = K.bspline_kan_forward(x, *p)
        torch.cuda.synchronize()
        err = compare(f"bspline_kan {label} N={n} {nin}->{nout}", y, ref, TOL_BSPLINE)
        w = FB.pack_weight(*p[1:]).unsqueeze(0).contiguous()
        ms = time_ms(torch, lambda: FB._launch("bspline_kan", "bspline", x, w,
                                               layer.grid))
        wrapper_ms = time_ms(torch, lambda: FB.bspline_kan(x, *p))
        plain_ms = time_ms(torch, lambda: K.bspline_kan_forward(x, *p))
    print(f"[kernel] bspline_kan {label}: kernel {ms:.4f} ms  (with weight packing "
          f"{wrapper_ms:.4f} ms)  plain {plain_ms:.4f} ms")
    return err, ms, plain_ms, kan_bound(n, 1, 9, nin, nout)


def check_qkv(torch, rng, n, heads, dh, label):
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.layers import MSA
    from kanvit_torch.ops import kan_bases as K

    msa = MSA(heads * dh, heads, "efficientkan",
              generator=torch.Generator().manual_seed(SEED)).cuda()
    grid = msa.q_mappings[0].grid
    x = torch.from_numpy(
        spline_inputs(rng, (n, heads * dh), grid[0].cpu().numpy())).cuda()
    with torch.inference_mode():
        bw, sw, sc = msa.grouped_weights()

        def plain():  # each head's q|k|v through the plain KANLinear forward
            return torch.cat([K.bspline_kan_forward(
                x[:, i * dh:(i + 1) * dh], grid, bw[i], sw[i], sc[i])
                for i in range(heads)], dim=1)

        y = FB.bspline_qkv_grouped(x, grid, bw, sw, sc)
        ref = plain()
        torch.cuda.synchronize()
        err = compare(f"bspline_qkv_grouped {label} N={n} H={heads} dh={dh}",
                      y, ref, TOL_BSPLINE)
        w = FB.pack_qkv_weight(bw, sw, sc).contiguous()
        ms = time_ms(torch, lambda: FB._launch("bspline_qkv_grouped", "bspline", x,
                                               w, grid))
        wrapper_ms = time_ms(torch, lambda: FB.bspline_qkv_grouped(x, grid, bw, sw, sc))
        plain_ms = time_ms(torch, plain)
    print(f"[kernel] bspline_qkv_grouped {label}: kernel {ms:.4f} ms  (with weight "
          f"packing {wrapper_ms:.4f} ms)  plain {plain_ms:.4f} ms")
    return err, ms, plain_ms, kan_bound(n, heads, 9, dh, 3 * dh)


def check_attention(torch, rng, b, t, heads, dh, label, cases):
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    # q, k, v as the strided slices of a grouped (N, H*3dh) projection output
    y = torch.from_numpy(rng.standard_normal((b * t, heads * 3 * dh))
                         .astype(np.float32)).cuda()
    y4 = y.view(b, t, heads, 3 * dh)
    q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
    errs = []
    with torch.inference_mode():
        for causal, mask in cases:
            o = FA.flash_attention_lanes(q, k, v, heads, causal=causal, mask=mask)
            ref = A.lanes_attention(q, k, v, heads, causal=causal, mask=mask)
            torch.cuda.synchronize()
            tag = f"causal={causal} mask={'none' if mask is None else 'yes'}"
            errs.append(compare(f"flash_attention_lanes {label} B={b} T={t} "
                                f"H={heads} dh={dh} {tag}", o, ref, TOL_ATTN))
            if mask is not None:
                dead = ~A.key_valid(mask, b, t, mask.device).any(dim=1)
                check(bool((o[dead] == 0).all()),
                      "a fully masked row must output exactly 0")
        causal, mask = cases[0]
        ms = time_ms(torch, lambda: FA.flash_attention_lanes(
            q, k, v, heads, causal=causal, mask=mask))
        plain_ms = time_ms(torch, lambda: A.lanes_attention(
            q, k, v, heads, causal=causal, mask=mask))
    lib_ms = sdpa_ms(torch, *(a.transpose(1, 2) for a in (q, k, v)), causal, mask)
    print(f"[kernel] flash_attention_lanes {label}: kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  scaled_dot_product_attention {lib_ms:.4f} ms")
    return errs[0], ms, plain_ms, attention_bound(b, heads, t, t, dh, causal, "fwd",
                                                  lib_ms)


def phase_kernels(torch):
    rng = np.random.default_rng(SEED)
    geo = {"n_img": BATCH, "tokens": 197, "heads": 6, "dh": 64, "d": 384}
    results = {}
    results["bspline_kan"] = check_bspline(
        torch, rng, BATCH * 196, 768, 384, "vit-s embedder")
    results["bspline_qkv_grouped"] = check_qkv(
        torch, rng, BATCH * geo["tokens"], geo["heads"], geo["dh"], "vit-s q/k/v")
    results["flash_attention_lanes"] = check_attention(
        torch, rng, BATCH, geo["tokens"], geo["heads"], geo["dh"], "vit-s",
        [(False, None)])
    # ragged, narrow: the reference MNIST geometry with an odd batch of 37
    check_bspline(torch, rng, 37 * 49, 16, 64, "mnist embedder")
    check_qkv(torch, rng, 37 * 50, 2, 32, "mnist q/k/v")
    mask = torch.from_numpy(rng.random((37, 50)) > 0.2).cuda()
    mask[0] = False          # batch item 0: every row fully masked
    mask[1, 0] = False       # batch item 1, causal: query 0 sees no key
    check_attention(torch, rng, 37, 50, 2, 32, "mnist",
                    [(False, mask), (True, mask), (True, None)])
    return results


# --------------------------------------------------------------------------
# Phase 4: backward kernels against autograd through their plain versions
# --------------------------------------------------------------------------

def grads_of(torch, fn, inputs, g):
    """``(leaves, output, gradients of (output * g).sum())``; the graph is
    kept, so the backward alone can be timed again."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    return leaves, out, torch.autograd.grad(out, leaves, g, retain_graph=True)


def compare_grads(label, names, got, want):
    return max(compare(f"{label} d{nm}", a, b, TOL_BWD)
               for nm, a, b in zip(names, got, want))


def check_bspline_bwd(torch, rng, n, nin, nout, label):
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.layers import KANLinear
    from kanvit_torch.ops import kan_bases as K

    layer = KANLinear(nin, nout, generator=torch.Generator().manual_seed(SEED)).cuda()
    grid = layer.grid
    x = torch.from_numpy(spline_inputs(rng, (n, nin), grid[0].cpu().numpy())).cuda()
    g = torch.from_numpy(rng.standard_normal((n, nout)).astype(np.float32)).cuda()
    inputs = [x, layer.base_weight, layer.spline_weight, layer.spline_scaler]
    _, _, got = grads_of(torch, lambda *a: FB.bspline_kan(a[0], grid, *a[1:]),
                         inputs, g)
    leaves, out, want = grads_of(
        torch, lambda *a: K.bspline_kan_forward(a[0], grid, *a[1:]), inputs, g)
    torch.cuda.synchronize()
    err = compare_grads(f"bspline_kan_bwd {label} N={n} {nin}->{nout}",
                        ("x", "base_weight", "spline_weight", "spline_scaler"),
                        got, want)
    w = FB.pack_weight(*inputs[1:]).unsqueeze(0).contiguous().detach()
    ms = time_ms(torch, lambda: FB._launch_bwd("bspline_kan_bwd", "bspline", x, w,
                                               grid, g, True, True))
    dw_ms = time_ms(torch, lambda: FB._launch_bwd("bspline_kan_bwd", "bspline", x, w,
                                                  grid, g, False, True))
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                          retain_graph=True))
    print(f"[kernel] bspline_kan_bwd {label}: kernel dx+dW {ms:.4f} ms (dW alone, "
          f"as on the training path, {dw_ms:.4f} ms)  plain autograd {plain_ms:.4f} ms")
    return err, ms, plain_ms, {"no_dx_ms": dw_ms}, kan_bound(n, 1, 9, nin, nout, True)


def check_qkv_bwd(torch, rng, n, heads, dh, label):
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.layers import MSA
    from kanvit_torch.ops import kan_bases as K

    msa = MSA(heads * dh, heads, "efficientkan",
              generator=torch.Generator().manual_seed(SEED)).cuda()
    grid = msa.q_mappings[0].grid
    x = torch.from_numpy(
        spline_inputs(rng, (n, heads * dh), grid[0].cpu().numpy())).cuda()
    g = torch.from_numpy(rng.standard_normal((n, heads * 3 * dh))
                         .astype(np.float32)).cuda()
    with torch.no_grad():
        inputs = [x, *msa.grouped_weights()]

    def plain(x, bw, sw, sc):
        return torch.cat([K.bspline_kan_forward(x[:, i * dh:(i + 1) * dh], grid,
                                                bw[i], sw[i], sc[i])
                          for i in range(heads)], dim=1)

    _, _, got = grads_of(torch, lambda *a: FB.bspline_qkv_grouped(a[0], grid, *a[1:]),
                         inputs, g)
    leaves, out, want = grads_of(torch, plain, inputs, g)
    torch.cuda.synchronize()
    err = compare_grads(f"bspline_qkv_grouped_bwd {label} N={n} H={heads} dh={dh}",
                        ("x", "bw", "sw", "sc"), got, want)
    w = FB.pack_qkv_weight(*inputs[1:]).contiguous()
    ms = time_ms(torch, lambda: FB._launch_bwd("bspline_qkv_grouped_bwd", "bspline",
                                               x, w, grid, g, True, True))
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                          retain_graph=True))
    print(f"[kernel] bspline_qkv_grouped_bwd {label}: kernel {ms:.4f} ms  "
          f"plain autograd {plain_ms:.4f} ms")
    return err, ms, plain_ms, kan_bound(n, heads, 9, dh, 3 * dh, True)


def check_attention_bwd(torch, rng, b, t, heads, dh, label, cases):
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    y = torch.from_numpy(rng.standard_normal((b * t, heads * 3 * dh))
                         .astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((b, t, heads * dh))
                         .astype(np.float32)).cuda()

    def through(attn, causal, mask):
        def fn(y):
            y4 = y.view(b, t, heads, 3 * dh)
            q, k, v = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
            return attn(q, k, v, heads, causal=causal, mask=mask)
        return fn

    errs = []
    for causal, mask in cases:
        _, _, (got,) = grads_of(torch, through(FA.flash_attention_lanes, causal, mask),
                                [y], g)
        _, _, (want,) = grads_of(torch, through(A.lanes_attention, causal, mask),
                                 [y], g)
        torch.cuda.synchronize()
        tag = f"causal={causal} mask={'none' if mask is None else 'yes'}"
        errs.append(compare(f"flash_attention_lanes_bwd {label} B={b} T={t} "
                            f"H={heads} dh={dh} {tag} dqkv", got, want, TOL_BWD))
        if mask is not None:
            dead = ~A.key_valid(mask, b, t, mask.device).any(dim=1)
            check(bool((got.view(b, t, -1)[dead] == 0).all()),
                  "a fully masked batch item must get gradients of exactly 0")
    causal, mask = cases[0]
    y4 = y.view(b, t, heads, 3 * dh)
    q4, k4, v4 = (y4[..., i * dh:(i + 1) * dh] for i in range(3))
    maskb = None if mask is None else A.key_valid(mask, b, t, y.device).to(torch.uint8)
    o, stats = FA._launch(q4, k4, v4, maskb, causal, True)
    ms = time_ms(torch, lambda: FA._launch_bwd(q4, k4, v4, maskb, o, stats, g, causal))
    leaves, out, _ = grads_of(torch, through(A.lanes_attention, causal, mask), [y], g)
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                          retain_graph=True))
    lib_ms = sdpa_ms(torch, q4.transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2),
                     causal, mask, backward="qkv")
    print(f"[kernel] flash_attention_lanes_bwd {label}: kernel {ms:.4f} ms  "
          f"plain autograd {plain_ms:.4f} ms  scaled_dot_product_attention backward "
          f"{lib_ms:.4f} ms")
    return errs[0], ms, plain_ms, attention_bound(b, heads, t, t, dh, causal, "bwd",
                                                  lib_ms)


def phase_backward_kernels(torch):
    rng = np.random.default_rng(SEED + 3)
    results = {
        "bspline_kan_bwd": check_bspline_bwd(torch, rng, BATCH * 196, 768, 384,
                                             "vit-s embedder"),
        "bspline_qkv_grouped_bwd": check_qkv_bwd(torch, rng, BATCH * 197, 6, 64,
                                                 "vit-s q/k/v"),
        "flash_attention_lanes_bwd": check_attention_bwd(
            torch, rng, BATCH, 197, 6, 64, "vit-s", [(False, None)]),
    }
    # ragged, narrow: the reference MNIST geometry with an odd batch of 37
    check_bspline_bwd(torch, rng, 37 * 49, 16, 64, "mnist embedder")
    check_qkv_bwd(torch, rng, 37 * 50, 2, 32, "mnist q/k/v")
    mask = torch.from_numpy(rng.random((37, 50)) > 0.2).cuda()
    mask[0] = False          # batch item 0: every row fully masked
    mask[1, 0] = False       # batch item 1, causal: query 0 sees no key
    check_attention_bwd(torch, rng, 37, 50, 2, 32, "mnist",
                        [(False, mask), (True, mask), (True, None)])
    return results


# --------------------------------------------------------------------------
# Phase 5: the tiled attention kernels against their plain versions
# --------------------------------------------------------------------------

def flash_inputs(torch, rng, b, h, tq, tk, dh):
    """q, k, v as ``(B, H, T, dh)`` views of ``(B, T, H, dh)`` tensors, the
    layout ``FlashAttentionBlock`` hands them over in."""
    def draw(t):
        return torch.from_numpy(rng.standard_normal((b, t, h, dh))
                                .astype(np.float32)).cuda().transpose(1, 2)
    return draw(tq), draw(tk), draw(tk)


def check_flash(torch, rng, b, h, tq, tk, dh, causal, mask, label, iters):
    """Forward, dq and dk/dv of ``flash_attention`` (tiled tier, buckets
    512/1024) against ``flash_attention_reference`` and autograd through
    it; times of each kernel alone and of its plain counterpart (the plain
    forward; autograd's backward to q, and to k and v). Returns ``(o, v,
    {kernel: (err, ms, plain_ms)})``."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    q, k, v = flash_inputs(torch, rng, b, h, tq, tk, dh)
    g = torch.from_numpy(rng.standard_normal((b, h, tq, dh)).astype(np.float32)).cuda()
    keys = None if mask is None else A.key_valid(mask, b, tk, mask.device)
    check(not FA.use_small(tq, tk, dh, h, 512, 1024), f"{label}: not the tiled tier")

    def kernel(*a):
        return FA.flash_attention(*a, causal, 512, 1024, mask)

    def plain(*a):
        return A.flash_attention_reference(*a, causal, 512, 1024, keys)[0]

    tag = (f"{label} B={b} H={h} Tq={tq} Tk={tk} dh={dh} causal={causal} "
           f"mask={'none' if mask is None else 'yes'}")
    with torch.inference_mode():
        o = kernel(q, k, v)
        err_fwd = compare(f"flash_attention {tag}", o, plain(q, k, v), TOL_ATTN)
    _, _, got = grads_of(torch, kernel, [q, k, v], g)
    leaves, out, want = grads_of(torch, plain, [q, k, v], g)
    torch.cuda.synchronize()
    err_dq = compare(f"flash_attention_dq {tag} dq", got[0], want[0], TOL_BWD)
    err_dkv = max(compare(f"flash_attention_dkv {tag} d{nm}", a, w, TOL_BWD)
                  for nm, a, w in zip("kv", got[1:], want[1:]))

    maskb = None if keys is None else keys.to(torch.uint8).contiguous()
    do = g.transpose(1, 2).contiguous()
    with torch.inference_mode():
        o4, stats = FA._launch_tiled(q, k, v, maskb, causal, True)
        _, delta = FA._launch_tiled_dq(q, k, v, maskb, o4, stats, do, causal)
        ms = {
            "fwd": time_ms(torch, lambda: FA._launch_tiled(q, k, v, maskb, causal,
                                                           False), iters, 2),
            "dq": time_ms(torch, lambda: FA._launch_tiled_dq(
                q, k, v, maskb, o4, stats, do, causal), iters, 2),
            "dkv": time_ms(torch, lambda: FA._launch_tiled_dkv(
                q, k, v, maskb, stats, do, delta, causal), iters, 2),
            "plain fwd": time_ms(torch, lambda: plain(q, k, v), iters, 2),
        }
    ms["plain dq"] = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves[:1], g, retain_graph=True), iters, 2)
    ms["plain dkv"] = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves[1:], g, retain_graph=True), iters, 2)
    for part in ("fwd", "dq", "dkv"):
        ms[f"sdpa {part}"] = sdpa_ms(torch, q, k, v, causal, keys,
                                     None if part == "fwd" else part[1:], iters)
    print(f"[kernel] tiled attention {label}: " + "  ".join(
        f"{key} {val:.4f} ms" for key, val in ms.items()))
    bounds = {part: attention_bound(b, h, tq, tk, dh, causal and tq == tk, part,
                                    ms[f"sdpa {part}"]) for part in ("fwd", "dq", "dkv")}
    return o, v, {
        "flash_attention": (err_fwd, ms["fwd"], ms["plain fwd"], bounds["fwd"]),
        "flash_attention_dq": (err_dq, ms["dq"], ms["plain dq"], bounds["dq"]),
        "flash_attention_dkv": (err_dkv, ms["dkv"], ms["plain dkv"], bounds["dkv"]),
    }


def check_no_visible_key(torch, o, v, mask, rows, item, label):
    """Rows of ``item`` that see no valid key causally are the mean of v
    over every valid key (the tiled tier's semantics), or 0 with none."""
    valid = mask[item].bool()
    want = (v[item][:, valid].mean(dim=1) if bool(valid.any())
            else torch.zeros_like(v[item][:, 0]))
    err = float((o[item][:, rows] - want[:, None]).abs().max())
    print(f"[kernel] tiled attention {label}: rows with no visible valid key "
          f"against the mean of v over the valid keys: max|err| {err:.3e}")
    check(err <= TOL_ATTN * max(1.0, float(want.abs().max())),
          f"{label}: rows with no visible valid key are not the mean of v")


def check_single_tile(torch, rng):
    """``flash_attention`` where kanvit's ``_use_small`` holds: the lanes
    kernels on (B, T, H, dh) views, against ``lanes_attention``."""
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.ops import attention as A

    b, h, t, dh = 16, 4, 256, 64
    check(FA.use_small(t, t, dh, h, 512, 1024), "single tile: not the small tier")
    q, k, v = flash_inputs(torch, rng, b, h, t, t, dh)
    mask = torch.from_numpy(rng.random((b, t)) > 0.2).cuda()
    mask[0, :4] = False
    g = torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32)).cuda()

    def plain(*a):
        o = A.lanes_attention(*(x.transpose(1, 2) for x in a), h, causal=True,
                              mask=mask)
        return o.view(b, t, h, dh).transpose(1, 2)

    def kernel(*a):
        return FA.flash_attention(*a, True, 512, 1024, mask)

    reset_counts()
    leaves, out, got = grads_of(torch, kernel, [q, k, v], g)
    plain_leaves, ref, want = grads_of(torch, plain, [q, k, v], g)
    torch.cuda.synchronize()
    counts = launch_counts()
    tag = f"single-tile route B={b} H={h} T={t} dh={dh} causal masked"
    compare(f"flash_attention {tag}", out.detach(), ref.detach(), TOL_ATTN)
    compare_grads(f"flash_attention {tag}", ("q", "k", "v"), got, want)
    check(bool((out[0, :, :4] == 0).all()),
          "single tile: rows with no visible valid key must be 0")
    check(counts["flash_attention_lanes"] == 1 and counts["flash_attention_lanes_bwd"] == 1
          and counts["flash_attention"] == 0,
          f"single tile: launches {counts}, want one lanes forward and backward")
    with torch.inference_mode():
        ms = {"fwd": time_ms(torch, lambda: kernel(q, k, v)),
              "plain fwd": time_ms(torch, lambda: plain(q, k, v))}
    ms["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True))
    ms["plain bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        ref, plain_leaves, g, retain_graph=True))
    print(f"[kernel] {tag}: " + "  ".join(f"{key} {val:.4f} ms"
                                          for key, val in ms.items()))


def phase_flash_kernels(torch):
    rng = np.random.default_rng(SEED + 4)
    _, _, main = check_flash(torch, rng, 16, 4, 2048, 2048, 64, True, None,
                             "decoder seq 2048", iters=10)
    _, _, long = check_flash(torch, rng, 4, 4, 8192, 8192, 64, True, None,
                             "decoder seq 8192", iters=3)
    # tq < tk: rows 0-216 sit at qpos < 0 and see no key; item 1 masks every
    # key, item 0 keys 0-3
    mask = torch.from_numpy(rng.random((3, 517)) > 0.2).cuda()
    mask[0, :4] = False
    mask[1] = False
    o, v, _ = check_flash(torch, rng, 3, 2, 300, 517, 32, True, mask,
                          "ragged tq<tk masked", iters=3)
    for item in (0, 1, 2):
        check_no_visible_key(torch, o, v, mask, slice(0, 217), item,
                             f"ragged tq<tk masked, item {item}")
    # tq == tk, keys 0-3 masked: causal rows 0-3 see no valid key
    mask = torch.ones(2, 1000, dtype=torch.bool, device="cuda")
    mask[0, :4] = False
    o, v, _ = check_flash(torch, rng, 2, 2, 1000, 1000, 16, True, mask,
                          "keys 0-3 masked", iters=3)
    check_no_visible_key(torch, o, v, mask, slice(0, 4), 0, "keys 0-3 masked")
    check_single_tile(torch, rng)
    return {name: (*main[name], {"at_seq_8192_batch_4": {
        "max_abs_err": long[name][0], "ms": long[name][1],
        "plain_ms": long[name][2], **long[name][3]}}) for name in main}


# --------------------------------------------------------------------------
# Phases 6 and 7: the Chebyshev, Fourier, RBF and sine kernels
# --------------------------------------------------------------------------

def cheby_inputs(rng, shape, saturated):
    """Normal inputs with a share where tanh(x) rounds to +-1 in f32
    (|x| in [9.5, 20], either sign): there the kernels' derivative is
    T'_n(+-1) (1 - t^2) = 0, and must be finite."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, int(flat.size * saturated), replace=False)
    flat[idx] = (rng.uniform(9.5, 20.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    return x


def fourier_inputs(rng, shape):
    """Normal inputs, every 7th entry spread over [-10, 10]."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = rng.uniform(-10.0, 10.0, flat[::7].size).astype(np.float32)
    return x


def check_kan(torch, rng, name, label, kernel, plain, inputs, names, launches,
              shape, f64=False):
    """Forward, dx and the parameter gradients of a KAN wrapper against its
    plain version and autograd through it, on the card; the backward's bits
    repeated; CUDA-event times of the forward kernel, the backward kernels
    (everything, and as on the training path: no dx for an embedder), the
    plain forward and autograd's backward. ``launches`` is ``(forward(),
    backward(g), backward_train(g))``, the launches alone; ``shape`` ``(n,
    G, S, nin, out, extra floats)`` for the bound. ``f64``: also hold the
    gradients against autograd through the plain version in f64. Returns
    the ``(err, ms, plain_ms, extras...)`` of the forward and of the
    backward."""
    x = inputs[0]
    with torch.inference_mode():
        y = kernel(*inputs)
        ref = plain(*inputs)
        torch.cuda.synchronize()
        err_fwd = compare(f"{name} {label} {tuple(x.shape)}", y, ref, TOL_KAN)
    g = torch.from_numpy(rng.standard_normal(tuple(ref.shape))
                         .astype(np.float32)).cuda()
    _, _, got = grads_of(torch, kernel, inputs, g)
    leaves, out, want = grads_of(torch, plain, inputs, g)
    torch.cuda.synchronize()
    err_bwd = compare_grads(f"{name}_bwd {label}", names, got, want)
    if f64:
        _, _, want64 = grads_of(torch, lambda *a: plain(*a).double(),
                                [a.double() for a in inputs], g.double())
        for nm, a, b, c in zip(names, got, want, want64):
            scale = max(1.0, float(c.abs().max()))
            print(f"[kernel] {name}_bwd {label} d{nm} against f64: kernel "
                  f"{float((a.double() - c).abs().max()) / scale:.3e}, plain f32 "
                  f"{float((b.double() - c).abs().max()) / scale:.3e} (x max(1, max|g|))")
        compare_grads(f"{name}_bwd {label} against f64", names,
                      [a.double() for a in got], want64)
    _, _, again = grads_of(torch, kernel, inputs, g)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"[kernel] {name}_bwd {label}: a second backward repeats the bits: {same}")
    check(same, f"{name}_bwd {label}: a second backward gave other bits")
    fwd, bwd, bwd_train = launches
    with torch.inference_mode():
        ms = time_ms(torch, fwd)
        plain_ms = time_ms(torch, lambda: plain(*inputs))
    bwd_ms = time_ms(torch, lambda: bwd(g))
    train_ms = time_ms(torch, lambda: bwd_train(g))
    plain_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                              retain_graph=True))
    *dims, extra = shape
    print(f"[kernel] {name} {label}: forward kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
          f" | backward kernels, all gradients {bwd_ms:.4f} ms (no dx, as an "
          f"embedder's training step {train_ms:.4f} ms)  plain autograd "
          f"{plain_bwd_ms:.4f} ms")
    return ((err_fwd, ms, plain_ms, kan_bound(*dims, extra_floats=extra)),
            (err_bwd, bwd_ms, plain_bwd_ms, {"no_dx_ms": train_ms},
             kan_bound(*dims, backward=True, extra_floats=extra)))


def check_basis(torch, rng, name, family, label, kernel, plain, inputs, w, aux,
                names):
    """``check_kan`` for the Chebyshev and Fourier wrappers: ``w`` is the
    packed weight and ``aux`` the degree or grid size the kernels take."""
    from kanvit_torch.kernels import fused_basis as FB

    x, bname = inputs[0], f"{name}_bwd"
    launches = (lambda: FB._launch(name, family, x, w, aux),
                lambda g: FB._launch_bwd(bname, family, x, w, aux, g, True, True),
                lambda g: FB._launch_bwd(bname, family, x, w, aux, g, False, True))
    return check_kan(torch, rng, name, label, kernel, plain, inputs, names, launches,
                     (x.shape[0], *w.shape, 0))


def fast_inputs(rng, shape):
    """Normal inputs (std 1.5) with a share at |x| in [20, 60], where silu's
    sigmoid and the RBF's exp saturate and one entry dominates its row's
    LayerNorm, and the first row constant (the LayerNorm's variance 0)."""
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, flat.size // 50, replace=False)
    flat[idx] = (rng.uniform(20.0, 60.0, idx.size)
                 * rng.choice([-1.0, 1.0], idx.size)).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.5
    return x


def sine_inputs(rng, shape):
    """Normal inputs, every 7th entry spread over [-20, 20]: arguments of
    x freq + phase over several pi."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = rng.uniform(-20.0, 20.0, flat[::7].size).astype(np.float32)
    return x


def check_rbf(torch, rng, name, label, n, groups, nin, nout):
    """``fastkan`` (groups 1) or ``fastkan_qkv_grouped`` against the plain
    FastKAN forward (per head) and autograd through it: x, the LayerNorm's
    gamma and beta, spline and base weights, base bias."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    lead = () if groups == 1 else (groups,)
    x = cuda(fast_inputs(rng, (n, groups * nin)))
    params = [cuda(1 + 0.1 * rng.standard_normal((*lead, nin))),
              cuda(0.1 * rng.standard_normal((*lead, nin))),
              cuda(rng.standard_normal((*lead, nout, nin * 8)) / np.sqrt(nin * 8)),
              cuda(rng.standard_normal((*lead, nout, nin)) / np.sqrt(nin)),
              cuda(0.1 * rng.standard_normal((*lead, nout)))]
    grid, den = torch.linspace(-2.0, 2.0, 8, device="cuda"), 4.0 / 7.0
    if groups == 1:
        kernel = lambda x, ga, be, *w: FB.fastkan(x, ga, be, grid, den, *w)  # noqa: E731
        plain = lambda x, ga, be, *w: K.fastkan_forward(x, ga, be, grid, den, *w)  # noqa: E731
        w = FB.pack_fastkan_weight(params[2], params[3], 8).unsqueeze(0)
    else:
        kernel = lambda x, ga, be, *w: FB.fastkan_qkv_grouped(  # noqa: E731
            x, ga, be, grid, den, *w)

        def plain(x, ga, be, sw, bw, bb):
            return torch.cat([K.fastkan_forward(
                x[:, i * nin:(i + 1) * nin], ga[i], be[i], grid, den, sw[i], bw[i], bb[i])
                for i in range(groups)], dim=1)
        w = FB.pack_fastkan_qkv_weight(params[2], params[3], 8)
    w = w.contiguous()
    ga, be = (p.reshape(groups, nin) for p in params[:2])
    with torch.inference_mode():
        _, stats = FB._launch_rbf(name, x, w, ga, be, grid, den)
    bname = f"{name}_bwd"
    launches = (
        lambda: FB._launch_rbf(name, x, w, ga, be, grid, den),
        lambda g: FB._launch_rbf_bwd(bname, x, w, ga, be, grid, den, stats, g, True, True),
        lambda g: FB._launch_rbf_bwd(bname, x, w, ga, be, grid, den, stats, g, False,
                                     True))
    return check_kan(torch, rng, name, label, kernel, plain, [x, *params],
                     ("x", "gamma", "beta", "spline_weight", "base_weight", "base_bias"),
                     launches, (n, groups, 9, nin, nout, 2 * groups * nin + 8))


def check_sine(torch, rng, name, label, n, groups, nin, nout, grid_size):
    """``sinekan`` (groups 1) or ``sinekan_qkv_grouped`` against the plain
    SineKAN forward (per head) and autograd through it: x, freq, amplitudes,
    bias. At the embedder dfreq sums N * nin = 9.6M terms a slice: the
    gradients are held against f64 too."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    lead = () if groups == 1 else (groups,)
    x = cuda(sine_inputs(rng, (n, groups * nin)))
    k = np.arange(1, grid_size + 1)
    params = [cuda(k / (grid_size + 1) + 0.05 * rng.standard_normal((*lead, grid_size))),
              cuda(rng.uniform(-1.0, 1.0, (*lead, nout, nin, grid_size)) / nout / k),
              cuda(np.full((*lead, nout), 1.0 / nout))]
    phase = K.sinekan_phase_init(nin, grid_size).cuda()
    if groups == 1:
        kernel = lambda x, f, a, b: FB.sinekan(x, f, phase, a, b)  # noqa: E731
        plain = lambda x, f, a, b: K.sinekan_forward(  # noqa: E731
            x, f, phase.to(x.dtype), a, b)
        w = FB.pack_sine_weight(params[1])
    else:
        kernel = lambda x, f, a, b: FB.sinekan_qkv_grouped(x, f, phase, a, b)  # noqa: E731

        def plain(x, f, a, b):
            return torch.cat([K.sinekan_forward(x[:, i * nin:(i + 1) * nin], f[i],
                                                phase.to(x.dtype), a[i], b[i])
                              for i in range(groups)], dim=1)
        w = FB.pack_sine_qkv_weight(params[1])
    w, freq2d = w.contiguous(), params[0].reshape(groups, grid_size)
    bname = f"{name}_bwd"
    launches = (
        lambda: FB._launch_sine(name, x, w, freq2d, phase),
        lambda g: FB._launch_sine_bwd(bname, x, w, freq2d, phase, g, True, True),
        lambda g: FB._launch_sine_bwd(bname, x, w, freq2d, phase, g, False, True))
    return check_kan(torch, rng, name, label, kernel, plain, [x, *params],
                     ("x", "freq", "amplitudes", "bias"), launches,
                     (n, groups, grid_size, nin, nout, (groups + nin) * grid_size),
                     f64=groups == 1 and nin >= 768)


def phase_basis_kernels(torch):
    """``chebykan`` and ``fourierkan`` at the vit-s embedder (batch 64: 12,544
    patches, 768 -> 384; Fourier grid 28), ``cheby_qkv_grouped`` at the
    vit-s q/k/v (12,608 tokens, 6 heads, 64 -> 192 each), and ragged narrow
    shapes of each. Coefficients of unit output scale."""
    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    rng = np.random.default_rng(SEED + 6)

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    results = {}

    def keep(name, fwd_bwd):
        results.setdefault(name, fwd_bwd[0])
        results.setdefault(f"{name}_bwd", fwd_bwd[1])

    for n, nin, nout, label in ((BATCH * 196, 768, 384, "vit-s embedder"),
                                (1000, 16, 24, "ragged")):
        x = cuda(cheby_inputs(rng, (n, nin), 0.1))
        cc = cuda(rng.standard_normal((nin, nout, 5)) / np.sqrt(nin * 5))
        keep("chebykan", check_basis(
            torch, rng, "chebykan", "cheby", label, FB.chebykan,
            K.chebykan_forward, [x, cc], FB.pack_cheby_weight(cc).contiguous(), 4,
            ("x", "coeffs")))
    for n, h, dh, label in ((BATCH * 197, 6, 64, "vit-s q/k/v"),
                            (37 * 50, 2, 32, "ragged")):
        x = cuda(cheby_inputs(rng, (n, h * dh), 0.02))
        cc = cuda(rng.standard_normal((h, dh, 3 * dh, 5)) / np.sqrt(dh * 5))

        def plain(x, cc, h=h, dh=dh):
            return torch.cat([K.chebykan_forward(x[:, i * dh:(i + 1) * dh], cc[i])
                              for i in range(h)], dim=1)

        keep("cheby_qkv_grouped", check_basis(
            torch, rng, "cheby_qkv_grouped", "cheby", label, FB.cheby_qkv_grouped,
            plain, [x, cc], FB.pack_cheby_qkv_weight(cc).contiguous(), 4,
            ("x", "cc")))
    for n, nin, nout, gs, label in ((BATCH * 196, 768, 384, 28, "vit-s embedder G28"),
                                    (1000, 16, 24, 5, "ragged G5"),
                                    (999, 20, 70, 7, "ragged G7")):
        x = cuda(fourier_inputs(rng, (n, nin)))
        co = cuda(rng.standard_normal((2, nout, nin, gs)) / np.sqrt(nin * gs))
        bias = cuda(rng.standard_normal((1, nout)) * 0.1)
        keep("fourierkan", check_basis(
            torch, rng, "fourierkan", "fourier", label, FB.fourierkan,
            K.fourierkan_forward, [x, co, bias], FB.pack_fourier_weight(co).contiguous(),
            gs, ("x", "coeffs", "bias")))
    return results


def phase_rbf_sine_kernels(torch):
    """``fastkan`` and ``sinekan`` (grid 28) at the vit-s embedder (12,544
    patches, 768 -> 384), ``fastkan_qkv_grouped`` and ``sinekan_qkv_grouped``
    (grid 4) at one vit-s q/k/v projection (12,608 tokens, 6 heads of 64 ->
    64), and ragged narrow shapes of each (nin 16, d_head 32, odd N)."""
    rng = np.random.default_rng(SEED + 9)
    results = {}

    def keep(name, fwd_bwd):
        results.setdefault(name, fwd_bwd[0])
        results.setdefault(f"{name}_bwd", fwd_bwd[1])

    for n, nin, nout, label in ((BATCH * 196, 768, 384, "vit-s embedder"),
                                (37 * 49, 16, 64, "ragged")):
        keep("fastkan", check_rbf(torch, rng, "fastkan", label, n, 1, nin, nout))
    for n, h, dh, label in ((BATCH * 197, 6, 64, "vit-s q/k/v"),
                            (37 * 50 - 1, 2, 32, "ragged")):
        keep("fastkan_qkv_grouped", check_rbf(torch, rng, "fastkan_qkv_grouped",
                                              label, n, h, dh, dh))
    for n, nin, nout, gs, label in ((BATCH * 196, 768, 384, 28, "vit-s embedder G28"),
                                    (37 * 49, 16, 64, 28, "ragged G28"),
                                    (999, 20, 70, 7, "ragged G7")):
        keep("sinekan", check_sine(torch, rng, "sinekan", label, n, 1, nin, nout, gs))
    for n, h, dh, label in ((BATCH * 197, 6, 64, "vit-s q/k/v"),
                            (37 * 50 - 1, 2, 32, "ragged")):
        keep("sinekan_qkv_grouped", check_sine(torch, rng, "sinekan_qkv_grouped",
                                               label, n, h, dh, dh, 4))
    return results


# --------------------------------------------------------------------------
# Phase 8: serving
# --------------------------------------------------------------------------

def launch_counts():
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.kernels import fused_basis as FB

    return {**FB.LAUNCHES, **FA.LAUNCHES}


def reset_counts():
    from kanvit_torch.kernels import flash_attention as FA
    from kanvit_torch.kernels import fused_basis as FB

    FB.reset_launches()
    FA.reset_launches()


def build_model(variant):
    from kanvit_torch.models import PRESETS, create_model

    t0 = time.perf_counter()
    model_cpu = create_model(variant, **PRESETS["vit-s"], seed=SEED)
    n_params = sum(p.numel() for p in model_cpu.parameters())
    print(f"[main] vit-s {variant} f32: {n_params} params, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return model_cpu


def phase_serve(torch, smi, model_cpu, tag, per_batch, seed):
    """Serve three requests (64, 64 and 37 images) through ``Predictor``:
    exactly ``per_batch`` kernel launches a forward batch and no backward
    launch, finite logits of the right shapes, probabilities that sum to 1,
    two images' logits against the same model's CPU forward, and the
    steady-state images/s."""
    from kanvit_torch.infer import Predictor
    from kanvit_torch.models import PRESETS

    geom = PRESETS["vit-s"]
    model = copy.deepcopy(model_cpu).to("cuda")
    pred = Predictor(model, batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((sum(REQUESTS), *geom["chw"])).astype(np.float32)
    bounds = np.cumsum((0,) + REQUESTS)
    reqs = [images[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]

    reset_counts()
    logits = [pred.logits(reqs[0]), pred.logits(reqs[1])]
    labels, probs = pred.predict(reqs[2])
    torch.cuda.synchronize()
    counts = launch_counts()
    n_fwd = len(REQUESTS)  # each request is one padded batch
    want = {k: 0 for k in counts}
    want.update({k: n_fwd * n for k, n in per_batch.items()})
    print(f"[{tag}] vit-s {model_cpu.type} launches over {n_fwd} forward batches: "
          f"{ {k: n for k, n in counts.items() if n} } (want per batch {per_batch}, "
          "nothing else, no backward)")
    check(counts == want, f"{tag}: launch counts {counts} != {want}")
    for r, y in zip(reqs, logits):
        check(y.shape == (len(r), geom["out_d"]), f"{tag}: logits shape {y.shape}")
        check(bool(np.isfinite(y).all()), f"{tag}: logits are not finite")
    check(probs.shape == (REQUESTS[2], geom["out_d"]) and labels.shape == (REQUESTS[2],),
          f"{tag}: predict shapes {probs.shape}, {labels.shape}")
    check(bool(np.isfinite(probs).all())
          and float(np.abs(probs.sum(-1) - 1).max()) < 1e-6,
          f"{tag}: predict probabilities do not sum to 1")

    with torch.inference_mode():
        ref = model_cpu(torch.from_numpy(reqs[0][:2])).numpy()
    err = float(np.abs(logits[0][:2] - ref).max())
    print(f"[{tag}] logits of 2 images, GPU against CPU plain forward: max|err| "
          f"{err:.3e}  limit {TOL_LOGITS:.0e}")
    check(err <= TOL_LOGITS, f"{tag}: GPU logits differ from the CPU forward by {err}")

    # steady state, batch 64: host images in, host logits out
    batch = reqs[0]
    for _ in range(3):
        pred.logits(batch)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        pred.logits(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ips = iters * BATCH / secs
    x = torch.from_numpy(batch).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: model(x), iters=10)
    print(f"[{tag}] Predictor.logits steady state, batch {BATCH}: {ips:.1f} images/s "
          f"({secs / iters * 1e3:.2f} ms per batch, host to host); device forward "
          f"{fwd_ms:.2f} ms per batch ({BATCH / fwd_ms * 1e3:.1f} images/s)  "
          f"[{smi}]")
    return {"images_per_s": ips, "device_forward_ms": fwd_ms,
            "logits_err": err, "launches": counts}


# --------------------------------------------------------------------------
# Phase 9: training
# --------------------------------------------------------------------------

def device_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    return out, (start, end)


def grad_scale(name, grads):
    """max|g| of a tensor's CPU gradient; for a key projection's bias (Linear,
    FastKAN base branch or SineKAN) that of the projection's weight. The
    softmax cancels the bias (it adds the same q . b to every score of a
    row), so its gradient is 0 in exact arithmetic and rounding noise on
    both sides."""
    m = re.fullmatch(r"(.*\.k_mappings\.\d+\.)(base_linear\.)?bias", name)
    if m:
        name = next(m.group(1) + w for w in ("weight", "base_linear.weight", "amplitudes")
                    if m.group(1) + w in grads)
    return float(grads[name].abs().max())


def grads_against(got, want):
    """The worst ``max|got - want| / grad_scale`` over tensors, and its name."""
    worst, worst_name = 0.0, ""
    for name, g in want.items():
        scale = grad_scale(name, want)
        err = float((got[name] - g).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def relu_patterns(torch, net, impose=None):
    """Forward hooks on every ReLU of ``net``: record each one's pattern
    (output > 0) into the returned dict, or, given ``impose`` (such a dict),
    compute ``input * pattern`` instead, so that the net takes the same
    linear piece as the run that recorded it. f32 rounding puts some
    pre-activations that lie within it of 0 on the other side (a few of
    vit-s's 14.5M a batch of 4), and each such flip moves its block's FF
    gradient by up to ~4e-3 of the tensor's max; on one pattern the
    gradients of the f32 run and of f64 differ by rounding alone. Returns
    ``(patterns, hooks)``."""
    seen, hooks = {}, []

    def record(name):
        return lambda mod, inp, out: seen.__setitem__(name, (out > 0).cpu())

    def follow(name):
        return lambda mod, inp, out: inp[0] * impose[name].to(inp[0].device,
                                                               inp[0].dtype)

    for name, mod in net.named_modules():
        if isinstance(mod, torch.nn.ReLU):
            hook = record(name) if impose is None else follow(name)
            hooks.append(mod.register_forward_hook(hook))
    return seen, hooks


# The launcher of each embedder's backward, whose last two arguments are
# (need_dx, need_dw).
EMBEDDER_BWD = {"fastkan": "_launch_rbf_bwd", "sinekan": "_launch_sine_bwd"}


def phase_train(torch, smi, model_cpu, tag, per_step_fwd, embedder):
    """6 Adam steps at batch 64 on one batch through ``kanvit_torch.train``:
    exactly ``per_step_fwd`` forward launches a step and as many backward
    ones, the embedder's (``embedder``) asked for no dx; losses finite
    and falling; 4-image gradients against the CPU; ms a step and images/s;
    the device time's split and a ``torch.profiler`` breakdown."""
    import torch.nn.functional as F

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.models import PRESETS
    from kanvit_torch.train import create_train_state, make_train_step

    geom = PRESETS["vit-s"]
    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal((BATCH, *geom["chw"]))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, geom["out_d"], BATCH)).cuda()
    state = create_train_state(model, 1e-3)
    step = make_train_step()
    per_step = {k: 0 for k in launch_counts()}
    per_step.update(per_step_fwd)
    per_step.update({f"{k}_bwd": n for k, n in per_step_fwd.items()})

    asked = []  # (need_dx, need_dw) of each embedder backward launch
    attr = EMBEDDER_BWD.get(embedder, "_launch_bwd")
    launch_bwd = getattr(FB, attr)

    def recording_launch_bwd(name, *args):
        if name == f"{embedder}_bwd":
            asked.append(tuple(args[-2:]))
        return launch_bwd(name, *args)

    reset_counts()
    losses, steps_ok = [], True
    setattr(FB, attr, recording_launch_bwd)
    try:
        for _ in range(TRAIN_STEPS):
            before = launch_counts()
            state, loss, logits = step(state, x, y)
            after = launch_counts()
            steps_ok &= {k: after[k] - before[k] for k in after} == per_step
            losses.append(loss)
    finally:
        setattr(FB, attr, launch_bwd)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(v) for v in losses]
    print(f"[{tag}] vit-s {model_cpu.type} batch {BATCH}, {TRAIN_STEPS} Adam(1e-3) "
          f"steps on one batch: losses {[round(v, 6) for v in losses]}")
    print(f"[{tag}] launches over {TRAIN_STEPS} steps: "
          f"{ {k: n for k, n in counts.items() if n} } (want per step "
          f"{ {k: n for k, n in per_step.items() if n} }, nothing else); the "
          f"embedder's backward asked for (dx, dW): {sorted(set(asked))}")
    check(steps_ok, f"{tag}: a training step's launches differ from {per_step}")
    check(asked == [(False, True)] * TRAIN_STEPS,
          f"{tag}: the embedder's backward must compute no dx, got {asked}")
    check(all(np.isfinite(losses)), f"{tag}: training losses are not finite: {losses}")
    check(losses[-1] < losses[0], f"{tag}: loss did not fall: {losses}")
    check(tuple(logits.shape) == (BATCH, geom["out_d"])
          and bool(logits.isfinite().all()), f"{tag}: training logits")

    # gradients of a small batch on the card against the same model's on the
    # CPU in f64, on the card's own ReLU pattern (see relu_patterns), the
    # free f64 and the CPU's f32 gradients beside them
    xg, yg = x[:GRAD_IMAGES], y[:GRAD_IMAGES]
    grads, patterns = {}, {}
    for key, net, dtype in (("gpu", copy.deepcopy(model_cpu).to("cuda"), torch.float32),
                            ("cpu", copy.deepcopy(model_cpu), torch.float32),
                            ("cpu64", copy.deepcopy(model_cpu).double(), torch.float64),
                            ("cpu64_gpu_relus", copy.deepcopy(model_cpu).double(),
                             torch.float64)):
        dev = next(net.parameters()).device
        seen, hooks = relu_patterns(torch, net, patterns.get("gpu")
                                    if key == "cpu64_gpu_relus" else None)
        F.cross_entropy(net(xg.to(dev, dtype)), yg.to(dev)).backward()
        for h in hooks:
            h.remove()
        patterns[key] = seen
        grads[key] = {name: p.grad.double().cpu() for name, p in net.named_parameters()}
    flips = sum(int((patterns["gpu"][k] != patterns["cpu64"][k]).sum())
                for k in patterns["gpu"])
    worst, worst_name = grads_against(grads["gpu"], grads["cpu64_gpu_relus"])
    free_worst, free_name = grads_against(grads["gpu"], grads["cpu64"])
    cpu_worst, cpu_name = grads_against(grads["cpu"], grads["cpu64"])
    f32_worst, f32_name = grads_against(grads["gpu"], grads["cpu"])
    print(f"[{tag}] gradients of {GRAD_IMAGES} images, per tensor, worst max|err| / "
          f"max|g|: GPU against CPU f64 on the GPU's ReLU pattern {worst:.3e} "
          f"({worst_name})  limit {TOL_GRADS:.0e}; against free CPU f64 "
          f"{free_worst:.3e} ({free_name}; {flips} ReLU outputs of the GPU's "
          f"forward on the other side of 0 than f64's); CPU f32 against CPU f64 "
          f"{cpu_worst:.3e} ({cpu_name}); GPU against CPU f32 {f32_worst:.3e} "
          f"({f32_name})")
    check(worst <= TOL_GRADS, f"{tag}: GPU gradients differ from the CPU's: "
                              f"{worst_name} {worst:.3e}")

    # steady state: host clock around a synchronised window, as the bench,
    # and CUDA events around the same window
    for _ in range(2):
        state, loss, _ = step(state, x, y)
    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, window = device_ms(torch, lambda: [step(state, x, y) for _ in range(iters)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    step_ms, ips = secs / iters * 1e3, iters * BATCH / secs
    dev_step_ms = window[0].elapsed_time(window[1]) / iters

    # device time of forward + loss, backward and the optimizer, CUDA events
    parts = {"forward+loss": [], "backward": [], "optimizer": []}
    for _ in range(3):
        state.tx.zero_grad()
        loss, ev_f = device_ms(torch, lambda: F.cross_entropy(model(x), y))
        _, ev_b = device_ms(torch, loss.backward)
        _, ev_o = device_ms(torch, state.tx.step)
        torch.cuda.synchronize()
        for key, (a, b) in zip(parts, (ev_f, ev_b, ev_o)):
            parts[key].append(a.elapsed_time(b))
    parts = {k: float(np.median(v)) for k, v in parts.items()}
    total = sum(parts.values())
    print(f"[{tag}] steady state, vit-s {model_cpu.type} batch {BATCH}: "
          f"{step_ms:.2f} ms per step, {ips:.1f} images/s (host clock; CUDA events "
          f"{dev_step_ms:.2f} ms per step)  [{smi}]")
    print(f"[{tag}] device ms per step: " + ", ".join(
        f"{k} {v:.2f} ({v / total:.1%})" for k, v in parts.items()))
    profile = phase_profile(torch, step, state, x, y, f"vit-s {model_cpu.type}")
    return {"images_per_s": ips, "step_ms": step_ms, "launches": counts,
            "losses": losses, "grad_rel_err": worst, "parts_ms": parts,
            "profile": profile}


# KAN basis kernels are grouped by family too (their template argument).
KAN_FAMILIES = ("Bspline", "Cheby", "Fourier", "Rbf", "Sine")
KERNEL_GROUPS = (
    ("KAN basis fwd", ("kan_fwd_kernel",)),
    ("KAN basis bwd", ("kan_dx_kernel", "kan_dw_kernel", "sum_splits_kernel",
                       "sum_blocks_kernel")),
    ("RBF LayerNorm stats and VJP", ("ln_stats_kernel", "ln_dx_kernel", "ln_dgb_kernel")),
    ("attention fwd", ("attention_lanes_fwd_kernel",)),
    ("attention bwd", ("attention_lanes_dq_kernel", "attention_lanes_dkv_kernel")),
    ("tiled attention fwd", ("flash_fwd_kernel",)),
    ("tiled attention dq", ("flash_dq_kernel",)),
    ("tiled attention dk/dv", ("flash_dkv_kernel",)),
    ("GEMM (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_", "sm80_")),
    ("Adam", ("multi_tensor", "adam", "Adam")),
)


def phase_profile(torch, step, state, x, y, label, steps=2):
    """Device time of ``steps`` training steps by kernel, from
    ``torch.profiler``; the idle share is of the window from the first
    kernel's start to the last kernel's end."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, x, y)
        torch.cuda.synchronize()
    # device-side events, without the GPU copies of record_function ranges
    # (they span kernels that are counted already)
    kernels = [e for e in prof.events()
               if "cuda" in str(getattr(e, "device_type", "")).lower()
               and not getattr(e, "is_user_annotation", False)]
    check(bool(kernels), "the profiler recorded no device time")
    busy = sum(e.time_range.end - e.time_range.start for e in kernels)
    window = (max(e.time_range.end for e in kernels)
              - min(e.time_range.start for e in kernels))
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    groups = {}
    for name, us in by_name.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other")
        family = next((f for f in KAN_FAMILIES if f in name), None)
        if group.startswith("KAN") and family:
            group = f"{group} ({family})"
        groups[group] = groups.get(group, 0.0) + us
    print(f"[profile] {steps} {label} training steps: device busy "
          f"{busy / steps / 1e3:.3f} ms per step, idle share "
          f"{1 - busy / window:.4f} of the device window")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {us / busy:6.1%}  {us / steps / 1e3:8.3f} ms/step  {group}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]     {us / steps / 1e3:8.3f} ms/step  {name[:110]}")
    return {"busy_ms_per_step": busy / steps / 1e3, "idle_share": 1 - busy / window,
            "groups_ms_per_step": {k: v / steps / 1e3 for k, v in groups.items()}}


# --------------------------------------------------------------------------
# Phase 10: decoder training
# --------------------------------------------------------------------------

def decoder_parts(torch, model, tokens):
    """Device ms of forward + loss, backward and an Adam step (CUDA events),
    medians of 3."""
    from kanvit_torch import bench_decoder as BD

    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    parts = {"forward+loss": [], "backward": [], "optimizer": []}
    for _ in range(3):
        opt.zero_grad()
        loss, ev_f = device_ms(torch, lambda: BD.lm_loss(model(tokens), tokens))
        _, ev_b = device_ms(torch, loss.backward)
        _, ev_o = device_ms(torch, opt.step)
        torch.cuda.synchronize()
        for key, (a, b) in zip(parts, (ev_f, ev_b, ev_o)):
            parts[key].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in parts.items()}


def decoder_grads_against_cpu(torch, tokens):
    """Parameter gradients of a 1-sequence batch on the card against the
    same model's on the CPU; the worst max|err| / max|g| over tensors."""
    from kanvit_torch import bench_decoder as BD

    cpu = BD.build_model(**DECODER, seed=SEED)
    gpu = copy.deepcopy(cpu).cuda()
    one = tokens[:1]
    BD.lm_loss(gpu(one), one).backward()
    BD.lm_loss(cpu(one.cpu()), one.cpu()).backward()
    worst, worst_name = 0.0, ""
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        scale = float(pc.grad.abs().max())
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name


def phase_decoder(torch, smi):
    from kanvit_torch import bench_decoder as BD

    blocks = DECODER["n_blocks"]
    per_step = {k: 0 for k in launch_counts()}
    per_step.update(flash_attention=blocks, flash_attention_dq=blocks,
                    flash_attention_dkv=blocks)
    launches = {k: 0 for k in per_step}
    out = []
    for seq, batch in DECODER_CONFIGS:
        model = BD.build_model(**DECODER, seed=SEED).cuda()
        tokens = BD.make_tokens(batch, seq, DECODER["vocab"], SEED).cuda()
        step = BD.make_step(model)
        reset_counts()
        losses, steps_ok = [], True
        for _ in range(TRAIN_STEPS):
            before = launch_counts()
            losses.append(step(tokens))
            after = launch_counts()
            steps_ok &= {k: after[k] - before[k] for k in after} == per_step
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {k: launches[k] + counts[k] for k in launches}
        losses = [float(v) for v in losses]
        label = f"decoder seq {seq} batch {batch}"
        print(f"[decoder] {label}, {TRAIN_STEPS} Adam(1e-3) steps on one batch: "
              f"losses {[round(v, 6) for v in losses]}")
        print(f"[decoder] launches over {TRAIN_STEPS} steps: {counts} (want per "
              f"step {blocks} tiled forward, {blocks} dq, {blocks} dk/dv, nothing else)")
        check(steps_ok, f"{label}: a step's launches differ from {per_step}")
        check(all(np.isfinite(losses)), f"{label}: losses are not finite: {losses}")
        check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
        result = {"seq": seq, "batch": batch, "losses": losses}
        if seq == DECODER_CONFIGS[0][0]:
            worst, name = decoder_grads_against_cpu(torch, tokens)
            print(f"[decoder] {label}: gradients of 1 sequence, GPU against CPU, per "
                  f"tensor: worst max|err| / max|g| {worst:.3e} ({name})  limit "
                  f"{TOL_GRADS:.0e}")
            check(worst <= TOL_GRADS, f"{label}: GPU gradients differ from the "
                                      f"CPU's: {name} {worst:.3e}")
            result["grad_rel_err"] = worst
        parts = decoder_parts(torch, model, tokens)
        total = sum(parts.values())
        print(f"[decoder] {label}: device ms per step: " + ", ".join(
            f"{k} {v:.2f} ({v / total:.1%})" for k, v in parts.items()))
        result["parts_ms"] = parts
        result["profile"] = phase_profile(torch, lambda *_: step(tokens), None, None,
                                          None, label)
        impls = ("kernel", "plain") if seq == DECODER_CONFIGS[0][0] else ("kernel",)
        for impl in impls:
            r = BD.bench_config(seq, batch, **DECODER, steps=5, warmup=2, impl=impl,
                                seed=SEED)
            print(f"[decoder] {json.dumps(r)}")
            print(f"[decoder] {label} impl={impl}: {r['tokens_per_sec']:.1f} tokens/s, "
                  f"{r['step_ms']:.2f} ms per step  [{smi}]")
            check(np.isfinite(r["loss"]) and r["step_ms"] > 0, f"{label}: bench result")
            result[impl] = r
        out.append(result)
        del model, step
        torch.cuda.empty_cache()
    return {"launches": launches, "configs": out}


# --------------------------------------------------------------------------
# Phase 11: the reference preset through the port's bench
# --------------------------------------------------------------------------

def phase_bench(torch, smi):
    from kanvit_torch import bench

    args = bench.parse_args(["--preset", "reference", "--batch-size", "128",
                             "--steps", "20", "--windows", "3", "--warmup", "5"])
    out = bench.run(args)
    print(f"[bench] {json.dumps(out)}")
    print(f"[bench] reference preset, batch 128: {out['value']} images/s, "
          f"{out['step_time_ms']} ms per step  [{smi}]")
    check(out["value"] > 0 and np.isfinite(out["step_time_ms"]), "bench result")

    # where the reference step's time goes
    from kanvit_torch.models import PRESETS, create_model
    from kanvit_torch.train import create_train_state, make_train_step

    geom = PRESETS["reference"]
    state = create_train_state(create_model("efficientkan", **geom, seed=SEED).cuda())
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((128, *geom["chw"]))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, geom["out_d"], 128)).cuda()
    step = make_train_step()
    for _ in range(3):
        step(state, x, y)
    phase_profile(torch, step, state, x, y, "reference", steps=3)
    return out


# --------------------------------------------------------------------------
# Phase 12: results
# --------------------------------------------------------------------------

KAN_SRC = "kanvit_torch/kernels/csrc/kan_basis.cu"
RBF_SINE_SRC = "kanvit_torch/kernels/csrc/kan_rbf_sine.cu"
FB_PY = "kanvit/kernels/fused_basis.py"
SOURCES = {
    "bspline_kan": (KAN_SRC, f"{FB_PY}:1067"),
    "bspline_qkv_grouped": (KAN_SRC, f"{FB_PY}:1240"),
    "flash_attention_lanes": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                              "kanvit/kernels/flash_attention.py:571"),
    "bspline_kan_bwd": (KAN_SRC, f"{FB_PY}:1159"),
    "bspline_qkv_grouped_bwd": (KAN_SRC, f"{FB_PY}:1278"),
    "flash_attention_lanes_bwd": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                                  "kanvit/kernels/flash_attention.py:604"),
    "flash_attention": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                        "kanvit/kernels/flash_attention.py:132"),
    "flash_attention_dq": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                           "kanvit/kernels/flash_attention.py:806"),
    "flash_attention_dkv": ("kanvit_torch/kernels/csrc/flash_attention.cu",
                            "kanvit/kernels/flash_attention.py:831"),
    "chebykan": (KAN_SRC, f"{FB_PY}:1067"),
    "chebykan_bwd": (KAN_SRC, f"{FB_PY}:1159"),
    "cheby_qkv_grouped": (KAN_SRC, f"{FB_PY}:1240"),
    "cheby_qkv_grouped_bwd": (KAN_SRC, f"{FB_PY}:1278"),
    "fourierkan": (KAN_SRC, f"{FB_PY}:2317"),
    "fourierkan_bwd": (KAN_SRC, f"{FB_PY}:2564"),
    "fastkan": (RBF_SINE_SRC, f"{FB_PY}:2947"),
    "fastkan_bwd": (RBF_SINE_SRC, f"{FB_PY}:2995"),
    "fastkan_qkv_grouped": (RBF_SINE_SRC, f"{FB_PY}:3191"),
    "fastkan_qkv_grouped_bwd": (RBF_SINE_SRC, f"{FB_PY}:3246"),
    "sinekan": (RBF_SINE_SRC, f"{FB_PY}:2317"),
    "sinekan_bwd": (RBF_SINE_SRC, f"{FB_PY}:2523"),
    "sinekan_qkv_grouped": (RBF_SINE_SRC, f"{FB_PY}:1518"),
    "sinekan_qkv_grouped_bwd": (RBF_SINE_SRC, f"{FB_PY}:1557"),
}
# The single-tile tier of flash_attention runs the lanes kernels (phase 5);
# fourierkan's and sinekan's kernels serve kanvit's generic tier below its
# K-blocked one too, and their backward both the K-blocked dx and dW (sine's
# opt-in split-residual pair and basis-saving forward, and sinekan_qkv, are
# the same functions); fastkan's, with the LayerNorm or the silu slice off,
# serve _rbf_base_op and _rbf_op.
ALSO_REPLACES = {
    "flash_attention_lanes": ["kanvit/kernels/flash_attention.py:410"],
    "flash_attention_lanes_bwd": ["kanvit/kernels/flash_attention.py:442"],
    "bspline_kan": [f"{FB_PY}:777"],
    "bspline_kan_bwd": [f"{FB_PY}:810", f"{FB_PY}:969", f"{FB_PY}:1006"],
    "fourierkan": [f"{FB_PY}:1067"],
    "fourierkan_bwd": [f"{FB_PY}:2492", f"{FB_PY}:1159"],
    "fastkan": [f"{FB_PY}:2726", f"{FB_PY}:1067"],
    "fastkan_bwd": [f"{FB_PY}:2769", f"{FB_PY}:1159"],
    "sinekan": [f"{FB_PY}:1067", f"{FB_PY}:2354"],
    "sinekan_bwd": [f"{FB_PY}:2492", f"{FB_PY}:1728", f"{FB_PY}:2401",
                    f"{FB_PY}:2433"],
}
# The main path each kernel must have been launched on ("train" otherwise).
MAIN_PATH = {"flash_attention": "decoder", "flash_attention_dq": "decoder",
             "flash_attention_dkv": "decoder",
             "chebykan": "cheby_train", "chebykan_bwd": "cheby_train",
             "cheby_qkv_grouped": "cheby_train",
             "cheby_qkv_grouped_bwd": "cheby_train",
             "fourierkan": "fourier_train", "fourierkan_bwd": "fourier_train",
             **{f"{name}{sfx}": f"{variant}_train"
                for variant, names in (("fast", ("fastkan", "fastkan_qkv_grouped")),
                                       ("sine", ("sinekan", "sinekan_qkv_grouped")))
                for name in names for sfx in ("", "_bwd")}}


def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    torch, smi = phase_toolchain()
    timed("build", phase_build)
    results = timed("forward kernels", phase_kernels, torch)
    results.update(timed("backward kernels", phase_backward_kernels, torch))
    results.update(timed("tiled attention kernels", phase_flash_kernels, torch))
    results.update(timed("Chebyshev and Fourier kernels", phase_basis_kernels, torch))
    results.update(timed("RBF and sine kernels", phase_rbf_sine_kernels, torch))

    from kanvit_torch.models import PRESETS

    blocks = PRESETS["vit-s"]["n_blocks"]
    lanes = {"flash_attention_lanes": blocks}
    efficientkan = {"bspline_kan": 1, "bspline_qkv_grouped": blocks, **lanes}
    cheby = {"chebykan": 1, "cheby_qkv_grouped": blocks, **lanes}
    fourier = {"fourierkan": 1, **lanes}
    # one grouped launch per q, k and v projection
    fast = {"fastkan": 1, "fastkan_qkv_grouped": 3 * blocks, **lanes}
    sine = {"sinekan": 1, "sinekan_qkv_grouped": 3 * blocks, **lanes}
    paths = {}
    model_cpu = build_model("efficientkan")
    paths["serve"] = timed("efficientkan serving", phase_serve, torch, smi, model_cpu,
                           "main", efficientkan, SEED + 1)["launches"]
    paths["train"] = timed("efficientkan training", phase_train, torch, smi, model_cpu,
                           "train", efficientkan, "bspline_kan")["launches"]
    paths["decoder"] = timed("decoder training", phase_decoder, torch, smi)["launches"]
    paths["flash_serve"] = timed(
        "flash-attn serving", phase_serve, torch, smi, build_model("flash-attn"),
        "flash-serve", lanes, SEED + 5)["launches"]
    for variant, per_batch, embedder in (("cheby", cheby, "chebykan"),
                                         ("fourier", fourier, "fourierkan"),
                                         ("fast", fast, "fastkan"),
                                         ("sine", sine, "sinekan")):
        model_cpu = build_model(variant)
        paths[f"{variant}_serve"] = timed(
            f"{variant} serving", phase_serve, torch, smi, model_cpu,
            f"{variant}-serve", per_batch, SEED + 7)["launches"]
        paths[f"{variant}_train"] = timed(
            f"{variant} training", phase_train, torch, smi, model_cpu,
            f"{variant}-train", per_batch, embedder)["launches"]
    paths["vanilla_serve"] = timed(
        "vanilla serving", phase_serve, torch, smi, build_model("vanilla"),
        "vanilla-serve", lanes, SEED + 8)["launches"]
    timed("reference bench", phase_bench, torch, smi)
    kernels = []
    for name, (err, ms, plain_ms, *extra) in results.items():
        src, replaces = SOURCES[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        main_path = MAIN_PATH.get(name, "train")
        check(by_path[main_path] > 0, f"the {main_path} path never launched {name}")
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": by_path[main_path],
                 "launches_by_path": by_path,
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        for more in extra:
            entry.update(more)
        check({"bound_ms", "bound_by", "library_ms"} <= set(entry),
              f"{name}: no bound in its result")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

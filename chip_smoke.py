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
5. serving: ``create_model("efficientkan", **PRESETS["vit-s"])`` served by
   ``Predictor(batch_size=64, device="cuda")`` for three requests (64, 64
   and 37 images), with the launch count of every kernel (no backward
   launch), the logits of two images against the same model's CPU forward,
   and the steady-state images/s;
6. training: the same model, batch 64, 6 Adam steps on one fixed batch
   through ``kanvit_torch.train`` (loss finite and falling, exactly
   1 + 12 + 12 forward and 1 + 12 + 12 backward launches a step), the
   gradients of a 4-image batch against the same model's CPU gradients,
   the steady-state step time and images/s, and a ``torch.profiler``
   breakdown of one step;
7. the reference MNIST preset (batch 128) through ``kanvit_torch.bench``,
   whose JSON line is printed;
8. one JSON line of per-kernel results, the card's ``nvidia-smi`` line, and
   last the result line ``{"ok": true, "device": {...}}``.

It imports torch, numpy and kanvit_torch only (no jax).
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
BATCH = 64
REQUESTS = (64, 64, 37)
TOL_BSPLINE = 1e-4   # x max(1, max|y|): f32 sums of depth 6912 / 576 in another order
TOL_ATTN = 1e-5      # x max(1, max|y|): f32 softmax, reduction depth 197
TOL_LOGITS = 1e-3    # GPU against CPU logits, 12 blocks deep
# Backward kernels, x max(1, max|g|) per gradient: f32 sums of depth up to
# 12,608 rows (dW), 3,456 (dx) and 197 (attention) in another order than
# cuBLAS / autograd, and probabilities recomputed from the forward's (m, l).
TOL_BWD = 1e-4
# GPU against CPU parameter gradients of a 4-image step, x max|g| of each
# tensor: f32 through 12 blocks with every sum in another order on each side.
TOL_GRADS = 1e-3
TRAIN_STEPS = 6
GRAD_IMAGES = 4
SEED = 0


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
        ms = time_ms(torch, lambda: FB._launch("bspline_kan", x, layer.grid, w, 3))
        wrapper_ms = time_ms(torch, lambda: FB.bspline_kan(x, *p))
        plain_ms = time_ms(torch, lambda: K.bspline_kan_forward(x, *p))
    print(f"[kernel] bspline_kan {label}: kernel {ms:.4f} ms  (with weight packing "
          f"{wrapper_ms:.4f} ms)  plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


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
        ms = time_ms(torch, lambda: FB._launch("bspline_qkv_grouped", x, grid, w, 3))
        wrapper_ms = time_ms(torch, lambda: FB.bspline_qkv_grouped(x, grid, bw, sw, sc))
        plain_ms = time_ms(torch, plain)
    print(f"[kernel] bspline_qkv_grouped {label}: kernel {ms:.4f} ms  (with weight "
          f"packing {wrapper_ms:.4f} ms)  plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


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
    print(f"[kernel] flash_attention_lanes {label}: kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms")
    return errs[0], ms, plain_ms


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
    ms = time_ms(torch, lambda: FB._launch_bwd("bspline_kan_bwd", x, grid, w, g,
                                               True, True))
    dw_ms = time_ms(torch, lambda: FB._launch_bwd("bspline_kan_bwd", x, grid, w, g,
                                                  False, True))
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                          retain_graph=True))
    print(f"[kernel] bspline_kan_bwd {label}: kernel dx+dW {ms:.4f} ms (dW alone, "
          f"as on the training path, {dw_ms:.4f} ms)  plain autograd {plain_ms:.4f} ms")
    return err, ms, plain_ms


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
    ms = time_ms(torch, lambda: FB._launch_bwd("bspline_qkv_grouped_bwd", x, grid,
                                               w, g, True, True))
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(out, leaves, g,
                                                          retain_graph=True))
    print(f"[kernel] bspline_qkv_grouped_bwd {label}: kernel {ms:.4f} ms  "
          f"plain autograd {plain_ms:.4f} ms")
    return err, ms, plain_ms


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
    print(f"[kernel] flash_attention_lanes_bwd {label}: kernel {ms:.4f} ms  "
          f"plain autograd {plain_ms:.4f} ms")
    return errs[0], ms, plain_ms


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
# Phase 5: serving
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


def build_model():
    from kanvit_torch.models import PRESETS, create_model

    t0 = time.perf_counter()
    model_cpu = create_model("efficientkan", **PRESETS["vit-s"], seed=SEED)
    n_params = sum(p.numel() for p in model_cpu.parameters())
    print(f"[main] vit-s efficientkan f32: {n_params} params, built in "
          f"{time.perf_counter() - t0:.2f} s")
    return model_cpu


def phase_serve(torch, smi, model_cpu):
    from kanvit_torch.infer import Predictor
    from kanvit_torch.models import PRESETS

    geom = PRESETS["vit-s"]
    model = copy.deepcopy(model_cpu).to("cuda")
    pred = Predictor(model, batch_size=BATCH, device="cuda")
    rng = np.random.default_rng(SEED + 1)
    images = rng.standard_normal((sum(REQUESTS), *geom["chw"])).astype(np.float32)
    bounds = np.cumsum((0,) + REQUESTS)
    reqs = [images[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]

    reset_counts()
    logits = [pred.logits(reqs[0]), pred.logits(reqs[1])]
    labels, probs = pred.predict(reqs[2])
    torch.cuda.synchronize()
    counts = launch_counts()
    n_fwd = len(REQUESTS)  # each request is one padded batch
    blocks = geom["n_blocks"]
    want = {"bspline_kan": n_fwd, "bspline_qkv_grouped": n_fwd * blocks,
            "flash_attention_lanes": n_fwd * blocks, "bspline_kan_bwd": 0,
            "bspline_qkv_grouped_bwd": 0, "flash_attention_lanes_bwd": 0}
    print(f"[main] launches over {n_fwd} forward batches: {counts} "
          f"(want {want}: 1 + {blocks} + {blocks} per batch, no backward)")
    check(counts == want, f"launch counts {counts} != {want}")
    for r, y in zip(reqs, logits):
        check(y.shape == (len(r), geom["out_d"]), f"logits shape {y.shape}")
        check(bool(np.isfinite(y).all()), "logits are not finite")
    check(probs.shape == (REQUESTS[2], geom["out_d"]) and labels.shape == (REQUESTS[2],),
          f"predict shapes {probs.shape}, {labels.shape}")
    check(bool(np.isfinite(probs).all())
          and float(np.abs(probs.sum(-1) - 1).max()) < 1e-6,
          "predict probabilities do not sum to 1")

    with torch.inference_mode():
        ref = model_cpu(torch.from_numpy(reqs[0][:2])).numpy()
    err = float(np.abs(logits[0][:2] - ref).max())
    print(f"[main] logits of 2 images, GPU against CPU plain forward: max|err| "
          f"{err:.3e}  limit {TOL_LOGITS:.0e}")
    check(err <= TOL_LOGITS, f"GPU logits differ from the CPU forward by {err}")

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
    print(f"[main] Predictor.logits steady state, batch {BATCH}: {ips:.1f} images/s "
          f"({secs / iters * 1e3:.2f} ms per batch, host to host); device forward "
          f"{fwd_ms:.2f} ms per batch ({BATCH / fwd_ms * 1e3:.1f} images/s)  "
          f"[{smi}]")
    return {"images_per_s": ips, "device_forward_ms": fwd_ms,
            "logits_err": err, "launches": counts}


# --------------------------------------------------------------------------
# Phase 6: training
# --------------------------------------------------------------------------

def device_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    return out, (start, end)


def phase_train(torch, smi, model_cpu):
    import torch.nn.functional as F

    from kanvit_torch.models import PRESETS
    from kanvit_torch.train import create_train_state, make_train_step

    geom = PRESETS["vit-s"]
    blocks = geom["n_blocks"]
    model = copy.deepcopy(model_cpu).to("cuda")
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.standard_normal((BATCH, *geom["chw"]))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, geom["out_d"], BATCH)).cuda()
    state = create_train_state(model, 1e-3)
    step = make_train_step()
    per_step = {"bspline_kan": 1, "bspline_qkv_grouped": blocks,
                "flash_attention_lanes": blocks, "bspline_kan_bwd": 1,
                "bspline_qkv_grouped_bwd": blocks,
                "flash_attention_lanes_bwd": blocks}

    reset_counts()
    losses, steps_ok = [], True
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        state, loss, logits = step(state, x, y)
        after = launch_counts()
        steps_ok &= {k: after[k] - before[k] for k in after} == per_step
        losses.append(loss)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(v) for v in losses]
    print(f"[train] vit-s batch {BATCH}, {TRAIN_STEPS} Adam(1e-3) steps on one batch: "
          f"losses {[round(v, 6) for v in losses]}")
    print(f"[train] launches over {TRAIN_STEPS} steps: {counts} (want per step "
          f"{per_step}: 1 + {blocks} + {blocks} forward and backward)")
    check(steps_ok, f"a training step's launches differ from {per_step}")
    check(all(np.isfinite(losses)), f"training losses are not finite: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(tuple(logits.shape) == (BATCH, geom["out_d"])
          and bool(logits.isfinite().all()), "training logits")

    # gradients of a small batch on the card against the same model's CPU step
    xg, yg = x[:GRAD_IMAGES], y[:GRAD_IMAGES]
    gpu = copy.deepcopy(model_cpu).to("cuda")
    F.cross_entropy(gpu(xg), yg).backward()
    F.cross_entropy(model_cpu(xg.cpu()), yg.cpu()).backward()
    worst, worst_name = 0.0, ""
    for (name, pc), pg in zip(model_cpu.named_parameters(), gpu.parameters()):
        scale = float(pc.grad.abs().max())
        err = float((pg.grad.cpu() - pc.grad).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, name
        pc.grad = None
    print(f"[train] gradients of {GRAD_IMAGES} images, GPU against CPU, per tensor: "
          f"worst max|err| / max|g| {worst:.3e} ({worst_name})  limit {TOL_GRADS:.0e}")
    check(worst <= TOL_GRADS, f"GPU gradients differ from the CPU's: {worst_name} "
                              f"{worst:.3e}")

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
    print(f"[train] steady state, vit-s batch {BATCH}: {step_ms:.2f} ms per step, "
          f"{ips:.1f} images/s (host clock; CUDA events {dev_step_ms:.2f} ms per "
          f"step)  [{smi}]")
    print("[train] device ms per step: " + ", ".join(
        f"{k} {v:.2f} ({v / total:.1%})" for k, v in parts.items()))
    profile = phase_profile(torch, step, state, x, y, "vit-s")
    return {"images_per_s": ips, "step_ms": step_ms, "launches": counts,
            "losses": losses, "grad_rel_err": worst, "parts_ms": parts,
            "profile": profile}


KERNEL_GROUPS = (
    ("bspline fwd", ("bspline_kan_fwd_kernel",)),
    ("bspline bwd", ("bspline_kan_dx_kernel", "bspline_kan_dw_kernel",
                     "sum_splits_kernel")),
    ("attention fwd", ("attention_lanes_fwd_kernel",)),
    ("attention bwd", ("attention_lanes_dq_kernel", "attention_lanes_dkv_kernel")),
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
# Phase 7: the reference preset through the port's bench
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
# Phase 8: results
# --------------------------------------------------------------------------

SOURCES = {
    "bspline_kan": ("kanvit_torch/kernels/csrc/bspline_kan.cu",
                    "kanvit/kernels/fused_basis.py:1067"),
    "bspline_qkv_grouped": ("kanvit_torch/kernels/csrc/bspline_kan.cu",
                            "kanvit/kernels/fused_basis.py:1240"),
    "flash_attention_lanes": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                              "kanvit/kernels/flash_attention.py:571"),
    "bspline_kan_bwd": ("kanvit_torch/kernels/csrc/bspline_kan.cu",
                        "kanvit/kernels/fused_basis.py:1159"),
    "bspline_qkv_grouped_bwd": ("kanvit_torch/kernels/csrc/bspline_kan.cu",
                                "kanvit/kernels/fused_basis.py:1278"),
    "flash_attention_lanes_bwd": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                                  "kanvit/kernels/flash_attention.py:604"),
}


def main():
    torch, smi = phase_toolchain()
    phase_build()
    results = phase_kernels(torch)
    results.update(phase_backward_kernels(torch))
    model_cpu = build_model()
    serve = phase_serve(torch, smi, model_cpu)
    train = phase_train(torch, smi, model_cpu)
    phase_bench(torch, smi)
    kernels = []
    for name, (err, ms, plain_ms) in results.items():
        src, replaces = SOURCES[name]
        by_path = {"serve": serve["launches"][name], "train": train["launches"][name]}
        check(by_path["train"] > 0, f"the training path never launched {name}")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

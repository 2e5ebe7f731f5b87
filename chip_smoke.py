"""Drive the kanvit_torch serving path once on one NVIDIA GPU and check it.

Run from the root of a kanvit checkout on a machine with a CUDA device and
the CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero:

1. toolchain and card: torch, CUDA and nvcc versions, the card's name and
   power limit; no CUDA device is an error, never a fall-back to the CPU;
2. build the CUDA kernels from ``kanvit_torch/kernels/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes (vit-s, batch 64) and at a ragged narrow shape,
   with error and time (CUDA events) of both;
4. the main path: ``create_model("efficientkan", **PRESETS["vit-s"])``
   served by ``Predictor(batch_size=64, device="cuda")`` for three
   requests (64, 64 and 37 images), with the launch count of every kernel,
   the logits of two images against the same model's CPU forward, and the
   steady-state images/s;
5. one JSON line of per-kernel results, the card's ``nvidia-smi`` line, and
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
# Phase 4: the main path
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


def phase_main_path(torch, smi):
    from kanvit_torch.infer import Predictor
    from kanvit_torch.models import PRESETS, create_model

    geom = PRESETS["vit-s"]
    t0 = time.perf_counter()
    model_cpu = create_model("efficientkan", **geom, seed=SEED)
    model = copy.deepcopy(model_cpu).to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] vit-s efficientkan f32: {n_params} params, built in "
          f"{time.perf_counter() - t0:.2f} s")
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
            "flash_attention_lanes": n_fwd * blocks}
    print(f"[main] launches over {n_fwd} forward batches: {counts} "
          f"(want {want}: 1 + {blocks} + {blocks} per batch)")
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


def main():
    torch, smi = phase_toolchain()
    phase_build()
    results = phase_kernels(torch)
    main_path = phase_main_path(torch, smi)
    sources = {
        "bspline_kan": ("kanvit_torch/kernels/csrc/bspline_kan.cu",
                        "kanvit/kernels/fused_basis.py:1067"),
        "bspline_qkv_grouped": ("kanvit_torch/kernels/csrc/bspline_kan.cu",
                                "kanvit/kernels/fused_basis.py:1240"),
        "flash_attention_lanes": ("kanvit_torch/kernels/csrc/attention_lanes.cu",
                                  "kanvit/kernels/flash_attention.py:571"),
    }
    kernels = []
    for name, (err, ms, plain_ms) in results.items():
        src, replaces = sources[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": main_path["launches"][name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Training throughput of the port — prints ONE JSON line.

The counterpart of the repository's ``bench.py`` (which imports jax at the
top, so it cannot be imported here): the same flags, the same presets and
the same JSON schema, measuring steady-state training images/s of
``create_model(model_type, **PRESETS[preset])`` with Adam(1e-3) and CE on
synthetic images and labels drawn from ``--seed``. Run on one card:

    python -m kanvit_torch.bench --preset reference --batch-size 128
    python -m kanvit_torch.bench --preset vit-s --batch-size 64
    python -m kanvit_torch.bench --preset vit-s --batch-size 64 --bf16

``--bf16`` is ``bench.py``'s: kanvit's bf16 policy, f32 parameters and
Adam, the step in bf16 (``make_train_step(bf16=True)``), for every ViT kind
(efficientkan, cheby, fourier, fast, sine, vanilla, flash-attn; the step
takes a ``fused_ff`` model too).

``--device`` (default ``cuda``) is explicit: with no card the run raises,
and it never moves to the CPU on its own (``--device cpu`` is for tests).
Each timed window of ``--steps`` steps ends in a synchronise; the median
window is reported. The XLA-only fields are null, ``steps_per_call`` is 1
(one step per Python call), and ``vs_baseline`` is null: the reference
baseline in ``benchmarks/reference_baseline.json`` was taken on another
host.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# Dense bf16 tensor-core peaks by card name (NVIDIA data sheets), for the MFU
# figure; checked in order, so the PCIe part is matched before the SXM one.
PEAK_FLOPS_BF16 = (("H100 PCIe", 756e12), ("H100", 989e12))


def peak_flops_bf16(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, val in PEAK_FLOPS_BF16:
        if key in name:
            return val
    return None


def _analytic_flops(model_type: str, geom: dict, batch: int) -> float:
    """Useful model FLOPs per training step (fwd + bwd), analytic — a copy
    of ``bench.py::_analytic_flops``.

    Per-variant KAN layer cost: a ``nin -> nout`` layer contracts an
    ``(E + base) * nin``-wide basis (E = basis functions per input feature,
    base = 1 when a silu base branch exists) against the weight:
    ``2 * rows * (E+base) * nin * nout`` FLOPs. Constants follow the
    call-site parity values (mapper sine/fourier grid 28, cheby degree 4,
    KANLinear grid 5 + order 3, FastKAN 8 RBF grids, sine grid 4 in MSA).
    Backward of every matmul costs 2x its forward.
    """
    c, h, w = geom["chw"]
    n_p, L = geom["n_patches"], geom["n_blocks"]
    d, n_heads, out_d = geom["d_hidden"], geom["n_heads"], geom["out_d"]
    t = n_p * n_p + 1
    rows_embed = batch * (t - 1)
    rows_tok = batch * t
    d_head = d // n_heads
    patch_dim = c * (h // n_p) * (w // n_p)

    def kan(rows, nin, nout, in_msa):
        if model_type in ("vanilla", "flash-attn") or (
            model_type == "fourier" and in_msa
        ):
            e = 1.0
        elif model_type == "efficientkan":
            e = 8 + 1  # grid 5 + order 3 splines, + silu base branch
        elif model_type == "fast":
            e = 8 + 1  # 8 RBF grids + silu base branch
        elif model_type == "sine":
            e = 4.0 if in_msa else 28.0
        elif model_type == "fourier":
            e = 2 * 28.0  # cos + sin harmonics
        elif model_type == "cheby":
            e = 5.0  # degree 4 -> T_0..T_4
        else:
            e = 1.0
        return 2.0 * rows * e * nin * nout

    fwd = kan(rows_embed, patch_dim, d, in_msa=False)  # patch embedder
    if model_type == "flash-attn":
        # Raw flash blocks: to_q (d->d), to_kv (d->2d), to_out (d->d).
        per_block = 2.0 * rows_tok * d * 4 * d
        per_block += 2.0 * 2 * batch * n_heads * t * t * d_head
        fwd += L * per_block
    else:
        per_block = 3 * n_heads * kan(rows_tok, d_head, d_head, in_msa=True)
        per_block += 2.0 * 2 * batch * n_heads * t * t * d_head  # qk^T, pv
        per_block += 2.0 * 2 * rows_tok * d * 4 * d  # FF pair
        fwd += L * per_block
    fwd += 2.0 * batch * d * out_d  # mlp head
    return 3.0 * fwd  # + backward at 2x forward


def parse_args(argv=None) -> argparse.Namespace:
    from kanvit_torch.models import PRESETS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-type", default="efficientkan")
    p.add_argument("--preset", default="reference", choices=sorted(PRESETS))
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--steps", type=int, default=50,
                   help="steps per timed window")
    p.add_argument("--windows", type=int, default=5,
                   help="repeated timed windows; the MEDIAN is reported")
    p.add_argument("--warmup", type=int, default=8)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute with f32 params (kanvit's --bf16 policy)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over this many batch chunks "
                        "(same update, chunked activations)")
    p.add_argument("--device", default="cuda",
                   help="torch device; no card raises (no move to the CPU)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and the synthetic batch")
    return p.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """Train ``--warmup`` steps, then ``--windows`` timed windows of
    ``--steps`` steps on one fixed synthetic batch; the result dict in
    ``bench.py``'s schema."""
    from kanvit_torch.models import PRESETS, create_model
    from kanvit_torch.train import create_train_state, make_train_step

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False: this bench measures the card, pass "
                           "--device cpu explicitly for a CPU run")
    geom = PRESETS[args.preset]
    model = create_model(args.model_type, **geom, seed=args.seed).to(device)
    state = create_train_state(model)
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.standard_normal(
        (args.batch_size, *geom["chw"])).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, geom["out_d"], args.batch_size)).to(device)
    step = make_train_step(bf16=args.bf16, grad_accum=args.grad_accum)

    for _ in range(args.warmup):
        state, loss, _ = step(state, x, y)
    _sync(device)

    window_s = []
    for _ in range(max(1, args.windows)):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss, _ = step(state, x, y)
        _sync(device)
        window_s.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"training loss is not finite: {float(loss)}")
    window_s.sort()
    dt = window_s[len(window_s) // 2]  # median window

    ips = args.batch_size * args.steps / dt
    step_ms = dt / args.steps * 1000
    peak = peak_flops_bf16(device)
    flops_model = _analytic_flops(args.model_type, geom, args.batch_size)
    mfu = (round(flops_model / (step_ms / 1000) / peak, 4)
           if flops_model and peak else None)
    name = "mnist" if args.preset == "reference" else args.preset
    dev_name = (f"{device} ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else str(device))
    return {
        "metric": f"{name}_{args.model_type}_train_images_per_sec_per_chip",
        "value": round(ips, 1),
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "step_time_ms": round(step_ms, 2),
        "step_time_ms_minmax": [
            round(window_s[0] / args.steps * 1000, 2),
            round(window_s[-1] / args.steps * 1000, 2),
        ],
        "windows": len(window_s),
        "steps_per_call": 1,
        "batch_size": args.batch_size,
        "grad_accum": args.grad_accum,
        "device": dev_name,
        "bf16": bool(args.bf16),
        "flops_per_step": flops_model,
        "mfu": mfu,
        "flops_per_step_xla": None,
        "mfu_xla": None,
        "peak_flops_bf16": peak,
    }


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))))


if __name__ == "__main__":
    main()

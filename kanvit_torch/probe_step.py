"""Where a training step's time goes on the card, host and device.

    python -m kanvit_torch.probe_step [--preset reference] [--batch-size 128]
                                      [--model-type sine fast ...]

For each model type: ``kanvit_torch.bench``'s training step (Adam 1e-3,
CE, one synthetic batch from seed 0) after a warm-up; the host's clock
over five windows of 50 steps (the median's ms a step) and the process's
CPU time over the same windows (the host's work, which other tenants of a
shared host do not stretch as they stretch its clock); then
``chip_smoke.phase_profile`` over 5 steps (the device's busy ms a step,
its idle share and its kernels) and, from the same trace, the CUDA
runtime calls the host made a step (count and ms by name: launches,
attribute calls, allocations); then the model's forward alone, as serving
runs it (inference mode, the same batch), by CUDA events over 20 calls.
The last line holds the numbers as JSON.

To compare another tree, copy this file into that tree's ``kanvit_torch/``
and run it from that tree's root (it uses that tree's ``chip_smoke.py``),
the trees in turns in one call.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def runtime_calls(torch, step, state, x, y, steps):
    """(count, ms) a step of each CUDA runtime or driver call the host
    makes over ``steps`` steps, from ``torch.profiler``'s trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, x, y)
        torch.cuda.synchronize()
    calls = {}
    for e in prof.events():
        if "cuda" in str(getattr(e, "device_type", "")).lower() or not e.name.startswith("cu"):
            continue
        n, us = calls.get(e.name, (0, 0.0))
        calls[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    return {k: (n / steps, us / steps / 1e3) for k, (n, us) in calls.items()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="reference")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--model-type", nargs="+", default=["sine", "fast"])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    from kanvit_torch.models import PRESETS, create_model
    from kanvit_torch.train import create_train_state, make_train_step

    geom, out = PRESETS[args.preset], {}
    for model_type in args.model_type:
        state = create_train_state(create_model(model_type, **geom, seed=0).cuda())
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((args.batch_size, *geom["chw"]))
                             .astype(np.float32)).cuda()
        y = torch.from_numpy(rng.integers(0, geom["out_d"], args.batch_size)).cuda()
        step = make_train_step()
        for _ in range(8):
            step(state, x, y)
        torch.cuda.synchronize()
        windows, cpu = [], []
        for _ in range(5):
            t0, c0 = time.perf_counter(), time.process_time()
            for _ in range(50):
                step(state, x, y)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / 50 * 1e3)
            cpu.append((time.process_time() - c0) / 50 * 1e3)
        host_ms, cpu_ms = sorted(windows)[2], sorted(cpu)[2]
        print(f"[step] {model_type} {args.preset} batch {args.batch_size}: {host_ms:.3f} ms a "
              f"step on the host's clock (windows {', '.join(f'{w:.3f}' for w in windows)}); "
              f"CPU {cpu_ms:.3f} ms (windows {', '.join(f'{w:.3f}' for w in cpu)})")
        prof = C.phase_profile(torch, step, state, x, y, f"{model_type} {args.preset}",
                               steps=5)
        calls = runtime_calls(torch, step, state, x, y, 5)
        for name, (n, ms) in sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]:
            print(f"[step]   host {ms:8.3f} ms/step  {n:6.1f} calls  {name}")
        model = state.model.eval()
        with torch.inference_mode():
            forward_ms = C.time_ms(torch, lambda: model(x))
        model.train()
        print(f"[step] {model_type} {args.preset} batch {args.batch_size}: device forward "
              f"{forward_ms:.3f} ms (CUDA events)")
        out[model_type] = {"host_ms_per_step": host_ms, "cpu_ms_per_step": cpu_ms, **prof,
                           "device_forward_ms": forward_ms,
                           "runtime_calls": {k: list(v) for k, v in calls.items()}}
    print(f"[probe_step] {ROOT}  [{smi}]")
    print(json.dumps(out))


if __name__ == "__main__":
    main()

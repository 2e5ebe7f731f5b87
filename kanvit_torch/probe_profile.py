"""Whether ``torch.profiler`` keeps every device record of a training step,
by the kernels that open its trace.

    python -m kanvit_torch.probe_profile [--model-type fourier sine] [--rounds 8]

For each model type at vit-s, batch 64 (``chip_smoke.py``'s model and
batch): the training step after a warm-up, first behind
``chip_smoke.fenced_run``'s spin fence (the reference count of device
records over two steps, the one ``phase_profile`` holds to CUDA events),
then ``--rounds`` profiles of two steps as the host feeds them, opened in
turns by one 0.1 ms spin alone, one 20 ms spin alone and
``chip_smoke.first_kernel``. Each profile's line gives its device records
without spins against the reference, the spins it kept, its busy ms a
step, and the kernels it lost (by a sequence match on names against the
reference); at the end, the SM clocks and throttle reasons that
``nvidia-smi`` sampled meanwhile. The last line holds the counts as JSON.
"""

from __future__ import annotations

import argparse
import copy
import difflib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model-type", nargs="+", default=["fourier", "sine"])
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    from torch.profiler import ProfilerActivity, profile

    from kanvit_torch.models import PRESETS
    from kanvit_torch.train import create_train_state, make_train_step

    def one_spin():
        torch.cuda._sleep(int(0.1 * C.spin_cycles_per_ms(torch)))
        torch.cuda.synchronize()

    def long_spin():
        torch.cuda._sleep(int(20 * C.spin_cycles_per_ms(torch)))
        torch.cuda.synchronize()

    leads = {"one spin": one_spin, "one 20 ms spin": long_spin,
             "first_kernel": lambda: C.first_kernel(torch)}
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks_throttle_reasons.active",
         "--format=csv,noheader", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    geom, steps, out = PRESETS["vit-s"], 2, {}
    for model_type in args.model_type:
        model = copy.deepcopy(C.build_model(model_type)).cuda()
        rng = np.random.default_rng(C.SEED + 2)
        x = torch.from_numpy(rng.standard_normal((C.BATCH, *geom["chw"]))
                             .astype(np.float32)).cuda()
        y = torch.from_numpy(rng.integers(0, geom["out_d"], C.BATCH)).cuda()
        state = create_train_state(model, 1e-3)
        step = make_train_step()
        for _ in range(8):
            step(state, x, y)
        torch.cuda.synchronize()
        per_op, _ = C.host_ms_per_op(torch, step, state, x, y)
        fenced, _, _ = C.fenced_run(torch, step, state, x, y, steps,
                                    max(1.0, 4 * C.SPIN_OPS * per_op))
        ref = [e.name for e in sorted(fenced, key=lambda e: e.time_range.start)]
        tally = {lead: {"profiles": 0, "short": 0, "lost": []} for lead in leads}
        for r in range(args.rounds * len(leads)):
            lead = list(leads)[r % len(leads)]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                leads[lead]()
                for _ in range(steps):
                    step(state, x, y)
                torch.cuda.synchronize()
            dev = C.device_kernels(prof)
            kept = sorted((e for e in dev if not C.is_spin(e)),
                          key=lambda e: e.time_range.start)
            names = [e.name for e in kept]
            lost = [name[:60] for op, i1, i2, _, _ in difflib.SequenceMatcher(
                a=ref, b=names, autojunk=False).get_opcodes() if op != "equal"
                for name in ref[i1:i2]]
            busy = sum(C.kernel_times(kept).values()) / steps / 1e3
            t = tally[lead]
            t["profiles"] += 1
            t["short"] += len(names) < len(ref)
            t["lost"].append(len(ref) - len(names))
            print(f"[probe_profile] {model_type} {lead}: {len(names)} device records of "
                  f"{len(ref)}, {sum(C.is_spin(e) for e in dev)} spins kept, busy "
                  f"{busy:.3f} ms a step; lost {lost[:4]}", flush=True)
        print(f"[probe_profile] {model_type}: profiles short of the fenced one's "
              f"{len(ref)} records, by lead-in: "
              f"{ {k: (v['short'], v['profiles']) for k, v in tally.items()} }  [{smi}]")
        out[model_type] = {"reference_records": len(ref), **tally}
    clocks.terminate()
    seen = {}
    for line in clocks.communicate()[0].splitlines():
        seen[line.strip()] = seen.get(line.strip(), 0) + 1
    print(f"[probe_profile] SM clock and throttle reasons, samples every 100 ms: {seen}")
    print(json.dumps({"card": smi, "steps": steps, "clock_samples": seen, "by_model": out}))


if __name__ == "__main__":
    main()

"""The grouped q/k/v forward and backwards and the wide fused FF on the
card: checks and times, for comparing trees.

    python -m kanvit_torch.probe_qkv [--full]

Runs ``chip_smoke.py``'s checks of ``bspline_qkv_grouped``'s forward
(``check_qkv``) and backward (``check_qkv_bwd``), each on the tensor cores
against the plain version and against f64, the bits repeated, CUDA-event
and device times beside the CUDA-core kernels they replace, at the vit-s
q/k/v (12,608 rows, 6 heads of 64 -> 192); of ``cheby_qkv_grouped`` there
(``check_basis`` with its tensor-core gates: the backward's every gradient
against f64, the bits, device times beside the CUDA-core kernels); and of
``fastkan_qkv_grouped`` and ``sinekan_qkv_grouped`` (``check_rbf`` and
``check_sine`` with their tensor-core gates) at one vit-s q/k/v projection
(6 heads of 64 -> 64, sine grid 4). ``--full`` first builds the kernels
(registers, spills and the SASS report), runs the B-spline q/k/v checks at
dh 8, with a refit grid a head and at a ragged shape too, and then the
fused-FF check (``check_ffn``) at vit-b's and vit-l's widths (D 768, F
3,072; D 1,024, F 4,096) at vit-s's rows, at D 2,048, at vit-s's own
widths and at a ragged shape. The last line holds the times as JSON.

To compare another tree's kernels, copy this file into that tree's
``kanvit_torch/`` and this tree's ``chip_smoke.py`` into its root, run it
from that root, and run the two trees in turns (A, B, B, A) in one call.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    rng = np.random.default_rng(C.SEED + 3)
    n = C.BATCH * 197
    if args.full:
        C.phase_build()
        for check in (C.check_qkv, C.check_qkv_bwd):
            check(torch, rng, C.BATCH * 50, 8, 8, "dh-8 mnist q/k/v")
            check(torch, rng, n, 6, 64, "vit-s refit grids a head", per_head=True)
            check(torch, rng, 37 * 50, 2, 32, "mnist q/k/v")
    times = {}
    for name, check in (("bspline_qkv_grouped", C.check_qkv),
                        ("bspline_qkv_grouped_bwd", C.check_qkv_bwd)):
        qkv = check(torch, rng, n, 6, 64, "vit-s q/k/v")
        times[name] = {"ms": qkv[1], **qkv[3], "bound_ms": qkv[4]["bound_ms"]}
    _, bwd = C.check_cheby_qkv(torch, rng, n, 6, 64, "vit-s q/k/v")
    times["cheby_qkv_grouped_bwd"] = {"ms": bwd[1], **bwd[3], **bwd[4]}
    _, bwd = C.check_rbf(torch, rng, "fastkan_qkv_grouped", "vit-s q/k/v", n, 6, 64, 64,
                         tc_gates=True)
    times["fastkan_qkv_grouped_bwd"] = {"ms": bwd[1], **bwd[3], **bwd[4]}
    _, bwd = C.check_sine(torch, rng, "sinekan_qkv_grouped", "vit-s q/k/v", n, 6, 64, 64, 4,
                          tc_gates=True)
    times["sinekan_qkv_grouped_bwd"] = {"ms": bwd[1], **bwd[3], **bwd[4]}
    shapes = ((n, 768, 3072, "vit-b widths"), (n, 1024, 4096, "vit-l widths"),
              (1000, 2048, 256, "d-2048"), (n, 384, 1536, "vit-s"),
              (37 * 50 + 1, 100, 400, "ragged"))
    for rows, d, f, label in shapes if args.full else ():
        fwd, bwd = C.check_ffn(torch, rng, rows, d, f, label, f64=True)
        times[f"ffn {label}"] = {"fwd_ms": fwd[1], "fwd_library_ms": fwd[3]["library_ms"],
                                 "bwd_ms": bwd[1], "bwd_library_ms": bwd[3]["library_ms"]}
    print(f"[probe_qkv] {ROOT}  [{smi}]")
    print(json.dumps(times))


if __name__ == "__main__":
    main()

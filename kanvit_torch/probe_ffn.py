"""The fused FF kernels on the card: checks and times, for comparing trees.

    python -m kanvit_torch.probe_ffn [--full]

Runs ``chip_smoke.py``'s fused-FF check (``check_ffn``) at the vit-s shape
(12,608 rows, D 384, F 1,536): forward and backward against the plain
version, the forward against f64, the backward's bits repeated, and the
CUDA-event and device times of the kernels (each by name), the plain
version and the library calls. ``--full`` first builds the kernels
(registers, spills and the SASS report), times ``mma.sync`` TF32 on the
card and runs the check at the card tests' ragged shapes too. The last line
holds the vit-s times.

To compare another tree's kernels, copy this file into that tree's
``kanvit_torch/`` and this tree's ``chip_smoke.py`` into its root, run it
from that root, and run the two trees in turns (A, B, B, A) in one call.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1, 8, 32, "tiny"), (50, 30, 50, "d30"), (37 * 50 + 1, 100, 400, "ragged"),
          (129, 512, 200, "d512"), (1000, 384, 1536, "mid"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    rng = np.random.default_rng(C.SEED + 9)
    if args.full:
        C.phase_build()
        C.mma_sync_rate(torch, smi)
        for n, d, f, label in SHAPES:
            C.check_ffn(torch, rng, n, d, f, label, f64=True)
    fwd, bwd = C.check_ffn(torch, rng, C.BATCH * 197, 384, 1536, "vit-s", f64=True)
    print(f"[probe_ffn] {ROOT} vit-s: forward {fwd[1]:.4f} ms (device "
          f"{fwd[4]['device_ms']:.4f}), backward {bwd[1]:.4f} ms (device "
          f"{bwd[4]['device_ms']:.4f})  [{smi}]")


if __name__ == "__main__":
    main()

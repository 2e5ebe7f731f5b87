"""The Fourier and sine embedder kernels on the card: times, for comparing trees.

    python -m kanvit_torch.probe_kan [--full]

Times ``fourierkan`` (grid 28) and ``sinekan`` (grid 28) at the vit-s
embedder (12,544 rows, 768 -> 384) as the serving and training paths call
them: the forward, the backward without dx (the training step's) and with
every gradient; CUDA events and the kernels' device time (each by name).
``--full`` first builds the kernels (registers, spills and the SASS report)
and runs ``chip_smoke.py``'s checks of both wrappers at the vit-s and
ragged shapes. The last line holds the times as JSON.

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


def embedder_calls(torch, C):
    """The launches of both wrappers at the vit-s embedder, by label."""
    import numpy as np

    from kanvit_torch.kernels import fused_basis as FB
    from kanvit_torch.ops import kan_bases as K

    rng = np.random.default_rng(C.SEED + 11)
    n, nin, nout, gs = C.BATCH * 196, 768, 384, 28

    def cuda(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    g = cuda(rng.standard_normal((n, nout)))
    x = cuda(C.fourier_inputs(rng, (n, nin)))
    w = FB.pack_fourier_weight(cuda(rng.standard_normal((2, nout, nin, gs))
                                    / np.sqrt(nin * gs))).contiguous()
    xs = cuda(C.sine_inputs(rng, (n, nin)))
    ws = FB.pack_sine_weight(cuda(rng.uniform(-1.0, 1.0, (nout, nin, gs)) / nout)
                             ).contiguous()
    freq = cuda(np.arange(1, gs + 1) / (gs + 1)).reshape(1, gs)
    phase = K.sinekan_phase_init(nin, gs).cuda()
    return {
        "fourierkan": lambda: FB._launch("fourierkan", "fourier", x, w, gs),
        "fourierkan_bwd no dx": lambda: FB._launch_bwd("fourierkan_bwd", "fourier", x,
                                                       w, gs, g, False, True),
        "fourierkan_bwd all": lambda: FB._launch_bwd("fourierkan_bwd", "fourier", x, w,
                                                     gs, g, True, True),
        "sinekan": lambda: FB._launch_sine("sinekan", xs, ws, freq, phase),
        "sinekan_bwd no dx": lambda: FB._launch_sine_bwd("sinekan_bwd", xs, ws, freq,
                                                         phase, g, False, True),
        "sinekan_bwd all": lambda: FB._launch_sine_bwd("sinekan_bwd", xs, ws, freq,
                                                       phase, g, True, True),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    if args.full:
        C.phase_build()
        C.phase_basis_kernels(torch)
        C.phase_rbf_sine_kernels(torch)
    times = {}
    with torch.inference_mode():
        for label, fn in embedder_calls(torch, C).items():
            times[label] = {"ms": C.time_ms(torch, fn),
                            "device_ms": C.kernel_ms(torch, fn, 10, label=label)}
            print(f"[probe_kan] {ROOT} {label}: {times[label]['ms']:.4f} ms (device "
                  f"{times[label]['device_ms']:.4f})  [{smi}]", flush=True)
    print(json.dumps({"tree": str(ROOT), "card": smi, "times": times}))


if __name__ == "__main__":
    main()

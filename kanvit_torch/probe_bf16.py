"""bf16 serving and training of the vit-s efficientkan on the card: checks
and times.

    python -m kanvit_torch.probe_bf16 [--train]

Builds the kernels (registers, spills and the SASS report), then runs
``chip_smoke.py``'s bf16 phases alone: its six bf16 kernels (the forwards
and backwards of ``bspline_kan``, ``bspline_qkv_grouped`` and the lanes
attention) against their plain twins and f64 at the vit-s and ragged
shapes, with CUDA-event and device times beside the f32 kernels'
(``phase_bf16_kernels``), and the bf16 serving of the vit-s efficientkan
through ``Predictor`` and ``make_eval_step(bf16=True)`` beside f32
(``phase_bf16_serve``); ``--train`` adds its bf16 training through
``make_train_step(bf16=True)`` (``phase_bf16_train``: launches, the loss
over 10 steps, the 4-image gradients against the CPU's bf16 twins, ms a
step beside f32's, the profile). The last line holds the times as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", action="store_true", help="also the bf16 training phase")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    C.timed("build", C.phase_build)
    results = C.timed("bf16 kernels", C.phase_bf16_kernels, torch)
    model = C.build_model("efficientkan")
    serve = C.timed("bf16 serving", C.phase_bf16_serve, torch, smi, model, C.SEED + 1)
    times = {name: {"ms": r[1], "plain_ms": r[2], **r[3], **r[4],
                    **{k: v for sub in r[5:] for k, v in sub.items()}}
             for name, r in results.items()}
    out = {"card": smi, "kernels": times,
           "serve": {k: v for k, v in serve.items() if k != "launches"}}
    if args.train:
        train = C.timed("bf16 training", C.phase_bf16_train, torch, smi, model)
        out["train"] = {k: v for k, v in train.items() if k != "launches"}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

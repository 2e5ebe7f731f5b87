"""bf16 serving of the vit-s efficientkan on the card: checks and times.

    python -m kanvit_torch.probe_bf16

Builds the kernels (registers, spills and the SASS report), then runs
``chip_smoke.py``'s bf16 phase alone: its three bf16 kernels against their
plain twins and f64 at the vit-s and ragged shapes, with CUDA-event and
device times beside the f32 kernels' (``phase_bf16_kernels``), and the
bf16 serving of the vit-s efficientkan through ``Predictor`` and
``make_eval_step(bf16=True)`` beside f32 (``phase_bf16_serve``). The last
line holds the times as JSON.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    torch, smi = C.phase_toolchain()
    C.timed("build", C.phase_build)
    results = C.timed("bf16 kernels", C.phase_bf16_kernels, torch)
    serve = C.timed("bf16 serving", C.phase_bf16_serve, torch, smi,
                    C.build_model("efficientkan"), C.SEED + 1)
    times = {name: {"ms": r[1], "plain_ms": r[2], **r[3], **r[4],
                    **{k: v for sub in r[5:] for k, v in sub.items()}}
             for name, r in results.items()}
    print(json.dumps({"card": smi, "kernels": times,
                      "serve": {k: v for k, v in serve.items() if k != "launches"}}))


if __name__ == "__main__":
    main()

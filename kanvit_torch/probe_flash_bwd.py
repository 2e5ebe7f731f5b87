"""The bf16 tiled attention's backward kernels (``flash_dq_bf16``,
``flash_dkv_bf16`` in ``csrc/flash_attention.cu``) timed on the card, with
another tree's in turns and a clock trace of one block's phases.

    python -m kanvit_torch.probe_flash_bwd [--parent PATH] [--ieee-exp] [--trace]

Builds the kernels, then at the causal decoder's shapes (B 16 at T 2048 and
B 4 at T 8192, in 4 heads of 64 and in 2 of 128) launches dq and dk/dv
alone on the bf16 forward's o and (m, l) and times each by CUDA events and
by the card's own time of its kernel. ``--parent PATH``: also build another
tree's ``flash_attention.cu`` (its headers beside it, e.g. ``git archive
HEAD kanvit_torch/kernels/csrc | tar -x -C build/parent``) into a library
of its own, time its bf16 dq and dk/dv in turns with this tree's (parent,
this, this, parent) and print the largest difference of their gradients.
``--ieee-exp``: the same for a copy of this tree's ``flash_attention.cu``
whose backward kernels take IEEE ``expf`` in place of ``exp_sfu``.
``--trace``: build a copy of this tree's ``flash_attention.cu`` whose
consumer warpgroups stamp the SM clock (``clock64``) at the phases of each
tile in block (0, 0, 0), and print per warpgroup the mean clocks a computed
tile of S and dP, the score pass, the second products, the release of the
stage and the wait for the next one. The last line holds the times as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path(__file__).resolve().parent / "kernels" / "csrc"

# (B, H, T, dh, launches a timing)
SHAPES = ((16, 4, 2048, 64, 20), (4, 4, 8192, 64, 6), (16, 2, 2048, 128, 20),
          (4, 2, 8192, 128, 6))

# The traced copy: a clock stamp after each anchor (or before it, where the
# flag is set) in the consumer loop of each kernel, for block (0, 0, 0).
TRACE_ANCHORS = {
    "flash_dq_bf16(const __grid_constant__": (
        ("mbar_wait(&full[s], it / HB_STAGES & 1);", False),
        ("      fence_regs(dp);", False),
        ("      wgmma_fence();\n#pragma unroll\n      for (int kk = 0; kk < HB_TILE / 16; ++kk) "
         "wgmma_rs<DH>(acc", True),
        ("      fence_regs(da);", False),
        ("    hb_release(&empty[s], lane);", False)),
    "flash_dkv_bf16(const __grid_constant__": (
        ("mbar_wait(&full[s], it / HB_STAGES & 1);", False),
        ("      fence_regs(dpt);", False),
        ("      wgmma_fence();\n#pragma unroll\n      for (int kk = 0; kk < HB_TILE / 16; ++kk) {",
         True),
        ("      fence_regs(sa);", False),
        ("    hb_release(&empty[s], lane);", False)),
}
TRACE_SOURCE = """__device__ long long hb_trace[2][2][5][256];
#define HB_T(KIND, K)                                                            \\
  if (ct == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && it < 256) \\
    hb_trace[KIND][w][K][it] = clock64();
"""
TRACE_READ = """
extern "C" int hb_trace_clear() {
  void* p = nullptr;
  const int err = (int)cudaGetSymbolAddress(&p, hb_trace);
  return err != 0 ? err : (int)cudaMemset(p, 0, sizeof(hb_trace));
}
extern "C" int hb_trace_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, hb_trace, sizeof(hb_trace));
}
"""


def _library(C, name, source_dir, patch=None):
    """nvcc on ``source_dir/flash_attention.cu`` (its headers copied beside
    it, the source rewritten by ``patch``) into a library of its own."""
    from kanvit_torch.kernels import _build

    out = _build.BUILD_ROOT / f"probe_flash_bwd_{name}"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(source_dir, out)
    src = out / "flash_attention.cu"
    if patch is not None:
        src.write_text(patch(src.read_text()))
    lib = out / "libprobe.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    C.check(proc.returncode == 0, f"{name}'s flash_attention.cu did not build:\n"
                                  f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _ieee_exp(source: str) -> str:
    at = source.index("flash_dq_bf16(const __grid_constant__")
    assert source.count("exp_sfu(", at) == 2, "the backward's exp calls moved"
    return source[:at] + source[at:].replace("exp_sfu(", "expf(")


def _traced(source: str) -> str:
    at = source.index("template <int DH>\n__global__ void __launch_bounds__(HB_THREADS, 1)\n"
                      "flash_dq_bf16(")
    source = source[:at] + TRACE_SOURCE + source[at:]
    for kind, (kernel, anchors) in enumerate(TRACE_ANCHORS.items()):
        pos = source.index(kernel)
        for k, (anchor, before) in enumerate(anchors):
            i = source.index(anchor, pos)
            stamp = f"HB_T({kind}, {k});\n"
            if before:
                source = source[:i] + stamp + source[i:]
            else:
                i += len(anchor)
                source = source[:i] + "\n" + stamp + source[i:]
            pos = i + len(stamp)
    return source + TRACE_READ


def _phase_means(stamps):
    """Mean clocks a tile by phase from one warpgroup's stamps (5, 256):
    after the full wait, S and dP, the score pass, the second products, the
    release; a tile the warpgroup skips has only the first and the last."""
    import numpy as np

    n = int((stamps[0] != 0).sum())
    s = stamps[:, :n].astype(np.float64)
    live = s[1] != 0
    means = {"tiles": n, "computed": int(live.sum()), "block clocks": float(s[4, -1] - s[0, 0])}
    for key, val in (("S, dP", s[1] - s[0]), ("scores", s[2] - s[1]),
                     ("second products", s[3] - s[2])):
        means[key] = round(float(val[live].mean()), 1) if live.any() else None
    means["release"] = round(float((s[4] - np.where(live, s[3], s[0])).mean()), 1)
    means["wait for the next tile"] = (round(float((s[0, 1:] - s[4, :-1]).mean()), 1)
                                       if n > 1 else None)
    return means


def _call(torch, lib, name, q, k, v, *ptrs):
    """The C entry ``kanvit_flash_attention_<name>_bf16`` of ``lib`` on the
    decoder's layout, causal, no mask."""
    from kanvit_torch.kernels import _build
    from kanvit_torch.kernels import flash_attention as FA

    entry = f"kanvit_flash_attention_{name}_bf16"
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = _build.SIGNATURES[entry]
    b, h, tq, dh = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *FA._tiled_strides(q, k, v), None,
             *ptrs, b, tq, k.shape[2], h, dh, 1, dh ** -0.5,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's flash_attention.cu, its headers beside it")
    ap.add_argument("--ieee-exp", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C
    from kanvit_torch.kernels import _build
    from kanvit_torch.kernels import flash_attention as FA

    torch, smi = C.phase_toolchain()
    C.phase_build()
    libs = {"this": _build.load()}
    if args.parent is not None:
        libs["parent"] = _library(C, "parent", args.parent.resolve().parent)
    if args.ieee_exp:
        libs["ieee_exp"] = _library(C, "ieee_exp", CSRC, _ieee_exp)
    traced = _library(C, "traced", CSRC, _traced) if args.trace else None
    rng = np.random.default_rng(C.SEED + 29)
    results = {}
    for b, h, t, dh, iters in SHAPES:
        tag = f"B {b} H {h} T {t} dh {dh}"
        q, k, v, g = C.flash_bf16_inputs(torch, rng, b, h, t, t, dh)
        do = g.transpose(1, 2).contiguous()
        entry = {}
        with torch.inference_mode():
            o4, stats = FA._launch_tiled(q, k, v, None, True, True)
            grads = {}
            for name, lib in libs.items():
                dq = torch.empty(b, t, h, dh, dtype=q.dtype, device="cuda")
                delta = torch.empty(b, h, t, device="cuda")
                dk, dv = torch.empty_like(dq), torch.empty_like(dq)
                calls = (lambda lib=lib, dq=dq, delta=delta: _call(
                             torch, lib, "dq", q, k, v, o4.data_ptr(), do.data_ptr(),
                             stats.data_ptr(), delta.data_ptr(), dq.data_ptr()),
                         lambda lib=lib, dk=dk, dv=dv, delta=delta: _call(
                             torch, lib, "dkv", q, k, v, do.data_ptr(), stats.data_ptr(),
                             delta.data_ptr(), dk.data_ptr(), dv.data_ptr()))
                for fn in calls:
                    fn()
                grads[name] = ((dq, dk, dv), calls)
            torch.cuda.synchronize()
            turns = [name for other in ("parent", "ieee_exp") if other in libs
                     for name in (other, "this", "this", other)] or ["this"]
            for name in turns:
                for part, fn in zip(("dq", "dkv"), grads[name][1]):
                    entry.setdefault(f"{name} {part} ms", []).append(
                        C.time_ms(torch, fn, iters, 3))
            for part, fn in zip(("dq", "dkv"), grads["this"][1]):
                entry[f"{part} device ms"] = C.kernel_ms(torch, fn, iters, 3)
            for other in ("parent", "ieee_exp"):
                if other in libs:
                    entry[f"max |this - {other}|"] = [
                        float((x.float() - y.float()).abs().max())
                        for x, y in zip(grads["this"][0], grads[other][0])]
            if traced is not None:
                dq, dk, dv = (torch.empty(b, t, h, dh, dtype=q.dtype, device="cuda")
                              for _ in range(3))
                delta = torch.empty(b, h, t, device="cuda")
                C.check(traced.hb_trace_clear() == 0, "the trace did not clear")
                _call(torch, traced, "dq", q, k, v, o4.data_ptr(), do.data_ptr(),
                      stats.data_ptr(), delta.data_ptr(), dq.data_ptr())
                _call(torch, traced, "dkv", q, k, v, do.data_ptr(), stats.data_ptr(),
                      delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
                torch.cuda.synchronize()
                stamps = np.zeros((2, 2, 5, 256), dtype=np.int64)
                C.check(traced.hb_trace_read(ctypes.c_void_p(stamps.ctypes.data)) == 0,
                        "the trace did not read back")
                for kind, part in enumerate(("dq", "dkv")):
                    for w in range(2):
                        entry[f"trace {part} warpgroup {w}"] = _phase_means(stamps[kind, w])
        print(f"[probe_flash_bwd] {tag}: " + json.dumps(entry), flush=True)
        results[tag] = entry
        del q, k, v, g, do, o4, stats, grads
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "results": results}))


if __name__ == "__main__":
    main()

"""The W8A8 ``int8_linear`` kernel's shapes, timed on the card.

    python -m kanvit_torch.probe_int8 [--parent PATH]

Builds the kernels, then a library from ``csrc/int8_matmul.cu`` that
launches ``int8_linear_kernel<BM, KC, STAGES>`` in the shapes of
``VARIANTS`` (rows a block, K bytes a stage of W, stages of its ring; the
route's are ``rows_per_block(K)``, 128 and 2). At the vit-s FF1 (12,608
tokens, 384 -> 1,536), FF2 (1,536 -> 384), the patch embedder (12,544, 768
-> 384), the TPU probe's shape (768 -> 3,072) and vit-b's FF2 (3,072 ->
768) it times the route and each variant by CUDA events, counts the
elements that differ from ``qdot_rowwise`` (0 for every one that runs),
and prints the bound (bytes at 3.35 TB/s, operations at the dense int8
rate), ``torch._int_mm`` alone on pre-quantized operands and the library
route (quantize, ``torch._int_mm``, dequantize). ``--parent PATH``: also
build another tree's ``int8_matmul.cu`` (its entry without the rows
argument) and time it on the same operands, in turns with the route. The
last line holds the times as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (rows a block, K bytes a stage, stages); the route's tiers first
VARIANTS = ((48, 128, 2), (64, 128, 3), (48, 64, 3), (32, 128, 3), (32, 64, 3),
            (32, 128, 2), (16, 128, 3), (128, 128, 3), (64, 64, 4), (64, 128, 2))

SOURCE = r"""
#include "int8_matmul.cu"

extern "C" int probe_int8(int v, const float* x, long long ldx, const int8_t* wq,
                          const float* sw, const float* bias, float* y, int n, int k, int nout,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (v) {
CASES
  }
  return -1;
}
""".replace("CASES", "\n".join(
    f"    case {i}: return launch_int8_linear<{bm}, {kc}, {ns}>(x, ldx, wq, sw, bias, y, n, k, "
    f"nout, st);" for i, (bm, kc, ns) in enumerate(VARIANTS)))

# (label, N, K, out)
SHAPES = (("vit-s FF1", 64 * 197, 384, 1536), ("vit-s FF2", 64 * 197, 1536, 384),
          ("vit-s embedder", 64 * 196, 768, 384), ("TPU probe shape", 64 * 197, 768, 3072),
          ("vit-b FF2", 64 * 197, 3072, 768))


def _parent_lib(C, path):
    """nvcc on another tree's ``int8_matmul.cu`` into its own library."""
    from kanvit_torch.kernels import _build

    out = _build.BUILD_ROOT / "probe_int8_parent"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libparent_int8.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    C.check(proc.returncode == 0, f"the parent's int8_matmul.cu did not build:\n"
                                  f"{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).kanvit_int8_linear_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, *[ctypes.c_void_p] * 4,
                   *[ctypes.c_int] * 3, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as C
    from kanvit_torch.kernels import int8_matmul as IM
    from kanvit_torch.ops import quant as Q
    from kanvit_torch.probe_qkv_fwd import _nvcc

    torch, smi = C.phase_toolchain()
    C.phase_build()
    proc, path = _nvcc(C, SOURCE, "probe_int8")
    log = proc.communicate()[0]
    C.check(proc.returncode == 0, f"probe_int8 did not build:\n{log}")
    keep = False
    for line in log.splitlines():  # each variant's registers and spills
        if "Compiling entry" in line:
            keep = "int8_linear_kernel" in line
            if keep:
                print(f"[probe_int8] {line.split('int8_linear_kernel')[1][:40]}")
        elif keep and ("registers" in line or "spill" in line):
            print(f"[probe_int8]     {line.strip()}")
    fn = ctypes.CDLL(str(path)).probe_int8
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, p, ctypes.c_longlong, *[p] * 4, *[ctypes.c_int] * 3, p]
    fn.restype = ctypes.c_int
    parent = _parent_lib(C, args.parent) if args.parent else None
    rng = np.random.default_rng(C.SEED + 18)
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for label, n, k, out in SHAPES:
        x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).cuda()
        w = torch.from_numpy((rng.standard_normal((out, k)) * 0.05).astype(np.float32)).cuda()
        b = torch.from_numpy(rng.standard_normal(out).astype(np.float32)).cuda()
        with torch.inference_mode():
            want = Q.qdot_rowwise(x, w, b)
            wq, sw = Q._quantize(w, dim=-1)
            swr = sw.reshape(-1).contiguous()
            xq, sx = Q._quantize(x, dim=-1)

            def route():
                return IM._launch(x, wq, swr, b)

            def library():
                xq, sx = Q._quantize(x, dim=-1)
                return torch._int_mm(xq, wq.t()).float() * sx * sw.reshape(1, -1) + b

            entry = {"rows_per_block": IM.rows_per_block(k),
                     "differing": int((route() != want).sum()),
                     "int_mm_ms": C.time_ms(torch, lambda: torch._int_mm(xq, wq.t()), 50),
                     "library_ms": C.time_ms(torch, library, 50),
                     "bound": C.int8_bound(n, k, out, None)}
            turns = [("route", route)]
            if parent is not None:
                def old(y=torch.empty_like(want)):
                    err = parent(x.data_ptr(), x.stride(0), wq.data_ptr(), swr.data_ptr(),
                                 b.data_ptr(), y.data_ptr(), n, k, out, stream)
                    C.check(err == 0, f"parent int8_linear {label}: CUDA error {err}")
                    return y

                entry["parent_differing"] = int((old() != want).sum())
                turns.append(("parent", old))
            for turn in range(2):
                for name, f in (turns if turn == 0 else turns[::-1]):
                    entry.setdefault(f"{name}_ms", []).append(C.time_ms(torch, f, 50))
            entry["route_device_ms"] = C.kernel_ms(torch, route, 10)
            for v, shape in enumerate(VARIANTS):
                y = torch.empty_like(want)

                def launch(v=v, y=y):
                    return fn(v, x.data_ptr(), x.stride(0), wq.data_ptr(), swr.data_ptr(),
                              b.data_ptr(), y.data_ptr(), n, k, out, stream)

                if launch() != 0:
                    entry[str(shape)] = None  # does not fit the shape
                    continue
                torch.cuda.synchronize()
                entry[str(shape)] = {"ms": C.time_ms(torch, launch, 50),
                                     "differing": int((y != want).sum())}
        times[label] = entry
        bound = entry["bound"]
        print(f"[probe_int8] {label} N={n} K={k} out={out}: route (BM "
              f"{entry['rows_per_block']}) " + ", ".join(f"{v:.4f}" for v in entry["route_ms"])
              + f" ms (device {entry['route_device_ms']:.4f})"
              + ("" if parent is None else ", parent " + ", ".join(
                  f"{v:.4f}" for v in entry["parent_ms"])
                 + f" ({entry['parent_differing']} differing)")
              + f"; {entry['differing']} elements differ from qdot_rowwise; bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']}; torch._int_mm alone "
              f"{entry['int_mm_ms']:.4f}, library {entry['library_ms']:.4f}", flush=True)
        for shape in VARIANTS:
            e = entry[str(shape)]
            print(f"[probe_int8]   (rows, KC, stages) {shape}: " + (
                "does not fit" if e is None else
                f"{e['ms']:.4f} ms, {e['differing']} differing"), flush=True)
        C.check(entry["differing"] == 0 and all(
            e is None or e["differing"] == 0 for e in (entry[str(s)] for s in VARIANTS)),
            f"int8_linear {label}: elements differ from qdot_rowwise")
    print(f"[probe_int8] {ROOT}  [{smi}]")
    print(json.dumps(times))


if __name__ == "__main__":
    main()

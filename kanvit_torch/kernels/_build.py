"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

The sources have a plain C interface (no PyTorch headers). Each ``.cu``
compiles to an object in its own nvcc process, all started together, and one
more nvcc call links the objects into one shared library. The library goes
to ``build/kanvit_torch/<hash of the sources and flags>/`` at the root of the
checkout (listed in ``.gitignore``) at first use, and later calls in any
process reuse it. A failed build raises with nvcc's output; nothing falls
back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kanvit_torch"
LIB_NAME = "libkanvit_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_p, _i64, _i32, _f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
# C signature of every exported function: (argtypes, restype). Pointers and
# the stream are c_void_p, so ctypes never truncates them to 32 bits.
SIGNATURES = {
    "kanvit_bspline_kan_fwd": (
        [_p, _i64, _p, _p, _p, _i32, _i32, _i32, _i32, _p], _i32),
    "kanvit_bspline_kan_bwd": (
        [_p, _i64, _p, _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32, _i32, _p],
        _i32),
    "kanvit_chebykan_fwd": ([_p, _i64, _p, _p, *[_i32] * 4, _p], _i32),
    "kanvit_chebykan_bwd": (
        [_p, _i64, *[_p] * 5, *[_i32] * 5, _p], _i32),
    "kanvit_fourierkan_fwd": ([_p, _i64, _p, _p, *[_i32] * 5, _p], _i32),
    "kanvit_fourierkan_bwd": (
        [_p, _i64, *[_p] * 5, *[_i32] * 6, _p], _i32),
    "kanvit_fastkan_fwd": (
        [_p, _i64, _p, _p, _p, _f32, _p, _p, _p, *[_i32] * 5, _p], _i32),
    "kanvit_fastkan_bwd": (
        [_p, _i64, _p, _p, _p, _f32, *[_p] * 9, *[_i32] * 7, _p], _i32),
    "kanvit_sinekan_fwd": ([_p, _i64, *[_p] * 4, *[_i32] * 5, _p], _i32),
    "kanvit_sinekan_bwd": ([_p, _i64, *[_p] * 9, *[_i32] * 6, _p], _i32),
    "kanvit_attention_lanes_fwd": (
        [_p, _p, _p, *[_i64] * 9, _p, _p, _p, _i32, _i32, _i32, _i32, _i32,
         _f32, _p], _i32),
    "kanvit_attention_lanes_bwd": (
        [_p, _p, _p, *[_i64] * 9, *[_p] * 8, _i32, _i32, _i32, _i32, _i32,
         _f32, _p], _i32),
    "kanvit_flash_attention_fwd": (
        [_p, _p, _p, *[_i64] * 9, *[_p] * 3, *[_i32] * 6, _f32, _p], _i32),
    "kanvit_flash_attention_dq": (
        [_p, _p, _p, *[_i64] * 9, *[_p] * 6, *[_i32] * 6, _f32, _p], _i32),
    "kanvit_flash_attention_dkv": (
        [_p, _p, _p, *[_i64] * 9, *[_p] * 6, *[_i32] * 6, _f32, _p], _i32),
}

_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of kanvit_torch are built from source at first use"
    )


def build(ptxas_info: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    Returns ``(library path, compiler output)``; the output is empty when
    the library was already built. ``ptxas_info`` adds ``-Xptxas -v``
    (registers, shared memory and spills of each kernel) to a fresh build.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{os.getpid()}.tmp"
    info = ["-Xptxas", "-v"] if ptxas_info else []
    cmds = [[nvcc, *NVCC_FLAGS, *info, "-c", "-o",
             str(out_dir / f"{src.stem}.{tag}.o"), str(src)]
            for src in sources() if src.suffix == ".cu"]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    objs = [cmd[cmd.index("-o") + 1] for cmd in cmds]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
    for cmd, proc, log in zip(cmds, procs, logs):
        _check(cmd, proc.returncode, log)
    proc = subprocess.run(link, capture_output=True, text=True, check=False)
    _check(link, proc.returncode, proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    for obj in objs:
        os.remove(obj)
    return lib, "".join(logs) + proc.stdout + proc.stderr


def _check(cmd: list[str], returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {returncode}:\n{' '.join(cmd)}\n{log}")


def load() -> ctypes.CDLL:
    """The kernel library, built at first use, with every signature set."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib

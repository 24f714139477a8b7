"""Build the CUDA sources with nvcc and bind them with ctypes.

One shared library per source file, with a plain C interface (no PyTorch
headers), so a build takes seconds. Libraries go to `build/tpuhevc_torch/`
at the repository root, named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so a changed source is never served a stale
build. Nothing is compiled at import time; the first call that needs a
kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from . import SOURCES

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "tpuhevc_torch")

FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-file extras: the MLP, the RDOQ trials, the bit estimate, the B
# step's, the grid coding's, the SAO decision's and the train step's float
# arithmetic round every float product on its own, as their PyTorch
# versions do
EXTRA_FLAGS = {k: ["-fmad=false"] for k in ("nnfme_mlp", "intra_txq",
                                            "tu_bits", "b_me", "b_pred",
                                            "b_txq", "grid_code",
                                            "grid_sao", "fme_train")}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple, object] = {}
BUILD_LOG: dict[str, str] = {}  # ptxas report (registers, smem) per source


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME:
            cand = os.path.join(CUDA_HOME, "bin", "nvcc")
            if os.path.exists(cand):
                path = cand
    if path is None:
        raise RuntimeError("nvcc not found (needs the CUDA toolkit)")
    return path


def _flags(name: str) -> list[str]:
    return FLAGS + EXTRA_FLAGS.get(name, [])


def so_path(name: str) -> str:
    """The library of `name`, named by a hash of its source, the shared
    headers of csrc/ and the flags."""
    h = hashlib.sha256()
    for src in [name + ".cu"] + sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict[str, float]:
    """Compile the named sources that have no current build, in parallel.
    Returns {name: seconds} for the ones compiled; raises on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        out = so_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc()] + _flags(name) + ["-o", tmp,
                                         os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs = {}
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[name] = time.time() - t0
        BUILD_LOG[name] = log
        if p.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = so_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
        return lib


def function(name: str, symbol: str, argtypes: list):
    """The C entry point `symbol` of `name`.so, typed (returns int)."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

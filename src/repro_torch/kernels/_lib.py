"""Build, load and count the port's CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`.
All sources build in parallel, at first use, into
``build/repro_torch_kernels/<hash>/`` at the repository root, where the
hash covers the sources and the flags: an edited source builds anew, an
unchanged one is loaded as it is.  Nothing here runs at import.

Every wrapper counts the kernels it launched in :data:`LAUNCHES` (one per
wrapper call that launched the kernel), so a run can show that its main
path went through them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

__all__ = [
    "KERNELS",
    "LAUNCHES",
    "build",
    "build_dir",
    "check",
    "count",
    "dtype_code",
    "library",
    "reset_launches",
    "stream",
]

# kernel name -> its CUDA source in csrc/
KERNELS = {
    "tile_sort": "row_sort.cu",
    "sort_kv": "kv_sort.cu",
    "merge_cut": "merge_cut.cu",
}

LAUNCHES = {name: 0 for name in KERNELS}

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.abspath(os.path.join(_CSRC, "..", "..", "..", ".."))
_DTYPES = {torch.float32: 0, torch.int32: 1}
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    "hk_row_sort": [_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR, _PTR],
    "hk_row_gather": [_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR, _PTR],
    "hk_argsort": [_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR],
    "hk_kv_gather": [_PTR, _PTR, _PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR],
    "hk_merge_cut": [_PTR, _PTR, _PTR, _PTR] + [_INT] * 5 + [_PTR, _PTR, _PTR],
}


def count(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> dict[str, int]:
    """Zero every launch count; returns the counts before the reset."""
    with _LOCK:
        out = dict(LAUNCHES)
        for name in LAUNCHES:
            LAUNCHES[name] = 0
    return out


def dtype_code(t: torch.Tensor) -> int:
    code = _DTYPES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32 or int32, not {t.dtype}")
    return code


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a C pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    return os.path.join(_REPO, "build", "repro_torch_kernels", _source_hash())


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels build on the GPU host")
    return found


def build() -> float:
    """Compile every kernel source not yet built, all in parallel; returns
    the seconds spent.  ``-Xptxas -v`` output lands in ``<name>.log``."""
    with _LOCK:
        out_dir = build_dir()
        todo = [
            src
            for src in KERNELS.values()
            if not os.path.exists(os.path.join(out_dir, src[:-3] + ".so"))
        ]
        if not todo:
            return 0.0
        os.makedirs(out_dir, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for src in todo:
            so = os.path.join(out_dir, src[:-3] + ".so")
            tmp = f"{so}.{os.getpid()}.tmp"
            log = open(os.path.join(out_dir, src[:-3] + ".log"), "wb")
            cmd = [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-o", tmp, os.path.join(_CSRC, src)]
            procs.append((src, so, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for src, so, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, so)
            else:
                failed.append(src)
        if failed:
            logs = []
            for src in failed:
                with open(os.path.join(out_dir, src[:-3] + ".log")) as f:
                    logs.append(f"--- {src}\n{f.read()[-4000:]}")
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build()
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(os.path.join(build_dir(), KERNELS[name][:-3] + ".so"))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = _INT
            lib.hk_error_string.argtypes = [_INT]
            lib.hk_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = lib.hk_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")

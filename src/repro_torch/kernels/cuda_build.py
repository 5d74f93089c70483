"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each source under ``src/repro_torch/csrc/`` is one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  All
sources compile at once, one ``nvcc`` process each, at first use; the
libraries land in a directory keyed by a digest of the sources and flags
(``build/repro_torch_kernels/`` at the repository root, which ``.gitignore``
lists).  Nothing here runs at import time: a CPU-only machine imports this
module but never calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HEADERS = ("dks_lattice.cuh",)
SOURCES = {
    "subset_combine": "subset_combine.cu",
    "lane_superstep": "lane_superstep.cu",
    "flash_attention": "flash_attention.cu",
    "embedding_bag": "embedding_bag.cu",
    "padded_topk": "padded_topk.cu",
    "batched_backtrace": "batched_backtrace.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# library -> {C entry point: argument types}; every entry returns an int.
SIGNATURES = {
    "subset_combine": {"dks_subset_combine": (_P, _P, _L, _I, _I, _P)},
    "lane_superstep": {"dks_lane_superstep":
                       (_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I,
                        _I, _P)},
    "flash_attention": {"flash_attention_fwd":
                        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                         _P)},
    "embedding_bag": {
        "embedding_bag_fwd": (_P, _L, _I, _P, _P, _P, _L, _I, _I, _P),
        "embedding_bag_grouped_fwd": (_P, _L, _I, _P, _P, _I, _P, _P, _L,
                                      _I, _I, _P)},
    "padded_topk": {"dks_padded_topk": (_P, _P, _L, _I, _I, _I, _P)},
    "batched_backtrace": {"bt_batched_backtrace":
                          (_P,) * 15 + (_I, _I, _L, _I, _I, _I, _I, _I, _L,
                                        _L, _P)},
}

# name -> {"seconds": build wall time, "log": nvcc's stderr (ptxas -v)}.
BUILD_LOG: dict[str, dict] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
             "/usr/local/cuda"]
    for root in cands:
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the repro_torch kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(HEADERS + tuple(SOURCES.values())):
        h.update(f.encode())
        h.update((CSRC / f).read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    """Where the library of one kernel source is (or will be) built."""
    return build_dir() / _digest() / f"lib{name}.so"


def build_all() -> dict[str, dict]:
    """Compile every source that has no library yet (all ``nvcc``
    processes started together); raises ``RuntimeError`` with the compiler
    output if any fails.  Returns :data:`BUILD_LOG`."""
    with _LOCK:
        todo = [n for n in SOURCES if not lib_path(n).exists()]
        if not todo:
            return BUILD_LOG
        nvcc = nvcc_path()
        procs = {}
        for name in todo:
            out = lib_path(name)
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.parent / f"tmp{os.getpid()}_{out.name}"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "log": log}
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not lib_path(name).exists():
        build_all()
    lib = ctypes.CDLL(str(lib_path(name)))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

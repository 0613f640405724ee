"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loads through ``ctypes`` -- no PyTorch headers,
so a build takes seconds, not minutes.  Libraries go to ``build/repro_torch/``
at the root of the checkout (listed in ``.gitignore``), named by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing builds at import: the first launch builds what it needs,
and :func:`build_all` starts one ``nvcc`` per source in parallel.

This module never falls back: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -split-compile=0: nvcc optimises and assembles the kernels of one source
# in parallel on every core (qn_apply.cu holds 36 kernel instances; in one
# thread their build alone took minutes)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")
SOURCES = ("qn_apply", "flash_attention", "rmsnorm")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of every exported launcher; all return a cudaError_t as int.
SIGNATURES: dict[str, dict[str, list]] = {
    "qn_apply": {
        # u, v, xs, mask, alpha, partial, out, m, B, D, K, tmask, n_cta,
        # slice, csize, nbuf, pref, l2_tiles, coop, bf16, vec, stream
        "qn_apply_multi_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I,
                                  _I, _I, _L, _I, _I, _I, _I, _I, _I, _I,
                                  _P],
        # u, v, g, s, hg, mask, slot, active, alpha, eps, partial, hg_new,
        # b, den, ev_u, ev_v, m, B, D, n_cta, slice, csize, nbuf, pref,
        # l2_tiles, coop, bf16, vec, stream
        "broyden_step_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _P,
                                _P, _P, _P, _P, _P, _I, _I, _L, _I, _L, _I,
                                _I, _I, _I, _I, _I, _I, _P],
        # broyden, bf16, m, K, vec, nbuf, out ctas
        "qn_stream_ctas": [_I, _I, _I, _I, _I, _I, _P],
        # u, v, s, hy, b, inv_den, slot, upd, ev_u, ev_v, m, B, D, chunk,
        # nchunks, bf16, vec, stream
        "lowrank_append_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                  _I, _L, _I, _I, _I, _I, _P],
    },
    "flash_attention": {
        # q, k, v, kv_len, out, partial, B, S, T, H, KV, HD, scale, causal,
        # decode, bf16, chunk, stream
        "flash_attention_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _I, _I, _I, _P],
    },
    "rmsnorm": {
        # x, w, out, rows, D, eps, bf16, per, wpr, n_cta, threads, stream
        "rmsnorm_launch": [_P, _P, _P, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all started together.  Returns per-source
    ``{"seconds", "cached", "log"}``; raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, report = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            report[name] = {"seconds": 0.0, "cached": True,
                            "log": log.read_text() if log.exists() else ""}
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                        "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")

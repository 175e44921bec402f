"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

The sources in `gen_fvgn_tpu_torch/csrc/*.cu` have a plain C interface (no
PyTorch headers), so a build takes seconds. Each source is compiled to an
object file by its own nvcc process, all started together, and the objects
are linked into one shared library under `gen_fvgn_tpu_torch/_build/`
(git-ignored). The library's name carries a hash of the sources, so an
edited source rebuilds and an unchanged one is reused.

A failed build raises; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("spmm.cu", "fused_mlp.cu", "fused_premlp.cu",
           "fused_slice_pool.cu")
# -fmad=false: no silent a*b+c contraction, so the kernels' float32
# elementwise steps round where the plain PyTorch versions round (the sparse
# apply asks for its fused multiply-adds explicitly).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None     # wall time of the last real build
BUILD_LOG: str = ""                       # nvcc's output (ptxas -v included)


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> None:
    global BUILD_SECONDS, BUILD_LOG
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{name}.{os.getpid()}.o"     # one per process
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs = [], []
    for name, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== nvcc {name} (exit {p.returncode})\n{out}")
        objs.append(str(obj))
    BUILD_LOG = "\n".join(logs)
    bad = [name for name, _, p in procs if p.returncode != 0]
    if bad:
        raise RuntimeError(f"nvcc failed for {bad}:\n{BUILD_LOG}")
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    BUILD_LOG += f"\n== link (exit {link.returncode})\n{link.stdout}"
    for obj in objs:
        os.unlink(obj)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{BUILD_LOG}")
    os.replace(tmp, lib_path)
    BUILD_SECONDS = time.perf_counter() - t0


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gfvgn_spmm_csr.restype = ci
    lib.gfvgn_spmm_csr.argtypes = [
        vp, vp, vp,            # crow, col, val
        vp, vp,                # x, out
        ci, ci, ci, ci,        # B, n_in, n_out, F
        ci, ci,                # x_is_bf16, out_is_bf16
        vp]                    # stream
    lib.gfvgn_fused_mlp.restype = ci
    lib.gfvgn_fused_mlp.argtypes = [
        vp, vp, ci, ci,        # part0, part1, width0, width1 (0 = absent)
        vp,                    # w1 [width0+width1, 128] bf16
        vp,                    # pre [M, 128] bf16 or null
        vp, vp, vp, vp, vp,    # b1, w2, b2, w3, b3
        vp, vp,                # gamma, beta (null without LayerNorm)
        vp, vp,                # out0, out1
        ci, ci, ci, ci, ci,    # M, res_idx, res_dual, layer_norm, d_out
        ci,                    # n_sm
        vp]                    # stream
    lib.gfvgn_fused_premlp.restype = ci
    lib.gfvgn_fused_premlp.argtypes = [
        vp, vp, vp,            # x [M, 128] bf16, gamma, beta
        vp, vp, vp, vp,        # w1 [128, 256] bf16, b1, w2 [256, 128] bf16, b2
        vp,                    # out [M, 128] bf16
        ci, ci,                # M, n_sm
        vp]                    # stream
    lib.gfvgn_fused_slice_pool.restype = ci
    lib.gfvgn_fused_slice_pool.argtypes = [
        vp, vp, ci,            # x [B, N, 128] bf16, mask f32, mask batch stride
        vp, vp, vp, vp,        # wfx, bfx, wx, bx
        vp, vp, vp,            # wsl [16, 32] bf16, bsl [32], inv_temp [8]
        vp, vp, vp, vp,        # slice_w, partials, tokens, norm
        ci, ci, ci, ci,        # B, N, rows_per_chunk, n_chunks
        vp]                    # stream


def load_library() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        lib_path = BUILD_DIR / f"libgfvgn_kernels_{_source_hash()}.so"
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _LIB = lib
    return _LIB

"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

The sources in `gen_fvgn_tpu_torch/csrc/*.cu` have a plain C interface (no
PyTorch headers), so a build takes seconds. Each source is compiled to an
object file by its own nvcc process, all started together, and the objects
are linked into one shared library under `gen_fvgn_tpu_torch/_build/`
(git-ignored). The library's name carries a hash of the sources and of the
headers they share, so an edit rebuilds and an unchanged tree is reused.

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
SOURCES = ("spmm.cu", "pair_spmm.cu", "fused_mlp.cu", "fused_premlp.cu",
           "fused_slice_pool.cu", "fused_slice_pool_bwd.cu")
# included by the sources: in the hash too
HEADERS = ("lane_reduce.cuh", "mma_sm90.cuh", "slice_pool_tiles.cuh")
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
    for name in SOURCES + HEADERS:
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
    cl = ctypes.c_longlong
    lib.gfvgn_spmm_csr.argtypes = [
        vp, vp, vp,            # crow, col, val
        vp, vp,                # x, out (windows)
        ci, ci, ci, ci,        # B, n_in, n_out, F
        cl, cl, cl, cl,        # x row/batch stride, out row/batch stride
        ci, ci,                # x_is_bf16, out_is_bf16
        vp]                    # stream
    for name in ("gfvgn_pair_sum", "gfvgn_pair_transpose"):
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = [
            vp, vp, vp,        # A: crow, col, val
            vp, vp, vp,        # B: crow, col, val
            vp, vp,            # operand, out
            ci, ci, ci, ci,    # B, n_in, n_out, H
            ci, ci,            # operand_is_bf16, out_is_bf16
            vp]                # stream
    lib.gfvgn_fused_mlp_workspace.restype = ctypes.c_longlong
    lib.gfvgn_fused_mlp_workspace.argtypes = [
        ci, ci, ci,            # width0, width1, H
        ci, ci, ci,            # has_pre, layer_norm, d_out
        ci, ci, ci]            # M, lanes, backward
    lib.gfvgn_fused_mlp.restype = ci
    lib.gfvgn_fused_mlp.argtypes = [
        vp, vp, ci, ci, ci,    # part0, part1, width0, width1 (0 = absent), H
        vp,                    # w1 [width0+width1, H] bf16
        vp,                    # pre [M, H] bf16 or null
        vp, vp, vp, vp, vp,    # b1, w2, b2, w3, b3
        vp, vp,                # gamma, beta (null without LayerNorm)
        vp, vp,                # out0, out1
        ci, ci, ci, ci, ci,    # M, res_idx, res_dual, layer_norm, d_out
        vp,                    # workspace
        vp]                    # stream
    lib.gfvgn_premlp_workspace.restype = ctypes.c_longlong
    lib.gfvgn_premlp_workspace.argtypes = [ci, ci, ci, ci]   # C, M, lanes, bwd
    lib.gfvgn_fused_premlp.restype = ci
    lib.gfvgn_fused_premlp.argtypes = [
        vp, vp, vp,            # x [M, C] bf16, gamma, beta
        vp, vp, vp, vp,        # w1 [C, 2C] bf16, b1, w2 [2C, C] bf16, b2
        vp,                    # out [M, C] bf16
        ci, ci,                # C, M
        vp]                    # stream
    lib.gfvgn_slice_pool_workspace.restype = ctypes.c_longlong
    lib.gfvgn_slice_pool_workspace.argtypes = [
        ci, ci, ci, ci, ci, ci]   # C, H, G, B, N, backward
    lib.gfvgn_fused_slice_pool.restype = ci
    lib.gfvgn_fused_slice_pool.argtypes = [
        vp, vp, ci,            # x [B, N, C] bf16, mask f32, mask batch stride
        vp, vp, vp, vp,        # wfx, bfx, wx, bx
        vp, vp, vp,            # wsl [D, G] bf16, bsl [G], inv_temp [H]
        vp, vp, vp,            # slice_w, tokens, norm
        ci, ci, ci, ci, ci,    # C, H, G, B, N
        vp, vp]                # workspace, stream
    lib.gfvgn_fused_mlp_bwd.restype = ci
    lib.gfvgn_fused_mlp_bwd.argtypes = [
        vp, vp, ci, ci, ci,    # part0, part1, width0, width1 (0 = absent), H
        vp, vp,                # w1 [width0+width1, H] bf16, pre or null
        vp, vp, vp, vp, vp,    # b1, w2, b2, w3, b3
        vp,                    # gamma (null without LayerNorm)
        vp, vp,                # dout0, dout1 (null unless res_dual)
        vp, vp, vp,            # dx0, dx1, dpre (null where absent)
        vp,                    # summed gradient slab (float32)
        ci, ci, ci, ci, ci,    # M, res_idx, res_dual, layer_norm, d_out
        ci,                    # lanes
        vp, vp]                # workspace, stream
    lib.gfvgn_fused_premlp_bwd.restype = ci
    lib.gfvgn_fused_premlp_bwd.argtypes = [
        vp, vp, vp,            # x [M, C] bf16, gamma, beta
        vp, vp, vp, vp,        # w1 [C, 2C] bf16, b1, w2 [2C, C] bf16, b2
        vp, vp,                # dout, dx [M, C] bf16
        vp,                    # summed gradient slab (float32)
        ci, ci, ci,            # C, M, lanes
        vp, vp]                # workspace, stream
    lib.gfvgn_fused_slice_pool_bwd.restype = ci
    lib.gfvgn_fused_slice_pool_bwd.argtypes = [
        vp, vp, ci,            # x [B, N, C] bf16, mask f32, mask batch stride
        vp, vp, vp, vp,        # wfx, bfx, wx, bx
        vp, vp, vp,            # wsl [D, G] bf16, bsl [G], inv_temp [H]
        vp, vp, vp,            # dslice_w bf16, dtokens f32, dnorm f32
        vp, vp,                # dx, summed slab
        ci, ci, ci, ci, ci,    # C, H, G, B, N
        vp, vp]                # workspace, stream


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

"""Build and load the hand-written CUDA kernels of ``leftrefill_torch/csrc``.

The sources are compiled at first launch with ``nvcc`` for ``sm_90a``, one
``nvcc`` per ``.cu`` file, all started together, then linked into
``leftrefill_torch/_build/<hash>/libleftrefill_kernels.so`` and loaded with
``ctypes`` (``native_lib.Library``: the hash covers every source, so an edit
rebuilds).  Each C entry point takes device pointers, ints and the CUDA
stream and returns ``cudaGetLastError()``; :func:`check` turns a non-zero
code into an error.

Importing this module needs neither ``nvcc`` nor a GPU: only a launch builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
from pathlib import Path

import torch

from leftrefill_torch import native_lib

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = native_lib.BUILD_ROOT
LIB_NAME = "libleftrefill_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, batch, heads, nq, nk, d, scale, stream
    "lr_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, dout, lse, delta, dq, batch, heads, nq, nk, d, scale, stream
    "lr_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # q, k, v, dout, lse, delta, dk, dv, batch, heads, nq, nk, d, scale, stream
    "lr_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # d -> dynamic shared memory of a block, bytes
    "lr_flash_fwd_smem": [_I],
    "lr_flash_bwd_dq_smem": [_I],
    "lr_flash_bwd_dkv_smem": [_I],
    # x, w, bias, out, b, h, w, ci, co, stream
    "lr_conv3x3": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # b, h, w, co -> output channels per block of the launch plan
    "lr_conv3x3_tile": [_I, _I, _I, _I],
    # output channels per block -> dynamic shared memory of a block, bytes
    "lr_conv3x3_smem": [_I],
    # x, w1, b1, w2, b2, h, out, r, din, inner, dout, stream
    "lr_geglu": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # r, dout -> output columns of a down block (lr_geglu_int8_tile: KI3's)
    "lr_geglu_tile": [_I, _I],
    "lr_geglu_int8_tile": [_I, _I],
    # kernel (0 up, 1 down), bn -> dynamic shared memory of a block, bytes
    "lr_geglu_smem": [_I, _I],
    "lr_geglu_int8_smem": [_I, _I],
    # x, w, scale, bias, out, b, h, w, ci, co, out_f32, stream
    "lr_conv3x3_int8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # b, h, w, ci, co, int[5] out -> the launch plan (tile, split, patch, shared memory)
    "lr_conv3x3_int8_plan": [_I, _I, _I, _I, _I, _P],
    # x, sx, w, sw, bias, res, out, r, k, n, stream
    "lr_dense_int8_res": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # r, k, n, int[4] out -> the launch plan (tile rows and columns, split, shared memory)
    "lr_dense_int8_res_plan": [_I, _I, _I, _P],
    # xq, sx, w1, s1, b1, w2, s2, b2, hq, sh, out, r, din, inner, dout, cw, stream
    "lr_geglu_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, a, bb, xq, scale, slots, n_slots, batch, hw, c, stream
    "lr_silu_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, gamma, beta, xn, xq, scale, rows, c, eps, stream
    "lr_ln_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # x, a, bb, xn, xq, scale, batch, hw, c, stream
    "lr_gn_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, gamma, beta, y, part, ticket, ab, batch, hw, c, groups, eps, silu, max_splits, stream
    "lr_group_norm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    # the timing probes (ops/probes.py):
    # q, k, v, o, lse, batch, heads, nq, nk, d, scale, exp, clamp, lse_store, rows, stream
    "lr_flash_fwd_variant": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    # exp, clamp, lse_store, rows -> 1 if that variant is built
    "lr_flash_fwd_variant_built": [_I, _I, _I, _I],
    # q, sq, k, sk, v, o, bh, nq, nk, scale, pv_int8, stream
    "lr_flash_int8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # x, o, n, stream
    "lr_noop": [_P, _P, _I, _P],
    # rows (variant) or pv_int8 -> dynamic shared memory of a block, bytes
    "lr_flash_fwd_variant_smem": [_I],
    "lr_flash_int8_smem": [_I],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _stages(nvcc: str, sources: list[Path], work: Path, target: Path) -> list:
    """One ``nvcc`` per source, all at once, then one link."""
    cu = [p for p in sources if p.suffix == ".cu"]
    objs = [str(work / f"{p.stem}.o") for p in cu]
    return [[[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(p)] for p, obj in zip(cu, objs)],
            [[nvcc, "-shared", "-o", str(target), *objs]]]


# each entry point returns cudaGetLastError()
LIBRARY = native_lib.Library(
    LIB_NAME, _sources, _nvcc, NVCC_FLAGS, _stages,
    {**{name: (argtypes, ctypes.c_int) for name, argtypes in _SIGNATURES.items()},
     "lr_error_string": ([_I], ctypes.c_char_p)})
library_path, build, library = LIBRARY.path, LIBRARY.build, LIBRARY.load


def check(code: int, name: str) -> None:
    if code != 0:
        msg = library().lr_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Wrapper-side argument checks: device, dtype, shape, contiguity, and
    16-byte alignment (the kernels move 16 bytes per copy)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


# ---------------------------------------------------------------------------
# routing of the dispatchers (flash attention and its backward, the bf16 and
# int8 3x3 convs, the int8 proj_out GEMM, the bf16 and int8 GEGLUs, the fused
# int8 prologues, the bf16 GroupNorm)

NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "conv3x3", "geglu", "conv3x3_int8", "dense_int8_res",
         "geglu_int8", "affine_silu_quant", "ln_quant", "gn_quant", "group_norm")
_ROUTER = native_lib.Router(NAMES, "kernels")


def plain_kernels_active(name: str) -> bool:
    return _ROUTER.is_plain(name)


def plain_kernels(names=NAMES):
    """Route the dispatchers of the kernels ``names`` (default: all) to the
    kernels' plain PyTorch versions.

    Only the full-model comparisons enter this (``chip_smoke.py``, the
    runbook's parity stage, ``tools/runbook.py``): they run the same forward
    (or train step, or decode) through the plain versions to hold the
    kernels' result against.  The serving and training paths never do."""
    return _ROUTER.plain(names)


_sites: list | None = None


@contextlib.contextmanager
def record_sites():
    """Collect (kernel, shape) for every dispatcher decision that chose a
    kernel while the context is open (site inventories and per-shape timing)."""
    global _sites
    prev, _sites = _sites, []
    try:
        yield _sites
    finally:
        _sites = prev


def note_site(kernel: str, shape: tuple) -> None:
    if _sites is not None:
        _sites.append((kernel, tuple(shape)))


def uses_kernel(t: torch.Tensor) -> bool:
    """Whether a dispatcher may send this tensor to a kernel: the kernels run
    on CUDA tensors only.  (The dispatch-count test patches this to count
    sites on the ``meta`` device.)"""
    return t.is_cuda

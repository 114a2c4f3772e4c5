"""Build and load the hand-written CUDA kernels of ``leftrefill_torch/csrc``.

The sources are compiled at first launch with ``nvcc`` for ``sm_90a``, one
``nvcc`` per ``.cu`` file, all started together, then linked into
``leftrefill_torch/_build/<hash>/libleftrefill_kernels.so`` (the hash covers
every source, so an edit rebuilds) and loaded with ``ctypes``.  Each C entry
point takes device pointers, ints and the CUDA stream and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.

Importing this module needs neither ``nvcc`` nor a GPU: only a launch builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
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

_lib = None
_lock = threading.Lock()


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile the sources unless this source hash is already built: one
    ``nvcc`` per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(out.parent / f"{src.stem}.{tag}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in jobs:
        logs.append(" ".join(cmd) + "\n" + proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(logs[-1])
    objs = [cmd[cmd.index("-o") + 1] for cmd, _ in jobs]
    if not failed:
        tmp = out.with_suffix(f".{tag}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(logs[-1])
    (out.parent / "build.log").write_text("\n".join(logs))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.lr_error_string.argtypes = [ctypes.c_int]
            lib.lr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


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
# int8 prologues)

NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "conv3x3", "geglu", "conv3x3_int8", "dense_int8_res",
         "geglu_int8", "affine_silu_quant", "ln_quant", "gn_quant")
_plain: frozenset = frozenset()


def plain_kernels_active(name: str) -> bool:
    return name in _plain


@contextlib.contextmanager
def plain_kernels(names=NAMES):
    """Route the dispatchers of the kernels ``names`` (default: all) to the
    kernels' plain PyTorch versions.

    Only the full-model comparisons enter this (``chip_smoke.py``, the
    runbook's parity stage, ``tools/runbook.py``): they run the same forward
    (or train step, or decode) through the plain versions to hold the
    kernels' result against.  The serving and training paths never do."""
    global _plain
    unknown = set(names) - set(NAMES)
    if unknown:
        raise ValueError(f"unknown kernels {sorted(unknown)}")
    prev, _plain = _plain, frozenset(names)
    try:
        yield
    finally:
        _plain = prev


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

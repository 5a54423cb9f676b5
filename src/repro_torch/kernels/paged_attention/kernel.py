"""Build, load and launch the CUDA paged-attention kernel.

``csrc/paged_attention.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout, named by a hash of the source and the flags, and loaded with
``ctypes``; later uses find the library already built. Nothing is built or
loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class LaunchCounter:
    """Counts kernel launches; ``chip_smoke.py`` reads it to show that the
    main path went through the kernel."""

    def __init__(self) -> None:
        self.count = 0

    def reset(self) -> None:
        self.count = 0


LAUNCHES = LaunchCounter()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA paged-attention kernel is "
                       "built from source at first use")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"paged_attention-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernel unless this source is already built; returns the
    shared library. ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) is kept beside it as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)          # atomic: a concurrent build sees all or nothing
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.paged_attention_bf16
        # q, k_pool, v_pool, tables, starts, n_valid, out; B, C, H, K, D,
        # bs, M, N, window; scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k_pool, v_pool, block_tables, starts, n_valid, block_size, window):
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables,
                   starts=starts, n_valid=n_valid)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {tensors[name].dtype}")
    for name in ("block_tables", "starts", "n_valid"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"want q (B,C,H,D) and equal pools (N,bs,K,D), got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, C, H, D = q.shape
    N, bs, K, Dk = k_pool.shape
    if bs != block_size or Dk != D or K == 0 or H % K:
        raise ValueError(f"pool {tuple(k_pool.shape)} does not fit q {tuple(q.shape)} "
                         f"with block_size={block_size}")
    if D % 2 or not 2 <= D <= 256:
        raise ValueError(f"head_dim must be even and <= 256, got {D}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] == 0
            or starts.shape != (B,) or n_valid.shape != (B,)):
        raise ValueError(f"tables {tuple(block_tables.shape)}, starts "
                         f"{tuple(starts.shape)}, n_valid {tuple(n_valid.shape)} "
                         f"do not fit batch {B}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def paged_attention_cuda(
    q: torch.Tensor,                   # (B, C, H, D) bf16
    k_pool: torch.Tensor,              # (N_blocks, block_size, K, D) bf16
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,        # (B, M) int32, -1 = unallocated
    starts: torch.Tensor,              # (B,) int32
    n_valid: torch.Tensor,             # (B,) int32
    *,
    block_size: int,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch the kernel on the current stream. Returns (B, C, H, D) bf16;
    columns ``>= n_valid`` are zeros. Raises on inputs the kernel does not
    take and on a refused launch."""
    _check(q, k_pool, v_pool, block_tables, starts, n_valid, block_size, window)
    B, C, H, D = q.shape
    N, _, K, _ = k_pool.shape
    out = torch.empty_like(q)
    scale = scale if scale is not None else D ** -0.5
    fn = _load().paged_attention_bf16
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                block_tables.data_ptr(), starts.data_ptr(), n_valid.data_ptr(),
                out.data_ptr(), B, C, H, K, D, block_size, block_tables.shape[1],
                N, window or 0, scale, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return out

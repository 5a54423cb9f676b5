"""Load and launch the CUDA selective-scan kernels: the forward and its
gradient.

``csrc/ssm_scan.cu`` and ``csrc/ssm_scan_bwd.cu`` have plain C interfaces
and share ``csrc/ssm_scan.cuh`` (the recurrence's step); ``kernels.loader``
builds each with ``nvcc`` at first use and loads it with ``ctypes``.
``ssm_scan_train_cuda`` runs the forward's training instance, which also
returns the state entering every chunk of ``CHUNK`` steps (``CHUNK`` is
``kChunk`` in ``ssm_scan.cuh``); ``ssm_scan_bwd_cuda`` launches the backward's
three passes from those states (each chunk's local carry, the carry
between chunks, each chunk's gradients) and then its fold of the partial
sums, and counts once in ``BWD_LAUNCHES``. ``bwd_resident_ctas`` reads the
gradient pass's resident CTAs an SM from the CUDA runtime. Nothing is built
or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import loader
from repro_torch.kernels.ssm_scan.ref import CHUNK

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
BWD_SOURCE = Path(__file__).resolve().parent / "csrc" / "ssm_scan_bwd.cu"
LAUNCHES = loader.LaunchCounter()
BWD_LAUNCHES = loader.LaunchCounter()
STATE_DIMS = (4, 8, 16)          # the N the kernel is instantiated for
DESIGN = ("v2: N/4 lanes a channel pair, longest rows first, 8-step stages in a 4-slot "
          "ring, ex2.approx")
BWD_DESIGN = ("v2: every (row, chunk of 32 steps) at once; a local carry pass, the carry "
              "between chunks (g_start = P g_end + L), then each chunk's gradients from its "
              "saved state, 8-step stages recomputed into registers; db, dc and da folded by "
              "a fourth launch, no atomics")
ROUTES = ("direct", "tma")       # the C interface's route codes, in order
_fn = None
_bwd_fn = None


def _load():
    global _fn
    if _fn is None:
        fn = loader.load(SOURCE).ssm_scan_bf16
        # dt, x, b, c, a, h0, n_valid, y, h_last, states; B, S, I, N, route;
        # stream
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _load_bwd():
    global _bwd_fn
    if _bwd_fn is None:
        fn = loader.load(BWD_SOURCE).ssm_scan_bwd_bf16
        # dt, x, b, c, dy, a, states, dh_last, n_valid, ddt, dx, dh0, part_db,
        # part_dc, carry, dtsum, db, dc, da; B, S, I, N; stream
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def bwd_resident_ctas(state_dim: int) -> int:
    """The backward's gradient pass (``ssm_scan_bwd_kernel``): its CTAs
    resident an SM at this N, by ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    (the card has no ``ncu``). Raises on a runtime error."""
    fn = loader.load(BWD_SOURCE).ssm_scan_bwd_occupancy
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(state_dim)
    if n < 0:
        raise RuntimeError(f"ssm_scan backward occupancy query failed: cudaError {-n}")
    return n


def n_chunks(seq_len: int) -> int:
    """Saved states a row: one where each chunk of ``CHUNK`` steps starts."""
    return -(-seq_len // CHUNK)


def _check(dt, b, c, x, a, h0, n_valid):
    tensors = dict(dt=dt, b=b, c=c, x=x, a=a, h0=h0, n_valid=n_valid)
    if h0 is None:                     # the backward takes the states instead
        del tensors["h0"]
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("dt", "b", "c", "x"):
        if tensors[name].dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {tensors[name].dtype}")
    for name in [n for n in ("a", "h0") if n in tensors]:
        if tensors[name].dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {tensors[name].dtype}")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (it moves as float4)")
    if n_valid.dtype != torch.int32:
        raise ValueError(f"n_valid must be int32, got {n_valid.dtype}")
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"want x (B, S, I) and b (B, S, N), got {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    B, S, I = x.shape
    N = b.shape[-1]
    if (dt.shape != x.shape or b.shape != (B, S, N) or c.shape != (B, S, N)
            or a.shape != (I, N) or (h0 is not None and h0.shape != (B, I, N))
            or n_valid.shape != (B,)):
        raise ValueError(f"dt {tuple(dt.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
                         f"a {tuple(a.shape)}, h0 {None if h0 is None else tuple(h0.shape)}, "
                         f"n_valid "
                         f"{tuple(n_valid.shape)} do not fit x {tuple(x.shape)}")
    if min(B, S, I) <= 0 or N not in STATE_DIMS:
        raise ValueError(f"need B, S, I > 0 and N in {STATE_DIMS}, got B={B} S={S} "
                         f"I={I} N={N}")
    if B > 65535:
        raise ValueError(f"at most 65535 rows (the grid's y), got B={B}")


def scan_route(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> str:
    """The route the kernel takes for these inputs: ``tma`` where its TMA
    maps can take them (N 8 or 16, so a step of b is a multiple of 16
    bytes; I a multiple of 8, so a step of dt and x is; dt, x, b and c on
    16-byte boundaries), else ``direct`` (the CTA's threads load each
    stage themselves)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (dt, x, b, c))
    return "tma" if b.shape[-1] in (8, 16) and x.shape[-1] % 8 == 0 and aligned else "direct"


def _launch(dt, b, c, x, a, h0, n_valid, save: bool):
    if loader.needs_grad(dt, b, c, x, a, h0):
        raise NotImplementedError(
            "ssm_scan_cuda returns an output autograd does not see; under grad call "
            "kernels.ssm_scan.ssm_scan, which runs SsmScanFn")
    B, S, I = x.shape
    N = b.shape[-1]
    if h0 is None:
        h0 = torch.zeros((B, I, N), dtype=torch.float32, device=x.device)
    if n_valid is None:
        n_valid = torch.full((B,), S, dtype=torch.int32, device=x.device)
    _check(dt, b, c, x, a, h0, n_valid)
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    states = (torch.empty((B, n_chunks(S), I, N), dtype=torch.float32, device=x.device)
              if save else None)
    fn = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
                h0.data_ptr(), n_valid.data_ptr(), y.data_ptr(), h_last.data_ptr(),
                states.data_ptr() if save else None, B, S, I, N,
                ROUTES.index(scan_route(dt, b, c, x)), stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {rc}")
    LAUNCHES.count += 1
    return y, h_last, states


def ssm_scan_cuda(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  x: torch.Tensor, a: torch.Tensor,
                  h0: Optional[torch.Tensor] = None,
                  n_valid: Optional[torch.Tensor] = None):
    """Launch the kernel on the current stream. Returns (y (B, S, I) bf16,
    zero at columns ``>= n_valid``; h_last (B, I, N) f32). ``h0`` None is
    zeros, ``n_valid`` None every column. Raises on inputs the kernel does
    not take and on a refused launch, and under grad: ``ops.ssm_scan``
    differentiates it through ``SsmScanFn``."""
    return _launch(dt, b, c, x, a, h0, n_valid, False)[:2]


def ssm_scan_train_cuda(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                        x: torch.Tensor, a: torch.Tensor,
                        h0: Optional[torch.Tensor] = None,
                        n_valid: Optional[torch.Tensor] = None):
    """``ssm_scan_cuda``'s training instance: the same y and h_last, bit for
    bit, and the state entering each chunk of ``CHUNK`` steps, (B,
    ``n_chunks(S)``, I, N) f32 (``h_last`` for a chunk at or past
    ``n_valid``), which ``ssm_scan_bwd_cuda`` takes. Returns (y, h_last,
    states); raises as ``ssm_scan_cuda``."""
    return _launch(dt, b, c, x, a, h0, n_valid, True)


def ssm_scan_bwd_cuda(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      x: torch.Tensor, a: torch.Tensor, states: torch.Tensor,
                      dy: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                      dh_last: Optional[torch.Tensor] = None):
    """The scan's gradient on the current stream, given ``states`` (the
    training forward's chunk states) and ``dy`` (B, S, I), the gradient of
    ``y``, and ``dh_last`` (B, I, N) f32 that of ``h_last`` (None: zero).
    Returns ``(ddt, db, dc, dx, da, dh0)``: ddt, dx (B, S, I) and db, dc
    (B, S, N) bf16, zero at columns ``>= n_valid``; da (I, N) and dh0
    (B, I, N) f32 (``ref.ssm_scan_bwd_ref`` states the recurrence). Each
    element is summed in one fixed order: two calls give the same bits.
    Raises on inputs the kernel does not take and on a refused launch."""
    B, S, I = x.shape
    N = b.shape[-1]
    if n_valid is None:
        n_valid = torch.full((B,), S, dtype=torch.int32, device=x.device)
    _check(dt, b, c, x, a, None, n_valid)
    if n_chunks(S) > 65535:
        raise ValueError(f"at most 65535 chunks of {CHUNK} columns (the grid's y), got S={S}")
    want = {"dy": (dy, torch.bfloat16, (B, S, I)),
            "states": (states, torch.float32, (B, n_chunks(S), I, N)),
            "dh_last": (dh_last, torch.float32, (B, I, N))}
    for name, (t, dtype, shape) in want.items():
        if t is not None and (t.device != x.device or t.dtype != dtype
                              or tuple(t.shape) != shape or not t.is_contiguous()
                              or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {dtype} {shape} "
                             f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty((I, N), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((B, I, N), dtype=torch.float32, device=x.device)
    # scratch: db's and dc's partials a channel block; each chunk's L, then
    # G_end, then da's partial; each chunk's sum of dt a channel
    part_db, part_dc = (torch.empty((-(-I // 64), B, S, N), dtype=torch.float32,
                                    device=x.device) for _ in range(2))
    carry = torch.empty((B, n_chunks(S), I, N), dtype=torch.float32, device=x.device)
    dtsum = torch.empty((B, n_chunks(S), I), dtype=torch.float32, device=x.device)
    fn = _load_bwd()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(dt.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
                a.data_ptr(), states.data_ptr(),
                dh_last.data_ptr() if dh_last is not None else None, n_valid.data_ptr(),
                ddt.data_ptr(), dx.data_ptr(), dh0.data_ptr(), part_db.data_ptr(),
                part_dc.data_ptr(), carry.data_ptr(), dtsum.data_ptr(), db.data_ptr(),
                dc.data_ptr(), da.data_ptr(), B, S, I, N, stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan backward kernel launch failed: cudaError {rc}")
    BWD_LAUNCHES.count += 1
    return ddt, db, dc, dx, da, dh0

"""xLSTM blocks (the port of ``repro/models/xlstm.py``): mLSTM (matrix
memory) and sLSTM (scalar memory, recurrent).

Both use exponential gating with the max-stabiliser of the xLSTM paper
(arXiv:2405.04517); q/k/v and the sLSTM recurrence use block-diagonal
per-head projections. The sequential scan is the reference path; the
chunk-parallel mLSTM (``_mlstm_chunked``) runs where the JAX package runs
it, a prefill of at least ``2 * chunk`` tokens with no valid gate, with the
JAX package's chunk rule. The JAX package has no Pallas kernel for either
recurrence, so the port runs both in plain PyTorch.

Caches are the JAX package's dicts: ``{"conv", "state", "n", "m"}`` for an
mLSTM layer (conv history in the cache dtype; C (B, H, dh, dh), n (B, H,
dh), m (B, H) float32, ``m`` starting at -inf) and ``{"state", "c", "n",
"m"}`` for an sLSTM one (h, c, n (B, d), m (B, H) float32, ``n`` starting
at ones). Parameters keep the JAX layouts and are cast by the caller; the
rounding points are the JAX functions'.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.kernels.loader import needs_grad
from repro_torch.models.common import ParamBuilder, act_fn
from repro_torch.models.ssm import _causal_conv

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_dims(d_model: int, xc: XLSTMConfig) -> Tuple[int, int, int]:
    """(inner, heads, head width) of an mLSTM layer."""
    inner = int(d_model * xc.proj_factor_mlstm)
    return inner, xc.num_heads, inner // xc.num_heads


def init_mlstm(b: ParamBuilder, d_model: int, xc: XLSTMConfig) -> None:
    inner, h, dh = mlstm_dims(d_model, xc)
    b.param("up_proj", (d_model, 2 * inner))
    b.param("conv_w", (xc.conv_width, inner))
    b.param("conv_b", (inner,), init="zeros")
    for n in ("wq", "wk", "wv"):
        b.param(n, (h, dh, dh), fan_in=dh)
    b.param("w_gates", (inner, 2 * h))                  # i~, f~ per head
    b.param("b_gates", (2 * h,), init="zeros")
    b.param("out_norm", (inner,), init="zeros")
    b.param("down_proj", (inner, d_model), fan_in=inner)


def _zero_state(B: int, H: int, dh: int, device) -> State:
    return (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H), float("-inf"), dtype=torch.float32, device=device))


def _gates(f_log: torch.Tensor, i_log: torch.Tensor, m0: torch.Tensor,
           valid: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stabiliser and the gate weights of every column at once.

    The recurrence m_t = max(log sigmoid(f_t) + m_{t-1}, i_t) unrolls to
    m_t = F_t + max(m_0, cummax_{k<=t} (i_k - F_k)), F the running sum of
    log sigmoid(f). An invalid column is the identity: its log f is 0 and
    its i is -inf (m unchanged), its decay 1 and input weight 0. Returns
    (m, f_p, i_p), each (B, S, H)."""
    if valid is not None:
        f_log = torch.where(valid[..., None], f_log, 0.0)
        i_log = torch.where(valid[..., None], i_log, float("-inf"))
    F_run = f_log.cumsum(1)
    m = F_run + torch.maximum(torch.cummax(i_log - F_run, dim=1).values, m0[:, None])
    m_prev = torch.cat([m0[:, None], m[:, :-1]], dim=1)
    f_p = torch.exp(f_log + m_prev - m)
    i_p = torch.exp(i_log - m)
    if valid is not None:
        f_p = torch.where(valid[..., None], f_p, 1.0)
        i_p = torch.where(valid[..., None], i_p, 0.0)
    return m, f_p, i_p


def _mlstm_scan(q, k, v, i_raw, f_raw, state: Optional[State] = None,
                valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, State]:
    """The stabilised mLSTM recurrence, one column at a time.

    q, k, v (B, S, H, dh); i_raw, f_raw (B, S, H). Returns (y (B, S, H, dh)
    float32, (C, n, m)), all float32. ``valid`` (B, S) bool gates the state
    per row and column: an invalid column leaves (C, n, m) as they were, so
    each row advances by its own tokens alone (its ``y`` there is garbage,
    as in the JAX package), which ``_gates`` gets by a decay of 1 and an
    input weight of 0 (C and n kept bit for bit for finite inputs, without
    a (B, H, dh, dh) select). The stabiliser and gate weights depend on the
    gates alone and are taken for every column first (``_gates``); then C
    (copied once, then updated in place) and n advance column by column,
    four operations a column; the outputs' denominators are taken after.
    Under grad each column makes new tensors instead, which autograd can
    differentiate."""
    B, S, H, dh = q.shape
    c, n, m0 = _zero_state(B, H, dh, q.device) if state is None else state
    grad = needs_grad(q, k, v, i_raw, f_raw, c, n, m0)
    m, f_p, i_p = _gates(F.logsigmoid(f_raw.float()), i_raw.float(), m0, valid)
    col = lambda t: t.transpose(0, 1).contiguous()                # column-major copies
    qf = q.float()
    ik, vf = col(i_p[..., None] * (k.float() * (dh ** -0.5))), col(v.float())
    q_rows, f_col = col(qf).view(S, B * H, 1, dh), col(f_p)
    if grad:
        nums, n_list = [], []
        for t in range(S):
            c = c * f_col[t][..., None, None] + ik[t][..., :, None] * vf[t][..., None, :]
            nums.append(torch.bmm(q_rows[t], c.view(B * H, dh, dh)))
            n = torch.addcmul(ik[t], f_col[t][..., None], n)
            n_list.append(n)
        num, ns = torch.stack(nums), torch.stack(n_list)
    else:
        c = c.clone()
        c_rows = c.view(B * H, dh, dh)
        num = torch.empty((S, B * H, 1, dh), dtype=torch.float32, device=q.device)
        ns = torch.empty((S, B, H, dh), dtype=torch.float32, device=q.device)
        for t in range(S):
            c.mul_(f_col[t][..., None, None]).addcmul_(ik[t][..., :, None], vf[t][..., None, :])
            torch.bmm(q_rows[t], c_rows, out=num[t])
            n = torch.addcmul(ik[t], f_col[t][..., None], n, out=ns[t])
    den = torch.maximum((ns * qf.transpose(0, 1)).sum(-1).abs(), torch.exp(-col(m)))
    y = num.view(S, B, H, dh) / den[..., None]
    return y.transpose(0, 1), (c, n, m[:, -1])


def mlstm_chunk_len(S: int, chunk: int) -> int:
    """The chunk length ``_mlstm_chunked`` takes: the largest divisor of S
    that is at most ``chunk`` (the JAX package's rule, unchanged: a prime
    S gives 1)."""
    ck = min(chunk, S)
    while S % ck:
        ck -= 1
    return ck


def _mlstm_chunked(q, k, v, i_raw, f_raw, state: Optional[State] = None,
                   chunk: int = 256) -> Tuple[torch.Tensor, State]:
    """Chunk-parallel mLSTM, the exact-math reformulation of ``_mlstm_scan``
    (the JAX function's derivation): with F_t the running sum of log
    sigmoid(f) in a chunk, g_k = i_k - F_k, M*_j = max(m_in, cummax_{k<=j}
    g_k) and m_j = F_j + M*_j, a chunk is an intra-chunk masked attention
    and one contraction with the carried state. Chunks of
    ``mlstm_chunk_len(S, chunk)``.

    The intra-chunk attention of every chunk is taken at once, weighted by
    the chunk's own running max L_j = cummax g (so exp(g_k - M*_j) is
    exp(g_k - L_j) exp(L_j - M*_j)); then the carried (C, n, m) advance
    chunk by chunk; then each chunk's weights are rescaled to M*_j and its
    carried part added. Returns (y (B, S, H, dh) float32, (C, n, m))."""
    B, S, H, dh = q.shape
    ck = mlstm_chunk_len(S, chunk)
    nc = S // ck
    split = lambda t: t.float().reshape(B, nc, ck, *t.shape[2:])
    qb, kb, vb = split(q), split(k) * (dh ** -0.5), split(v)       # (B, nc, ck, H, dh)
    F_c = split(F.logsigmoid(f_raw.float())).cumsum(2)             # (B, nc, ck, H)
    g = split(i_raw) - F_c
    L = torch.cummax(g, dim=2).values
    causal = torch.ones((ck, ck), dtype=torch.bool, device=q.device).tril()
    logw = g.transpose(2, 3)[..., None, :] - L.transpose(2, 3)[..., :, None]  # (B,nc,H,j,k)
    w = torch.where(causal, torch.exp(logw), 0.0)
    scores = torch.einsum("bcjhd,bckhd->bchjk", qb, kb)
    num = torch.einsum("bchjk,bckhd->bcjhd", scores * w, vb)
    n_loc = torch.einsum("bchjk,bckhd->bcjhd", w, kb)
    c_in, n_in, m_in = _zero_state(B, H, dh, q.device) if state is None else state
    q_c = torch.empty_like(num)
    n_ins, m_ins = [], []
    for j in range(nc):
        n_ins.append(n_in)
        m_ins.append(m_in)
        q_c[:, j] = torch.einsum("bjhd,bhde->bjhe", qb[:, j], c_in)
        # the state carried past the chunk (coefficients at its last column)
        ms_tot = torch.maximum(L[:, j, -1], m_in)                  # (B, H)
        kv_w = torch.exp(g[:, j] - ms_tot[:, None])                # (B, ck, H)
        decay = torch.exp(m_in - ms_tot)
        c_in = (torch.einsum("bkhd,bkhe->bhde", kb[:, j] * kv_w[..., None], vb[:, j])
                + c_in * decay[..., None, None])
        n_in = torch.einsum("bkhd,bkh->bhd", kb[:, j], kv_w) + n_in * decay[..., None]
        m_in = F_c[:, j, -1] + ms_tot
    m_0 = torch.stack(m_ins, dim=1)[:, :, None]                    # (B, nc, 1, H)
    mstar = torch.maximum(L, m_0)
    scale = torch.exp(L - mstar)[..., None]
    carry = torch.exp(m_0 - mstar)[..., None]
    num = num * scale + q_c * carry
    n_all = n_loc * scale + torch.stack(n_ins, dim=1)[:, :, None] * carry
    den = torch.maximum((qb * n_all).sum(-1).abs(), torch.exp(-(F_c + mstar)))
    return (num / den[..., None]).reshape(B, S, H, dh), (c_in, n_in, m_in)


def _group_norm_heads(y: torch.Tensor, scale: torch.Tensor, heads: int) -> torch.Tensor:
    """Per-head RMS norm of (B, S, inner) split into heads, float32."""
    B, S, inner = y.shape
    yh = y.reshape(B, S, heads, inner // heads).float()
    yh = yh * torch.rsqrt(yh.square().mean(-1, keepdim=True) + 1e-6)
    return yh.reshape(B, S, inner) * (1.0 + scale.float())


def mlstm_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, xc: XLSTMConfig, *,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, S, d) -> (B, S, d), and the new ``{"conv", "state", "n",
    "m"}`` when ``cache`` is given. ``valid`` (B, S) bool, a valid prefix
    per row: the conv history and the recurrence advance over each row's
    real columns alone. The chunk-parallel form runs exactly when ``valid``
    is None and ``S >= 2 * xc.chunk``; every other call takes the scan."""
    B, S, d = x.shape
    inner, h, dh = mlstm_dims(d, xc)
    up = x @ params["up_proj"]
    x_in, z = up[..., :inner], up[..., inner:]
    n_valid = valid.sum(dim=1).to(torch.int32) if valid is not None else None
    x_c, new_hist = _causal_conv(x_in, params["conv_w"], params["conv_b"],
                                 cache["conv"] if cache is not None else None,
                                 n_valid=n_valid)
    x_c = F.silu(x_c)

    xh = x_c.reshape(B, S, h, dh)
    q = torch.einsum("bshd,hde->bshe", xh, params["wq"])
    k = torch.einsum("bshd,hde->bshe", xh, params["wk"])
    v = torch.einsum("bshd,hde->bshe", x_in.reshape(B, S, h, dh), params["wv"])
    gates = x_c @ params["w_gates"] + params["b_gates"]
    i_raw, f_raw = gates[..., :h], gates[..., h:]

    state = None if cache is None else (cache["state"], cache["n"], cache["m"])
    if valid is None and S >= 2 * xc.chunk:
        y, (c, n, m) = _mlstm_chunked(q, k, v, i_raw, f_raw, state, chunk=xc.chunk)
    else:
        y, (c, n, m) = _mlstm_scan(q, k, v, i_raw, f_raw, state, valid=valid)

    y = _group_norm_heads(y.reshape(B, S, inner), params["out_norm"], h)
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ params["down_proj"]
    if cache is None:
        return out, None
    return out, {"conv": new_hist.to(cache["conv"].dtype), "state": c, "n": n, "m": m}


def mlstm_init_cache(d_model: int, xc: XLSTMConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """Zero conv history (B, W-1, inner) in ``dtype``; zero C and n, m at
    -inf, float32."""
    inner, h, dh = mlstm_dims(d_model, xc)
    c, n, m = _zero_state(batch, h, dh, device)
    return {"conv": torch.zeros((batch, xc.conv_width - 1, inner), dtype=dtype, device=device),
            "state": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_ff_half(d_model: int, xc: XLSTMConfig) -> int:
    """Gated-FF half width: proj_factor * d_model rounded up to 64."""
    return -(-int(d_model * xc.proj_factor_slstm) // 64) * 64


def init_slstm(b: ParamBuilder, d_model: int, xc: XLSTMConfig) -> None:
    h = xc.num_heads
    dh = d_model // h
    b.param("w_in", (d_model, 4 * d_model))
    b.param("r_rec", (h, dh, 4 * dh), fan_in=dh)
    b.param("b_in", (4 * d_model,), init="zeros")
    b.param("out_norm", (d_model,), init="zeros")
    half = slstm_ff_half(d_model, xc)
    b.param("ff_up", (d_model, 2 * half))
    b.param("ff_down", (half, d_model), fan_in=half)


def slstm_forward(params: Dict[str, torch.Tensor], x: torch.Tensor, xc: XLSTMConfig, *,
                  cache: Optional[Dict[str, torch.Tensor]] = None,
                  valid: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, S, d) -> (B, S, d), and the new ``{"state", "c", "n", "m"}``
    when ``cache`` is given. The recurrence runs in float32 (``r_rec`` cast
    to it) with a per-head max stabiliser; ``valid`` gates h, c, n and m
    per row and column; then the per-head norm and the gated FF (tanh
    GELU)."""
    B, S, d = x.shape
    h = xc.num_heads
    dh = d // h
    w = (x @ params["w_in"] + params["b_in"]).float()                 # (B, S, 4d)
    if cache is not None:
        h_prev, c, n, m = cache["state"], cache["c"], cache["n"], cache["m"]
    else:
        h_prev = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h_prev)
        n = torch.ones_like(h_prev)
        m = torch.zeros((B, h), dtype=torch.float32, device=x.device)
    r_rec = params["r_rec"].float()
    ys = []
    for t in range(S):
        rec = torch.einsum("bhd,hdg->bhg", h_prev.view(B, h, dh), r_rec).reshape(B, 4 * d)
        i_r, f_r, z_r, o_r = (w[:, t] + rec).chunk(4, dim=-1)           # (B, d) each
        i_h = i_r.reshape(B, h, dh)
        f_h = F.logsigmoid(f_r).reshape(B, h, dh)
        m_new = torch.maximum(f_h.amax(-1) + m, i_h.amax(-1))           # (B, h)
        i_p = torch.exp(i_h - m_new[..., None]).reshape(B, d)
        f_p = torch.exp(f_h + (m - m_new)[..., None]).reshape(B, d)
        c_up = torch.addcmul(f_p * c, i_p, torch.tanh(z_r))
        n_up = torch.addcmul(i_p, f_p, n)
        h_new = torch.sigmoid(o_r) * c_up / n_up.clamp_min(1e-6)
        ys.append(h_new)
        if valid is None:
            h_prev, c, n, m = h_new, c_up, n_up, m_new
        else:
            keep = valid[:, t, None]
            h_prev = torch.where(keep, h_new, h_prev)
            c = torch.where(keep, c_up, c)
            n = torch.where(keep, n_up, n)
            m = torch.where(keep, m_new, m)
    y = torch.stack(ys, dim=1).reshape(B, S, h, dh)                    # float32
    y = (y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-6)).reshape(B, S, d)
    y = (y * (1.0 + params["out_norm"].float())).to(x.dtype)
    u, g = (y @ params["ff_up"]).chunk(2, dim=-1)
    out = (u * act_fn("gelu")(g)) @ params["ff_down"]
    if cache is None:
        return out, None
    return out, {"state": h_prev, "c": c, "n": n, "m": m}


def slstm_init_cache(d_model: int, xc: XLSTMConfig, batch: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """h and c zero, n ones (B, d); m zero (B, H); all float32. An sLSTM
    layer keeps no conv history."""
    f32 = dict(dtype=torch.float32, device=device)
    return {"state": torch.zeros((batch, d_model), **f32),
            "c": torch.zeros((batch, d_model), **f32),
            "n": torch.ones((batch, d_model), **f32),
            "m": torch.zeros((batch, xc.num_heads), **f32)}

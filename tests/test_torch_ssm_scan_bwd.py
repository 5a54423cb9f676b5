"""Port parity: the selective scan's gradient (the backward kernel's plain
version) against the JAX package's.

``repro_torch.kernels.ssm_scan.ssm_scan_bwd_ref`` (the reverse recurrence,
a chunk of 32 columns at a time from each chunk's saved state; what the
CUDA backward is held against on the card) against ``jax.vjp`` of JAX's
``selective_scan_ref`` for all six inputs, with a cotangent for ``y`` and
for ``h_last`` and with none for ``h_last``, at N 4, 8 and 16, S not a
multiple of the chunk, ``h0`` zero and not. Inputs from numpy seed 0 in
float32. Tolerance: each element within 1e-5 of its gradient's largest
element: float32 throughout, the same products summed in
other orders, through up to 70 steps of a decaying recurrence.

Then, in the port alone: the gated rows (valid prefixes 0, 1, partial and
full) against autograd through ``ssm_scan_loop``; the chunk states
(``ssm_scan_chunk_states``, the training forward's extra output) against
the column loop's states; and ``SsmScanFn``'s plumbing on the CPU with
its two CUDA entries standing in as their plain versions; and the
wrappers' chunk (``ref.CHUNK``) the kernels' ``kChunk``.

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import selective_scan_ref as j_ref
from repro_torch.kernels.ssm_scan import (SsmScanFn, ssm_scan_bwd_ref, ssm_scan_chunk_states,
                                          ssm_scan_ref)
from repro_torch.kernels.ssm_scan import ops as sops
from repro_torch.kernels.ssm_scan.ref import CHUNK, ssm_scan_loop
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

REL = 1e-5
NAMES = ("dt", "b", "c", "x", "a", "h0")


def _inputs(b, s, i, n, *, h0_zero=False, seed=0):
    """dt, b, c, x, a, h0 and the cotangents dy, dh_last, float32 from
    numpy: dt softplus of normals, a = -exp(normal * 0.3)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale).astype(np.float32)
    dt = np.log1p(np.exp(f(b, s, i))).astype(np.float32)
    bb, cc, x = f(b, s, n, scale=0.5), f(b, s, n, scale=0.5), f(b, s, i, scale=0.5)
    a = (-np.exp(f(i, n, scale=0.3))).astype(np.float32)
    h0 = np.zeros((b, i, n), np.float32) if h0_zero else f(b, i, n, scale=0.1)
    return (dt, bb, cc, x, a, h0), f(b, s, i), f(b, i, n)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


@pytest.mark.parametrize("b,s,i,n,h0_zero,with_dh", [
    (2, 70, 24, 16, False, True),      # three chunks, the last of 6 columns
    (3, 45, 16, 8, True, True),        # h0 zero
    (2, 33, 12, 4, False, False),      # no cotangent for h_last
])
def test_bwd_ref_matches_jax_vjp(b, s, i, n, h0_zero, with_dh):
    arrays, dy, dh = _inputs(b, s, i, n, h0_zero=h0_zero)
    _, vjp = jax.vjp(j_ref, *map(jnp.asarray, arrays))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh if with_dh else np.zeros_like(dh))))
    t = [torch.from_numpy(x) for x in arrays]
    got = ssm_scan_bwd_ref(*t[:5], torch.from_numpy(dy), t[5],
                           dh_last=torch.from_numpy(dh) if with_dh else None)
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert got[4].shape == (i, n) and got[5].shape == (b, i, n)
    for name, g, w in zip(NAMES, got, want):
        _close(g.numpy(), np.asarray(w), f"d{name}")


@pytest.mark.parametrize("n_valid", [(0, 1, 40, 70), (70, 33, 64, 0)])
def test_gated_rows_match_autograd_through_the_loop(n_valid):
    """Rows with 0, 1, partial and full valid prefixes (a chunk boundary
    at 32 and 64): the gradients equal autograd through ``ssm_scan_loop``,
    gated columns get exact zeros, and an empty row's ``dh0`` is its
    ``dh_last``."""
    arrays, dy, dh = _inputs(4, 70, 20, 8, seed=1)
    t = [torch.from_numpy(x) for x in arrays]
    nv = torch.tensor(n_valid, dtype=torch.int32)
    leaves = [x.clone().requires_grad_(True) for x in t]
    y, h = ssm_scan_loop(*leaves, nv)
    torch.autograd.backward([y, h], [torch.from_numpy(dy), torch.from_numpy(dh)])
    got = ssm_scan_bwd_ref(*t[:5], torch.from_numpy(dy), t[5], nv, torch.from_numpy(dh))
    for name, g, leaf in zip(NAMES, got, leaves):
        _close(g.numpy(), leaf.grad.numpy(), f"d{name}")
    gated = torch.arange(70)[None, :] >= nv.long()[:, None]
    for g in (got[0], got[3], got[1], got[2]):
        assert (g[gated] == 0).all()
    empty = nv == 0
    assert torch.equal(got[5][empty], torch.from_numpy(dh)[empty])


@pytest.mark.parametrize("s,n_valid", [(70, None), (64, (64, 0, 31, 33))])
def test_chunk_states_match_the_loop(s, n_valid):
    """The state entering each chunk of 32 columns against the column
    loop's state after the chunk before (``h0`` for the first; a row's
    last state for chunks at or past its prefix), within 1e-5; and the
    backward from the loop's states equals the backward that computes its
    own."""
    arrays, dy, _ = _inputs(4, s, 12, 16, seed=2)
    t = [torch.from_numpy(x) for x in arrays]
    nv = None if n_valid is None else torch.tensor(n_valid, dtype=torch.int32)
    states = ssm_scan_chunk_states(*t, nv)
    assert states.shape == (4, -(-s // CHUNK), 12, 16) and states.dtype == torch.float32
    assert torch.equal(states[:, 0], t[5])
    loop = [t[5]] + [ssm_scan_loop(*(x[:, :k] for x in t[:4]), t[4], t[5], nv)[1]
                     for k in range(CHUNK, s, CHUNK)]
    for k, want in enumerate(loop):
        np.testing.assert_allclose(states[:, k].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    mine = ssm_scan_bwd_ref(*t[:5], torch.from_numpy(dy), t[5], nv)
    theirs = ssm_scan_bwd_ref(*t[:5], torch.from_numpy(dy), None, nv,
                              states=torch.stack(loop, dim=1))
    for name, g, w in zip(NAMES, mine, theirs):
        _close(g.numpy(), w.numpy(), f"d{name} from the loop's states")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_fn_plumbing(monkeypatch, dtype):
    """``SsmScanFn`` on the CPU, its CUDA entries standing in as their
    plain versions: its gradients equal autograd through ``ssm_scan_ref``
    (float32 within 1e-5; bf16 within one bf16 step of the largest), each
    in its input's dtype, the forward's states those of
    ``ssm_scan_chunk_states``, and ``n_valid`` gets none."""
    seen = {}

    def fwd(dt, b, c, x, a, h0, n_valid):
        seen["states"] = ssm_scan_chunk_states(dt, b, c, x, a, h0, n_valid)
        return (*ssm_scan_ref(dt, b, c, x, a, h0, n_valid), seen["states"])

    def bwd(dt, b, c, x, a, states, dy, n_valid, dh_last):
        assert states is seen["states"]
        return ssm_scan_bwd_ref(dt, b, c, x, a, dy, None, n_valid, dh_last, states=states)

    monkeypatch.setattr(sops, "ssm_scan_train_cuda", fwd)
    monkeypatch.setattr(sops, "ssm_scan_bwd_cuda", bwd)
    arrays, dy, dh = _inputs(3, 40, 16, 8, seed=3)
    cast = [torch.from_numpy(x).to(dtype if k < 4 else torch.float32)
            for k, x in enumerate(arrays)]
    nv = torch.tensor([40, 0, 17], dtype=torch.int32)
    dy_t, dh_t = torch.from_numpy(dy).to(dtype), torch.from_numpy(dh)
    mine = [x.clone().requires_grad_(True) for x in cast]
    y, h = SsmScanFn.apply(*mine, nv)
    torch.autograd.backward([y, h], [dy_t, dh_t])
    theirs = [x.clone().requires_grad_(True) for x in cast]
    y2, h2 = ssm_scan_ref(*theirs, nv)
    torch.autograd.backward([y2, h2], [dy_t, dh_t])
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for name, p, q in zip(NAMES, mine, theirs):
        assert p.grad.dtype == p.dtype, name
        tol = REL if dtype == torch.float32 else 2 ** -7
        scale = float(q.grad.float().abs().max())
        err = float((p.grad.float() - q.grad.float()).abs().max())
        assert err <= tol * scale, (name, err, scale)
    # n_valid and any input that needs no grad get None
    dt_only = [x.clone().requires_grad_(k == 0) for k, x in enumerate(cast)]
    grads = SsmScanFn.backward(_Ctx(dt_only, nv), dy_t, None)
    assert grads[0] is not None and all(g is None for g in grads[1:])


class _Ctx:
    """What ``SsmScanFn.backward`` reads of its context, from a forward run
    by hand on ``inputs``."""

    def __init__(self, inputs, n_valid):
        self.needs_input_grad = tuple(t.requires_grad for t in inputs) + (False,)
        states = sops.ssm_scan_train_cuda(*(t.detach() for t in inputs), n_valid)[2]
        self.saved_tensors = (*(t.detach() for t in inputs[:5]), n_valid, states)


def test_chunk_is_the_kernels():
    """``CHUNK``, by which the wrappers size the chunk states, is the
    ``kChunk`` that both kernels are built with (``ssm_scan.cuh``): the C
    interfaces take no chunk, so nothing else ties the two."""
    import re
    from pathlib import Path

    from repro_torch.kernels.ssm_scan.kernel import BWD_SOURCE, SOURCE

    header = (Path(SOURCE).parent / "ssm_scan.cuh").read_text()
    assert re.findall(r"constexpr int kChunk = (\d+);", header) == [str(CHUNK)]
    for src in (SOURCE, BWD_SOURCE):
        text = Path(src).read_text()
        assert '#include "ssm_scan.cuh"' in text and "kChunk" in text, src
        assert not re.search(r"constexpr int kChunk", text), src

"""Port parity: the MoE FFN (``repro_torch.models.moe``) against the JAX package's.

Same numpy inputs through both packages, float32:

* ``route_topk``: expert ids, gates, aux and z losses. Expert ids must be
  equal, except at a near-tie: an id may differ only where JAX's
  probabilities of the two experts swapped are within ``TIE_TOL`` (the
  two frameworks sum the router product in different orders). At an exact
  tie both pick the lower expert id (checked on integer-valued inputs,
  where the logits are exact in float32).
* ``expert_capacity`` over a table of token counts and configs.
* ``build_dispatch``: ``slot``, ``keep`` and ``rank`` exactly, with forced
  drops (a small capacity) and masked tokens (expert id ``E``), also at a
  training micro-batch's size (8,192 tokens, top-8 of 64 experts; a
  capacity of 720 that ~70% unmasked assignments overflow) and under a skewed routing (most assignments to one
  expert, far past its capacity; masked ids in single k columns).
* ``moe_ffn_oracle``: output and router losses, with and without
  ``token_mask``, silu and gelu, a forced-drop capacity, and one shared
  expert (``dataclasses.replace`` on both configs). The port's expert FFN
  is the moe_jam kernel's plain version (f32 accumulation, ``h`` rounded
  to ``x.dtype`` once); the JAX model's ``expert_ffn`` rounds ``g``, ``u``
  and ``h`` to ``x.dtype``. At float32 neither rounds, so the two agree to
  summation order: atol ``F32_ATOL``. bfloat16 is compared end to end in
  ``tests/test_torch_engine.py`` with its margin.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.models import moe as tmoe
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

TIE_TOL = 1e-6
F32_ATOL = 2e-5          # outputs ~0.3 rms; f32 sums of 64-96 terms in other orders


def _cfgs(arch="olmoe-1b-7b", smoke=True, **kw):
    j = (j_get_smoke if smoke else j_get_config)(arch).moe
    t = (get_smoke if smoke else get_config)(arch).moe
    return dataclasses.replace(j, **kw), dataclasses.replace(t, **kw)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,d,e,k,seed", [(64, 64, 8, 2, 0), (256, 128, 64, 8, 1),
                                          (33, 48, 16, 4, 2)])
def test_route_topk_matches_jax(n, d, e, k, seed):
    jm, tm = _cfgs(num_experts=e, top_k=k)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)
    jr = jmoe.route_topk(jnp.asarray(x), jnp.asarray(w), jm)
    tr = tmoe.route_topk(_t(x), _t(w), tm)
    assert tr.expert_ids.dtype == torch.int32 and tuple(tr.expert_ids.shape) == (n, k)
    jids, tids = np.asarray(jr.expert_ids), tr.expert_ids.numpy()
    # JAX's probabilities, to place any difference at a near-tie
    logits = np.asarray(jnp.asarray(x) @ jnp.asarray(w))
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    for row, pos in zip(*np.nonzero(jids != tids)):
        p_j, p_t = probs[row, jids[row, pos]], probs[row, tids[row, pos]]
        assert abs(p_j - p_t) <= TIE_TOL, (row, pos, p_j, p_t)
    same = (jids == tids).all(-1)
    assert same.mean() > 0.9
    np.testing.assert_allclose(tr.gates.numpy()[same], np.asarray(jr.gates)[same],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tr.aux_loss), float(jr.aux_loss), rtol=1e-5)
    np.testing.assert_allclose(float(tr.z_loss), float(jr.z_loss), rtol=1e-5)


def test_route_topk_exact_ties_pick_the_lower_expert():
    jm, tm = _cfgs(num_experts=8, top_k=3)
    rng = np.random.default_rng(5)
    x = rng.integers(-2, 3, size=(40, 16)).astype(np.float32)
    w = (rng.integers(-4, 5, size=(16, 8)) / 8).astype(np.float32)
    w[:, 5] = w[:, 2]                  # experts 2 and 5 tie on every token
    w[:, 7] = w[:, 2]
    jr = jmoe.route_topk(jnp.asarray(x), jnp.asarray(w), jm)
    tr = tmoe.route_topk(_t(x), _t(w), tm)
    np.testing.assert_array_equal(tr.expert_ids.numpy(), np.asarray(jr.expert_ids))
    np.testing.assert_allclose(tr.gates.numpy(), np.asarray(jr.gates), atol=1e-6)
    ids = tr.expert_ids.numpy()
    assert any(2 in r and 5 in r for r in ids.tolist())      # the tie was reached


@pytest.mark.parametrize("arch,smoke,kw", [
    ("olmoe-1b-7b", True, {}),
    ("olmoe-1b-7b", False, {}),
    ("olmoe-1b-7b", False, dict(capacity_factor=1.0)),
    ("olmoe-1b-7b", True, dict(capacity_factor=2.0, top_k=3)),
])
def test_expert_capacity_matches_jax(arch, smoke, kw):
    jm, tm = _cfgs(arch, smoke, **kw)
    table = [1, 3, 7, 8, 12, 31, 64, 100, 255, 256, 257, 1000, 4096, 32768]
    got = [tmoe.expert_capacity(n, tm) for n in table]
    assert got == [jmoe.expert_capacity(n, jm) for n in table]
    assert all(c >= 8 and c % 8 == 0 for c in got)
    if not smoke and not kw:
        assert tmoe.expert_capacity(8 * 32, tm) == 40    # the serving engine's buckets


@pytest.mark.parametrize("n,k,e,capacity,seed", [(50, 2, 8, 8, 0), (128, 8, 64, 8, 1),
                                                 (40, 4, 4, 16, 2), (8192, 8, 64, 720, 3),
                                                 (3800, 6, 64, 240, 4)])
def test_build_dispatch_matches_jax(n, k, e, capacity, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, e, size=(n, k)).astype(np.int32)
    ids[rng.random(n) < 0.3] = e       # masked tokens: every k column to id E
    gates = rng.random((n, k)).astype(np.float32)
    js, jk, jr = jmoe.build_dispatch(jnp.asarray(ids), jnp.asarray(gates), e, capacity)
    ts, tk, tr = tmoe.build_dispatch(_t(ids), e, capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert ts.dtype == torch.int32
    assert (~tk.numpy()).any(), "the capacity forced no drop"
    assert (ts.numpy()[ids == e] == e * capacity).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_build_dispatch_skewed_matches_jax(seed):
    """Half the assignments to one expert (far past its capacity), the rest
    uniform, and masked ids in single k columns as well as whole tokens."""
    n, k, e, capacity = 600, 4, 16, 24
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, e, size=(n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.5] = 3
    ids[rng.random((n, k)) < 0.1] = e
    ids[rng.random(n) < 0.1] = e
    gates = rng.random((n, k)).astype(np.float32)
    js, jk, jr = jmoe.build_dispatch(jnp.asarray(ids), jnp.asarray(gates), e, capacity)
    ts, tk, tr = tmoe.build_dispatch(_t(ids), e, capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr.dtype == torch.int32 and int(tr.max()) >= 5 * capacity


def _moe_params(rng, d, m):
    e, f = m.num_experts, m.expert_ff
    p = dict(router=rng.normal(size=(d, e)) / np.sqrt(d),
             w_gate=rng.normal(size=(e, d, f)) / np.sqrt(d),
             w_up=rng.normal(size=(e, d, f)) / np.sqrt(d),
             w_down=rng.normal(size=(e, f, d)) / np.sqrt(f))
    if m.num_shared:
        ff = (m.shared_ff or m.expert_ff) * m.num_shared
        p.update(ws_gate=rng.normal(size=(d, ff)) / np.sqrt(d),
                 ws_up=rng.normal(size=(d, ff)) / np.sqrt(d),
                 ws_down=rng.normal(size=(ff, d)) / np.sqrt(ff))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("masked,shared,capacity", [
    (False, 0, None), (True, 0, None), (True, 0, 8), (False, 1, None), (True, 1, 8)])
def test_moe_ffn_oracle_matches_jax(act, masked, shared, capacity):
    jm, tm = _cfgs(num_shared=shared)
    d = get_smoke("olmoe-1b-7b").d_model
    rng = np.random.default_rng(11 + shared)
    params = _moe_params(rng, d, tm)
    x = rng.normal(size=(4, 12, d)).astype(np.float32)
    mask = rng.random((4, 12)) < 0.6 if masked else None
    jy, jaux = jmoe.moe_ffn_oracle({k: jnp.asarray(v) for k, v in params.items()},
                                   jnp.asarray(x), jm, act, capacity=capacity,
                                   token_mask=None if mask is None else jnp.asarray(mask))
    ty, taux = tmoe.moe_ffn_oracle({k: _t(v) for k, v in params.items()}, _t(x), tm,
                                   act, capacity=capacity,
                                   token_mask=None if mask is None else _t(mask))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    if mask is not None and not shared:
        assert (ty.numpy()[~mask] == 0).all()      # masked tokens get nothing


def test_moe_ffn_refuses_a_transport_and_cuda_on_cpu():
    _, tm = _cfgs()
    d = get_smoke("olmoe-1b-7b").d_model
    params = {k: _t(v) for k, v in _moe_params(np.random.default_rng(0), d, tm).items()}
    x = torch.zeros((1, 4, d))
    with pytest.raises(NotImplementedError, match="A14"):
        tmoe.moe_ffn(params, x, tm, transport=lambda *a, **k: None)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tmoe.moe_ffn(params, x, tm, kernel="cuda")
    y, aux = tmoe.moe_ffn(params, x, tm)
    assert y.shape == x.shape and aux.shape == ()

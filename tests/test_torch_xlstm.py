"""Port parity: ``xlstm-1.3b`` (mLSTM and sLSTM blocks) against the JAX
package, at the smoke (4 layers, d_model 64, mLSTM inner 128 in 4 heads
of 32, an sLSTM every 2nd layer).

* Configs, layer plans (with a remainder and with no sLSTM), the default
  backend (recurrent), the bridge's parameter and cache leaves.
* ``_mlstm_scan`` with and without a carried state and a ``valid`` gate
  (rows of 0, partial and full valid prefixes): outputs on valid columns
  and (C, n, m) within ``ATOL`` in float32; a row's state stays bit for
  bit where its columns are invalid.
* ``_mlstm_chunked`` at the four cases of ``tests/test_xlstm_chunked.py``,
  a prime length (chunk length 1) and twice the chunk, against the JAX
  function at the same chunk length, and against the port's scan; the
  chunk rule itself at the prompt lengths of chip_smoke's slots traffic.
* ``slstm_forward`` and ``mlstm_forward`` (its per-row conv history) with
  and without a cache and ``valid``.
* The contiguous forward (a short prefill on the scan, a 512-token one on
  the chunked form, decode steps, no cache) and the recurrent forward
  from one state, in float32.
* The recurrent Engine against the JAX ``Engine(cache="recurrent")`` on a
  plain Mesh with a forced preemption (schedule, snapshot counts, tokens
  against the JAX float32 forward), and against itself without the
  preemption (identical tokens); the slots Engine against the JAX slots
  Engine (``test_torch_slots.slots_engine_parity``).
* bf16: at 16 layers the port's bf16 logits depart from its float32 ones
  as the JAX package's do from its own (within 2x).
* ``RecurrentState`` over the mixed per-layer dicts: the template's
  values, bytes per slot (also at full width, on the meta device),
  snapshot, a freed slot's reset and restore.

The JAX side runs jitted where it is called more than once. Tolerances
are float32 ``ATOL`` (1e-4), and ``CHUNKED_ATOL`` (2e-4) for the 512-token
chunked prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import default_cache_backend as j_default_cache_backend
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.engine import Engine as JEngine
from repro.engine import Request as JRequest
from repro.models import model as jmodel
from repro.models import xlstm as jx
from repro.models.kvcache import RecurrentLayout as JRecurrentLayout
from repro.models.kvcache import SSMCache
from repro_torch.bridge import params_from_jax, recurrent_cache_from_jax, slot_cache_from_jax
from repro_torch.configs.registry import default_cache_backend, get_config, get_smoke
from repro_torch.engine import Engine, RecurrentState, Request
from repro_torch.models import model as tmodel
from repro_torch.models import xlstm as tx
from repro_torch.models.kvcache import RecurrentLayout
from repro_torch.runtime.steps import make_recurrent_serve_step
from test_torch_engine import (F32_MARGIN_TOL, MARGIN_TOL, REC_GEOM, REC_NEW,
                               _drive_recurrent, _oracle_exceptions, same_tokens_but_at_ties)
from test_torch_engine import _schedule as _engine_schedule
from test_torch_slots import slots_engine_parity, slots_parity_env
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ARCH = "xlstm-1.3b"
ATOL = 1e-4
CHUNKED_ATOL = 2e-4
REC_LENS = (4, 5, 7)


@pytest.fixture(scope="module")
def xl():
    jcfg = j_get_smoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(4))[0]
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(4)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg),
                oracle=jax.jit(lambda p, t: jmodel.forward(jcfg, p, t,
                                                           compute_dtype=jnp.float32)[0]),
                prompts=[rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
                         for n in REC_LENS])


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, msg="", atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0, err_msg=msg)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_config_plan_backend_and_bridge(xl):
    jcfg, cfg = xl["jcfg"], xl["cfg"]
    assert get_config(ARCH).to_json() == j_get_config(ARCH).to_json()
    assert cfg.to_json() == jcfg.to_json()
    full = [(("mlstm",) * 7 + ("slstm",), 6)]
    assert tmodel.layer_plan(get_config(ARCH)) == jmodel.layer_plan(j_get_config(ARCH)) == full
    assert tmodel.layer_plan(cfg) == jmodel.layer_plan(jcfg) == [(("mlstm", "slstm"), 2)]
    for layers, every in ((5, 2), (3, 8), (3, 0)):
        t = dataclasses.replace(cfg, num_layers=layers,
                                xlstm=dataclasses.replace(cfg.xlstm, slstm_every=every))
        j = dataclasses.replace(jcfg, num_layers=layers,
                                xlstm=dataclasses.replace(jcfg.xlstm, slstm_every=every))
        assert tmodel.layer_plan(t) == jmodel.layer_plan(j)
    assert default_cache_backend(cfg) == j_default_cache_backend(jcfg) == "recurrent"
    assert tx.slstm_ff_half(2048, cfg.xlstm) == jx.slstm_ff_half(2048, jcfg.xlstm) == 2752
    # parameters, bit for bit in bf16; fresh ones draw the same shapes
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), xl["jparams"])
    p = params_from_jax(bf, cfg)
    assert set(p) == {"embed", "head", "final_norm", "layers"}
    fresh = tmodel.init_params(cfg, device="cpu")
    for i, (layer, bt) in enumerate(zip(p["layers"], tmodel.flat_block_types(cfg))):
        want = dict(_leaves(bf["groups"][0][i % 2]))
        assert set(layer) == {"ln1", bt} and set(dict(_leaves(layer))) == set(want)
        for key, leaf in _leaves(layer):
            np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                          want[key][i // 2].view(np.int16), err_msg=str(key))
        assert ({k: tuple(v.shape) for k, v in _leaves(fresh["layers"][i])}
                == {k: v.shape[1:] for k, v in want.items()})
    # the caches: the JAX init cache through the bridge equals the port's
    jc = jax.tree.map(np.asarray, jmodel.init_cache(jcfg, 3, 16))
    got = recurrent_cache_from_jax(jc, cfg)
    want = tmodel.init_recurrent_cache(cfg, 3, device="cpu")
    for g, w, bt in zip(got["layers"], want["layers"], tmodel.flat_block_types(cfg)):
        assert set(g) == set(w) == ({"conv", "state", "n", "m"} if bt == "mlstm"
                                    else {"state", "c", "n", "m"})
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
            assert torch.equal(g[key], w[key]), key
    assert slot_cache_from_jax(jc, cfg)["length"] == 0


def _mlstm_inputs(rng, B, S, H, dh):
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)
    return (f(B, S, H, dh), f(B, S, H, dh), f(B, S, H, dh),
            rng.standard_normal((B, S, H)).astype(np.float32),
            (rng.standard_normal((B, S, H)) + 1.0).astype(np.float32))


def _state(rng, B, H, dh):
    m = rng.standard_normal((B, H)).astype(np.float32)
    m[0, 0] = -np.inf                          # a row at its initial stabiliser
    return ((rng.standard_normal((B, H, dh, dh)) * 0.3).astype(np.float32),
            (rng.standard_normal((B, H, dh)) * 0.3).astype(np.float32), m)


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_scan_matches_jax(with_state, with_valid):
    B, S, H, dh = 3, 7, 2, 8
    rng = np.random.default_rng(20 + 2 * with_state + with_valid)
    ins = _mlstm_inputs(rng, B, S, H, dh)
    state = _state(rng, B, H, dh) if with_state else None
    n_valid = np.array([0, 4, S])
    valid = np.arange(S)[None, :] < n_valid[:, None] if with_valid else None
    jy, jst = jax.jit(jx._mlstm_scan)(*map(jnp.asarray, ins),
                                      None if state is None else tuple(map(jnp.asarray, state)),
                                      None if valid is None else jnp.asarray(valid))
    tst0 = None if state is None else tuple(torch.from_numpy(a) for a in state)
    ty, tst = tx._mlstm_scan(*map(torch.from_numpy, ins), tst0,
                             None if valid is None else torch.from_numpy(valid))
    cols = valid if valid is not None else np.ones((B, S), bool)
    _close(ty.numpy()[cols], np.asarray(jy)[cols])
    for name, g, w in zip("Cnm", tst, jst):
        _close(g, w, name)
    if with_valid:
        # the idle row keeps its state bit for bit; the partial row ends
        # where its valid prefix alone takes it
        c0, n0, m0 = tst0 if tst0 is not None else tx._zero_state(B, H, dh, "cpu")
        for g, w in zip(tst, (c0, n0, m0)):
            assert torch.equal(g[0], w[0])
        pre = tuple(torch.from_numpy(a[1:2, :4]) for a in ins)
        _, alone = tx._mlstm_scan(*pre, None if tst0 is None else tuple(t[1:2] for t in tst0))
        for g, w in zip(tst, alone):
            assert torch.equal(g[1:2], w)


@pytest.mark.parametrize("b,s,h,dh,chunk", [
    (2, 64, 2, 16, 16),
    (1, 128, 4, 32, 32),
    (2, 96, 1, 8, 24),
    (1, 64, 2, 16, 64),           # a single chunk
    (1, 67, 2, 16, 16),           # prime: chunks of 1
    (1, 64, 2, 16, 32),           # twice the chunk
])
def test_mlstm_chunked_matches_jax(b, s, h, dh, chunk):
    rng = np.random.default_rng(s + chunk)
    ins = _mlstm_inputs(rng, b, s, h, dh)
    state = _state(rng, b, h, dh)
    fn = jax.jit(jx._mlstm_chunked, static_argnames="chunk")
    for st in (None, state):
        jy, jst = fn(*map(jnp.asarray, ins), None if st is None else tuple(map(jnp.asarray, st)),
                     chunk=chunk)
        tst0 = None if st is None else tuple(torch.from_numpy(a) for a in st)
        ty, tst = tx._mlstm_chunked(*map(torch.from_numpy, ins), tst0, chunk=chunk)
        _close(ty, jy)
        for name, g, w in zip("Cnm", tst, jst):
            _close(g, w, name)
        # the chunked form against the port's own scan (the JAX test's rule)
        sy, sst = tx._mlstm_scan(*map(torch.from_numpy, ins), tst0)
        np.testing.assert_allclose(ty.numpy(), sy.numpy(), atol=2e-4, rtol=2e-4)
        for g, w in zip(tst, sst):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=2e-4)


def test_mlstm_chunk_rule_is_the_jax_one():
    """The largest divisor of S at most ``chunk``: at chip_smoke's slots
    prompt lengths (numpy seed 0) it degenerates to 1, 2, 5, 6 and 10."""
    lengths = {3800: 200, 2630: 10, 3385: 5, 2568: 214, 563: 1, 2382: 6, 568: 142,
               3086: 2, 3916: 178, 3936: 246, 512: 256, 67: 67}
    for S, ck in lengths.items():
        assert tx.mlstm_chunk_len(S, 256) == ck, S


def _layer(xl, bt):
    """One smoke layer's block params (float32) in both packages."""
    i = tmodel.flat_block_types(xl["cfg"]).index(bt)
    jp = jax.tree.map(lambda t: t[0], xl["jparams"]["groups"][0][i])[bt]
    return jp, xl["tparams"]["layers"][i][bt]


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("with_cache", [False, True])
def test_slstm_forward_matches_jax(xl, with_cache, with_valid):
    jcfg, cfg = xl["jcfg"], xl["cfg"]
    jp, tp = _layer(xl, "slstm")
    B, S, d, H = 3, 6, cfg.d_model, cfg.xlstm.num_heads
    rng = np.random.default_rng(30 + 2 * with_cache + with_valid)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    valid = (np.arange(S)[None, :] < np.array([0, 3, S])[:, None]) if with_valid else None
    jcache = tcache = None
    if with_cache:
        h0, c0, m0 = (rng.standard_normal(s).astype(np.float32) * 0.5
                      for s in ((B, d), (B, d), (B, H)))
        n0 = np.abs(rng.standard_normal((B, d))).astype(np.float32) + 0.5
        jcache = SSMCache(jnp.zeros((B, 0, 0)), jnp.asarray(h0),
                          tuple(map(jnp.asarray, (c0, n0, m0))), jnp.zeros((), jnp.int32))
        tcache = {k: torch.from_numpy(a) for k, a in zip(("state", "c", "n", "m"),
                                                         (h0, c0, n0, m0))}
    jy, jc = jx.slstm_forward(jp, jnp.asarray(x), jcfg.xlstm, cache=jcache,
                              valid=None if valid is None else jnp.asarray(valid))
    ty, tc = tx.slstm_forward(tp, torch.from_numpy(x), cfg.xlstm, cache=tcache,
                              valid=None if valid is None else torch.from_numpy(valid))
    cols = valid if valid is not None else np.ones((B, S), bool)
    _close(ty.numpy()[cols], np.asarray(jy)[cols])
    assert (tc is None) == (jc is None)
    if with_cache:
        for key, want in zip(("state", "c", "n", "m"), (jc.state, *jc.extra)):
            _close(tc[key], want, key)


@pytest.mark.parametrize("with_valid", [False, True])
def test_mlstm_forward_conv_history_matches_jax(xl, with_valid):
    """From a carried cache: each row's new conv history is the last W-1 of
    (history ++ its valid tokens), and its state advances over those
    alone."""
    jcfg, cfg = xl["jcfg"], xl["cfg"]
    jp, tp = _layer(xl, "mlstm")
    inner, H, dh = tx.mlstm_dims(cfg.d_model, cfg.xlstm)
    B, S, W = 3, 6, cfg.xlstm.conv_width
    rng = np.random.default_rng(40 + with_valid)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, W - 1, inner)).astype(np.float32)
    c0, n0, m0 = _state(rng, B, H, dh)
    valid = (np.arange(S)[None, :] < np.array([0, 2, S])[:, None]) if with_valid else None
    jc = SSMCache(jnp.asarray(conv), jnp.asarray(c0), (jnp.asarray(n0), jnp.asarray(m0)),
                  jnp.zeros((), jnp.int32))
    jy, jnc = jx.mlstm_forward(jp, jnp.asarray(x), jcfg.xlstm, cache=jc,
                               valid=None if valid is None else jnp.asarray(valid))
    tc = {k: torch.from_numpy(a) for k, a in zip(("conv", "state", "n", "m"),
                                                 (conv, c0, n0, m0))}
    ty, tnc = tx.mlstm_forward(tp, torch.from_numpy(x), cfg.xlstm, cache=tc,
                               valid=None if valid is None else torch.from_numpy(valid))
    cols = valid if valid is not None else np.ones((B, S), bool)
    _close(ty.numpy()[cols], np.asarray(jy)[cols])
    for key, want in zip(("conv", "state", "n", "m"), (jnc.conv, jnc.state, *jnc.extra)):
        _close(tnc[key], want, key)
    if with_valid:
        assert torch.equal(tnc["conv"][0], tc["conv"][0])


def _compare_caches(got, want, msg, atol=ATOL):
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        assert set(g) == set(w)
        for key in w:
            _close(g[key], w[key], f"{msg} layer {i} {key}", atol)


def test_contiguous_forward_and_decode_match_jax(xl):
    """A 13-token prefill of two rows (the scan), two decode steps, a
    512-token prefill of one row (the chunked form: valid is None and S >=
    2 x chunk), and the forward with no cache."""
    jcfg, cfg, jp, tp = xl["jcfg"], xl["cfg"], xl["jparams"], xl["tparams"]
    f32 = dict(compute_dtype=jnp.float32)
    jprefill = jax.jit(lambda p, t, c: jmodel.forward(jcfg, p, t, cache=c, **f32)[:2])
    jdecode = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t, **f32))
    rng = np.random.default_rng(7)
    # the chunked form sums in another order than the JAX one (y reaches
    # ~80 where den is small): its prefill is held to CHUNKED_ATOL, the JAX
    # package's own bound for its chunked form against its scan
    for B, S, atol in ((2, 13, ATOL), (1, 2 * cfg.xlstm.chunk, CHUNKED_ATOL)):
        tok = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        jl, jc = jprefill(jp, jnp.asarray(tok), jmodel.init_cache(jcfg, B, S + 2,
                                                                  dtype=jnp.float32))
        tc = tmodel.init_cache(cfg, B, S + 2, dtype=torch.float32, device="cpu")
        tl, tc, aux = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tc,
                                     paged_kernel="ref", compute_dtype=torch.float32)
        assert aux == 0.0 and tc["length"] == S
        _close(tl, jl, f"prefill {S}", atol)
        _compare_caches(tc, slot_cache_from_jax(jax.tree.map(np.asarray, jc), cfg),
                        f"prefill {S}", atol)
    for step in range(2):
        t1 = rng.integers(0, cfg.vocab_size, size=(1, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(t1))
        tl, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(t1), kernel="ref",
                                    compute_dtype=torch.float32)
        _close(tl, jl, f"decode {step}")
    _compare_caches(tc, slot_cache_from_jax(jax.tree.map(np.asarray, jc), cfg), "decode")
    jl = xl["oracle"](jp, jnp.asarray(tok))         # the module's float32 forward, no cache
    tl, none, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert none is None
    _close(tl, jl, "no cache (the 512 tokens, chunked)", CHUNKED_ATOL)


# (n_valid, starts) per step; slots 3, chunk 4, as test_torch_model's mamba
_RECURRENT = [([4, 4, 0], [0, 0, 0]), ([2, 1, 4], [4, 4, 0]), ([1, 4, 1], [6, 5, 4])]


def test_recurrent_forward_matches_jax_from_the_same_state(xl):
    jcfg, cfg, jp, tp = xl["jcfg"], xl["cfg"], xl["jparams"], xl["tparams"]
    rng = np.random.default_rng(5)
    jcache = jmodel.init_cache(jcfg, 3, 16, dtype=jnp.float32)
    step_fn = jax.jit(lambda p, t, c, st, nv: jmodel.forward(
        jcfg, p, t, cache=c, compute_dtype=jnp.float32,
        recurrent=JRecurrentLayout(st, nv))[:2])
    for step, (nv, st) in enumerate(_RECURRENT):
        tok = rng.integers(0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
        nv, st = np.asarray(nv, np.int32), np.asarray(st, np.int32)
        tcache = recurrent_cache_from_jax(jax.tree.map(np.asarray, jcache), cfg)
        jl, jcache = step_fn(jp, jnp.asarray(tok), jcache, jnp.asarray(st), jnp.asarray(nv))
        tl, tcache, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tcache,
                                       recurrent=RecurrentLayout(torch.from_numpy(st),
                                                                 torch.from_numpy(nv)),
                                       paged_kernel="ref", compute_dtype=torch.float32)
        valid = np.arange(4)[None, :] < nv[:, None]
        _close(tl.numpy()[valid], np.asarray(jl)[valid], f"step {step}")
        _compare_caches(tcache, recurrent_cache_from_jax(jax.tree.map(np.asarray, jcache),
                                                         cfg), f"step {step}")


def test_bf16_departs_from_float32_as_the_jax_package_does(xl):
    """A 16-layer stack of the smoke's width (14 mLSTM, 2 sLSTM), a recurrent
    step of 16 columns from a state built in bf16 over 48 tokens: the
    port's bf16 logits depart from its float32 ones by as much as the JAX
    package's bf16 logits depart from its own float32 ones (within 2x of
    the mean row error). A deep stack at random weights amplifies bf16
    rounding; both packages do, about equally."""
    jcfg = dataclasses.replace(xl["jcfg"], num_layers=16, xlstm=dataclasses.replace(
        xl["jcfg"].xlstm, slstm_every=8))
    cfg = dataclasses.replace(xl["cfg"], num_layers=16, xlstm=dataclasses.replace(
        xl["cfg"].xlstm, slstm_every=8))
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16),
                      jmodel.init_params(jcfg, jax.random.PRNGKey(6))[0])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    step = jax.jit(lambda p, t, c, st, nv, dt: jmodel.forward(
        jcfg, p, t, cache=c, compute_dtype=dt, recurrent=JRecurrentLayout(st, nv))[:2],
        static_argnums=(5,))
    rng = np.random.default_rng(6)
    B, C = 2, 16
    nv = np.full((B,), C, np.int32)
    jcache = jmodel.init_cache(jcfg, B, 16)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
        _, jcache = step(jp, jnp.asarray(tok), jcache, jnp.full((B,), i * C, jnp.int32),
                         jnp.asarray(nv), jnp.bfloat16)
    tok = rng.integers(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
    st = np.full((B,), 3 * C, np.int32)
    tcache = recurrent_cache_from_jax(jax.tree.map(np.asarray, jcache), cfg)
    out = {}
    for name, jd, td in (("16", jnp.bfloat16, torch.bfloat16), ("32", jnp.float32,
                                                                 torch.float32)):
        jc = jax.tree.map(lambda a: a.astype(jd) if a.dtype == jnp.bfloat16 else a, jcache)
        out["j" + name] = np.asarray(step(jp, jnp.asarray(tok), jc, jnp.asarray(st),
                                          jnp.asarray(nv), jd)[0]).astype(np.float32)
        tc = {"layers": [{k: t.to(td) if k == "conv" else t.clone() for k, t in layer.items()}
                         for layer in tcache["layers"]]}
        out["t" + name] = tmodel.forward(
            cfg, tp, torch.from_numpy(tok), cache=tc, compute_dtype=td, paged_kernel="ref",
            recurrent=RecurrentLayout(torch.from_numpy(st), torch.from_numpy(nv)))[0].float().numpy()
    err = {k: float(np.abs(out[k + "16"] - out[k + "32"]).max(-1).mean()) for k in "tj"}
    print(f"[xlstm 16 layers] mean row error bf16 - float32: port {err['t']:.4f}, JAX "
          f"{err['j']:.4f}; float32 port - JAX "
          f"{float(np.abs(out['t32'] - out['j32']).max()):.2e}")
    assert err["t"] <= 2 * err["j"]


def first_layers_departure(l16, l32):
    """bf16 logits' departure from float32 ones: the mean over rows of the
    row's largest |difference|, over the float32 logits' rms."""
    return float(np.abs(l16 - l32).max(-1).mean() / np.sqrt(np.mean(l32 ** 2)))


@pytest.mark.parametrize("layers,path", [(1, "recurrent"), (2, "recurrent"), (1, "chunked")])
def test_bf16_departs_from_float32_as_the_jax_package_does_at_full_width(layers, path):
    """The full mLSTM width and vocabulary (d 2048, inner 4096, 4 heads of
    1,024: a 16.8 MB matrix memory a row; 50,304 logits), the stack cut to
    its first layer (an mLSTM block) or two (mLSTM, sLSTM): a recurrent
    step of 16 columns from a state built in bf16 over 32 tokens, or a
    512-token prefill with no cache (the chunk-parallel form, chunks of
    256). The port's bf16 logits depart from its float32 ones by as much as
    the JAX package's do (within 2x of the mean row error). chip_smoke.py
    holds the first layer's departure on the card to twice the JAX
    package's own here (``XL_FIRST_LAYER_TOL``)."""
    def cut(c):
        return dataclasses.replace(c, num_layers=layers,
                                   xlstm=dataclasses.replace(c.xlstm, slstm_every=2))

    jcfg, cfg = cut(j_get_config(ARCH)), cut(get_config(ARCH))
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16),
                      jmodel.init_params(jcfg, jax.random.PRNGKey(7))[0])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    rng = np.random.default_rng(7)
    out = {}
    if path == "chunked":
        assert tx.mlstm_chunk_len(512, cfg.xlstm.chunk) == 256
        tok = rng.integers(0, cfg.vocab_size, size=(1, 512)).astype(np.int32)
        fwd = jax.jit(lambda p, t, dt: jmodel.forward(jcfg, p, t, compute_dtype=dt)[0],
                      static_argnums=(2,))
        for name, jd, td in (("16", jnp.bfloat16, torch.bfloat16), ("32", jnp.float32,
                                                                     torch.float32)):
            out["j" + name] = np.asarray(fwd(jp, jnp.asarray(tok), jd)).astype(np.float32)
            out["t" + name] = tmodel.forward(cfg, tp, torch.from_numpy(tok), compute_dtype=td,
                                             paged_kernel="ref")[0].float().numpy()
    else:
        step = jax.jit(lambda p, t, c, st, nv, dt: jmodel.forward(
            jcfg, p, t, cache=c, compute_dtype=dt, recurrent=JRecurrentLayout(st, nv))[:2],
            static_argnums=(5,))
        B, C = 2, 16
        nv = np.full((B,), C, np.int32)
        jcache = jmodel.init_cache(jcfg, B, 16)
        for i in range(2):
            tok = rng.integers(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
            _, jcache = step(jp, jnp.asarray(tok), jcache, jnp.full((B,), i * C, jnp.int32),
                             jnp.asarray(nv), jnp.bfloat16)
        tok = rng.integers(0, cfg.vocab_size, size=(B, C)).astype(np.int32)
        st = np.full((B,), 2 * C, np.int32)
        tcache = recurrent_cache_from_jax(jax.tree.map(np.asarray, jcache), cfg)
        for name, jd, td in (("16", jnp.bfloat16, torch.bfloat16), ("32", jnp.float32,
                                                                     torch.float32)):
            jc = jax.tree.map(lambda a: a.astype(jd) if a.dtype == jnp.bfloat16 else a, jcache)
            out["j" + name] = np.asarray(step(jp, jnp.asarray(tok), jc, jnp.asarray(st),
                                              jnp.asarray(nv), jd)[0]).astype(np.float32)
            tc = {"layers": [{k: t.to(td) if k == "conv" else t.clone()
                              for k, t in layer.items()} for layer in tcache["layers"]]}
            out["t" + name] = tmodel.forward(
                cfg, tp, torch.from_numpy(tok), cache=tc, compute_dtype=td, paged_kernel="ref",
                recurrent=RecurrentLayout(torch.from_numpy(st),
                                          torch.from_numpy(nv)))[0].float().numpy()
    err = {k: float(np.abs(out[k + "16"] - out[k + "32"]).max(-1).mean()) for k in "tj"}
    rel = {k: first_layers_departure(out[k + "16"], out[k + "32"]) for k in "tj"}
    print(f"[xlstm full width, {layers} layer(s), {path}] mean row error bf16 - float32: port "
          f"{err['t']:.4f}, JAX {err['j']:.4f} (over the float32 rms: port {rel['t']:.4f}, "
          f"JAX {rel['j']:.4f}); float32 port - JAX "
          f"{float(np.abs(out['t32'] - out['j32']).max()):.2e}")
    _close(out["t32"], out["j32"], "float32 logits at full width", CHUNKED_ATOL)
    assert err["t"] <= 2 * err["j"]


def _recurrent_engine(xl, dtype, **geom):
    e = Engine(xl["cfg"], device="cpu", cache="auto", **geom)
    e.load_params(xl["tparams"])
    if dtype != torch.bfloat16:
        e.bundle = make_recurrent_serve_step(xl["cfg"], slots=e.slots, chunk=e.chunk,
                                             kernel="ref", device="cpu", compute_dtype=dtype)
        make = lambda n: tmodel.init_recurrent_cache(xl["cfg"], n, dtype=dtype, device="cpu")
        e.state = RecurrentState(e.slots, lambda: make(1))
        e.cache = make(e.slots)
    return e


def test_recurrent_engine_matches_jax_and_resumes_exactly(xl):
    """``cache="auto"`` resolves to recurrent. With a forced mid-decode
    preemption: the schedule and snapshot counts of the JAX engine; tokens
    the JAX float32 forward's argmax (exactly in float32 but under
    ``F32_MARGIN_TOL``, within ``MARGIN_TOL`` in bf16; at most one in ten
    under the margin); the same tokens as a run without the preemption."""
    from jax.sharding import Mesh

    from repro.configs.base import SHAPES, RunConfig, ShardingConfig

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    run = RunConfig(model=xl["jcfg"], shape=SHAPES["decode_32k"],
                    sharding=ShardingConfig(fsdp_params=False, seq_axis=None))
    with mesh:
        je = JEngine(xl["jcfg"], run, mesh, cache="recurrent", **REC_GEOM)
        je.load_params(xl["jparams"])
        j_victim = _drive_recurrent(je, JRequest, xl["prompts"])
    jm = je.state.metrics()
    snaps = ("snapshots_taken", "snapshots_restored")
    want = dict(_engine_schedule(je), **{k: jm[k] for k in snaps})
    for dtype, margin in ((torch.float32, F32_MARGIN_TOL), (torch.bfloat16, MARGIN_TOL)):
        e = _recurrent_engine(xl, dtype, **REC_GEOM)
        assert e.cache_kind == "recurrent" and e.kernel == "ref"
        assert _drive_recurrent(e, Request, xl["prompts"]) == j_victim
        m = e.metrics()
        assert dict(_engine_schedule(e), **{k: m[k] for k in snaps}) == want
        assert m["preemptions"] == 1 and m["snapshots_restored"] == 1
        if dtype == torch.bfloat16:
            assert m["state_bytes_per_slot"] == jm["state_bytes_per_slot"]
        assert m["kernel_launches"] == {} and m["nonfinite_logits"] == 0
        assert all(len(r.out_tokens) == REC_NEW for r in e.completed)
        gaps = {}
        faults, exceptions, total = _oracle_exceptions(xl, xl["prompts"], e, margin, gaps)
        same = same_tokens_but_at_ties({r.rid: r.out_tokens for r in e.completed},
                                       {r.rid: r.out_tokens for r in je.completed}, gaps)
        print(f"[xlstm {dtype}] {exceptions}/{total} tokens differ from the float32 argmax "
              f"inside the margin {margin}; {same}/{total} equal to the JAX engine's")
        assert not faults, faults
        assert exceptions <= total // 10
        again = _recurrent_engine(xl, dtype, **REC_GEOM)
        for rid, p in enumerate(xl["prompts"]):
            again.submit(Request(rid, p, max_new_tokens=REC_NEW))
        again.run_until_drained()
        assert again.preempt_count == 0
        assert ({r.rid: r.out_tokens for r in again.completed}
                == {r.rid: r.out_tokens for r in e.completed})


def test_slots_engine_matches_jax(xl, monkeypatch):
    """The arch on ``cache="slots"``: a 2-slot engine of 32 rows, prompts
    of 4, 7 and 5 tokens, 4 new each."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, xl["cfg"].vocab_size, size=(n,)).astype(np.int32)
               for n in (4, 7, 5)]
    env = slots_parity_env(xl["jcfg"], xl["cfg"], xl["jparams"], prompts, slots=2,
                           max_len=32)
    slots_engine_parity(env, 4, monkeypatch)


def test_recurrent_state_over_mixed_layers(xl):
    """The template holds each layer type's initial values; the bytes per
    slot count every leaf (0.71 GB at full width: 42 mLSTM layers of a
    4 x 1024 x 1024 float32 C); a snapshot restores bit for bit into
    another slot after that slot was reset for a fresh request."""
    cfg = xl["cfg"]
    st = RecurrentState(2, lambda: tmodel.init_recurrent_cache(cfg, 1, device="cpu"))
    for layer, bt in zip(st.template["layers"], tmodel.flat_block_types(cfg)):
        assert torch.isneginf(layer["m"]).all() if bt == "mlstm" else (layer["m"] == 0).all()
        assert (layer["n"] == (0 if bt == "mlstm" else 1)).all()
        assert all((layer[k] == 0).all() for k in layer if k not in ("m", "n"))
    inner, H, dh = tx.mlstm_dims(cfg.d_model, cfg.xlstm)
    mlstm = 3 * inner * 2 + 4 * (H * dh * dh + H * dh + H)
    slstm = 4 * (3 * cfg.d_model + H)
    assert st.state_bytes_per_slot() == 2 * (mlstm + slstm) == 36928
    full = get_config(ARCH)
    meta = RecurrentState(1, lambda: tmodel.init_recurrent_cache(full, 1, device="meta"))
    assert meta.state_bytes_per_slot() == 42 * (3 * 4096 * 2 + 4 * (4 * 1024 * 1024 + 4 * 1024
                                                                      + 4)) + 6 * 4 * (
        3 * 2048 + 4) == 706_511_616
    # snapshot slot 0, reset slot 1 for a fresh request, restore into it
    cache = tmodel.init_recurrent_cache(cfg, 2, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))

    class Entry:
        snapshot = None
    victim = Entry()
    st.evict(victim, cache, 0)
    want = [{k: t[0].clone() for k, t in layer.items()} for layer in cache["layers"]]
    st.init(Entry(), cache, 1)
    for layer, tmpl in zip(cache["layers"], st.template["layers"]):
        for k in layer:
            assert torch.equal(layer[k][1], tmpl[k][0]), k
    for layer in cache["layers"]:
        for t in layer.values():
            t[0].zero_()
    st.init(victim, cache, 1)
    assert victim.snapshot is None
    for layer, w in zip(cache["layers"], want):
        for k in layer:
            assert torch.equal(layer[k][1], w[k]), k
    assert (st.snapshots_taken, st.snapshots_restored) == (1, 1)


def test_serve_cli_xlstm_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                                     "--requests", "3", "--max-new", "4", "--metrics-json"])
    serve.main()
    out = capsys.readouterr().out
    assert "3/3 requests, 12 tokens" in out and '"cache": "recurrent"' in out

"""The port's training half (A13, dense GQA) against the JAX package, on the CPU.

Same numpy inputs through both packages: the optimizer, schedule and
gradient transforms on seeded arrays; ``synthetic_batch`` bit for bit for
every smoke arch; ``loss_fn`` and every leaf's gradient in float32 (the JAX
``forward`` is patched to float32 for the module, as in
``test_torch_graph.py``), also through the flash branch (the chunking
threshold lowered in both packages by monkeypatch) and with
``remat="full"``; two ``make_train_step`` steps at ``accum_steps`` 1 and 2
(the JAX step jitted once per accum, on a plain ``Mesh``); and the port's
data pipeline, checkpoint manager, trainer and launcher against the
properties the JAX tests (``test_data``, ``test_checkpoint``,
``test_trainer_fault``, ``test_steps_accum``) hold the JAX package to.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import ShardingConfig
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.data.synthetic import synthetic_batch as j_synthetic_batch
from repro.kernels.flash_attention.ref import mha_ref as j_mha_ref
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import grad as jgrad
from repro.optim import schedule as jschedule
from repro.runtime.steps import make_train_step as j_make_train_step
from repro_torch import bridge, tree
from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs.base import SHAPES, OptimizerConfig, RunConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.data import DataPipeline, batch_shapes, synthetic_batch
from repro_torch.kernels.flash_attention import mha_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               compress_int8, decompress_int8, global_norm,
                               init_error_feedback, warmup_cosine)
from repro_torch.runtime.fault import FaultInjector, InjectedFault
from repro_torch.runtime.steps import make_step, make_train_step, train_refusal
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

SEQ, BATCH = 16, 2
# float32 in both packages; sums in other orders
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4            # relative to the leaf's max |g|
OPT_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_float32():
    """The JAX forward in float32, as the port's tests run it."""
    forward = jmodel.forward

    def forward_f32(*args, **kw):
        kw.setdefault("compute_dtype", jnp.float32)
        return forward(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "forward", forward_f32)
        yield


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(JAX params, port params) of ``arch``'s smoke, one float32 tree."""
    jcfg = j_get_smoke(arch)
    jp = _np(jax.jit(lambda k: jmodel.init_params(jcfg, k)[0])(jax.random.PRNGKey(0)))
    return jp, bridge.params_from_jax(jp, get_smoke(arch))


def _shape(seq=SEQ, batch=BATCH):
    return JShapeConfig("t", seq, batch, "train"), ShapeConfig("t", seq, batch, "train")


def _batch(arch, step=0, seq=SEQ, batch=BATCH):
    jshape, _ = _shape(seq, batch)
    return j_synthetic_batch(j_get_smoke(arch), jshape, step)


def _tbatch(nb):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in nb.items()}


def _flash(monkeypatch):
    """Send both packages' attention through their flash branch."""
    monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 64)
    monkeypatch.setattr(jattn, "Q_CHUNK", 4)
    monkeypatch.setattr(jattn, "KV_CHUNK", 4)
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 64)


def _close_rel(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    err = np.abs(a - b).max() / scale
    assert err <= tol, f"{what}: max |port - jax| / max |jax| = {err:.3e} > {tol}"


# ---------------------------------------------------------------------------
# optimizer, schedule, gradient transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(1, 10), (100, 1000), (10, 5)])
def test_warmup_cosine_matches_jax(warmup, total):
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    jcfg = JOptimizerConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    for s in (0, 1, 2, 5, 9, 10, 50, 99, 100, 101, 500, 999, 1000, 5000):
        got = float(warmup_cosine(torch.tensor(s, dtype=torch.int32), ocfg))
        want = float(jschedule.warmup_cosine(jnp.int32(s), jcfg))
        assert abs(got - want) <= OPT_TOL * max(1.0, abs(want)), (s, got, want)


def _opt_tree(rng):
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "layers": [{"b": rng.standard_normal((5,)).astype(np.float32),
                        "m3": rng.standard_normal((3, 4, 2)).astype(np.float32)}]}


def _jtree(nt):
    return jax.tree.map(jnp.asarray, nt)


def _ttree(nt):
    return tree.map_(lambda a: torch.from_numpy(a.copy()), nt)


def test_adamw_two_steps_match_jax():
    rng = np.random.default_rng(0)
    p0 = _opt_tree(rng)
    grads = [_opt_tree(rng), _opt_tree(rng)]
    ocfg, jcfg = OptimizerConfig(weight_decay=0.1), JOptimizerConfig(weight_decay=0.1)
    jp, jo = _jtree(p0), jadamw.adamw_init(_jtree(p0))
    tp = _ttree(p0)
    to = adamw_init(tp)
    for g, lr in zip(grads, (1e-2, 3e-3)):
        jp, jo = jadamw.adamw_update(_jtree(g), jo, jp, jnp.float32(lr), jcfg)
        tp, to = adamw_update(_ttree(g), to, tp, torch.tensor(lr, dtype=torch.float32), ocfg)
    assert int(to.step) == int(jo.step) == 2 and to.step.dtype == torch.int32
    for name, t, j in (("params", tp, jp), ("m", to.m, jo.m), ("v", to.v, jo.v)):
        for (path, a), b in zip(tree.flatten_with_paths(t), jax.tree.leaves(j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OPT_TOL, atol=OPT_TOL,
                                       err_msg=f"{name}/{path}")


def test_global_norm_clip_and_int8_match_jax():
    rng = np.random.default_rng(1)
    g = _opt_tree(rng)
    assert abs(float(global_norm(_ttree(g))) - float(jgrad.global_norm(_jtree(g)))) <= OPT_TOL
    for max_norm in (0.5, 1e3):
        tg, tn = clip_by_global_norm(_ttree(g), max_norm)
        jg, jn = jgrad.clip_by_global_norm(_jtree(g), max_norm)
        assert abs(float(tn) - float(jn)) <= OPT_TOL * float(jn)
        for a, b in zip(tree.leaves(tg), jax.tree.leaves(jg)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OPT_TOL, atol=OPT_TOL)
    x = rng.standard_normal((7, 9)).astype(np.float32) * 3
    tq, ts = compress_int8(torch.from_numpy(x))
    jq, js = jgrad.compress_int8(jnp.asarray(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(float(ts) - float(js)) <= OPT_TOL * float(js)
    np.testing.assert_allclose(decompress_int8(tq, ts).numpy(),
                               np.asarray(jgrad.decompress_int8(jq, js)), rtol=OPT_TOL)
    e = init_error_feedback(_ttree(g))
    assert all(float(t.abs().sum()) == 0 and t.dtype == torch.float32 for t in tree.leaves(e))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_synthetic_batch_bit_equal(arch):
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    jshape, shape = _shape(seq=24, batch=3)
    for step, seed in ((0, 0), (17, 3)):
        got = synthetic_batch(cfg, shape, step, seed)
        want = j_synthetic_batch(jcfg, jshape, step, seed)
        assert sorted(got) == sorted(want) == sorted(batch_shapes(cfg, shape))
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{arch} {k}")


def test_pipeline_prefetch_order_and_close():
    cfg = get_smoke("llama3.2-1b")
    shape = ShapeConfig("tiny", 32, 2, "train")
    pipe = DataPipeline(cfg, shape, device="cpu", seed=0, start_step=5, prefetch=2)
    try:
        for step in (5, 6):
            got = next(pipe)
            assert pipe.step == step + 1
            np.testing.assert_array_equal(got["tokens"].numpy(),
                                          synthetic_batch(cfg, shape, step, 0)["tokens"])
    finally:
        pipe.close()
    pipe.close()                                   # idempotent


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _jax_loss(arch, nb):
    jp, _ = _weights(arch)
    jcfg = j_get_smoke(arch)
    return jax.jit(lambda p, b: jmodel.loss_fn(jcfg, p, b))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, nb))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-4b", "olmoe-1b-7b", "hubert-xlarge",
                                  "qwen2-vl-72b"])
def test_loss_fn_matches_jax(arch):
    nb = _batch(arch)
    jloss, jm = _jax_loss(arch, nb)
    _, tp = _weights(arch)
    with torch.no_grad():
        tloss, tm = tmodel.loss_fn(get_smoke(arch), tp, _tbatch(nb), compute_dtype=torch.float32)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL * max(1.0, abs(float(jloss)))
    for k in ("ce", "aux", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL * max(1.0, abs(float(jm[k]))), k
    # decoders predict the next token (S - 1 per row), encoders every frame
    per_row = SEQ if get_smoke(arch).is_encoder else SEQ - 1
    assert float(tm["tokens"]) == BATCH * per_row


def _port_grads(cfg, tp, nb):
    params = tree.map_(lambda t: t.clone().requires_grad_(True), tp)
    loss, _ = tmodel.loss_fn(cfg, params, _tbatch(nb), compute_dtype=torch.float32)
    leaves = tree.leaves(params)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


# the recurrent and hybrid stacks (mamba's SSM scan, xLSTM's mLSTM scan and
# sLSTM) through their plain paths' out-of-place form under grad; "sdpa"
# names the default path, which for mamba and xlstm has no attention (the
# MoE stacks' cases are in test_torch_moe_train.py)
GRAD_CASES = [("llama3.2-1b", "sdpa"), ("llama3.2-1b", "flash"), ("gemma3-4b", "sdpa"),
              ("gemma3-4b", "flash"), ("mamba-130m", "sdpa"), ("hymba-1.5b", "sdpa"),
              ("hymba-1.5b", "flash"), ("xlstm-1.3b", "sdpa")]


@pytest.mark.parametrize("arch,path", GRAD_CASES, ids=[f"{a}-{p}" for a, p in GRAD_CASES])
def test_gradients_match_jax(arch, path, monkeypatch):
    check_gradients(arch, path, monkeypatch)


def check_gradients(arch, path, monkeypatch):
    """Every leaf's gradient of ``loss_fn`` against ``jax.grad`` of the JAX
    one, on ``path`` ("sdpa" or "flash"), within GRAD_TOL."""
    if path == "flash":
        _flash(monkeypatch)
    nb = _batch(arch)
    jp, tp = _weights(arch)
    jcfg = j_get_smoke(arch)
    jg = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(jcfg, p, b)[0]))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, nb))
    want = bridge.params_from_jax(_np(jg), get_smoke(arch))
    calls = []
    inner = tattn.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    got = _port_grads(get_smoke(arch), tp, nb)
    assert bool(calls) == (path == "flash")
    for (p, w), g in zip(tree.flatten_with_paths(want), got):
        _close_rel(g, w.numpy(), GRAD_TOL, f"{arch} {path} d{p}")


@pytest.mark.parametrize("path", ["sdpa", "flash"])
def test_remat_full_equals_none(path, monkeypatch):
    if path == "flash":
        _flash(monkeypatch)
    arch = "gemma3-4b"
    nb = _batch(arch)
    _, tp = _weights(arch)
    cfg = get_smoke(arch)
    assert cfg.remat == "none"
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(tmodel, "checkpoint", counting)
    plain = _port_grads(cfg, tp, nb)
    assert not calls
    remat = _port_grads(dataclasses.replace(cfg, remat="full"), tp, nb)
    assert len(calls) == cfg.num_layers
    for p, a, b in zip(tree.flatten_with_paths(tp), remat, plain):
        _close_rel(a, b, GRAD_TOL, f"remat d{p[0]}")


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 1), (8, 2)])
def test_mha_ref_gradient_matches_jax(hq, hkv, window):
    """The backward kernel's plain version: autograd through ``mha_ref``."""
    rng = np.random.default_rng(hq * 10 + hkv)
    q = rng.standard_normal((2, hq, 13, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, 13, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, 13, 16)).astype(np.float32)
    w = rng.standard_normal((2, hq, 13, 16)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(j_mha_ref(q, k, v, causal=True, window=window) * w)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (mha_ref(tq, tk, tv, causal=True, window=window) * torch.from_numpy(w)).sum().backward()
    for name, a, b in (("dq", tq.grad, jg[0]), ("dk", tk.grad, jg[1]), ("dv", tv.grad, jg[2])):
        _close_rel(a.numpy(), np.asarray(b), GRAD_TOL, name)


def _mlstm_grad_inputs(rng, B, S, H, dh, with_state):
    f = lambda *s: (rng.standard_normal(s) * 0.4).astype(np.float32)
    ins = (f(B, S, H, dh), f(B, S, H, dh), f(B, S, H, dh),
           rng.standard_normal((B, S, H)).astype(np.float32),
           (rng.standard_normal((B, S, H)) + 1.0).astype(np.float32))
    state = None
    if with_state:                             # a finite stabiliser: -inf has no gradient
        state = (f(B, H, dh, dh), f(B, H, dh), rng.standard_normal((B, H)).astype(np.float32))
    # weights of y (B, S, H, dh), C, n and m in the loss
    weights = (f(B, S, H, dh), f(B, H, dh, dh), f(B, H, dh), f(B, H))
    return ins, state, weights


def _mlstm_grads_close(jfn, tfn, ins, state, weights, what):
    """jax.grad of sum(y * w) + the weighted final state through ``jfn``
    against autograd through ``tfn``, for every input and state leaf."""
    def jloss(ins, state):
        y, st = jfn(*ins, state)
        return sum(jnp.sum(a * w) for a, w in zip((y, *st), weights))

    jg = jax.grad(jloss, argnums=(0, 1))(tuple(map(jnp.asarray, ins)),
                                          None if state is None
                                          else tuple(map(jnp.asarray, state)))
    t_ins = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    t_st = None if state is None else [torch.from_numpy(a).requires_grad_(True) for a in state]
    y, st = tfn(*t_ins, None if t_st is None else tuple(t_st))
    loss = sum((a * torch.from_numpy(w)).sum() for a, w in zip((y, *st), weights))
    leaves = t_ins + ([] if t_st is None else t_st)
    got = torch.autograd.grad(loss, leaves)
    want = list(jg[0]) + ([] if state is None else list(jg[1]))
    for name, g, w in zip(["q", "k", "v", "i", "f", "C0", "n0", "m0"], got, want):
        _close_rel(g.numpy(), np.asarray(w), GRAD_TOL, f"{what} d{name}")


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked_gradient_matches_jax(with_state):
    """The chunk-parallel mLSTM, which a 16-token smoke does not reach: two
    chunks of 4 (S = 2 x chunk, the least that takes it)."""
    from repro.models import xlstm as jx
    from repro_torch.models import xlstm as tx
    ins, state, weights = _mlstm_grad_inputs(np.random.default_rng(41 + with_state),
                                             2, 8, 2, 8, with_state)
    _mlstm_grads_close(functools.partial(jx._mlstm_chunked, chunk=4),
                       functools.partial(tx._mlstm_chunked, chunk=4), ins, state, weights,
                       "chunked")


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_scan_gradient_matches_jax(with_state):
    """The column-by-column mLSTM under grad (its out-of-place form), with a
    valid gate that leaves one row idle and stops one part-way."""
    from repro.models import xlstm as jx
    from repro_torch.models import xlstm as tx
    ins, state, weights = _mlstm_grad_inputs(np.random.default_rng(43 + with_state),
                                             3, 6, 2, 8, with_state)
    valid = np.arange(6)[None, :] < np.array([0, 4, 6])[:, None]
    weights = (weights[0] * valid[:, :, None, None],) + weights[1:]    # y is garbage off valid
    _mlstm_grads_close(lambda *a: jx._mlstm_scan(*a, jnp.asarray(valid)),
                       lambda *a: tx._mlstm_scan(*a, torch.from_numpy(valid)),
                       ins, state, weights, "scan")


@pytest.mark.parametrize("gated", [False, True])
def test_ssm_scan_ref_gradient_matches_loop(gated):
    """The prefix scan's out-of-place form under grad against autograd
    through the column loop, with a carried state and (gated) a valid
    prefix per row."""
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_loop, ssm_scan_ref
    rng = np.random.default_rng(7 + gated)
    B, S, I, N = 3, 11, 6, 4
    f = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.5).astype(np.float32))
    dt, x, b, c = f(B, S, I).abs(), f(B, S, I), f(B, S, N), f(B, S, N)
    a, h0 = -f(I, N).abs() - 0.1, f(B, I, N)
    n_valid = torch.tensor([0, 5, S]) if gated else None
    wy, wh = f(B, S, I), f(B, I, N)
    grads = []
    for fn in (ssm_scan_ref, ssm_scan_loop):
        leaves = [t.clone().requires_grad_(True) for t in (dt, b, c, x, a, h0)]
        y, h = fn(*leaves, n_valid=n_valid)
        grads.append(torch.autograd.grad((y * wy).sum() + (h * wh).sum(), leaves))
    for name, g, w in zip(["dt", "b", "c", "x", "a", "h0"], *grads):
        _close_rel(g.numpy(), w.numpy(), GRAD_TOL, f"d{name}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _runs(accum, total=10):
    ocfg = dict(accum_steps=accum, total_steps=total, warmup_steps=1)
    jrun = JRunConfig(model=j_get_smoke("llama3.2-1b"), shape=JShapeConfig("t", 32, 4, "train"),
                      sharding=ShardingConfig(fsdp_params=False),
                      optimizer=JOptimizerConfig(**ocfg))
    run = RunConfig(model=get_smoke("llama3.2-1b"), shape=ShapeConfig("t", 32, 4, "train"),
                    optimizer=OptimizerConfig(**ocfg))
    return jrun, run


@pytest.fixture(scope="module")
def jax_steps(mesh):
    """Two JAX train steps at accum 1 and at 2 from one init: per accum,
    the metrics of each step and the params after the second."""
    jcfg = j_get_smoke("llama3.2-1b")
    jp, _ = _weights("llama3.2-1b")
    out = {}
    for accum in (1, 2):
        jrun, _ = _runs(accum)
        bundle = j_make_train_step(jcfg, jrun, mesh)
        step = jax.jit(bundle.fn)
        with mesh:
            params = jax.tree.map(jnp.asarray, jp)
            opt = jadamw.adamw_init(params)
            metrics = []
            for s in range(2):
                nb = j_synthetic_batch(jcfg, jrun.shape, s)
                params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, nb))
                metrics.append({k: float(v) for k, v in m.items()})
        out[accum] = (metrics, _np(params), _np(opt))
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, jax_steps):
    jmetrics, jparams, jopt = jax_steps[accum]
    _, run = _runs(accum)
    cfg = get_smoke("llama3.2-1b")
    _, tp0 = _weights("llama3.2-1b")
    params = tree.map_(torch.clone, tp0)
    opt = adamw_init(params)
    bundle = make_train_step(cfg, run, device="cpu", compute_dtype=torch.float32)
    assert bundle.meta["kind"] == "train" and bundle.meta["accum"] == accum
    for s in range(2):
        params, opt, m = bundle.fn(params, opt, _tbatch(synthetic_batch(cfg, run.shape, s)))
        for k in ("loss", "ce", "aux", "tokens", "grad_norm", "lr"):
            want = jmetrics[s][k]
            assert abs(float(m[k]) - want) <= LOSS_TOL * max(1.0, abs(want)), (s, k)
    assert float(m["tokens"]) == 4 * 31
    assert not any(t.requires_grad for t in tree.leaves(params))
    want = bridge.params_from_jax(jparams, cfg)
    for (path, a), b in zip(tree.flatten_with_paths(params), tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5, err_msg=path)
    ported = bridge.opt_state_from_jax(jopt, cfg)
    assert int(ported.step) == int(opt.step) == 2
    for a, b in zip(tree.leaves(opt.m), tree.leaves(ported.m)):
        _close_rel(a.numpy(), b.numpy(), GRAD_TOL, "m")


@pytest.mark.parametrize("arch", ["mamba-130m", "hymba-1.5b", "xlstm-1.3b", "olmoe-1b-7b",
                                  "deepseek-v2-lite-16b"])
def test_train_step_runs_recurrent_smokes(arch):
    """Two ``make_train_step`` steps of each recurrent, hybrid or MoE smoke
    on the CPU (the first at the warmup's lr of 0): finite losses and
    gradients, and every leaf moved by the second. The MoE bundles name the
    expert FFN's kernels beside flash attention's."""
    cfg = get_smoke(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                    optimizer=OptimizerConfig(total_steps=10, warmup_steps=1))
    _, tp0 = _weights(arch)
    params = tree.map_(torch.clone, tp0)
    opt = adamw_init(params)
    bundle = make_train_step(cfg, run, device="cpu", compute_dtype=torch.float32)
    assert (("moe_jam", "moe_jam_bwd") == bundle.meta["kernels"][-2:]) == (cfg.moe is not None)
    for s in range(2):
        params, opt, m = bundle.fn(params, opt, _tbatch(synthetic_batch(cfg, run.shape, s)))
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"])), s
        assert float(m["grad_norm"]) > 0, s
    assert float(m["lr"]) > 0
    moved = [not torch.equal(a, b) for a, b in zip(tree.leaves(params), tree.leaves(tp0))]
    assert all(moved), f"{arch}: {moved.count(False)} leaves did not move"


def test_make_step_dispatches():
    cfg = get_smoke("llama3.2-1b")
    for shape, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                        ("decode_32k", "decode")):
        run = RunConfig(model=cfg, shape=SHAPES[shape])
        assert make_step(cfg, run, 2, device="cpu").meta["kind"] == kind


def test_train_refusal_names_the_later_halves():
    assert train_refusal(get_config("llama3.2-1b"), 4096) is None
    assert train_refusal(get_config("stablelm-3b"), 64) is None        # plain _sdpa
    assert train_refusal(get_config("olmoe-1b-7b"), 4096) is None      # moe_jam's backward
    assert "q/k 192, v 128" in train_refusal(get_config("deepseek-v2-lite-16b"), 4096)
    assert "later halves" in train_refusal(get_config("deepseek-v2-lite-16b"), 4096)
    assert train_refusal(get_config("mamba-130m"), 4096) is None       # ssm_scan's backward
    assert train_refusal(get_config("hymba-1.5b"), 4096) is None       # and flash's at D 64
    assert "xLSTM" in train_refusal(get_config("xlstm-1.3b"), 4096)
    assert "later halves" in train_refusal(get_config("gemma3-4b"), 4096)      # 256 wide
    assert "later halves" in train_refusal(get_config("hubert-xlarge"), 4096)  # 80 wide


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ck_tree(step):
    return {"params": {"w": torch.full((4, 4), float(step)), "b": torch.arange(3.0) + step,
                       "h": torch.full((2,), step + 0.5).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(step, dtype=torch.int32)}}


def test_checkpoint_roundtrip_async_retention(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d, keep=2)
    want = _ck_tree(7)
    mgr.save(7, want, blocking=True)
    assert latest_step(d) == 7
    got = restore(d, 7, want)
    for (p, a), b in zip(tree.flatten_with_paths(got), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    mgr.save(8, _ck_tree(8))                       # async
    mgr.wait()
    assert latest_step(d) == 8
    for s in (9, 10):
        mgr.save(s, _ck_tree(s), blocking=True)
    assert sorted(os.listdir(d)) == ["step_10", "step_9"]
    cast = restore(d, 10, {"params": {"w": torch.empty(4, 4, dtype=torch.bfloat16),
                                      "b": torch.empty(3), "h": torch.empty(2)},
                           "opt": {"step": torch.empty((), dtype=torch.int64)}})
    assert cast["params"]["w"].dtype == torch.bfloat16 and cast["opt"]["step"].item() == 10
    assert cast["params"]["h"].dtype == torch.float32
    assert float(cast["params"]["h"][0]) == 10.5


def test_checkpoint_uncommitted_ignored(tmp_path):
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    assert mgr.restore_latest({"x": torch.empty(1)}) == (None, None)
    mgr.save(5, _ck_tree(5), blocking=True)
    os.makedirs(os.path.join(d, "step_9"))         # a crash mid-save: no COMMIT
    np.savez(os.path.join(d, "step_9", "arrays.npz"), x=np.zeros(1))
    assert latest_step(d) == 5
    with pytest.raises(FileNotFoundError):
        restore(d, 9, {"x": torch.empty(1)})


def _gate_savez(monkeypatch, release):
    """Hold every ``np.savez`` until ``release`` is set (at most 30 s), so
    that what happens meanwhile on the calling thread lands while an async
    save is being written."""
    savez = np.savez

    def gated(*args, **kw):
        release.wait(timeout=30)
        return savez(*args, **kw)

    monkeypatch.setattr(np, "savez", gated)


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8).clone()


def test_checkpoint_async_save_is_a_snapshot(tmp_path, monkeypatch):
    """An async save writes the tree as it was at ``save``, even when its
    CPU leaves are updated in place while the file is written."""
    import threading

    release = threading.Event()
    _gate_savez(monkeypatch, release)
    d = str(tmp_path / "ckpt")
    mgr = CheckpointManager(d)
    live = _ck_tree(3)
    want = tree.map_(lambda t: t.clone(), live)
    mgr.save(3, live)                              # async, held before the write
    for t in tree.leaves(live):
        t.add_(1)
    release.set()
    mgr.wait()
    for (p, a), b in zip(tree.flatten_with_paths(restore(d, 3, want)), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), p


def test_checkpoint_restore_refuses_other_shapes(tmp_path):
    d = str(tmp_path / "ckpt")
    CheckpointManager(d).save(1, _ck_tree(1), blocking=True)
    other = _ck_tree(1)
    other["params"]["w"] = torch.empty(3, 4)
    with pytest.raises(ValueError, match="params/w"):
        restore(d, 1, other)


# ---------------------------------------------------------------------------
# the trainer and the launcher
# ---------------------------------------------------------------------------

class RecordingTrainer(Trainer):
    """Records the step each pipeline starts at and its first batch."""

    def _pipeline(self, start_step):
        return _Recording(super()._pipeline(start_step), self.starts)


class _Recording:
    def __init__(self, pipe, starts):
        self.pipe, self.starts, self.start = pipe, starts, pipe.step

    def __next__(self):
        batch = next(self.pipe)
        if self.start is not None:
            self.starts.append((self.start, batch["tokens"].clone()))
            self.start = None
        return batch

    def close(self):
        self.pipe.close()


def _train(tmp_path, steps, injector=None, ckpt_every=4, cls=Trainer):
    cfg = get_smoke("llama3.2-1b")
    run = RunConfig(model=cfg, shape=ShapeConfig("tiny", 32, 4, "train"),
                    optimizer=OptimizerConfig(total_steps=steps, warmup_steps=2),
                    checkpoint_dir=str(tmp_path / "ckpt"))
    t = cls(cfg, run, tcfg=TrainerConfig(steps=steps, checkpoint_every=ckpt_every,
                                         log_every=1000),
            injector=injector, log_fn=lambda s: None, device="cpu")
    t.starts = []
    return t, t.train()


def test_trainer_loss_decreases(tmp_path):
    _, stats = _train(tmp_path, 30)
    assert stats.steps == 30 and stats.restarts == 0
    assert stats.final_metrics["loss"] < 5.6      # < ~log(vocab) + slack


def test_trainer_restart_resumes_token_stream(tmp_path):
    t, stats = _train(tmp_path, 10, FaultInjector(fail_steps=(6,)), cls=RecordingTrainer)
    assert stats.steps == 10 and stats.restarts == 1
    cfg, shape = t.cfg, t.run.shape
    assert [s for s, _ in t.starts] == [0, 4]     # the checkpoint of step 4
    np.testing.assert_array_equal(t.starts[1][1].numpy(),
                                  synthetic_batch(cfg, shape, 4, 0)["tokens"])


def test_trainer_restart_budget_exhausted(tmp_path):
    with pytest.raises(InjectedFault):
        _train(tmp_path, 10, FaultInjector(fail_steps=(2, 3, 4, 5, 6)))


def test_trainer_async_checkpoint_is_the_saved_step(tmp_path, monkeypatch):
    """The Trainer's async checkpoint of step 2, written while step 3
    updates params and optimizer state in place, restores bit for bit to
    the state after step 2."""
    import threading

    release = threading.Event()
    _gate_savez(monkeypatch, release)
    after = []

    class Snapshotting(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            fn = self.bundle.fn

            def step(params, opt, batch):
                out = fn(params, opt, batch)
                after.append(tree.map_(lambda t: t.detach().clone(),
                                       {"params": out[0], "opt": out[1]}))
                if len(after) == 3:                # step 3 ran over the live state
                    release.set()
                return out

            self.bundle.fn = step

    t, stats = _train(tmp_path, 3, ckpt_every=2, cls=Snapshotting)
    assert stats.steps == 3 and latest_step(t.run.checkpoint_dir) == 2
    want = after[1]
    got = restore(t.run.checkpoint_dir, 2, want)
    assert not torch.equal(after[2]["params"]["embed"], want["params"]["embed"])
    for (p, a), b in zip(tree.flatten_with_paths(got), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), p


def test_trainer_requires_checkpoint_dir():
    cfg = get_smoke("llama3.2-1b")
    run = RunConfig(model=cfg, shape=ShapeConfig("tiny", 32, 4, "train"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        Trainer(cfg, run, log_fn=lambda s: None, device="cpu")


def test_trainer_does_not_retry_bugs(tmp_path, monkeypatch):
    calls = []

    def broken(*a):
        calls.append(1)
        raise RuntimeError("a bug, not a fault")

    cfg = get_smoke("llama3.2-1b")
    run = RunConfig(model=cfg, shape=ShapeConfig("tiny", 32, 4, "train"),
                    checkpoint_dir=str(tmp_path / "ckpt"))
    t = Trainer(cfg, run, tcfg=TrainerConfig(steps=3), log_fn=lambda s: None, device="cpu")
    t.bundle.fn = broken
    with pytest.raises(RuntimeError, match="a bug"):
        t.train()
    assert calls == [1] and t.policy.restarts == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_jax(arch):
    """The analytic counts, config only: total and active per token."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == (jcfg.param_count(),
                                                             jcfg.active_param_count())


def test_launcher_prints_done(tmp_path, capsys):
    train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "3", "--batch", "4",
                    "--seq", "64", "--device", "cpu", "--checkpoint-dir",
                    str(tmp_path / "ckpt"), "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "[train] done: 3 steps, loss=" in out and "restarts=0" in out
    assert latest_step(str(tmp_path / "ckpt")) == 2

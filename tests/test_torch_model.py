"""Port parity: parameters, and the serving forward of the whole model.

``repro_torch.models.model.forward`` against ``repro.models.model.forward(
..., paged=, paged_kernel="ref", compute_dtype=float32)`` with float32 pools
on ``get_smoke("llama3.2-1b")`` (2 layers, d_model 64, 4 heads / 2 kv heads)
(and the ``gemma3-4b``, ``stablelm-3b`` and ``granite-20b`` smokes, whose
default backend is paged too) and on ``get_smoke("olmoe-1b-7b")`` (2 MoE layers, 4/4 heads, 8 experts,
top-2) with the same weights (JAX ``init_params`` -> numpy ->
``params_from_jax``), over a scripted schedule of three steps: prefill
chunks, a decode row, an idle row, table holes and a reused block with
stale rows. Logits and both pools of every layer are compared, valid
columns only, atol 1e-4 (float32 through two layers; summation order
differs); the MoE router losses to rtol 1e-5. The MoE layers route the
padding columns to the drop slot in both packages (``token_mask``).

``get_smoke("mamba-130m")`` (2 SSM layers, d_model 64, inner 128, N 4)
runs the recurrent forward (``recurrent=RecurrentLayout``) over three
steps of prefill, decode and idle rows. Each step starts both packages
from the same state, the JAX package's carried over by
``recurrent_cache_from_jax``: logits on valid columns and every layer's
new conv history and state agree to 1e-5 in float32 (1.9e-6 seen). In
bfloat16 the JAX package scans the layers of a pure-recurrent stack and
XLA fuses the elementwise chains, while the port unrolls the layers and
rounds after every op, so the two differ by a few bf16 ulps: logits within
``MAMBA_BF16_LOGITS`` of the largest |logit| (0.84% seen), the state and
conv history within ``MAMBA_BF16_STATE`` (3.4e-2 seen, at values up to
~5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import model as jmodel
from repro_torch.configs.registry import default_cache_backend
from repro.models.kvcache import PagedLayout as JPagedLayout
from repro.models.kvcache import RecurrentLayout as JRecurrentLayout
from repro_torch.bridge import flatten_groups, params_from_jax, recurrent_cache_from_jax
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.models import model as tmodel
from repro_torch.models.kvcache import PagedLayout, RecurrentLayout
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ATOL = 1e-4
MAMBA_ATOL = 1e-5
MAMBA_BF16_LOGITS = 0.03       # of max |logit|: ~4 bf16 ulps at the top of the range
MAMBA_BF16_STATE = 0.1


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke("llama3.2-1b")
    jparams = jmodel.init_params(j_get_smoke("llama3.2-1b"), jax.random.PRNGKey(0))[0]
    np_params = jax.tree.map(np.asarray, jparams)
    return cfg, jparams, np_params


def test_configs_match_jax():
    from repro.configs.registry import get_config as j_get_config
    assert get_config("llama3.2-1b").to_json() == j_get_config("llama3.2-1b").to_json()
    assert get_smoke("llama3.2-1b").to_json() == j_get_smoke("llama3.2-1b").to_json()
    for arch in ("qwen2-vl-72b", "hubert-xlarge"):
        assert get_config(arch).to_json() == j_get_config(arch).to_json()
        assert get_smoke(arch).to_json() == j_get_smoke(arch).to_json()


def test_params_from_jax_round_trip(smoke):
    cfg, _, np_params = smoke
    g = np_params["groups"][0][0]
    assert g["attn"]["wq"].shape == (2, 64, 4, 16)
    assert g["mlp"]["w_down"].shape == (2, 128, 64)
    assert g["ln1"].shape == (2, 64)
    p = params_from_jax(np_params, cfg)
    assert set(p) == {"embed", "final_norm", "layers"}
    assert tuple(p["embed"].shape) == (256, 64) and p["embed"].dtype == torch.float32
    np.testing.assert_array_equal(p["embed"].numpy(), np_params["embed"])
    assert len(p["layers"]) == cfg.num_layers == 2
    for i, layer in enumerate(p["layers"]):
        want = dict(_leaves(g))
        got = dict(_leaves(layer))
        assert set(got) == set(want)
        for key, leaf in want.items():
            np.testing.assert_array_equal(got[key].numpy(), leaf[i])
    # init_params draws the same shapes (its own random bits)
    fresh = tmodel.init_params(cfg, device="cpu")
    assert tuple(fresh["embed"].shape) == (256, 64)
    for layer in fresh["layers"]:
        assert ({k: tuple(v.shape) for k, v in _leaves(layer)}
                == {k: v.shape[1:] for k, v in _leaves(g)})


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_params_from_jax_keeps_bf16_bits(smoke):
    cfg, jparams, _ = smoke
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), jparams)
    p = params_from_jax(bf, cfg)
    assert p["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(p["embed"].view(torch.int16).numpy(),
                                  bf["embed"].view(np.int16))


# (tokens, tables, starts, n_valid) per step; slots 3, chunk 4, bs 4, M 4
_SCHEDULE = [
    # row 0 prefills 4, row 1 prefills 3, row 2 idle
    ([[5, 9, 17, 200], [3, 3, 8, 0], [0, 0, 0, 0]],
     [[0, 1, -1, -1], [3, -1, -1, -1], [-1, -1, -1, -1]], [0, 0, 0], [4, 3, 0]),
    # row 0 prefills 4 more (crosses into block 1), row 1 decodes, row 2 starts
    ([[77, 1, 250, 31], [40, 0, 0, 0], [12, 13, 14, 15]],
     [[0, 1, -1, -1], [3, 4, -1, -1], [5, -1, -1, -1]], [4, 3, 0], [4, 1, 4]),
    # row 0 decodes, row 1 is a new request reusing block 3 (stale rows
    # 2..3 of the old one stay in the pool), row 2 decodes into block 6
    ([[99, 0, 0, 0], [7, 8, 0, 0], [101, 0, 0, 0]],
     [[0, 1, 2, -1], [3, -1, -1, -1], [5, 6, -1, -1]], [8, 0, 4], [1, 2, 1]),
]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-4b", "stablelm-3b", "granite-20b"])
def test_paged_forward_matches_jax_over_schedule(smoke, arch):
    """The dense-GQA smokes on the paged backend, their default in both
    packages: gemma3-4b with windows of 8 over rows of up to 9 tokens,
    stablelm-3b's partial rotary, granite-20b's single kv head."""
    jcfg = j_get_smoke(arch)
    if arch == "llama3.2-1b":
        cfg, jparams, np_params = smoke
    else:
        cfg = get_smoke(arch)
        jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))[0]
        np_params = jax.tree.map(np.asarray, jparams)
    N, bs = 8, 4
    tparams = params_from_jax(np_params, cfg)
    jcache = jmodel.init_paged_cache(jcfg, N, bs, dtype=jnp.float32)
    tcache = tmodel.init_paged_cache(cfg, N, bs, dtype=torch.float32, device="cpu")
    for step, (tok, tab, st, nv) in enumerate(_SCHEDULE):
        tok, tab = np.asarray(tok, np.int32), np.asarray(tab, np.int32)
        st, nv = np.asarray(st, np.int32), np.asarray(nv, np.int32)
        jl = JPagedLayout(jnp.asarray(tab), jnp.asarray(st), jnp.asarray(nv), bs)
        jlogits, jcache, _ = jmodel.forward(jcfg, jparams, jnp.asarray(tok),
                                            cache=jcache, paged=jl, paged_kernel="ref",
                                            compute_dtype=jnp.float32)
        tl = PagedLayout(*(torch.from_numpy(a) for a in (tab, st, nv)), bs)
        tlogits, tcache, _ = tmodel.forward(cfg, tparams, torch.from_numpy(tok),
                                            cache=tcache, paged=tl, paged_kernel="ref",
                                            compute_dtype=torch.float32)
        assert tlogits.dtype == torch.float32
        valid = np.arange(4)[None, :] < nv[:, None]
        np.testing.assert_allclose(tlogits.numpy()[valid], np.asarray(jlogits)[valid],
                                   atol=ATOL, rtol=0, err_msg=f"step {step}")
        jlayers = flatten_groups(jax.tree.map(np.asarray, jcache["groups"]), cfg)
        for i, (jl_, tl_) in enumerate(zip(jlayers, tcache["layers"])):
            for kv in ("k", "v"):
                np.testing.assert_allclose(tl_[kv].numpy(), jl_[kv], atol=ATOL, rtol=0,
                                           err_msg=f"step {step} layer {i} {kv}")


def test_serve_step_emits_argmax_at_last_valid_column(smoke):
    """``emit="last"`` is the argmax at column ``max(n_valid - 1, 0)`` and
    ``emit="all"`` the argmax at every column, from the same pools."""
    from repro_torch.runtime.steps import make_paged_serve_step

    cfg, _, np_params = smoke
    params = params_from_jax(np_params, cfg)
    tok, tab, st, nv = (torch.tensor(a, dtype=torch.int32) for a in _SCHEDULE[0])
    outs = {}
    for emit in ("last", "all"):
        step = make_paged_serve_step(cfg, slots=3, chunk=4, num_blocks=8, block_size=4,
                                     max_blocks_per_seq=4, kernel="ref", emit=emit,
                                     device="cpu", compute_dtype=torch.float32)
        assert step.meta["paged_kernel"] == "ref"
        cache = tmodel.init_paged_cache(cfg, 8, 4, dtype=torch.float32, device="cpu")
        outs[emit], _ = step.fn(params, cache, tok, tab, st, nv)
        assert int(step.meta["nonfinite_logits"]) == 0
    assert outs["all"].shape == (3, 4) and outs["last"].shape == (3,)
    last = (nv.long() - 1).clamp(min=0)
    assert torch.equal(outs["last"], outs["all"][torch.arange(3), last])


# ---------------------------------------------------------------------------
# olmoe-1b-7b: the GQA MoE stack
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmoe():
    jcfg = j_get_smoke("olmoe-1b-7b")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(1))[0]
    return get_smoke("olmoe-1b-7b"), jcfg, jparams, jax.tree.map(np.asarray, jparams)


def test_olmoe_config_and_layer_plan_match_jax(olmoe):
    import dataclasses

    from repro.configs.registry import get_config as j_get_config
    cfg, jcfg, _, _ = olmoe
    assert get_config("olmoe-1b-7b").to_json() == j_get_config("olmoe-1b-7b").to_json()
    assert cfg.to_json() == jcfg.to_json()
    assert default_cache_backend(get_config("olmoe-1b-7b")) == "paged"
    assert tmodel.layer_plan(cfg) == jmodel.layer_plan(jcfg) == [(("attn_moe",), 2)]
    for first in (1, 2):
        t = dataclasses.replace(cfg, num_layers=3,
                                moe=dataclasses.replace(cfg.moe, first_dense_layers=first))
        j = dataclasses.replace(jcfg, num_layers=3,
                                moe=dataclasses.replace(jcfg.moe, first_dense_layers=first))
        assert tmodel.layer_plan(t) == jmodel.layer_plan(j)
    mla = dataclasses.replace(cfg, attention=dataclasses.replace(cfg.attention, kind="mla"))
    jmla = dataclasses.replace(jcfg, attention=dataclasses.replace(jcfg.attention, kind="mla"))
    assert tmodel.layer_plan(mla) == jmodel.layer_plan(jmla) == [(("mla_moe",), 2)]


def test_olmoe_bridge_moves_moe_leaves_bit_for_bit(olmoe):
    cfg, _, jparams, _ = olmoe
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), jparams)
    p = params_from_jax(bf, cfg)
    moe = bf["groups"][0][0]["moe"]
    assert moe["router"].shape == (2, 64, 8) and moe["w_gate"].shape == (2, 8, 64, 32)
    assert moe["w_down"].shape == (2, 8, 32, 64)
    assert set(p) == {"embed", "head", "final_norm", "layers"}
    for i, layer in enumerate(p["layers"]):
        assert set(layer) == {"ln1", "ln2", "attn", "moe"}
        assert set(layer["moe"]) == set(moe)
        for key, leaf in moe.items():
            got = layer["moe"][key]
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          leaf[i].view(np.int16), err_msg=key)
    fresh = tmodel.init_params(cfg, device="cpu")
    for layer in fresh["layers"]:
        assert ({k: tuple(v.shape) for k, v in _leaves(layer)}
                == {k: v.shape[1:] for k, v in _leaves(bf["groups"][0][0])})


def test_olmoe_paged_forward_matches_jax_over_schedule(olmoe):
    cfg, jcfg, jparams, np_params = olmoe
    N, bs = 8, 4
    tparams = params_from_jax(np_params, cfg)
    jcache = jmodel.init_paged_cache(jcfg, N, bs, dtype=jnp.float32)
    tcache = tmodel.init_paged_cache(cfg, N, bs, dtype=torch.float32, device="cpu")
    for step, (tok, tab, st, nv) in enumerate(_SCHEDULE):
        tok, tab = np.asarray(tok, np.int32), np.asarray(tab, np.int32)
        st, nv = np.asarray(st, np.int32), np.asarray(nv, np.int32)
        jl = JPagedLayout(jnp.asarray(tab), jnp.asarray(st), jnp.asarray(nv), bs)
        jlogits, jcache, jaux = jmodel.forward(jcfg, jparams, jnp.asarray(tok),
                                               cache=jcache, paged=jl, paged_kernel="ref",
                                               compute_dtype=jnp.float32)
        tl = PagedLayout(*(torch.from_numpy(a) for a in (tab, st, nv)), bs)
        tlogits, tcache, taux = tmodel.forward(cfg, tparams, torch.from_numpy(tok),
                                               cache=tcache, paged=tl, paged_kernel="ref",
                                               compute_dtype=torch.float32)
        valid = np.arange(4)[None, :] < nv[:, None]
        np.testing.assert_allclose(tlogits.numpy()[valid], np.asarray(jlogits)[valid],
                                   atol=ATOL, rtol=0, err_msg=f"step {step}")
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
        jlayers = flatten_groups(jax.tree.map(np.asarray, jcache["groups"]), cfg)
        for i, (jl_, tl_) in enumerate(zip(jlayers, tcache["layers"])):
            for kv in ("k", "v"):
                np.testing.assert_allclose(tl_[kv].numpy(), jl_[kv], atol=ATOL, rtol=0,
                                           err_msg=f"step {step} layer {i} {kv}")


# ---------------------------------------------------------------------------
# mamba-130m: the pure-SSM stack on the recurrent path
# ---------------------------------------------------------------------------

# (n_valid, starts) per step; slots 3, chunk 4: two prefill rows and an
# idle one, then a partial prefill, a decode row and a fresh prefill, then
# decode, a last prefill chunk and decode
_RECURRENT = [([4, 4, 0], [0, 0, 0]), ([2, 1, 4], [4, 4, 0]), ([1, 4, 1], [6, 5, 4])]


@pytest.fixture(scope="module")
def mamba():
    jcfg = j_get_smoke("mamba-130m")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(3))[0]
    return get_smoke("mamba-130m"), jcfg, jparams


def test_mamba_config_plan_backend_and_bridge(mamba):
    from repro.configs.registry import get_config as j_get_config
    cfg, jcfg, jparams = mamba
    assert get_config("mamba-130m").to_json() == j_get_config("mamba-130m").to_json()
    assert cfg.to_json() == jcfg.to_json()
    assert tmodel.layer_plan(cfg) == jmodel.layer_plan(jcfg) == [(("ssm",), 2)]
    assert default_cache_backend(cfg) == "recurrent"
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), jparams)
    p = params_from_jax(bf, cfg)
    assert set(p) == {"embed", "head", "final_norm", "layers"}
    ssm = bf["groups"][0][0]["ssm"]
    assert ssm["in_proj"].shape == (2, 64, 256) and ssm["a_log"].shape == (2, 128, 4)
    for i, layer in enumerate(p["layers"]):
        assert set(layer) == {"ln1", "ssm"} and set(layer["ssm"]) == set(ssm)
        for key, leaf in ssm.items():
            np.testing.assert_array_equal(layer["ssm"][key].view(torch.int16).numpy(),
                                          leaf[i].view(np.int16), err_msg=key)
    fresh = tmodel.init_params(cfg, device="cpu")
    for layer in fresh["layers"]:
        assert ({k: tuple(v.shape) for k, v in _leaves(layer)}
                == {k: v.shape[1:] for k, v in _leaves(bf["groups"][0][0])})
        assert (layer["ssm"]["a_log"] == 1).all() and (layer["ssm"]["d_skip"] == 1).all()
    # the cache bridge: the JAX init cache -> the port's, dtypes kept
    tc = recurrent_cache_from_jax(jax.tree.map(np.asarray, jmodel.init_cache(jcfg, 3, 16)), cfg)
    want = tmodel.init_recurrent_cache(cfg, 3, device="cpu")
    for got, ref in zip(tc["layers"], want["layers"]):
        for key in ("conv", "state"):
            assert got[key].dtype == ref[key].dtype and got[key].shape == ref[key].shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_recurrent_forward_matches_jax_from_the_same_state(mamba, dtype):
    cfg, jcfg, jparams = mamba
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jparams = jax.tree.map(lambda t: t.astype(jd), jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    rng = np.random.default_rng(5)
    jcache = jmodel.init_cache(jcfg, 3, 16, dtype=jd)
    worst_logit = worst_state = 0.0
    for step, (nv, st) in enumerate(_RECURRENT):
        tok = rng.integers(0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
        nv, st = np.asarray(nv, np.int32), np.asarray(st, np.int32)
        tcache = recurrent_cache_from_jax(jax.tree.map(np.asarray, jcache), cfg)
        jlogits, jcache, _ = jmodel.forward(
            jcfg, jparams, jnp.asarray(tok), cache=jcache, compute_dtype=jd,
            recurrent=JRecurrentLayout(jnp.asarray(st), jnp.asarray(nv)))
        tl = RecurrentLayout(torch.from_numpy(st), torch.from_numpy(nv))
        tlogits, tcache, taux = tmodel.forward(cfg, tparams, torch.from_numpy(tok),
                                               cache=tcache, recurrent=tl,
                                               paged_kernel="ref", compute_dtype=td)
        assert tlogits.dtype == torch.float32 and taux == 0.0
        valid = np.arange(4)[None, :] < nv[:, None]
        got, want = tlogits.numpy()[valid], np.asarray(jlogits)[valid]
        jlayers = recurrent_cache_from_jax(jax.tree.map(np.asarray, jcache), cfg)["layers"]
        for i, (jl_, tl_) in enumerate(zip(jlayers, tcache["layers"])):
            for key in ("conv", "state"):
                assert tl_[key].dtype == jl_[key].dtype
                diff = (tl_[key].float() - jl_[key].float()).abs().max().item()
                worst_state = max(worst_state, diff)
                if dtype == "float32":
                    np.testing.assert_allclose(tl_[key].numpy(), jl_[key].numpy(),
                                               atol=MAMBA_ATOL, rtol=0,
                                               err_msg=f"step {step} layer {i} {key}")
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=MAMBA_ATOL, rtol=0,
                                       err_msg=f"step {step}")
        worst_logit = max(worst_logit, float(np.abs(got - want).max() / np.abs(want).max()))
    print(f"[mamba {dtype}] largest logit difference {worst_logit:.4f} of max |logit|; "
          f"largest state/conv difference {worst_state:.3e}")
    if dtype == "bfloat16":
        assert worst_logit <= MAMBA_BF16_LOGITS
        assert worst_state <= MAMBA_BF16_STATE


def test_recurrent_serve_step_emits_argmax_at_last_valid_column(mamba):
    from repro_torch.runtime.steps import make_recurrent_serve_step

    cfg, _, jparams = mamba
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    nv, st = (torch.tensor(a, dtype=torch.int32) for a in _RECURRENT[1])
    tok = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    step = make_recurrent_serve_step(cfg, slots=3, chunk=4, kernel="ref", device="cpu",
                                     compute_dtype=torch.float32)
    assert step.meta["kernel"] == "ref" and step.meta["kernels"] == ("ssm_scan",)
    cache = tmodel.init_recurrent_cache(cfg, 3, dtype=torch.float32, device="cpu")
    got, new = step.fn(params, cache, tok, st, nv)
    logits, _, _ = tmodel.forward(cfg, params, tok, cache=cache,
                                  recurrent=RecurrentLayout(st, nv), paged_kernel="ref",
                                  compute_dtype=torch.float32)
    assert torch.equal(got, logits[torch.arange(3), (nv.long() - 1).clamp(min=0)]
                       .argmax(-1).to(torch.int32))
    assert int(step.meta["nonfinite_logits"]) == 0
    # the step leaves its input cache as it was
    assert not any(lc["state"].any() for lc in cache["layers"])
    with pytest.raises(ValueError, match="recurrent serving supports"):
        make_recurrent_serve_step(get_smoke("llama3.2-1b"), slots=3, chunk=4, device="cpu")

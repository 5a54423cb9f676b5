"""Port parity: MLA attention (``deepseek-v2-lite-16b``) and MoE stacks on
the slots backend against the JAX package, at the smokes (deepseek: 3
layers, the first dense, 4 heads with q and k of 24 = 16 + 8 and v of 16,
kv_lora_rank 32, 8 experts top-2 plus 2 shared; olmoe: 2 MoE layers).

* Configs, layer plans and the default backend equal the JAX package's;
  ``Engine(cache="auto")`` resolves to slots for deepseek.
* The bridge moves the MLA leaves and the shared experts' bit for bit.
* ``mla_attention`` in float32 from the same weights, each of the JAX
  package's branches: no cache, prefill into a cache, absorbed decode
  over it (outputs, and the ``c_kv``/``k_rope`` rows), within ``ATOL``.
  With the chunking threshold lowered in both packages (by monkeypatch:
  no file changes), the prefill and the cacheless pass take the JAX
  ``_sdpa_chunked`` and the port's flash attention (its plain version on
  the CPU) at separate widths: q and k of 24, v of 16.
* ``mha_ref`` with v narrower than q and k against ``_sdpa_chunked``.
* The contiguous forward and decode of both smokes in float32, with and
  without the lowered threshold: logits and every layer's cache rows. The
  MoE blocks route every token with no mask, as the JAX package's
  contiguous block does.
* The slots Engine on both smokes against the JAX ``Engine(cache="slots")``
  on a plain Mesh: admission order, ticks, completions and the shared
  length exactly; the port's engine in float32 emits the argmax of the
  JAX float32 forward driven through its own admissions and decode
  inputs (in every row but those under ``F32_MARGIN_TOL``, at most one in
  ten), with every prefill's and every active decode row's logits within
  ``ATOL`` of it; the bf16 engine's tokens meet the same oracle within
  ``MARGIN_TOL``, except where the MoE router turns bf16 rounding into
  another expert (ROADMAP §C's envelope: at least ``MOE_BF16_SHARE`` of
  the tokens).
"""
import math
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import SHAPES, RunConfig, ShardingConfig
from repro.configs.registry import default_cache_backend as j_default_cache_backend
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.engine import Engine as JEngine
from repro.engine import Request as JRequest
from repro.engine import engine as j_engine_mod
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.kvcache import MLACache as JMLACache
from repro_torch.bridge import params_from_jax, slot_cache_from_jax
from repro_torch.configs.registry import default_cache_backend, get_config, get_smoke
from repro_torch.engine import Engine, Request
from repro_torch.kernels.flash_attention import mha_ref
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.kvcache import MLACache
from repro_torch.runtime.steps import make_prefill_step, make_serve_step
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ARCH = "deepseek-v2-lite-16b"
ARCHS = (ARCH, "olmoe-1b-7b")
ATOL = 1e-4
MARGIN_TOL = 5e-2          # as tests/test_torch_engine.py
F32_MARGIN_TOL = 1e-3
MOE_BF16_SHARE = 0.85      # as tests/test_torch_engine.py
GEOM = dict(slots=2, max_len=32)
LENS, MAX_NEW = (5, 9, 9, 5), 6


@pytest.fixture(scope="module")
def models():
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = j_get_smoke(arch)
        jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(20 + i))[0]
        cfg = get_smoke(arch)
        out[arch] = dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                         tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return out


def _lower_threshold(monkeypatch):
    monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(jattn, "Q_CHUNK", 4)
    monkeypatch.setattr(jattn, "KV_CHUNK", 4)
    monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 16)


def _count_flash(monkeypatch):
    calls = []
    inner = tattn.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["scale"]))
        return inner(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    return calls


def test_deepseek_config_plan_and_backend_match_jax():
    for get, jget in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        cfg, jcfg = get(ARCH), jget(ARCH)
        assert cfg.to_json() == jcfg.to_json()
        assert tmodel.layer_plan(cfg) == jmodel.layer_plan(jcfg)
        assert default_cache_backend(cfg) == j_default_cache_backend(jcfg) == "slots"
    assert tmodel.layer_plan(get_config(ARCH)) == [(("mla_dense",), 1), (("mla_moe",), 26)]
    e = Engine(get_smoke(ARCH), device="cpu", cache="auto", **GEOM)
    assert (e.cache_kind, e.kernel) == ("slots", "ref")
    assert e.kernel_launches == {"flash_attention": 0, "moe_jam": 0}


def test_bridge_moves_mla_and_shared_expert_leaves_bit_for_bit(models):
    m = models[ARCH]
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), m["jparams"])
    p = params_from_jax(bf, m["cfg"])
    # group 0: one mla_dense layer (no repeats axis); group 1: two mla_moe
    want = [(bf["groups"][0][0], None)] + [(bf["groups"][1][0], r) for r in range(2)]
    assert len(p["layers"]) == 3
    attn_shapes = {"wq": (64, 4, 24), "w_dkv": (64, 40), "kv_norm": (32,),
                   "w_uk": (32, 4, 16), "w_uv": (32, 4, 16), "wo": (4, 16, 64)}
    for i, (got, (tree, r)) in enumerate(zip(p["layers"], want)):
        assert set(got) == {"ln1", "ln2", "attn", "mlp" if i == 0 else "moe"}
        assert {k: tuple(v.shape) for k, v in got["attn"].items()} == attn_shapes
        sub = ["attn", "mlp" if i == 0 else "moe"]
        if i:
            assert {k: tuple(got["moe"][k].shape) for k in ("ws_gate", "ws_up", "ws_down")} \
                == {"ws_gate": (64, 64), "ws_up": (64, 64), "ws_down": (64, 64)}
        for s in sub:
            assert set(got[s]) == set(tree[s])
            for key, leaf in tree[s].items():
                leaf = leaf if r is None else leaf[r]
                assert got[s][key].dtype == torch.bfloat16
                np.testing.assert_array_equal(got[s][key].view(torch.int16).numpy(),
                                              leaf.view(np.int16), err_msg=f"{i} {s} {key}")


def _attn_params(m):
    jp = m["jparams"]["groups"][0][0]["attn"]
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _check_cache(tc: MLACache, jc: JMLACache):
    assert tc.length == int(jc.length)
    np.testing.assert_allclose(tc.c_kv.numpy(), np.asarray(jc.c_kv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.k_rope.numpy(), np.asarray(jc.k_rope), atol=ATOL, rtol=0)


@pytest.mark.parametrize("path", ["sdpa", "flash"])
@pytest.mark.parametrize("branch", ["cacheless", "prefill", "decode"])
def test_mla_attention_branches_match_jax(models, monkeypatch, branch, path):
    """Absorbed decode runs no flash call (S == 1), so its ``flash`` case
    decodes after a prefill that took flash."""
    m = models[ARCH]
    a, ja = m["cfg"].attention, m["jcfg"].attention
    jp, tp = _attn_params(m)
    if path == "flash":
        _lower_threshold(monkeypatch)
    calls = _count_flash(monkeypatch)
    x = np.random.default_rng(3).standard_normal((2, 9, 64), dtype=np.float32)
    if branch == "cacheless":
        jy, _ = jattn.mla_attention(jp, jnp.asarray(x), ja)
        ty, none = tattn.mla_attention(tp, torch.from_numpy(x), a, kernel="ref")
        assert none is None
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    else:
        jc = JMLACache.init(2, 16, a.kv_lora_rank, a.qk_rope_head_dim, dtype=jnp.float32)
        tc = MLACache(torch.zeros(2, 16, a.kv_lora_rank), torch.zeros(2, 16, a.qk_rope_head_dim),
                      0)
        jy, jc = jattn.mla_attention(jp, jnp.asarray(x), ja, cache=jc)
        ty, tc = tattn.mla_attention(tp, torch.from_numpy(x), a, cache=tc, kernel="ref")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
        _check_cache(tc, jc)
        if branch == "decode":
            for step in range(3):
                x1 = np.random.default_rng(4 + step).standard_normal((2, 1, 64), dtype=np.float32)
                jy, jc = jattn.mla_attention(jp, jnp.asarray(x1), ja, cache=jc)
                ty, tc = tattn.mla_attention(tp, torch.from_numpy(x1), a, cache=tc, kernel="ref")
                np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=0,
                                           err_msg=f"decode step {step}")
                _check_cache(tc, jc)
    assert calls == ([(24, 24, 16, 1 / math.sqrt(24))] if path == "flash" else [])


@pytest.mark.parametrize("case", [dict(causal=True, window=None, G=1, off=0),
                                  dict(causal=False, window=None, G=1, off=0),
                                  dict(causal=True, window=5, G=2, off=3)])
def test_mha_ref_at_separate_widths_matches_sdpa_chunked(case):
    """q and k of 24, v of 16: the output takes v's width; the JAX
    blockwise formulation in chunks of 4 against the plain version."""
    B, K, G, S, D, Dv = 2, 2, case["G"], 12, 24, 16
    T = S + case["off"]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, S, K, G, D), dtype=np.float32)
    k = rng.standard_normal((B, T, K, D), dtype=np.float32)
    v = rng.standard_normal((B, T, K, Dv), dtype=np.float32)
    q_pos = (np.arange(S) + case["off"])[None].repeat(B, 0)
    kv_pos = np.arange(T)[None].repeat(B, 0)
    want = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=D ** -0.5,
                               q_pos=jnp.asarray(q_pos), kv_pos=jnp.asarray(kv_pos),
                               causal=case["causal"], window=case["window"], q_chunk=4,
                               kv_chunk=4)                       # (B, S, K, G, Dv)
    got = mha_ref(torch.from_numpy(q).reshape(B, S, K * G, D).transpose(1, 2),
                  torch.from_numpy(k).transpose(1, 2), torch.from_numpy(v).transpose(1, 2),
                  causal=case["causal"], window=case["window"], q_offset=case["off"])
    assert got.shape == (B, K * G, S, Dv)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(want).reshape(B, S, K * G, Dv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("path", ["sdpa", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_moe_forward_and_decode_match_jax(models, monkeypatch, arch, path):
    m = models[arch]
    jcfg, cfg, jp, tp = m["jcfg"], m["cfg"], m["jparams"], m["tparams"]
    if path == "flash":
        _lower_threshold(monkeypatch)
    calls = _count_flash(monkeypatch)
    f32 = dict(compute_dtype=jnp.float32)
    jprefill = jax.jit(lambda p, t, c: jmodel.forward(jcfg, p, t, cache=c, **f32)[:2])
    jdecode = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t, **f32))
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    jl, jc = jprefill(jp, jnp.asarray(tok), jmodel.init_cache(jcfg, 2, 16, dtype=jnp.float32))
    tc = tmodel.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    tl, tc, aux = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tc, paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert isinstance(aux, torch.Tensor) and torch.isfinite(aux)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for step in range(2):
        t1 = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(t1))
        tl, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(t1), kernel="ref",
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    want = slot_cache_from_jax(jax.tree.map(np.asarray, jc), cfg)
    assert tc["length"] == want["length"] == 11
    keys = ("c_kv", "k_rope") if arch == ARCH else ("k", "v")
    for i, (got_l, want_l) in enumerate(zip(tc["layers"], want["layers"])):
        assert set(got_l) == set(want_l) == set(keys)
        for key in keys:
            np.testing.assert_allclose(got_l[key].numpy(), want_l[key].numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"layer {i} {key}")
    jl = jax.jit(lambda p, t: jmodel.forward(jcfg, p, t, **f32)[0])(jp, jnp.asarray(tok))
    tl, none, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert none is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(calls) == (2 * cfg.num_layers if path == "flash" else 0)


# ---------------------------------------------------------------------------
# the slots Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slots_envs(models):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = {}
    for arch in ARCHS:
        m = models[arch]
        jcfg = m["jcfg"]
        run = RunConfig(model=jcfg, shape=SHAPES["decode_32k"],
                        sharding=ShardingConfig(fsdp_params=False, seq_axis=None))
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, jcfg.vocab_size, size=(n,)).astype(np.int32) for n in LENS]
        f32 = dict(compute_dtype=jnp.float32)
        oracle = dict(
            prefill=jax.jit(lambda p, t, jcfg=jcfg: jmodel.forward(
                jcfg, p, t, cache=jmodel.init_cache(jcfg, 1, GEOM["max_len"],
                                                    dtype=jnp.float32), **f32)[:2]),
            decode=jax.jit(lambda p, c, t, jcfg=jcfg: jmodel.decode_step(jcfg, p, c, t, **f32)))
        jitted = types.SimpleNamespace(**vars(jmodel))
        jitted.forward = jax.jit(jmodel.forward, static_argnums=(0,))
        out[arch] = dict(m, mesh=mesh, run=run, prompts=prompts, oracle=oracle, jitted=jitted)
    return out


def _serve_jax(env, monkeypatch):
    monkeypatch.setattr(j_engine_mod, "model_lib", env["jitted"])
    with env["mesh"], warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        e = JEngine(env["jcfg"], env["run"], env["mesh"], cache="slots", **GEOM)
        e.load_params(env["jparams"])
        for rid, p in enumerate(env["prompts"]):
            e.submit(JRequest(rid, p, max_new_tokens=MAX_NEW))
        e.run_until_drained()
    return e


def _serve_torch(env, monkeypatch, dtype):
    """The port's slots engine (``cache="auto"`` for deepseek); returns it
    and its recorded prefills and decode steps, with their logits."""
    cache = "auto" if env["cfg"].name.startswith(ARCH) else "slots"
    e = Engine(env["cfg"], device="cpu", cache=cache, kernel="ref", **GEOM)
    assert e.cache_kind == "slots"
    e.load_params(env["tparams"])
    if dtype != torch.bfloat16:
        e.bundle = make_serve_step(env["cfg"], slots=e.slots, kernel="ref", device="cpu",
                                   compute_dtype=dtype)
        e.prefill_bundle = make_prefill_step(env["cfg"], max_len=e.max_len, kernel="ref",
                                             device="cpu", compute_dtype=dtype)
        e.cache = tmodel.init_cache(env["cfg"], e.slots, e.max_len, dtype=dtype, device="cpu")
    events, decode_logits = [], []
    inner = tmodel.decode_step

    def rec_decode_step(*args, **kw):
        logits, cache = inner(*args, **kw)
        decode_logits.append(logits[:, -1].numpy().copy())
        return logits, cache

    monkeypatch.setattr(tmodel, "decode_step", rec_decode_step)
    prefill, decode = e.prefill_bundle.fn, e.bundle.fn

    def rec_prefill(params, tokens):
        out = prefill(params, tokens)
        slot = e.slot_entry.index(None)
        events.append(("prefill", slot, tokens.numpy().copy(), out[0].numpy().copy()))
        return out

    def rec_decode(params, cache, tokens):
        out = decode(params, cache, tokens)
        active = [i for i, x in enumerate(e.slot_entry) if x is not None]
        events.append(("decode", active, tokens.numpy().copy(), decode_logits[-1]))
        return out

    e.prefill_bundle.fn, e.bundle.fn = rec_prefill, rec_decode
    for rid, p in enumerate(env["prompts"]):
        e.submit(Request(rid, p, max_new_tokens=MAX_NEW))
    e.run_until_drained()
    monkeypatch.setattr(tmodel, "decode_step", inner)
    return e, events


def _schedule(e):
    return dict(admission=list(e.admission_log), ticks=e.ticks, completed=len(e.completed),
                length=int(e.cache["length"]))


def _scatter(live, one, slot, slots):
    """The JAX engine's prefill scatter (``Engine._prefill_slot``)."""
    def put(a, b):
        for ax in range(a.ndim):
            if a.shape[ax] == slots and b.shape[ax] == 1 and a.shape[:ax] == b.shape[:ax]:
                return a.at[(slice(None),) * ax + (slot,)].set(jnp.take(b, 0, axis=ax))
        return a
    return {"length": jnp.maximum(live["length"], one["length"]),
            "groups": jax.tree.map(put, live["groups"], one["groups"])}


def _against_f32(env, events, margin, atol):
    """Drive the JAX float32 forward through the recorded admissions and
    decode inputs; returns (tokens, tokens under the margin, faults, the
    largest logit difference over prefills and active decode rows)."""
    jcache = jmodel.init_cache(env["jcfg"], GEOM["slots"], GEOM["max_len"], dtype=jnp.float32)
    total, exceptions, faults, worst = 0, 0, [], 0.0

    def check(where, row, got):
        nonlocal total, exceptions, worst
        total += 1
        worst = max(worst, float(np.abs(got - row).max()))
        if int(np.argmax(got)) != int(np.argmax(row)):
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] >= margin:
                faults.append((where, int(np.argmax(got)), int(np.argmax(row)),
                               float(top2[1] - top2[0])))
            else:
                exceptions += 1

    for i, (kind, slots, inp, out) in enumerate(events):
        if kind == "prefill":
            logits, filled = env["oracle"]["prefill"](env["jparams"], jnp.asarray(inp))
            check((i, slots), np.asarray(logits)[0, -1], out[0])
            jcache = _scatter(jcache, filled, slots, GEOM["slots"])
        else:
            logits, jcache = env["oracle"]["decode"](env["jparams"], jcache, jnp.asarray(inp))
            for r in slots:
                check((i, r), np.asarray(logits)[r, -1], out[r])
    if atol is not None:
        assert worst <= atol, worst
    return total, exceptions, faults


@pytest.mark.parametrize("arch", ARCHS)
def test_slots_engine_moe_matches_jax(slots_envs, monkeypatch, arch):
    env = slots_envs[arch]
    want = _schedule(_serve_jax(env, monkeypatch))
    for dtype in (torch.float32, torch.bfloat16):
        e, events = _serve_torch(env, monkeypatch, dtype)
        assert _schedule(e) == want
        assert all(len(r.out_tokens) == MAX_NEW for r in e.completed)
        m = e.metrics()
        assert m["kernel_launches"] == {"flash_attention": 0, "moe_jam": 0}
        assert m["nonfinite_logits"] == 0 and m["steps"] == e.ticks
        if dtype == torch.float32:
            total, exceptions, faults = _against_f32(env, events, F32_MARGIN_TOL, ATOL)
            assert not faults, faults
            assert exceptions <= total // 10
        else:
            total, exceptions, faults = _against_f32(env, events, MARGIN_TOL, None)
            print(f"[{arch} slots bf16] {exceptions} tokens under the margin, {len(faults)} "
                  f"router flips past it, of {total}")
            assert total - len(faults) >= MOE_BF16_SHARE * total


def test_serve_cli_deepseek_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                                     "--max-len", "64", "--prompt-len", "20", "--requests",
                                     "3", "--max-new", "4", "--metrics-json"])
    serve.main()
    out = capsys.readouterr().out
    assert "[serve:slots/fifo] 3/3 requests, 12 tokens" in out
    assert '"cache": "slots"' in out and "moe_jam" in out

"""Port parity: ``qwen2-vl-72b`` (M-RoPE: three rotary position streams,
and image-patch embeddings spliced over the first positions) against the
JAX package, at the smoke (2 layers, d_model 64, 4/2 heads of 16,
sections (2, 3, 3), 8 patch tokens).

* Configs, layer plans, the default backend (slots, which
  ``Engine(cache="auto")`` resolves to) and the bridge (no
  ``frontend_proj``: the patch embeddings are d_model wide).
* ``apply_mrope`` against the JAX one on 3-D positions whose streams
  differ, at the smoke's width and sections and at the full config's (D
  128, sections (16, 24, 24), theta 1e6), within 1e-6 in float32; on text
  positions it equals ``apply_rope`` bit for bit, and
  ``text_mrope_positions`` equals the JAX one.
* ``forward`` in float32 from the same weights with the splice and image
  positions (t 0, h and w over a 2 x 4 grid, text after them): a prefill
  of two rows into a fresh cache, two decode steps at explicit text
  positions, the forward with no cache and the prefill step; logits and
  every layer's k/v within ``ATOL``. ``path="flash"`` lowers the chunking
  threshold in both packages by monkeypatch (no file changes), so the
  prefill and the cacheless pass take the JAX ``_sdpa_chunked`` and the
  port's flash attention (its plain version on the CPU, one call a
  layer); ``path="sdpa"`` keeps both on plain ``_sdpa``.
* The slots Engine against the JAX ``Engine(cache="slots")``
  (``test_torch_slots.slots_engine_parity``), through ``cache="auto"``:
  every slot decodes at the shared length in all three streams, as the
  JAX engine's slots tick does.
* The refusals that mirror the JAX package's: the paged path refuses an
  mrope stack.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import default_cache_backend as j_default_cache_backend
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import rope as jrope
from repro_torch.bridge import params_from_jax, slot_cache_from_jax
from repro_torch.configs.registry import default_cache_backend, get_config, get_smoke
from repro_torch.engine import Engine, Request
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import rope as trope
from repro_torch.runtime.steps import make_prefill_step
from test_torch_slots import slots_engine_parity, slots_parity_env
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ARCH = "qwen2-vl-72b"
ATOL = 1e-4
ROPE_ATOL = 1e-6
GRID = (2, 4)                 # the smoke's 8 patches as an h x w grid


@pytest.fixture(scope="module")
def qw():
    jcfg = j_get_smoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(6))[0]
    cfg = get_smoke(ARCH)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))


def image_positions(batch, seq, grid):
    """(3, B, S) int32: the first h x w positions an image (t 0, h and w
    its row and column), then text, all three streams at one position
    counting on from the image's largest."""
    h, w = grid
    p = h * w
    pos = np.zeros((3, batch, seq), np.int32)
    idx = np.arange(p)
    pos[1, :, :p] = idx // w
    pos[2, :, :p] = idx % w
    pos[:, :, p:] = max(h, w) + np.arange(seq - p)
    return pos


def test_config_plan_backend_and_bridge(qw):
    jcfg, cfg = qw["jcfg"], qw["cfg"]
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert full.to_json() == jfull.to_json() and cfg.to_json() == jcfg.to_json()
    assert tmodel.layer_plan(full) == jmodel.layer_plan(jfull) == [(("attn_full",), 80)]
    assert tmodel.layer_plan(cfg) == jmodel.layer_plan(jcfg)
    assert default_cache_backend(full) == j_default_cache_backend(jfull) == "slots"
    e = Engine(cfg, device="cpu", cache="auto", slots=2, max_len=16)
    assert e.cache_kind == "slots" and e.kernel_launches == {"flash_attention": 0}
    p = qw["tparams"]
    assert set(p) == set(qw["jparams"]) - {"groups"} | {"layers"} == {
        "embed", "head", "final_norm", "layers"}
    fresh = tmodel.init_params(cfg, device="cpu")
    assert set(fresh) == set(p)
    assert [tuple(layer["attn"]["wq"].shape) for layer in fresh["layers"]] == [(64, 4, 16)] * 2


@pytest.mark.parametrize("head_dim,sections,theta", [(16, (2, 3, 3), 10000.0),
                                                     (128, (16, 24, 24), 1_000_000.0)])
def test_apply_mrope_matches_jax(head_dim, sections, theta):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 11, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(3, 2, 11)).astype(np.int32)   # the streams differ
    want = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections))
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ROPE_ATOL, rtol=0)
    # each stream moves its own frequency slots and no other: a stream's
    # positions changed alone leave the other streams' slots as they were
    bounds = np.cumsum((0,) + sections)
    for s in range(3):
        moved = pos.copy()
        moved[s] += 17
        other = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved), theta, sections)
        slots = np.abs(other.numpy() - got.numpy()).max(axis=(0, 1, 2))   # (D,)
        half = head_dim // 2
        changed = set(np.flatnonzero(slots[:half] + slots[half:]))
        assert changed <= set(range(bounds[s], bounds[s + 1])) and changed, (s, changed)
    # text positions: every stream the same, apply_rope's result bit for bit
    off = np.array([3, 9], np.int32)
    text = trope.text_mrope_positions(2, 11, torch.from_numpy(off))
    np.testing.assert_array_equal(
        text.numpy(), np.asarray(jrope.text_mrope_positions(2, 11, jnp.asarray(off))))
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype)
        assert torch.equal(trope.apply_mrope(xt, text, theta, sections),
                           trope.apply_rope(xt, text[0], theta))
    with pytest.raises(AssertionError):
        trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, (1, 1, 1))


def _patch_threshold(monkeypatch, path):
    if path == "flash":
        monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 64)
        monkeypatch.setattr(jattn, "Q_CHUNK", 4)
        monkeypatch.setattr(jattn, "KV_CHUNK", 4)
        monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 64)
    calls = []
    inner = tattn.flash_attention

    def counting(*args, **kw):
        calls.append(kw.get("causal"))
        return inner(*args, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("path", ["sdpa", "flash"])
def test_forward_with_image_matches_jax(qw, monkeypatch, path):
    jcfg, cfg, jp, tp = qw["jcfg"], qw["cfg"], qw["jparams"], qw["tparams"]
    calls = _patch_threshold(monkeypatch, path)
    f32 = dict(compute_dtype=jnp.float32)
    rng = np.random.default_rng(11)
    B, S, P = 2, 13, cfg.frontend.num_patch_tokens
    tok = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    feats = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    pos = image_positions(B, S, GRID)
    jin = dict(frontend_feats=jnp.asarray(feats), mrope_positions=jnp.asarray(pos))
    tin = dict(frontend_feats=torch.from_numpy(feats), mrope_positions=torch.from_numpy(pos))
    jl, jc = jax.jit(lambda p, t, c, f, m: jmodel.forward(
        jcfg, p, t, cache=c, frontend_feats=f, mrope_positions=m, **f32)[:2])(
        jp, jnp.asarray(tok), jmodel.init_cache(jcfg, B, 24, dtype=jnp.float32), *jin.values())
    tc = tmodel.init_cache(cfg, B, 24, dtype=torch.float32, device="cpu")
    tl, tc, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tc, paged_kernel="ref",
                               compute_dtype=torch.float32, **tin)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert calls == ([True] * cfg.num_layers if path == "flash" else [])
    # the splice and the 3-D positions both reach the logits
    plain, _, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert np.abs(plain.numpy() - tl.numpy()).max() > 1e-2
    jdecode = jax.jit(lambda p, c, t, m: jmodel.decode_step(jcfg, p, c, t, mrope_positions=m,
                                                            **f32))
    nxt = int(pos.max()) + 1
    for step in range(2):
        t1 = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        m1 = np.full((3, B, 1), nxt + step, np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(t1), jnp.asarray(m1))
        tl, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(t1), kernel="ref",
                                    compute_dtype=torch.float32,
                                    mrope_positions=torch.from_numpy(m1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    want = slot_cache_from_jax(jax.tree.map(np.asarray, jc), cfg)
    assert tc["length"] == want["length"] == S + 2
    for i, (got_l, want_l) in enumerate(zip(tc["layers"], want["layers"])):
        for kv in ("k", "v"):
            np.testing.assert_allclose(got_l[kv].numpy(), want_l[kv].numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"layer {i} {kv}")
    # no cache, and the prefill step (the last position, a filled cache)
    jl = jax.jit(lambda p, t, f, m: jmodel.forward(
        jcfg, p, t, frontend_feats=f, mrope_positions=m, **f32)[0])(
        jp, jnp.asarray(tok), *jin.values())
    tl, none, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), paged_kernel="ref",
                                 compute_dtype=torch.float32, **tin)
    assert none is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    step = make_prefill_step(cfg, max_len=24, kernel="ref", device="cpu",
                             compute_dtype=torch.float32)
    last, filled = step.fn(tp, torch.from_numpy(tok), **tin)
    assert filled["length"] == S and step.meta["kernels"] == ("flash_attention",)
    np.testing.assert_allclose(last.numpy(), np.asarray(jl)[:, -1], atol=ATOL, rtol=0)
    assert len(calls) == (4 * cfg.num_layers if path == "flash" else 0)


def test_slots_engine_matches_jax(qw, monkeypatch):
    """``cache="auto"`` (slots): 2 slots of 32 rows, prompts of 4, 7 and 5
    tokens (unaligned: the lockstep length), 4 new each; the text prompts
    rotate by text positions, every decode tick at the shared length."""
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, qw["cfg"].vocab_size, size=(n,)).astype(np.int32)
               for n in (4, 7, 5)]
    env = slots_parity_env(qw["jcfg"], qw["cfg"], qw["jparams"], prompts, slots=2,
                           max_len=32)
    slots_engine_parity(env, 4, monkeypatch, cache="auto")


def test_paged_path_refuses_mrope(qw):
    cfg = qw["cfg"]
    e = Engine(cfg, device="cpu", cache="paged", slots=2, max_len=16, num_blocks=8,
               block_size=4)
    e.load_params(qw["tparams"])
    e.submit(Request(0, np.arange(5, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(ValueError, match="paged serving does not support mrope"):
        e.tick()


def test_serve_cli_qwen_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                                     "--max-len", "64", "--prompt-len", "20", "--requests",
                                     "3", "--max-new", "4", "--metrics-json"])
    serve.main()
    out = capsys.readouterr().out
    assert "[serve:slots/fifo] 3/3 requests, 12 tokens" in out
    assert '"flash_attention"' in out

"""Port parity: ``hymba-1.5b`` (GQA attention and a mamba SSM in parallel
in every block, mean-fused) against the JAX package, at the smoke (2
layers: one ``hybrid_local`` of window 8 and one ``hybrid_full``; d_model
64, 4/2 heads of 16, SSM inner 128, state 4).

* Configs, layer plans (with a remainder), the default backend (slots,
  which ``Engine(cache="auto")`` resolves to) and the bridge's hybrid
  leaves bit for bit.
* The contiguous forward in float32 from the same weights: a prefill of
  two rows into a fresh cache, decode steps, and the forward with no
  cache; logits and every layer's ``{"k", "v", "conv", "state"}`` within
  ``ATOL``. ``path="flash"`` lowers the chunking threshold in both
  packages by monkeypatch (no file changes), so the prefill and the
  cacheless pass take the JAX ``_sdpa_chunked`` and the port's flash
  attention (its plain version on the CPU: one call a layer, the local
  one with its window); ``path="sdpa"`` keeps both on plain ``_sdpa``.
* bfloat16: the smoke's two layers form one unrepeated group, so the JAX
  package runs them unrolled as the port does; the logits differ by
  rounding, within ``BF16_LOGITS`` of the largest |logit|.
* The slots Engine against the JAX ``Engine(cache="slots")``
  (``test_torch_slots.slots_engine_parity``): schedule, tokens against
  the JAX float32 forward, float32 logits within ``ATOL``.
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
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.bridge import params_from_jax, slot_cache_from_jax
from repro_torch.configs.registry import default_cache_backend, get_config, get_smoke
from repro_torch.engine import Engine
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from test_torch_slots import slots_engine_parity, slots_parity_env
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ARCH = "hymba-1.5b"
ATOL = 1e-4
BF16_LOGITS = 0.03


@pytest.fixture(scope="module")
def hy():
    jcfg = j_get_smoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(5))[0]
    cfg = get_smoke(ARCH)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_config_plan_backend_and_bridge(hy):
    jcfg, cfg = hy["jcfg"], hy["cfg"]
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert full.to_json() == jfull.to_json() and cfg.to_json() == jcfg.to_json()
    assert tmodel.layer_plan(full) == jmodel.layer_plan(jfull) == [
        (("hybrid_local",) * 15 + ("hybrid_full",), 2)]
    assert tmodel.layer_plan(cfg) == jmodel.layer_plan(jcfg) == [
        (("hybrid_local", "hybrid_full"), 1)]
    for layers, ratio in ((5, 1), (3, 0)):
        t = dataclasses.replace(cfg, num_layers=layers, attention=dataclasses.replace(
            cfg.attention, local_global_ratio=ratio))
        j = dataclasses.replace(jcfg, num_layers=layers, attention=dataclasses.replace(
            jcfg.attention, local_global_ratio=ratio))
        assert tmodel.layer_plan(t) == jmodel.layer_plan(j)
    assert default_cache_backend(full) == j_default_cache_backend(jfull) == "slots"
    e = Engine(cfg, device="cpu", cache="auto", slots=2, max_len=16)
    assert e.cache_kind == "slots"
    assert e.kernel_launches == {"flash_attention": 0, "ssm_scan": 0}
    with pytest.raises(ValueError, match="paged serving supports"):
        tmodel.init_paged_cache(cfg, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="recurrent serving supports"):
        Engine(cfg, device="cpu", cache="recurrent", slots=2, max_len=16)
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), hy["jparams"])
    p = params_from_jax(bf, cfg)
    fresh = tmodel.init_params(cfg, device="cpu")
    for i, layer in enumerate(p["layers"]):
        want = dict(_leaves(bf["groups"][0][i]))
        assert set(layer) == {"ln1", "ln2", "attn", "ssm", "mlp"}
        assert set(dict(_leaves(layer))) == set(want)
        for key, leaf in _leaves(layer):
            np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                          want[key].view(np.int16), err_msg=str(key))
        assert ({k: tuple(v.shape) for k, v in _leaves(fresh["layers"][i])}
                == {k: v.shape for k, v in want.items()})
    c = tmodel.init_cache(cfg, 2, 16, device="cpu")
    assert [sorted(layer) for layer in c["layers"]] == [["conv", "k", "state", "v"]] * 2
    assert c["layers"][0]["state"].dtype == torch.float32


def _patch_threshold(monkeypatch, path):
    if path == "flash":
        monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 64)
        monkeypatch.setattr(jattn, "Q_CHUNK", 4)
        monkeypatch.setattr(jattn, "KV_CHUNK", 4)
        monkeypatch.setattr(tattn, "CHUNK_THRESHOLD", 64)
    calls = []
    inner = tattn.flash_attention

    def counting(*args, **kw):
        calls.append(kw.get("window"))
        return inner(*args, **kw)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    return calls


@pytest.mark.parametrize("path", ["sdpa", "flash"])
def test_contiguous_forward_and_decode_match_jax(hy, monkeypatch, path):
    jcfg, cfg, jp, tp = hy["jcfg"], hy["cfg"], hy["jparams"], hy["tparams"]
    calls = _patch_threshold(monkeypatch, path)
    f32 = dict(compute_dtype=jnp.float32)
    jprefill = jax.jit(lambda p, t, c: jmodel.forward(jcfg, p, t, cache=c, **f32)[:2])
    jdecode = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t, **f32))
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jprefill(jp, jnp.asarray(tok), jmodel.init_cache(jcfg, 2, 24, dtype=jnp.float32))
    tc = tmodel.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    tl, tc, aux = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tc, paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert aux == 0.0 and tl.shape == (2, 13, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert calls == ([8, None] if path == "flash" else [])
    for step in range(2):
        t1 = rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(t1))
        tl, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(t1), kernel="ref",
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"decode step {step}")
    want = slot_cache_from_jax(jax.tree.map(np.asarray, jc), cfg)
    assert tc["length"] == want["length"] == 15
    for i, (got_l, want_l) in enumerate(zip(tc["layers"], want["layers"])):
        assert set(got_l) == set(want_l) == {"k", "v", "conv", "state"}
        for key in want_l:
            np.testing.assert_allclose(got_l[key].numpy(), want_l[key].numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"layer {i} {key}")
    jl = jax.jit(lambda p, t: jmodel.forward(jcfg, p, t, **f32)[0])(jp, jnp.asarray(tok))
    tl, none, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), paged_kernel="ref",
                                 compute_dtype=torch.float32)
    assert none is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert len(calls) == (4 if path == "flash" else 0)


def test_bf16_unrolled_layers_within_margin(hy):
    """Prefill and two decode steps in bf16 through both packages (the
    smoke's two layers are one unrepeated group: neither package scans
    them); prints the largest difference for ROADMAP's envelopes."""
    jcfg, cfg = hy["jcfg"], hy["cfg"]
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), hy["jparams"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jmodel.forward(
        jcfg, p, t, cache=jmodel.init_cache(jcfg, 2, 24))[:2])(jp, jnp.asarray(tok))
    tc = tmodel.init_cache(cfg, 2, 24, device="cpu")
    tl, tc, _ = tmodel.forward(cfg, tp, torch.from_numpy(tok), cache=tc, paged_kernel="ref")
    worst = float(np.abs(tl.numpy() - np.asarray(jl)).max() / np.abs(np.asarray(jl)).max())
    jdecode = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(2):
        t1 = np.asarray(np.asarray(jl)[:, -1].argmax(-1)[:, None], np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(t1))
        tl, tc = tmodel.decode_step(cfg, tp, tc, torch.from_numpy(t1), kernel="ref")
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()
                                 / np.abs(np.asarray(jl)).max()))
    print(f"[{ARCH} bf16] largest logit difference {worst:.4f} of max |logit|")
    assert worst <= BF16_LOGITS


def test_slots_engine_matches_jax(hy, monkeypatch):
    """``cache="auto"`` (slots): 2 slots of 32 rows, prompts of 4, 7 and 5
    tokens (unaligned: the lockstep length), 4 new each."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, hy["cfg"].vocab_size, size=(n,)).astype(np.int32)
               for n in (4, 7, 5)]
    env = slots_parity_env(hy["jcfg"], hy["cfg"], hy["jparams"], prompts, slots=2,
                           max_len=32)
    slots_engine_parity(env, 4, monkeypatch, cache="auto")


def test_serve_cli_hymba_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu",
                                     "--max-len", "64", "--prompt-len", "20", "--requests",
                                     "3", "--max-new", "4", "--metrics-json"])
    serve.main()
    out = capsys.readouterr().out
    assert "[serve:slots/fifo] 3/3 requests, 12 tokens" in out
    assert '"ssm_scan"' in out and '"flash_attention"' in out

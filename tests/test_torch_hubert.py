"""Port parity: ``hubert-xlarge`` (an audio encoder: frame features through
``frontend_proj``, attention without the causal mask, no rotary
positions, no cache) against the JAX package, at the smoke (2 layers,
d_model 64, 4/4 heads of 16, features of 32, gelu).

* Configs, layer plans, the default backend (the JAX package's answer)
  and the bridge: ``params_from_jax`` carries ``frontend_proj`` bit for
  bit, and ``init_params`` draws it at (feature_dim, d_model).
* The prefill step, the encoder's entry point, against the JAX
  ``forward`` over every frame, float32 (``ATOL``): logits (B, T, V) for
  every frame and no cache. ``path="flash"`` lowers the chunking
  threshold in both packages by monkeypatch (no file changes), so both
  take their flash formulation (the port's plain version of the kernel
  on the CPU, one call a layer, ``causal=False``); ``path="sdpa"`` keeps
  both on plain ``_sdpa`` with no mask. The features move the logits and
  the tokens do not.
* bfloat16: the JAX package scans the smoke's two repeated layers, the
  port unrolls them; the logits differ by rounding, within
  ``BF16_LOGITS`` of the largest |logit|.
* The refusals that mirror the JAX package's: every Engine backend, every
  decode step and the serve CLI refuse an encoder.
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
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import default_cache_backend, get_config, get_smoke
from repro_torch.engine import Engine
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.runtime import steps as tsteps
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ARCH = "hubert-xlarge"
ATOL = 1e-4
BF16_LOGITS = 0.03


@pytest.fixture(scope="module")
def hb():
    jcfg = j_get_smoke(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(7))[0]
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(15)
    feats = rng.standard_normal((2, 13, cfg.frontend.feature_dim)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, feats=feats,
                tparams=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))


def test_config_plan_backend_and_bridge(hb):
    jcfg, cfg = hb["jcfg"], hb["cfg"]
    full, jfull = get_config(ARCH), j_get_config(ARCH)
    assert full.to_json() == jfull.to_json() and cfg.to_json() == jcfg.to_json()
    assert tmodel.layer_plan(full) == jmodel.layer_plan(jfull) == [(("attn_full",), 48)]
    assert tmodel.layer_plan(cfg) == jmodel.layer_plan(jcfg)
    assert default_cache_backend(full) == j_default_cache_backend(jfull)
    p = hb["tparams"]
    assert set(p) == {"embed", "frontend_proj", "head", "final_norm", "layers"}
    np.testing.assert_array_equal(p["frontend_proj"].numpy(),
                                  np.asarray(hb["jparams"]["frontend_proj"]))
    bf = jax.tree.map(lambda t: np.asarray(t.astype(jnp.bfloat16)), hb["jparams"])
    pb = params_from_jax(bf, cfg)
    assert pb["frontend_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pb["frontend_proj"].view(torch.int16).numpy(),
                                  bf["frontend_proj"].view(np.int16))
    fresh = tmodel.init_params(cfg, device="cpu")
    assert set(fresh) == set(p)
    assert tuple(fresh["frontend_proj"].shape) == (32, 64)
    assert float(fresh["frontend_proj"].std()) == pytest.approx(32 ** -0.5, rel=0.15)


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
def test_encoder_prefill_matches_jax(hb, monkeypatch, path):
    jcfg, cfg, jp, tp, feats = hb["jcfg"], hb["cfg"], hb["jparams"], hb["tparams"], hb["feats"]
    calls = _patch_threshold(monkeypatch, path)
    B, T = feats.shape[:2]
    tok = np.zeros((B, T), np.int32)
    jl = jax.jit(lambda p, t, f: jmodel.forward(jcfg, p, t, frontend_feats=f,
                                                compute_dtype=jnp.float32)[0])(
        jp, jnp.asarray(tok), jnp.asarray(feats))
    step = tsteps.make_prefill_step(cfg, max_len=T, kernel="ref", device="cpu",
                                    compute_dtype=torch.float32)
    assert step.meta["kernels"] == ("flash_attention",) and step.meta["kind"] == "prefill"
    tl, cache = step.fn(tp, torch.from_numpy(tok), torch.from_numpy(feats))
    assert cache is None and tl.shape == (B, T, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert calls == ([False] * cfg.num_layers if path == "flash" else [])
    # every frame sees every frame: a change to the last frame moves the first
    moved = feats.copy()
    moved[:, -1] += 1.0
    tm, _ = step.fn(tp, torch.from_numpy(tok), torch.from_numpy(moved))
    assert np.abs(tm.numpy()[:, 0] - tl.numpy()[:, 0]).max() > 1e-3
    # the tokens are not read
    other = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    to, _ = step.fn(tp, torch.from_numpy(other), torch.from_numpy(feats))
    assert torch.equal(to, tl)


def test_bf16_unrolled_layers_within_margin_of_scanned(hb):
    """The JAX forward scans the smoke's two repeated layers, the port
    unrolls them; both in bf16 from the same bf16 weights and features."""
    jcfg, cfg, feats = hb["jcfg"], hb["cfg"], hb["feats"]
    jp = jax.tree.map(lambda t: t.astype(jnp.bfloat16), hb["jparams"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    tok = np.zeros(feats.shape[:2], np.int32)
    jl = np.asarray(jax.jit(lambda p, t, f: jmodel.forward(jcfg, p, t, frontend_feats=f)[0])(
        jp, jnp.asarray(tok), jnp.asarray(feats)))
    step = tsteps.make_prefill_step(cfg, max_len=feats.shape[1], kernel="ref", device="cpu")
    tl, _ = step.fn(tp, torch.from_numpy(tok), torch.from_numpy(feats))
    worst = float(np.abs(tl.numpy() - jl).max() / np.abs(jl).max())
    print(f"[{ARCH} bf16] largest logit difference {worst:.4f} of max |logit|")
    assert worst <= BF16_LOGITS


def test_encoder_refusals_mirror_jax(hb, monkeypatch):
    cfg = hb["cfg"]
    for cache in ("auto", "slots", "paged", "recurrent"):
        with pytest.raises(ValueError, match="encoder-only arch has no decode path"):
            Engine(cfg, device="cpu", cache=cache, slots=2, max_len=16, num_blocks=8)
    geom = dict(slots=2, chunk=4, device="cpu")
    for make in (lambda: tsteps.make_serve_step(cfg, slots=2, device="cpu"),
                 lambda: tsteps.make_recurrent_serve_step(cfg, **geom),
                 lambda: tsteps.make_paged_serve_step(cfg, num_blocks=8, block_size=4,
                                                      max_blocks_per_seq=4, **geom)):
        with pytest.raises(ValueError, match="encoder-only arch has no decode step"):
            make()
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="hubert-xlarge is encoder-only: no decode path"):
        serve.main()

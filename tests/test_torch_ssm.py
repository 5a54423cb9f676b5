"""Port parity: the selective SSM block against ``repro.models.ssm``.

On ``get_smoke("mamba-130m")``'s widths (d_model 64, inner 128, N 4, conv
width 4, dt_rank 4), with one layer's JAX parameters, in float32:

* ``_causal_conv`` with and without per-row ``n_valid`` (0, partial and
  full rows), from a random history: output and new history;
* ``ssm_forward`` without a cache (``valid=None``), from a cache with a
  valid prefix per row, and continuing from the cache the first chunk
  left: output on valid columns, conv history and state.

Tolerance 1e-5 absolute and relative (float32; matmuls and the scan's
sums in other orders; outputs up to ~1). Both caches are built in
float32: JAX's ``ssm_init_cache`` keeps the conv history in bfloat16
unless asked otherwise, and so does the port's (checked here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke as j_get_smoke
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.models.kvcache import SSMCache
from repro_torch.bridge import to_tensor
from repro_torch.configs.registry import get_smoke
from repro_torch.models import ssm as tssm
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 4, 6
N_VALID = np.array([S, 0, 1, 4], np.int32)


@pytest.fixture(scope="module")
def layer():
    jcfg = j_get_smoke("mamba-130m")
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(7))[0]
    np_ssm = jax.tree.map(lambda t: np.asarray(t)[0], jparams["groups"][0][0]["ssm"])
    # a random bias and dt bias so neither term is zero
    rng = np.random.default_rng(0)
    np_ssm["conv_b"] = (rng.standard_normal(np_ssm["conv_b"].shape) * 0.1).astype(np.float32)
    np_ssm["dt_bias"] = (rng.standard_normal(np_ssm["dt_bias"].shape) * 0.5).astype(np.float32)
    tparams = {k: to_tensor(v) for k, v in np_ssm.items()}
    return get_smoke("mamba-130m"), jcfg, np_ssm, tparams


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("with_nv", [False, True])
def test_causal_conv_matches_jax(layer, with_nv):
    cfg, _, p, tp = layer
    x, hist = _x(1, (B, S, 128)), _x(2, (B, 3, 128))
    nv = N_VALID if with_nv else None
    jout, jhist = jssm._causal_conv(jnp.asarray(x), jnp.asarray(p["conv_w"]),
                                    jnp.asarray(p["conv_b"]), jnp.asarray(hist),
                                    n_valid=None if nv is None else jnp.asarray(nv))
    tout, thist = tssm._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
                                    torch.from_numpy(hist),
                                    n_valid=None if nv is None else torch.from_numpy(nv))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), **TOL)
    if with_nv:   # an empty row keeps its history; a full one takes the tail
        np.testing.assert_array_equal(thist[1].numpy(), hist[1])
        np.testing.assert_array_equal(thist[0].numpy(), x[0, -3:])


def test_ssm_forward_without_cache_matches_jax(layer):
    cfg, jcfg, p, tp = layer
    x = _x(3, (B, S, 64))
    jout, jc = jssm.ssm_forward(p, jnp.asarray(x), jcfg.ssm)
    tout, tc = tssm.ssm_forward(tp, torch.from_numpy(x), cfg.ssm, kernel="ref")
    assert jc is None and tc is None
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_ssm_forward_with_valid_prefix_and_continuation_matches_jax(layer):
    cfg, jcfg, p, tp = layer
    jcache = jssm.ssm_init_cache(64, jcfg.ssm, B, dtype=jnp.float32)
    tcache = tssm.ssm_init_cache(64, cfg.ssm, B, dtype=torch.float32)
    assert tcache["conv"].dtype == torch.float32 and tcache["state"].dtype == torch.float32
    for chunk, nv in enumerate((N_VALID, np.array([2, 3, S, 0], np.int32))):
        x = _x(10 + chunk, (B, S, 64))
        valid = np.arange(S)[None, :] < nv[:, None]
        jout, jcache = jssm.ssm_forward(p, jnp.asarray(x), jcfg.ssm, cache=jcache,
                                        valid=jnp.asarray(valid))
        tout, tcache = tssm.ssm_forward(tp, torch.from_numpy(x), cfg.ssm, cache=tcache,
                                        valid=torch.from_numpy(valid), kernel="ref")
        np.testing.assert_allclose(tout.numpy()[valid], np.asarray(jout)[valid],
                                   **TOL, err_msg=f"chunk {chunk}")
        np.testing.assert_allclose(tcache["conv"].numpy(), np.asarray(jcache.conv), **TOL)
        np.testing.assert_allclose(tcache["state"].numpy(), np.asarray(jcache.state),
                                   **TOL)


def test_init_cache_dtypes_match_jax(layer):
    cfg, jcfg, _, _ = layer
    j = jssm.ssm_init_cache(64, jcfg.ssm, 2)
    t = tssm.ssm_init_cache(64, cfg.ssm, 2)
    assert isinstance(j, SSMCache)
    for key, jt in (("conv", j.conv), ("state", j.state)):
        assert tuple(t[key].shape) == jt.shape
        assert str(t[key].dtype).split(".")[-1] == str(jt.dtype)
        assert not t[key].any()

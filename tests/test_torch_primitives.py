"""Port parity: model primitives of ``repro_torch.models`` against the JAX
package's ``repro.models`` at float32 on the CPU.

Inputs come from numpy seeds and go to both packages. Tolerance: atol 1e-5
(float32; the two frameworks sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import rope as trope
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

ATOL = 1e-5


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1, 16)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    scale = rng.normal(size=shape[-1:]).astype(np.float32) * 0.1
    want = np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rms_norm_scales_by_one_plus_scale():
    """Zero scale leaves the normalized input unscaled (the 1 + scale rule)."""
    x = torch.tensor([[3.0, 4.0]])
    out = tcommon.rms_norm(x, torch.zeros(2), eps=0.0)
    np.testing.assert_allclose(out.numpy(), [[3 / 12.5 ** 0.5, 4 / 12.5 ** 0.5]],
                               atol=1e-6)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.25])
def test_apply_rope_matches_jax(rotary_pct):
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 8, 3, 64
    x = rng.normal(size=(B, S, H, D)).astype(np.float32)
    pos = rng.integers(0, 1025, size=(B, S)).astype(np.int32)
    pos[0, -1] = 1024
    want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0,
                                       rotary_pct))
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0,
                           rotary_pct).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_mlp_matches_jax(act, gated):
    rng = np.random.default_rng(2)
    d, f = 32, 48
    x = rng.normal(size=(2, 3, d)).astype(np.float32)
    params = {"w_up": rng.normal(size=(d, f)).astype(np.float32) / d ** 0.5,
              "w_down": rng.normal(size=(f, d)).astype(np.float32) / f ** 0.5}
    if gated:
        params["w_gate"] = rng.normal(size=(d, f)).astype(np.float32) / d ** 0.5
    want = np.asarray(jmlp.mlp({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(x), act, gated))
    got = tmlp.mlp({k: torch.from_numpy(v) for k, v in params.items()},
                   torch.from_numpy(x), act, gated).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_softcap_matches_jax():
    x = np.linspace(-80, 80, 33).astype(np.float32)
    for cap in (0.0, 30.0):
        want = np.asarray(jcommon.softcap(jnp.asarray(x), cap))
        got = tcommon.softcap(torch.from_numpy(x), cap).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)

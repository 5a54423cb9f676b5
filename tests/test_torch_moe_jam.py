"""Port parity: the moe_jam expert FFN's plain version against the JAX package's.

``repro_torch.kernels.moe_jam.moe_jam_ffn_ref`` (what the CPU path runs,
and what the CUDA kernel is held against on the card) against JAX's
``expert_ffn_ref`` and against the Pallas kernel ``moe_jam_ffn`` in
interpret mode, with block_c 8 / block_f 32 so the Pallas grid has several
capacity tiles and accumulates over F. Uneven shapes (C = 24, F = 96, and
C = 40 with F = 32, the engine's capacity at the smoke width), and the
edges of the CUDA kernel's tiles: C = 65 and 130 (past one and two 64-row
M tiles), D and F = 96 and 160 (multiples of 32, not of 64 or 128), one
expert; with counts that end inside, at and past a 64-row tile, against
JAX's ref on the bucket with the empty rows zeroed.

All three compute the same function: gate and up accumulate in float32,
``h`` is rounded to ``x.dtype`` once, the down product accumulates in
float32, the output is ``x.dtype``. Tolerances: float32 atol 1e-5
(outputs ~0.6 rms; summation order only: 7e-7 seen). bfloat16: the sums
are the same float32 sums of exact bf16 products in other orders, so ``h``
or the output may round to the neighbouring bf16 value: atol = rtol =
1e-2, one bf16 ulp of an output up to 2 in magnitude (2^-7 = 7.8e-3); one
ulp (3.9e-3) is seen.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_jam import moe_jam_ffn as j_moe_jam_ffn
from repro.kernels.moe_jam.ref import expert_ffn_ref as j_ref
from repro_torch.kernels.moe_jam import (LAUNCHES, moe_jam_ffn, moe_jam_ffn_cuda,
                                         moe_jam_ffn_ref)
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
SHAPES = [(3, 24, 64, 96), (4, 40, 64, 32)]
EDGE_SHAPES = [(2, 65, 64, 32), (2, 130, 32, 64), (3, 8, 96, 160), (2, 16, 160, 96),
               (1, 24, 64, 96)]


def _inputs(e, c, d, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, c, d)).astype(np.float32)
    wg = (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32)
    return x, wg, wu, wd


def _both(arrays, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
def test_plain_version_matches_jax_ref(shape, act, dtype):
    j_args, t_args = _both(_inputs(*shape), dtype)
    want = np.asarray(j_ref(*j_args, act), np.float32)
    got = moe_jam_ffn_ref(*t_args, act)
    assert tuple(got.shape) == shape[:3] and got.dtype == t_args[0].dtype
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_plain_version_matches_pallas_interpret(act, dtype):
    shape = SHAPES[0]
    j_args, t_args = _both(_inputs(*shape, seed=1), dtype)
    want = np.asarray(j_moe_jam_ffn(*j_args, act, block_c=8, block_f=32,
                                    interpret=True), np.float32)
    got = moe_jam_ffn_ref(*t_args, act)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("shape", [(4, 65, 64, 32), (4, 130, 96, 160), (1, 70, 160, 96)])
def test_counts_at_tile_edges_match_jax_ref(shape, act):
    """Kept rows ending inside a 64-row tile, at its edge and one past it:
    the plain version with counts equals JAX's ref on the bucket whose
    empty rows are zero, as the dispatch leaves them."""
    e, c, _, _ = shape
    x, wg, wu, wd = _inputs(*shape, seed=4)
    counts = np.array([0, 64, 65, c - 1][:e] if e > 1 else [c - 6], np.int32)
    x *= (np.arange(c)[None, :] < counts[:, None])[:, :, None]
    j_args, t_args = _both((x, wg, wu, wd), "float32")
    want = np.asarray(j_ref(*j_args, act), np.float32)
    got = moe_jam_ffn_ref(*t_args, act, counts=torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, **TOL["float32"])
    assert not got.numpy()[np.arange(c)[None, :] >= counts[:, None]].any()


def test_counts_zero_the_empty_rows():
    """Rows at or past ``counts[e]`` are zeros; on a bucket whose empty rows
    are zero (as the dispatch builds it) that changes nothing."""
    x, wg, wu, wd = (torch.from_numpy(a) for a in _inputs(4, 24, 64, 32, seed=2))
    counts = torch.tensor([0, 5, 24, 17], dtype=torch.int32)
    rows = torch.arange(24)[None, :, None] < counts[:, None, None].long()
    y = moe_jam_ffn_ref(x, wg, wu, wd, counts=counts)
    assert (y[~rows.expand_as(y)] == 0).all()
    full = moe_jam_ffn_ref(x, wg, wu, wd)
    torch.testing.assert_close(y[rows.expand_as(y)], full[rows.expand_as(full)],
                               atol=0, rtol=0)
    torch.testing.assert_close(moe_jam_ffn_ref(x * rows, wg, wu, wd, counts=counts),
                               moe_jam_ffn_ref(x * rows, wg, wu, wd), atol=0, rtol=0)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    x, wg, wu, wd = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(2, 8, 32, 32))
    before = LAUNCHES.count
    torch.testing.assert_close(moe_jam_ffn(x, wg, wu, wd, "gelu"),
                               moe_jam_ffn_ref(x, wg, wu, wd, "gelu"), atol=0, rtol=0)
    assert LAUNCHES.count == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        moe_jam_ffn(x, wg, wu, wd, kernel="cuda")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        moe_jam_ffn_cuda(x, wg, wu, wd)
    with pytest.raises(ValueError, match="kernel must be one of"):
        moe_jam_ffn(x, wg, wu, wd, kernel="pallas")
    assert LAUNCHES.count == before


def test_loader_names_each_build_by_its_source_and_flags(tmp_path, monkeypatch):
    """Both kernels build through ``kernels.loader``: one library per source
    hash under ``build/kernels/``; without ``nvcc`` a build raises (it is
    never skipped or replaced by the plain version)."""
    from repro_torch.kernels import loader
    from repro_torch.kernels.moe_jam import kernel as mj_kernel
    from repro_torch.kernels.paged_attention import kernel as pa_kernel

    libs = [loader.library_path(k.SOURCE) for k in (pa_kernel, mj_kernel)]
    assert [p.parent for p in libs] == [loader.BUILD_DIR] * 2
    assert [p.name.split("-")[0] for p in libs] == ["paged_attention", "moe_jam"]
    assert libs[0] != libs[1] and all(len(p.stem.split("-")[1]) == 16 for p in libs)
    src = tmp_path / "k.cu"
    src.write_text("// not built")
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(loader.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        loader.build_all([src])

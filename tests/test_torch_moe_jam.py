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

The backward's plain version, ``moe_jam_ffn_bwd_ref`` (the formula of the
backward kernel and its yardstick on the card), against autograd through
``moe_jam_ffn_ref`` in float32 (within ``BWD_REL`` of each gradient's max
|g|: the same float32 products, summed in other orders) and against
``jax.grad`` of JAX's ``expert_ffn_ref`` on the same numpy inputs (within
``GRAD_TOL``), silu and gelu, with counts that leave empty rows and one
empty expert; the wrapper under grad on the CPU takes the plain version,
which autograd differentiates.

Around the CUDA kernels, on the CPU: both moe_jam sources include
``csrc/moe_jam.cuh``, so an edit of it renames both builds; the backward's
per-pass work (``bench.needed_bwd_work``) adds up to the whole. The CUDA
kernels themselves are held against the plain versions on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_jam import moe_jam_ffn as j_moe_jam_ffn
from repro.kernels.moe_jam.ref import expert_ffn_ref as j_ref
from repro_torch.kernels.moe_jam import (BWD_LAUNCHES, LAUNCHES, MoeJamFn, moe_jam_ffn,
                                         moe_jam_ffn_bwd_cuda, moe_jam_ffn_bwd_ref,
                                         moe_jam_ffn_cuda, moe_jam_ffn_ref)
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
SHAPES = [(3, 24, 64, 96), (4, 40, 64, 32)]
EDGE_SHAPES = [(2, 65, 64, 32), (2, 130, 32, 64), (3, 8, 96, 160), (2, 16, 160, 96),
               (1, 24, 64, 96)]
# the backward: float32 products in other orders (BWD_REL, against autograd
# through the port's plain version; GRAD_TOL, against jax.grad), relative to
# each gradient's max |g| (~0.1-10 here)
BWD_REL, GRAD_TOL = 1e-5, 1e-4
# 4 experts of 40 rows, D 64, F 96: one empty expert, rows ending inside,
# at and short of the capacity
BWD_SHAPE, BWD_COUNTS = (4, 40, 64, 96), np.array([0, 17, 40, 33], np.int32)


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


def test_a_shared_header_renames_both_moe_jam_builds(tmp_path):
    """The forward and the backward include ``csrc/moe_jam.cuh``: the loader
    hashes the headers beside a source into its library's name, so a change
    to the header renames both builds (and to one source only that one)."""
    import shutil

    from repro_torch.kernels import loader
    from repro_torch.kernels.moe_jam import kernel as mj_kernel

    csrc = mj_kernel.SOURCE.parent
    assert mj_kernel.BWD_SOURCE.parent == csrc
    for src in (mj_kernel.SOURCE, mj_kernel.BWD_SOURCE):
        assert '#include "moe_jam.cuh"' in src.read_text()
    for f in csrc.iterdir():
        shutil.copy(f, tmp_path / f.name)
    fwd, bwd = tmp_path / mj_kernel.SOURCE.name, tmp_path / mj_kernel.BWD_SOURCE.name
    names = lambda: (loader.library_path(fwd).name, loader.library_path(bwd).name)  # noqa: E731
    first = names()
    assert first == (loader.library_path(mj_kernel.SOURCE).name,
                     loader.library_path(mj_kernel.BWD_SOURCE).name)
    header = tmp_path / "moe_jam.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = names()
    assert second[0] != first[0] and second[1] != first[1]
    bwd.write_text(bwd.read_text() + "\n// edited\n")
    third = names()
    assert third[0] == second[0] and third[1] != second[1]


def test_bwd_passes_add_up_to_the_whole_at_olmoe_train_buckets():
    """``bench.needed_bwd_work``'s passes (act three products, dx two, dw
    three) sum to the whole backward's flops, and their bytes to the
    whole's plus what passes between them (h, dG, dU written once and read
    by dx and dw, w_gate / w_up read again by dx, x / dy again by dw, the
    counts by each), on olmoe-1b-7b's training buckets."""
    from repro_torch.kernels.moe_jam import bench as mbench

    e, d, f, k, tokens, c = mbench.TRAIN["olmoe-1b-7b train"]
    counts = mbench.train_counts(tokens, e, k, c)
    work = mbench.needed_bwd_work(counts, capacity=c, d_model=d, d_ff=f)
    passes = work["passes"]
    assert set(passes) == set(mbench.BWD_PASSES)
    rows, busy = int(counts.sum()), int((counts > 0).sum())
    product = 2 * rows * d * f
    assert [passes[p]["flops"] for p in ("act", "dx", "dw")] == [3 * product, 2 * product,
                                                                 3 * product]
    assert sum(w["flops"] for w in passes.values()) == work["flops"] == 8 * product
    between = (3 + 2 + 3) * rows * f * 2 + busy * 2 * d * f * 2 + 2 * rows * d * 2 + 2 * 4 * e
    assert sum(w["bytes"] for w in passes.values()) == work["bytes"] + between


def _bwd_case(act_seed=0):
    """(x with rows past BWD_COUNTS zeroed, as the dispatch leaves them,
    weights, dy over every row, the kept-row mask) in float32."""
    x, wg, wu, wd = _inputs(*BWD_SHAPE, seed=5 + act_seed)
    c = BWD_SHAPE[1]
    kept = (np.arange(c)[None, :] < BWD_COUNTS[:, None])[:, :, None]
    dy = np.random.default_rng(6 + act_seed).normal(size=BWD_SHAPE[:3]).astype(np.float32)
    return x * kept, wg, wu, wd, dy, kept


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bwd_ref_matches_autograd_through_the_plain_version(act):
    """Float32: the four gradients equal autograd's through
    ``moe_jam_ffn_ref`` (counts given, dy over every row); dx past counts
    and the empty expert's weight gradients are exact zeros; NaN in x and
    dy past counts changes no bit."""
    x, wg, wu, wd, dy, kept = _bwd_case()
    counts = torch.from_numpy(BWD_COUNTS)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, wg, wu, wd)]
    want = torch.autograd.grad(moe_jam_ffn_ref(*ins, act, counts=counts), ins,
                               torch.from_numpy(dy))
    got = moe_jam_ffn_bwd_ref(*(torch.from_numpy(a) for a in (x, wg, wu, wd, dy)), act,
                              counts=counts)
    for name, g, w in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= BWD_REL, (name, err)
    assert not got[0].numpy()[~kept[..., 0]].any()
    assert all(not w[0].any() for w in got[1:])                  # expert 0 is empty
    nan = np.where(kept, 0.0, np.nan).astype(np.float32)
    again = moe_jam_ffn_bwd_ref(*(torch.from_numpy(a) for a in (x + nan, wg, wu, wd, dy + nan)),
                                act, counts=counts)
    for a, b in zip(again, got):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_expert_grad(act):
    """jax.grad of <expert_ffn_ref(x, w...), dy> over x and the weights,
    jitted once per act."""
    def loss(x, wg, wu, wd, dy):
        return jnp.sum(j_ref(x, wg, wu, wd, act) * dy)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bwd_ref_matches_jax_grad(act):
    """Float32, the same numpy inputs: ``moe_jam_ffn_bwd_ref`` with counts
    (dy over every row) against ``jax.grad`` of JAX's ``expert_ffn_ref`` on
    the bucket whose empty rows are zero, with dy zero there too (the rows
    the kernel's output holds as constant zeros)."""
    x, wg, wu, wd, dy, kept = _bwd_case(1)
    want = _jax_expert_grad(act)(*(jnp.asarray(a) for a in (x, wg, wu, wd, dy * kept)))
    got = moe_jam_ffn_bwd_ref(*(torch.from_numpy(a) for a in (x, wg, wu, wd, dy)), act,
                              counts=torch.from_numpy(BWD_COUNTS))
    for name, g, w in zip(("dx", "dw_gate", "dw_up", "dw_down"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL, (name, err)


def test_wrapper_under_grad_takes_the_plain_version_on_cpu(monkeypatch):
    """On CPU tensors under grad, ``moe_jam_ffn`` runs the plain version and
    autograd differentiates it (``MoeJamFn`` is the card's route); the
    gradients equal ``moe_jam_ffn_bwd_ref``'s, and no kernel counts. The
    backward kernel's wrapper refuses CPU tensors."""
    def card_only(*args):
        raise AssertionError("MoeJamFn ran on CPU tensors")

    monkeypatch.setattr(MoeJamFn, "apply", card_only)
    x, wg, wu, wd, dy, _ = _bwd_case(2)
    counts = torch.from_numpy(BWD_COUNTS)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, wg, wu, wd)]
    before = (LAUNCHES.count, BWD_LAUNCHES.count)
    out = moe_jam_ffn(*ins, "silu", counts=counts)
    got = torch.autograd.grad(out, ins, torch.from_numpy(dy))
    want = moe_jam_ffn_bwd_ref(*(t.detach() for t in ins), torch.from_numpy(dy), "silu",
                               counts=counts)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= BWD_REL
    assert (LAUNCHES.count, BWD_LAUNCHES.count) == before
    bf = [t.detach().to(torch.bfloat16) for t in ins]
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        moe_jam_ffn_bwd_cuda(*bf, torch.from_numpy(dy).to(torch.bfloat16))

"""Port parity: paged attention and the paged pool write.

* the plain version (``repro_torch...paged_attention_ref``) against the JAX
  oracle (``repro.kernels.paged_attention.ref``) over table holes, block
  reuse, n_valid in {0, 1, C}, window on/off, block sizes 4/8/16 and group
  sizes 1/2/4, compared on valid columns only (columns >= n_valid are
  garbage by contract);
* the plain version's masking of table entries that name no pool block
  (-1 and ids past the pool) inside a live range, against a direct numpy
  softmax over the keys each column sees;
* ``PagedKVCache.write`` against the JAX write, exactly, dropped columns
  included;
* ``resolve_kernel``, the launch counter on the CPU, the bytes model and
  ``compare_valid`` (the kernel check's comparison);
* the CUDA kernel's split-K form in plain PyTorch
  (``paged_attention_split_ref``: per-split partials merged by the
  log-sum-exp rule) against the plain version (float32) and the JAX oracle
  (bf16) over the same grid, rows spread over many splits, windows whose
  lower edge falls inside a split, splits of only masked or past-the-end
  keys and table holes; what it gives a column that sees no key; and
  ``split_plan``, the cut of a table into splits that the wrapper uses.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.

Tolerances: float32 atol 1e-5 (summation order); bfloat16 atol/rtol 2e-2
(both paths round the probabilities to bf16 before P.V, at different
places in the two frameworks, and the output is bf16: ~2^-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import modeled_hbm_bytes as j_modeled
from repro.kernels.paged_attention.ref import paged_attention_ref as j_ref
from repro.models.kvcache import PagedKVCache as JPagedKVCache
from repro.models.kvcache import PagedLayout as JPagedLayout
from repro_torch.bridge import to_tensor
from repro_torch.kernels.paged_attention import (LAUNCHES, compare_valid,
                                                 modeled_hbm_bytes,
                                                 paged_attention,
                                                 paged_attention_cuda,
                                                 paged_attention_ref,
                                                 paged_attention_split_ref,
                                                 resolve_kernel, split_plan)
from repro_torch.models.kvcache import PagedKVCache, PagedLayout
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

F32_TOL = dict(atol=1e-5, rtol=0)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _case(rng, *, bs, B, C, K, G, D, M, n_valid_choices=(0, 1, None), holes=True):
    """Random paged-attention inputs (numpy): pool blocks may be shared by
    several rows (reuse: stale rows past seq_end), tables hold -1 past each
    row's live blocks, starts range from 0 to deep into the table."""
    N = B * M + 2
    H = K * G
    q = rng.normal(size=(B, C, H, D)).astype(np.float32) * 0.5
    k_pool = rng.normal(size=(N, bs, K, D)).astype(np.float32) * 0.5
    v_pool = rng.normal(size=(N, bs, K, D)).astype(np.float32) * 0.5
    tables = rng.integers(0, N, size=(B, M)).astype(np.int32)
    n_valid = np.asarray([int(rng.choice([c if c is not None else C
                                          for c in n_valid_choices]))
                          for _ in range(B)], np.int32)
    starts = np.asarray([int(rng.integers(0, M * bs - C + 1)) for _ in range(B)],
                        np.int32)
    starts[0] = 0
    if holes:
        for b in range(B):
            live = -(-(starts[b] + n_valid[b]) // bs)
            tables[b, live:] = -1
    return q, k_pool, v_pool, tables, starts, n_valid


def _valid(y, n_valid):
    y = np.asarray(y, np.float32)
    mask = np.arange(y.shape[1])[None, :] < np.asarray(n_valid)[:, None]
    return np.where(mask[:, :, None, None], y, 0.0)


def _both(args, dtype, **kw):
    q, kp, vp, tb, st, nv = args
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = j_ref(jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
                 jnp.asarray(tb), jnp.asarray(st), jnp.asarray(nv), **kw)
    got = paged_attention_ref(torch.from_numpy(q).to(td), torch.from_numpy(kp).to(td),
                              torch.from_numpy(vp).to(td), torch.from_numpy(tb),
                              torch.from_numpy(st), torch.from_numpy(nv), **kw)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    return (_valid(got.float().numpy(), nv),
            _valid(np.asarray(want.astype(jnp.float32)), nv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_plain_version_matches_jax_ref(bs, G, window, dtype):
    rng = np.random.default_rng(1000 * bs + 10 * G + (window or 0))
    args = _case(rng, bs=bs, B=4, C=4, K=2, G=G, D=16, M=4)
    got, want = _both(args, dtype, block_size=bs, window=window)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_plain_version_deep_decode_with_window():
    """Decode deep into a sequence with small windows: most live blocks
    precede the window."""
    rng = np.random.default_rng(13)
    q, kp, vp, tb, _, _ = _case(rng, bs=8, B=2, C=1, K=2, G=2, D=16, M=6, holes=False)
    st = np.asarray([47, 46], np.int32)
    nv = np.ones(2, np.int32)
    for window in (5, 8, 19):
        got, want = _both((q, kp, vp, tb, st, nv), "float32", block_size=8,
                          window=window)
        np.testing.assert_allclose(got, want, **F32_TOL)


def _dense_oracle(q, kp, vp, tables, starts, n_valid, bs, window):
    """Softmax over exactly the keys each valid column sees: causal,
    windowed, and held by a table entry that names a pool block."""
    B, C, H, D = q.shape
    N, _, K, _ = kp.shape
    out = np.zeros_like(q)
    for b in range(B):
        for c in range(n_valid[b]):
            qp = starts[b] + c
            lo = 0 if window is None else max(0, qp - window + 1)
            pos = np.asarray([p for p in range(lo, qp + 1)
                              if 0 <= tables[b, p // bs] < N])
            blk = tables[b, pos // bs]
            for h in range(H):
                k = kp[blk, pos % bs, h // (H // K)]
                v = vp[blk, pos % bs, h // (H // K)]
                s = k @ q[b, c, h] / np.sqrt(D)
                p = np.exp(s - s.max())
                out[b, c, h] = (p / p.sum()) @ v
    return out


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("G", [1, 2])
def test_plain_version_masks_entries_that_name_no_block(G, window):
    """Inside a row's live range, a -1 entry and an id past the pool are
    both masked (the CUDA kernel masks them the same way) and read
    nothing out of range; every valid column still sees its own key."""
    rng = np.random.default_rng(31 + G)
    q, kp, vp, tb, st, nv = _case(rng, bs=4, B=3, C=4, K=2, G=G, D=16, M=6,
                                  n_valid_choices=(1, None), holes=False)
    N = kp.shape[0]
    st[:] = [12, 9, 16]
    for b in range(3):
        tb[b, -(-int(st[b] + nv[b]) // 4):] = -1
    tb[0, 1], tb[1, 0], tb[2, 2], tb[2, 3] = -1, N, N + 7, -1
    got = paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, tb, st, nv)),
                              block_size=4, window=window)
    want = _dense_oracle(q, kp, vp, tb, st, nv, 4, window)
    np.testing.assert_allclose(_valid(got.numpy(), nv), _valid(want, nv), **F32_TOL)


def _write_case(rng):
    B, C, K, D, bs, M, N = 3, 4, 2, 8, 4, 3, 9
    k_new = rng.normal(size=(B, C, K, D)).astype(np.float32)
    v_new = rng.normal(size=(B, C, K, D)).astype(np.float32)
    pool_k = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    pool_v = rng.normal(size=(N, bs, K, D)).astype(np.float32)
    # row 0: prefill across a block edge; row 1: decode into a table hole
    # (dropped); row 2: idle (all dropped); distinct destination rows
    tables = np.asarray([[4, 2, -1], [7, -1, -1], [0, 1, 3]], np.int32)
    starts = np.asarray([2, 4, 5], np.int32)
    n_valid = np.asarray([4, 1, 0], np.int32)
    return k_new, v_new, pool_k, pool_v, tables, starts, n_valid, bs


def test_pool_write_matches_jax_exactly():
    k_new, v_new, pool_k, pool_v, tables, starts, n_valid, bs = _write_case(
        np.random.default_rng(5))
    jl = JPagedLayout(jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(n_valid), bs)
    want = JPagedKVCache(jnp.asarray(pool_k), jnp.asarray(pool_v), bs).write(
        jnp.asarray(k_new), jnp.asarray(v_new), jl)
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    tl = PagedLayout(torch.from_numpy(tables), torch.from_numpy(starts),
                     torch.from_numpy(n_valid), bs)
    got = PagedKVCache(tk, tv, bs).write(torch.from_numpy(k_new),
                                         torch.from_numpy(v_new), tl)
    assert got.k_pool is tk                     # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want.k_pool))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want.v_pool))
    # exactly 4 + 0 + 0 rows changed: the hole and the idle row were dropped
    changed = (tk.numpy() != pool_k).any(axis=(2, 3)).sum()
    assert changed == 4


def test_pool_write_keeps_dtype_and_bf16_bits():
    k_new, v_new, pool_k, pool_v, tables, starts, n_valid, bs = _write_case(
        np.random.default_rng(6))
    jl = JPagedLayout(jnp.asarray(tables), jnp.asarray(starts), jnp.asarray(n_valid), bs)
    want = JPagedKVCache(jnp.asarray(pool_k, jnp.bfloat16),
                         jnp.asarray(pool_v, jnp.bfloat16), bs).write(
        jnp.asarray(k_new), jnp.asarray(v_new), jl)
    tk = to_tensor(np.asarray(jnp.asarray(pool_k, jnp.bfloat16)))
    tv = to_tensor(np.asarray(jnp.asarray(pool_v, jnp.bfloat16)))
    tl = PagedLayout(torch.from_numpy(tables), torch.from_numpy(starts),
                     torch.from_numpy(n_valid), bs)
    PagedKVCache(tk, tv, bs).write(torch.from_numpy(k_new), torch.from_numpy(v_new), tl)
    assert tk.dtype == torch.bfloat16
    np.testing.assert_array_equal(tk.view(torch.int16).numpy(),
                                  np.asarray(want.k_pool).view(np.int16))
    np.testing.assert_array_equal(tv.view(torch.int16).numpy(),
                                  np.asarray(want.v_pool).view(np.int16))


def test_resolve_kernel():
    assert resolve_kernel("auto", "cpu") == "ref"
    assert resolve_kernel("ref", "cpu") == "ref"
    assert resolve_kernel("auto", torch.device("cuda")) == "cuda"
    assert resolve_kernel("cuda", "cuda:0") == "cuda"
    assert resolve_kernel("ref", "cuda") == "ref"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        resolve_kernel("cuda", "cpu")
    with pytest.raises(ValueError, match="kernel must be one of"):
        resolve_kernel("pallas", "cpu")


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(9)
    q, kp, vp, tb, st, nv = (torch.from_numpy(a) for a in
                             _case(rng, bs=4, B=2, C=2, K=1, G=2, D=8, M=3))
    before = LAUNCHES.count
    got = paged_attention(q, kp, vp, tb, st, nv, block_size=4)
    want = paged_attention_ref(q, kp, vp, tb, st, nv, block_size=4)
    assert torch.equal(got, want)
    assert LAUNCHES.count == before
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        paged_attention_cuda(q, kp, vp, tb, st, nv, block_size=4)
    assert LAUNCHES.count == before


def test_split_override_takes_cuda_tensors_only():
    """The launcher behind the bench's split sweep has no plain version
    either: on CPU tensors it raises and counts no launch."""
    from repro_torch.kernels.paged_attention import kernel

    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in _case(rng, bs=4, B=2, C=2, K=1, G=2, D=8, M=3)]
    args[0] = args[0].bfloat16()
    before = LAUNCHES.count
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernel._launch(*args, 4, None, None, 4)
    assert LAUNCHES.count == before


def test_modeled_bytes_match_jax():
    """The plain path's model is the JAX one; the CUDA kernel reads each
    live position's row, up to seq_end, where the TPU kernel reads whole
    blocks: equal on block-aligned lengths, never more."""
    kw = dict(block_size=8, max_blocks=8, kv_heads=2, head_dim=64)
    row = 2 * 64 * 2 * 2
    for lens in ([1, 9, 64], [16] * 4, [0, 3]):
        assert modeled_hbm_bytes(lens, kernel="ref", **kw) == j_modeled(lens, kernel="ref", **kw)
        cuda = modeled_hbm_bytes(lens, kernel="cuda", **kw)
        assert cuda == sum(lens) * row <= j_modeled(lens, kernel="pallas", **kw)
    assert (modeled_hbm_bytes([16, 64], kernel="cuda", **kw)
            == j_modeled([16, 64], kernel="pallas", **kw))


def test_compare_valid_scales_with_each_row():
    """The kernel check's comparison: garbage columns are ignored, a long
    row's small output is held to its own scale, and NaN always fails."""
    ref = torch.full((1, 2, 1, 4), 0.05)
    ref[0, 1] = 3.0                              # garbage column
    out = ref.clone()
    out[0, 1] = -7.0
    assert compare_valid(out, ref, torch.tensor([1]))[2] == 0
    out[0, 0, 0, 0] += 5e-3                      # ~ a skipped key tile; passes atol 2e-2
    err, worst, bad = compare_valid(out, ref, torch.tensor([1]))
    assert bad == 1 and worst > 2 and abs(err - 5e-3) < 1e-6
    out[0, 0, 0, 0] = float("nan")
    assert compare_valid(out, ref, torch.tensor([1]))[2] == 1


# ---------------------------------------------------------------------------
# the split-K form of the CUDA kernel
# ---------------------------------------------------------------------------

def _split_vs(args, dtype, kps, oracle="plain", **kw):
    """(split form, plain version) or (split form, JAX oracle) in
    ``dtype``, on valid columns."""
    q, kp, vp, tb, st, nv = args
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    t = [torch.from_numpy(a) for a in args]
    for i in range(3):
        t[i] = t[i].to(td)
    got = paged_attention_split_ref(*t, keys_per_split=kps, **kw)
    assert got.dtype == td and tuple(got.shape) == q.shape
    if oracle == "plain":
        want = paged_attention_ref(*t, **kw).float().numpy()
    else:
        want = _both(args, dtype, **kw)[1]
    return _valid(got.float().numpy(), nv), _valid(want, nv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("bs", [4, 8, 16])
def test_split_form_matches_plain_version_and_jax(bs, G, window, dtype):
    """The plain grid with one block a split (4 splits) and with the
    default plan (one split at these widths)."""
    rng = np.random.default_rng(1000 * bs + 10 * G + (window or 0))
    args = _case(rng, bs=bs, B=4, C=4, K=2, G=G, D=16, M=4)
    for kps in (bs, None):
        got, want = _split_vs(args, dtype, kps, "plain" if dtype == "float32" else "jax",
                              block_size=bs, window=window)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def _long_case(seed, *, holes=True):
    """Rows spread over a table of 64 keys: deep prefill chunks, decode
    rows, an idle row, and (``holes``) table entries that name no pool
    block (-1, ids past the pool) inside the live ranges before each
    chunk."""
    rng = np.random.default_rng(seed)
    q, kp, vp, tb, _, _ = _case(rng, bs=4, B=4, C=5, K=2, G=2, D=16, M=16, holes=False)
    N = kp.shape[0]
    st = np.asarray([40, 59, 13, 0], np.int32)
    nv = np.asarray([5, 1, 0, 5], np.int32)
    for b in range(4):
        tb[b, -(-int(st[b] + nv[b]) // 4):] = -1
    if holes:
        tb[0, 3], tb[0, 8], tb[1, 5], tb[1, 13] = -1, N, N + 3, -1
    return q, kp, vp, tb, st, nv


@pytest.mark.parametrize("dtype,oracle", [("float32", "plain"), ("bfloat16", "plain"),
                                          ("bfloat16", "jax")])
@pytest.mark.parametrize("window", [None, 11, 22])
@pytest.mark.parametrize("kps", [4, 8, 12])
def test_split_form_over_many_splits(kps, window, dtype, oracle):
    """M * bs = 64 keys in 6 to 16 splits; with a window, the splits below
    its lower edge hold only masked keys (or none of the live range);
    splits past each row's end are empty. Against the plain version with
    table holes inside the live ranges; against the JAX oracle, which
    reads the clamped block at a hole, without them."""
    args = _long_case(77 + kps, holes=oracle == "plain")
    assert split_plan(16, 4, kps).n_splits >= 64 // 12
    got, want = _split_vs(args, dtype, kps, oracle, block_size=4, window=window)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_split_form_does_not_depend_on_the_cut():
    """One split, 2, 4 and 16 splits of the same float32 input agree."""
    args = [torch.from_numpy(a) for a in _long_case(5)]
    outs = [paged_attention_split_ref(*args, block_size=4, window=9, keys_per_split=kps)
            for kps in (64, 32, 16, 4)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), **F32_TOL)


def test_split_form_row_that_sees_no_key():
    """A column whose own key lies in a table hole and whose window (1)
    reaches no other key: every key of its live range scores -2^30, so it
    gets the mean of the live range's V rows, the hole's counting as zero;
    the splits that hold only masked keys merge with equal weight. Its
    neighbour column sees its own key; columns >= n_valid are zeros."""
    rng = np.random.default_rng(3)
    q, kp, vp, tb, _, _ = _case(rng, bs=4, B=1, C=3, K=1, G=1, D=8, M=8, holes=False)
    st = np.asarray([9], np.int32)
    nv = np.asarray([2], np.int32)
    tb[0, 2] = -1                              # positions 8..11: the column at 9
    tb[0, 3:] = -1
    args = [torch.from_numpy(a) for a in (q, kp, vp, tb, st, nv)]
    for kps in (4, 8, 32):
        got = paged_attention_split_ref(*args, block_size=4, window=1, keys_per_split=kps)
        # window 1 at start 9: the live range starts at block 2 (position 8)
        live = [8, 9, 10]                        # seq_end 11
        rows = [kp.shape[1] * tb[0, p // 4] + p % 4 if tb[0, p // 4] >= 0 else None
                for p in live]
        v = vp.reshape(-1, 1, 8)
        mean = sum(v[r, 0] for r in rows if r is not None) / len(live)
        np.testing.assert_allclose(got[0, 0, 0].numpy(), mean, atol=1e-6)
        assert (got[0, 2] == 0).all()
    ref = paged_attention_ref(*args, block_size=4, window=1)
    assert not np.allclose(ref[0, 0, 0].numpy(), got[0, 0, 0].numpy())


def test_split_plan():
    # the engine's table: 64 blocks of 16 -> 8 splits of 128 keys
    assert split_plan(64, 16) == (128, 8)
    # narrower than one split: one split, which the kernel writes directly
    assert split_plan(4, 16) == (128, 1)
    assert split_plan(3, 5) == (130, 1)
    # whole blocks of about 128 keys for other block sizes
    assert split_plan(64, 5) == (130, 3)
    # wide tables: at most 32 splits, of whole blocks
    kps, n = split_plan(1000, 16)
    assert n <= 32 and kps % 16 == 0 and (n - 1) * kps < 16000 <= n * kps
    assert split_plan(64, 16, 32) == (32, 32)
    with pytest.raises(ValueError, match="more than 32 splits"):
        split_plan(64, 16, 16)

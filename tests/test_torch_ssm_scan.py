"""Port parity: the selective scan's plain version against the JAX package's.

``repro_torch.kernels.ssm_scan.ssm_scan_ref`` (what the CPU path runs, and
what the CUDA kernel is held against on the card; a prefix composition of
the columns' maps) against the same recurrence a column at a time
(``ssm_scan_loop``) and against JAX's
``selective_scan_ref`` and the Pallas kernel ``ssm_scan`` in interpret
mode, at the sizes of the JAX package's own sweep
(``tests/test_kernels.py::test_ssm_scan_sweep``), every column valid;
then with per-row valid prefixes (the serving layout) against JAX's
oracle run on each row's prefix alone.

Tolerance 1e-4 absolute and relative, as the JAX sweep holds its kernel
to its oracle: float32 throughout, the same products summed in other
orders (``y`` is an einsum over N in both) through up to 128 steps of a
decaying recurrence. A row with no valid column returns ``h0`` bit for bit.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import ssm_scan as j_ssm_scan
from repro.kernels.ssm_scan.ref import selective_scan_ref as j_ref
from repro_torch.kernels.ssm_scan import LAUNCHES, ssm_scan, ssm_scan_ref
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)
# the JAX sweep's (b, s, i, n, chunk)
SWEEP = [(2, 64, 32, 16, 16), (1, 48, 16, 8, 48), (3, 128, 64, 16, 32), (2, 30, 16, 8, 8)]


def _inputs(b, s, i, n, seed=4):
    """dt, b, c, x, a, h0 with the JAX sweep's distributions, from numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, i)))).astype(np.float32)
    bb = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cc = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    x = (rng.standard_normal((b, s, i)) * 0.5).astype(np.float32)
    a = (-np.exp(rng.standard_normal((i, n)) * 0.3)).astype(np.float32)
    h0 = (rng.standard_normal((b, i, n)) * 0.1).astype(np.float32)
    return dt, bb, cc, x, a, h0


@pytest.mark.parametrize("b,s,i,n,chunk", SWEEP)
def test_plain_version_matches_jax_ref_and_pallas(b, s, i, n, chunk):
    arrays = _inputs(b, s, i, n)
    y, h = ssm_scan_ref(*map(torch.from_numpy, arrays))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    yr, hr = j_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **TOL)
    yp, hp = j_ssm_scan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yp), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hp), **TOL)
    # every column valid is the same as no n_valid at all
    yv, hv = ssm_scan_ref(*map(torch.from_numpy, arrays),
                          n_valid=torch.full((b,), s, dtype=torch.int32))
    assert torch.equal(yv, y) and torch.equal(hv, h)


@pytest.mark.parametrize("b,s,i,n", [(5, 16, 32, 16), (4, 7, 24, 4)])
def test_gated_rows_match_jax_ref_on_their_prefix(b, s, i, n):
    """Mixed valid prefixes (0, 1, partial, full): each row's valid ``y``
    and its ``h_last`` equal JAX's oracle on that row's prefix alone; ``y``
    is zero past the prefix, and an empty row returns ``h0`` exactly."""
    dt, bb, cc, x, a, h0 = _inputs(b, s, i, n, seed=b * s)
    n_valid = np.array([0, 1, s, s // 2, 3][:b], np.int32)
    y, h = ssm_scan_ref(*map(torch.from_numpy, (dt, bb, cc, x, a, h0)),
                        n_valid=torch.from_numpy(n_valid))
    for r, nv in enumerate(n_valid):
        if nv == 0:
            assert torch.equal(h[r], torch.from_numpy(h0[r]))
        else:
            sl = lambda t: jnp.asarray(t[r:r + 1, :nv])
            yr, hr = j_ref(sl(dt), sl(bb), sl(cc), sl(x), jnp.asarray(a),
                           jnp.asarray(h0[r:r + 1]))
            np.testing.assert_allclose(y[r, :nv].numpy(), np.asarray(yr)[0], **TOL)
            np.testing.assert_allclose(h[r].numpy(), np.asarray(hr)[0], **TOL)
        assert (y[r, nv:] == 0).all()


@pytest.mark.parametrize("b,s,i,n,block,with_h0", [
    (4, 37, 24, 8, 1 << 24, True),       # one block of channels
    (4, 37, 24, 8, 4 * 37 * 8 * 5, True),  # blocks of 5 channels, the last of 4
    (1, 300, 16, 4, 1 << 24, False),     # one long row, no h0
    (8, 1, 32, 16, 8 * 16 * 7, False),   # a decode tick, blocks of 7
])
def test_prefix_scan_matches_the_column_loop(monkeypatch, b, s, i, n, block, with_h0):
    """``ssm_scan_ref`` (the prefix composition, a block of channels at a
    time) against ``ssm_scan_loop`` (a column at a time) on the same
    inputs, with mixed valid prefixes: float32 within 1e-5, the orders of
    the same products only; y zero past the prefix in both; an empty row
    returns h0 bit for bit."""
    from repro_torch.kernels.ssm_scan import ref

    monkeypatch.setattr(ref, "BLOCK_ELEMS", block)
    dt, bb, cc, x, a, h0 = map(torch.from_numpy, _inputs(b, s, i, n, seed=s))
    h0 = h0 if with_h0 else None
    n_valid = torch.tensor([0, s, 1, s // 2, s, 3, 0, s][:b], dtype=torch.int32)
    for nv in (None, n_valid):
        y, h = ref.ssm_scan_ref(dt, bb, cc, x, a, h0, nv)
        yl, hl = ref.ssm_scan_loop(dt, bb, cc, x, a, h0, nv)
        np.testing.assert_allclose(y.numpy(), yl.numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(h.numpy(), hl.numpy(), atol=1e-5, rtol=1e-5)
    assert (y[0] == 0).all()
    if with_h0:
        assert torch.equal(h[0], h0[0])


def test_bf16_inputs_give_x_dtype_and_float32_state():
    dt, bb, cc, x, a, h0 = (torch.from_numpy(t) for t in _inputs(2, 8, 16, 4))
    bf = lambda t: t.to(torch.bfloat16)
    y, h = ssm_scan_ref(bf(dt), bf(bb), bf(cc), bf(x), a, h0,
                        n_valid=torch.tensor([8, 3], dtype=torch.int32))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    # the same arithmetic on the rounded inputs, in float32
    yf, hf = ssm_scan_ref(*(bf(t).float() for t in (dt, bb, cc, x)), a, h0,
                          n_valid=torch.tensor([8, 3], dtype=torch.int32))
    assert torch.equal(h, hf) and torch.equal(y, yf.to(torch.bfloat16))


def test_wrapper_resolves_kernel_kind_on_cpu():
    args = [torch.from_numpy(t) for t in _inputs(2, 4, 8, 4)]
    before = LAUNCHES.count
    y, h = ssm_scan(*args)                     # auto on CPU tensors -> plain version
    yr, hr = ssm_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    assert LAUNCHES.count == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssm_scan(*args, kernel="cuda")


@pytest.mark.parametrize("i,n,offset,route", [
    (1536, 16, 0, "tma"), (200, 8, 0, "tma"), (1600, 16, 0, "tma"), (130, 16, 0, "direct"),
    (1536, 4, 0, "direct"), (1536, 16, 1, "direct")])
def test_scan_route_follows_what_tma_can_take(i, n, offset, route):
    """The scan takes its TMA route where its maps can take the inputs (N 8
    or 16, I a multiple of 8, dt, x, b and c on 16-byte boundaries), else
    its direct route; ``offset`` bf16 elements shift x's base off one."""
    from repro_torch.kernels.ssm_scan.kernel import scan_route

    def aligned(shape, shift=0):
        numel = int(np.prod(shape))
        flat = torch.zeros(numel + 16, dtype=torch.bfloat16)
        lead = (16 - flat.data_ptr() % 16) % 16 // 2
        return flat[lead + shift:lead + shift + numel].view(shape)

    b = aligned((2, 3, n))
    assert scan_route(aligned((2, 3, i)), b, aligned((2, 3, n)),
                      aligned((2, 3, i), offset)) == route


def test_flush_l2_writes_one_half_and_reads_the_other():
    from repro_torch.kernels.timing import flush_l2

    flush = torch.full((64,), 7, dtype=torch.uint8)
    flush_l2(flush)
    assert (flush[:32] == 0).all() and (flush[32:] == 7).all()

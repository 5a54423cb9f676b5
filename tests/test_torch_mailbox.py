"""Port parity: the plain versions of the mailbox handler kernels against
the JAX package's Server-Side Sum and Indirect Put.

The same numpy frames go through the port's ``am_server_sum`` /
``am_indirect_put`` on the CPU (their plain versions) and through the JAX
package's oracles (``server_sum_ref``, the sequential ``indirect_put_ref``)
and its Pallas kernels in interpret mode. Integers throughout: every
comparison is exact. The Indirect Put also runs on collision-heavy
traffic (every frame on one row, all rows distinct, two rows in turn, one
table row, one frame) at heap bases 0, slots - 1 and +-(2^31 - 1). JAX
adds ``floormod(key, slots) + got[0]`` in int32, which wraps for a base
above 2^31 - slots, where the port computes the row exactly (ROADMAP §C);
so JAX is given the base's floor residue, which names the same rows
exactly. The CUDA kernels themselves are held against these plain
versions on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.message import FrameSpec as JSpec
from repro.kernels.mailbox import am_indirect_put as j_am_indirect_put
from repro.kernels.mailbox import am_server_sum as j_am_server_sum
from repro.kernels.mailbox.ref import indirect_put_ref as j_indirect_put_ref
from repro.kernels.mailbox.ref import server_sum_ref as j_server_sum_ref
from repro_torch.core.message import FrameSpec, pack_frames
from repro_torch.kernels import mailbox as mb
from repro_torch.kernels.mailbox import bench
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

SPEC, J_SPEC = FrameSpec(4, 0, 16), JSpec(4, 0, 16)
USR_OFF, PW = SPEC.offsets()["usr"], SPEC.payload_words
I32 = np.iinfo(np.int32)


def _frames(usr):
    return pack_frames(SPEC, func_id=0, payload_words=torch.from_numpy(usr))


def _put_usr(rng, n, slots):
    usr = rng.integers(I32.min, I32.max, size=(n, PW), endpoint=True,
                       dtype=np.int64).astype(np.int32)
    usr[:, 0] = rng.integers(-3 * slots, 3 * slots, size=n)       # negative keys, collisions
    usr[8:, 0] += usr[8:, 0] % slots == 5                         # frame 7 writes 5's row last
    usr[:4, 0] = [I32.min, I32.max, -1, 5]
    usr[4:8, 0] = 5 + slots * np.arange(1, 5)                     # all on key 5's row
    return usr


COLLISIONS = ["one_row", "distinct", "alternate", "slots1", "n1"]


def collision_usr(kind, rng, n=40, slots=16):
    """(USR words, slots) of an Indirect Put whose keys collide as ``kind``
    says: every frame on one row, all rows distinct (n <= slots), two rows
    in turn, a table of one row, or one frame; keys negative and positive,
    each row reached by several keys."""
    if kind == "slots1":
        slots = 1
    if kind == "distinct":
        slots = max(slots, n)
    if kind == "n1":
        n = 1
    usr = rng.integers(I32.min, I32.max, size=(n, PW), endpoint=True,
                       dtype=np.int64).astype(np.int32)
    wraps = slots * rng.integers(-3, 4, size=n)                   # other keys, same row
    if kind == "one_row":
        usr[:, 0] = 7 % slots + wraps
    elif kind == "distinct":
        usr[:, 0] = rng.permutation(slots)[:n] + wraps
    elif kind == "alternate":
        usr[:, 0] = 1 + np.arange(n) % 2 + wraps
    return usr, slots


@pytest.mark.parametrize("n", [1, 7, 127, 130])
def test_server_sum_matches_jax(n):
    rng = np.random.default_rng(n)
    usr = rng.integers(I32.min, I32.max, size=(n, PW), endpoint=True,
                       dtype=np.int64).astype(np.int32)
    usr[0] = I32.max                                   # wraps
    frames = _frames(usr)
    got = mb.am_server_sum(frames, SPEC)
    assert got.dtype == torch.int32 and got.shape == (n,)
    jf = jnp.asarray(frames.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_am_server_sum(jf, J_SPEC)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_server_sum_ref(jf, USR_OFF, PW)))
    np.testing.assert_array_equal(
        got.numpy(), mb.am_server_sum(frames, SPEC, kernel="ref").numpy())
    assert int(got[0]) == int(np.int64(I32.max) * PW % 2 ** 32 - 2 ** 32)


@pytest.mark.parametrize("got_base", [0, 3])
def test_indirect_put_matches_jax_sequential_ref(got_base):
    rng = np.random.default_rng(10 + got_base)
    slots = 16
    usr = _put_usr(rng, 40, slots)
    frames = _frames(usr)
    table0 = rng.integers(-9, 9, size=(slots, 2)).astype(np.int32)
    heap0 = rng.integers(-9, 9, size=(slots, PW - 1)).astype(np.int32)
    table, heap = torch.from_numpy(table0.copy()), torch.from_numpy(heap0.copy())
    got = torch.tensor([got_base, 7, 7, 7], dtype=torch.int32)
    out = mb.am_indirect_put(frames, table, heap, got, SPEC)
    assert out[0] is table and out[1] is heap           # in place
    jt, jh = j_indirect_put_ref(jnp.asarray(frames.numpy()), jnp.asarray(table0),
                                jnp.asarray(heap0), USR_OFF, PW, got_base)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(heap.numpy(), np.asarray(jh))
    row = (5 % slots + got_base) % slots                # the later frame's row lands
    np.testing.assert_array_equal(heap[row].numpy(), usr[7, 1:])
    assert table[row].tolist() == [int(usr[7, 0]), row]


@pytest.mark.parametrize("got_base", [0, 3])
def test_indirect_put_matches_jax_pallas_kernel(got_base):
    if not hasattr(jpl, "store"):
        pytest.skip("this jax's Pallas has no pl.store, which the JAX package's "
                    "indirect_put_pallas calls; the sequential oracle test covers it")
    rng = np.random.default_rng(20 + got_base)
    slots = 8
    frames = _frames(_put_usr(rng, 12, slots))
    table = torch.zeros((slots, 2), dtype=torch.int32)
    heap = torch.zeros((slots, PW - 1), dtype=torch.int32)
    got = torch.tensor([got_base, 0, 0, 0], dtype=torch.int32)
    mb.am_indirect_put(frames, table, heap, got, SPEC)
    jt, jh = j_am_indirect_put(jnp.asarray(frames.numpy()), jnp.zeros((slots, 2), jnp.int32),
                               jnp.zeros((slots, PW - 1), jnp.int32),
                               jnp.asarray(got.numpy()), J_SPEC)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(heap.numpy(), np.asarray(jh))


@pytest.mark.parametrize("got_base", ["zero", "slots-1", "int32-max", "-int32-max"])
@pytest.mark.parametrize("kind", COLLISIONS)
def test_indirect_put_collisions_match_jax_sequential_ref(kind, got_base):
    rng = np.random.default_rng(COLLISIONS.index(kind))
    usr, slots = collision_usr(kind, rng)
    base = {"zero": 0, "slots-1": slots - 1, "int32-max": I32.max,
            "-int32-max": -I32.max}[got_base]
    frames = _frames(usr)
    table0 = rng.integers(-9, 9, size=(slots, 2)).astype(np.int32)
    heap0 = rng.integers(-9, 9, size=(slots, PW - 1)).astype(np.int32)
    table, heap = torch.from_numpy(table0.copy()), torch.from_numpy(heap0.copy())
    got = torch.tensor([base, 7, 7, 7], dtype=torch.int32)
    mb.am_indirect_put(frames, table, heap, got, SPEC)
    jt, jh = j_indirect_put_ref(jnp.asarray(frames.numpy()), jnp.asarray(table0),
                                jnp.asarray(heap0), USR_OFF, PW, base % slots)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(heap.numpy(), np.asarray(jh))
    rows = bench.put_rows(usr[:, 0], slots, base)
    written = {"one_row": 1, "distinct": len(usr), "alternate": min(2, len(usr)),
               "slots1": 1, "n1": 1}[kind]
    assert len(np.unique(rows)) == written


@pytest.mark.parametrize("got_base", ["zero", "slots-1", "int32-max", "-int32-max"])
@pytest.mark.parametrize("kind", COLLISIONS)
def test_indirect_put_collisions_match_jax_pallas_kernel(kind, got_base):
    if not hasattr(jpl, "store"):
        pytest.skip("this jax's Pallas has no pl.store, which the JAX package's "
                    "indirect_put_pallas calls; the sequential oracle test covers it")
    rng = np.random.default_rng(COLLISIONS.index(kind))
    usr, slots = collision_usr(kind, rng, n=12, slots=8)
    base = {"zero": 0, "slots-1": slots - 1, "int32-max": I32.max,
            "-int32-max": -I32.max}[got_base]
    frames = _frames(usr)
    table = torch.zeros((slots, 2), dtype=torch.int32)
    heap = torch.zeros((slots, PW - 1), dtype=torch.int32)
    mb.am_indirect_put(frames, table, heap, torch.tensor([base, 0, 0, 0], dtype=torch.int32),
                       SPEC)
    jt, jh = j_am_indirect_put(jnp.asarray(frames.numpy()), jnp.zeros((slots, 2), jnp.int32),
                               jnp.zeros((slots, PW - 1), jnp.int32),
                               jnp.asarray([base % slots, 0, 0, 0], jnp.int32), J_SPEC)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(heap.numpy(), np.asarray(jh))


def test_indirect_put_equals_numpy_sequential_replay():
    """4,096 frames on 64 rows: every row is written many times; the plain
    version must leave what frame-by-frame puts leave."""
    rng = np.random.default_rng(30)
    slots, base = 64, 12_345
    usr = bench.put_payloads(rng, 4096)
    table = torch.zeros((slots, 2), dtype=torch.int32)
    heap = torch.zeros((slots, PW - 1), dtype=torch.int32)
    mb.indirect_put_ref(_frames(usr), table, heap, USR_OFF, PW, base)
    want_t, want_h = np.zeros((slots, 2), np.int32), np.zeros((slots, PW - 1), np.int32)
    rows = bench.put_rows(usr[:, 0], slots, base)
    for i, r in enumerate(rows):
        want_t[r] = usr[i, 0], r
        want_h[r] = usr[i, 1:]
    np.testing.assert_array_equal(table.numpy(), want_t)
    np.testing.assert_array_equal(heap.numpy(), want_h)
    uniq, last = bench.last_writers(rows)                  # chip_smoke's replay
    np.testing.assert_array_equal(want_h[uniq], usr[last, 1:])
    assert len(uniq) == slots
    np.testing.assert_array_equal(
        mb.put_slots(torch.from_numpy(usr[:, 0]), slots, torch.tensor(base)).numpy(), rows)


def test_frame_path_traffic_and_work():
    rng = np.random.default_rng(0)
    usr = bench.put_payloads(rng, 20_000)
    hot = np.isin(usr[:, 0], bench.hot_keys())
    assert 0.08 < hot.mean() < 0.12 and (usr[:, 0] < 0).mean() > 0.4
    assert {bench.INT32_MIN, bench.INT32_MAX} <= set(bench.hot_keys().tolist())
    frames = _frames(bench.sum_payloads(rng, 5000))
    before = frames.clone()
    bad = bench.corrupt(frames, rng)
    assert len(bad) == 5
    changed = (frames != before).any(1).nonzero().squeeze(1).numpy()
    np.testing.assert_array_equal(changed, bad)
    valid = mb.am_server_sum(frames, SPEC) == frames[:, SPEC.offsets()["sig"] + 1]
    np.testing.assert_array_equal((~valid).nonzero().squeeze(1).numpy(), bad)
    assert bench.sum_work(10) == {"bytes": 680}
    assert bench.put_work(10, 4) == {"bytes": 40 + 4 * 128 + 4}


def test_put_claim_table_is_sized_by_the_frames():
    from repro_torch.kernels.mailbox.kernel import claim_entries

    for n, slots in [(1, 1), (1, 2 ** 26), (17, 1000), (2 ** 20, 2 ** 26), (2 ** 20, 5)]:
        e = claim_entries(n, slots)
        assert e & (e - 1) == 0 and max(32, 2 * min(n, slots)) <= e < max(64, 4 * min(n, slots))
    assert claim_entries(2 ** 20, 2 ** 26) == claim_entries(2 ** 20, 2 ** 31 - 1) == 2 ** 21


def test_put_sector_work_counts_whole_sectors():
    """``put_sector_work`` against a byte-by-byte count: each frame's key
    sector, the winners' data sectors, the written table and heap rows'
    sectors (each once) and got[0]; partly written sectors counted apart."""
    rng = np.random.default_rng(5)
    n, w, usr_off = 50, SPEC.total_words, USR_OFF
    rows = np.sort(rng.choice(200, size=12, replace=False))
    last = np.sort(rng.choice(n, size=12, replace=False))
    rows[1] = rows[0] + 1                                  # neighbours share sectors
    read = {(i * w + usr_off) * 4 // 32 for i in range(n)}
    for l in last:
        read |= {b // 32 for b in range((l * w + usr_off + 1) * 4, (l * w + usr_off + PW) * 4)}
    written = partial = 0
    for pitch in (8, 4 * (PW - 1)):
        covered = {}
        for r in rows:
            for b in range(r * pitch, (r + 1) * pitch):
                covered.setdefault(b // 32, set()).add(b)
        written += len(covered)
        partial += sum(len(v) < 32 for v in covered.values())
    got = bench.put_sector_work(n, rows, last)
    assert got["sectors"] == len(read) + written + 1 and got["partial_sectors"] == partial
    assert got["bytes"] == 32 * got["sectors"]
    assert got["rmw_bytes"] == 32 * (got["sectors"] + partial)


def test_wrappers_resolve_and_raise_on_the_cpu():
    frames = _frames(np.zeros((3, PW), np.int32))
    table = torch.zeros((4, 2), dtype=torch.int32)
    heap = torch.zeros((4, PW - 1), dtype=torch.int32)
    got = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mb.am_server_sum(frames, SPEC, kernel="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mb.am_indirect_put(frames, table, heap, got, SPEC, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mb.server_sum_cuda(frames, USR_OFF, PW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mb.indirect_put_cuda(frames, table, heap, got, USR_OFF, PW)
    with pytest.raises(ValueError, match="kernel must be"):
        mb.am_server_sum(frames, SPEC, kernel="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mb.ring_am_put(frames[None], spec=SPEC, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mb.mailbox_put_cuda(frames[None], sig_off=30, usr_off=USR_OFF, payload_words=PW)
    arrivals, spins, sums = mb.ring_am_put(frames[None], spec=SPEC, handler="sum")
    assert torch.equal(arrivals[0], frames) and spins.tolist() == [[[0]]]
    assert torch.equal(sums[0, :, 0], mb.am_server_sum(frames, SPEC))
    assert (mb.SUM_LAUNCHES.count, mb.PUT_LAUNCHES.count, mb.RING_LAUNCHES.count) == (0, 0, 0)


@pytest.mark.parametrize("w,usr_off,pw", [(32, 12, 16), (32, 13, 16), (32, 0, 1),
                                          (8, 2, 3), (7, 1, 5), (4, 0, 4), (300, 3, 290)])
def test_sum_sector_work_counts_whole_sectors(w, usr_off, pw):
    """``sum_sector_work`` against a byte-by-byte count over frames of ``w``
    words: every 32-byte sector holding a USR byte, each once (frames of
    fewer than 8 words share sectors), plus the sums' sectors."""
    n = 37
    usr = {b // 32 for f in range(n) for b in range((f * w + usr_off) * 4,
                                                   (f * w + usr_off + pw) * 4)}
    got = bench.sum_sector_work(n, usr_off, pw, w=w)
    assert got["usr_sectors"] == len(usr)
    assert got["sectors"] == len(usr) + -(-4 * n // 32) and got["bytes"] == 32 * got["sectors"]


def test_sum_sector_work_at_the_frame_path():
    """Three sectors a frame of USR (bytes 48-111) and the sums: 104.9 MB,
    0.0313 ms at 3.35 TB/s, where the bytes bound counts 71.3 MB."""
    from repro_torch.kernels.timing import bound_ms

    n = bench.BANKS * bench.FRAMES_PER_BANK
    got = bench.sum_sector_work(n)
    assert got == {"bytes": 104_857_600, "sectors": 3 * n + n // 8, "usr_sectors": 3 * n}
    assert round(bound_ms(got)[0], 4) == 0.0313
    assert bench.sum_sector_work(0) == {"bytes": 0, "sectors": 0, "usr_sectors": 0}
    assert bench.sum_sector_work(5, payload_words=0)["usr_sectors"] == 0


@pytest.mark.parametrize("usr_off,pw,w,offset,sms,route", [
    (12, 16, 32, 0, 132, "wide"), (0, 4, 16, 0, 132, "wide"), (12, 300, 320, 0, 132, "wide"),
    (0, 8192, 8208, 0, 132, "wide"), (12, 16, 32, 0, 1, "scalar"), (12, 128, 144, 0, 1, "scalar"),
    (12, 132, 144, 0, 1, "wide"), (13, 16, 32, 0, 132, "scalar"), (12, 17, 32, 0, 132, "scalar"),
    (12, 0, 32, 0, 132, "scalar"), (0, 3, 4, 0, 132, "scalar"), (12, 16, 30, 0, 132, "scalar"),
    (12, 16, 32, 1, 132, "scalar"), (12, 300, 320, 1, 1, "scalar")])
def test_sum_route_follows_alignment_and_call_size(usr_off, pw, w, offset, sms, route):
    """The Server-Side Sum takes its wide route (a CTA a frame) where the
    USR words sit on 16-byte boundaries (base on 16 bytes; pitch, offset
    and width multiples of 4 words, width at least 4) and the call has at
    most 4 frames an SM (5 frames here: 132 SMs, or 1) or more than 128
    USR words a frame, else its scalar route; ``offset`` words shift the
    frames' base off a 16-byte boundary."""
    from repro_torch.kernels.mailbox.kernel import sum_route

    flat = torch.zeros(5 * w + 4, dtype=torch.int32)
    base = flat.data_ptr() % 16 // 4
    frames = flat[(4 - base) % 4 + offset:][:5 * w].view(5, w)
    assert sum_route(frames, usr_off, pw, sms=sms) == route

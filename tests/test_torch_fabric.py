"""Port parity: the GOT, rieds, jam dispatch, mailboxes, leases and the
``Fabric`` frame path against the JAX package's ``repro.core`` and
``repro.fabric``.

The port's handlers are batched (``(N, PW)`` USR words -> ``(N, R)``),
the JAX ones per frame; the same two jams of the frame path are written
once per framework (the port's are ``kernels.mailbox.bench.kv_fabric``,
which ``chip_smoke.py`` serves at full size). Everything compared is
integer words or counters, so every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mailbox as j_mb
from repro.core.got import GotTable as JGot
from repro.core.message import FrameSpec as JSpec
from repro.core.registry import RiedPackage as JRied
from repro.fabric import Fabric as JFabric
from repro.fabric.leases import LeasePool as JLeasePool
from repro_torch.bridge import got_from_jax, mailbox_from_jax
from repro_torch.core import mailbox as t_mb
from repro_torch.core.got import GotTable
from repro_torch.core.message import HDR_FUNC_ID, FrameSpec, checksum, pack_frames
from repro_torch.core.registry import RiedPackage
from repro_torch.fabric import Fabric, LeasePool
from repro_torch.kernels.mailbox import bench
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

SLOTS, BASE = 64, 3
I32 = np.iinfo(np.int32)


def _j_kv_fabric():
    """The JAX package's counterpart of ``bench.kv_fabric``."""
    ried = JRied("kv")
    ried.export("kv.table")(lambda: jnp.zeros((SLOTS, 2), jnp.int32))
    ried.export("kv.heap")(lambda: jnp.zeros((SLOTS, 15), jnp.int32))
    ried.export("kv.heap_base")(lambda: jnp.int32(BASE))
    fabric = JFabric(name="kv").install(ried)
    spec = JSpec(got_slots=4, state_words=0, payload_words=16)

    @fabric.function("server_side_sum", spec=spec, result_words=2)
    def server_side_sum(got, state, usr):
        return jnp.stack([jnp.sum(usr, dtype=jnp.int32), jnp.int32(0)])

    @fabric.function("indirect_put", spec=spec, result_words=2,
                     got_symbols=("kv.heap_base", "kv.table"))
    def indirect_put(got, state, usr):
        base, table = got
        slots = table.shape[0]
        idx = jnp.remainder(jnp.remainder(usr[0], slots) + base, slots)
        return jnp.stack([usr[0], idx]).astype(jnp.int32)

    return fabric, spec


def _usr(rng, n):
    usr = rng.integers(I32.min, I32.max, size=(n, 16), endpoint=True,
                       dtype=np.int64).astype(np.int32)
    usr[:4, 0] = [I32.min, I32.max, -1, 5]          # negative keys, the extremes
    usr[4:8, 0] = 5 + SLOTS * np.arange(1, 5)       # keys that collide with 5
    return usr


def test_got_layout_hash_and_bridge_match_jax():
    names = ("kv.table", "kv.heap", "kv.heap_base", "bias")
    j, t = JGot(), GotTable()
    for i, n in enumerate(names):
        assert t.bind(n, i) == j.bind(n, i)
    assert t.layout_hash() == j.layout_hash() and t.symbols == j.symbols
    t.check_layout(j.layout_hash())
    np.testing.assert_array_equal(t.got_indices(["bias", "kv.heap"], 4, device="cpu").numpy(),
                                  np.asarray(j.got_indices(["bias", "kv.heap"], 4)))
    other = GotTable()
    other.bind("kv.heap", 0)
    other.bind("kv.table", 1)                        # another index order
    with pytest.raises(RuntimeError, match="layout mismatch"):
        other.check_layout(j.layout_hash())
    with pytest.raises(KeyError, match="unresolved"):
        t.resolve(["missing"])
    t.bind("bias", 9)                                # rebinding keeps the index
    assert t.value_of("bias") == 9 and t.index_of("bias") == 3

    j_fab, _ = _j_kv_fabric()
    values = [np.asarray(v) for v in j_fab.got.resolve(j_fab.got.symbols)]
    bridged = got_from_jax(j_fab.got.symbols, values)
    assert bridged.layout_hash() == j_fab.got.layout_hash()
    assert bridged.layout_hash() == bench.kv_fabric("cpu", SLOTS, BASE).got.layout_hash()
    assert int(bridged.value_of("kv.heap_base")) == BASE
    assert bridged.value_of("kv.heap").shape == (SLOTS, 15)


def test_ried_install_binds_in_export_order():
    ried = RiedPackage("iface")
    ried.export("table")(lambda: torch.arange(4))
    ried.export("bias")(lambda: 5)
    got = GotTable()
    ried.install(got)
    assert got.symbols == ried.symbols == ("table", "bias")
    assert got.value_of("bias") == 5
    fabric = Fabric(name="f").install(ried)
    assert fabric.got.symbols == ("table", "bias")
    fabric.install({"extra": 1})
    assert fabric.got.symbols[-1] == "extra"
    with pytest.raises(TypeError, match="cannot install"):
        fabric.install(3)


def test_dispatcher_rows_match_jax_dispatcher():
    rng = np.random.default_rng(0)
    j_fab, j_spec = _j_kv_fabric()
    t_fab = bench.kv_fabric("cpu", SLOTS, BASE)
    usr = _usr(rng, 24)
    kind = np.array(["indirect_put", "server_side_sum"])[rng.integers(0, 2, size=24)]
    frames = []
    for i in range(24):
        jf = np.asarray(j_fab.pack(kind[i], jnp.asarray(usr[i])))
        tf = t_fab.pack(kind[i], torch.from_numpy(usr[i]))
        np.testing.assert_array_equal(tf.numpy(), jf)
        frames.append(jf)
    frames = np.stack(frames)
    batched = t_fab.pack("indirect_put", torch.from_numpy(usr))
    assert batched.shape == (24, bench.SPEC.total_words)
    o = bench.SPEC.offsets()
    frames[8, o["usr"] + 2] ^= 4                    # bad checksum: a zero row
    frames[9, o["sig"]] = 0                         # no signal: a zero row
    frames[10, HDR_FUNC_ID] = 7                     # clamped to the last jam
    frames[11, HDR_FUNC_ID] = -3                    # clamped to the first
    j_rows = np.asarray(j_mb.drain_frames(jnp.asarray(frames), j_fab.dispatcher(j_spec, 2), 2))
    dispatch = t_fab.dispatcher(bench.SPEC, 2)
    t_rows = t_mb.drain_frames(torch.from_numpy(frames), dispatch, 2).numpy()
    np.testing.assert_array_equal(t_rows, j_rows)
    assert (t_rows[8:10] == 0).all()
    assert t_rows[10, 1] == (usr[10, 0].astype(np.int64) % SLOTS + BASE) % SLOTS
    assert t_rows[11, 0] == int(checksum(torch.from_numpy(usr[11])))
    # any batch shape; the dispatcher is cached per generation and rebuilt
    # after a bind
    np.testing.assert_array_equal(dispatch(torch.from_numpy(frames.reshape(4, 6, -1))).numpy(),
                                  t_rows.reshape(4, 6, 2))
    assert t_fab.dispatcher(bench.SPEC, 2) is dispatch
    t_fab.bind("kv.heap_base", torch.tensor(0, dtype=torch.int32))
    assert t_fab.dispatcher(bench.SPEC, 2) is not dispatch
    for name in ("server_side_sum", "indirect_put"):
        one = t_fab.call(name, torch.from_numpy(usr[0]))
        assert one.shape == (2,)
    assert t_fab.metrics()["calls"] == {"server_side_sum": 1, "indirect_put": 1}
    with pytest.raises(KeyError, match="no frame functions"):
        t_fab.dispatcher(FrameSpec(4, 0, 8), 2)


def test_width_validation_and_duplicate_names_raise_as_in_jax():
    spec = FrameSpec(got_slots=4, state_words=0, payload_words=8)
    fabric = Fabric(name="test")
    fabric.install({"bias": torch.tensor(100, dtype=torch.int32)})
    fabric.function("rev", spec=spec, result_words=8)(lambda got, state, usr: usr.flip(1))
    with pytest.raises(ValueError, match="result words"):
        fabric.function("bad", spec=spec, result_words=8)(lambda g, s, u: u[:, :4])
    with pytest.raises(ValueError, match="result words"):
        fabric.function("bad2", got_symbols=("bias",), spec=spec, result_words=8)(
            lambda g, s, u: torch.zeros((u.shape[0], 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="single array"):
        fabric.function("bad3", spec=spec, result_words=8)(lambda g, s, u: (u, u))
    with pytest.raises(ValueError, match="failed shape validation"):
        fabric.function("bad4", spec=spec, result_words=8)(lambda g, s, u: u @ u)
    # a symbol bound later: validated when the dispatcher is built
    fabric.function("late", got_symbols=("later",), spec=spec, result_words=8)(
        lambda g, s, u: u[:, :5])
    fabric.bind("later", 1)
    with pytest.raises(ValueError, match="5 result words"):
        fabric.dispatcher(spec, 8)
    fabric2 = Fabric(name="test2")
    fabric2.function("rev", spec=spec, result_words=8)(lambda got, state, usr: usr.flip(1))
    payload = torch.arange(8, dtype=torch.int32)
    np.testing.assert_array_equal(fabric2.call("rev", payload).numpy(), np.arange(8)[::-1])
    with pytest.raises(ValueError, match="already registered"):
        fabric2.function("rev", spec=spec, result_words=8)(lambda g, s, u: u)
    with pytest.raises(ValueError, match="already registered"):
        fabric2.register_collective("rev", lambda *a, **k: None, placements=("local",))
    fabric2.register_collective("coll", lambda p, s, pl: (p, pl), placements=("local",))
    assert fabric2.call("coll", 1, placement="local") == (1, "local")
    with pytest.raises(ValueError, match="supports placements"):
        fabric2.call("coll", 1, placement="injected")
    with pytest.raises(NotImplementedError, match="A14"):
        fabric2.moe_transport(mode="local")


def _expert_fabrics(d=8, f=12, tokens=2):
    """One expert served both ways: weights resident in the GOT (local)
    and weights shipped in STATE (injected)."""
    from repro_torch.core import injection as inj

    rng = np.random.default_rng(4)
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
          for s in ((d, f), (d, f), (f, d))]
    spec_local = FrameSpec(got_slots=4, state_words=0, payload_words=tokens * d // 2)
    spec_inj = inj.injected_frame_spec(d, f, tokens)
    fabric = Fabric(name="expert")
    fabric.install({"w_gate": ws[0], "w_up": ws[1], "w_down": ws[2]})

    def ffn(x, wg, wu, wd):
        h = torch.nn.functional.silu(x @ wg) * (x @ wu)
        return inj.tokens_to_words(h @ wd)[None]

    @fabric.function("expert.local", spec=spec_local, result_words=tokens * d // 2,
                     got_symbols=("w_gate", "w_up", "w_down"))
    def local(got, state, usr):
        return ffn(inj.words_to_tokens(usr[0], tokens, d), *got)

    @fabric.function("expert.injected", spec=spec_inj, result_words=tokens * d // 2)
    def injected(got, state, usr):
        return ffn(inj.words_to_tokens(usr[0], tokens, d),
                   *inj.unpack_expert_state(state[0], d, f))

    x = torch.from_numpy(rng.standard_normal((tokens, d)).astype(np.float32)).to(torch.bfloat16)
    return fabric, ws, inj.tokens_to_words(x), inj


def test_frame_call_local_and_injected_identical():
    fabric, ws, payload, inj = _expert_fabrics()
    local = fabric.call("expert.local", payload, placement="local")
    for _ in range(3):
        state = fabric.lease("expert.state", ws, materialize=lambda: inj.expert_state_words(*ws))
        injected = fabric.call("expert.injected", payload, state=state, placement="injected")
        assert torch.equal(injected, local)
        assert torch.equal(fabric.call("expert.injected", payload, state=state), local)   # auto
    lease = fabric.metrics()["leases"]["expert.state"]
    assert (lease["misses"], lease["hits"]) == (1, 2)
    assert fabric.metrics()["calls"] == {"expert.local": 1, "expert.injected": 6}


def test_frame_placement_errors_as_in_jax():
    fabric, ws, payload, inj = _expert_fabrics()
    state = inj.expert_state_words(*ws)
    with pytest.raises(ValueError, match="resident state"):
        fabric.call("expert.local", payload, state=payload, placement="local")
    with pytest.raises(ValueError, match="state_words > 0"):
        fabric.call("expert.local", payload, placement="injected")
    with pytest.raises(ValueError, match="requires"):
        fabric.call("expert.injected", payload, placement="injected")
    with pytest.raises(ValueError, match="placement must be"):
        fabric.call("expert.injected", payload, state=state, placement="tp")
    with pytest.raises(KeyError, match="no function"):
        fabric.call("missing", payload)
    with pytest.raises(TypeError, match="no extra"):
        fabric.call("expert.local", payload, placement="local", moe=1)


def test_lease_counters_match_jax_lease_pool():
    def drive(pool, make):
        a, b = (make(), make()), (make(), make())
        out = [pool.acquire("w", a, ttl_calls=2, materialize=lambda: "v1"),
               pool.acquire("w", a, ttl_calls=2, materialize=lambda: "v2"),
               pool.acquire("w", a, ttl_calls=2, materialize=lambda: "v3"),   # expired
               pool.acquire("w", b, ttl_calls=2, materialize=lambda: "v4"),   # new identity
               pool.evict("w"), pool.evict("w"),
               pool.acquire("w", b, materialize=lambda: "v5"),
               pool.acquire("w", b, materialize=lambda: "v6"),
               pool.acquire("p", a), pool.evict("p"), pool.evict("none")]
        with pytest.raises(ValueError, match="ttl_calls"):
            pool.acquire("x", a, ttl_calls=0)
        return out, pool.metrics()

    j_out, j_m = drive(JLeasePool(), lambda: jnp.ones(2))
    t_out, t_m = drive(LeasePool(), lambda: torch.ones(2))
    assert t_m == j_m
    assert [o for o in t_out if isinstance(o, (str, bool))] == \
        [o for o in j_out if isinstance(o, (str, bool))]


def test_post_local_and_drain_mailbox_match_jax():
    rng = np.random.default_rng(5)
    j_fab, j_spec = _j_kv_fabric()
    t_fab = bench.kv_fabric("cpu", SLOTS, BASE)
    j_cfg = j_mb.MailboxConfig(banks=2, frames_per_bank=3, spec=j_spec)
    t_cfg = t_mb.MailboxConfig(banks=2, frames_per_bank=3, spec=bench.SPEC)
    j_box, t_box = j_mb.init_mailbox(j_cfg), t_mb.init_mailbox(t_cfg, device="cpu")
    usr = _usr(rng, 9)
    # bank 1 gets 5 frames: the last 2 have no credit and are dropped
    for i, bank in enumerate([1, 0, 1, 1, 1, 0, 1, 1, 0]):
        frame = t_fab.pack("indirect_put" if i % 2 else "server_side_sum",
                           torch.from_numpy(usr[i]))
        j_box = j_mb.post_local(j_box, jnp.int32(bank), jnp.asarray(frame.numpy()))
        t_box = t_mb.post_local(t_box, torch.tensor(bank), frame)
        for key in ("frames", "credits", "head"):
            np.testing.assert_array_equal(t_box[key].numpy(), np.asarray(j_box[key]), err_msg=key)
    assert t_box["credits"].tolist() == [0, 0] and t_box["head"].tolist() == [3, 3]
    j_res, j_clear = j_mb.drain_mailbox(j_box, j_fab.dispatcher(j_spec, 2), j_cfg)
    t_res, t_clear = t_mb.drain_mailbox(t_box, t_fab.dispatcher(bench.SPEC, 2), t_cfg)
    np.testing.assert_array_equal(t_res.numpy(), np.asarray(j_res))
    for key in ("frames", "credits", "head"):
        np.testing.assert_array_equal(t_clear[key].numpy(), np.asarray(j_clear[key]))
    assert t_box["head"].tolist() == [3, 3]           # the drained box is left as it was
    bridged = mailbox_from_jax(jax.tree.map(np.asarray, j_box))
    assert all(torch.equal(bridged[k], t_box[k]) for k in t_box)
    # the drained banks as ranks: a ring put hands bank r's frames to bank r + 1,
    # an all-to-all of (rank, dest) blocks hands rank r what each rank sent it
    ring = t_mb.ring_put(t_box["frames"])
    assert torch.equal(ring[1], t_box["frames"][0]) and torch.equal(ring[0], t_box["frames"][1])
    blocks = t_box["frames"][:, None].expand(2, 2, *t_box["frames"].shape[1:])
    assert torch.equal(t_mb.alltoall_put(blocks)[0, 1], t_box["frames"][1])


@pytest.mark.parametrize("max_spins", [0, 1, 64, 1 << 20])
def test_wait_loops_match_jax(max_spins):
    spec = FrameSpec(got_slots=4, state_words=0, payload_words=8)
    j_spec = JSpec(got_slots=4, state_words=0, payload_words=8)
    delivered = pack_frames(spec, func_id=0, payload_words=torch.ones(8, dtype=torch.int32))[None]
    for frames in (delivered, torch.zeros_like(delivered)):
        jf = jnp.asarray(frames.numpy())
        t_spins, t_found = t_mb.spin_wait_poll(frames, spec, max_spins=max_spins)
        j_spins, j_found = j_mb.spin_wait_poll(jf, j_spec, max_spins=max_spins)
        assert (int(t_spins), bool(t_found)) == (int(j_spins), bool(j_found))
        assert t_spins.dtype == torch.int32
        t_w, t_wf = t_mb.wfe_wait(frames, spec)
        j_w, j_wf = j_mb.wfe_wait(jf, j_spec)
        assert (int(t_w), bool(t_wf)) == (int(j_w), bool(j_wf))


def test_frame_path_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    spec = FrameSpec(got_slots=4, state_words=0, payload_words=8)
    for make in (lambda: t_mb.init_mailbox(t_mb.MailboxConfig(spec=spec)),
                 lambda: pack_frames(spec, func_id=0),
                 lambda: GotTable().got_indices([], 4),
                 lambda: bench.kv_fabric(slots=4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # given tensors, the frames follow them
    assert pack_frames(spec, func_id=0, payload_words=torch.zeros(8, dtype=torch.int32)).is_cpu

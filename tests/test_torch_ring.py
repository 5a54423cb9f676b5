"""Port parity: the one-sided ring put and the reference transports against
the JAX package.

One subprocess with 4 CPU devices (``tests/helpers.run_multidev``, a
plain ``Mesh`` as ``tests/test_kernels_mailbox.py`` builds it) runs the
JAX ``ring_am_put`` (its Pallas kernel ``mailbox_put_pallas`` under the
TPU-semantics interpreter) over 4 ranks: N of 1 and 3 frames, WFE and
poll, stashed with the fused sum and not, shifts 1, 2 and 5; and
``core.mailbox.ring_put`` / ``alltoall_put`` under ``shard_map``. It packs
the frames with ``pack_frame`` from numpy payloads (seed 0) and writes
every result to an ``.npz``. The port packs the same payloads with
``pack_frames``, and its plain ``ring_am_put``, ``ring_put`` and
``alltoall_put`` must equal the JAX results exactly (int32). The poll's
cap (2^20 spins when the last frame's SIG word is missing) is held
against the constant: 2^20 interpreted loop steps would stall the suite.
The CUDA kernel is held against the plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from helpers import run_multidev
from repro_torch.core import mailbox as t_mb
from repro_torch.core.message import FrameSpec, pack_frames
from repro_torch.kernels import mailbox as mb
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

SPEC = FrameSpec(got_slots=4, state_words=0, payload_words=16)
RANKS, FRAME_COUNTS, SHIFTS = 4, (1, 3), (1, 2, 5)
ROUTES = [("wfe", True), ("poll", True), ("wfe", False), ("poll", False)]
I32 = np.iinfo(np.int32)

_JAX = r"""
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import mailbox as jmb
from repro.core.message import FrameSpec, pack_frame
from repro.kernels.mailbox import ring_am_put

inputs = np.load(INPUTS)
spec = FrameSpec(got_slots=4, state_words=0, payload_words=16)
mesh = Mesh(np.array(jax.devices()).reshape(4), ("x",))
out = {}
for n_frames in (1, 3):
    usr = inputs[f"usr{n_frames}"]
    frames = jnp.stack([jnp.stack([pack_frame(spec, func_id=0, src_rank=r,
                                              payload_words=jnp.asarray(usr[r, i]))
                                   for i in range(n_frames)]) for r in range(4)])
    out[f"frames{n_frames}"] = np.asarray(frames)
    for shift in (1, 2, 5):
        for wait in ("wfe", "poll"):
            for stash in (True, False):
                arr, spins, sums = ring_am_put(frames, mesh, "x", spec=spec, shift=shift,
                                               wait=wait, stash=stash,
                                               handler="sum" if stash else None)
                key = f"{n_frames}-{shift}-{wait}-{int(stash)}"
                out[f"arrivals/{key}"] = np.asarray(arr)
                out[f"spins/{key}"] = np.asarray(spins)
                if stash:
                    out[f"sums/{key}"] = np.asarray(sums)
        ring = compat.shard_map(lambda b: jmb.ring_put(b, "x", shift), mesh=mesh,
                                in_specs=P("x"), out_specs=P("x"), check_vma=False)
        out[f"ring_put/{n_frames}-{shift}"] = np.asarray(ring(frames))
    blocks = jnp.asarray(inputs[f"a2a{n_frames}"])                   # (4, 4, N, W)
    a2a = compat.shard_map(lambda b: jmb.alltoall_put(b[0], "x")[None], mesh=mesh,
                           in_specs=P("x"), out_specs=P("x"), check_vma=False)
    out[f"alltoall/{n_frames}"] = np.asarray(a2a(blocks))
try:
    ring_am_put(frames, mesh, "x", spec=spec, stash=False, handler="sum")
    out["fused_sum_without_stash"] = np.array("ran")
except Exception as exc:
    out["fused_sum_without_stash"] = np.array(type(exc).__name__)
np.savez(OUTPUT, **out)
print("RING_JAX_OK")
"""


def _usr(rng, *shape):
    usr = rng.integers(I32.min, I32.max, size=shape + (SPEC.payload_words,), endpoint=True,
                       dtype=np.int64).astype(np.int32)
    usr.reshape(-1, SPEC.payload_words)[0] = I32.max                 # a sum that wraps
    return usr


def _frames(usr):
    ranks = torch.arange(usr.shape[0], dtype=torch.int32).view(-1, *([1] * (usr.ndim - 2)))
    return pack_frames(SPEC, func_id=0, src_rank=ranks, payload_words=torch.from_numpy(usr))


@pytest.fixture(scope="module")
def jax_ring(tmp_path_factory):
    """Inputs (numpy seed 0) and the JAX package's results, from one
    4-device subprocess."""
    tmp = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    inputs = {}
    for n in FRAME_COUNTS:
        inputs[f"usr{n}"] = _usr(rng, RANKS, n)
        inputs[f"a2a{n}"] = _frames(_usr(rng, RANKS, RANKS, n)).numpy()
    np.savez(tmp / "inputs.npz", **inputs)
    code = _JAX.replace("INPUTS", repr(str(tmp / "inputs.npz"))).replace(
        "OUTPUT", repr(str(tmp / "jax.npz")))
    assert "RING_JAX_OK" in run_multidev(code, n_devices=RANKS)
    return inputs, dict(np.load(tmp / "jax.npz"))


@pytest.mark.parametrize("n_frames", FRAME_COUNTS)
def test_frames_match_jax(jax_ring, n_frames):
    inputs, want = jax_ring
    np.testing.assert_array_equal(_frames(inputs[f"usr{n_frames}"]).numpy(),
                                  want[f"frames{n_frames}"])


@pytest.mark.parametrize("wait,stash", ROUTES)
@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("n_frames", FRAME_COUNTS)
def test_ring_am_put_matches_jax(jax_ring, n_frames, shift, wait, stash):
    inputs, want = jax_ring
    key = f"{n_frames}-{shift}-{wait}-{int(stash)}"
    frames = _frames(inputs[f"usr{n_frames}"])
    arrivals, spins, sums = mb.ring_am_put(frames, spec=SPEC, shift=shift, wait=wait,
                                           stash=stash, handler="sum" if stash else None)
    assert arrivals.dtype == spins.dtype == torch.int32
    np.testing.assert_array_equal(arrivals.numpy(), want[f"arrivals/{key}"])
    np.testing.assert_array_equal(spins.numpy(), want[f"spins/{key}"])
    if stash:
        np.testing.assert_array_equal(sums.numpy(), want[f"sums/{key}"])
    else:
        assert sums is None
    assert mb.RING_LAUNCHES.count == 0                # the CPU takes the plain version


@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("n_frames", FRAME_COUNTS)
def test_ring_put_matches_jax(jax_ring, n_frames, shift):
    inputs, want = jax_ring
    got = t_mb.ring_put(_frames(inputs[f"usr{n_frames}"]), shift)
    np.testing.assert_array_equal(got.numpy(), want[f"ring_put/{n_frames}-{shift}"])


@pytest.mark.parametrize("n_frames", FRAME_COUNTS)
def test_alltoall_put_matches_jax(jax_ring, n_frames):
    inputs, want = jax_ring
    blocks = torch.from_numpy(inputs[f"a2a{n_frames}"])
    got = t_mb.alltoall_put(blocks)
    np.testing.assert_array_equal(got.numpy(), want[f"alltoall/{n_frames}"])
    assert torch.equal(got[1, 2], blocks[2, 1])


def test_fused_sum_needs_the_stash_in_both_packages(jax_ring):
    """The JAX kernel cannot read its HBM mailbox from inside the kernel and
    fails under the interpreter; the port raises ``ValueError`` before
    either path runs."""
    _, want = jax_ring
    assert str(want["fused_sum_without_stash"]) == "ValueError"
    frames = _frames(np.zeros((2, 1, SPEC.payload_words), np.int32))
    for kernel in ("auto", "ref"):
        with pytest.raises(ValueError, match="stash=True"):
            mb.ring_am_put(frames, spec=SPEC, stash=False, handler="sum", kernel=kernel)


@pytest.mark.parametrize("handler", [None, "sum"])
def test_poll_without_sig_runs_to_the_cap(handler):
    """The last frame's SIG word zeroed: the poll of a stashed mailbox
    counts exactly 2^20 spins on every rank, and the arrivals are right;
    WFE and the non-stash mailbox still count 0."""
    frames = _frames(_usr(np.random.default_rng(1), 3, 5))
    frames[:, -1, SPEC.offsets()["sig"]] = 0
    arrivals, spins, sums = mb.ring_am_put(frames, spec=SPEC, wait="poll", handler=handler)
    assert mb.MAX_SPINS == 1 << 20
    assert spins.shape == (3, 1, 1) and (spins == 1 << 20).all()
    assert torch.equal(arrivals, torch.roll(frames, 1, 0))
    if handler:
        assert torch.equal(sums[..., 0], mb.server_sum_ref(
            arrivals.view(-1, SPEC.total_words), SPEC.offsets()["usr"], 16).view(3, 5))
    frames[1, -1, SPEC.offsets()["sig"]] = 0x516A22           # rank 2 receives rank 1's
    assert mb.ring_am_put(frames, spec=SPEC, wait="poll")[1].view(-1).tolist() == [
        1 << 20, 1 << 20, 1]
    for wait, stash in (("wfe", True), ("poll", False)):
        assert (mb.ring_am_put(frames, spec=SPEC, wait=wait, stash=stash)[1] == 0).all()


def test_ring_wrappers_raise():
    frames = _frames(np.zeros((2, 3, SPEC.payload_words), np.int32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        mb.ring_am_put(frames, spec=SPEC, kernel="cuda")
    with pytest.raises(ValueError, match="A14"):
        mb.mailbox_put_cuda(torch.zeros((9, 1, 32), dtype=torch.int32), sig_off=30,
                            usr_off=12, payload_words=16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mb.mailbox_put_cuda(frames, sig_off=30, usr_off=12, payload_words=16)
    with pytest.raises(ValueError, match=r"\(n, N >= 1, 32\)"):
        mb.ring_am_put(frames[0], spec=SPEC)
    with pytest.raises(ValueError, match=r"\(n, N >= 1, 32\)"):
        mb.ring_am_put(frames[:, :0], spec=SPEC)
    with pytest.raises(ValueError, match=r"\(n, N >= 1, 32\)"):
        mb.ring_am_put(frames[..., :16], spec=SPEC)
    with pytest.raises(ValueError, match="shift"):
        mb.ring_am_put(frames, spec=SPEC, shift=-1)
    with pytest.raises(ValueError, match="wait"):
        mb.ring_am_put(frames, spec=SPEC, wait="spin")
    with pytest.raises(ValueError, match="handler"):
        mb.ring_am_put(frames, spec=SPEC, handler="put")
    with pytest.raises(ValueError, match="kernel must be"):
        mb.ring_am_put(frames, spec=SPEC, kernel="pallas")
    assert mb.RING_LAUNCHES.count == 0

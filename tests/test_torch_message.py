"""Port parity: frames and word packings against ``repro.core.message``
and ``repro.core.injection``.

Frames are the ABI between the two packages: the same numpy inputs must
give the same int32 words in both, bit for bit. Every comparison here is
exact (integers, or bit patterns of floats).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import injection as j_inj
from repro.core import message as jm
from repro_torch.core import injection as t_inj
from repro_torch.core import message as tm
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)

SPECS = [(4, 0, 16), (4, 8, 12), (2, 3, 5), (0, 0, 1), (8, 33, 64)]
I32 = np.iinfo(np.int32)


def _words(rng, shape):
    w = rng.integers(I32.min, I32.max, size=shape, endpoint=True, dtype=np.int64)
    flat = w.reshape(-1)
    flat[:2] = [I32.min, I32.max][:flat.size]       # the extremes, always
    return w.astype(np.int32)


@pytest.mark.parametrize("geom", SPECS)
def test_frame_spec_offsets_and_sizes(geom):
    j, t = jm.FrameSpec(*geom), tm.FrameSpec(*geom)
    assert t.offsets() == j.offsets()
    assert (t.body_words, t.total_words, t.total_bytes) == (
        j.body_words, j.total_words, j.total_bytes)
    assert t.total_words % tm.ALIGN_WORDS == 0
    for name in ("MAGIC", "SIG_MAGIC", "HEADER_WORDS", "SIG_WORDS", "HDR_FUNC_ID",
                 "HDR_SEQ_NO", "HDR_FLAGS", "FLAG_INJECTED", "FLAG_READONLY_USR",
                 "FLAG_RECV_GOT"):
        assert int(getattr(tm, name)) == int(getattr(jm, name)), name


@pytest.mark.parametrize("geom", SPECS)
def test_pack_frames_equals_jax_pack_frame(geom):
    rng = np.random.default_rng(sum(geom))
    j, t = jm.FrameSpec(*geom), tm.FrameSpec(*geom)
    n = 6
    got = rng.integers(-1, 9, size=(n, t.got_slots)).astype(np.int32)
    state = _words(rng, (n, t.state_words))
    usr = _words(rng, (n, t.payload_words))
    hdr = {k: rng.integers(I32.min, I32.max, size=n, endpoint=True, dtype=np.int64)
           .astype(np.int32) for k in ("func_id", "elem_id", "src_rank", "seq_no", "flags")}
    frames = tm.pack_frames(t, got=torch.from_numpy(got), state_words=torch.from_numpy(state),
                            payload_words=torch.from_numpy(usr),
                            **{k: torch.from_numpy(v) for k, v in hdr.items()})
    assert frames.shape == (n, t.total_words) and frames.dtype == torch.int32
    for i in range(n):
        want = jm.pack_frame(j, got=jnp.asarray(got[i]), state_words=jnp.asarray(state[i]),
                             payload_words=jnp.asarray(usr[i]),
                             **{k: int(v[i]) for k, v in hdr.items()})
        np.testing.assert_array_equal(frames[i].numpy(), np.asarray(want))
    # one frame: no batch dimension; header ints; sections left out are zeros
    one = tm.pack_frames(t, func_id=3, seq_no=9, payload_words=torch.from_numpy(usr[0]))
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jm.pack_frame(j, func_id=3, seq_no=9,
                                              payload_words=jnp.asarray(usr[0]))))
    np.testing.assert_array_equal(tm.pack_frames(t, func_id=1, device="cpu").numpy(),
                                  np.asarray(jm.pack_frame(j, func_id=1)))


def test_pack_frames_takes_any_batch_shape_and_checks_widths():
    t = tm.FrameSpec(4, 0, 8)
    usr = torch.from_numpy(_words(np.random.default_rng(1), (2, 3, 8)))
    frames = tm.pack_frames(t, func_id=torch.tensor([[0], [1]], dtype=torch.int32),
                            payload_words=usr)
    assert frames.shape == (2, 3, t.total_words)
    assert frames[1, 2, tm.HDR_FUNC_ID] == 1 and frames[0, 2, tm.HDR_FUNC_ID] == 0
    np.testing.assert_array_equal(frames[1, 2].numpy(),
                                  tm.pack_frames(t, func_id=1, payload_words=usr[1, 2]).numpy())
    with pytest.raises(ValueError, match="payload_words"):
        tm.pack_frames(t, func_id=0, payload_words=torch.zeros(7, dtype=torch.int32))


def test_unpack_and_frame_valid_match_jax():
    rng = np.random.default_rng(2)
    geom = (4, 8, 12)
    j, t = jm.FrameSpec(*geom), tm.FrameSpec(*geom)
    usr, state = _words(rng, (8, 12)), _words(rng, (8, 8))
    frames = tm.pack_frames(t, func_id=5, seq_no=7, flags=2, state_words=torch.from_numpy(state),
                            payload_words=torch.from_numpy(usr)).numpy()
    o = t.offsets()
    frames[1, o["usr"] + 3] += 1                    # a corrupted USR word
    frames[2, o["sig"]] = 0                         # no SIG magic
    frames[3, tm.HDR_MAGIC] = 0                     # no header magic
    frames[4, o["sig"] + 1] ^= 1                    # a corrupted checksum
    frames[5] = 0                                   # never delivered
    valid = tm.frame_valid(t, torch.from_numpy(frames))
    assert valid.tolist() == [True, False, False, False, False, False, True, True]
    for i in range(len(frames)):
        assert bool(jm.frame_valid(j, jnp.asarray(frames[i]))) == bool(valid[i])
        want = jm.unpack_frame(j, jnp.asarray(frames[i]))
        got = tm.unpack_frame(t, torch.from_numpy(frames[i]))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_checksum_wraps_like_jax():
    rng = np.random.default_rng(3)
    cases = [np.array([I32.max, 1], np.int32), np.array([I32.min, -1], np.int32),
             np.full(64, I32.max, np.int32), _words(rng, (257,)), np.zeros(0, np.int32)]
    for w in cases:
        got = tm.checksum(torch.from_numpy(w))
        assert got.dtype == torch.int32
        assert int(got) == int(jm.checksum(jnp.asarray(w)))
    assert int(tm.checksum(torch.tensor([I32.max, 1], dtype=torch.int32))) == I32.min
    batch = _words(rng, (5, 16))
    np.testing.assert_array_equal(tm.checksum(torch.from_numpy(batch)).numpy(),
                                  [int(jm.checksum(jnp.asarray(r))) for r in batch])


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_float_words_match_jax_both_ways(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 100).astype(np.float32)
    x[0] = -0.0
    w_f32 = tm.f32_to_words(torch.from_numpy(x))
    np.testing.assert_array_equal(w_f32.numpy(), np.asarray(jm.f32_to_words(jnp.asarray(x))))
    np.testing.assert_array_equal(tm.words_to_f32(w_f32, (n,)).numpy().view(np.int32),
                                  x.view(np.int32))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    w_bf16 = tm.bf16_to_words(xb)
    assert w_bf16.shape == ((n + 1) // 2,)
    np.testing.assert_array_equal(
        w_bf16.numpy(), np.asarray(jm.bf16_to_words(jnp.asarray(x).astype(jnp.bfloat16))))
    back = tm.words_to_bf16(w_bf16, n, (n,))
    assert torch.equal(back.view(torch.int16), xb.view(torch.int16))
    j_back = jm.words_to_bf16(jnp.asarray(w_bf16.numpy()), n, (n,))
    np.testing.assert_array_equal(np.asarray(j_back).view(np.int16), xb.view(torch.int16).numpy())


@pytest.mark.parametrize("d,f,tokens", [(8, 12, 4), (5, 7, 3)])
def test_injection_words_match_jax(d, f, tokens):
    rng = np.random.default_rng(d * f)
    ws = [rng.standard_normal(s).astype(np.float32) for s in ((d, f), (d, f), (f, d))]
    t_ws = [torch.from_numpy(w).to(torch.bfloat16) for w in ws]
    j_ws = [jnp.asarray(w).astype(jnp.bfloat16) for w in ws]
    words = t_inj.expert_state_words(*t_ws)
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_inj.expert_state_words(*j_ws)))
    assert words.shape == (t_inj.expert_state_size_words(d, f),)
    assert t_inj.expert_state_size_words(d, f) == j_inj.expert_state_size_words(d, f)
    for a, b in zip(t_inj.unpack_expert_state(words, d, f), t_ws):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    t_spec = t_inj.injected_frame_spec(d, f, tokens)
    j_spec = j_inj.injected_frame_spec(d, f, tokens)
    assert (t_spec.got_slots, t_spec.state_words, t_spec.payload_words, t_spec.total_words) == (
        j_spec.got_slots, j_spec.state_words, j_spec.payload_words, j_spec.total_words)
    x = rng.standard_normal((tokens, d)).astype(np.float32)
    tw = t_inj.tokens_to_words(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(
        tw.numpy(), np.asarray(j_inj.tokens_to_words(jnp.asarray(x).astype(jnp.bfloat16))))
    assert torch.equal(t_inj.words_to_tokens(tw, tokens, d).float(),
                       torch.from_numpy(x).to(torch.bfloat16).float())

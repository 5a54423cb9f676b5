"""The handoff wire format's properties (the port of
``tests/test_handoff_properties.py``), with hypothesis at its example
counts: for any ticket, encode -> decode is the identity and a
retransmission is byte-identical; any single-bit flip, dropped,
duplicated or swapped frame, and any train the injector perturbs at rate
1.0, is detected by ``decode_handoff``. Every drawn ticket's train is also
held word for word against the JAX ``encode_handoff``'s.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.cluster import encode_handoff as j_encode
from repro.engine import MigrationTicket as JTicket
from repro_torch.cluster import decode_handoff, encode_handoff
from repro_torch.engine.engine import MigrationTicket
from repro_torch.faults import FaultInjector, FaultPlan
from test_torch_engine import share_cores_among_workers  # noqa: F401  (autouse)


def _random_ticket(seed, state_len, cls=MigrationTicket):
    """An arbitrary well-formed ticket; state_len 0 => stateless."""
    rng = np.random.default_rng(seed)
    return cls(
        rid=int(rng.integers(0, 1 << 30)),
        cache_kind=["paged", "slots", "recurrent"][int(rng.integers(3))],
        priority=int(rng.integers(-4, 5)),
        max_new_tokens=int(rng.integers(1, 64)),
        prompt=[int(t) for t in rng.integers(0, 1 << 20, size=int(rng.integers(1, 9)))],
        out_tokens=[int(t) for t in rng.integers(0, 1 << 20, size=int(rng.integers(0, 5)))],
        pos=int(rng.integers(0, 100)),
        state=bytes(rng.integers(0, 256, size=state_len, dtype=np.uint8)) if state_len else None)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 12000))
def test_roundtrip_any_ticket(seed, state_len):
    t = _random_ticket(seed, state_len)
    frames = encode_handoff(t)
    np.testing.assert_array_equal(frames, np.stack(j_encode(_random_ticket(seed, state_len,
                                                                             JTicket))))
    assert decode_handoff(frames) == t


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 9000))
def test_retransmission_is_byte_identical(seed, state_len):
    t = _random_ticket(seed, state_len)
    np.testing.assert_array_equal(encode_handoff(t), encode_handoff(t))


def test_empty_state_rides_as_none():
    """state=b"" encodes as state=None (FLAG_INJECTED means "carries
    bytes") and decodes back to None."""
    none_t = _random_ticket(5, 0)
    empty_t = dataclasses.replace(none_t, state=b"")
    np.testing.assert_array_equal(encode_handoff(none_t), encode_handoff(empty_t))
    assert decode_handoff(encode_handoff(empty_t)).state is None


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 9000), st.integers(0, 2**32 - 1))
def test_any_single_bit_flip_detected(seed, state_len, where):
    frames = encode_handoff(_random_ticket(seed, state_len))
    rng = np.random.default_rng(where)
    i = int(rng.integers(len(frames)))
    word = int(rng.integers(frames.shape[1]))
    bit = int(rng.integers(32))
    bad = frames.copy()
    bad[i].view(np.uint32)[word] ^= np.uint32(1) << np.uint32(bit)
    with pytest.raises(ValueError):
        decode_handoff(bad)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 9000), st.integers(0, 2**32 - 1))
def test_dropped_frame_detected(seed, state_len, where):
    frames = encode_handoff(_random_ticket(seed, state_len))
    i = int(np.random.default_rng(where).integers(len(frames)))
    with pytest.raises(ValueError):
        decode_handoff(np.delete(frames, i, axis=0))


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 9000), st.integers(0, 2**32 - 1))
def test_duplicated_frame_detected(seed, state_len, where):
    frames = encode_handoff(_random_ticket(seed, state_len))
    i = int(np.random.default_rng(where).integers(len(frames)))
    with pytest.raises(ValueError):
        decode_handoff(np.insert(frames, i, frames[i], axis=0))


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(8000, 20000), st.integers(0, 2**32 - 1))
def test_swapped_frames_detected(seed, state_len, where):
    frames = encode_handoff(_random_ticket(seed, state_len))
    assert len(frames) >= 2
    rng = np.random.default_rng(where)
    i = int(rng.integers(len(frames)))
    j = int(rng.integers(len(frames) - 1))
    j += j >= i                      # uniform over pairs with j != i
    train = frames.copy()
    train[[i, j]] = train[[j, i]]
    with pytest.raises(ValueError):
        decode_handoff(train)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 6000), st.integers(0, 3))
def test_injector_perturbations_always_detected(seed, state_len, kind_i):
    """A train the injector perturbs at rate 1.0 (one kind) never decodes,
    and the retransmission (a fresh encode) is the original train again."""
    kind = ("drop", "corrupt", "duplicate", "reorder")[kind_i]
    t = _random_ticket(seed, state_len)
    frames = encode_handoff(t)
    inj = FaultInjector(FaultPlan(seed=seed, frame_fault_rate=1.0, fault_kinds=(kind,)))
    perturbed = inj.perturb_train(frames, rid=t.rid)
    assert inj.injected == len(frames)
    with pytest.raises(ValueError):
        decode_handoff(perturbed)
    np.testing.assert_array_equal(frames, encode_handoff(t))

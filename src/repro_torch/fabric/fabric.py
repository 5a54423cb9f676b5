"""``Fabric``: the one function-invocation surface, on one device.

The port of ``repro/fabric/fabric.py``:

* ``fabric.install(ried)`` / ``fabric.bind(name, value)``: resident state
  into the fabric's ``GotTable``;
* ``@fabric.function(name, got_symbols=…, spec=…, result_words=…)``:
  register a frame-path jam handler (the batched ABI of
  ``core.registry``), its result width checked at registration when its
  symbols are already resolvable, else at the first dispatcher build;
* ``fabric.register_collective(name, invoke, placements=…)``: a function
  whose lowering is its own (the Engine's serve steps);
* ``fabric.call(name, payload, *, state=None, placement=…)``: frame
  functions pack their frames and dispatch them, eagerly (no cached
  compiled caller); collectives run their ``invoke``;
* ``fabric.pack`` / ``fabric.dispatcher``: the sender's and the
  receiver's halves of the frame path, for mailbox plumbing;
* ``fabric.lease(name, state, ttl_calls=…)``: the named warm-state pool;
* ``fabric.metrics()``: the telemetry surface, with the JAX keys.

Frame placements: ``"local"`` (state resident in the GOT, STATE empty),
``"injected"`` (``state=`` words packed into STATE; the spec needs STATE
room), ``"auto"`` (injected iff ``state`` is given). The MoE collective
transport (``moe_transport``) waits for ROADMAP A14.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core import transport as transport_lib
from repro_torch.core.got import GotTable
from repro_torch.core.message import FrameSpec
from repro_torch.core.registry import (Jam, RiedPackage, _JamPackageImpl,
                                       validate_result_width)
from repro_torch.core.transport import TransportEstimate
from repro_torch.fabric.leases import LeasePool

FRAME_PLACEMENTS = ("local", "injected", "auto")


class Fabric:
    """One function-invocation surface over jams, rieds, mailboxes and
    registered collectives, on one device."""

    def __init__(self, *, name: str = "fabric"):
        self.name = name
        self.got = GotTable()
        # frame functions grouped into lanes, one package per (spec,
        # result_words) geometry; func_ids are dense within a lane
        self._lanes: Dict[Tuple[FrameSpec, int], _JamPackageImpl] = {}
        self._frame_fn_lane: Dict[str, Tuple[FrameSpec, int]] = {}
        self._collectives: Dict[str, Callable] = {}
        self._collective_placements: Dict[str, Tuple[str, ...]] = {}
        self.leases = LeasePool(on_hit=self._gather_hit, on_miss=self._gather_miss)
        self._calls: Dict[str, int] = {}
        self._decisions: List[Tuple[str, TransportEstimate]] = []
        # bumped on any (re)bind or registration: drops the dispatchers
        # built against the previous GOT state
        self._generation = 0
        self._dispatchers: Dict[Tuple[Any, ...], Callable] = {}

    def _bump_generation(self) -> None:
        self._generation += 1
        self._dispatchers.clear()

    # -- resident state (rieds / GOT) ---------------------------------------

    def install(self, ried) -> "Fabric":
        """Install a ``RiedPackage`` (or any symbol -> value mapping) into
        the fabric's GOT. Returns self."""
        if isinstance(ried, RiedPackage) or hasattr(ried, "install"):
            ried.install(self.got)
        elif isinstance(ried, Mapping):
            for symbol, value in ried.items():
                self.got.bind(symbol, value)
        else:
            raise TypeError(f"cannot install {type(ried).__name__}; expected "
                            f"a RiedPackage or a symbol->value mapping")
        self._bump_generation()
        return self

    def bind(self, symbol: str, value: Any) -> int:
        """Bind one resident symbol (a one-symbol ried)."""
        idx = self.got.bind(symbol, value)
        self._bump_generation()
        return idx

    # -- registration ---------------------------------------------------------

    def function(self, name: str, *, spec: FrameSpec, result_words: int,
                 got_symbols: Sequence[str] = ()):
        """Decorator: register a frame-path jam handler under ``name``."""
        got_symbols = tuple(got_symbols)

        def deco(fn: Callable) -> Callable:
            if name in self._frame_fn_lane or name in self._collectives:
                raise ValueError(f"function {name!r} already registered on "
                                 f"fabric {self.name!r}")
            if got_symbols and all(s in self.got for s in got_symbols):
                # before the lane sees it: a failed registration must not
                # poison the lane's later dispatchers
                validate_result_width(Jam(name, -1, fn, got_symbols), spec, result_words,
                                      self.got.resolve(got_symbols), package=self.name)
            lane_key = (spec, result_words)
            lane = self._lanes.get(lane_key)
            if lane is None:
                lane = self._lanes[lane_key] = _JamPackageImpl(
                    f"{self.name}.lane{len(self._lanes)}", spec, result_words)
            lane.register(name, got_symbols)(fn)
            self._frame_fn_lane[name] = lane_key
            self._bump_generation()
            return fn
        return deco

    def register_collective(self, name: str, invoke: Callable, *,
                            placements: Tuple[str, ...]) -> None:
        """Register a function with its own lowering:
        ``invoke(payload, state, placement, **kwargs)``. A second
        registration under the same name is refused."""
        if name in self._collectives or name in self._frame_fn_lane:
            raise ValueError(f"function {name!r} already registered on "
                             f"fabric {self.name!r}")
        self._collectives[name] = invoke
        self._collective_placements[name] = placements
        self._bump_generation()

    def moe_transport(self, **kwargs) -> Callable:
        raise NotImplementedError(
            "the MoE jam transport is a collective across devices: it waits for "
            "ROADMAP A14 (multi-GPU)")

    @property
    def functions(self) -> Tuple[str, ...]:
        return tuple(sorted((*self._frame_fn_lane, *self._collectives)))

    # -- invocation -------------------------------------------------------------

    def call(self, name: str, payload, *, state=None, placement: str = "auto",
             **kwargs):
        """Invoke function ``name`` on ``payload``.

        Frame functions return the dispatcher's result words, ``(R,)`` for
        one ``(PW,)`` payload or ``(..., R)`` for a batch; collectives
        return what their ``invoke`` returns. Only calls that pass
        validation count in ``metrics()["calls"]``."""
        if name in self._collectives:
            if placement not in self._collective_placements[name]:
                raise ValueError(
                    f"collective {name!r} supports placements "
                    f"{self._collective_placements[name]}, got {placement!r}")
            self._calls[name] = self._calls.get(name, 0) + 1
            return self._collectives[name](payload, state, placement, **kwargs)
        if name not in self._frame_fn_lane:
            raise KeyError(f"no function {name!r} on fabric {self.name!r}; "
                           f"registered: {self.functions}")
        if kwargs:
            raise TypeError(f"frame function {name!r} takes no extra "
                            f"kwargs, got {sorted(kwargs)}")
        return self._frame_call(name, payload, state, placement)

    def pack(self, name: str, payload: torch.Tensor, *, state=None, src_rank=0,
             seq_no=0) -> torch.Tensor:
        """Sender side: the frames ``call`` would send, ``(..., PW)``
        payload words -> ``(..., W)`` frames."""
        lane = self._lanes[self._frame_fn_lane[name]]
        return lane.pack(name, self.got, payload_words=payload, state_words=state,
                         src_rank=src_rank, seq_no=seq_no)

    def dispatcher(self, spec: FrameSpec, result_words: int
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Receiver side: the dispatcher of one frame lane, ``(..., W)``
        frames -> ``(..., R)`` results (what ``drain_mailbox`` runs)."""
        lane = self._lanes.get((spec, result_words))
        if lane is None:
            raise KeyError(f"no frame functions registered for spec={spec} "
                           f"result_words={result_words}")
        key = (spec, result_words, self._generation)
        fn = self._dispatchers.get(key)
        if fn is None:
            fn = self._dispatchers[key] = lane.build_dispatcher(self.got)
        return fn

    def _frame_call(self, name: str, payload, state, placement: str):
        if placement not in FRAME_PLACEMENTS:
            raise ValueError(f"frame function {name!r}: placement must be "
                             f"one of {FRAME_PLACEMENTS}, got {placement!r}")
        spec, result_words = self._frame_fn_lane[name]
        if placement == "auto":
            # state given always means injection; a spec without STATE
            # room then raises the precise error below
            placement = "injected" if state is not None else "local"
        if placement == "local" and state is not None:
            raise ValueError(
                f"{name!r}: placement='local' invokes resident state (GOT); "
                f"state= must be None (use placement='injected' to ship it)")
        if placement == "injected":
            if not spec.state_words:
                raise ValueError(
                    f"{name!r}: placement='injected' needs a FrameSpec with "
                    f"state_words > 0 (this one has none)")
            if state is None:
                raise ValueError(f"{name!r}: placement='injected' requires "
                                 f"state= (the serialized function state)")
        dispatch = self.dispatcher(spec, result_words)
        self._calls[name] = self._calls.get(name, 0) + 1
        return dispatch(self.pack(name, payload, state=state))

    # -- leases (rFaaS warm state) -----------------------------------------------

    def lease(self, name: str, state: Sequence[Any], *,
              ttl_calls: Optional[int] = None,
              materialize: Optional[Callable[[], Any]] = None) -> Any:
        """Acquire or renew the named warm-state lease (``fabric.leases``)."""
        return self.leases.acquire(name, state, ttl_calls=ttl_calls,
                                   materialize=materialize)

    def evict(self, name: str) -> bool:
        return self.leases.evict(name)

    def _gather_hit(self) -> None:
        transport_lib.get_telemetry().gather_hits += 1

    def _gather_miss(self) -> None:
        transport_lib.get_telemetry().gather_misses += 1

    # -- telemetry ----------------------------------------------------------------

    def record_decision(self, name: str, est: TransportEstimate) -> None:
        self._decisions.append((name, est))

    @property
    def decisions(self) -> List[Tuple[str, TransportEstimate]]:
        """Raw ``placement="auto"`` (name, TransportEstimate) pairs, in call
        order."""
        return list(self._decisions)

    def metrics(self) -> Dict[str, Any]:
        """Registered functions, per-function call counts, auto-placement
        decisions, per-lease counters and the process-wide transport
        summary (JSON-friendly)."""
        return {
            "fabric": self.name,
            "functions": list(self.functions),
            "calls": dict(self._calls),
            "decisions": [f"{name}: {est.describe()}" for name, est in self._decisions],
            "leases": self.leases.metrics(),
            "transport_telemetry": transport_lib.get_telemetry().summary(),
        }

"""Jam and ried packages: the mobile functions and the resident state.

The port of ``repro/core/registry.py``. *Rieds* install resident symbols
into a ``GotTable`` (the receiver's interface library). *Jams* are the
mobile functions: a package assigns dense function ids (the Local Function
"vector of function pointers" of the paper's §IV-B) and builds a
dispatcher over its handlers. The deprecated ``JamPackage`` shim is not
ported: jams are registered on ``repro_torch.fabric.Fabric``.

Handler ABI, batched (PyTorch's idiom for the JAX package's per-frame
handlers under ``vmap``)::

    handler(got: tuple, state (N, SW) int32, usr (N, PW) int32) -> (N, R) int32

``got`` holds the resolved resident symbols of the jam, in the order it
named them. The dispatcher runs every jam of a package on the whole block
and selects each frame's row by its ``func_id`` (what vectorising the JAX
``lax.switch`` gives), so a handler must not mutate resident state: it
also runs on frames addressed to other jams.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.got import GotTable
from repro_torch.core.message import (FLAG_INJECTED, HDR_FUNC_ID, FrameSpec,
                                      frame_valid, pack_frames, unpack_frame)

Handler = Callable[[Tuple[Any, ...], torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Jam:
    name: str
    func_id: int
    handler: Handler
    got_symbols: Tuple[str, ...]


def _device_of(got: Tuple[Any, ...]) -> torch.device:
    return next((v.device for v in got if isinstance(v, torch.Tensor)),
                torch.device("cpu"))


def validate_result_width(jam: Jam, spec: FrameSpec, result_words: int,
                          got: Tuple[Any, ...], *, package: str) -> None:
    """Check that ``jam``'s handler gives ``result_words`` int32 words per
    frame for this geometry, before any dispatch: the handler runs once on
    a one-frame batch of zero STATE and USR words, on the device of the
    first tensor among ``got`` (else the CPU)."""
    dev = _device_of(got)
    state = torch.zeros((1, spec.state_words), dtype=torch.int32, device=dev)
    usr = torch.zeros((1, spec.payload_words), dtype=torch.int32, device=dev)
    try:
        out = jam.handler(got, state, usr)
    except Exception as e:
        raise ValueError(
            f"jam {jam.name!r} in package {package!r}: handler failed shape "
            f"validation on spec {spec} ({e})") from e
    if not isinstance(out, torch.Tensor):
        leaves = len(out) if isinstance(out, (tuple, list, dict)) else 1
        raise ValueError(
            f"jam {jam.name!r} in package {package!r}: handler must return "
            f"a single array of {result_words} words, got a pytree of "
            f"{leaves} leaves")
    if out.dim() == 0 or out.shape[0] != 1:
        raise ValueError(
            f"jam {jam.name!r} in package {package!r}: handler must return one "
            f"row per frame, (1, ...) for one frame, got shape {tuple(out.shape)}")
    n = math.prod(out.shape[1:])
    if n != result_words:
        raise ValueError(
            f"jam {jam.name!r} in package {package!r}: handler returns {n} "
            f"result words (shape {tuple(out.shape[1:])}), but the package "
            f"declares result_words={result_words}")


class _JamPackageImpl:
    """A named package of jams sharing one ``FrameSpec`` and result width
    (one frame lane of a ``Fabric``)."""

    def __init__(self, name: str, spec: FrameSpec, result_words: int):
        self.name = name
        self.spec = spec
        self.result_words = result_words
        self._jams: Dict[str, Jam] = {}
        self._order: List[Jam] = []

    def register(self, name: str, got_symbols: Sequence[str] = ()):
        def deco(fn: Handler) -> Handler:
            if name in self._jams:
                raise ValueError(f"jam {name!r} already registered in {self.name}")
            jam = Jam(name, len(self._order), fn, tuple(got_symbols))
            if not jam.got_symbols:
                # nothing to resolve: the width is known now
                validate_result_width(jam, self.spec, self.result_words, (),
                                      package=self.name)
            self._jams[name] = jam
            self._order.append(jam)
            return fn
        return deco

    def pack(self, name: str, got_table: GotTable, *, payload_words: torch.Tensor,
             state_words: Optional[torch.Tensor] = None, src_rank=0,
             seq_no=0) -> torch.Tensor:
        """Pack active messages for jam ``name``: ``(..., PW)`` payload words
        -> ``(..., W)`` frames on the payload's device."""
        jam = self._jams[name]
        flags = FLAG_INJECTED if state_words is not None and self.spec.state_words else 0
        return pack_frames(
            self.spec, func_id=jam.func_id,
            got=got_table.got_indices(jam.got_symbols, self.spec.got_slots,
                                      device=payload_words.device),
            state_words=state_words, payload_words=payload_words,
            src_rank=src_rank, seq_no=seq_no, flags=flags)

    def build_dispatcher(self, got_table: GotTable
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Dispatch: frames ``(..., W)`` -> results ``(..., R)`` int32.

        Invalid frames (bad magic, signal or checksum) give zero rows. A
        frame's ``func_id`` is clamped to the package's ids, as the JAX
        dispatcher clamps its ``lax.switch`` index. Every handler's width
        is checked, with its resolved GOT values, before the first block.
        """
        spec, width = self.spec, self.result_words
        branches = []
        for jam in self._order:
            got = got_table.resolve(jam.got_symbols)
            validate_result_width(jam, spec, width, got, package=self.name)
            branches.append((jam, got))

        def dispatch(frames: torch.Tensor) -> torch.Tensor:
            flat = frames.reshape(-1, frames.shape[-1])
            f = unpack_frame(spec, flat)
            func_id = flat[:, HDR_FUNC_ID].clamp(0, len(branches) - 1)
            out = torch.zeros((flat.shape[0], width), dtype=torch.int32,
                              device=flat.device)
            for k, (jam, got) in enumerate(branches):
                rows = jam.handler(got, f["state"], f["usr"])
                rows = rows.reshape(flat.shape[0], width).to(torch.int32)
                out = torch.where((func_id == k)[:, None], rows, out)
            out = torch.where(frame_valid(spec, flat)[:, None], out, 0)
            return out.reshape(frames.shape[:-1] + (width,))

        return dispatch


class RiedPackage:
    """Interface distribution: a named setup of resident symbols.
    ``install`` runs every exported initializer against a ``GotTable``."""

    def __init__(self, name: str):
        self.name = name
        self._exports: List[Tuple[str, Callable[[], Any]]] = []

    def export(self, symbol: str):
        def deco(init_fn: Callable[[], Any]):
            self._exports.append((symbol, init_fn))
            return init_fn
        return deco

    def install(self, got: GotTable) -> None:
        for symbol, init_fn in self._exports:
            got.bind(symbol, init_fn())

    @property
    def symbols(self) -> Tuple[str, ...]:
        return tuple(s for s, _ in self._exports)

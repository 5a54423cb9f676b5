"""GOT (global offset table) analogue: per-process symbol binding.

The port of ``repro/core/got.py``. A ``GotTable`` maps symbol names to
dense indices and resident values (tensors or any Python object); jam
handlers receive the resolved values of their symbols, in order, as their
first argument. Senders pack indices into a frame's GOTP section;
receivers check layout agreement with ``layout_hash``, which is the JAX
package's hash for the same bindings, so frames cross between the two.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


class GotTable:
    """Symbol name -> (index, resident value)."""

    def __init__(self) -> None:
        self._index: Dict[str, int] = {}
        self._values: List[Any] = []

    def bind(self, name: str, value: Any) -> int:
        """Install or replace a resident symbol; returns its GOT index."""
        if name in self._index:
            self._values[self._index[name]] = value
            return self._index[name]
        self._index[name] = len(self._values)
        self._values.append(value)
        return self._index[name]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def value_of(self, name: str) -> Any:
        return self._values[self._index[name]]

    def __contains__(self, name: str) -> bool:
        return name in self._index

    @property
    def symbols(self) -> Tuple[str, ...]:
        return tuple(sorted(self._index, key=self._index.get))

    def resolve(self, names: Sequence[str]) -> Tuple[Any, ...]:
        missing = [n for n in names if n not in self._index]
        if missing:
            raise KeyError(f"unresolved GOT symbols {missing}; "
                           f"resident: {self.symbols}")
        return tuple(self._values[self._index[n]] for n in names)

    def got_indices(self, names: Sequence[str], slots: int, device=None) -> torch.Tensor:
        """GOTP section content for a frame (padded with -1), on ``device``
        (default ``cuda``; ``"cpu"`` to ask for the CPU)."""
        idx = [self._index[n] for n in names]
        idx += [-1] * (slots - len(idx))
        return torch.tensor(idx[:slots], dtype=torch.int32, device=resolve_device(device))

    def layout_hash(self) -> int:
        """Hash of the symbol -> index layout; sender and receiver must
        agree before GOTP indices mean anything (the namespace exchange of
        the paper's §V)."""
        h = hashlib.sha256(";".join(
            f"{n}={i}" for n, i in sorted(self._index.items())).encode())
        return int.from_bytes(h.digest()[:4], "little")

    def check_layout(self, other_hash: int) -> None:
        if self.layout_hash() != other_hash:
            raise RuntimeError(
                "GOT layout mismatch between sender and receiver — run the "
                "namespace exchange (install the same rieds) first.")

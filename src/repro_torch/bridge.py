"""Convert the JAX package's parameter trees (as numpy) into the port's.

The JAX model keeps ``params["groups"][g][p]``: one tree per position ``p``
of each repeated layer pattern ``g`` of ``layer_plan``, with a leading
``repeats`` axis **only when repeats > 1**. The port keeps one tree per
layer, ``params["layers"][i]``, in ``flat_block_types`` order (for each
repeat, the pattern in order). Top level: ``embed`` (V, d),
``final_norm`` (d,), ``head`` (d, V) when untied.

No transposition is made anywhere: every weight keeps its JAX layout
(``wq`` (d, H, D), ``wk``/``wv`` (d, K, D), ``wo`` (H, D, d), ``w_gate``/
``w_up`` (d, f), ``w_down`` (f, d), ``in_proj`` (d, 2 inner), ``conv_w``
(W, inner), ``a_log`` (inner, N); mLSTM's ``up_proj`` (d, 2 inner),
``wq``/``wk``/``wv`` (H, dh, dh), ``w_gates`` (inner, 2 H); sLSTM's
``w_in`` (d, 4 d), ``r_rec`` (H, dh, 4 dh), ``ff_up`` (d, 2 f); MLA's
``wq`` (d, H, dn + dr), ``w_dkv`` (d, r + dr), ``kv_norm`` (r,), ``w_uk``
(r, H, dn), ``w_uv`` (r, H, dv),
``wo`` (H, dv, d); the shared experts' ``ws_gate``/``ws_up`` (d, f_s),
``ws_down`` (f_s, d)). Dtypes are kept; bfloat16 arrays are
moved bit for bit. The bridge takes numpy only and imports no JAX.

``opt_state_from_jax`` does the same for an AdamW state.
``recurrent_cache_from_jax`` and ``slot_cache_from_jax`` do the same for a
recurrent and a contiguous cache, so that both packages can start from one
mid-sequence state and their caches can be compared. ``got_from_jax`` and
``mailbox_from_jax`` carry a GOT and a mailbox across; frames themselves
cross as plain int32 arrays. ``state_from_jax`` turns a request's state
buffer exported by the JAX engine (``RST1``) into the port's, so a JAX
``MigrationTicket``'s state imports into the port's engine.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.got import GotTable
from repro_torch.models import blocks as blocks_mod
from repro_torch.models.kvcache import state_leaves, state_to_bytes
from repro_torch.models.model import layer_plan


def to_tensor(arr: Any, device=None) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16) -> tensor with the same dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def flatten_groups(groups: List[List[Any]], cfg: ModelConfig) -> List[Any]:
    """``groups[g][p]`` trees (leaves with a leading repeats axis when the
    group repeats) -> one tree per layer, in ``flat_block_types`` order."""
    def take(tree, r, stacked):
        if isinstance(tree, dict):
            return {k: take(v, r, stacked) for k, v in tree.items()}
        return tree[r] if stacked else tree

    layers = []
    for g_idx, (pattern, repeats) in enumerate(layer_plan(cfg)):
        for r in range(repeats):
            for p_idx in range(len(pattern)):
                layers.append(take(groups[g_idx][p_idx], r, repeats > 1))
    return layers


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """``repro.models.model.init_params(...)[0]`` passed as numpy arrays ->
    the port's parameter dict on ``device`` (default: the CPU)."""
    out = {k: to_tensor(v, device) for k, v in np_tree.items() if k != "groups"}
    out["layers"] = [_tree_to_torch(t, device)
                     for t in flatten_groups(np_tree["groups"], cfg)]
    return out


def opt_state_from_jax(np_opt: Any, cfg: ModelConfig, device=None):
    """A JAX ``AdamWState`` (``step``, ``m``, ``v``; the moments in the JAX
    parameter tree), passed as numpy arrays -> the port's ``AdamWState``
    on ``device`` (default: the CPU), the moments in the port's tree."""
    from repro_torch.optim.adamw import AdamWState

    step, m, v = np_opt
    return AdamWState(step=to_tensor(np.asarray(step, np.int32), device),
                      m=params_from_jax(m, cfg, device), v=params_from_jax(v, cfg, device))


def recurrent_cache_from_jax(np_cache: Dict[str, Any], cfg: ModelConfig,
                             device=None) -> Dict[str, Any]:
    """``repro.models.model.init_cache`` or a recurrent step's new cache
    (``{"length", "groups": [[...]]}``: ``{"conv", "state"}`` for an SSM
    layer, ``{"conv", "state", "n", "m"}`` for an mLSTM one, ``{"state",
    "c", "n", "m"}`` for an sLSTM one, leaves with a leading repeats axis
    when the group repeats), passed as numpy arrays -> the port's
    ``{"layers": [...]}`` of the same dicts. The shared ``length`` scalar
    is dropped: the port's per-request positions live in the engine."""
    return {"layers": [_tree_to_torch(t, device)
                       for t in flatten_groups(np_cache["groups"], cfg)]}


def slot_cache_from_jax(np_cache: Dict[str, Any], cfg: ModelConfig,
                        device=None) -> Dict[str, Any]:
    """``repro.models.model.init_cache`` or a contiguous forward's new cache
    (``{"length", "groups": [[{"k", "v"}]]}``, ``{"c_kv", "k_rope"}`` for an
    MLA layer, the state dicts of ``recurrent_cache_from_jax`` for a state
    layer, ``{"k", "v", "conv", "state"}`` for a hybrid one, leaves with a
    leading repeats axis when the group repeats), passed as numpy arrays
    -> the port's ``{"length": int, "layers": [...]}`` of the same
    dicts."""
    return {"length": int(np_cache["length"]),
            "layers": [_tree_to_torch(t, device)
                       for t in flatten_groups(np_cache["groups"], cfg)]}


def got_from_jax(symbols: Sequence[str], np_values: Sequence[Any], device=None) -> GotTable:
    """A ``repro.core.got.GotTable``'s ``symbols`` (in index order) and its
    values (numpy arrays, or any other Python object, kept as it is) -> the
    port's ``GotTable`` with the same indices, hence the same
    ``layout_hash``."""
    got = GotTable()
    for name, value in zip(symbols, np_values, strict=True):
        got.bind(name, to_tensor(value, device) if isinstance(value, np.ndarray) else value)
    return got


def mailbox_from_jax(np_mb: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """``repro.core.mailbox.init_mailbox``-shaped ``{"frames", "credits",
    "head"}`` as numpy -> the port's mailbox on ``device``."""
    return {k: to_tensor(v, device) for k, v in np_mb.items()}


def _layer_keys(bt: str, cfg: ModelConfig, cache_kind: str) -> List[str]:
    """A layer's cache keys in the port's order, for one backend (read off
    shapeless ``meta`` tensors)."""
    if cache_kind == "paged":
        one = blocks_mod.init_paged_block_cache(bt, cfg, 1, 1, device="meta")
    elif cache_kind == "recurrent":
        one = blocks_mod.init_recurrent_block_cache(bt, cfg, 1, device="meta")
    else:
        one = blocks_mod.init_block_cache(bt, cfg, 1, 1, device="meta")
    return list(one)


def state_from_jax(cfg: ModelConfig, cache_kind: str, buf: bytes) -> bytes:
    """A state buffer written by the JAX engine (``SequenceState.serialize``
    of its ``cache_kind`` backend) -> the same state in the port's buffer
    format. The JAX tree flattens as ``{"groups": [[{key: leaf}]],
    "length"}`` with dict keys sorted and a leading repeats axis on each
    leaf of a repeated group (the paged buffer has no ``length``); the
    port's is one dict a layer, in ``flat_block_types`` order, then (slots
    only) ``length`` first. The bytes of each leaf move as they are."""
    leaves = state_leaves(buf)
    plan = layer_plan(cfg)
    n_leaves = sum(len(_layer_keys(bt, cfg, cache_kind)) for pattern, _ in plan
                   for bt in pattern) + (cache_kind != "paged")
    if len(leaves) != n_leaves:
        raise ValueError(f"a JAX {cache_kind} state of {cfg.name} has {n_leaves} leaves, "
                         f"the buffer {len(leaves)}")
    it = iter(leaves)
    groups = [[{k: next(it) for k in sorted(_layer_keys(bt, cfg, cache_kind))}
               for bt in pattern] for pattern, _ in plan]
    layers = []
    for (pattern, repeats), group in zip(plan, groups):
        for r in range(repeats):
            for bt, tree in zip(pattern, group):
                layers.append({k: tree[k][r] if repeats > 1 else tree[k]
                               for k in _layer_keys(bt, cfg, cache_kind)})
    if cache_kind == "slots":
        return state_to_bytes({"length": next(it), "layers": layers})
    return state_to_bytes({"layers": layers})

"""``repro_torch.engine.Engine`` — the serving engine: paged, recurrent and
slots backends.

The port of the JAX package's ``engine/engine.py``: one submit/admit/step/
complete loop (``tick``) over a sequence-state backend, a pluggable
``SchedulerPolicy`` (admission order, victim choice, block budgets) and
streaming outputs through ``RequestHandle``. The paged backend gates
admission on its block budget, prefills in chunks through the same
fixed-shape step as decode and preempts by recompute when the pool runs
dry; the recurrent backend gates on free slots alone and preempts
(``preempt(rid)``) by snapshot and resume; the slots backend prefills each
admitted request in one forward into a fresh contiguous row, decodes every
slot in lockstep at one shared cache length, and cannot preempt.

Fabric-routed invocation: the steps are registered on the step bundle's
``Fabric`` (``engine.paged_step`` / ``engine.recurrent_step``, or
``engine.decode`` and ``engine.prefill`` for slots) and every tick invokes
them through ``fabric.call`` at the engine's ``placement`` (a prefill
always at ``"local"``, as in the JAX package): ``"local"`` (weights
resident), ``"injected"`` (the step's params lease is acquired every tick:
the first acquire is the injection, a miss; later ticks hit warm) or
``"auto"`` (injected while that lease is warm, local while it is cold;
each resolution is recorded as a ``TransportEstimate``). Placement never
changes the math: every branch runs the same step on the same device.

Live migration and the failure lifecycle, the replica side of
``repro_torch.cluster``: ``export_request`` detaches a queued or running
request into a position-independent ``MigrationTicket`` (its state in the
``RST1`` format), ``import_request`` queues one and restores its state at
admission instead of a prefill, ``snapshot_request`` serializes without
releasing anything; ``fail`` refuses every verb until ``restart``, which
abandons all request state and keeps the params and the built steps;
``fault_hook`` fires between placement resolution and step execution.

Graph runs (``repro_torch.fabric.graph``): ``submit_graph`` queues a
``GraphRun`` whose node invocations every tick advances one round beside
the request rows, its node outputs leased on the engine's fabric. A
``DecodeSession`` steps through the same ``engine.paged_step`` as the
ticks, and a speculation round through ``engine.paged_verify``, the paged
step built with ``emit="all"`` (``ensure_verify_step``), registered on the
same fabric and counted in ``steps``/``verify_steps`` and
``kernel_launches``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import default_cache_backend
from repro_torch.core.transport import TransportEstimate
from repro_torch.core.transport import get_telemetry as transport_telemetry
from repro_torch.device import resolve_device
from repro_torch.engine.scheduler import (SchedulerPolicy, SchedulerState, _PolicyBase,
                                          resolve_policy)
from repro_torch.engine.state import PagedKVState, RecurrentState, SlotKVState
from repro_torch.engine.stream import RequestHandle
from repro_torch.faults.errors import EngineFailedError
from repro_torch.models import model as model_lib
from repro_torch.models.kvcache import state_to_bytes
from repro_torch.runtime.steps import (LAUNCH_COUNTERS, make_paged_serve_step,
                                       make_prefill_step, make_recurrent_serve_step,
                                       make_serve_step)

__all__ = ["Request", "Engine", "MigrationTicket"]

PLACEMENTS = ("local", "injected", "auto")


@dataclasses.dataclass
class Request:
    """One generation request.

    ``priority`` is read by priority-aware scheduler policies (higher =
    more urgent). ``arrival_tick`` is stamped by ``Engine.submit``.
    """

    rid: int
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int = 16
    priority: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    arrival_tick: int = -1


@dataclasses.dataclass
class MigrationTicket:
    """Position-independent snapshot of one in-flight request, the unit of
    live migration (``Engine.export_request`` -> wire ->
    ``Engine.import_request``).

    ``state`` is the ``SequenceState.serialize`` buffer covering the first
    ``pos`` tokens of prompt ++ out_tokens (None when nothing is resident:
    the target recomputes). It holds logical token order only, no block
    ids or slot indices, so source and target may differ in pool geometry;
    only the model and ``cache_kind`` must match.
    """

    rid: int
    cache_kind: str
    priority: int
    max_new_tokens: int
    prompt: List[int]
    out_tokens: List[int]
    pos: int = 0                        # tokens the state buffer covers
    state: Optional[bytes] = None


@dataclasses.dataclass
class _Entry:
    """Scheduler state for one request (queued -> running -> finished, with
    running -> queued on preemption)."""

    req: Request
    handle: Optional[RequestHandle] = None
    pos: int = 0                        # tokens resident in the cache
    blocks: List[int] = dataclasses.field(default_factory=list)
    admit_seq: int = -1                 # first-admission stamp (victim order)
    arrival_seq: int = -1               # submit-order stamp (policy ties)
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    first_token_tick: Optional[int] = None
    preemptions: int = 0
    prompt_tokens: List[int] = dataclasses.field(default_factory=list)
    snapshot: Optional[Any] = None      # recurrent backend: evicted state rows
    inbound: Optional[bytes] = None     # migrated-in state, restored at admission

    def seq(self) -> List[int]:
        """prompt ++ generated — what must be resident before decoding."""
        return self.prompt_tokens + self.req.out_tokens


class Engine:
    """Serving engine on one device.

    ``cache="paged"``: shared per-layer block pool (``num_blocks`` x
    ``block_size`` tokens), chunked prefill (``chunk`` tokens per tick)
    through the same step as decode, block-budget-gated admission,
    preempt-and-requeue (recompute) on pool exhaustion.
    ``cache="recurrent"`` (SSM and xLSTM stacks): constant-size state
    per slot, chunked prefill likewise, admission on free slots
    alone, preemption by snapshot and resume. ``cache="auto"`` takes
    ``registry.default_cache_backend``.

    ``kernel`` selects every kernel of the step (paged attention and the
    MoE expert FFN, or the selective scan): ``"cuda"`` (the hand-written
    kernels), ``"ref"`` (their plain versions) or ``"auto"`` (``cuda`` on
    the card, ``ref`` on the CPU); unlike the JAX engine, it applies to the
    recurrent backend too. ``device`` defaults to ``cuda`` and raises when
    there is no card; tests pass ``device="cpu"``. ``placement`` routes
    each tick's step through the bundle's fabric (see the module
    docstring). ``compute_dtype`` is the steps' compute dtype and the
    cache's (tests run float32 engines against the JAX package's float32
    forward).
    """

    _ids = itertools.count()

    def __init__(self, cfg: ModelConfig, *, device=None, cache: str = "paged",
                 slots: int, max_len: int, scheduler="fifo",
                 kernel: str = "auto", num_blocks: Optional[int] = None,
                 block_size: int = 16, chunk: int = 8,
                 eos_id: Optional[int] = None, engine_id: Optional[str] = None,
                 placement: str = "local", compute_dtype: torch.dtype = torch.bfloat16):
        if cfg.is_encoder:
            raise ValueError("encoder-only arch has no decode path")
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be 'local', 'injected', or "
                             f"'auto', got {placement!r}")
        if cache == "auto":
            cache = default_cache_backend(cfg)
        if cache not in ("paged", "slots", "recurrent"):
            raise ValueError(f"cache must be 'paged', 'slots', or 'recurrent', "
                             f"got {cache!r}")
        if cache == "paged" and num_blocks is None:
            raise ValueError("cache='paged' requires num_blocks=")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cache_kind = cache
        self.engine_id = engine_id or f"engine-{next(Engine._ids)}"
        self.placement = placement
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        self.policy: SchedulerPolicy = resolve_policy(scheduler)
        self.params: Optional[Dict[str, Any]] = None
        self.cache: Optional[Dict[str, Any]] = None
        self.ticks = 0
        self.steps = 0                         # step runs: ticks, graph sessions
        self.completed: List[Request] = []
        self.queue: List[_Entry] = []
        self.slot_entry: List[Optional[_Entry]] = [None] * slots
        self._finished: List[_Entry] = []
        self._submit_counter = 0
        self._admit_counter = 0
        self.admission_log: List[int] = []     # rids in first-admission order
        self.peak_active = 0
        self.preempt_count = 0
        self.migrations_in = 0
        self.migrations_out = 0
        self._pending_pump: List[_Entry] = []
        self._placements: Dict[str, str] = {}
        self.compute_dtype = compute_dtype
        self._params_nbytes_memo: Optional[int] = None
        # the chaos and recovery surface (repro_torch.faults): a failed
        # engine refuses tick/submit/export/import/snapshot until restart();
        # fault_hook fires between placement resolution and step execution
        # (the lease-expiry window); lease_fallbacks counts auto resolutions
        # of injected demoted to local because the params lease went cold
        # in that window
        self.failed_reason: Optional[str] = None
        self.fault_hook: Optional[Callable[[str], None]] = None
        self.lease_fallbacks = 0
        # the graph tier (fabric.graph): active runs advanced one round per
        # tick, and the multi-token verify step, built at first use
        self._graphs: List[Any] = []
        self._graphs_done: List[Any] = []
        self.graph_invocations = 0
        self.verify_steps = 0                  # verify-step invocations
        self.verify_bundle = None

        self.chunk = chunk
        if cache == "paged":
            self.block_size = block_size
            self.num_blocks = num_blocks
            self.max_blocks_per_seq = -(-max_len // block_size)
            if num_blocks < self.max_blocks_per_seq:
                raise ValueError(
                    f"num_blocks={num_blocks} cannot hold one max_len={max_len} "
                    f"request ({self.max_blocks_per_seq} blocks of {block_size})")
            self.bundle = make_paged_serve_step(
                cfg, slots=slots, chunk=chunk, num_blocks=num_blocks,
                block_size=block_size, max_blocks_per_seq=self.max_blocks_per_seq,
                kernel=kernel, device=self.device, compute_dtype=compute_dtype)
            # per-step live-token fraction: resident tokens / pool token capacity
            self._live_frac_last = 0.0
            self._live_frac_sum = 0.0
            self._live_frac_ticks = 0
            self.peak_blocks_used = 0
        elif cache == "recurrent":
            self.bundle = make_recurrent_serve_step(
                cfg, slots=slots, chunk=chunk, kernel=kernel, device=self.device,
                compute_dtype=compute_dtype)
        else:
            self.bundle = make_serve_step(cfg, slots=slots, kernel=kernel, device=self.device,
                                          compute_dtype=compute_dtype)
            self.prefill_bundle = make_prefill_step(cfg, max_len=max_len, kernel=kernel,
                                                    device=self.device,
                                                    compute_dtype=compute_dtype)
        self._make_state()
        if not self.state.supports_preemption:
            pv = getattr(type(self.policy), "pick_victim", None)
            if pv is not None and pv is not _PolicyBase.pick_victim:
                warnings.warn(
                    f"cache='slots' has no preemption path: "
                    f"{type(self.policy).__name__}.pick_victim will never "
                    "be consulted (admission order still applies); use "
                    "cache='paged' or 'recurrent' for preemption-aware "
                    "scheduling", UserWarning, stacklevel=2)
        # the fabric of the bundle built here; a bundle swapped in later
        # (tests build their step in float32) runs through the same seam
        self.fabric = self.bundle.meta["fabric"]
        self._step_name = "engine.decode" if cache == "slots" else f"engine.{cache}_step"
        self._params_lease = f"{self._step_name}.params"
        self._register_fabric_steps()
        # resolved kernel kind ("cuda" | "ref"), and CUDA kernel launches in
        # steps, per kernel the steps can run
        self.kernel: str = self.bundle.meta["kernel"]
        self.kernel_launches = {name: 0 for name in self.bundle.meta["kernels"]}

    def _make_state(self) -> None:
        """(Re)build the sequence-state backend empty: shared by
        ``__init__`` and ``restart()`` (a restarted replica rejoins with a
        fresh pool and no request state)."""
        if self.cache_kind == "paged":
            self.state = PagedKVState(self.num_blocks, self.block_size)
            self.pool = self.state.pool
        elif self.cache_kind == "recurrent":
            self.state = RecurrentState(self.slots, lambda: model_lib.init_recurrent_cache(
                self.cfg, 1, dtype=self.compute_dtype, device=self.device))
        else:
            self.state = SlotKVState(self.slots)

    def _fresh_cache(self) -> Dict[str, Any]:
        kw = dict(dtype=self.compute_dtype, device=self.device)
        if self.cache_kind == "paged":
            return model_lib.init_paged_cache(self.cfg, self.num_blocks, self.block_size, **kw)
        if self.cache_kind == "recurrent":
            return model_lib.init_recurrent_cache(self.cfg, self.slots, **kw)
        return model_lib.init_cache(self.cfg, self.slots, self.max_len, **kw)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def load_params(self, params: Optional[Dict[str, Any]] = None,
                    seed: int = 0) -> None:
        """Install model weights: ``params`` moved to the engine's device,
        or random bf16 weights drawn on the device from ``seed``."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = model_lib.init_params(self.cfg, gen, self.device,
                                           dtype=torch.bfloat16)
        self.params = _to_device(params, self.device)
        self._params_nbytes_memo = None
        self.cache = self._fresh_cache()

    def inject_params(self, params: Optional[Dict[str, Any]] = None,
                      seed: int = 0) -> None:
        """Install weights *and* warm the step's params lease: the executor
        side of ``placement="injected"``/``"auto"``. Afterwards ``auto``
        resolves injected (warm reuse ships nothing) from the first tick,
        and the injection itself is the lease's one miss."""
        self.load_params(params, seed)
        self.fabric.lease(self._params_lease, list(_leaves(self.params)))

    # -- failure lifecycle (the replica side of cluster failover) ----------

    @property
    def alive(self) -> bool:
        return self.failed_reason is None

    def fail(self, reason: str = "injected failure") -> None:
        """Enter the failed state: every later tick, submit, export,
        import and snapshot raises ``EngineFailedError`` until
        ``restart()``. Host-side bookkeeping (metrics, completed requests)
        stays readable."""
        self.failed_reason = reason

    def restart(self) -> None:
        """Simulate a process restart: clear the failure and abandon ALL
        request state (queue, slots, pool blocks, stream handles), so the
        replica rejoins empty; the router has recovered its requests
        elsewhere. The params and the built steps survive."""
        self.failed_reason = None
        for entry in self._entries_everywhere():
            entry.handle = None
        self.queue.clear()
        self.slot_entry = [None] * self.slots
        self._pending_pump.clear()
        self._graphs.clear()                    # sessions die with the pool
        self._make_state()
        if self.params is not None:
            self.cache = self._fresh_cache()

    def _check_alive(self, what: str) -> None:
        if self.failed_reason is not None:
            raise EngineFailedError(self.engine_id,
                                    f"{self.failed_reason} (refusing {what})")

    def pending(self) -> bool:
        """True while any request is queued or occupying a slot, or any
        graph run is still looping."""
        return bool(self.queue or any(e is not None for e in self.slot_entry)
                    or any(not run.done for run in self._graphs))

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Serve until queue + slots drain; returns completed requests."""
        while self.pending() and self.ticks < max_ticks:
            self.tick()
        return self.completed

    # ------------------------------------------------------------------
    # request plumbing
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> RequestHandle:
        """Queue a request; returns its streaming ``RequestHandle``."""
        self._check_alive("submit")
        msg = self.state.validate(len(req.prompt), req.max_new_tokens, self.max_len)
        if msg:
            raise ValueError(f"request {req.rid}: {msg}")
        req.arrival_tick = self.ticks
        entry = _Entry(req=req, submit_time=time.perf_counter(),
                       arrival_seq=self._submit_counter,
                       prompt_tokens=[int(t) for t in req.prompt])
        self._submit_counter += 1
        entry.handle = RequestHandle(self, req)
        self.queue.append(entry)
        return entry.handle

    def submit_graph(self, spec, inputs, *, loop_until=None, max_rounds: int = 256,
                     resolve=None, on_node_error=None):
        """Queue a ``fabric.graph`` run; returns its streaming
        ``GraphHandle``. Each ``tick`` advances every active graph one
        round (all nodes once, in topological order) after the request
        rows; node outputs land as warm leases on this engine's fabric
        (``graph/<gid>/<node>``), and ``handle.tokens()`` drives ``tick()``
        as ``RequestHandle.tokens()`` does. Graphs that loop
        (``loop_until``) keep their round cadence: one speculation round a
        tick for the draft/verify graph."""
        self._check_alive("submit_graph")
        from repro_torch.fabric.graph.executor import GraphRun
        run = GraphRun(spec, inputs, fabric=self.fabric, loop_until=loop_until,
                       max_rounds=max_rounds, resolve=resolve,
                       on_node_error=on_node_error)
        self._graphs.append(run)
        return run.handle._bind(self)

    def _tick_graphs(self) -> int:
        """Advance every active graph run one round; returns the number of
        node invocations fired."""
        fired = 0
        for run in list(self._graphs):
            if not run.done:
                fired += run.advance()
            if run.done:
                self._graphs.remove(run)
                self._graphs_done.append(run)
        self.graph_invocations += fired
        return fired

    def _sched_state(self, block_budget: Optional[int]) -> SchedulerState:
        return SchedulerState(
            tick=self.ticks,
            free_slots=sum(e is None for e in self.slot_entry),
            block_budget=block_budget,
            blocks_needed=self.state.units_needed,
            capacity=self.state.capacity())

    def _stamp_admitted(self, entry: _Entry) -> None:
        if entry.admit_seq < 0:
            entry.admit_seq = self._admit_counter
            self._admit_counter += 1
            self.admission_log.append(entry.req.rid)

    def _emit(self, entry: _Entry, tok: int) -> None:
        """Append one generated token + TTFT stamps; stream delivery waits
        for ``_flush_streams`` at the end of the tick, so a raising client
        callback cannot abort the engine's bookkeeping mid-loop."""
        entry.req.out_tokens.append(tok)
        if len(entry.req.out_tokens) == 1:
            entry.first_token_time = time.perf_counter()
            entry.first_token_tick = self.ticks
        if entry.handle is not None:
            self._pending_pump.append(entry)

    def _flush_streams(self) -> None:
        while self._pending_pump:
            entry = self._pending_pump.pop(0)
            if entry.handle is not None:
                entry.handle._pump()

    def _complete(self, slot: int, entry: _Entry) -> None:
        entry.req.done = True
        self.state.release(entry)
        self.completed.append(entry.req)
        self._finished.append(entry)
        self.slot_entry[slot] = None

    def _entries_everywhere(self) -> List[_Entry]:
        out = list(self.queue) + [e for e in self.slot_entry if e is not None]
        out.extend(self._finished)
        return out

    # ------------------------------------------------------------------
    # tick — one admit/step/complete round
    # ------------------------------------------------------------------

    def _admit_chunked(self) -> None:
        """Policy-gated admission: the policy picks the next queued entry;
        it admits only when a slot is free AND the backend can hold its
        whole resident prefix plus one decode token. ``budget`` tracks the
        blocks already promised to entries admitted in this same call — they
        are allocated later in the tick, so reading free blocks alone would
        over-commit the pool. The recurrent backend's capacity is not
        consumable (``free_units`` None): it gates on free slots alone."""
        budget = self.state.capacity().free_units
        while self.queue:
            free_slots = [i for i, e in enumerate(self.slot_entry) if e is None]
            if not free_slots:
                return
            state = self._sched_state(budget)
            idx = self.policy.admit(self.queue, state)
            if idx is None:
                return                  # policy head blocked => wait
            entry = self.queue.pop(idx)
            if budget is not None:
                budget -= max(self.policy.budget(entry, state),
                              self.state.units_needed(entry))
            self._stamp_admitted(entry)
            slot = free_slots[0]
            self.slot_entry[slot] = entry
            self.cache = self.state.init(entry, self.cache, slot)
            if entry.inbound is not None:
                self._restore_inbound(entry, slot)

    def _restore_inbound(self, entry: _Entry, slot: int) -> None:
        """Absorb a migrated-in request's state into ``slot``, the admission
        side of ``import_request``. A paged entry first grows blocks over
        its resident prefix (which may preempt a victim, as a native
        request's growth would). Afterwards the entry is one that prefilled
        here: chunked backends resume at ``entry.pos``, slots decode from
        ``out_tokens[-1]``."""
        if self.cache_kind == "paged":
            self._ensure_capacity(entry, max(entry.pos, 1))
        self.cache = self.state.restore(entry, self.cache, slot, entry.inbound)
        entry.inbound = None

    def _preempt(self, victim: _Entry) -> None:
        """Evict the victim through the backend (paged: its blocks return
        to the pool and ``pos`` resets, so re-admission recomputes;
        recurrent: its state is snapshot and ``pos`` kept, so re-admission
        resumes) and requeue it in admission order: before every
        never-admitted entry and every previously preempted entry with a
        younger admit stamp. Generated tokens are kept."""
        slot = self.slot_entry.index(victim)
        self.cache = self.state.evict(victim, self.cache, slot)
        victim.preemptions += 1
        self.preempt_count += 1
        self.slot_entry[slot] = None
        at = next((i for i, e in enumerate(self.queue)
                   if e.admit_seq < 0 or e.admit_seq > victim.admit_seq),
                  len(self.queue))
        self.queue.insert(at, victim)

    def preempt(self, rid: int) -> None:
        """Evict a running request by id through the backend's preemption
        path and requeue it (admission-ordered): paged requeues recompute
        the prefix, recurrent ones resume from their state snapshot."""
        for entry in self.slot_entry:
            if entry is not None and entry.req.rid == rid:
                self._preempt(entry)
                return
        raise KeyError(f"request {rid} is not running in any slot")

    def _ensure_capacity(self, entry: _Entry, upto_tokens: int) -> None:
        """Grow the entry's blocks to cover ``upto_tokens``, preempting the
        policy's victim among the other running requests whenever the pool
        runs dry."""
        while not self.state.grow(entry, upto_tokens):
            running = [e for e in self.slot_entry
                       if e is not None and e is not entry]
            victim = self.policy.pick_victim(running, self._sched_state(0))
            if victim is None:
                # unreachable given the num_blocks >= max_blocks_per_seq
                # init check: a lone request always fits
                raise RuntimeError("block pool exhausted by a single request")
            self._preempt(victim)

    def tick(self) -> int:
        """Admit + advance every active request one step, then every active
        graph run one round. Returns the rows advanced plus the node
        invocations fired."""
        self._check_alive("tick")
        if self.cache_kind == "slots":
            advanced = self._tick_slots()
        else:
            advanced = self._tick_chunked()
        if self._graphs:
            advanced += self._tick_graphs()
        return advanced

    def _tick_chunked(self) -> int:
        """One step of the paged or recurrent backend over every active
        request row."""
        self._admit_chunked()
        paged = self.cache_kind == "paged"

        # phase A: chunk sizing + capacity growth (may preempt victims,
        # including entries already scheduled earlier in this loop)
        sched: List[Tuple[int, _Entry, int, List[int]]] = []
        for slot in range(self.slots):
            entry = self.slot_entry[slot]
            if entry is None:
                continue
            seq = entry.seq()
            n = min(self.chunk, len(seq) - entry.pos)
            self._ensure_capacity(entry, entry.pos + n)
            sched.append((slot, entry, n, seq))
        sched = [item for item in sched if self.slot_entry[item[0]] is item[1]]
        # the tick counts even when nothing is schedulable, so
        # run_until_drained's max_ticks stays a hard bound
        self.ticks += 1
        if not sched:
            self._flush_streams()
            return 0
        self.peak_active = max(self.peak_active, len(sched))
        if paged:
            self.peak_blocks_used = max(self.peak_blocks_used, self.pool.used_blocks)
            live = sum(entry.pos + n for _, entry, n, _ in sched)
            self._live_frac_last = live / (self.num_blocks * self.block_size)
            self._live_frac_sum += self._live_frac_last
            self._live_frac_ticks += 1

        # phase B: the fixed-shape step inputs (block tables: paged only)
        tokens = np.zeros((self.slots, self.chunk), np.int32)
        starts = np.zeros((self.slots,), np.int32)
        n_valid = np.zeros((self.slots,), np.int32)
        if paged:
            tables = np.full((self.slots, self.max_blocks_per_seq), -1, np.int32)
        for slot, entry, n, seq in sched:
            tokens[slot, :n] = seq[entry.pos:entry.pos + n]
            if paged:
                tables[slot, :len(entry.blocks)] = entry.blocks
            starts[slot] = entry.pos
            n_valid[slot] = n
        args = (tokens, tables, starts, n_valid) if paged else (tokens, starts, n_valid)
        next_np = self._step_call(*args)
        self.steps += 1

        for slot, entry, n, seq in sched:
            known = len(seq)
            entry.pos += n
            self.state.append(entry, n)
            if entry.pos < known:
                continue                 # mid-prefill: output discarded
            tok = int(next_np[slot])
            self._emit(entry, tok)
            if (len(entry.req.out_tokens) >= entry.req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)):
                self._complete(slot, entry)

        self._flush_streams()
        return len(sched)

    # -- slots (fixed-slot contiguous cache) backend ----------------------

    def _admit_slots(self) -> None:
        for slot in range(self.slots):
            if self.slot_entry[slot] is not None or not self.queue:
                continue
            idx = self.policy.admit(self.queue, self._sched_state(None))
            if idx is None:
                return
            entry = self.queue.pop(idx)
            self._stamp_admitted(entry)
            if entry.inbound is not None:
                # migrated in: the row replaces the prefill; the next decode
                # tick feeds out_tokens[-1] like any resident row's
                self.slot_entry[slot] = entry
                self._restore_inbound(entry, slot)
            else:
                self._prefill_slot(slot, entry)

    def _prefill_slot(self, slot: int, entry: _Entry) -> None:
        """Run the prompt through the ``engine.prefill`` step (a (1, L)
        forward into a fresh ``max_len`` row, through the fabric at
        ``placement="local"``), emit its greedy token, and scatter the row
        into ``slot`` of the live cache. A request rebuilt by failover from
        its prompt and delivered tokens (no state) prefills everything but
        its newest token, which the next decode tick feeds, and emits
        nothing: every known token was delivered already."""
        known = entry.seq()
        tokens = known[:-1] if entry.req.out_tokens else known
        prompt = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        logits, filled = self._call("engine.prefill", prompt, "local")
        if not entry.req.out_tokens:
            self._emit(entry, int(torch.argmax(logits[0])))
        self.cache = self.state.scatter(self.cache, filled, slot)
        self.slot_entry[slot] = entry

    def _tick_slots(self) -> int:
        """Admit (prefilling each admitted request), then one decode step
        for every slot; a tick with no active slot does not count. An mrope
        stack's step rotates every slot at the cache's shared length in all
        three streams, as the JAX engine's slots tick passes it."""
        self._admit_slots()
        active = [i for i, e in enumerate(self.slot_entry) if e is not None]
        if not active:
            self._flush_streams()
            return 0
        self.peak_active = max(self.peak_active, len(active))
        tokens = np.zeros((self.slots, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slot_entry[i].req.out_tokens[-1]
        next_np = self._step_call(tokens)
        self.steps += 1
        for i in active:
            e = self.slot_entry[i]
            tok = int(next_np[i, 0])
            self._emit(e, tok)
            if (len(e.req.out_tokens) >= e.req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)):
                self._complete(i, e)
        self.ticks += 1
        self._flush_streams()
        return len(active)

    # ------------------------------------------------------------------
    # fabric registration / invocation
    # ------------------------------------------------------------------

    def _register_fabric_steps(self) -> None:
        """Register the serve step (and the slots backend's prefill) on the
        bundle's fabric, so every tick invokes it through ``fabric.call``.
        The step's payload is ``(cache, *step arrays)``, the prefill's the
        prompt; the state is the params tree. The resolved placement of
        each lands in ``metrics()["fabric"]["placements"]``."""
        self._register(self._step_name, lambda state, payload: self.bundle.fn(state, *payload),
                       lambda payload: sum(a.nbytes for a in payload[1:]))
        if self.cache_kind == "slots":
            self._register("engine.prefill",
                           lambda state, prompt: self.prefill_bundle.fn(state, prompt),
                           lambda prompt: prompt.nbytes)

    def _register(self, name: str, run, payload_bytes) -> None:
        def invoke(payload, state, placement):
            placement = self._guarded_placement(name, payload_bytes(payload), state,
                                                placement)
            if placement == "injected":
                self.fabric.lease(self._params_lease, list(_leaves(state)))
            self._placements[name] = placement
            return run(state, payload)

        self.fabric.register_collective(name, invoke, placements=PLACEMENTS)
        self._placements[name] = self.placement

    def _lease_warm(self, state) -> bool:
        """True when a live params lease holds exactly these tensors (the
        ``is`` hit rule of ``fabric.leases``)."""
        lease = self.fabric.leases.get(self._params_lease)
        leaves = list(_leaves(state))
        return bool(lease is not None and lease.live and len(lease.key) == len(leaves)
                    and all(a is b for a, b in zip(lease.key, leaves)))

    def _params_nbytes(self) -> int:
        """Bytes of the weight tree: what injecting it ships."""
        if self._params_nbytes_memo is None and self.params is not None:
            self._params_nbytes_memo = sum(t.nbytes for t in _leaves(self.params))
        return self._params_nbytes_memo or 0

    def _resolve_auto(self, name: str, payload_bytes: int, state) -> str:
        """``placement="auto"`` for one tick: injected while the params
        lease is warm (the weights already live with the executor: reuse
        ships nothing), local while it is cold (a first injection would
        ship the whole weight tree for one tick's payload). The estimate is
        recorded on the fabric's decision log either way."""
        injected_bytes = 0 if self._lease_warm(state) else self._params_nbytes()
        est = TransportEstimate(
            local_bytes=payload_bytes, injected_bytes=injected_bytes, common_bytes=0,
            chosen="injected" if injected_bytes <= payload_bytes else "local")
        self.fabric.record_decision(name, est)
        return est.chosen

    def _guarded_placement(self, name: str, payload_bytes: int, state,
                           placement: str) -> str:
        """Resolve ``"auto"`` and close the lease-expiry race: the params
        lease can expire (TTL, eviction, an injected storm) between
        placement resolution and step execution, the window ``fault_hook``
        fires in. An auto resolution of injected was premised on warm reuse
        shipping nothing, so if the lease went cold underneath it the call
        falls back to local (``lease_fallbacks``) instead of re-shipping
        the weights. An explicit ``"injected"`` is left alone: re-acquiring
        on a cold lease is the injection."""
        requested = placement
        if placement == "auto":
            placement = self._resolve_auto(name, payload_bytes, state)
        if self.fault_hook is not None:
            self.fault_hook(name)
        if requested == "auto" and placement == "injected" and not self._lease_warm(state):
            self.lease_fallbacks += 1
            placement = "local"
        return placement

    def _call(self, name: str, payload, placement: str):
        """``fabric.call`` of a registered step on the params, counting the
        CUDA kernel launches it makes."""
        before = {k: LAUNCH_COUNTERS[k].count for k in self.kernel_launches}
        out = self.fabric.call(name, payload, state=self.params, placement=placement)
        for k in self.kernel_launches:
            self.kernel_launches[k] += LAUNCH_COUNTERS[k].count - before[k]
        return out

    def _step_call(self, *arrays: np.ndarray, name: Optional[str] = None,
                   placement: Optional[str] = None) -> np.ndarray:
        """Run the serve step (or the registered step ``name``) on host-built
        inputs, through the fabric at ``placement`` (default: this
        engine's); returns the step's tokens."""
        args = [torch.from_numpy(a).to(self.device) for a in arrays]
        out, self.cache = self._call(name or self._step_name, (self.cache, *args),
                                     placement or self.placement)
        return out.cpu().numpy()

    def _session_step_call(self, *arrays: np.ndarray,
                           placement: Optional[str] = None) -> np.ndarray:
        """A graph session's step: the tick's fabric-registered step at the
        session's own placement; returns next tokens ``(slots,)``."""
        self._check_alive("session step")
        out = self._step_call(*arrays, placement=placement)
        self.steps += 1
        return out

    def ensure_verify_step(self) -> None:
        """Build and register the multi-token verify step (paged only): the
        paged step built with ``emit="all"``, the greedy token at *every*
        fed position, which a speculation round reads to accept or reject
        k candidates in one invocation. The same geometry, kernels, cache
        and compute dtype as the decode step; it is registered on the
        engine's fabric as ``engine.paged_verify``, so it shares the
        decode step's params lease, placement guard and ``fault_hook``,
        and its launches count in ``kernel_launches``. A kernel that
        cannot build or launch raises: nothing falls back to the plain
        path."""
        if self.cache_kind != "paged":
            raise ValueError(
                f"the verify step rides the paged chunked-prefill shape; engine "
                f"{self.engine_id} has cache={self.cache_kind!r}")
        if self.verify_bundle is not None:
            return
        self.verify_bundle = make_paged_serve_step(
            self.cfg, slots=self.slots, chunk=self.chunk, num_blocks=self.num_blocks,
            block_size=self.block_size, max_blocks_per_seq=self.max_blocks_per_seq,
            kernel=self.kernel, emit="all", device=self.device,
            compute_dtype=self.compute_dtype)
        self._register("engine.paged_verify",
                       lambda state, payload: self.verify_bundle.fn(state, *payload),
                       lambda payload: sum(a.nbytes for a in payload[1:]))

    def _verify_call(self, *arrays: np.ndarray, placement: Optional[str] = None) -> np.ndarray:
        """One verify-step invocation through the fabric (building the step
        at first use); returns the greedy tokens ``(slots, chunk)``."""
        self._check_alive("verify step")
        self.ensure_verify_step()
        out = self._step_call(*arrays, name="engine.paged_verify", placement=placement)
        self.verify_steps += 1
        return out

    # ------------------------------------------------------------------
    # live migration: export/import of in-flight entries
    # ------------------------------------------------------------------

    def export_request(self, rid: int) -> MigrationTicket:
        """Detach request ``rid``, queued or running, into a
        ``MigrationTicket`` and release everything it held here (slot,
        blocks, snapshot, stream handle). Called between ticks; the ticket
        restores on any engine with the same model and ``cache_kind``
        (``import_request``) and resumes with the greedy output it would
        have had here. Raises ``KeyError`` for unknown or finished rids."""
        self._check_alive("export_request")
        for slot, entry in enumerate(self.slot_entry):
            if entry is not None and entry.req.rid == rid:
                return self._export_entry(entry, slot)
        for i, entry in enumerate(self.queue):
            if entry.req.rid == rid:
                self.queue.pop(i)
                return self._export_entry(entry, None)
        raise KeyError(f"request {rid} is not queued or running on {self.engine_id} "
                       f"(finished requests cannot migrate)")

    def _resident(self, entry: _Entry, slot: int) -> Tuple[Optional[bytes], int]:
        """A running entry's state buffer and the tokens it covers: slots
        cover the prompt and every generated token but the newest (not fed
        back through the step yet); chunked backends ``entry.pos``, none
        before the first chunk."""
        if self.cache_kind == "slots":
            return (self.state.serialize(entry, self.cache, slot),
                    len(entry.prompt_tokens) + max(0, len(entry.req.out_tokens) - 1))
        if entry.pos > 0:
            return self.state.serialize(entry, self.cache, slot), entry.pos
        return None, 0

    def _parked(self, entry: _Entry) -> Tuple[Optional[bytes], int]:
        """A queued entry's state: a migrated-in buffer not yet absorbed is
        forwarded verbatim (dropping it would demote a warm handoff to a
        recompute); a preempted recurrent entry's snapshot is its state."""
        if entry.inbound is not None:
            return entry.inbound, entry.pos
        if self.cache_kind == "recurrent" and entry.snapshot is not None:
            return state_to_bytes(entry.snapshot), entry.pos
        return None, 0

    def _export_entry(self, entry: _Entry, slot: Optional[int]) -> MigrationTicket:
        if slot is not None:
            buf, pos = self._resident(entry, slot)
            self.slot_entry[slot] = None
        else:
            buf, pos = self._parked(entry)
        self.state.release(entry)
        ticket = self._ticket_for(entry, buf, pos)
        # detach the local stream: the source's handle must not see tokens
        # the target produces (the router rebinds its own handle)
        entry.handle = None
        self._pending_pump = [e for e in self._pending_pump if e is not entry]
        self.migrations_out += 1
        return ticket

    def _ticket_for(self, entry: _Entry, buf: Optional[bytes], pos: int) -> MigrationTicket:
        req = entry.req
        return MigrationTicket(rid=req.rid, cache_kind=self.cache_kind,
                               priority=req.priority, max_new_tokens=req.max_new_tokens,
                               prompt=list(entry.prompt_tokens),
                               out_tokens=list(req.out_tokens), pos=pos, state=buf)

    def snapshot_request(self, rid: int) -> MigrationTicket:
        """The non-destructive twin of ``export_request``: ``rid``'s state
        as a ``MigrationTicket`` while the request keeps running here. A
        router takes these at its snapshot cadence, so that when this
        replica dies the request restores on a peer from the last snapshot
        instead of a recompute. Raises ``KeyError`` for unknown or finished
        rids."""
        self._check_alive("snapshot_request")
        for slot, entry in enumerate(self.slot_entry):
            if entry is not None and entry.req.rid == rid:
                return self._ticket_for(entry, *self._resident(entry, slot))
        for entry in self.queue:
            if entry.req.rid == rid:
                return self._ticket_for(entry, *self._parked(entry))
        raise KeyError(f"request {rid} is not queued or running on {self.engine_id} "
                       f"(finished requests have no state to snapshot)")

    def import_request(self, ticket: MigrationTicket) -> RequestHandle:
        """Queue a migrated request like a fresh submit (policies see its
        priority); its state, when the ticket carries one, is restored at
        admission instead of a prefill, so decoding resumes at token
        ``pos`` (paged resumes mid-chunked-prefill too: ``pos`` is a chunk
        boundary). A ticket of another ``cache_kind`` is refused: state
        bytes do not convert across backends."""
        self._check_alive("import_request")
        if ticket.cache_kind != self.cache_kind:
            raise ValueError(
                f"cannot import a cache_kind={ticket.cache_kind!r} ticket into "
                f"{self.engine_id} (cache_kind={self.cache_kind!r}): sequence-state "
                f"bytes do not convert across backends")
        msg = self.state.validate(len(ticket.prompt), ticket.max_new_tokens, self.max_len)
        if msg:
            raise ValueError(f"request {ticket.rid}: {msg}")
        req = Request(rid=ticket.rid, prompt=np.asarray(ticket.prompt, np.int32),
                      max_new_tokens=ticket.max_new_tokens, priority=ticket.priority,
                      out_tokens=list(ticket.out_tokens), arrival_tick=self.ticks)
        entry = _Entry(req=req, submit_time=time.perf_counter(),
                       arrival_seq=self._submit_counter,
                       prompt_tokens=list(ticket.prompt))
        self._submit_counter += 1
        if ticket.state is not None:
            entry.inbound = ticket.state
            entry.pos = ticket.pos
        entry.handle = RequestHandle(self, req)
        self.queue.append(entry)
        self.migrations_in += 1
        return entry.handle

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------

    def _request_records(self) -> List[Dict[str, Any]]:
        recs = []
        for e in sorted(self._entries_everywhere(), key=lambda e: e.arrival_seq):
            r = e.req
            recs.append({
                "rid": r.rid,
                "priority": r.priority,
                "arrival_tick": r.arrival_tick,
                "admitted": e.admit_seq >= 0,
                "first_token_tick": e.first_token_tick,
                "ttft_s": (e.first_token_time - e.submit_time
                           if e.first_token_time is not None else None),
                "tokens": len(r.out_tokens),
                "preemptions": e.preemptions,
                "done": r.done,
            })
        return recs

    def metrics(self) -> Dict[str, Any]:
        """Engine telemetry snapshot (JSON-friendly), with the JAX engine's
        keys for what the port has, plus the resolved kernel kind
        (``kernel``), the launch count of each kernel the step can run
        (``kernel_launches``: ``{"paged_attention": n, "moe_jam": m}`` on
        the paged backend, else one key per kernel the stack's block types
        can launch, e.g. ``{"ssm_scan": n}``, ``{"flash_attention": n,
        "ssm_scan": m}``, or ``{}`` for an xLSTM stack; prefills, graph sessions and
        verify steps included), the step count (``steps``: ticks that ran
        the step and graph sessions' steps) and ``verify_steps``, the
        non-finite-logits counter (both steps),
        ``migrations`` (``{"in", "out"}``) and ``engine.failed_reason``, and
        the fabric block: ``fabric`` (the bundle fabric's ``metrics()`` with
        each step's resolved ``placements`` and ``lease_fallbacks``),
        ``transport_decisions`` and ``transport_telemetry``. Paged engines
        add the pool's keys and ``chunk``, recurrent ones ``chunk``, the
        snapshot counters and the state bytes per slot. Graph runs add
        ``graphs`` (``active``, ``completed``, ``node_invocations``,
        ``runs``), with the JAX engine's schema."""
        done = [e for e in self._entries_everywhere() if e.req.done]
        ttfts = sorted(e.first_token_time - e.submit_time
                       for e in done if e.first_token_time is not None)
        out = {
            "engine": {
                "engine_id": self.engine_id,
                "cache": self.cache_kind,
                "scheduler": self.policy.name,
                "slots": self.slots,
                "max_len": self.max_len,
                "placement": self.placement,
                "failed_reason": self.failed_reason,
                "device": str(self.device),
            },
            "ticks": self.ticks,
            "steps": self.steps,
            "verify_steps": self.verify_steps,
            "active_slots": sum(e is not None for e in self.slot_entry),
            "peak_active_slots": self.peak_active,
            "queued": len(self.queue),
            "completed": len(self.completed),
            "preemptions": self.preempt_count,
            "migrations": {"in": self.migrations_in, "out": self.migrations_out},
            "ttft_s": ttfts,
            "requests": self._request_records(),
            "kernel": self.kernel,
            "kernel_launches": dict(self.kernel_launches),
            "nonfinite_logits": int(self.bundle.meta["nonfinite_logits"]) + (
                int(self.verify_bundle.meta["nonfinite_logits"]) if self.verify_bundle else 0),
            "transport_decisions": [est.describe() for _, est in self.fabric.decisions],
            "transport_telemetry": transport_telemetry().summary(),
            "fabric": dict(self.fabric.metrics(), placements=dict(self._placements),
                           lease_fallbacks=self.lease_fallbacks),
        }
        if self._graphs or self._graphs_done:
            out["graphs"] = {
                "active": len(self._graphs),
                "completed": len(self._graphs_done),
                "node_invocations": self.graph_invocations,
                "runs": [run.metrics() for run in self._graphs + self._graphs_done],
            }
        if self.cache_kind != "slots":
            out["chunk"] = self.chunk
        if self.cache_kind == "paged":
            out.update({
                "paged_kernel": self.kernel,
                "live_token_fraction": self._live_frac_last,
                "live_token_fraction_mean": (
                    self._live_frac_sum / self._live_frac_ticks
                    if self._live_frac_ticks else 0.0),
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "free_blocks": self.pool.free_blocks,
                "used_blocks": self.pool.used_blocks,
                "peak_used_blocks": self.peak_blocks_used,
                "occupancy": self.pool.used_blocks / max(1, self.num_blocks),
            })
        else:
            out.update(self.state.metrics())
        return out


def _leaves(tree):
    """The tensors of a params or cache tree, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)

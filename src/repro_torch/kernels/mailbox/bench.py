"""Frame-path inputs and the work count of the mailbox kernels.

``chip_smoke.py`` takes its frame path's shapes and traffic from here: a
key-value shard of 2^26 rows (table 512 MiB + heap 3.75 GiB) resident on
the card, and deliveries of 2^20 frames of 128 B (a 64-bank x 16,384-slot
mailbox block) with 16 USR words each; and its ring: 8 ranks of 131,072
such frames (16 MiB a rank, 2^20 in all), plus latency frames of 64,
1,024 and 8,192 USR words. Run as a module on a machine with a CUDA card,
it times the handler kernels, their plain versions and a library
yardstick at that size (the L2 cache flushed before every launch), splits
the Indirect Put's time over its three passes (clear, claim, fix) with
``torch.profiler``, bounds the sum and the put also by the 32-byte
sectors they must move (``sum_sector_work``, ``put_sector_work``), times
the sum also warm and at the ring's latency widths (on
16-byte-aligned frames, its wide route, and on the same frames 4 bytes off,
its scalar route), times the put's yardstick also with the rows in the
order the kernel writes them, and times the ring put's routes
(``ring_times``):

    PYTHONPATH=src python -m repro_torch.kernels.mailbox.bench
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.core.message import FrameSpec, checksum, pack_frames
from repro_torch.core.registry import RiedPackage
from repro_torch.device import resolve_device
from repro_torch.fabric import Fabric
from repro_torch.kernels.mailbox.ref import put_slots
from repro_torch.kernels.timing import (bound_ms, card_name, floor_ms, kernel_ms,
                                        l2_flush_buffer, timed_ms)

SPEC = FrameSpec(got_slots=4, state_words=0, payload_words=16)   # 32 words, 128 B
BANKS, FRAMES_PER_BANK = 64, 16384                 # 2^20 frames per delivery
SLOTS = 1 << 26                                    # rows of the resident shard
HEAP_BASE = 12_345                                 # got[0] of the put
HOT_KEYS, HOT_SHARE, CORRUPT_SHARE = 1024, 0.10, 0.001
RING_RANKS, RING_FRAMES = 8, 131072                # 16 MiB of frames a rank
PAYLOADS = (64, 1024, 8192)                        # USR words of the latency frames
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1
PUT_PASSES = ("clear", "claim", "fix")             # the Indirect Put's kernels, in order


def kv_fabric(device=None, slots: int = SLOTS, heap_base: int = HEAP_BASE) -> Fabric:
    """The server of the frame path: a ``Fabric`` holding a key-value shard
    (``kv.table`` (slots, 2), ``kv.heap`` (slots, 15) int32 zeros and
    ``kv.heap_base``, a 0-d int32 tensor) installed by the ried ``kv`` on
    ``device`` (default ``cuda``), and two jams in one lane of ``SPEC`` and
    2 result words:

    * ``server_side_sum`` returns ``[sum(usr), 0]`` (wrapping);
    * ``indirect_put`` returns ``[key, idx]``, the table row the frame's
      put writes, with ``idx`` hashed through ``kv.heap_base``.

    The jams compute what a frame asks for and leave the shard alone (the
    dispatcher runs every jam on every frame); the handler kernels apply
    the puts."""
    device = resolve_device(device)
    ried = RiedPackage("kv")
    ried.export("kv.table")(lambda: torch.zeros((slots, 2), dtype=torch.int32, device=device))
    ried.export("kv.heap")(lambda: torch.zeros((slots, SPEC.payload_words - 1),
                                               dtype=torch.int32, device=device))
    ried.export("kv.heap_base")(lambda: torch.tensor(heap_base, dtype=torch.int32,
                                                     device=device))
    fabric = Fabric(name="kv").install(ried)

    @fabric.function("server_side_sum", spec=SPEC, result_words=2)
    def server_side_sum(got, state, usr):
        s = checksum(usr)
        return torch.stack([s, torch.zeros_like(s)], 1)

    @fabric.function("indirect_put", spec=SPEC, result_words=2,
                     got_symbols=("kv.heap_base", "kv.table"))
    def indirect_put(got, state, usr):
        base, table = got
        idx = put_slots(usr[:, 0], table.shape[0], base)
        return torch.stack([usr[:, 0], idx.to(torch.int32)], 1)

    return fabric


def hot_keys() -> np.ndarray:
    """The 1,024 hot keys (numpy seed 1), with int32's two extremes."""
    keys = np.random.default_rng(1).integers(INT32_MIN, INT32_MAX, size=HOT_KEYS,
                                             endpoint=True, dtype=np.int64)
    keys[:2] = INT32_MIN, INT32_MAX
    return keys.astype(np.int32)


def put_payloads(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 16) int32 USR words of Indirect Put frames: the key, then 15
    data words uniform over int32. Keys are uniform over int32 (negatives
    included) except a ``HOT_SHARE`` of them, drawn from ``hot_keys()``:
    ~10^5 frames of a delivery land on a row an earlier frame of it wrote."""
    usr = rng.integers(INT32_MIN, INT32_MAX, size=(n, SPEC.payload_words), endpoint=True,
                       dtype=np.int64).astype(np.int32)
    hot = rng.random(n) < HOT_SHARE
    usr[hot, 0] = rng.choice(hot_keys(), size=int(hot.sum()))
    return usr


def sum_payloads(rng: np.random.Generator, n: int,
                 payload_words: int = SPEC.payload_words) -> np.ndarray:
    """(n, payload_words) int32 USR words of Server-Side Sum frames,
    uniform over int32, so most sums wrap."""
    return rng.integers(INT32_MIN, INT32_MAX, size=(n, payload_words), endpoint=True,
                        dtype=np.int64).astype(np.int32)


def corrupt(frames: torch.Tensor, rng: np.random.Generator,
            share: float = CORRUPT_SHARE) -> np.ndarray:
    """Flip bits of one USR word in ``share`` of the frames, in place (a
    non-zero xor: every such frame fails its checksum); returns their
    indices, sorted."""
    n = frames.shape[0]
    bad = np.sort(rng.choice(n, size=int(n * share), replace=False))
    word = SPEC.offsets()["usr"] + rng.integers(0, SPEC.payload_words, size=len(bad))
    mask = rng.integers(1, INT32_MAX, size=len(bad), endpoint=True).astype(np.int32)
    rows = torch.from_numpy(bad).to(frames.device)
    cols = torch.from_numpy(word).to(frames.device)
    frames[rows, cols] ^= torch.from_numpy(mask).to(frames.device)
    return bad


def put_rows(keys: np.ndarray, slots: int = SLOTS, base: int = HEAP_BASE) -> np.ndarray:
    """Each key's table row, in numpy int64 (floor modulo)."""
    return (keys.astype(np.int64) % slots + base) % slots


def last_writers(rows: np.ndarray):
    """(rows written, the index of each one's last frame), by a numpy
    replay of sequential puts: the first occurrence in reversed order."""
    uniq, first = np.unique(rows[::-1], return_index=True)
    return uniq, len(rows) - 1 - first


def sum_work(n: int, payload_words: int = SPEC.payload_words) -> dict:
    """Bytes the Server-Side Sum needs: every USR word read, one int32 sum
    written per frame."""
    return dict(bytes=n * (4 * payload_words + 4))


def put_work(n: int, rows_written: int, payload_words: int = SPEC.payload_words) -> dict:
    """Bytes the Indirect Put needs on this input: every frame's key read;
    for each row written, its last writer's data read and the table row (8
    B) and heap row written; got[0] read."""
    data = 4 * (payload_words - 1)
    return dict(bytes=4 * n + rows_written * (2 * data + 8) + 4)


SECTOR = 32                 # bytes: the unit a random access moves


def _sectors(first_byte: np.ndarray, nbytes: int):
    """The 32-byte sectors that ranges [first_byte, first_byte + nbytes)
    touch, and the bytes of each range in each: (sector ids, bytes), one
    entry per (range, sector)."""
    lo = first_byte // SECTOR
    span = int((SECTOR - 1 + nbytes - 1) // SECTOR + 1)          # at most this many
    ids = lo[:, None] + np.arange(span)[None, :]
    start = np.maximum(ids * SECTOR, first_byte[:, None])
    end = np.minimum((ids + 1) * SECTOR, first_byte[:, None] + nbytes)
    keep = end > start
    return ids[keep], (end - start)[keep]


def sum_sector_work(n: int, usr_off: int = SPEC.offsets()["usr"],
                    payload_words: int = SPEC.payload_words, *,
                    w: int = SPEC.total_words) -> dict:
    """The Server-Side Sum's needed traffic counted in whole 32-byte
    sectors, as the card's memory moves it (frames of ``w`` words from a
    32-byte boundary): every sector that holds a USR word, each once, plus
    the sectors of the sums (4 B a frame, written in order). At the frame
    path (USR at bytes 48-111 of a 128-byte frame) that is three sectors a
    frame where the bytes bound counts two."""
    usr = 0
    if n and payload_words:
        start = np.arange(n, dtype=np.int64) * (4 * w) + 4 * usr_off
        lo, hi = start // SECTOR, (start + 4 * payload_words - 1) // SECTOR
        # the ranges come in order, so a sector shared with earlier frames
        # is at most the one the previous range ended in
        prev = np.concatenate([[-1], hi[:-1]])
        usr = int(np.maximum(hi - np.maximum(lo, prev + 1) + 1, 0).sum())
    sectors = usr + -(-4 * n // SECTOR)
    return dict(bytes=SECTOR * sectors, sectors=sectors, usr_sectors=usr)


def put_sector_work(n: int, rows: np.ndarray, last: np.ndarray, *, w: int = SPEC.total_words,
                    usr_off: int = SPEC.offsets()["usr"],
                    payload_words: int = SPEC.payload_words) -> dict:
    """The Indirect Put's needed traffic counted in whole 32-byte sectors,
    as random accesses move it (arrays from 32-byte boundaries): the sector
    of every frame's key, the sectors of each winner's data words, and the
    sectors that the written table rows (8 B each) and heap rows (4 (pw -
    1) B at that pitch) fall in, each sector once, plus got[0]. ``bytes``
    counts a partly written sector as one write; ``rmw_bytes`` adds a read
    of each such sector, as a device that must merge the bytes it keeps
    would do. ``rows`` are the rows written, ``last`` their last writers'
    frame indices."""
    rows, last = np.asarray(rows, np.int64), np.asarray(last, np.int64)
    data = 4 * (payload_words - 1)
    keys = (np.arange(n, dtype=np.int64) * w + usr_off) * 4 // SECTOR
    read = np.union1d(keys, _sectors((last * w + usr_off + 1) * 4, data)[0]) \
        if data else keys
    written = partial = 0
    for first, nbytes in ((rows * 8, 8), (rows * data, data)):
        if not nbytes:
            continue
        ids, got = _sectors(first, nbytes)
        uniq, inv = np.unique(ids, return_inverse=True)
        full = np.bincount(inv, weights=got) >= SECTOR
        written += len(uniq)
        partial += int((~full).sum())
    sectors = len(read) + written + 1
    return dict(bytes=SECTOR * sectors, rmw_bytes=SECTOR * (sectors + partial),
                sectors=sectors, partial_sectors=partial)


def ring_work(n: int, frames: int, words: int, summed: bool = False) -> dict:
    """Bytes the ring put needs: every frame read once and written once;
    with the fused sum, one int32 written per frame."""
    return dict(bytes=8 * n * frames * words + (4 * n * frames if summed else 0))


def ring_blocks(device, rng: np.random.Generator, n: int, frames: int,
                spec: FrameSpec = SPEC) -> torch.Tensor:
    """(n, frames, W) Server-Side Sum frames of ``spec`` on ``device``,
    rank r's with src_rank r, USR words uniform over int32."""
    usr = torch.from_numpy(sum_payloads(rng, n * frames, spec.payload_words)).to(device)
    ranks = torch.arange(n, dtype=torch.int32, device=device).view(n, 1)
    return pack_frames(spec, func_id=0, src_rank=ranks,
                       payload_words=usr.view(n, frames, spec.payload_words))


def ring_routes(blocks: torch.Tensor, spec: FrameSpec = SPEC) -> dict:
    """The ring put of ``blocks`` five ways, name -> call: stashed with the
    fused sum (execute on arrival), non-stash then ``am_server_sum`` on
    each rank (the drain's extra round trip through device memory), the
    non-stash put alone, and stashed without a handler under WFE and under
    poll."""
    from repro_torch.kernels.mailbox.ops import am_server_sum, ring_am_put

    def non_stash():
        arrivals, _, _ = ring_am_put(blocks, spec=spec, stash=False)
        return [am_server_sum(a, spec) for a in arrivals]

    return {"stash+sum": lambda: ring_am_put(blocks, spec=spec, handler="sum"),
            "non-stash+drain": non_stash,
            "non-stash": lambda: ring_am_put(blocks, spec=spec, stash=False),
            "wfe": lambda: ring_am_put(blocks, spec=spec),
            "poll": lambda: ring_am_put(blocks, spec=spec, wait="poll")}


def ring_times(blocks: torch.Tensor, flush: torch.Tensor, iters: int,
               spec: FrameSpec = SPEC) -> dict:
    """Device ms of each of ``ring_routes`` with the L2 flushed before every
    launch (``ms``) and warm (``warm_ms``), of the library calls
    ``torch.roll`` and ``roll`` + ``usr.sum(dtype=int32)`` (flushed), and
    the poll's spins on each rank in one more call."""
    from repro_torch.kernels.mailbox.ops import ring_am_put

    usr = slice(spec.offsets()["usr"], spec.offsets()["usr"] + spec.payload_words)
    out = {name: dict(ms=timed_ms(fn, iters, flush), warm_ms=timed_ms(fn, iters, None))
           for name, fn in ring_routes(blocks, spec).items()}
    out["roll_ms"] = timed_ms(lambda: torch.roll(blocks, 1, 0), iters, flush)
    out["roll+sum_ms"] = timed_ms(
        lambda: torch.roll(blocks, 1, 0)[..., usr].sum(-1, dtype=torch.int32), iters, flush)
    out["poll_spins"] = ring_am_put(blocks, spec=spec, wait="poll")[1].view(-1).tolist()
    return out


def frames_on(device, usr: np.ndarray, func_id: int = 0) -> torch.Tensor:
    return pack_frames(SPEC, func_id=func_id, payload_words=torch.from_numpy(usr).to(device))


def put_passes_ms(put, flush) -> dict:
    """Mean device time (ms) of each of the Indirect Put's kernels
    (``PUT_PASSES``) per call, the L2 flushed before each call."""
    return kernel_ms(put, flush, {name: f"put_{name}_kernel" for name in PUT_PASSES})


def main() -> int:
    from repro_torch.kernels.mailbox.kernel import PUT_DESIGN, SUM_DESIGN, sum_route
    from repro_torch.kernels.mailbox.ops import (indirect_put_cuda, indirect_put_ref,
                                                 server_sum_cuda, server_sum_ref)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card: this times the CUDA kernels")
    dev = torch.device("cuda")
    n = BANKS * FRAMES_PER_BANK
    usr_off, pw = SPEC.offsets()["usr"], SPEC.payload_words
    rng = np.random.default_rng(0)
    flush = l2_flush_buffer(dev)
    out = {}

    frames = frames_on(dev, sum_payloads(rng, n))
    usr = frames[:, usr_off:usr_off + pw]
    bound, by = bound_ms(sum_work(n))

    def ssum():
        return server_sum_cuda(frames, usr_off, pw)

    out["server_sum"] = dict(
        frames=n, bound_ms=bound, bound_by=by,
        design=f"{SUM_DESIGN}, route {sum_route(frames, usr_off, pw)}",
        sector_bound_ms=bound_ms(sum_sector_work(n, usr_off, pw))[0],
        ms=timed_ms(ssum, 200, flush),
        plain_ms=timed_ms(lambda: server_sum_ref(frames, usr_off, pw), 50, flush),
        library_ms=timed_ms(lambda: usr.sum(1, dtype=torch.int32), 200, flush),
        warm_ms=timed_ms(ssum, 200, None))

    keys_usr = put_payloads(rng, n)
    frames = frames_on(dev, keys_usr)
    table = torch.zeros((SLOTS, 2), dtype=torch.int32, device=dev)
    heap = torch.zeros((SLOTS, pw - 1), dtype=torch.int32, device=dev)
    got = torch.tensor([HEAP_BASE, 0, 0, 0], dtype=torch.int32, device=dev)
    rows, last = last_writers(put_rows(keys_usr[:, 0]))
    rows_t = torch.from_numpy(rows).to(dev)
    win = torch.from_numpy(last).to(dev)
    t_vals = torch.stack([frames[win, usr_off], rows_t.to(torch.int32)], 1)
    h_vals = frames[win, usr_off + 1:usr_off + pw].contiguous()
    # the same writes in the order the kernel makes them: by winning frame
    by_frame = torch.from_numpy(np.argsort(last)).to(dev)
    rows_f, t_f, h_f = rows_t[by_frame], t_vals[by_frame], h_vals[by_frame]
    bound, by = bound_ms(put_work(n, len(rows)))
    sectors = put_sector_work(n, rows, last)
    # the same frames again give the same state: every timed call is a
    # full put
    out["indirect_put"] = dict(
        frames=n, rows_written=len(rows), bound_ms=bound, bound_by=by, design=PUT_DESIGN,
        sector_bound_ms=bound_ms(sectors)[0], rmw_bound_ms=bound_ms(
            dict(bytes=sectors["rmw_bytes"]))[0], **sectors,
        ms=timed_ms(lambda: indirect_put_cuda(frames, table, heap, got, usr_off, pw), 100,
                    flush),
        plain_ms=timed_ms(lambda: indirect_put_ref(frames, table, heap, usr_off, pw,
                                                   got[0]), 20, flush),
        library_ms=timed_ms(lambda: (table.index_put_((rows_t,), t_vals),
                                     heap.index_put_((rows_t,), h_vals)), 100, flush),
        library_frame_order_ms=timed_ms(lambda: (table.index_put_((rows_f,), t_f),
                                                 heap.index_put_((rows_f,), h_f)), 100, flush))
    out["indirect_put"]["passes_ms"] = put_passes_ms(
        lambda: indirect_put_cuda(frames, table, heap, got, usr_off, pw), flush)
    for name, r in out.items():
        print(f"[bench] {name}: {n} frames: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    r = out["server_sum"]
    print(f"[bench] server_sum {r['design']}: bound by 32-byte sectors "
          f"{r['sector_bound_ms']:.4f} ms; warm {r['warm_ms']:.4f} ms", flush=True)
    # the ring's latency frames, drained by the sum on the non-stash route:
    # 16 frames of 64, 1,024 and 8,192 USR words, on a 16-byte boundary and
    # (the scalar route) a copy 4 bytes off one
    for words in PAYLOADS:
        wide = ring_blocks(dev, rng, 1, 16, FrameSpec(got_slots=4, state_words=0,
                                                      payload_words=words))[0]
        off = torch.empty(wide.numel() + 4, dtype=torch.int32, device=dev)[1:]
        off = off[:wide.numel()].view(wide.shape).copy_(wide)
        r[f"{words}_words"] = {sum_route(f, usr_off, words): timed_ms(
            lambda: server_sum_cuda(f, usr_off, words), 200, flush) for f in (wide, off)}
    print(f"[bench] server_sum of 16 frames of {PAYLOADS} USR words, by route: "
          f"{ {k: v for k, v in r.items() if k.endswith('_words')} }", flush=True)
    r = out["indirect_put"]
    print(f"[bench] indirect_put library with the rows in winning-frame order (the "
          f"kernel's): {r['library_frame_order_ms']:.4f} ms", flush=True)
    print(f"[bench] indirect_put {r['design']}: passes (profiler, device time per call) "
          f"{r['passes_ms']}; bound by 32-byte sectors {r['sector_bound_ms']:.4f} ms "
          f"({r['sectors']} sectors, {r['partial_sectors']} partly written; "
          f"{r['rmw_bound_ms']:.4f} ms if each of those is read too)", flush=True)

    blocks = ring_blocks(dev, rng, RING_RANKS, RING_FRAMES)
    out["ring_put"] = dict(ranks=RING_RANKS, frames=RING_FRAMES,
                           bound_ms=bound_ms(ring_work(RING_RANKS, RING_FRAMES,
                                                       SPEC.total_words, summed=True))[0],
                           **ring_times(blocks, flush, 50))
    print(f"[bench] ring_put {RING_RANKS} x {RING_FRAMES} frames: {out['ring_put']}",
          flush=True)
    out["floor_ms"] = floor_ms(flush)
    print(f"[bench] timer floor (a one-element fill_): {out['floor_ms']:.4f} ms", flush=True)
    print(json.dumps({"card": card_name(), **out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

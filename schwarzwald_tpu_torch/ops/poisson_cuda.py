"""MIN_DISTANCE (Poisson-disk) accept mask on the card: the prep, the
binding of the CUDA kernels (csrc/poisson.cu), and their plain-torch
versions.

This is the counterpart of schwarzwald_tpu/ops/poisson_pallas.py. Semantics
(the reference's greedy pass, PoissonDiskSampling::sample_points,
Sampling.h:444-465): walk the Morton-sorted range in order and accept a
point iff it is analyzed and no previously ACCEPTED point lies at
d2 < spacing^2, d2 = (dx*dx + dy*dy) + dz*dz.

The range is cut into blocks of `block` consecutive points, and for every
block bi the earlier blocks bj < bi whose AABB meets bi's AABB inflated by
the spacing are listed (CSR pair_ptr / pair_bj): `_pair_csr` in numpy
(`prep`, the CPU path) or `pair_csr_torch` on the card (`range_mask_cuda`).
The mask does not depend on the block size. Two formulations compute it:

  * block-sequential (`accept_mask_torch`, the plain version of the whole
    mask, which the CPU path runs): blocks decided in ascending order, a
    cross step against the final accept flags of the listed blocks, then an
    intra step (earliest-undecided relaxation over the block's strict-lower
    close matrix);
  * two-phase (the kernels, `accept_mask_cuda`; plain version
    `accept_mask_two_phase_torch`): phase A lists, for every point, its
    earlier close points (plain version `close_lists_torch`), which
    depends on no decision; phase B decides the blocks in ascending order
    over those lists (`decide_torch`), each block waiting only on the
    blocks its lists name (`block_deps`). The lists are held under
    CLOSE_BUDGET entries: past it, both phases run window by window over
    the blocks (`plan_windows`), and a window's phase A resolves close
    points of earlier windows against their final mask.

Precision modes:
  * "f64" (the engine's): d2 in float64 against the float32 spacing
    product widened to float64 -- bit-equal to the native host kernel
    (native/src/schwarzwald_native.cpp), so device output is byte-identical
    to the host run.
  * "f32": everything in float32 -- bit-equal to the float32 greedy oracle
    and to the Pallas kernel.

Dispatch rules (deterministic, each counted in `counters`):
  * below_floor: ranges under DEVICE_FLOOR points stay on the host kernel
    (ops/sampling._poisson_device_attempt);
  * pair_gate: more than MAX_PAIRS_PER_BLOCK block pairs per block (all
    points inside a few spacing balls) -> the host kernel;
  * kernel / plain: the range ran on the CUDA kernels (a CUDA device) or on
    the plain-torch version (the CPU).
`launches` counts kernel launches; the wrapper adds one where it launches a
kernel and nowhere else. Each worker thread runs its ranges on a CUDA
stream of its own (`thread_stream`); `trace`, when set to a list, receives
one record per range that `range_mask_cuda` ran.
"""
from __future__ import annotations

import ctypes
import math
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

BLOCK = 512                 # the kernels' block size (csrc/poisson.cu)
MAX_PAIRS_PER_BLOCK = 96    # pair-list gate (poisson_pallas.py:59)
DEVICE_FLOOR = 4096         # smallest range sent to the device
# close-list entries (int32 point indices) held at once: 256 MB. A window
# of blocks holds at most this many, or one block's intra pairs.
CLOSE_BUDGET = 1 << 26
# elements of one chunk of the block-pair test in pair_csr_torch
_PAIR_CHUNK = 1 << 22

_lock = threading.Lock()
launches = 0
counters = {"below_floor": 0, "pair_gate": 0, "kernel": 0, "plain": 0}
trace: list | None = None


def count(rule: str) -> None:
    with _lock:
        counters[rule] += 1


def reset_counters() -> None:
    global launches
    with _lock:
        launches = 0
        for k in counters:
            counters[k] = 0


def snapshot() -> dict:
    with _lock:
        return {"launches": launches, **counters}


def _launched() -> None:
    global launches
    with _lock:
        launches += 1


# -- the prep --------------------------------------------------------------------

class Prep(NamedTuple):
    """Host prep of one range: coordinate planes in the mode's dtype,
    optional analyze flags, the squared spacing, and the CSR list of cross
    pairs (bj < bi, ascending bj within a row)."""
    planes: np.ndarray          # (3, n) float64 or float32
    analyze: np.ndarray | None  # (n,) uint8
    sq: float                   # squared spacing, exact in the mode's dtype
    pair_ptr: np.ndarray        # (n_blocks + 1,) int32
    pair_bj: np.ndarray         # (n_cross,) int32
    block: int

    @property
    def n(self) -> int:
        return self.planes.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.pair_ptr.size - 1


def squared_spacing(spacing: float, precision: str) -> float:
    """The reference's float32 spacing product (Sampling.h:448-449); the
    f64 mode widens it to double exactly as the native kernel does."""
    sq = np.float32(spacing) * np.float32(spacing)
    return float(sq) if precision == "f64" else float(np.float32(sq))


def inflation(spacing: float) -> float:
    """The AABB inflation: spacing (+1e-4 relative). The close test's
    rounding (the float32 spacing product, float32 d2 in the f32 mode) can
    admit pairs a hair beyond the true spacing, and the prune must never be
    tighter than the close test."""
    return float(np.float32(spacing)) * (1.0 + 1e-4)


def _pair_csr(mins: np.ndarray, maxs: np.ndarray, s: float,
              max_pairs: int, row_chunk: int = 1024):
    """Cross pairs (bi, bj < bi) whose AABBs meet with bi inflated by s,
    as CSR; None once the pair count (cross + intra) passes max_pairs."""
    nb = mins.shape[0]
    lo = mins - s
    hi = maxs + s
    counts = np.zeros(nb + 1, dtype=np.int64)
    cols = []
    n_pairs = nb  # every block pairs with itself
    for r0 in range(0, nb, row_chunk):
        r1 = min(nb, r0 + row_chunk)
        inter = (np.arange(r0, r1)[:, None] > np.arange(r1)[None, :])
        for a in range(3):
            inter &= ((lo[r0:r1, a, None] <= maxs[None, :r1, a])
                      & (hi[r0:r1, a, None] >= mins[None, :r1, a]))
        counts[r0 + 1:r1 + 1] = inter.sum(axis=1)
        n_pairs += int(counts[r0 + 1:r1 + 1].sum())
        if n_pairs > max_pairs:
            return None
        cols.append(np.nonzero(inter)[1].astype(np.int32))
    pair_ptr = np.cumsum(counts).astype(np.int32)
    pair_bj = (np.concatenate(cols) if cols
               else np.zeros(0, dtype=np.int32))
    return pair_ptr, pair_bj


def prep(positions: np.ndarray, spacing: float,
         analyze_mask: np.ndarray | None = None, precision: str = "f64",
         block: int = BLOCK) -> Prep | None:
    """Host prep of one Morton-sorted range (poisson_pallas._prep's
    counterpart). None when the range is outside the kernel's envelope:
    empty, spacing <= 0, or the pair-list gate."""
    n = positions.shape[0]
    if n == 0 or spacing <= 0:
        return None
    pos = np.asarray(positions,
                     dtype=np.float64 if precision == "f64" else np.float32)
    n_blocks = -(-n // block)
    # per-block AABBs in the mode's dtype (float32 values widen exactly)
    full = (n // block) * block
    mins = np.empty((n_blocks, 3), dtype=np.float64)
    maxs = np.empty((n_blocks, 3), dtype=np.float64)
    if full:
        pb = pos[:full].reshape(-1, block, 3)
        mins[:full // block] = pb.min(axis=1)
        maxs[:full // block] = pb.max(axis=1)
    if full < n:
        mins[-1] = pos[full:].min(axis=0)
        maxs[-1] = pos[full:].max(axis=0)
    csr = _pair_csr(mins, maxs, inflation(spacing),
                    MAX_PAIRS_PER_BLOCK * n_blocks)
    if csr is None:
        return None
    analyze = (None if analyze_mask is None
               else np.ascontiguousarray(analyze_mask, dtype=np.uint8))
    return Prep(np.ascontiguousarray(pos.T), analyze,
                squared_spacing(spacing, precision), csr[0], csr[1], block)


def pair_csr_torch(planes: torch.Tensor, s: float, max_pairs: int,
                   block: int = BLOCK):
    """`_pair_csr` in torch ops on the planes' device, from the (3, n)
    planes: the block AABBs, then the same pair set (bj < bi, ascending bj
    within a row) as int32 (pair_ptr, pair_bj), or None past max_pairs.
    The gate reads one count from the device: the only synchronise."""
    n = planes.shape[1]
    device = planes.device
    nb = -(-n // block)
    full = (n // block) * block
    mins = torch.empty((nb, 3), dtype=torch.float64, device=device)
    maxs = torch.empty((nb, 3), dtype=torch.float64, device=device)
    if full:
        pb = planes[:, :full].reshape(3, -1, block)
        mins[:full // block] = pb.amin(dim=2).t().to(torch.float64)
        maxs[:full // block] = pb.amax(dim=2).t().to(torch.float64)
    if full < n:
        mins[-1] = planes[:, full:].amin(dim=1).to(torch.float64)
        maxs[-1] = planes[:, full:].amax(dim=1).to(torch.float64)
    lo = mins - s
    hi = maxs + s
    rows = torch.arange(nb, device=device)
    chunk = max(1, _PAIR_CHUNK // nb)

    def meets(r0: int, r1: int) -> torch.Tensor:
        m = rows[r0:r1, None] > rows[None, :r1]
        for a in range(3):
            m &= ((lo[r0:r1, a, None] <= maxs[None, :r1, a])
                  & (hi[r0:r1, a, None] >= mins[None, :r1, a]))
        return m

    counts = torch.zeros(nb, dtype=torch.int64, device=device)
    for r0 in range(0, nb, chunk):
        r1 = min(nb, r0 + chunk)
        counts[r0:r1] = meets(r0, r1).sum(dim=1)
    n_cross = int(counts.sum())
    if n_cross + nb > max_pairs:
        return None
    ptr = torch.zeros(nb + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=ptr[1:])
    # every pair goes to its slot; the others to a spare last slot
    pair_bj = torch.empty(n_cross + 1, dtype=torch.int32, device=device)
    for r0 in range(0, nb, chunk):
        r1 = min(nb, r0 + chunk)
        m = meets(r0, r1)
        slot = torch.where(m, ptr[r0:r1, None] + m.cumsum(dim=1) - 1, n_cross)
        pair_bj.scatter_(0, slot.reshape(-1),
                         rows[None, :r1].expand(r1 - r0, r1).reshape(-1)
                         .to(torch.int32))
    return ptr.to(torch.int32), pair_bj[:n_cross]


def plan_windows(block_totals: np.ndarray, budget: int) -> list:
    """Cut the blocks into windows [b0, b1) of at most `budget` close-list
    entries (by each block's full count), each at least one block."""
    cum = np.concatenate([[0], np.cumsum(block_totals, dtype=np.int64)])
    nb = block_totals.size
    windows, b0 = [], 0
    while b0 < nb:
        b1 = int(np.searchsorted(cum, cum[b0] + budget, side="right")) - 1
        b1 = min(nb, max(b1, b0 + 1))
        windows.append((b0, b1))
        b0 = b1
    return windows


def _list_capacity(block_totals: np.ndarray, windows: list, budget: int,
                   block: int) -> int:
    """Entries a window stores at most: its full count when that is within
    the budget, else (a window of one block past the budget) only the
    block's own pairs, since its earlier close points lie in earlier
    windows."""
    cap = 0
    for b0, b1 in windows:
        total = int(block_totals[b0:b1].sum())
        if total > budget:
            total = min(total, block * (block - 1) // 2)
        cap = max(cap, total)
    return cap


def _masked(planes: torch.Tensor, analyze: torch.Tensor | None):
    """The planes with x = NaN at the points that are not analyzed: every
    d2 with such a point is NaN, never < sq, so it is neither a source nor
    a target of a close pair."""
    if analyze is None:
        return planes
    masked = planes.clone()
    masked[0].masked_fill_(analyze == 0, float("nan"))
    return masked


# -- the CUDA kernels --------------------------------------------------------------

_c_fns: dict = {}


def _kernel_fns(precision: str) -> dict:
    """ctypes entry points of csrc/poisson.cu for the mode (built and
    loaded at first use): close_count, close_fill, decide."""
    fns = _c_fns.get(precision)
    if fns is not None:
        return fns
    from ._cuda_build import load_kernel_library

    lib = load_kernel_library("poisson")
    lib.poisson_block_size.argtypes = []
    lib.poisson_block_size.restype = ctypes.c_int
    if lib.poisson_block_size() != BLOCK:
        raise RuntimeError("csrc/poisson.cu BLOCK disagrees with "
                           "ops/poisson_cuda.BLOCK")
    scalar = ctypes.c_double if precision == "f64" else ctypes.c_float
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    common = [p, i64, scalar, ctypes.c_double, p, p, i32, i32, i64]
    fns = {"close_count": getattr(lib, f"poisson_close_count_{precision}"),
           "close_fill": getattr(lib, f"poisson_close_fill_{precision}"),
           "decide": lib.poisson_decide}
    fns["close_count"].argtypes = common + [p, p]
    fns["close_fill"].argtypes = common + [p, p, p, p, p]
    fns["decide"].argtypes = [i64, i32, i32, p, p, p, p, p, p, p, p]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    _c_fns[precision] = fns
    return fns


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor | None):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(fn, *args) -> None:
    """Call one launching entry point on the current stream; raise on a
    refused launch, count it otherwise."""
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"poisson kernel launch failed: CUDA error {err}")
    _launched()


def _checked_inputs(planes, analyze, pair_ptr, pair_bj) -> tuple:
    """(precision, n, n_blocks) after checking the kernels' inputs."""
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"the Poisson kernels need CUDA tensors, got "
                         f"{device}")
    precision = {torch.float64: "f64", torch.float32: "f32"}.get(planes.dtype)
    if precision is None:
        raise TypeError(f"planes must be float64 or float32, "
                        f"got {planes.dtype}")
    n = planes.shape[-1]
    if n >= 1 << 31:
        raise ValueError(f"a range holds at most 2^31 - 1 points, got {n}")
    n_blocks = -(-n // BLOCK)
    _check(planes, "planes", planes.dtype, (3, n), device)
    if analyze is not None:
        _check(analyze, "analyze", torch.uint8, (n,), device)
    _check(pair_ptr, "pair_ptr", torch.int32, (n_blocks + 1,), device)
    _check(pair_bj, "pair_bj", torch.int32, (pair_bj.shape[0],), device)
    return precision, n, n_blocks


def _reach(sq: float) -> float:
    """Phase A's cull reach: a point skips a 32-point chunk of a listed
    block when some axis puts the chunk's AABB beyond it. sqrt(sq) is the
    float32 spacing (exactly in f64, to 3e-8 in f32), and the 1e-4
    relative margin is the pair prune's (`inflation`), so the cull is never
    tighter than the close test."""
    return math.sqrt(sq) * (1.0 + 1e-4)


def _close_count(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1, counts):
    _launch(fns["close_count"], _ptr(planes), n, sq, _reach(sq),
            _ptr(pair_ptr), _ptr(pair_bj), b0, b1, b0 * BLOCK, _ptr(counts))


def _close_fill(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1, out,
                offsets, idx, blocked):
    _launch(fns["close_fill"], _ptr(planes), n, sq, _reach(sq),
            _ptr(pair_ptr), _ptr(pair_bj), b0, b1, b0 * BLOCK, _ptr(out),
            _ptr(offsets), _ptr(idx), _ptr(blocked))


def _decide(fns, n, b0, b1, offsets, idx, blocked, ticket, flags, state,
            out):
    _launch(fns["decide"], n, b0, b1, _ptr(offsets), _ptr(idx),
            _ptr(blocked), _ptr(ticket), _ptr(flags), _ptr(state), _ptr(out))


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                          device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int64, out=offsets[1:])
    return offsets


def accept_mask_cuda(planes: torch.Tensor, analyze: torch.Tensor | None,
                     sq: float, pair_ptr: torch.Tensor,
                     pair_bj: torch.Tensor, budget: int = CLOSE_BUDGET,
                     stats: dict | None = None) -> torch.Tensor:
    """The two-phase kernels on CUDA tensors, on the current stream:
    phase A counts the close pairs of every point, the windows are planned
    from those counts (one synchronise), then each window runs phase A's
    fill and phase B. Returns the (n,) uint8 accept mask on the card.

    `stats`, when given, receives "windows", "close_entries" (the full
    count), "lists": phase A's (offsets, idx, blocked) of the last window
    (for a range in one window, the whole range's, as `close_lists_torch`
    gives them; idx is valid up to offsets[-1]) and "events": (phase,
    start, end) CUDA events, read with `phase_ms` once the stream is
    synchronised."""
    precision, n, nb = _checked_inputs(planes, analyze, pair_ptr, pair_bj)
    fns = _kernel_fns(precision)
    device = planes.device
    with torch.cuda.device(device):
        events = [] if stats is not None else None

        def mark():
            if events is None:
                return None
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        a0 = mark()
        planes = _masked(planes, analyze)
        out = torch.empty(n, dtype=torch.uint8, device=device)
        counts = torch.empty(nb * BLOCK, dtype=torch.int32, device=device)
        blocked = torch.empty(nb * BLOCK, dtype=torch.uint8, device=device)
        flags = torch.zeros(nb, dtype=torch.int32, device=device)
        state = torch.zeros(n, dtype=torch.uint8, device=device)
        _close_count(fns, planes, n, sq, pair_ptr, pair_bj, 0, nb, counts)
        totals = counts.view(nb, BLOCK).sum(dim=1, dtype=torch.int64).cpu()
        totals = totals.numpy()
        windows = plan_windows(totals, budget)
        idx = torch.empty(_list_capacity(totals, windows, budget, BLOCK),
                          dtype=torch.int32, device=device)
        tickets = torch.zeros(len(windows), dtype=torch.int32, device=device)
        for w, (b0, b1) in enumerate(windows):
            p0, p1 = b0 * BLOCK, b1 * BLOCK
            if w:
                a0 = mark()
                _close_count(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1,
                             counts[p0:p1])
            offsets = _offsets(counts[p0:p1])
            _close_fill(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1, out,
                        offsets, idx, blocked[p0:p1])
            a1 = mark()
            _decide(fns, n, b0, b1, offsets, idx, blocked[p0:p1],
                    tickets[w:w + 1], flags, state, out)
            if events is not None:
                events += [("A", a0, a1), ("B", a1, mark())]
        if stats is not None:
            stats.update(windows=len(windows),
                         close_entries=int(totals.sum()), events=events,
                         lists=(offsets, idx, blocked[p0:p1]))
    return out


def phase_ms(stats: dict) -> dict:
    """Milliseconds of phase A and phase B summed over the windows of one
    `accept_mask_cuda` call (after its stream was synchronised)."""
    ms = {"A": 0.0, "B": 0.0}
    for phase, start, end in stats["events"]:
        ms[phase] += start.elapsed_time(end)
    return ms


_tls = threading.local()


def own_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A CUDA stream on `device` made outside PyTorch's pool
    (`poisson_stream_create` in csrc/poisson.cu, non-blocking). The pool
    hands out 32 streams per device in turn, so past 32 sending threads it
    would give two threads one stream; each call here makes a new one.

    The stream lives for the process: it is never destroyed, so its handle
    is never handed to another thread, and a trace that names a range's
    stream by its handle names one thread's stream. The engine starts
    about two sending threads per core and run; a CUDA stream is a small
    object."""
    from ._cuda_build import load_kernel_library

    lib = load_kernel_library("poisson")
    lib.poisson_stream_create.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    handle = ctypes.c_void_p()
    with torch.cuda.device(device):
        err = lib.poisson_stream_create(ctypes.byref(handle))
    if err != 0:
        raise RuntimeError(f"poisson_stream_create failed on {device}: "
                           f"CUDA error {err}")
    return torch.cuda.ExternalStream(handle.value, device=device)


def thread_stream(device: torch.device | str) -> torch.cuda.ExternalStream:
    """The calling thread's CUDA stream on `device`: one `own_stream` made
    at the thread's first call and kept for its later calls, so that ranges
    sent from several worker threads run on the card at once, each thread
    on a stream no other thread has. `cuda` with no index means the current
    device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"thread_stream needs a CUDA device, got {device}")
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    stream = getattr(_tls, "stream", None)
    if stream is None or stream.device != device:
        stream = _tls.stream = own_stream(device)
    return stream


def range_mask_cuda(positions: np.ndarray, spacing: float,
                    analyze_mask: np.ndarray | None = None,
                    precision: str = "f64",
                    device: torch.device | str = "cuda") -> np.ndarray | None:
    """Accept mask of one Morton-sorted range on the card, on the calling
    thread's stream: upload from pinned memory, the pair CSR on the card
    (None past the pair gate), the kernels, the mask download. Synchronises
    only that stream. Returns a numpy bool array.

    With `trace` set, the range's record holds, for each part (upload,
    prep, kernel, download), its stream time from CUDA events (`*_ms`), the
    calling thread's wall time enqueueing it, synchronises inside the part
    included (`host_*_ms`), and that thread's CPU time over the same span
    (`cpu_*_ms`); `wait_ms` is the wall time of the final synchronise."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"range_mask_cuda needs a CUDA device, got {device}")
    n = positions.shape[0]
    if n == 0 or spacing <= 0:
        return None
    stream = thread_stream(device)
    dtype = torch.float64 if precision == "f64" else torch.float32
    records = trace
    marks = []

    def mark():
        if records is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((e, time.perf_counter(), time.thread_time()))

    with torch.cuda.device(device), torch.cuda.stream(stream):
        mark()
        pos = torch.from_numpy(np.ascontiguousarray(positions,
                                                    dtype=np.float64))
        pos = pos.pin_memory().to(device, non_blocking=True)
        analyze = None
        if analyze_mask is not None:
            analyze = torch.from_numpy(np.ascontiguousarray(
                analyze_mask, dtype=np.uint8)).pin_memory().to(
                    device, non_blocking=True)
        mark()
        planes = pos.to(dtype).t().contiguous()
        nb = -(-n // BLOCK)
        csr = pair_csr_torch(planes, inflation(spacing),
                             MAX_PAIRS_PER_BLOCK * nb)
        if csr is None:
            return None
        mark()
        stats = {} if records is not None else None
        out = accept_mask_cuda(planes, analyze,
                               squared_spacing(spacing, precision), *csr,
                               stats=stats)
        mark()
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        mark()
        stream.synchronize()
        synced = time.perf_counter()
    if records is not None:
        record = {"n": n, "stream": stream.cuda_stream,
                  "thread": threading.current_thread().name,
                  "windows": stats["windows"], **phase_ms(stats),
                  "wait_ms": (synced - marks[-1][1]) * 1e3}
        for part, (a, b) in zip(("upload", "prep", "kernel", "download"),
                                zip(marks, marks[1:])):
            record[f"{part}_ms"] = a[0].elapsed_time(b[0])
            record[f"host_{part}_ms"] = (b[1] - a[1]) * 1e3
            record[f"cpu_{part}_ms"] = (b[2] - a[2]) * 1e3
        with _lock:
            records.append(record)
    return host.numpy().view(bool).copy()


# -- the plain-torch versions ----------------------------------------------------

def _d2(xi: torch.Tensor, xj: torch.Tensor) -> torch.Tensor:
    """(bi, bj) squared distances, operation order matching the kernel:
    each op is its own rounding (no fused multiply-add)."""
    dx = xi[0][:, None] - xj[0][None, :]
    dy = xi[1][:, None] - xj[1][None, :]
    dz = xi[2][:, None] - xj[2][None, :]
    return (dx * dx + dy * dy) + dz * dz


def accept_mask_torch(planes: torch.Tensor, analyze: torch.Tensor | None,
                      sq: float, pair_ptr: torch.Tensor,
                      pair_bj: torch.Tensor,
                      block: int = BLOCK) -> torch.Tensor:
    """The whole mask, block-sequential, in torch ops, on whatever device
    the tensors are on: per block, the cross step as
    (close & accepted_j).any(1) and the intra step as a relaxation loop.
    Returns the (n,) uint8 mask."""
    n = planes.shape[1]
    device = planes.device
    sq_t = torch.tensor(sq, dtype=planes.dtype, device=device)
    acc = torch.zeros(n, dtype=torch.bool, device=device)
    ptr = pair_ptr.tolist()
    offsets = torch.arange(block, device=device)
    for bi in range(len(ptr) - 1):
        lo, hi = bi * block, min(n, (bi + 1) * block)
        xi = planes[:, lo:hi]
        und = (torch.ones(hi - lo, dtype=torch.bool, device=device)
               if analyze is None else analyze[lo:hi] != 0)
        bjs = pair_bj[ptr[bi]:ptr[bi + 1]]
        if bjs.numel():
            # bj < bi: full blocks. (close & accepted_j).any(1), with the
            # close test evaluated on the accepted columns only
            idx = (bjs.to(torch.int64)[:, None] * block
                   + offsets[None, :]).reshape(-1)
            idx = idx[acc[idx]]
            und &= ~(_d2(xi, planes[:, idx]) < sq_t).any(dim=1)
        b = hi - lo
        close = (_d2(xi, xi) < sq_t) & torch.ones(
            b, b, dtype=torch.bool, device=device).tril(-1)
        _relax(close, und, acc[lo:hi])
    return acc.to(torch.uint8)


def _relax(close: torch.Tensor, und: torch.Tensor,
           acc_b: torch.Tensor) -> None:
    """Earliest-undecided relaxation of one block over its strict-lower
    close matrix: reject on an accepted close earlier point, accept when no
    close earlier point is undecided. Writes the accepts into acc_b."""
    while bool(und.any()):
        acc_hit = (close & acc_b[None, :]).any(dim=1)
        und_hit = (close & und[None, :]).any(dim=1)
        newly_acc = und & ~acc_hit & ~und_hit
        acc_b |= newly_acc
        und &= ~(acc_hit | newly_acc)


def close_lists_torch(planes: torch.Tensor, analyze: torch.Tensor | None,
                      sq: float, pair_ptr: torch.Tensor,
                      pair_bj: torch.Tensor, block: int = BLOCK,
                      b0: int = 0, b1: int | None = None,
                      out: torch.Tensor | None = None) -> tuple:
    """Phase A in torch ops for the window of blocks [b0, b1): (offsets
    int64 ((b1 - b0) * block + 1,), idx int32, blocked uint8 ((b1 - b0) *
    block,)), indexed from point b0 * block. Each point's list holds its
    earlier close points at or after b0 * block, in the kernel's order (the
    listed bj ascending, then its own block). A close point before b0 *
    block is resolved against the final mask `out`: an accepted one marks
    the point blocked. Padding and points not analyzed are blocked."""
    planes = _masked(planes, analyze)
    n = planes.shape[1]
    device = planes.device
    nb = -(-n // block)
    b1 = nb if b1 is None else b1
    sq_t = torch.tensor(sq, dtype=planes.dtype, device=device)
    ptr = pair_ptr.tolist()
    lane = torch.arange(block, device=device)
    counts = torch.zeros((b1 - b0) * block, dtype=torch.int64, device=device)
    blocked = torch.ones((b1 - b0) * block, dtype=torch.uint8, device=device)
    lists = []
    for bi in range(b0, b1):
        lo, hi = bi * block, min(n, (bi + 1) * block)
        xi = planes[:, lo:hi]
        bjs = pair_bj[ptr[bi]:ptr[bi + 1]].to(torch.int64)
        rej = torch.zeros(hi - lo, dtype=torch.bool, device=device)
        early = bjs[bjs < b0]
        if early.numel():
            cols = (early[:, None] * block + lane[None, :]).reshape(-1)
            rej = ((_d2(xi, planes[:, cols]) < sq_t)
                   & (out[cols] != 0)[None, :]).any(dim=1)
        late = bjs[bjs >= b0]
        cols = torch.cat([(late[:, None] * block + lane[None, :]).reshape(-1),
                          torch.arange(lo, hi, device=device)])
        close = _d2(xi, planes[:, cols]) < sq_t
        b = hi - lo
        close[:, cols.numel() - b:] &= torch.ones(
            b, b, dtype=torch.bool, device=device).tril(-1)
        rows, at = close.nonzero(as_tuple=True)
        lists.append(cols[at])
        counts[lo - b0 * block:hi - b0 * block] = close.sum(dim=1)
        analyzed = ~torch.isnan(xi[0])
        blocked[lo - b0 * block:hi - b0 * block] = (~analyzed | rej).to(
            torch.uint8)
    idx = (torch.cat(lists) if lists
           else torch.zeros(0, dtype=torch.int64, device=device))
    return _offsets(counts), idx.to(torch.int32), blocked


def decide_torch(n: int, offsets: torch.Tensor, idx: torch.Tensor,
                 blocked: torch.Tensor, block: int = BLOCK, b0: int = 0,
                 b1: int | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Phase B in torch ops for the window [b0, b1) of `close_lists_torch`:
    blocks in ascending order, each rejecting its points on an accepted
    close point of an earlier block, then relaxing over its own close
    pairs. Writes into `out` (a new (n,) uint8 mask when None) and returns
    it."""
    device = offsets.device
    nb = -(-n // block)
    b1 = nb if b1 is None else b1
    if out is None:
        out = torch.zeros(n, dtype=torch.uint8, device=device)
    base0 = b0 * block
    for b in range(b0, b1):
        lo, hi = b * block, min(n, (b + 1) * block)
        m = hi - lo
        und = blocked[lo - base0:hi - base0] == 0
        e0, e1 = int(offsets[lo - base0]), int(offsets[hi - base0])
        ent = idx[e0:e1].to(torch.int64)
        owner = torch.repeat_interleave(
            torch.arange(m, device=device),
            offsets[lo - base0 + 1:hi - base0 + 1]
            - offsets[lo - base0:hi - base0])
        cross = ent < lo
        hits = torch.zeros(m, dtype=torch.int64, device=device).index_add_(
            0, owner[cross], out[ent[cross]].to(torch.int64))
        und &= hits == 0
        close = torch.zeros(m, m, dtype=torch.bool, device=device)
        close[owner[~cross], ent[~cross] - lo] = True
        acc_b = torch.zeros(m, dtype=torch.bool, device=device)
        _relax(close, und, acc_b)
        out[lo:hi] = acc_b.to(torch.uint8)
    return out


def accept_mask_two_phase_torch(planes: torch.Tensor,
                                analyze: torch.Tensor | None, sq: float,
                                pair_ptr: torch.Tensor,
                                pair_bj: torch.Tensor, block: int = BLOCK,
                                budget: int = CLOSE_BUDGET) -> torch.Tensor:
    """The kernels' whole two-phase path in torch ops, windows included:
    the (n,) uint8 mask, equal to `accept_mask_torch` at any budget."""
    n = planes.shape[1]
    offsets, _, _ = close_lists_torch(planes, analyze, sq, pair_ptr, pair_bj,
                                      block)
    totals = (offsets[block::block] - offsets[:-1:block]).cpu().numpy()
    out = torch.zeros(n, dtype=torch.uint8, device=planes.device)
    for b0, b1 in plan_windows(totals, budget):
        lists = close_lists_torch(planes, analyze, sq, pair_ptr, pair_bj,
                                  block, b0, b1, out)
        decide_torch(n, *lists, block, b0, b1, out)
    return out


def block_deps(offsets: torch.Tensor, idx: torch.Tensor, n: int,
               block: int = BLOCK) -> list:
    """The plain version of phase B's wait set, for a whole-range window:
    for every block, the sorted earlier blocks that hold a close point of
    one of its points (each a subset of its AABB pairs)."""
    counts = (offsets[1:] - offsets[:-1]).cpu()
    owner = torch.repeat_interleave(
        torch.arange(counts.numel()), counts) // block
    src = idx.cpu().to(torch.int64) // block
    keep = src < owner
    pairs = torch.unique(owner[keep] * (1 << 32) + src[keep]).numpy()
    nb = -(-n // block)
    deps = [[] for _ in range(nb)]
    for key in pairs.tolist():
        deps[key >> 32].append(key & 0xFFFFFFFF)
    return deps


def longest_chain(deps: list) -> int:
    """Blocks on the longest chain of waits in `block_deps`: phase B's
    critical path, in blocks decided one after another."""
    depth = [0] * len(deps)
    for b, ds in enumerate(deps):
        depth[b] = 1 + max((depth[d] for d in ds), default=0)
    return max(depth, default=0)


def accept_mask(p: Prep, device: torch.device | str) -> np.ndarray:
    """Accept mask of a host-prepped range with the block-sequential plain
    version, on the CPU (a range for the card goes to `range_mask_cuda`,
    which preps on the card). Returns a numpy bool array."""
    device = torch.device(device)
    if device.type != "cpu":
        raise ValueError(f"accept_mask runs the plain version on the CPU; "
                         f"got {device} (use range_mask_cuda on a card)")
    t = [None if a is None else torch.from_numpy(a)
         for a in (p.planes, p.analyze, p.pair_ptr, p.pair_bj)]
    return accept_mask_torch(*t[:2], p.sq, *t[2:], p.block).numpy().view(
        bool)

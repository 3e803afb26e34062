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
(`prep`, the CPU path), or on the card the prep kernels of csrc/poisson.cu
(`range_prep`, which `range_mask_cuda` runs; plain version `prep_torch`,
from `pair_csr_torch` and `_masked`). The mask does not depend on the block
size. Two formulations compute it:

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
`launches` counts K2's launches (phase A's counting and filling kernels,
phase B's deciding kernel); the wrapper adds one where it launches a kernel
and nowhere else, so a range past the pair gate adds one: its counting pass
is launched and returns at once on the card. `prep_launches` counts the
prep kernels' launches the same way. Each sending thread runs its ranges on
a CUDA stream that no other live thread holds (`thread_stream`,
`StreamPool`), with the buffers of a workspace that goes with the stream
(`_Workspace`); `trace`, when set to a list, receives one record per range
that `range_mask_cuda` ran.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
import time
import weakref
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

BLOCK = 512                 # the kernels' block size (csrc/poisson.cu)
# the prep: a range of at most PREP_ONE_LAUNCH blocks is one launch, a
# larger one two: the blocks, then a CTA a row testing every earlier block
# or, from PREP_GROUPED_FROM blocks, tiles of rows testing a union box per
# PREP_GROUP blocks first (csrc/poisson.cu)
PREP_ONE_LAUNCH = 512
PREP_GROUPED_FROM = 3200
PREP_GROUP = 32
# the prep's epochs a workspace counts through, 1 .. PREP_EPOCHS - 1,
# before it zeroes its flags and status words again
PREP_EPOCHS = 1 << 16
MAX_PAIRS_PER_BLOCK = 96    # pair-list gate (poisson_pallas.py:59)
DEVICE_FLOOR = 4096         # smallest range sent to the device
# close-list entries (int32 point indices) held at once: 256 MB. A window
# of blocks holds at most this many, or one block's intra pairs.
CLOSE_BUDGET = 1 << 26
# The memory of the sending threads' workspaces, summed over all live ones.
# A workspace keeps what its largest range needed (about 26 bytes a point
# pinned, 70 on the card, up to twice that after rounding, plus the close
# lists), and the engine runs 8-18 sending threads, more on a larger host;
# page-locked memory is taken from what the host's batches and the sinks'
# write-behind need, and card memory from the sweep and the exchange. A
# range that would take the workspaces past a cap runs on one-off buffers
# (pageable host memory), dropped when it ends.
PINNED_CAP = 2 << 30
DEVICE_CAP = 8 << 30
# the buffer groups of a workspace (`_Workspace.arrays`)
PARTS = ("host", "upload", "prep", "k2")
# elements of one chunk of the block-pair test in pair_csr_torch
_PAIR_CHUNK = 1 << 22

_lock = threading.Lock()
launches = 0
prep_launches = 0
counters = {"below_floor": 0, "pair_gate": 0, "kernel": 0, "plain": 0}
trace: list | None = None


def count(rule: str) -> None:
    with _lock:
        counters[rule] += 1


def reset_counters() -> None:
    global launches, prep_launches
    with _lock:
        launches = prep_launches = 0
        for k in counters:
            counters[k] = 0


def snapshot() -> dict:
    with _lock:
        return {"launches": launches, **counters}


def _launched() -> None:
    global launches
    with _lock:
        launches += 1


def _prep_launched() -> None:
    global prep_launches
    with _lock:
        prep_launches += 1


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


def prep_launches_per_range(n_blocks: int) -> int:
    """Kernel launches of the prep of a range of `n_blocks` blocks on the
    card: one up to PREP_ONE_LAUNCH blocks, two above."""
    if n_blocks <= 0:
        return 0
    return 1 if n_blocks <= PREP_ONE_LAUNCH else 2


def prep_grouped(n_blocks: int) -> bool:
    """Whether the prep's second launch tests group boxes first (the
    root-sized ranges), not every earlier block."""
    return n_blocks >= PREP_GROUPED_FROM


def prep_groups(n_blocks: int) -> int:
    """The group boxes of a range's prep in two launches."""
    return max(1, -(-n_blocks // PREP_GROUP))


def gate_capacity(n_blocks: int) -> int:
    """pair_bj's capacity on the range path: the cross pairs the gate
    admits (it counts each block's pair with itself too), about 0.75 bytes
    a point."""
    return MAX_PAIRS_PER_BLOCK * n_blocks - n_blocks


def prep_torch(positions: torch.Tensor, analyze: torch.Tensor | None,
               spacing: float, precision: str = "f64",
               block: int = BLOCK) -> tuple:
    """The plain version of the prep kernels (csrc/poisson.cu
    prep_one_kernel; prep_blocks_kernel, then prep_rows_kernel or
    prep_pairs_kernel) on (n, 3) float64 positions and
    an optional (n,) uint8 analyze mask: (planes, pair_ptr, pair_bj, head).
    planes: (3, n) in the mode's dtype, x = NaN where the point is not
    analyzed (`_masked`). pair_ptr: (n_blocks + 1,) int32, and the first
    n_cross entries of pair_bj, (gate_capacity(n_blocks),) int32:
    `pair_csr_torch`'s CSR. head: int64 (gate flag, n_cross); the gate is
    set when n_cross + n_blocks passes MAX_PAIRS_PER_BLOCK * n_blocks, and
    then pair_bj's entries are not part of the contract."""
    dtype = torch.float64 if precision == "f64" else torch.float32
    planes = positions.to(dtype).t().contiguous()
    nb = -(-planes.shape[1] // block)
    ptr, bj = pair_csr_torch(planes, inflation(spacing), 1 << 62, block)
    n_cross, cap = bj.numel(), gate_capacity(nb)
    pair_bj = torch.zeros(cap, dtype=torch.int32, device=positions.device)
    if n_cross <= cap:
        pair_bj[:n_cross] = bj
    head = torch.tensor([int(n_cross > cap), n_cross], dtype=torch.int64,
                        device=positions.device)
    return _masked(planes, analyze), ptr, pair_bj, head


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
    loaded at first use): close_count, close_fill, decide, the prep's
    prep_one (one launch), prep_blocks and prep_rows or prep_pairs (two),
    and copy.
    Each only queues work on a stream and returns in microseconds, so it
    is called holding the interpreter lock (ctypes.PyDLL): with the
    engine's 8-25 sending threads a thread that let the lock go waited
    about 0.6 ms to win it back (PERF.md section 5), and a range makes
    seven or eight such calls."""
    fns = _c_fns.get(precision)
    if fns is not None:
        return fns
    from ._cuda_build import load_kernel_library

    lib = load_kernel_library("poisson")
    for name, want in (("poisson_block_size", BLOCK),
                       ("poisson_prep_one_launch", PREP_ONE_LAUNCH),
                       ("poisson_prep_group", PREP_GROUP),
                       ("poisson_prep_epochs", PREP_EPOCHS)):
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/poisson.cu {name}() disagrees with "
                               f"ops/poisson_cuda ({want})")
    held = ctypes.PyDLL(lib._name)
    scalar = ctypes.c_double if precision == "f64" else ctypes.c_float
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    common = [p, i64, scalar, ctypes.c_double, p, p, i32, i32, i64]
    fns = {"close_count": getattr(held, f"poisson_close_count_{precision}"),
           "close_fill": getattr(held, f"poisson_close_fill_{precision}"),
           "decide": held.poisson_decide,
           "prep_one": getattr(held, f"poisson_prep_one_{precision}"),
           "prep_blocks": getattr(held, f"poisson_prep_blocks_{precision}"),
           "prep_pairs": held.poisson_prep_pairs,
           "prep_rows": held.poisson_prep_rows,
           "copy": held.poisson_copy}
    fns["close_count"].argtypes = common + [p, p, p]
    fns["close_fill"].argtypes = common + [p, p, p, p, p]
    fns["decide"].argtypes = [i64, i32, i32, p, p, p, p, p, p, p, p]
    fns["prep_one"].argtypes = [p, p, i64, p, p, p, p, i32, p, p, p,
                                ctypes.c_double, i64, p, p, p, p]
    fns["prep_blocks"].argtypes = [p, p, i64, p, p, p, p, p, p, p, p]
    fns["prep_pairs"].argtypes = [p, p, i32, ctypes.c_double, i64, p, p, p,
                                  p, i32, p, p]
    fns["prep_rows"].argtypes = [p, i32, ctypes.c_double, i64, p, p, p, p,
                                 i32, p, p]
    fns["copy"].argtypes = [p, p, i64, ctypes.c_int, p]
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


def _launch(fn, *args, counter=_launched) -> None:
    """Call one launching entry point on the current stream; raise on a
    refused launch, count it on `counter` otherwise."""
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"poisson kernel launch failed: CUDA error {err}")
    counter()


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


# The kernels' wrappers below launch on a CUDA tensor and write into the
# buffers they are given. Their CPU branches, which run the plain versions,
# are there for the tests of the range path (tests/test_torch_poisson_prep.py
# drives `_range_mask` and `range_prep` on CPU workspaces).

def _prep(pos, analyze, n, nb, spacing, precision, buf) -> int:
    """The prep of a range into buf.planes, .ptr, .bj and .head[:2] (the
    prep kernels: one launch up to PREP_ONE_LAUNCH blocks, two above; on
    the card it also zeroes buf.state, .flags and .tickets and uses
    buf.box and .gbox as scratch, buf.gcount (zero before and after), and
    buf.ready and .status with the epoch of buf.ws). pos is the
    range's (3n,) float64 positions, analyze its (n,) uint8 mask or None.
    Returns the kernels it launched (0 on the CPU)."""
    if pos.device.type == "cpu":
        planes, ptr, bj, head = prep_torch(pos.view(n, 3), analyze, spacing,
                                           precision)
        buf.planes.copy_(planes)
        buf.ptr.copy_(ptr)
        buf.bj.copy_(bj)
        buf.head[:2].copy_(head)
        return 0
    fns = _kernel_fns(precision)
    s, cap = inflation(spacing), gate_capacity(nb)
    epoch = buf.ws.prep_epoch()
    if prep_launches_per_range(nb) == 1:
        _launch(fns["prep_one"], _ptr(pos), _ptr(analyze), n,
                _ptr(buf.planes), _ptr(buf.box), _ptr(buf.ready),
                _ptr(buf.status), epoch, _ptr(buf.state),
                _ptr(buf.flags), _ptr(buf.tickets), s, cap, _ptr(buf.ptr),
                _ptr(buf.bj), _ptr(buf.head), counter=_prep_launched)
        return 1
    grouped = prep_grouped(nb)
    gbox, gcount = (buf.gbox, buf.gcount) if grouped else (None, None)
    _launch(fns["prep_blocks"], _ptr(pos), _ptr(analyze), n,
            _ptr(buf.planes), _ptr(buf.box), _ptr(gbox), _ptr(gcount),
            _ptr(buf.state), _ptr(buf.flags), _ptr(buf.tickets),
            counter=_prep_launched)
    if grouped:
        _launch(fns["prep_pairs"], _ptr(buf.box), _ptr(buf.gbox), nb, s,
                cap, _ptr(buf.ptr), _ptr(buf.bj), _ptr(buf.ready),
                _ptr(buf.status), epoch, _ptr(buf.head),
                counter=_prep_launched)
    else:
        _launch(fns["prep_rows"], _ptr(buf.box), nb, s, cap, _ptr(buf.ptr),
                _ptr(buf.bj), _ptr(buf.ready), _ptr(buf.status), epoch,
                _ptr(buf.head), counter=_prep_launched)
    return 2


def _close_count(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1, counts,
                 gate=None):
    """Phase A's counting pass over [b0, b1); it does nothing when
    gate[0] (the prep's head) is set."""
    if planes.device.type == "cpu":
        if gate is None or not gate[0]:
            offsets, _, _ = close_lists_torch(
                planes, None, sq, pair_ptr, pair_bj, BLOCK, b0, b1,
                torch.zeros(n, dtype=torch.uint8))
            counts.copy_(offsets[1:] - offsets[:-1])
        return
    _launch(fns["close_count"], _ptr(planes), n, sq, _reach(sq),
            _ptr(pair_ptr), _ptr(pair_bj), b0, b1, b0 * BLOCK, _ptr(gate),
            _ptr(counts))


def _close_fill(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1, out,
                offsets, idx, blocked):
    if planes.device.type == "cpu":
        _, lists, flags = close_lists_torch(planes, None, sq, pair_ptr,
                                            pair_bj, BLOCK, b0, b1, out)
        idx[:lists.numel()] = lists
        blocked.copy_(flags)
        return
    _launch(fns["close_fill"], _ptr(planes), n, sq, _reach(sq),
            _ptr(pair_ptr), _ptr(pair_bj), b0, b1, b0 * BLOCK, _ptr(out),
            _ptr(offsets), _ptr(idx), _ptr(blocked))


def _decide(fns, n, b0, b1, offsets, idx, blocked, ticket, flags, state,
            out):
    if offsets.device.type == "cpu":
        decide_torch(n, offsets, idx, blocked, BLOCK, b0, b1, out)
        return
    _launch(fns["decide"], n, b0, b1, _ptr(offsets), _ptr(idx),
            _ptr(blocked), _ptr(ticket), _ptr(flags), _ptr(state), _ptr(out))


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                          device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int64, out=offsets[1:])
    return offsets


def _copy(fns, dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst <- src between a workspace's pinned host buffer and its device
    buffer, queued on the current stream; with fns None (the CPU, or a
    one-off workspace's pageable host memory, which a copy waits on) a
    torch copy, which lets the interpreter lock go."""
    if fns is None:
        dst.copy_(src, non_blocking=True)
        return
    kind = 1 if dst.device.type == "cuda" else 2  # cudaMemcpyKind
    stream = torch.cuda.current_stream().cuda_stream
    err = fns["copy"](_ptr(dst), _ptr(src), src.nbytes, kind,
                      ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"poisson copy failed: CUDA error {err}")


def _event(events):
    """A CUDA event recorded on the current stream, when timing."""
    if events is None:
        return None
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _run_windows(fns, planes, n, sq, pair_ptr, pair_bj, totals, budget,
                 buf, take_idx, events, a0) -> tuple:
    """Phase A's fill and phase B window by window, after phase A's
    counting pass over every block (buf.counts; `totals` its per-block
    sums, on the host). buf holds out, counts, blocked, flags, state and
    tickets (zeroed) and offsets (offsets[0] = 0); take_idx(entries) gives
    the close-list buffer. `events`, when a list, receives (phase, start,
    end) CUDA events, phase A from `a0`. Returns (windows, the last
    window's lists (offsets, idx, blocked))."""
    windows = plan_windows(totals, budget)
    idx = take_idx(_list_capacity(totals, windows, budget, BLOCK))
    for w, (b0, b1) in enumerate(windows):
        p0, p1 = b0 * BLOCK, b1 * BLOCK
        if w:
            a0 = _event(events)
            _close_count(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1,
                         buf.counts[p0:p1])
        offsets = buf.offsets[:p1 - p0 + 1]
        torch.cumsum(buf.counts[p0:p1], 0, dtype=torch.int64,
                     out=offsets[1:])
        _close_fill(fns, planes, n, sq, pair_ptr, pair_bj, b0, b1, buf.out,
                    offsets, idx, buf.blocked[p0:p1])
        a1 = _event(events)
        _decide(fns, n, b0, b1, offsets, idx, buf.blocked[p0:p1],
                buf.tickets[w:w + 1], buf.flags, buf.state, buf.out)
        if events is not None:
            events += [("A", a0, a1), ("B", a1, _event(events))]
    return windows, (offsets, idx, buf.blocked[p0:p1])


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
        a0 = _event(events)
        planes = _masked(planes, analyze)
        buf = _Workspace(device, counted=False).arrays(n, precision, False,
                                                        ("k2",))
        for t in (buf.flags, buf.state, buf.tickets):
            t.zero_()  # the range path's prep zeroes them
        _close_count(fns, planes, n, sq, pair_ptr, pair_bj, 0, nb,
                     buf.counts)
        totals = buf.counts.view(nb, BLOCK).sum(dim=1, dtype=torch.int64)
        totals = totals.cpu().numpy()
        windows, lists = _run_windows(
            fns, planes, n, sq, pair_ptr, pair_bj, totals, budget, buf,
            lambda k: torch.empty(k, dtype=torch.int32, device=device),
            events, a0)
        if stats is not None:
            stats.update(windows=len(windows),
                         close_entries=int(totals.sum()), events=events,
                         lists=lists)
    return buf.out


def range_prep(positions: torch.Tensor, analyze: torch.Tensor | None,
               spacing: float, precision: str = "f64") -> tuple:
    """The prep of one range, as the range path runs it, into one-off
    buffers of a workspace: the prep kernels on CUDA tensors (on the
    current stream, nothing synchronised), their plain version `prep_torch`
    on CPU ones. positions: (n, 3) float64; analyze: (n,) uint8 or None.
    Returns (planes, pair_ptr, pair_bj, head) as `prep_torch` does."""
    n = positions.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"a range holds at most 2^31 - 1 points, got {n}")
    device = positions.device
    _check(positions, "positions", torch.float64, (n, 3), device)
    if analyze is not None:
        _check(analyze, "analyze", torch.uint8, (n,), device)
    buf = _Workspace(device, counted=False).arrays(n, precision, False,
                                                    ("prep", "k2"))
    with (torch.cuda.device(device) if device.type == "cuda"
          else contextlib.nullcontext()):
        _prep(positions.view(-1), analyze, n, -(-n // BLOCK), spacing,
              precision, buf)
    return buf.planes, buf.ptr, buf.bj, buf.head[:2]


def phase_ms(stats: dict) -> dict:
    """Milliseconds of phase A and phase B summed over the windows of one
    `accept_mask_cuda` call (after its stream was synchronised)."""
    ms = {"A": 0.0, "B": 0.0}
    for phase, start, end in stats["events"]:
        ms[phase] += start.elapsed_time(end)
    return ms


# -- the sending threads' workspaces ---------------------------------------------

_ws_lock = threading.Lock()
_ws_held = {"host": 0, "device": 0, "peak_host": 0, "peak_device": 0,
            "one_off": 0}


class _Workspace:
    """The buffers of one sending thread's ranges on one device: pinned
    host buffers for the upload and the download, and the device scratch
    of the prep and the kernels. It goes from thread to thread with the
    stream it is used on (`StreamPool.workspace`), so it is used only on
    that stream, one range at a time, and a range takes it only after the
    stream's previous range synchronised (`pending`: after a range that
    raised part way, the next one synchronises first): reuse needs no
    events.

    A buffer grows to the next power of two of elements at least what a
    range needs, and stays; a range takes views of its first elements.
    Growth is held under PINNED_CAP and DEVICE_CAP summed over all
    workspaces; `arrays` returns None past a cap. A one-off workspace
    (`counted=False`) takes exact sizes, pageable host memory, and counts
    toward no cap."""

    def __init__(self, device, counted: bool = True):
        self.device = torch.device(device)
        self.counted = counted
        self.pending = False
        self._bufs: dict = {}
        self._epoch = 0

    def prep_epoch(self) -> int:
        """The next epoch of the prep on this workspace, 1 .. PREP_EPOCHS
        - 1: no ready flag or status word holds it from an earlier launch
        (they are zeroed when made, and again when the count wraps)."""
        self._epoch += 1
        if self._epoch >= PREP_EPOCHS:
            for name in ("ready", "status"):
                self._bufs[name].zero_()
            self._epoch = 1
        return self._epoch

    def _take(self, need: dict) -> dict | None:
        """Views of `need` ({name: (dtype, count, on the host)}) after
        growing what is short; None, growing nothing, past a cap."""
        grow = {}
        for name, (dtype, count, host) in need.items():
            t = self._bufs.get(name)
            if t is None or t.numel() < count:
                size = (max(count, 1) if not self.counted
                        else 1 << max(0, count - 1).bit_length())
                grow[name] = (dtype, size, host)
        if grow:
            if not self.counted:
                self._grow(grow)
            else:
                with _ws_lock:
                    delta = {"host": 0, "device": 0}
                    for name, (dtype, size, host) in grow.items():
                        old = self._bufs.get(name)
                        delta["host" if host else "device"] += (
                            size * dtype.itemsize
                            - (0 if old is None else old.nbytes))
                    if (_ws_held["host"] + delta["host"] > PINNED_CAP
                            or _ws_held["device"] + delta["device"]
                            > DEVICE_CAP):
                        return None
                    self._grow(grow)
                    for key, d in delta.items():
                        _ws_held[key] += d
                        _ws_held[f"peak_{key}"] = max(_ws_held[f"peak_{key}"],
                                                      _ws_held[key])
        return {name: self._bufs[name][:count]
                for name, (_, count, _) in need.items()}

    def _grow(self, grow: dict) -> None:
        pinned = self.counted and self.device.type == "cuda"
        for name, (dtype, size, host) in grow.items():
            self._bufs.pop(name, None)
            t = torch.empty(size, dtype=dtype,
                            device="cpu" if host else self.device,
                            pin_memory=host and pinned)
            if name == "offsets":
                t[:1].zero_()  # the windows' cumsum writes offsets[1:]
            elif name in ("ready", "status", "gcount"):
                t.zero_()  # the prep's tickets, flags and status words
            self._bufs[name] = t

    def arrays(self, n: int, precision: str, analyze: bool,
               parts=PARTS):
        """The views of one range of n points, as a namespace, or None
        past a cap. This is the one list of the range path's buffers; each
        of `parts` adds its group, and a name of a group left out is None:
        "host": up (3n,) float64 and up_ana (n,) uint8, down (n,) uint8,
        head_host (2 + nb,) int64; "upload": pos and ana, their copies on
        the device; "prep": planes (3, n), box, ptr, bj (at the gate's
        capacity), head (gate flag, n_cross, the nb per-block close
        totals), gbox and gcount (the two-launch prep's group boxes and
        tickets), ready and status (the prep's ticket, the one-launch prep's
        flags, and the look-back's status words); the last three zeroed
        when made;
        "k2": counts, blocked, flags, tickets, state,
        out and offsets."""
        nb = -(-n // BLOCK)
        f64, i64, i32, u8 = torch.float64, torch.int64, torch.int32, \
            torch.uint8
        dtype = f64 if precision == "f64" else torch.float32
        planes = f"planes_{precision}"
        groups = {
            "host": {"up": (f64, 3 * n, True), "down": (u8, n, True),
                     "head_host": (i64, 2 + nb, True),
                     "up_ana": (u8, n, True)},
            "upload": {"pos": (f64, 3 * n, False), "ana": (u8, n, False)},
            "prep": {planes: (dtype, 3 * n, False),
                     "box": (f64, 6 * nb, False),
                     "ptr": (i32, nb + 1, False),
                     "bj": (i32, gate_capacity(nb), False),
                     "head": (i64, 2 + nb, False),
                     "gbox": (f64, 6 * prep_groups(nb), False),
                     "gcount": (i32, prep_groups(nb), False),
                     "ready": (i32, 1 + nb, False),
                     "status": (i64, nb, False)},
            "k2": {"counts": (i32, nb * BLOCK, False),
                   "blocked": (u8, nb * BLOCK, False),
                   "flags": (i32, nb, False), "tickets": (i32, nb, False),
                   "state": (u8, n, False), "out": (u8, n, False),
                   "offsets": (i64, nb * BLOCK + 1, False)}}
        need = {name: spec for part in parts
                for name, spec in groups[part].items()
                if analyze or name not in ("up_ana", "ana")}
        views = self._take(need)
        if views is None:
            return None
        if planes in views:
            views[planes] = views[planes].view(3, n)
        names = {name: None for group in groups.values() for name in group
                 if name != planes}
        names["planes"] = views.pop(planes, None)
        return SimpleNamespace(**{**names, **views}, ws=self)

    def idx(self, entries: int) -> torch.Tensor | None:
        """The close-list buffer of `entries` int32, or None past the
        device cap."""
        views = self._take({"idx": (torch.int32, entries, False)})
        return None if views is None else views["idx"]


def workspace_stats() -> dict:
    """The workspaces' memory: bytes held now (host: pinned on the card)
    and their peaks, summed over all workspaces of the process; the ranges
    that ran on one-off buffers; workspaces made in the stream pool."""
    with _ws_lock:
        out = dict(_ws_held)
    out["made"] = _pool.workspaces_made()
    return out


def own_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A CUDA stream on `device` made outside PyTorch's pool
    (`poisson_stream_create` in csrc/poisson.cu, non-blocking). The pool
    hands out 32 streams per device in turn, so past 32 sending threads it
    would give two threads one stream; each call here makes a new one.

    The stream lives for the process: it is never destroyed, so its handle
    never names another stream, and a trace that names a range's stream by
    its handle names one stream. `StreamPool` hands it from thread to
    thread."""
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


class StreamPool:
    """The streams of `own_stream`, handed to the sending threads: a free
    list per device, behind a lock. A thread takes a stream at its first
    range on a device and holds it until it ends; a new stream is made only
    when the device's free list is empty once the streams of every thread
    that has ended are back in it, so the streams made never exceed the
    peak number of threads holding one at once. The engine makes a new
    thread pool per batch and per reconstructed level, and its threads
    come and go; the streams stay with the pools' width, not with the
    number of threads that ever sent a range.

    A thread's streams come back when its locals are cleared as it ends
    (`_ThreadStreams.__del__`), or, should that come after the next thread
    asks (CPython may clear them after `join()` has returned), when `take`
    finds the free list empty and the thread no longer alive.

    A stream goes back with its thread's last work possibly still queued
    on it. That is safe: the next holder's work on the stream runs after
    it, in stream order, and the thread synchronised the stream before it
    read any result.

    Each stream has one workspace (`workspace`), made at its first range
    and handed on with it: the workspaces made never exceed the streams
    made."""

    def __init__(self):
        self._lock = threading.RLock()  # __del__ may give back inside take
        self._free: dict = {}  # device -> [stream]
        # id -> the _ThreadStreams holding streams, held weakly: a holder
        # dies with its thread's locals, and its __del__ gives them back
        self._holders = weakref.WeakValueDictionary()
        self._workspaces: dict = {}  # stream -> _Workspace
        self.made = 0
        self.peak_held = 0

    def _held(self) -> int:
        return sum(len(h.streams) for h in self._holders.values())

    def _give(self, holder) -> None:
        with self._lock:
            for device, stream in holder.streams.items():
                self._free.setdefault(device, []).append(stream)
            holder.streams = {}
            self._holders.pop(id(holder), None)

    def take(self, holder, device: torch.device):
        """A stream on `device` for `holder`'s thread, recorded in it."""
        with self._lock:
            free = self._free.setdefault(device, [])
            if not free:
                for h in list(self._holders.values()):
                    if not h.thread.is_alive():
                        self._give(h)
            stream = free.pop() if free else None
            if stream is None:
                self.made += 1
        if stream is None:
            try:
                stream = own_stream(device)
            except BaseException:
                with self._lock:
                    self.made -= 1
                raise
        with self._lock:
            holder.streams[device] = stream
            self._holders[id(holder)] = holder
            self.peak_held = max(self.peak_held, self._held())
        return stream

    def stats(self) -> dict:
        with self._lock:
            return {"made": self.made, "held": self._held(),
                    "peak_held": self.peak_held,
                    "free": sum(map(len, self._free.values()))}

    def workspace(self, stream) -> _Workspace:
        """The workspace that goes with `stream` (made at its first ask)."""
        with self._lock:
            ws = self._workspaces.get(stream)
            if ws is None:
                ws = self._workspaces[stream] = _Workspace(stream.device)
            return ws

    def workspaces_made(self) -> int:
        with self._lock:
            return len(self._workspaces)


class _ThreadStreams:
    """One thread's streams, by device, held in the thread's locals; they
    go back to the pool when the thread's locals are cleared."""

    def __init__(self, pool: StreamPool, thread: threading.Thread):
        self.pool, self.thread = pool, thread
        self.streams: dict = {}

    def __del__(self):
        self.pool._give(self)


_pool = StreamPool()
_tls = threading.local()


def stream_stats() -> dict:
    """The stream pool's counts: streams made in this process, streams held
    by threads now, the peak of those, and streams free."""
    return _pool.stats()


def thread_stream(device: torch.device | str) -> torch.cuda.ExternalStream:
    """The calling thread's CUDA stream on `device`, taken from the
    `StreamPool` at the thread's first call on that device and kept for its
    later calls, on that device and beside the streams it holds on others:
    ranges sent from several worker threads run on the card at once, and
    no two threads alive at once share a stream. `cuda` with no index means
    the current device."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"thread_stream needs a CUDA device, got {device}")
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    mine = getattr(_tls, "streams", None)
    if mine is None:
        mine = _tls.streams = _ThreadStreams(_pool,
                                             threading.current_thread())
    stream = mine.streams.get(device)
    if stream is None:
        stream = mine.pool.take(mine, device)
    return stream


def stream_sharing_faults(records: list) -> list:
    """What a `trace` shows against the rule that no two threads alive at
    once share a stream: a thread that ran ranges on two streams of one
    device, or a stream on which two threads' spans (first range start to
    last range end; a thread holds its stream at least that long) overlap.
    Returns one message per fault."""
    faults = []
    per_thread: dict = {}
    spans: dict = {}
    for r in records:
        per_thread.setdefault((r["thread"], r["device"]), set()).add(
            r["stream"])
        span = spans.setdefault(r["stream"], {}).setdefault(
            r["thread"], [r["t0"], r["t1"]])
        span[0], span[1] = min(span[0], r["t0"]), max(span[1], r["t1"])
    for (thread, device), streams in sorted(per_thread.items()):
        if len(streams) > 1:
            faults.append(f"thread {thread} ran ranges on {len(streams)} "
                          f"streams of {device}")
    for stream, by_thread in spans.items():
        ordered = sorted(by_thread.items(), key=lambda kv: kv[1][0])
        for (ta, (_, end)), (tb, (start, _)) in zip(ordered, ordered[1:]):
            if start < end:
                faults.append(f"threads {ta} and {tb} held stream "
                              f"{stream:#x} at once")
    return faults


def peak_live_senders(records: list) -> int:
    """A lower bound, from a `trace`, on the sending threads alive at once:
    a thread is alive from its first range's start to its pool's last
    range's end (a ThreadPoolExecutor's workers, `<pool>_<k>`, live until
    the pool shuts down, after its last range), the main thread to the end
    of the process, and any other thread to its own last range's end."""
    first, pool_of, end = {}, {}, {}
    for r in records:
        t = r["thread"]
        first[t] = min(first.get(t, r["t0"]), r["t0"])
        pool = (t.rsplit("_", 1)[0] if t.startswith("ThreadPoolExecutor-")
                else t)
        pool_of[t] = pool
        end[pool] = (math.inf if t == "MainThread"
                     else max(end.get(pool, r["t1"]), r["t1"]))
    # ends before starts at one instant: a lower bound
    events = sorted([(first[t], 1) for t in first]
                    + [(end[pool_of[t]], -1) for t in first])
    alive = peak = 0
    for _, step in events:
        alive += step
        peak = max(peak, alive)
    return peak


def range_mask_cuda(positions: np.ndarray, spacing: float,
                    analyze_mask: np.ndarray | None = None,
                    precision: str = "f64",
                    device: torch.device | str = "cuda") -> np.ndarray | None:
    """Accept mask of one Morton-sorted range on the card, on the calling
    thread's stream and its workspace: one upload from the pinned buffer,
    the prep kernels, phase A's counting pass, one synchronise that reads
    the pair gate and the per-block close totals (None past the gate), the
    windows of phase A's fill and phase B, one download into the pinned
    buffer, the final synchronise. Synchronises only that stream. Returns
    a numpy bool array.

    With `trace` set, the range's record holds, for each part (upload: the
    copy to the card; prep: the prep kernels; kernel: phase A through
    phase B, the synchronise between included; download: the copy back),
    its stream time from CUDA events (`*_ms`), the calling thread's wall
    time enqueueing it, synchronises inside the part included
    (`host_*_ms`), and that thread's CPU time over the same span
    (`cpu_*_ms`); `wait_ms` is the wall time of the final synchronise;
    `t0` and `t1` are the range's start and the end of that synchronise on
    the host's clock (`time.perf_counter`); `prep_launches` the prep's
    kernels launched for the range. With `trace` unset, no CUDA
    event is recorded."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"range_mask_cuda needs a CUDA device, got {device}")
    n = positions.shape[0]
    if n == 0 or spacing <= 0:
        return None
    stream = thread_stream(device)
    ws = _pool.workspace(stream)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        return _range_mask(ws, positions, spacing, analyze_mask, precision,
                           stream)


def _range_mask(ws: _Workspace, positions: np.ndarray, spacing: float,
                analyze_mask: np.ndarray | None, precision: str,
                stream=None) -> np.ndarray | None:
    """`range_mask_cuda`'s path on `ws`'s device, on the current stream
    (`stream`, synchronised where the path waits; on the CPU the kernels'
    plain versions run and nothing waits)."""
    n = positions.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"a range holds at most 2^31 - 1 points, got {n}")
    nb = -(-n // BLOCK)

    def sync():
        if stream is not None:
            stream.synchronize()

    home = ws
    if home.pending:  # a range before this one raised part way
        sync()
        home.pending = False
    analyze = analyze_mask is not None
    buf = ws.arrays(n, precision, analyze)
    one_off = buf is None
    if one_off:
        with _ws_lock:
            _ws_held["one_off"] += 1
        ws = _Workspace(home.device, counted=False)
        buf = ws.arrays(n, precision, analyze)
    records = trace
    marks = []

    def mark():
        if records is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((e, time.perf_counter(), time.thread_time()))

    fns = _kernel_fns(precision) if ws.device.type == "cuda" else None
    pinned = fns if ws.counted else None  # the copies' entry points
    mark()
    np.copyto(buf.up.numpy().reshape(n, 3), positions)
    if analyze:
        np.copyto(buf.up_ana.numpy(), analyze_mask)
    home.pending = True
    _copy(pinned, buf.pos, buf.up)
    if analyze:
        _copy(pinned, buf.ana, buf.up_ana)
    mark()
    prep_launched = _prep(buf.pos, buf.ana, n, nb, spacing, precision, buf)
    mark()
    sq = squared_spacing(spacing, precision)
    # phase A's counting pass: past the gate it returns at once on the card
    _close_count(fns, buf.planes, n, sq, buf.ptr, buf.bj, 0, nb, buf.counts,
                 gate=buf.head)
    torch.sum(buf.counts.view(nb, BLOCK), dim=1, dtype=torch.int64,
              out=buf.head[2:])
    _copy(pinned, buf.head_host, buf.head)
    sync()
    head = buf.head_host.numpy()
    if head[0]:
        home.pending = False
        return None
    events = [] if records is not None else None

    def take_idx(entries):
        idx = ws.idx(entries)
        if idx is None:
            with _ws_lock:
                _ws_held["one_off"] += 1
            idx = torch.empty(entries, dtype=torch.int32, device=ws.device)
        return idx

    windows, _ = _run_windows(fns, buf.planes, n, sq, buf.ptr, buf.bj,
                              head[2:], CLOSE_BUDGET, buf, take_idx, events,
                              marks[-1][0] if marks else None)
    mark()
    _copy(pinned, buf.down, buf.out)
    mark()
    sync()
    home.pending = False
    synced = time.perf_counter()
    if records is not None:
        record = {"n": n, "stream": getattr(stream, "cuda_stream", None),
                  "device": str(ws.device),
                  "thread": threading.current_thread().name,
                  "t0": marks[0][1], "t1": synced,
                  "windows": len(windows), "one_off": one_off,
                  "prep_launches": prep_launched,
                  **phase_ms({"events": events}),
                  "wait_ms": (synced - marks[-1][1]) * 1e3}
        for part, (a, b) in zip(("upload", "prep", "kernel", "download"),
                                zip(marks, marks[1:])):
            record[f"{part}_ms"] = a[0].elapsed_time(b[0])
            record[f"host_{part}_ms"] = (b[1] - a[1]) * 1e3
            record[f"cpu_{part}_ms"] = (b[2] - a[2]) * 1e3
        with _lock:
            records.append(record)
    return buf.down.numpy().view(bool).copy()


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

"""MIN_DISTANCE (Poisson-disk) accept mask on the card: host prep, the
binding of the CUDA kernel (csrc/poisson.cu), and its plain-torch version.

This is the counterpart of schwarzwald_tpu/ops/poisson_pallas.py. Semantics
(the reference's greedy pass, PoissonDiskSampling::sample_points,
Sampling.h:444-465): walk the Morton-sorted range in order and accept a
point iff it is analyzed and no previously ACCEPTED point lies at
d2 < spacing^2, d2 = (dx*dx + dy*dy) + dz*dz.

Block-sequential formulation, shared by the kernel and the plain version:
the range is cut into blocks of `block` consecutive points; the host lists,
for every block bi, the earlier blocks bj < bi whose AABB meets bi's AABB
inflated by the spacing (`prep`, CSR pair_ptr / pair_bj, built in row
chunks so host memory stays bounded at any range size). Blocks are then
decided in ascending order: a cross step against the final accept flags of
the listed blocks, and an intra step (earliest-undecided relaxation over
the block's strict-lower close matrix). The mask does not depend on the
block size.

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
  * kernel / plain: the range ran on the CUDA kernel (a CUDA tensor) or on
    the plain-torch version (a CPU tensor).
`launches` counts kernel launches; the wrapper adds one where it launches
and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

BLOCK = 512                 # the kernel's block size (csrc/poisson.cu)
MAX_PAIRS_PER_BLOCK = 96    # pair-list gate (poisson_pallas.py:59)
DEVICE_FLOOR = 4096         # smallest range sent to the device

_lock = threading.Lock()
launches = 0
counters = {"below_floor": 0, "pair_gate": 0, "kernel": 0, "plain": 0}


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
    # inflate by spacing (+1e-4 relative): the close test's rounding (the
    # float32 spacing product, float32 d2 in the f32 mode) can admit pairs
    # a hair beyond the true spacing, and the prune must never be tighter
    # than the close test
    s = float(np.float32(spacing)) * (1.0 + 1e-4)
    csr = _pair_csr(mins, maxs, s, MAX_PAIRS_PER_BLOCK * n_blocks)
    if csr is None:
        return None
    analyze = (None if analyze_mask is None
               else np.ascontiguousarray(analyze_mask, dtype=np.uint8))
    return Prep(np.ascontiguousarray(pos.T), analyze,
                squared_spacing(spacing, precision), csr[0], csr[1], block)


# -- the CUDA kernel -----------------------------------------------------------

_c_fns: dict = {}


def _kernel_fn(precision: str):
    """ctypes entry point of csrc/poisson.cu for the mode (built and
    loaded at first use)."""
    fn = _c_fns.get(precision)
    if fn is not None:
        return fn
    from ._cuda_build import load_kernel_library

    lib = load_kernel_library("poisson")
    lib.poisson_block_size.argtypes = []
    lib.poisson_block_size.restype = ctypes.c_int
    if lib.poisson_block_size() != BLOCK:
        raise RuntimeError("csrc/poisson.cu BLOCK disagrees with "
                           "ops/poisson_cuda.BLOCK")
    scalar = ctypes.c_double if precision == "f64" else ctypes.c_float
    fn = getattr(lib, f"poisson_accept_mask_{precision}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   scalar, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _c_fns[precision] = fn
    return fn


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


def accept_mask_cuda(planes: torch.Tensor, analyze: torch.Tensor | None,
                     sq: float, pair_ptr: torch.Tensor,
                     pair_bj: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (one CTA walks the range on the
    current stream). Returns the (n,) uint8 accept mask on the card."""
    device = planes.device
    if device.type != "cuda":
        raise ValueError(f"accept_mask_cuda needs CUDA tensors, got {device}")
    precision = {torch.float64: "f64", torch.float32: "f32"}.get(planes.dtype)
    if precision is None:
        raise TypeError(f"planes must be float64 or float32, "
                        f"got {planes.dtype}")
    n = planes.shape[-1]
    n_blocks = -(-n // BLOCK)
    _check(planes, "planes", planes.dtype, (3, n), device)
    if analyze is not None:
        _check(analyze, "analyze", torch.uint8, (n,), device)
    _check(pair_ptr, "pair_ptr", torch.int32, (n_blocks + 1,), device)
    _check(pair_bj, "pair_bj", torch.int32, (pair_bj.shape[0],), device)
    fn = _kernel_fn(precision)
    out = torch.empty(n, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.c_void_p(planes.data_ptr()),
                 None if analyze is None
                 else ctypes.c_void_p(analyze.data_ptr()),
                 n, sq, ctypes.c_void_p(pair_ptr.data_ptr()),
                 ctypes.c_void_p(pair_bj.data_ptr()), n_blocks,
                 ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"poisson kernel launch failed: CUDA error {err}")
    global launches
    with _lock:
        launches += 1
    return out


# -- the plain-torch version ---------------------------------------------------

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
    """The kernel's algorithm in torch ops, on whatever device the tensors
    are on: per block, the cross step as (close & accepted_j).any(1) and
    the intra step as a relaxation loop. Returns the (n,) uint8 mask."""
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
        acc_b = torch.zeros(b, dtype=torch.bool, device=device)
        while bool(und.any()):
            acc_hit = (close & acc_b[None, :]).any(dim=1)
            und_hit = (close & und[None, :]).any(dim=1)
            newly_acc = und & ~acc_hit & ~und_hit
            acc_b |= newly_acc
            und &= ~(acc_hit | newly_acc)
        acc[lo:hi] = acc_b
    return acc.to(torch.uint8)


def accept_mask(p: Prep, device: torch.device | str) -> np.ndarray:
    """Accept mask of a prepped range on `device`: a CUDA device launches
    the kernel (and raises if it cannot), the CPU runs the plain version.
    Returns a numpy bool array."""
    device = torch.device(device)
    planes = torch.from_numpy(p.planes).to(device)
    analyze = (None if p.analyze is None
               else torch.from_numpy(p.analyze).to(device))
    pair_ptr = torch.from_numpy(p.pair_ptr).to(device)
    pair_bj = torch.from_numpy(p.pair_bj).to(device)
    if device.type == "cuda":
        if p.block != BLOCK:
            raise ValueError(f"the kernel's block is {BLOCK}, got {p.block}")
        count("kernel")
        out = accept_mask_cuda(planes, analyze, p.sq, pair_ptr, pair_bj)
    elif device.type == "cpu":
        count("plain")
        out = accept_mask_torch(planes, analyze, p.sq, pair_ptr, pair_bj,
                                p.block)
    else:
        raise ValueError(f"no Poisson kernel for device {device}")
    return out.cpu().numpy().view(bool)

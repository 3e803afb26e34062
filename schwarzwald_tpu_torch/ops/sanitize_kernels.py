"""K1, K2, K2's prep and X2 through the port's entry points on the card,
each against its plain version: the program that compute-sanitizer runs
over the kernels.

    python -m schwarzwald_tpu_torch.ops.sanitize_kernels [--cases a,b,...]
        [--sweep-cases a,b,...] [--k1-points N] [--threads T] [--poison]
        [--self-check]

The prep kernels (`poisson_cuda.range_prep`) on each named case of
`poisson_cases` in both precision modes against `prep_torch`, and K2
(`poisson_cuda.accept_mask_cuda`) on the same against `accept_mask_torch`;
one case sent by `range_mask_cuda` (the prep and K2 on the sending
thread's workspace) from T threads at once, each on its own stream,
against the same plain mask; the pair gate exactly at and one past its
capacity (`gate_cases`): the prep kernels against `prep_torch` with a
guard region after pair_bj that no write may reach, and each range sent
through the engine's entry point, which the host kernel takes past the
gate; X2 (`device_tiling.octree_select_grid_cuda`) on each case of
`sweep_cases` under each grid sampler against `octree_select_grid_torch`,
with a guard after `out` that no write may reach; K1
(`morton_cuda.interleave_cuda`) on N coordinates with the one-hot edge
rows against `interleave21`. Results must be equal exactly; the exit code is 0 when every check held and 1
otherwise. `--poison` fills every `torch.empty` of the kernels' wrappers
(the workspaces' buffers too) with NaN or the type's largest value
(`torch.utils.deterministic.fill_uninitialized_memory`), so that a kernel
reading a slot nothing wrote changes its result; the plain versions run
unpoisoned, outside PyTorch's deterministic mode. `--self-check` launches
K1 once on 1,000 points: what a sanitizer is first run on, to learn
whether it supports the card.

chip_smoke.py (phase 8) runs this under `compute-sanitizer --tool
memcheck|racecheck|synccheck|initcheck`, restricted to the kernels
`interleave_kernel`, `close_kernel`, `decide_kernel`, `prep_one_kernel`,
`prep_blocks_kernel`, `prep_rows_kernel`, `prep_pairs_kernel` and X2's
`sweep_kernel`;
`poisson_cases` and `sweep_cases` here also give its phase 2 its inputs.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import contextlib
import sys
import time

import numpy as np
import torch

ROOT_POINTS = 5_490_148         # the 10M main path's root range
ROOT_CASE = f"root_{ROOT_POINTS}"
DENSE_POINTS = 92_160           # 180 blocks at the pair gate's edge
THREADS_CASE = "uniform_262144"
# the prep's launch choice at its edges: 1 block, and PREP_ONE_LAUNCH - 1,
# PREP_ONE_LAUNCH (one launch) and PREP_ONE_LAUNCH + 1 blocks (two); its
# second launch's at PREP_GROUPED_FROM - 1 (a CTA a row) and
# PREP_GROUPED_FROM blocks (tiles of rows, group boxes)
EDGE_CASES = ("uniform_300", "analyze3_261532", "edge_262144",
              "uniform_262145", "uniform_1637888", "uniform_1637889")
SANITIZED_CASES = ("uniform_4096", "uniform_262144", f"dense_{DENSE_POINTS}",
                   "clustered_192000", "duplicates_262144", "analyze3_262144",
                   *EDGE_CASES)
K1_POINTS = 10_000_001
POISON = False  # set by --poison: the kernels run under `poisoned()`


@contextlib.contextmanager
def poisoned():
    """While POISON is set, every torch.empty inside is filled with NaN or
    its type's largest value (PyTorch does so in deterministic mode)."""
    if not POISON:
        yield
        return
    from torch.utils import deterministic

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           deterministic.fill_uninitialized_memory)
    deterministic.fill_uninitialized_memory = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        deterministic.fill_uninitialized_memory = was[2]


def sorted_range(pos, extent):
    """Clamp, Morton-encode and sort a cloud with the port's indexing."""
    from . import indexing

    keys, clamped = indexing.index_points(pos, np.zeros(3),
                                          np.full(3, extent))
    _, order = indexing.sort_with_keys(keys)
    return clamped[order]


def poisson_cases(names=None) -> list:
    """(name, sorted positions, spacing, analyze mask, extent, precision
    modes) of the named K2 cases (all when None), drawn in one order from
    one seed, so a case's points do not depend on which others are asked
    for. The root-shaped range is the 10M main path's largest (the root's
    5,490,148 points at the root spacing, 1000 * sqrt(3) / 250); the dense
    range sits at the pair gate's edge (87.5 pairs per block, 1.8e9 close
    pairs), so the kernels run window by window. EDGE_CASES sit at the
    prep's choice between one launch and two, and between its second
    launch's two kernels."""
    rng = np.random.default_rng(20260816)
    ext = 64.0
    both = ("f64", "f32")
    drawn = []  # (name, unsorted positions, extent, spacing, edit, modes)
    for n in (4096, 262_144, 1_500_000):
        drawn.append((f"uniform_{n}", rng.uniform(0.0, ext, (n, 3)), ext,
                      2.0, None, both))
    centers = rng.uniform(4.0, ext - 4.0, (64, 3))
    pos = np.concatenate([c + rng.normal(0.0, 0.8, (3000, 3))
                          for c in centers])
    drawn.append(("clustered_192000", np.clip(pos, 0.0, ext - 1e-9), ext,
                  0.6, None, both))
    drawn.append(("duplicates_262144", rng.uniform(0.0, ext, (262_144, 3)),
                  ext, 1.0, "duplicates", both))
    drawn.append(("analyze3_262144", rng.uniform(0.0, ext, (262_144, 3)),
                  ext, 2.0, "analyze3", both))
    drawn.append((f"dense_{DENSE_POINTS}",
                  rng.uniform(0.0, 10.0, (DENSE_POINTS, 3)), 10.0, 6.0, None,
                  both))
    drawn.append((ROOT_CASE, rng.uniform(0.0, 1000.0, (ROOT_POINTS, 3)),
                  1000.0, 1000.0 * 3 ** 0.5 / 250, None, ("f64",)))
    for name in EDGE_CASES:
        n = int(name.rsplit("_", 1)[1])
        drawn.append((name, rng.uniform(0.0, ext, (n, 3)), ext, 2.0,
                      "analyze3" if name.startswith("analyze3") else None,
                      both))
    cases = []
    for name, raw, extent, spacing, edit, modes in drawn:
        if names is not None and name not in names:
            continue
        pos = sorted_range(raw, extent)
        analyze = None
        if edit == "duplicates":
            pos[5000:6000] = pos[4999]  # a run of exact duplicates
        elif edit == "analyze3":
            analyze = np.zeros(pos.shape[0], dtype=bool)
            analyze[::3] = True
        cases.append((name, pos, spacing, analyze, extent, modes))
    return cases


GATE_CASES = ("gate_at_limit", "gate_one_past", "gate_at_limit_684",
              "gate_one_past_544", "gate_at_limit_3674",
              "gate_one_past_3339")
GUARD = 4096  # int32 entries after pair_bj's capacity that must stay


def ball_blocks(k: int, far: int = 0, seed: int = 3) -> np.ndarray:
    """k blocks of points inside one spacing ball (every pair of them
    meets at a spacing of 5), then `far` blocks each far from everything:
    k (k - 1) / 2 cross pairs over k + far blocks."""
    from .poisson_cuda import BLOCK

    rng = np.random.default_rng(seed)
    pos = [rng.uniform(0.0, 0.01, (k * BLOCK, 3))]
    for f in range(far):
        pos.append(rng.uniform(0.0, 0.01, (BLOCK, 3)) + 1000.0 * (f + 1))
    return np.concatenate(pos)


def gate_cases() -> list:
    """(name, positions, spacing) of a range exactly at the pair gate (191
    blocks: 191 * 190 / 2 = 95 * 191 cross pairs, `gate_capacity(191)`)
    and one one past it (192 + 1 blocks: 192 * 191 / 2 = 95 * 193 + 1),
    both in the prep's one launch; the same in its two launches with a CTA
    a row (361 + 323 blocks: 361 * 360 / 2 = 95 * 684; 322 + 222 blocks:
    322 * 321 / 2 = 95 * 544 + 1) and with group boxes (836 + 2,838
    blocks: 836 * 835 / 2 = 95 * 3,674; 797 + 2,542 blocks: 797 * 796 / 2
    = 95 * 3,339 + 1)."""
    return [("gate_at_limit", ball_blocks(191), 5.0),
            ("gate_one_past", ball_blocks(192, far=1), 5.0),
            ("gate_at_limit_684", ball_blocks(361, far=323), 5.0),
            ("gate_one_past_544", ball_blocks(322, far=222), 5.0),
            ("gate_at_limit_3674", ball_blocks(836, far=2838), 5.0),
            ("gate_one_past_3339", ball_blocks(797, far=2542), 5.0)]


def guarded_prep(pos: np.ndarray, spacing: float, precision: str,
                 device) -> tuple:
    """The prep kernels on one range into one-off buffers of a workspace,
    as the range path runs them, with pair_bj's capacity followed by GUARD
    entries of -7: ((planes, pair_ptr, pair_bj, head), whether every guard
    entry is still -7)."""
    from . import poisson_cuda

    n = pos.shape[0]
    nb = -(-n // poisson_cuda.BLOCK)
    cap = poisson_cuda.gate_capacity(nb)
    p = torch.from_numpy(pos).to(device)
    buf = poisson_cuda._Workspace(device, counted=False).arrays(
        n, precision, False, ("prep", "k2"))
    guarded = torch.full((cap + GUARD,), -7, dtype=torch.int32,
                         device=device)
    buf.bj = guarded[:cap]
    with torch.cuda.device(device):
        poisson_cuda._prep(p.view(-1), None, n, nb, spacing, precision, buf)
        torch.cuda.synchronize(device)
    return ((buf.planes, buf.ptr, buf.bj, buf.head[:2]),
            bool((guarded[cap:] == -7).all()))


def check_gate(case, precision: str, device, send: bool = True) -> str:
    """A range at or one past the pair gate: the prep kernels (poisoned
    buffers) against `prep_torch`, the guard after pair_bj intact; in f64
    the range sent through `device_poisson` as the engine sends it: past
    the gate None (the host kernel takes it), `pair_gate` counted and one
    K2 launch (the counting pass, which returns at once on the card); at
    the gate the plain mask, in three launches a window (not for the
    two-launch cases at the gate: their 1.7e10 close pairs and more are
    K2's work, not the prep's). `send` False: the prep alone."""
    from . import device_poisson, poisson_cuda

    name, pos, spacing = case
    want = poisson_cuda.prep_torch(torch.from_numpy(pos).to(device), None,
                                   spacing, precision)
    with poisoned():
        got, guard_kept = guarded_prep(pos, spacing, precision, device)
    bad = prep_mismatch(got, want)
    if bad or not guard_kept:
        raise RuntimeError(f"prep {name} {precision}: "
                           f"{bad or 'a write past pair_bj capacity'}")
    gate, n_cross = want[3].tolist()
    line = f"prep {name} {precision}: n_cross={n_cross} gate={gate}, " \
           f"equal to the plain version, nothing written past the capacity"
    if not send or precision != "f64" or name.startswith("gate_at_limit_"):
        return line
    before = poisson_cuda.snapshot()
    with poisoned():
        mask = device_poisson.poisson_accept_mask_device(
            None, pos, 0.0, spacing, None, backend="cuda")
    after = poisson_cuda.snapshot()
    counted = {k: after[k] - before[k] for k in ("launches", "pair_gate",
                                                  "kernel")}
    if gate:
        if mask is not None or counted != {"launches": 1, "pair_gate": 1,
                                           "kernel": 0}:
            raise RuntimeError(f"K2 {name}: past the gate the range gave "
                               f"{'no mask' if mask is None else 'a mask'}"
                               f" and counted {counted}")
        return f"{line}; K2 {name}: to the host kernel, counted {counted}"
    _, _, plain = plain_mask(pos, spacing, None, "f64", device)
    launches = counted.pop("launches")
    if mask is None or not np.array_equal(mask, plain.cpu().numpy().view(
            bool)) or counted != {"pair_gate": 0, "kernel": 1} or (
            launches < 3 or launches % 3):
        raise RuntimeError(f"K2 {name}: at the gate the range's mask is not "
                           f"the plain one, or it counted {counted} and "
                           f"{launches} launches")
    counted["launches"] = launches  # 3 a window of close lists
    return f"{line}; K2 {name}: the plain mask, counted {counted}"


SWEEP_SAMPLERS = ("RANDOM_GRID", "GRID_CENTER", "JITTERED")
SWEEP_GROUP_POINTS = 4_000_000  # the engine's sweep group (FAST pipeline)
SWEEP_GUARD = 4096  # int8 entries after `out` that must stay


def sweep_cases(names=None) -> list:
    """(name, sorted uint64 keys, positions in key order, extent, spacing,
    max_points, max_depth, min_node_level) of the named X2 cases (all when
    None), drawn in one order from one seed:
      * clustered_4M at min_node_level -1 and 2: a sweep group of the main
        path's size, 250 Gaussian clusters as chip_smoke.py's phase 5
        cloud, at the defaults (spacing = diagonal / 250, 20,000 points a
        node);
      * single_1: one point;
      * equal_5000: every key equal (one position);
      * mirrored_ties: pairs of points mirrored about the centres of cells
        of depths 2-10, on dyadic coordinates, so their distances tie
        exactly;
      * block_edges_70001: uniform, n not a multiple of a warp or a block,
        cells straddling the kernel's blocks;
      * reroot_3000: a 1e-4-wide cluster at a spacing whose candidate
        grids pass the 21 Morton levels, so the plan stops and leaves
        points at 0;
      * above_n_3000: max_points above n."""
    from . import indexing

    rng = np.random.default_rng(20261017)
    drawn = []  # (name, positions, extent, spacing, max_points, min level)
    k = 250
    centers = rng.uniform(50.0, 950.0, (k, 3))
    sigmas = rng.uniform(2.0, 25.0, k)
    pos = rng.normal(0.0, 1.0, (SWEEP_GROUP_POINTS, 3))
    pos *= np.repeat(sigmas, SWEEP_GROUP_POINTS // k)[:, None]
    pos += np.repeat(centers, SWEEP_GROUP_POINTS // k, axis=0)
    np.clip(pos, 1.0, 999.0, out=pos)
    for minlv in (-1, 2):
        drawn.append((f"clustered_4M_level{minlv}", pos, 1000.0,
                      1000.0 * 3 ** 0.5 / 250, 20_000, minlv))
    drawn.append(("single_1", rng.uniform(0.0, 64.0, (1, 3)), 64.0, 2.0,
                  200, -1))
    drawn.append(("equal_5000", np.full((5000, 3), 17.25), 64.0, 2.0, 200,
                  -1))
    pairs = []
    for depth in range(2, 11):
        size = 64.0 / 2 ** depth
        cells = rng.integers(0, 2 ** depth, (40, 3))
        half = rng.integers(1, 64, (40, 3)) * (size / 256)
        centre = (cells + 0.5) * size
        pairs += [centre + half, centre - half]
    drawn.append(("mirrored_ties", np.concatenate(pairs), 64.0, 0.25, 1,
                  -1))
    drawn.append(("block_edges_70001", rng.uniform(0.0, 64.0, (70_001, 3)),
                  64.0, 2.0, 100, -1))
    drawn.append(("reroot_3000",
                  np.array([10.0, 20.0, 30.0]) + rng.uniform(
                      0.0, 1e-4, (3000, 3)), 64.0, 64.0 / 2 ** 18, 100,
                  -1))
    drawn.append(("above_n_3000", rng.uniform(0.0, 64.0, (3000, 3)), 64.0,
                  2.0, 10_000, -1))
    cases = []
    for name, raw, extent, spacing, max_points, minlv in drawn:
        if names is not None and name not in names:
            continue
        keys, clamped = indexing.index_points(raw.copy(), np.zeros(3),
                                              np.full(3, extent))
        order = indexing.sort_by_key(keys)
        cases.append((name, keys[order], np.ascontiguousarray(
            clamped[order]), extent, spacing, max_points, 100, minlv))
    return cases


def sweep_args(case, sampler: str, device) -> tuple:
    """(key, positional arguments after it, keyword arguments) of
    octree_select_grid for one case and sampler on `device`."""
    from . import device_tiling

    _, keys, pos, extent, spacing, max_points, max_depth, minlv = case
    key = device_tiling.keys_tensor(keys, device)
    kw = {"strategy": sampler, "min_node_level": minlv}
    if sampler != "RANDOM_GRID":
        kw.update(positions=torch.from_numpy(pos).to(device),
                  root_min=[0.0] * 3, root_max=[extent] * 3)
    if sampler == "JITTERED":
        kw["jit_cfgs"] = device_tiling.jittered_static_configs(
            extent, spacing, max_depth)
    cands = device_tiling.candidate_levels(extent, spacing, max_depth)
    return key, (cands, max_points, max_depth), kw


def check_sweep(case, sampler: str, device) -> str:
    """X2's kernel (`device_tiling.octree_select_grid_cuda`) against its
    plain version on the card, every int8 level equal; under --poison the
    output and the scratch start as poison, and a guard after `out` must
    stay untouched."""
    from . import device_tiling

    key, args, kw = sweep_args(case, sampler, device)
    n = key.shape[0]
    want = device_tiling.octree_select_grid_torch(key, *args, **kw)
    before = device_tiling.snapshot()["x2_launches"]
    with poisoned():
        guarded = torch.full((n + SWEEP_GUARD,), -7, dtype=torch.int8,
                             device=device)
        if POISON:
            guarded[:n] = 127
        got = device_tiling.octree_select_grid_cuda(key, *args, **kw,
                                                    out=guarded[:n])
        torch.cuda.synchronize(device)
    launches = device_tiling.snapshot()["x2_launches"] - before
    if not torch.equal(got, want):
        bad = torch.nonzero(got != want).flatten()[:5].tolist()
        raise RuntimeError(f"X2 {case[0]} {sampler}: "
                           f"{int((got != want).sum())} levels differ from "
                           f"the plain version (first at {bad})")
    if not bool((guarded[n:] == -7).all()):
        raise RuntimeError(f"X2 {case[0]} {sampler}: a write past out")
    levels = sorted(torch.unique(want).tolist())
    return (f"X2 {case[0]} {sampler}: n={n} launches={launches} levels="
            f"{levels}, equal to the plain version, nothing written past "
            f"out")


def edge_coords(n: int, seed: int):
    """(n,) int32 random 21-bit coordinates per axis whose first rows are
    the one-hot edge rows (each bit alone, 0 and 2^21 - 1 on one axis,
    the other two at 0)."""
    rng = np.random.default_rng(seed)
    axes = [rng.integers(0, 1 << 21, n).astype(np.int32) for _ in range(3)]
    oh = np.array([1 << i for i in range(21)] + [0, (1 << 21) - 1],
                  dtype=np.int32)
    for a in range(3):
        for b in range(3):
            axes[a][b * oh.size:(b + 1) * oh.size] = oh if a == b else 0
    return axes


def check_k1(n: int, device) -> str:
    from . import morton_cuda

    x, y, z = (torch.from_numpy(a).to(device) for a in edge_coords(n, n))
    want = morton_cuda.interleave21(x, y, z)
    with poisoned():
        got = morton_cuda.interleave_cuda(x, y, z)
        torch.cuda.synchronize(device)
    if not torch.equal(got, want):
        raise RuntimeError(f"K1 n={n}: {int((got != want).sum())} keys "
                           f"differ from the plain version")
    return f"K1 n={n}: equal to the plain version"


def plain_mask(pos, spacing, analyze, precision, device) -> tuple:
    """(prep, plain mask on the card) of one range."""
    from . import poisson_cuda

    p = poisson_cuda.prep(pos, spacing, analyze, precision)
    if p is None:
        raise RuntimeError("prep declined the range")
    t = [None if a is None else torch.from_numpy(a).to(device)
         for a in (p.planes, p.analyze, p.pair_ptr, p.pair_bj)]
    return p, t, poisson_cuda.accept_mask_torch(t[0], t[1], p.sq, t[2], t[3])


def prep_mismatch(got, want) -> str | None:
    """What differs between two preps of one range (planes, pair_ptr,
    pair_bj, head as `poisson_cuda.prep_torch` returns them): the planes
    bit for bit (NaN where a point is not analyzed), the head (gate flag,
    n_cross), pair_ptr, and pair_bj's first n_cross entries when the gate
    is open. None when nothing does."""
    bits = {torch.float64: torch.int64, torch.float32: torch.int32}
    if got[0].dtype != want[0].dtype or not torch.equal(
            got[0].view(bits[got[0].dtype]),
            want[0].view(bits[want[0].dtype])):
        return "planes"
    if not torch.equal(got[3], want[3]):
        return f"head {got[3].tolist()} (want {want[3].tolist()})"
    if not torch.equal(got[1], want[1]):
        return "pair_ptr"
    gate, n_cross = want[3].tolist()
    if got[2].numel() != want[2].numel() or (
            not gate and not torch.equal(got[2][:n_cross],
                                         want[2][:n_cross])):
        return "pair_bj"
    return None


def check_prep(case, precision: str, device) -> str:
    from . import poisson_cuda

    name, pos, spacing, analyze, _, _ = case
    p = torch.from_numpy(pos).to(device)
    a = (None if analyze is None
         else torch.from_numpy(analyze.astype(np.uint8)).to(device))
    want = poisson_cuda.prep_torch(p, a, spacing, precision)
    with poisoned():
        got = poisson_cuda.range_prep(p, a, spacing, precision)
        torch.cuda.synchronize(device)
    bad = prep_mismatch(got, want)
    if bad:
        raise RuntimeError(f"prep {name} {precision}: {bad} differs from "
                           f"the plain version")
    gate, n_cross = want[3].tolist()
    return (f"prep {name} {precision}: n_cross={n_cross} gate={gate}, "
            f"equal to the plain version")


def check_k2(case, precision: str, device) -> str:
    from . import poisson_cuda

    name, pos, spacing, analyze, _, _ = case
    p, (planes, ana, ptr, bj), want = plain_mask(pos, spacing, analyze,
                                                 precision, device)
    stats: dict = {}
    with poisoned():
        got = poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj,
                                            stats=stats)
        torch.cuda.synchronize(device)
    if not torch.equal(got, want):
        raise RuntimeError(f"K2 {name} {precision}: "
                           f"{int((got != want).sum())} points differ from "
                           f"the plain version")
    return (f"K2 {name} {precision}: n={p.n} windows={stats['windows']} "
            f"accepted={int(got.sum())}, equal to the plain version")


def check_threads(case, threads: int, device) -> str:
    """The case's range sent by `range_mask_cuda` from `threads` threads at
    once (f64, each thread on its own stream), against the plain mask."""
    from . import poisson_cuda

    name, pos, spacing, analyze, _, _ = case
    _, _, want = plain_mask(pos, spacing, analyze, "f64", device)
    want = want.cpu().numpy().view(bool)
    with poisoned(), cf.ThreadPoolExecutor(threads) as pool:
        got = list(pool.map(
            lambda _: (poisson_cuda.range_mask_cuda(pos, spacing, analyze,
                                                    device=device),
                       poisson_cuda.thread_stream(device).cuda_stream),
            range(threads)))
    bad = [k for k, (mask, _) in enumerate(got)
           if not np.array_equal(mask, want)]
    if bad:
        raise RuntimeError(f"K2 {name} from {threads} threads: the masks of "
                           f"threads {bad} differ from the plain version")
    streams = len({s for _, s in got})
    return (f"K2 {name} from {threads} threads at once: every mask equal to "
            f"the plain version; {streams} streams")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=",".join(SANITIZED_CASES))
    ap.add_argument("--sweep-cases", default=None)
    ap.add_argument("--k1-points", type=int, default=K1_POINTS)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--poison", action="store_true")
    ap.add_argument("--self-check", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sanitize_kernels: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", torch.cuda.current_device())
    if args.poison:
        import warnings

        global POISON
        POISON = True
        warnings.filterwarnings("ignore", ".*deterministic")
    t0 = time.perf_counter()

    def timed(check, *check_args):
        start = time.perf_counter()
        line = check(*check_args, device)
        print(f"{line} ({time.perf_counter() - start:.1f} s)", flush=True)

    try:
        if args.self_check:
            timed(check_k1, 1000)
        else:
            names = [c for c in args.cases.split(",") if c]
            cases = {c[0]: c for c in poisson_cases(
                set(names) | ({THREADS_CASE} if args.threads else set()))}
            print(f"sanitize_kernels: cases drawn in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for name in names:
                for precision in cases[name][5]:
                    timed(check_prep, cases[name], precision)
                    timed(check_k2, cases[name], precision)
            if args.threads:
                timed(check_threads, cases[THREADS_CASE], args.threads)
            for case in gate_cases():
                for precision in ("f64", "f32"):
                    timed(check_gate, case, precision)
            sweep_names = (None if args.sweep_cases is None
                           else set(args.sweep_cases.split(",")))
            for case in sweep_cases(sweep_names):
                for sampler in SWEEP_SAMPLERS:
                    timed(check_sweep, case, sampler)
            timed(check_k1, args.k1_points)
    except RuntimeError as exc:
        print(f"sanitize_kernels: FAIL: {exc}", file=sys.stderr, flush=True)
        return 1
    print(f"sanitize_kernels: ok in {time.perf_counter() - t0:.1f} s"
          f"{' (poisoned)' if args.poison else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

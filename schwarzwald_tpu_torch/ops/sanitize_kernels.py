"""K1 and K2 through the port's entry points on the card, each against its
plain version: the program that compute-sanitizer runs over the kernels.

    python -m schwarzwald_tpu_torch.ops.sanitize_kernels [--cases a,b,...]
        [--k1-points N] [--threads T] [--poison] [--self-check]

K2 (`poisson_cuda.accept_mask_cuda`) on each named case of `poisson_cases`
in both precision modes against `accept_mask_torch`; one case sent by
`range_mask_cuda` from T threads at once, each on its own stream, against
the same plain mask; K1 (`morton_cuda.interleave_cuda`) on N coordinates
with the one-hot edge rows against `interleave21`. Results must be equal
exactly; the exit code is 0 when every check held and 1 otherwise.
`--poison` fills every `torch.empty` of the kernels' wrappers with NaN or
the type's largest value (`torch.utils.deterministic.fill_uninitialized_
memory`), so that a kernel reading a slot nothing wrote changes its result;
the plain versions run unpoisoned, outside PyTorch's deterministic mode. `--self-check` launches
K1 once on 1,000 points: what a sanitizer is first run on, to learn
whether it supports the card.

chip_smoke.py (phase 8) runs this under `compute-sanitizer --tool
memcheck|racecheck|synccheck|initcheck`, restricted to the kernels
`interleave_kernel`, `close_kernel` and `decide_kernel`; the case builders
here also give its phase 2 its inputs.
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
SANITIZED_CASES = ("uniform_4096", "uniform_262144", f"dense_{DENSE_POINTS}",
                   "clustered_192000", "duplicates_262144", "analyze3_262144")
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
    pairs), so the kernels run window by window."""
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
                    timed(check_k2, cases[name], precision)
            if args.threads:
                timed(check_threads, cases[THREADS_CASE], args.threads)
            timed(check_k1, args.k1_points)
    except RuntimeError as exc:
        print(f"sanitize_kernels: FAIL: {exc}", file=sys.stderr, flush=True)
        return 1
    print(f"sanitize_kernels: ok in {time.perf_counter() - t0:.1f} s"
          f"{' (poisoned)' if args.poison else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

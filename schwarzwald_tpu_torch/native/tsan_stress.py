"""Stress run of the port's native library (native/src) under
ThreadSanitizer, a run of known races beside it, and the verdict on what
each reports. Imports numpy and ctypes only, so that it runs in a process
that preloads libtsan, without torch or the rest of the package.

    python3 tsan_stress.py stress LIB              # drive LIB from threads
    python3 tsan_stress.py canary CANARY_LIB       # the known races
    python3 tsan_stress.py verdict MODE RUN RC LOG # judge one run's output

`tsan_check.sh` builds LIB and CANARY_LIB with -fsanitize=thread, preloads
libtsan and the GOMP_parallel shim (tsan_gomp.c, which tells
ThreadSanitizer of each OpenMP region's fork and join, as libgomp is not
instrumented), and runs both in two modes: A with one OpenMP thread per
caller (races between concurrent callers: thread_local state, statics,
shared scratch), B with the default OpenMP team. The stress run passes with
exit code 0, no report and every thread's results equal to the main
thread's; the canary run passes with ThreadSanitizer's exit code 66 and
reports at both of its races and nowhere else. The verdict comes from the
exit code and the count of reports, never from a line the run prints on
its own.
"""
from __future__ import annotations

import ctypes
import queue
import re
import sys
import threading

import numpy as np

THREADS = 8  # callers alive at once in each wave
WAVES = 2    # each wave's threads start while the earlier waves' live

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

# the entry points driven, with native/loader.py's argument types
ARGTYPES = {
    "poisson_accept_mask": [_f64p, ctypes.c_int64, _f64p, _f64p,
                            ctypes.c_double, ctypes.c_void_p, _u8p],
    "octree_sweep": [_u64p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                     ctypes.c_int32, ctypes.c_int32, _f64p, _f64p,
                     ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_void_p, _i8p],
    "gather_rows": [_u64p, ctypes.c_void_p, _i64p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p],
    "radix_argsort_u64": [_u64p, ctypes.c_int64, _i64p],
    "radix_sort_kv_u64": [_u64p, ctypes.c_int64, _i64p, _u64p],
    "index_points_fused": [_f64p, ctypes.c_int64, _f64p, _f64p, _u64p],
    "las_decode_index_fused": [_u8p, ctypes.c_int64, ctypes.c_int32, _f64p,
                               _f64p, ctypes.c_int32, _f64p, _f64p, _f64p,
                               _f64p, _u64p],
    "laz_decode_points": [_u8p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int32, _u16p, _i32p, ctypes.c_int32,
                          _u8p],
    "laz_encode_stream": [_u8p, ctypes.c_int64, ctypes.c_int32, _u16p,
                          _i32p, ctypes.c_int32, _u8p, ctypes.c_int64],
}
RESTYPES = {"laz_decode_points": ctypes.c_int64,
            "laz_encode_stream": ctypes.c_int64}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        if name in RESTYPES:
            fn.restype = RESTYPES[name]
    return lib


# -- the workloads ------------------------------------------------------------

N = 20_000
LO, HI = np.zeros(3), np.full(3, 64.0)


def make_inputs(seed: int = 0) -> dict:
    """Read-only inputs shared by every thread."""
    rng = np.random.default_rng(seed)
    xyz = np.cumsum(rng.integers(-9, 10, (N, 3)), axis=0).astype(np.int32)
    point10 = np.zeros((N, 20), dtype=np.uint8)
    point10.view(np.int32)[:, :3] = xyz
    point10[:, 12:14] = rng.integers(0, 256, (N, 2))  # intensity
    point10[:, 14] = rng.integers(1, 4, N) | (3 << 3)  # return 1-3 of 3
    point10[:, 15] = rng.integers(0, 10, N)            # classification
    point14 = np.zeros((N // 2, 30), dtype=np.uint8)
    point14[:, :12] = xyz[:N // 2].view(np.uint8).reshape(-1, 12)
    point14[:, 14] = rng.integers(1, 4, N // 2) | (3 << 4)
    point14[:, 16] = rng.integers(0, 10, N // 2)
    point14[:, 22:30] = np.cumsum(rng.uniform(0, 1e-3, N // 2)).view(
        np.uint8).reshape(-1, 8)  # gps time
    positions = rng.uniform(0.0, 64.0, (N, 3))
    reversed_ = np.ascontiguousarray(positions[::-1])
    # The small arrays the OpenMP workers read are made here too, by the
    # main thread before any worker starts: numpy keeps freed blocks under
    # 1 KiB in a cache of its own and hands them to the next thread without
    # malloc, so a small array made in one caller could sit where another
    # caller's array was, an ownership change ThreadSanitizer cannot see
    # once it reaches a reused libgomp worker.
    return {"keys": rng.integers(0, 1 << 63, 5 * N, dtype=np.uint64),
            "point10": point10.reshape(-1), "point14": point14.reshape(-1),
            "positions": positions,
            "analyze": (rng.random(N) < 0.5).astype(np.uint8),
            "item_types": {6: np.array([6], dtype=np.uint16),
                           10: np.array([10], dtype=np.uint16)},
            "item_sizes": {20: np.array([20], dtype=np.int32),
                           30: np.array([30], dtype=np.int32)},
            "candidates": np.array([min(lv + 4, 14) for lv in range(-1, 11)],
                                   dtype=np.int32),
            "las_scale": np.full(3, 0.01), "las_offset": np.zeros(3),
            "las_cell": np.full(3, 0.5), "las_lo": np.full(3, -40.0),
            "las_hi": np.full(3, 40.0),
            "gather_sources": np.array([positions.ctypes.data,
                                        reversed_.ctypes.data],
                                       dtype=np.uint64),
            "reversed": reversed_}


def sorted_cloud(lib, inp: dict):
    """The positions with their Morton keys, clamped and sorted."""
    pos = inp["positions"].copy()
    keys = np.empty(N, dtype=np.uint64)
    lib.index_points_fused(pos, N, LO, HI, keys)
    order = np.empty(N, dtype=np.int64)
    lib.radix_argsort_u64(keys, N, order)
    return np.ascontiguousarray(keys[order]), np.ascontiguousarray(pos[order])


def w_radix(lib, inp):
    keys = inp["keys"]
    order = np.empty(keys.size, dtype=np.int64)
    lib.radix_argsort_u64(keys, keys.size, order)
    order_kv = np.empty(keys.size, dtype=np.int64)
    sk = np.empty(keys.size, dtype=np.uint64)
    lib.radix_sort_kv_u64(keys, keys.size, order_kv, sk)
    return order, order_kv, sk


def w_laz(lib, inp):
    """Encode and decode a pointwise (POINT10) and a layered (POINT14)
    stream in chunks, which the codec spreads over its OpenMP team."""
    out = []
    for key, item, size, chunk in (("point10", 6, 20, 2500),
                                   ("point14", 10, 30, 1250)):
        rec = inp[key]
        n = rec.size // size
        types, sizes = inp["item_types"][item], inp["item_sizes"][size]
        buf = np.empty(rec.size * 2 + 65536, dtype=np.uint8)
        written = lib.laz_encode_stream(rec, n, chunk, types, sizes, 1, buf,
                                        buf.size)
        if written <= 8:
            raise RuntimeError(f"laz_encode_stream returned {written}")
        back = np.empty(rec.size, dtype=np.uint8)
        rc = lib.laz_decode_points(np.ascontiguousarray(buf[8:written]),
                                   written - 8, n, chunk, types, sizes, 1,
                                   back)
        if rc < 0 or not np.array_equal(back, rec):
            raise RuntimeError(f"{key} did not round-trip ({rc})")
        out.append(buf[:written].copy())
    return out


def w_poisson(lib, inp):
    _, pos = sorted_cloud(lib, inp)
    masks = []
    for analyze in (None, inp["analyze"]):
        mask = np.empty(N, dtype=np.uint8)
        lib.poisson_accept_mask(
            pos, N, LO, HI, 1.5,
            None if analyze is None else analyze.ctypes.data_as(
                ctypes.c_void_p), mask)
        masks.append(mask)
    return masks


def w_sweep(lib, inp):
    """The host octree sweep for MIN_DISTANCE (positions, no candidates)
    and RANDOM_GRID (candidate levels, no positions)."""
    keys, pos = sorted_cloud(lib, inp)
    max_depth = 10
    cands = inp["candidates"]
    out = []
    for strategy, positions, cand in ((0, pos, None), (2, None, cands)):
        levels = np.zeros(N, dtype=np.int8)
        lib.octree_sweep(
            keys, None,
            None if positions is None else positions.ctypes.data_as(
                ctypes.c_void_p),
            N, strategy, 0, max_depth, 500, LO, HI, 4.0,
            None if cand is None else cand.ctypes.data_as(ctypes.c_void_p),
            None, None, None, levels)
        out.append(levels)
    return out


def w_decode_index(lib, inp):
    rec = inp["point10"]
    pos = np.empty((N, 3), dtype=np.float64)
    keys = np.empty(N, dtype=np.uint64)
    lib.las_decode_index_fused(rec, N, 20, inp["las_scale"],
                               inp["las_offset"], 1, inp["las_cell"],
                               inp["las_lo"], inp["las_hi"], pos, keys)
    return pos, keys


def w_gather(lib, inp):
    """gather_rows over two chunks and over one (gather_typed's two
    loops), 24-byte rows."""
    srcs = inp["gather_sources"]
    rng = np.random.default_rng(1)
    chunk_ids = rng.integers(0, 2, N).astype(np.int64)
    local = rng.integers(0, N, N).astype(np.int64)
    two = np.empty((N, 3), dtype=np.float64)
    lib.gather_rows(srcs, chunk_ids.ctypes.data_as(ctypes.c_void_p), local,
                    N, 24, two.ctypes.data_as(ctypes.c_void_p))
    one = np.empty((N, 3), dtype=np.float64)
    lib.gather_rows(srcs, None, local, N, 24,
                    one.ctypes.data_as(ctypes.c_void_p))
    return two, one


WORKLOADS = (("radix", w_radix), ("laz", w_laz), ("poisson", w_poisson),
             ("sweep", w_sweep), ("decode_index", w_decode_index),
             ("gather", w_gather))


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_same, a, b))
    return np.array_equal(a, b)


def stress(path: str) -> int:
    """Every workload once on the main thread, then WAVES waves of THREADS
    threads, each running all of them (in an order of its own) at once;
    every thread's results must equal the main thread's.

    A worker never ends: it parks until the process exits. The library's
    thread_local state lives in dynamic TLS (it is loaded with dlopen),
    and when a thread ends glibc frees that block later from another
    thread, a hand-off that ThreadSanitizer cannot see (glibc is not
    instrumented); it would report the thread's TLS destructors against
    `_dl_deallocate_tls`. Waves of new threads beside parked ones still
    give every workload fresh thread_local state next to live state."""
    lib = bind(ctypes.CDLL(path))
    inp = make_inputs()
    want = {name: fn(lib, inp) for name, fn in WORKLOADS}
    results: queue.Queue = queue.Queue()
    park = threading.Event()
    differ, errors = [], []
    for wave in range(WAVES):
        ready = threading.Barrier(THREADS)

        def work(k):
            try:
                ready.wait(timeout=120)
                mine = WORKLOADS[k % len(WORKLOADS):] + \
                    WORKLOADS[:k % len(WORKLOADS)]
                results.put((k, {name: fn(lib, inp) for name, fn in mine},
                             None))
            except BaseException as exc:  # reported by the main thread
                results.put((k, None, repr(exc)))
            park.wait()

        for k in range(THREADS):
            threading.Thread(target=work, args=(k,), daemon=True,
                             name=f"wave{wave}_{k}").start()
        for _ in range(THREADS):
            k, got, err = results.get(timeout=600)
            if err is not None:
                errors.append(f"wave {wave} thread {k}: {err}")
                continue
            differ += [f"wave {wave} thread {k}: {name}" for name in want
                       if not _same(got[name], want[name])]
    print(f"tsan stress: {WAVES} waves of {THREADS} threads, "
          f"{len(WORKLOADS)} workloads each: results_differ={len(differ)} "
          f"errors={len(errors)}", flush=True)
    for line in differ + errors:
        print(f"  {line}", flush=True)
    return 1 if differ or errors else 0


# -- the known races ----------------------------------------------------------

def canary(path: str) -> int:
    """The canary library's hand-off on the main thread (checked), its
    team race, and its callers' race from THREADS threads at once."""
    lib = ctypes.CDLL(path)
    for name in ("canary_callers", "canary_team", "canary_handoff"):
        getattr(lib, name).restype = ctypes.c_int64
    lib.canary_callers.argtypes = lib.canary_team.argtypes = [ctypes.c_int64]
    lib.canary_handoff.argtypes = [_i64p, ctypes.c_int64]
    n = 100_000
    handoff_ok = lib.canary_handoff(np.empty(n, dtype=np.int64), n) \
        == n * (n - 1)
    lib.canary_team(n)
    ready = threading.Barrier(THREADS)

    def call():
        ready.wait(timeout=120)
        lib.canary_callers(n)

    threads = [threading.Thread(target=call) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"tsan canary: handoff {'ok' if handoff_ok else 'WRONG'}",
          flush=True)
    return 0 if handoff_ok else 1


# -- the verdict ----------------------------------------------------------------

_WARNING = "WARNING: ThreadSanitizer: "
_STRESS = re.compile(r"^tsan stress: .* results_differ=(\d+) errors=(\d+)$")
CANARY_RACES = ("canary_callers", "canary_team")


def reports(text: str) -> list:
    """(kind, site) of each ThreadSanitizer report in a run's output: the
    kind from its WARNING line, the site from its SUMMARY line without the
    directories ("" when the run ended before the summary)."""
    out = []
    for line in text.splitlines():
        if line.startswith(_WARNING):
            out.append([re.sub(r" \(pid=\d+\)$", "", line[len(_WARNING):]),
                        ""])
        elif line.startswith("SUMMARY: ThreadSanitizer: ") and out:
            site = line.split(": ", 2)[-1]
            if site.startswith(out[-1][0] + " "):
                site = site[len(out[-1][0]) + 1:]
            out[-1][1] = re.sub(r"\S*/", "", site)
    return [tuple(r) for r in out]


def _function(site: str) -> str:
    """The function a summary site names, without OpenMP's ._omp_fn.N."""
    return re.sub(r"\._omp_fn\.\d+$", "", site.rsplit(" in ", 1)[-1])


def verdict(mode: str, run: str, rc: int, text: str) -> tuple:
    """(passed, lines) for one run of one mode. A stress run passes with
    exit code 0, no report and the stress run's line showing every result
    equal; a canary run with exit code 66, reports at both known races and
    at no other site, and its hand-off right."""
    found = reports(text)
    count = sum(line.startswith(_WARNING) for line in text.splitlines())
    if run == "stress":
        lines = [m for m in map(_STRESS.match, text.splitlines()) if m]
        run_ok = len(lines) == 1 and lines[0].groups() == ("0", "0")
        passed = rc == 0 and count == 0 and run_ok
    else:
        funcs = {_function(site) for _, site in found}
        run_ok = "tsan canary: handoff ok" in text.splitlines()
        passed = (rc == 66 and run_ok and funcs == set(CANARY_RACES)
                  and all(kind == "data race" for kind, _ in found))
    lines = [f"tsan mode {mode} {run}: rc {rc}, {count} reports, results "
             f"{'ok' if run_ok else 'FAILED'} -> "
             f"{'pass' if passed else 'FAIL'}"]
    sites: dict = {}
    for kind, site in found:
        sites[f"{kind} {site}"] = sites.get(f"{kind} {site}", 0) + 1
    lines += [f"  {n} x {key}" for key, n in sorted(sites.items())]
    return passed, lines


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "stress":
        return stress(argv[1])
    if len(argv) == 2 and argv[0] == "canary":
        return canary(argv[1])
    if len(argv) == 5 and argv[0] == "verdict":
        with open(argv[4], errors="replace") as f:
            passed, lines = verdict(argv[1], argv[2], int(argv[3]), f.read())
        print("\n".join(lines), flush=True)
        return 0 if passed else 1
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The CUDA kernels (csrc/poisson.cu, csrc/morton.cu, csrc/sweep.cu)
against their plain-torch versions on the card, and the engine's device
paths on the card against the CPU and the host, on small cases.
Needs a CUDA card and nvcc; skipped without a card. Imports nothing of
JAX, so on a machine without it run:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from schwarzwald_tpu_torch import native
from schwarzwald_tpu_torch.core.aabb import AABB
from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
from schwarzwald_tpu_torch.io.memory import MemoryPersistence
from schwarzwald_tpu_torch.core import morton
from schwarzwald_tpu_torch.ops import (device, device_poisson, device_tiling,
                                       indexing, morton_cuda, poisson_cuda,
                                       sanitize_kernels)
from schwarzwald_tpu_torch.ops.sampling import SamplingStrategy
from schwarzwald_tpu_torch.tiling import (TilerMetaParameters, TilingStrategy,
                                          make_tiling_algorithm)

pytestmark = pytest.mark.cuda

EXTENT = 64.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def sorted_uniform(n, seed, lo=(0.0, 0.0, 0.0), hi=(EXTENT,) * 3):
    pos = np.random.default_rng(seed).uniform(lo, hi, (n, 3))
    keys, pos = indexing.index_points(pos, np.zeros(3), np.full(3, EXTENT))
    return pos[indexing.sort_by_key(keys)]


def on_card(p, device):
    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)
    return t(p.planes), t(p.analyze), t(p.pair_ptr), t(p.pair_bj)


def cases():
    dup = sorted_uniform(4096, 3)
    dup[100:140] = dup[99]
    analyze = np.zeros(5000, dtype=bool)
    analyze[::3] = True
    return {
        "uniform_4096": (sorted_uniform(4096, 1), 2.0, None),
        "partial_block_5000": (sorted_uniform(5000, 2), 1.0, None),
        "single_block_300": (sorted_uniform(300, 4), 8.0, None),
        "duplicates_4096": (dup, 1.0, None),
        "analyze3_5000": (sorted_uniform(5000, 5), 2.0, analyze),
    }


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(cases()))
def test_kernel_matches_plain_version(cuda, precision, case):
    pos, spacing, analyze = cases()[case]
    p = poisson_cuda.prep(pos, spacing, analyze, precision)
    planes, ana, ptr, bj = on_card(p, cuda)
    got = poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj)
    want = poisson_cuda.accept_mask_torch(planes, ana, p.sq, ptr, bj)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if precision == "f64":
        host = native.poisson_sample_kernel()(
            pos, np.zeros(3), np.full(3, EXTENT), spacing, analyze)
        np.testing.assert_array_equal(got.cpu().numpy().view(bool), host)


def test_each_launch_counts_once(cuda):
    """One window: phase A's counting and filling kernels and phase B's
    deciding kernel, three launches per call."""
    p = poisson_cuda.prep(sorted_uniform(4096, 6), 2.0)
    planes, ana, ptr, bj = on_card(p, cuda)
    before = poisson_cuda.snapshot()["launches"]
    for _ in range(3):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj)
    poisson_cuda.accept_mask_torch(planes, ana, p.sq, ptr, bj)
    assert poisson_cuda.snapshot()["launches"] == before + 3 * 3


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(cases()))
def test_phase_kernels_match_their_plain_versions(cuda, precision, case):
    pos, spacing, analyze = cases()[case]
    p = poisson_cuda.prep(pos, spacing, analyze, precision)
    planes, ana, ptr, bj = on_card(p, cuda)
    stats = {}
    mask = poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj,
                                         stats=stats)
    assert stats["windows"] == 1
    want = poisson_cuda.close_lists_torch(planes, ana, p.sq, ptr, bj)
    for g, w in zip(stats["lists"], want):
        assert torch.equal(g, w)
    assert torch.equal(mask, poisson_cuda.decide_torch(p.n, *want))
    assert torch.equal(mask, poisson_cuda.accept_mask_torch(
        planes, ana, p.sq, ptr, bj))


@pytest.mark.parametrize("budget", [1, 5000])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_kernel_windows_match_plain_version(cuda, precision, budget):
    pos = sorted_uniform(20_000, 14)
    p = poisson_cuda.prep(pos, 2.5, None, precision)
    planes, ana, ptr, bj = on_card(p, cuda)
    stats = {}
    got = poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj,
                                        budget=budget, stats=stats)
    torch.cuda.synchronize()
    assert stats["windows"] > 1
    assert set(poisson_cuda.phase_ms(stats)) == {"A", "B"}
    assert torch.equal(got, poisson_cuda.accept_mask_two_phase_torch(
        planes, ana, p.sq, ptr, bj, budget=budget))
    assert torch.equal(got, poisson_cuda.accept_mask_torch(
        planes, ana, p.sq, ptr, bj))


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_pair_csr_on_the_card_equals_numpy(cuda, precision):
    pos = sorted_uniform(50_000, 15)
    p = poisson_cuda.prep(pos, 1.5, None, precision)
    planes = torch.from_numpy(p.planes).to(cuda)
    ptr, bj = poisson_cuda.pair_csr_torch(
        planes, poisson_cuda.inflation(1.5),
        poisson_cuda.MAX_PAIRS_PER_BLOCK * p.n_blocks)
    np.testing.assert_array_equal(ptr.cpu().numpy(), p.pair_ptr)
    np.testing.assert_array_equal(bj.cpu().numpy(), p.pair_bj)


def test_ranges_from_threads_at_once_equal_a_serial_run(cuda):
    """8 threads send ranges at once, each on a stream of its own that it
    keeps: the masks are those of a serial run and of the native host
    kernel."""
    import concurrent.futures as cf

    ranges = [(sorted_uniform(30_000 + 1000 * k, 20 + k), 1.0 + 0.25 * k,
               None if k % 3 else np.arange(30_000 + 1000 * k) % 4 == 0)
              for k in range(8)]

    def run(args):
        return (poisson_cuda.range_mask_cuda(*args),
                poisson_cuda.thread_stream(cuda).cuda_stream)

    serial = [run(r)[0] for r in ranges]
    poisson_cuda.trace = []
    try:
        with cf.ThreadPoolExecutor(8) as pool:
            results = list(pool.map(run, ranges))
        records = poisson_cuda.trace
    finally:
        poisson_cuda.trace = None
    assert len({s for _, s in results}) > 1
    assert len(records) == 8
    threads = {}
    for r in records:
        threads.setdefault(r["thread"], set()).add(r["stream"])
    assert all(len(s) == 1 for s in threads.values())
    assert len({r["stream"] for r in records}) == len(threads) > 1
    for (pos, spacing, analyze), want, (got, _) in zip(ranges, serial,
                                                       results):
        np.testing.assert_array_equal(got, want)
        host = native.poisson_sample_kernel()(
            pos, np.zeros(3), np.full(3, EXTENT), spacing, analyze)
        np.testing.assert_array_equal(got, host)


def test_forty_threads_get_forty_streams(cuda):
    """40 threads alive at once each get a stream of their own, outside
    PyTorch's pool (32 streams per device, which would have to repeat one),
    and each sends a range on it: the masks are the native host kernel's,
    and every record names its thread's stream."""
    import threading

    pos = sorted_uniform(6000, 30)
    want = native.poisson_sample_kernel()(pos, np.zeros(3),
                                          np.full(3, EXTENT), 1.5, None)
    streams, masks, ready = {}, {}, threading.Barrier(40)

    def send(k):
        streams[k] = poisson_cuda.thread_stream("cuda").cuda_stream
        masks[k] = poisson_cuda.range_mask_cuda(pos, 1.5)
        assert poisson_cuda.thread_stream(cuda).cuda_stream == streams[k]
        ready.wait(timeout=120)  # no thread ends before all have a stream

    poisson_cuda.trace = []
    try:
        threads = [threading.Thread(target=send, args=(k,), name=f"s{k}")
                   for k in range(40)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        records = poisson_cuda.trace
    finally:
        poisson_cuda.trace = None
    assert len(streams) == 40 and len(set(streams.values())) == 40
    assert {r["thread"]: r["stream"] for r in records} == {
        f"s{k}": s for k, s in streams.items()}
    for k in range(40):
        np.testing.assert_array_equal(masks[k], want)


def test_successive_pools_send_on_the_same_streams(cuda):
    """Two pools of 20 threads one after the other, all 20 alive at once
    in each, as the engine makes one per batch and per level: the second
    pool's threads hold the first pool's 20 streams, no stream is made
    past the first pool, and every mask equals the native host kernel's."""
    import concurrent.futures as cf
    import threading

    pos = sorted_uniform(6000, 31)
    want = native.poisson_sample_kernel()(pos, np.zeros(3),
                                          np.full(3, EXTENT), 1.5, None)
    handed, made = [], []
    for _ in range(2):
        ready = threading.Barrier(20)

        def send(k):
            mask = poisson_cuda.range_mask_cuda(pos, 1.5)
            stream = poisson_cuda.thread_stream(cuda).cuda_stream
            ready.wait(timeout=120)  # no thread ends before all have one
            return mask, stream

        with cf.ThreadPoolExecutor(20) as pool:
            out = list(pool.map(send, range(20)))
        handed.append({s for _, s in out})
        made.append(poisson_cuda.stream_stats()["made"])
        for mask, _ in out:
            np.testing.assert_array_equal(mask, want)
    assert len(handed[0]) == 20 and handed[1] == handed[0]
    assert made[1] == made[0]


def test_kernels_under_memcheck(cuda):
    """The kernels' sanitizer checker on uniform_262144 (both modes) and K1
    under compute-sanitizer's memcheck, limited to K1's and K2's kernels:
    no error. Skips where the toolkit has no compute-sanitizer or the tool
    refuses the card."""
    import os
    import subprocess
    import sys

    from schwarzwald_tpu_torch.ops import _cuda_build

    tool = os.path.join(os.path.dirname(_cuda_build.nvcc_path()),
                        "compute-sanitizer")
    if not os.access(tool, os.X_OK):
        pytest.skip(f"no compute-sanitizer at {tool}")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [tool, "--tool", "memcheck", "--error-exitcode", "1",
         "--kernel-regex", "kns=interleave_kernel|close_kernel|decide_kernel|"
         "prep_one_kernel|prep_blocks_kernel|prep_rows_kernel|"
         "prep_pairs_kernel|sweep_kernel",
         sys.executable, "-m", "schwarzwald_tpu_torch.ops.sanitize_kernels",
         "--cases", "uniform_262144", "--threads", "0", "--k1-points",
         "100003"], cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1"))
    out = proc.stdout + proc.stderr
    if "Device not supported" in out:
        pytest.skip(f"{tool} refuses this card")
    assert proc.returncode == 0, out[-3000:]
    assert "ERROR SUMMARY: 0 errors" in out


# every case of sanitize_kernels.poisson_cases, the main path's root and
# the edges of the prep's one launch too
PREP_CASES = ("uniform_4096", "uniform_262144", "uniform_1500000",
              "clustered_192000", "duplicates_262144", "analyze3_262144",
              "dense_92160", "root_5490148", *sanitize_kernels.EDGE_CASES)


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", PREP_CASES)
def test_prep_kernels_match_their_plain_version(cuda, precision, case):
    """The prep kernels equal prep_torch (pair_csr_torch and _masked) on
    the card: the planes bit for bit, the head, the pair CSR element for
    element; one prep launch counted per call up to PREP_ONE_LAUNCH blocks,
    two above, none of K2's."""
    from schwarzwald_tpu_torch.ops import sanitize_kernels

    (_, pos, spacing, analyze, _, _), = sanitize_kernels.poisson_cases(
        {case})
    p = torch.from_numpy(pos).to(cuda)
    a = (None if analyze is None
         else torch.from_numpy(analyze.astype(np.uint8)).to(cuda))
    nb = -(-pos.shape[0] // poisson_cuda.BLOCK)
    launches = 1 if nb <= poisson_cuda.PREP_ONE_LAUNCH else 2
    before = (poisson_cuda.prep_launches, poisson_cuda.snapshot()["launches"])
    got = poisson_cuda.range_prep(p, a, spacing, precision)
    torch.cuda.synchronize()
    assert (poisson_cuda.prep_launches,
            poisson_cuda.snapshot()["launches"]) == (before[0] + launches,
                                                     before[1])
    want = poisson_cuda.prep_torch(p, a, spacing, precision)
    assert sanitize_kernels.prep_mismatch(got, want) is None
    assert want[3].tolist()[0] == 0


def gate_case(name):
    (_, pos, spacing), = [c for c in sanitize_kernels.gate_cases()
                          if c[0] == name]
    return pos, spacing


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sanitize_kernels.GATE_CASES)
def test_prep_kernels_at_the_pair_gate(cuda, precision, case):
    """Exactly at and one past pair_bj's capacity, in the prep's one launch
    and in its two: the prep kernels give prep_torch's head and pair_ptr
    (and pair_bj where the gate is open), and write nothing into a guard
    region after the capacity."""
    pos, spacing = gate_case(case)
    got, guard_kept = sanitize_kernels.guarded_prep(pos, spacing, precision,
                                                    cuda)
    want = poisson_cuda.prep_torch(torch.from_numpy(pos).to(cuda), None,
                                   spacing, precision)
    assert sanitize_kernels.prep_mismatch(got, want) is None
    assert guard_kept
    cap = poisson_cuda.gate_capacity(got[1].numel() - 1)
    assert got[3].tolist() == ([0, cap] if "at_limit" in case
                               else [1, cap + 1])


def test_a_range_past_the_gate_goes_to_the_host_kernel(cuda):
    """Sent as the engine sends it, a range one past the gate gives None
    and counts pair_gate and one K2 launch (its counting pass, which
    returns at once on the card); the thread's workspace then serves the
    next range."""
    pos, spacing = gate_case("gate_one_past")
    before = poisson_cuda.snapshot()
    assert device_poisson.poisson_accept_mask_device(
        None, pos, 0.0, spacing, None, backend="cuda") is None
    after = poisson_cuda.snapshot()
    assert {k: after[k] - before[k] for k in ("launches", "pair_gate",
                                              "kernel")} == {
        "launches": 1, "pair_gate": 1, "kernel": 0}
    pos = sorted_uniform(4096, 11)
    np.testing.assert_array_equal(
        poisson_cuda.range_mask_cuda(pos, 2.0),
        native.poisson_sample_kernel()(pos, np.zeros(3), np.full(3, EXTENT),
                                       2.0, None))


def mixed_ranges(count, seed):
    """`count` Morton-sorted ranges of 4,096 to 1,000,000 points (sizes
    spaced evenly in log), spacings and analyze masks varied."""
    sizes = np.geomspace(4096, 1_000_000, count).astype(int)
    out = []
    for k, n in enumerate(sizes):
        extent = EXTENT * (n / 4096) ** (1 / 3)
        pos = np.random.default_rng(seed + k).uniform(0.0, extent, (n, 3))
        keys, pos = indexing.index_points(pos, np.zeros(3),
                                          np.full(3, extent))
        pos = pos[indexing.sort_by_key(keys)]
        analyze = None if k % 3 else np.arange(n) % 4 == 0
        out.append((pos, 1.0 + 0.5 * (k % 4), analyze, extent))
    return out


def test_forty_threads_of_mixed_ranges_equal_the_host_kernel(cuda):
    """40 threads at once send ranges of 4,096 to 1,000,000 points, each
    on its stream and workspace: every mask is the native host kernel's."""
    import concurrent.futures as cf

    ranges = mixed_ranges(40, 60)
    host = native.poisson_sample_kernel()
    with cf.ThreadPoolExecutor(40) as pool:
        got = list(pool.map(lambda r: poisson_cuda.range_mask_cuda(
            r[0], r[1], r[2]), ranges))
    for (pos, spacing, analyze, extent), mask in zip(ranges, got):
        np.testing.assert_array_equal(mask, host(
            pos, np.zeros(3), np.full(3, extent), spacing, analyze))


def test_a_second_pass_allocates_nothing(cuda):
    """4 threads, each sending the same ranges: after the first pass no
    device segment, pinned block or workspace byte is added by the
    second, and the masks repeat."""
    import concurrent.futures as cf
    import threading

    ranges = mixed_ranges(6, 80)[:5]  # 4,096 to 251,000 points
    ready = threading.Barrier(4)

    def send(_):
        ready.wait(timeout=120)  # each worker takes one task
        return [poisson_cuda.range_mask_cuda(pos, spacing, analyze)
                for pos, spacing, analyze, _ in ranges]

    def counts():
        ws = poisson_cuda.workspace_stats()
        return (torch.cuda.memory_stats()["segment.all.allocated"],
                torch.cuda.host_memory_stats()["num_host_alloc"],
                ws["host"], ws["device"], ws["one_off"])

    with cf.ThreadPoolExecutor(4) as pool:
        first = list(pool.map(send, range(4)))
        warm = counts()
        second = list(pool.map(send, range(4)))
        assert counts() == warm
    for a, b in zip(first + second, first[:1] * 8):
        for m, w in zip(a, b):
            np.testing.assert_array_equal(m, w)


def test_wrapper_checks_its_inputs(cuda):
    p = poisson_cuda.prep(sorted_uniform(4096, 7), 2.0)
    planes, ana, ptr, bj = on_card(p, cuda)
    with pytest.raises(TypeError):
        poisson_cuda.accept_mask_cuda(planes.to(torch.int32), ana, p.sq,
                                      ptr, bj)
    with pytest.raises(ValueError, match="contiguous"):
        poisson_cuda.accept_mask_cuda(planes.t().contiguous().t(), ana,
                                      p.sq, ptr, bj)
    with pytest.raises(ValueError, match="pair_ptr"):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr[:-1], bj)
    with pytest.raises(ValueError, match="pair_bj"):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj.cpu())


@pytest.mark.parametrize("sampler", ["MIN_DISTANCE", "MIN_DISTANCE_FAST"])
def test_engine_through_the_kernel_equals_host(cuda, sampler):
    pos = np.random.default_rng(8).uniform([0.0] * 3,
                                           [EXTENT, EXTENT / 2, EXTENT / 2],
                                           (12_000, 3))
    bounds = AABB([0.0] * 3, [EXTENT] * 3)

    def run(use_device):
        persistence = MemoryPersistence()
        meta = TilerMetaParameters(spacing_at_root=1.0,
                                   max_points_per_node=500, concurrency=4,
                                   use_device=use_device)
        algo = make_tiling_algorithm(TilingStrategy.Fast,
                                     SamplingStrategy(sampler, 500),
                                     persistence, meta)
        algo.level_of_start_nodes = 1
        algo.process_batch(PointBuffer(pos.copy()), bounds)
        algo.finalize(bounds)
        return persistence

    host = run(None)
    before = poisson_cuda.snapshot()
    dev = run("cuda")
    after = poisson_cuda.snapshot()
    # three ranges, each one window: three launches per range
    assert after["kernel"] == before["kernel"] + 3
    assert after["launches"] == before["launches"] + 3 * 3
    assert set(host.node_names()) == set(dev.node_names())
    for name in host.node_names():
        np.testing.assert_array_equal(dev.retrieve_points(name).positions,
                                      host.retrieve_points(name).positions,
                                      err_msg=name)


# -- kernel K1: the Morton interleave ------------------------------------------

def grid_coords(n, seed):
    """(n,) int32 coordinates per axis, with one-hot, 0 and 2^21 - 1 rows."""
    rng = np.random.default_rng(seed)
    axes = [rng.integers(0, 1 << 21, n).astype(np.int32) for _ in range(3)]
    oh = np.array([1 << i for i in range(21)] + [0, (1 << 21) - 1],
                  dtype=np.int32)
    zo = np.zeros_like(oh)
    rows = [(oh, zo, zo), (zo, oh, zo), (zo, zo, oh)]
    return [np.concatenate([axes[a]] + [r[a] for r in rows])
            for a in range(3)]


@pytest.mark.parametrize("n", [0, 1, 1000, 100_003])
def test_morton_kernel_matches_plain_version(cuda, n):
    # the last n rows, which hold the edge rows once n >= 69
    axes = [a[a.size - n:] for a in grid_coords(n, n)]
    x, y, z = (torch.from_numpy(a).to(cuda) for a in axes)
    got = morton_cuda.interleave_cuda(x, y, z)
    want = morton_cuda.interleave21(x, y, z)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (axes[0].size,)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.uint64),
        morton.from_grid_coords(*(a.view(np.uint32) for a in axes)))


def test_morton_launches_count_once(cuda):
    x, y, z = (torch.from_numpy(a).to(cuda) for a in grid_coords(5000, 9))
    before = morton_cuda.snapshot()["launches"]
    for _ in range(3):
        morton_cuda.interleave(x, y, z)
    morton_cuda.interleave21(x, y, z)
    assert morton_cuda.snapshot()["launches"] == before + 3


def test_morton_wrapper_checks_its_inputs(cuda):
    x, y, z = (torch.from_numpy(a).to(cuda) for a in grid_coords(5000, 10))
    with pytest.raises(TypeError):
        morton_cuda.interleave_cuda(x.to(torch.int64), y, z)
    with pytest.raises(ValueError, match="contiguous"):
        morton_cuda.interleave_cuda(x, torch.stack([y, y], 1)[:, 0], z)
    with pytest.raises(ValueError, match="shape"):
        morton_cuda.interleave_cuda(x, y[:-1], z)
    with pytest.raises(ValueError, match="is on"):
        morton_cuda.interleave_cuda(x, y, z.cpu())


def test_batch_step_on_the_card_equals_host(cuda):
    pos = np.random.default_rng(11).uniform(0.0, EXTENT, (200_000, 3))
    got = device.encode_sort_batch(pos, np.zeros(3), np.full(3, EXTENT),
                                   level=3, device=cuda)
    keys, _ = indexing.index_points(pos.copy(), np.zeros(3),
                                    np.full(3, EXTENT))
    sk, order = indexing.sort_with_keys(keys)
    np.testing.assert_array_equal(got.keys.cpu().numpy().view(np.uint64), sk)
    np.testing.assert_array_equal(got.order.cpu().numpy(), order)
    np.testing.assert_array_equal(
        got.node_histogram.cpu().numpy(),
        np.bincount(morton.truncate_to_level(sk, 2).astype(np.int64),
                    minlength=512))


# -- the octree sweep ------------------------------------------------------------

SWEEP_EDGE_CASES = ("single_1", "equal_5000", "mirrored_ties",
                    "block_edges_70001", "reroot_3000", "above_n_3000")


@pytest.mark.parametrize("case", ["uniform_and_cluster",
                                  *SWEEP_EDGE_CASES])
@pytest.mark.parametrize("strategy", ["RANDOM_GRID", "GRID_CENTER",
                                      "JITTERED"])
def test_sweep_on_the_card_equals_cpu(cuda, strategy, case):
    """X2's kernel on the card, one launch, against the plain version on
    the CPU, every int8 level: a uniform cloud with a dense cluster, and
    the checker's edge cases (one point, equal keys, exact distance ties,
    cells across the kernel's CTAs, a plan that stops at re-rooting
    depths, max_points above n)."""
    if case == "uniform_and_cluster":
        rng = np.random.default_rng(12)
        pos = np.concatenate([rng.uniform(0.0, EXTENT, (20_000, 3)),
                              rng.normal(20.0, 0.5, (20_000, 3))])
        keys, pos = indexing.index_points(pos, np.zeros(3),
                                          np.full(3, EXTENT))
        order = indexing.sort_by_key(keys)
        drawn = (case, keys[order], pos[order], EXTENT, 2.0, 200, 100, -1)
    else:
        drawn = sanitize_kernels.sweep_cases({case})[0]

    def run(dev):
        key, args, kw = sanitize_kernels.sweep_args(drawn, strategy, dev)
        return device_tiling.octree_select_grid(key, *args, **kw)

    want = run("cpu").numpy()
    before = device_tiling.snapshot()["x2_launches"]
    got = run(cuda)
    assert device_tiling.snapshot()["x2_launches"] == before + 1
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if case == "uniform_and_cluster":
        assert np.unique(want[want > 0]).size >= 3


@pytest.mark.parametrize("case", ["clustered_4M_level-1",
                                  "clustered_4M_level2"])
@pytest.mark.parametrize("strategy", ["RANDOM_GRID", "GRID_CENTER",
                                      "JITTERED"])
def test_sweep_of_a_main_path_group_equals_the_plain_version(cuda, strategy,
                                                            case):
    """X2 on a 4M-point group of the main path's size, from the root and
    from level 2: one launch, every level the plain version's on the
    card."""
    drawn = sanitize_kernels.sweep_cases({case})[0]
    key, args, kw = sanitize_kernels.sweep_args(drawn, strategy, cuda)
    want = device_tiling.octree_select_grid_torch(key, *args, **kw)
    before = device_tiling.snapshot()["x2_launches"]
    got = device_tiling.octree_select_grid_cuda(key, *args, **kw)
    assert device_tiling.snapshot()["x2_launches"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("strategy", ["RANDOM_GRID", "GRID_CENTER"])
def test_a_sweep_too_large_for_shared_memory_equals_the_plain_version(
        cuda, strategy):
    """24M points: more than the CTAs that fit on the card hold in shared
    memory, so each CTA keeps its state in a region of device memory; one
    launch, every level the plain version's."""
    n = 24_000_000
    rng = np.random.default_rng(17)
    pos = rng.uniform(0.0, EXTENT, (n, 3))
    keys, pos = indexing.index_points(pos, np.zeros(3), np.full(3, EXTENT))
    order = indexing.sort_by_key(keys)
    drawn = ("large", keys[order], np.ascontiguousarray(pos[order]), EXTENT,
             EXTENT * 3 ** 0.5 / 250, 20_000, 100, -1)
    del keys, pos, order
    key, args, kw = sanitize_kernels.sweep_args(drawn, strategy, cuda)
    want = device_tiling.octree_select_grid_torch(key, *args, **kw)
    before = device_tiling.snapshot()["x2_launches"]
    got = device_tiling.octree_select_grid_cuda(key, *args, **kw)
    assert device_tiling.snapshot()["x2_launches"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def sweep_jobs(device):
    """(key, args, kwargs, plain levels) of four sweeps: the uniform cloud
    with a cluster under each grid sampler, and a block-edge case."""
    rng = np.random.default_rng(16)
    pos = np.concatenate([rng.uniform(0.0, EXTENT, (60_000, 3)),
                          rng.normal(30.0, 0.7, (60_000, 3))])
    keys, pos = indexing.index_points(pos, np.zeros(3), np.full(3, EXTENT))
    order = indexing.sort_by_key(keys)
    drawn = ("cloud", keys[order], np.ascontiguousarray(pos[order]), EXTENT,
             2.0, 300, 100, -1)
    edge = sanitize_kernels.sweep_cases({"block_edges_70001"})[0]
    jobs = []
    for case, sampler in ((drawn, "RANDOM_GRID"), (drawn, "GRID_CENTER"),
                          (drawn, "JITTERED"), (edge, "GRID_CENTER")):
        key, args, kw = sanitize_kernels.sweep_args(case, sampler, device)
        jobs.append((key, args, kw, device_tiling.octree_select_grid_torch(
            key, *args, **kw)))
    return jobs


def test_four_sweeps_on_four_streams_at_once(cuda):
    """Four sweeps enqueued on four streams of one card, each enqueued
    before any is waited on, twice over: every level the plain version's
    (each launch carries its own plan)."""
    jobs = sweep_jobs(cuda)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in jobs]
    outs = []
    for _ in range(2):
        for s, (key, args, kw, _) in zip(streams, jobs):
            with torch.cuda.stream(s):
                outs.append(device_tiling.octree_select_grid_cuda(
                    key, *args, **kw))
    torch.cuda.synchronize()
    for got, (_, _, _, want) in zip(outs, jobs + jobs):
        assert torch.equal(got, want)


def test_sweeps_and_k2_ranges_in_flight_together(cuda):
    """Threads send K2 ranges (phase B's CTAs wait on ready flags) while
    other threads enqueue sweeps (a cooperative launch that starts only
    when all its CTAs fit on the card): nothing deadlocks, every mask is
    the native host kernel's and every level the plain version's."""
    import concurrent.futures as cf

    jobs = sweep_jobs(cuda)
    ranges = mixed_ranges(12, 90)
    host = native.poisson_sample_kernel()
    torch.cuda.synchronize()

    def sweep(job):
        key, args, kw, _ = job
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            got = [device_tiling.octree_select_grid_cuda(key, *args, **kw)
                   for _ in range(3)]
            torch.cuda.current_stream().synchronize()
        return got

    with cf.ThreadPoolExecutor(16) as pool:
        masks = [pool.submit(poisson_cuda.range_mask_cuda, r[0], r[1], r[2])
                 for r in ranges]
        sweeps = [pool.submit(sweep, job) for job in jobs]
        masks = [f.result(timeout=300) for f in masks]
        sweeps = [f.result(timeout=300) for f in sweeps]
    for (pos, spacing, analyze, extent), mask in zip(ranges, masks):
        np.testing.assert_array_equal(mask, host(
            pos, np.zeros(3), np.full(3, extent), spacing, analyze))
    for got, (_, _, _, want) in zip(sweeps, jobs):
        assert all(torch.equal(g, want) for g in got)


def test_sweep_wrapper_checks_its_inputs(cuda):
    key = torch.arange(100, dtype=torch.int64, device=cuda)
    pos = torch.zeros(100, 3, dtype=torch.float64, device=cuda)
    gc = dict(strategy="GRID_CENTER", root_min=[0.0] * 3,
              root_max=[1.0] * 3)
    cands = device_tiling.candidate_levels(EXTENT, 2.0, 100)
    with pytest.raises(ValueError, match="are on"):
        device_tiling.octree_select_grid_cuda(key, cands, 10, 100,
                                              positions=pos.cpu(), **gc)
    with pytest.raises(TypeError, match="dtype"):
        device_tiling.octree_select_grid_cuda(key.to(torch.int32), cands,
                                              10, 100)
    with pytest.raises(ValueError, match="out must be"):
        device_tiling.octree_select_grid_cuda(
            key, cands, 10, 100, positions=pos, **gc,
            out=torch.empty(100, dtype=torch.int16, device=cuda))
    # a key on the CPU never reaches the kernel through the dispatch
    before = device_tiling.snapshot()["x2_launches"]
    device_tiling.octree_select_grid(key.cpu(), cands, 10, 100)
    assert device_tiling.snapshot()["x2_launches"] == before


@pytest.mark.parametrize("tiling", ["FAST", "ACCURATE"])
@pytest.mark.parametrize("sampler", ["RANDOM_GRID", "GRID_CENTER",
                                     "JITTERED"])
def test_engine_grid_sweep_through_the_card_equals_host(cuda, tiling,
                                                        sampler):
    rng = np.random.default_rng(13)
    batches = [rng.uniform(0.0, EXTENT / 2, (5000, 3)),
               rng.uniform(0.0, EXTENT, (5000, 3))]
    bounds = AABB([0.0] * 3, [EXTENT] * 3)

    def run(use_device):
        persistence = MemoryPersistence()
        meta = TilerMetaParameters(
            spacing_at_root=2.0 if sampler == "JITTERED" else 6.0,
            max_points_per_node=300, concurrency=4, use_device=use_device)
        algo = make_tiling_algorithm(TilingStrategy(tiling),
                                     SamplingStrategy(sampler, 300),
                                     persistence, meta)
        if tiling == "FAST":
            algo.level_of_start_nodes = 3
        for pos in batches:
            algo.process_batch(PointBuffer(pos.copy()), bounds)
        algo.finalize(bounds)
        return algo, persistence

    _, host = run(None)
    algo, dev = run("cuda")
    assert algo.device_sweeps_ok == (2 if tiling == "FAST" else 1)
    assert algo.device_reroots == 0
    assert set(host.node_names()) == set(dev.node_names())
    for name in host.node_names():
        np.testing.assert_array_equal(dev.retrieve_points(name).positions,
                                      host.retrieve_points(name).positions,
                                      err_msg=name)


# -- the multi-device layer ------------------------------------------------------

def test_dryrun_multichip_on_the_card(cuda):
    """4 shards on the card(s): K1 launched once per shard, the exchange
    and the miniature tile checked inside."""
    from schwarzwald_tpu_torch.entry import dryrun_multichip

    morton_cuda.reset_counters()
    dryrun_multichip(4)
    assert morton_cuda.snapshot()["launches"] == 4


def test_exchange_on_the_card_equals_cpu(cuda):
    from schwarzwald_tpu_torch.parallel.multidevice import make_mesh

    rng = np.random.default_rng(14)
    base = rng.uniform(0.0, EXTENT, (500, 3))
    pos = np.concatenate([rng.uniform(0.0, EXTENT, (30_000, 3)),
                          base[rng.integers(0, 500, 20_000)]])
    keys, _ = indexing.index_points(pos, np.zeros(3), np.full(3, EXTENT))
    ids = np.arange(keys.size, dtype=np.int64)
    mesh = make_mesh(4, "cuda")
    assert all(d.type == "cuda" for d in mesh)
    got, got_hist = device.ShardedExchange(mesh, level=3).route(keys, ids)
    want, want_hist = device.ShardedExchange(
        make_mesh(4, "cpu"), level=3).route(keys, ids)
    for (gk, gi), (wk, wi) in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(got_hist, want_hist)


@pytest.mark.parametrize("sampler", ["RANDOM_GRID", "MIN_DISTANCE"])
def test_multidevice_engine_on_the_card_equals_host(cuda, sampler):
    """TilingAlgorithmMultiDevice over 4 shards on the card against the
    single-device FAST host run at start level 3: grid samplers sweep per
    owner on the card, MIN_DISTANCE ranges go through K2."""
    from schwarzwald_tpu_torch.parallel.multidevice import (
        TilingAlgorithmMultiDevice, make_mesh)

    rng = np.random.default_rng(15)
    batches = [rng.uniform(0.0, EXTENT / 2, (5000, 3)),
               rng.uniform(0.0, EXTENT, (20_000, 3))]
    bounds = AABB([0.0] * 3, [EXTENT] * 3)

    def run(use_device, multi):
        persistence = MemoryPersistence()
        meta = TilerMetaParameters(spacing_at_root=1.0,
                                   max_points_per_node=300, concurrency=4,
                                   use_device=use_device)
        if multi:
            algo = TilingAlgorithmMultiDevice(
                SamplingStrategy(sampler, 300), persistence, meta,
                mesh=make_mesh(4, use_device), ownership_level=3)
        else:
            algo = make_tiling_algorithm(TilingStrategy.Fast,
                                         SamplingStrategy(sampler, 300),
                                         persistence, meta)
            algo.level_of_start_nodes = 3
        for pos in batches:
            algo.process_batch(PointBuffer(pos.copy()), bounds)
        algo.finalize(bounds)
        return algo, persistence

    _, host = run(None, False)
    before = poisson_cuda.snapshot()
    algo, dev = run("cuda", True)
    after = poisson_cuda.snapshot()
    if sampler == "MIN_DISTANCE":
        assert after["launches"] > before["launches"]
    else:
        assert algo.device_sweeps_ok >= 4 and algo.device_reroots == 0
    assert set(host.node_names()) == set(dev.node_names())
    for name in host.node_names():
        np.testing.assert_array_equal(dev.retrieve_points(name).positions,
                                      host.retrieve_points(name).positions,
                                      err_msg=name)


def test_bench_profiler_sees_the_card_and_names_spans(cuda, tmp_path):
    """bench_torch's traced-run machinery on the card: torch.profiler
    records K1's launches, the util/trace.py span merged onto its clock
    names them, and the breakdown reads an idle share of the window."""
    import json

    from torch.profiler import ProfilerActivity, profile, record_function

    import bench_torch
    from schwarzwald_tpu_torch.ops.sanitize_kernels import edge_coords
    from schwarzwald_tpu_torch.util.trace import ChromeTracer

    x, y, z = (torch.from_numpy(a).to(cuda) for a in edge_coords(1 << 20, 3))
    morton_cuda.interleave_cuda(x, y, z)
    torch.cuda.synchronize()
    tracer = ChromeTracer()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(bench_torch.WINDOW):
            anchor = tracer._now_us()
            with tracer.span("k1_launches", "index"):
                for _ in range(5):
                    morton_cuda.interleave_cuda(x, y, z)
                torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    bench_torch.merge_spans(doc, tracer._events, anchor)
    b = bench_torch.breakdown(doc)
    assert b["measured"], "the profiler recorded no device operation"
    assert 0.0 <= b["idle_share"] < 1.0
    k1 = [op for op in b["top_ops"] if "interleave" in op["name"]]
    assert k1 and k1[0]["count"] == 5 and k1[0]["span"] == "k1_launches"
    # key_averages() sees the device time too (the traced run reads the
    # Chrome trace itself)
    assert sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()) > 0


def test_bench_kernels_alone_on_the_card(cuda):
    """bench_torch.k2_alone: K2 at the timing case, a positive time from
    CUDA events."""
    import bench_torch

    got = bench_torch.k2_alone({"k2_ms_uniform_262144"})
    assert set(got) == {"k2_ms_uniform_262144"}
    assert all(v > 0 for v in got.values()), got

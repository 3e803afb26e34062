"""The CUDA kernels (csrc/poisson.cu, csrc/morton.cu) against their
plain-torch versions on the card, and the octree sweep and the engine's
device paths on the card against the CPU and the host, on small cases.
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
from schwarzwald_tpu_torch.ops import (device, device_tiling, indexing,
                                       morton_cuda, poisson_cuda)
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

@pytest.mark.parametrize("strategy", ["RANDOM_GRID", "GRID_CENTER",
                                      "JITTERED"])
def test_sweep_on_the_card_equals_cpu(cuda, strategy):
    rng = np.random.default_rng(12)
    pos = np.concatenate([rng.uniform(0.0, EXTENT, (20_000, 3)),
                          rng.normal(20.0, 0.5, (20_000, 3))])
    keys, pos = indexing.index_points(pos, np.zeros(3), np.full(3, EXTENT))
    order = indexing.sort_by_key(keys)
    skeys, spos = keys[order], pos[order]
    spacing, max_points = 2.0, 200
    cands = device_tiling.candidate_levels(EXTENT, spacing, 100)
    jit_cfgs = device_tiling.jittered_static_configs(EXTENT, spacing, 100)

    def run(dev):
        kw = {}
        if strategy != "RANDOM_GRID":
            kw = dict(positions=torch.from_numpy(spos).to(dev),
                      root_min=[0.0] * 3, root_max=[EXTENT] * 3,
                      jit_cfgs=jit_cfgs)
        return device_tiling.octree_select_grid(
            device_tiling.keys_tensor(skeys, dev), cands, max_points, 100,
            strategy=strategy, **kw).cpu().numpy()

    want = run("cpu")
    got = run(cuda)
    np.testing.assert_array_equal(got, want)
    assert np.unique(want[want > 0]).size >= 3


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

"""The port's multi-device layer (`--multichip`) against the JAX package on
the CPU: the lossless exchange (ops/device.ShardedExchange) shard for shard
against JAX's on its virtual 4-device CPU mesh, the mesh, the dry runs, the
multi-device engine's BIN output byte for byte, and the CLI. The port's
shards here are 4 CPU devices; every comparison is exact. The card's cases
are in tests/test_torch_cuda.py, which imports no JAX."""
import importlib
import os

import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
from schwarzwald_tpu.ops import indexing
from schwarzwald_tpu_torch.ops import morton_cuda
from schwarzwald_tpu_torch.ops.device import ShardedExchange
from schwarzwald_tpu_torch.parallel import multidevice

from test_torch_slice import assert_same_tree, cli, write_las
from test_torch_sweep import jax_sweep_program

torch.set_num_threads(1)

N_DEV = 4
EXTENT = 64.0
BMIN = np.zeros(3)
BMAX = np.full(3, EXTENT)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="module")
def jax_mesh():
    from schwarzwald_tpu.parallel import multidevice as jax_multidevice

    return jax_multidevice.make_mesh(N_DEV, backend="cpu")


@pytest.fixture(scope="module")
def mesh():
    return multidevice.make_mesh(N_DEV, "cpu")


def host_keys(pos):
    keys, _ = indexing.index_points(pos.copy(), BMIN, BMAX)
    return keys


# -- the exchange: shard for shard -------------------------------------------

def route_case(name: str):
    """(keys, ids, cell_range) of tests/test_multidevice.py's batches, and
    of a batch that does not divide by the shard count and one whose keys
    lie partly outside the striped cells (the clip of JAX's _dest_of)."""
    rng = np.random.default_rng(20260816)
    cell_range = None
    if name == "uniform":
        keys = host_keys(rng.uniform(BMIN, BMAX, (N_DEV * 512, 3)))
    elif name == "skewed":  # every point in the first level-1 octant
        keys = host_keys(rng.uniform(0.0, 7.9, (4096, 3)))
    elif name == "duplicates":
        base = rng.uniform(BMIN, BMAX, (50, 3))
        keys = host_keys(base[rng.integers(0, 50, 2000)])
    elif name == "uneven":
        keys = host_keys(rng.uniform(BMIN, BMAX, (1001, 3)))
    elif name == "cell_range":  # host 0's half of the level-3 cells
        cells = rng.integers(0, 256, 4000, dtype=np.uint64)
        low = rng.integers(0, 1 << 54, 4000, dtype=np.uint64)
        keys = (cells << np.uint64(63 - 9)) | low
        cell_range = (0, 256)
    elif name == "foreign_cells":  # keys outside [100, 401) stay on the
        # ends; 301 cells do not divide by 4 shards
        keys = host_keys(rng.uniform(BMIN, BMAX, (3000, 3)))
        cell_range = (100, 401)
    else:
        raise KeyError(name)
    return keys, np.arange(keys.size, dtype=np.int64), cell_range


ROUTE_CASES = ["uniform", "skewed", "duplicates", "uneven", "cell_range",
               "foreign_cells"]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_equals_jax(jax_mesh, mesh, case):
    from schwarzwald_tpu.ops.device import ShardedExchange as JaxExchange

    keys, ids, cell_range = route_case(case)
    want, want_hist = JaxExchange(jax_mesh, level=3,
                                  cell_range=cell_range).route(keys, ids)
    exchange = ShardedExchange(mesh, level=3, cell_range=cell_range)
    got, got_hist = exchange.route(keys, ids)
    assert len(got) == len(want) == N_DEV
    for d, ((gk, gi), (wk, wi)) in enumerate(zip(got, want)):
        assert gk.dtype == np.uint64 and gi.dtype == np.int64
        np.testing.assert_array_equal(gk, wk, err_msg=f"shard {d} keys")
        np.testing.assert_array_equal(gi, wi, err_msg=f"shard {d} ids")
    np.testing.assert_array_equal(got_hist, want_hist)
    # the global stable sort, nothing lost
    order = indexing.sort_by_key(keys)
    np.testing.assert_array_equal(np.concatenate([k for k, _ in got]),
                                  keys[order])
    np.testing.assert_array_equal(np.concatenate([i for _, i in got]),
                                  ids[order])
    assert exchange.owned_points == [k.size for k, _ in got]
    assert len(exchange.route_seconds) == 1
    if case == "skewed":
        assert got[0][0].size > keys.size // 2
    if case == "cell_range":  # the owned block striped over every shard
        assert all(k.size for k, _ in got)


def test_route_shards_take_device_spans(mesh):
    """route_shards on per-shard tensors of the batch's contiguous spans
    gives route's owners and histogram."""
    keys, ids, _ = route_case("duplicates")
    exchange = ShardedExchange(mesh, level=3)
    want, want_hist = exchange.route(keys, ids)
    per = -(-keys.size // N_DEV)
    spans = [slice(d * per, (d + 1) * per) for d in range(N_DEV)]
    k = [torch.from_numpy(keys[s].view(np.int64)) for s in spans]
    i = [torch.from_numpy(ids[s]) for s in spans]
    got, hist = exchange.route_shards(k, i)
    for (gk, gi), (wk, wi) in zip(got, want):
        np.testing.assert_array_equal(gk.numpy().view(np.uint64), wk)
        np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(hist.numpy(), want_hist)
    with pytest.raises(ValueError, match="expected 4 shards"):
        exchange.route_shards(k[:3], i[:3])


# -- the mesh ------------------------------------------------------------------

def test_mesh_places_shards():
    """cpu and host: CPU shards; cuda without a card raises and puts no shard
    on the CPU."""
    assert multidevice.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert multidevice.make_mesh(2, None) == [torch.device("cpu")] * 2
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multidevice.make_mesh(4, "cuda")
    with pytest.raises(ValueError, match="at least one shard"):
        multidevice.make_mesh(0, "cpu")
    with pytest.raises(ValueError, match="cuda, cpu or None"):
        multidevice.make_mesh(2, "tpu")


# -- the dry runs --------------------------------------------------------------

def test_dryrun(mesh):
    multidevice.dryrun(mesh, n_per_device=512)


@pytest.mark.parametrize("fault", ["lost", "duplicated", "foreign",
                                   "unstable"])
def test_check_routed_catches_faults(mesh, fault):
    """The dry runs' check itself: each kind of fault raises."""
    keys, ids, _ = route_case("duplicates")
    per_device, hist = ShardedExchange(mesh, level=3).route(keys, ids)
    per_device = [(k.copy(), i.copy()) for k, i in per_device]
    k0, i0 = per_device[0]
    if fault == "lost":
        per_device[0] = (k0[1:], i0[1:])
    elif fault == "duplicated":
        i0[1] = i0[0]
    elif fault == "foreign":
        per_device[0], per_device[1] = per_device[1], per_device[0]
    else:  # two equal keys out of batch order
        dup = np.flatnonzero(k0[1:] == k0[:-1])[0]
        i0[[dup, dup + 1]] = i0[[dup + 1, dup]]
    with pytest.raises(RuntimeError):
        multidevice.check_routed(per_device, hist, keys, ids, N_DEV)


def test_dryrun_multichip_on_cpu_shards():
    """The port's entry point: K1's plain version per shard on the CPU (no
    launch), the exchange, and the miniature tile equal to single-device
    FAST."""
    from schwarzwald_tpu_torch.entry import dryrun_multichip

    morton_cuda.reset_counters()
    dryrun_multichip(N_DEV, device="cpu")
    assert morton_cuda.snapshot()["launches"] == 0


# -- the engine: BIN output byte for byte --------------------------------------

def run_multidevice(pkg, sampler, mesh, batches, out, use_device="cpu"):
    PointBuffer = mod(pkg, "core.pointbuffer").PointBuffer
    AABB = mod(pkg, "core.aabb").AABB
    BinaryPersistence = mod(pkg, "io.bin_persistence").BinaryPersistence
    SamplingStrategy = mod(pkg, "ops.sampling").SamplingStrategy
    tiling = mod(pkg, "tiling")
    bounds = AABB(BMIN, BMAX)
    spacing = 2.0 if sampler == "JITTERED" else 6.0
    meta = tiling.TilerMetaParameters(
        spacing_at_root=spacing, max_points_per_node=300, concurrency=4,
        use_device=use_device)
    os.makedirs(out)
    sink = BinaryPersistence(str(out))
    if mesh is None:  # the single-device FAST run at the ownership level
        algo = tiling.make_tiling_algorithm(
            tiling.TilingStrategy.Fast, SamplingStrategy(sampler, 300), sink,
            meta)
        algo.level_of_start_nodes = 3
    else:
        algo = mod(pkg, "parallel.multidevice").TilingAlgorithmMultiDevice(
            SamplingStrategy(sampler, 300), sink, meta, mesh=mesh,
            ownership_level=3)
    for pos in batches:
        algo.process_batch(PointBuffer(pos.copy()), bounds)
    algo.finalize(bounds)
    sink.close()
    return algo


def bin_files(out) -> dict:
    files = {}
    for f in sorted(os.listdir(out)):
        with open(os.path.join(out, f), "rb") as fh:
            files[f] = fh.read()
    assert any(f.endswith(".bin") for f in files)
    return files


@pytest.mark.parametrize("sampler", ["RANDOM_GRID", "GRID_CENTER",
                                     "JITTERED", "MIN_DISTANCE"])
def test_multidevice_engine_equals_jax(on_cpu, monkeypatch, tmp_path,
                                       jax_mesh, mesh, sampler):
    """Batch 1 fills the lower octant (every point on shard 0), batch 2 the
    whole cube (fresh start nodes on every shard, revisits on shard 0): the
    port's multi-device BIN output is the JAX package's, byte for byte, and
    the port's single-device FAST host run's."""
    jax_sweep_program(monkeypatch, sampler)
    rng = np.random.default_rng(20260816)
    batches = [rng.uniform(0.0, 32.0, (5000, 3)),
               rng.uniform(0.0, 64.0, (5000, 3))]
    run_multidevice("schwarzwald_tpu", sampler, jax_mesh, batches,
                    tmp_path / "jax")
    algo = run_multidevice("schwarzwald_tpu_torch", sampler, mesh, batches,
                           tmp_path / "port")
    run_multidevice("schwarzwald_tpu_torch", sampler, None, batches,
                    tmp_path / "single", use_device=None)
    want = bin_files(tmp_path / "jax")
    assert bin_files(tmp_path / "port") == want
    assert bin_files(tmp_path / "single") == want
    grid = sampler != "MIN_DISTANCE"
    # one sweep per owner with fresh start nodes: shard 0 in batch 1,
    # all four in batch 2; the Poisson samplers have no sweep
    assert algo.device_sweeps_ok == (1 + N_DEV if grid else 0)
    assert algo.device_reroots == 0
    assert sum(algo.exchange.owned_points) == 10_000
    assert len(algo.exchange.route_seconds) == 2


# -- the CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("use_device", ["cpu", "host"])
def test_cli_multichip_equals_jax(tmp_path, use_device):
    """`--multichip 2` in the port writes the JAX CLI's `--multichip 2`
    tree byte for byte, and reports its shards."""
    src = tmp_path / "in.las"
    write_las(src, 6000, 11)
    base = ["--tiler", "-i", str(src), "--spacing", "6", "--sampling",
            "RANDOM_GRID", "--output-format", "BIN", "--multichip", "2"]
    assert cli("schwarzwald_tpu", base + ["-o", str(tmp_path / "jax")]) == 0
    assert cli("schwarzwald_tpu_torch",
               base + ["-o", str(tmp_path / "port"), "--use-device",
                       use_device]) == 0
    assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_tiler_process_reports_shards(tmp_path):
    src = tmp_path / "in.las"
    write_las(src, 6000, 12)
    tp = mod("schwarzwald_tpu_torch", "process.tiler_process")
    proc = tp.TilerProcess(tp.TilerArguments(
        sources=[str(src)], output_directory=str(tmp_path / "out"),
        spacing=6.0, sampling_strategy="RANDOM_GRID", use_device="cpu",
        multichip=3))
    proc.run()
    stats = proc.device_stats
    assert stats["shards"] == 3 and stats["cards"] == 0
    assert sum(stats["points_per_shard"]) == 6000
    assert len(stats["exchange_s"]) >= 1
    assert stats["device_sweeps_ok"] >= 1

"""The port's multi-host layer (`--multihost`) against the JAX package on the
CPU: the planning functions, the bounds all-gather over two gloo ranks, and
whole runs of two or three "hosts" (threads of one process, or CLI
subprocesses) sharing an output directory, whose trees must be the JAX
package's byte for byte."""
import importlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
from schwarzwald_tpu.parallel import multihost as jax_multihost
from schwarzwald_tpu_torch.core.aabb import AABB
from schwarzwald_tpu_torch.parallel import multihost, plan_multihost_tiling

from test_torch_slice import assert_same_tree, cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDS_EXTENT = 100.0
JOIN_S = 600


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- planning (tests/test_multihost.py) ------------------------------------------

def test_assign_files_partition_is_complete_and_disjoint():
    files = [(f"f{i}.las", (i + 1) * 1000) for i in range(10)]
    parts = [multihost.assign_files(files, p, 3) for p in range(3)]
    assert parts == [jax_multihost.assign_files(files, p, 3)
                     for p in range(3)]
    all_assigned = [f for part in parts for f in part]
    assert sorted(all_assigned) == sorted(f for f, _ in files)
    assert len(set(all_assigned)) == 10
    loads = [sum(c for f, c in files if f in part) for part in parts]
    assert max(loads) <= 2 * min(loads)


def test_assign_files_deterministic():
    files = [(f"f{i}.las", 100) for i in range(7)]
    assert multihost.assign_files(files, 1, 4) \
        == multihost.assign_files(files, 1, 4) \
        == jax_multihost.assign_files(files, 1, 4)


def test_owned_node_blocks_cover_level():
    total = 8 ** 3
    blocks = [multihost.owned_node_block(p, 5, 3) for p in range(5)]
    assert blocks == [jax_multihost.owned_node_block(p, 5, 3)
                      for p in range(5)]
    assert blocks[0][0] == 0 and blocks[-1][1] == total
    for (a, b), (c, d) in zip(blocks, blocks[1:]):
        assert b == c


def same_plan(plan, jax_plan):
    assert plan.process_index == jax_plan.process_index
    assert plan.process_count == jax_plan.process_count
    assert plan.local_files == jax_plan.local_files
    assert plan.start_level == jax_plan.start_level
    assert plan.owned_node_range == jax_plan.owned_node_range
    np.testing.assert_array_equal(plan.global_bounds_cubic.min,
                                  jax_plan.global_bounds_cubic.min)
    np.testing.assert_array_equal(plan.global_bounds_cubic.max,
                                  jax_plan.global_bounds_cubic.max)


def test_plan_single_process():
    from schwarzwald_tpu.core.aabb import AABB as JaxAABB

    files = [("a.las", 100), ("b.las", 300)]
    plan = plan_multihost_tiling(files, AABB([0, 0, 0], [10, 20, 5]),
                                 start_level=3, process_index=0,
                                 process_count=1)
    same_plan(plan, jax_multihost.plan_multihost_tiling(
        files, JaxAABB([0, 0, 0], [10, 20, 5]), start_level=3,
        process_index=0, process_count=1))
    assert sorted(plan.local_files) == ["a.las", "b.las"]
    ext = plan.global_bounds_cubic.extent()
    assert ext[0] == ext[1] == ext[2] == 20
    assert plan.owned_node_range == (0, 512)


def test_plan_multi_process_split():
    from schwarzwald_tpu.core.aabb import AABB as JaxAABB

    files = [(f"f{i}.las", 100) for i in range(8)]
    plans = [plan_multihost_tiling(files, AABB([0, 0, 0], [8, 8, 8]),
                                   start_level=2, process_index=p,
                                   process_count=4) for p in range(4)]
    for p, plan in enumerate(plans):
        same_plan(plan, jax_multihost.plan_multihost_tiling(
            files, JaxAABB([0, 0, 0], [8, 8, 8]), start_level=2,
            process_index=p, process_count=4))
    covered = [f for p in plans for f in p.local_files]
    assert sorted(covered) == sorted(f for f, _ in files)
    assert plans[0].owned_node_range == (0, 16)
    assert plans[3].owned_node_range == (48, 64)


def test_planning_never_initializes_a_backend(monkeypatch):
    """Planning with explicit indices, and the bounds all-gather without a
    process group, start no process group and never touch CUDA; the
    implicit-index path falls back to a single process."""
    import torch.distributed as dist

    def wedged(*a, **k):
        raise AssertionError("a backend was touched during planning")

    monkeypatch.setattr(dist, "init_process_group", wedged)
    monkeypatch.setattr(torch.cuda, "_lazy_init", wedged)
    monkeypatch.setattr(torch.cuda, "init", wedged)

    bounds = AABB([0, 0, 0], [10, 10, 20])
    assert multihost.all_reduce_bounds(bounds).extent()[2] == 20
    plan = plan_multihost_tiling([("a.las", 5)], bounds, start_level=3,
                                 process_index=1, process_count=2)
    assert plan.process_index == 1 and plan.process_count == 2
    plan = plan_multihost_tiling([("a.las", 5)], bounds, start_level=3)
    assert (plan.process_index, plan.process_count) == (0, 1)
    assert not dist.is_initialized()
    assert not torch.cuda.is_initialized()


# -- the bounds all-gather over two gloo ranks ---------------------------------------

RANK_SCRIPT = """
import datetime, json, sys
import torch.distributed as dist
from schwarzwald_tpu_torch.core.aabb import AABB
from schwarzwald_tpu_torch.parallel import multihost

rank, store_path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group(
    "gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2,
    timeout=datetime.timedelta(seconds=60))
local = AABB([rank, 0.5, -rank], [10.0 + rank, 5.0, 1.0 - rank])
union = multihost.all_reduce_bounds(local)
plan = multihost.plan_multihost_tiling(
    [("a.las", 5), ("b.las", 7)], local, start_level=3)
print(json.dumps({"min": union.min.tolist(), "max": union.max.tolist(),
                  "index": plan.process_index, "count": plan.process_count,
                  "cubic_min": plan.global_bounds_cubic.min.tolist(),
                  "cubic_max": plan.global_bounds_cubic.max.tolist()}))
dist.destroy_process_group()
"""


def stop(procs) -> None:
    """Kill what is still running of `procs` (a rank or host that failed
    leaves the other waiting)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_all_reduce_bounds_over_two_gloo_ranks(tmp_path):
    """Two processes in one gloo group, met through a FileStore (no
    network; gloo's pair sockets on the loopback): each gets the union of
    both ranks' bounds, and planning takes its rank and the world size from
    the group."""
    env = dict(os.environ, PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r),
                               store], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outputs = [p.communicate(timeout=120) for p in procs]
    finally:
        stop(procs)
    results = []
    for p, (out, err) in zip(procs, outputs):
        assert p.returncode == 0, err[-2000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    for rank, r in enumerate(results):
        assert r["min"] == [0.0, 0.5, -1.0] and r["max"] == [11.0, 5.0, 1.0]
        assert (r["index"], r["count"]) == (rank, 2)
        assert r["cubic_min"] == results[0]["cubic_min"]
        assert r["cubic_max"] == results[0]["cubic_max"]


# -- whole runs: hosts as threads ----------------------------------------------------

def write_parts(tmp_path, n_files, n, seed):
    """`n_files` LAS files of `n` uniform points each (with intensities),
    from one numpy seed."""
    from schwarzwald_tpu.core.attributes import PointAttribute
    from schwarzwald_tpu.core.aabb import AABB as JaxAABB
    from schwarzwald_tpu.core.pointbuffer import PointBuffer
    from schwarzwald_tpu.io import las

    rng = np.random.default_rng(seed)
    files = []
    for i in range(n_files):
        buf = PointBuffer(rng.uniform(1.0, BOUNDS_EXTENT - 1, (n, 3)))
        buf.set_column(PointAttribute.Intensity,
                       rng.integers(0, 65535, n, dtype=np.uint16))
        path = tmp_path / f"part{i}.las"
        las.write_las(str(path), buf, JaxAABB([0.0] * 3, [BOUNDS_EXTENT] * 3))
        files.append(str(path))
    return files


def run_hosts(pkg, files, out, count, delay_s=0.0, **kw):
    """`count` TilerProcess hosts of `pkg` in threads, host 0 first (and
    `delay_s` before the others)."""
    tp = mod(pkg, "process.tiler_process")
    fmt = mod(pkg, "core.attributes").OutputFormat(kw.pop("fmt", "BIN"))
    errors = []

    def host(index):
        try:
            tp.TilerProcess(tp.TilerArguments(
                sources=files, output_directory=str(out), spacing=5.0,
                max_points_per_node=400, sampling_strategy="RANDOM_GRID",
                output_format=fmt, multihost_index=index,
                multihost_count=count, **kw)).run()
        except BaseException as err:  # surfaced in the main thread
            errors.append((index, err))

    threads = [threading.Thread(target=host, args=(i,)) for i in range(count)]
    threads[0].start()
    time.sleep(delay_s)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert not os.path.exists(os.path.join(out, ".mh-exchange"))


@pytest.mark.parametrize("hosts,fmt,multichip", [
    (2, "BIN", 0), (3, "ENTWINE_LAS", 0), (2, "BIN", 2)])
@pytest.mark.parametrize("use_device", ["host", "cpu"])
def test_hosts_as_threads_equal_jax(tmp_path, hosts, fmt, multichip,
                                    use_device):
    """TilerProcess hosts; with `multichip` each host's own points fan out
    over its shards (the composition of parallel/multihost.py)."""
    files = write_parts(tmp_path, hosts + 1, 3000, 21)
    run_hosts("schwarzwald_tpu", files, tmp_path / "jax", hosts, fmt=fmt,
              fixed_start_level=3, multichip=multichip)
    run_hosts("schwarzwald_tpu_torch", files, tmp_path / "port", hosts,
              fmt=fmt, fixed_start_level=3, use_device=use_device,
              multichip=multichip)
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    if fmt == "ENTWINE_LAS":
        with open(tmp_path / "port" / "ept.json") as f:
            assert json.load(f)["points"] == (hosts + 1) * 3000


def test_stale_exchange_leftovers_do_not_corrupt_rerun(tmp_path):
    """A crashed run's markers and a spill of 4 bogus points in
    `.mh-exchange/` (tests/test_multihost_e2e.py:100): the port's rerun
    ingests none of it and writes the JAX package's clean tree."""
    from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
    from schwarzwald_tpu_torch.io.bin_persistence import BinaryPersistence

    files = write_parts(tmp_path, 2, 3000, 22)
    run_hosts("schwarzwald_tpu", files, tmp_path / "jax", 2)
    out = tmp_path / "port"
    stale = out / ".mh-exchange"
    (stale / "deadbeef" / "to_0").mkdir(parents=True)
    (stale / "prepared_0").write_text("deadbeef")
    (stale / "deadbeef" / "spills_done_0").touch()
    (stale / "deadbeef" / "spills_done_1").touch()
    BinaryPersistence(str(stale / "deadbeef" / "to_0")).persist_points(
        PointBuffer(np.random.default_rng(1).uniform(1, 99, (4, 3))),
        AABB([0.0] * 3, [BOUNDS_EXTENT] * 3), "from1_000000")
    run_hosts("schwarzwald_tpu_torch", files, out, 2, delay_s=1.0,
              use_device="host")
    assert_same_tree(tmp_path / "jax", out)


# -- the distributed finalize ----------------------------------------------------------

def run_owned_blocks(pkg, pts, out, sink_name, single=False):
    """Each of two hosts fed exactly the points of its owned level-3 block
    (tests/test_multihost_e2e.py:330), or with `single` one FAST host at
    level 3. Returns each host's reconstructed-node count."""
    PointBuffer = mod(pkg, "core.pointbuffer").PointBuffer
    AABB_ = mod(pkg, "core.aabb").AABB
    sinks = {"BIN": (mod(pkg, "io.bin_persistence"), "BinaryPersistence"),
             "LAS": (mod(pkg, "io.las_persistence"), "LASPersistence")}
    module, name = sinks[sink_name]
    Sink = getattr(module, name)
    SamplingStrategy = mod(pkg, "ops.sampling").SamplingStrategy
    tiling = mod(pkg, "tiling")
    mh = mod(pkg, "parallel.multihost")
    bounds = AABB_([0.0] * 3, [BOUNDS_EXTENT] * 3)
    meta = tiling.TilerMetaParameters(spacing_at_root=5.0,
                                      max_points_per_node=400,
                                      cache_size_bytes=1 << 26)
    os.makedirs(out)
    if single:
        algo = tiling.make_tiling_algorithm(
            tiling.TilingStrategy.Fast, SamplingStrategy("RANDOM_GRID", 400),
            Sink(str(out)), meta)
        algo.level_of_start_nodes = 3
        algo.process_batch(PointBuffer(pts.copy()), bounds)
        algo.finalize(bounds)
        algo.persistence.close()
        return {}
    indexing = mod(pkg, "ops.indexing")
    morton = mod(pkg, "core.morton")
    keys, _ = indexing.index_points(pts.copy(), bounds.min, bounds.max)
    level3 = morton.truncate_to_level(keys, 2)
    lo1 = mh.owned_node_block(1, 2, 3)[0]
    parts = {0: pts[level3 < lo1], 1: pts[level3 >= lo1]}
    counters, errors = {}, []

    def host(index):
        try:
            coord = mh.MultiHostCoordinator(str(out), index, 2, timeout=300.0)
            plan = mh.MultiHostPlan(
                process_index=index, process_count=2, local_files=[],
                global_bounds_cubic=bounds, start_level=3,
                owned_node_range=mh.owned_node_block(index, 2, 3))
            algo = mh.TilingAlgorithmMultiHost(
                SamplingStrategy("RANDOM_GRID", 400), Sink(str(out)), meta,
                plan, coord)
            algo.process_batch(PointBuffer(parts[index].copy()), bounds)
            algo.finalize(bounds)
            algo.inner.persistence.close()
            counters[index] = algo.reconstructed_nodes
        except BaseException as err:
            errors.append((index, err))

    threads = [threading.Thread(target=host, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return counters


def file_bytes(d) -> dict:
    out = {}
    for f in sorted(os.listdir(d)):
        if f.endswith(".bin") or f.endswith(".las"):
            with open(os.path.join(d, f), "rb") as fh:
                out[f] = fh.read()
    assert out
    return out


@pytest.mark.parametrize("sink", ["BIN", "LAS"])
def test_distributed_finalize_byte_identity(tmp_path, sink):
    """Both hosts rebuild a share of the ancestors, together exactly the
    single host's; the tree is the single-host run's and the JAX package's
    two-host tree, file for file, byte for byte (LAS: ancestors re-sampled
    from quantized children)."""
    pts = np.random.default_rng(23).uniform(1.0, BOUNDS_EXTENT - 1,
                                            (30_000, 3))
    counters = run_owned_blocks("schwarzwald_tpu_torch", pts,
                                tmp_path / "multi", sink)
    run_owned_blocks("schwarzwald_tpu_torch", pts, tmp_path / "single", sink,
                     single=True)
    run_owned_blocks("schwarzwald_tpu", pts, tmp_path / "jax", sink)
    assert counters[0] > 0 and counters[1] > 0
    multi = file_bytes(tmp_path / "multi")
    ancestors = sum(1 for f in multi if len(f.split(".")[0]) - 1 < 3)
    assert counters[0] + counters[1] == ancestors
    assert multi == file_bytes(tmp_path / "single")
    assert multi == file_bytes(tmp_path / "jax")


# -- multihost x multichip -----------------------------------------------------------

@pytest.mark.parametrize("use_device", [None, "cpu"])
def test_multihost_with_multichip_inner(tmp_path, use_device):
    """Each host's owned points fan out over its own 2 CPU shards, striped
    over the host's owned cells (tests/test_multidevice.py:185): the tree is
    the JAX package's with its 2-device CPU mesh, byte for byte, and
    conserves every point at and below the ownership level."""
    from schwarzwald_tpu.parallel.multidevice import make_mesh as jax_mesh

    n = 8000
    pos = np.random.default_rng(24).uniform(0.0, BOUNDS_EXTENT, (n, 3))
    halves = [pos[: n // 2], pos[n // 2:]]

    def run(pkg, out, mesh, device):
        PointBuffer = mod(pkg, "core.pointbuffer").PointBuffer
        AABB_ = mod(pkg, "core.aabb").AABB
        BinaryPersistence = mod(pkg, "io.bin_persistence").BinaryPersistence
        SamplingStrategy = mod(pkg, "ops.sampling").SamplingStrategy
        tiling = mod(pkg, "tiling")
        mh = mod(pkg, "parallel.multihost")
        md = mod(pkg, "parallel.multidevice")
        bounds = AABB_([0.0] * 3, [BOUNDS_EXTENT] * 3)
        meta = tiling.TilerMetaParameters(
            spacing_at_root=6.0, max_points_per_node=300, concurrency=4,
            use_device=device)
        os.makedirs(out)
        errors, shards = [], {}

        def host(index):
            try:
                coord = mh.MultiHostCoordinator(str(out), index, 2,
                                                timeout=300.0)
                plan = mh.plan_multihost_tiling(
                    [("a", n // 2), ("b", n // 2)], bounds, start_level=3,
                    process_index=index, process_count=2)
                sink = BinaryPersistence(str(out))
                inner = md.TilingAlgorithmMultiDevice(
                    SamplingStrategy("RANDOM_GRID", 300), sink, meta,
                    mesh=mesh, ownership_level=3,
                    cell_range=plan.owned_node_range)
                algo = mh.TilingAlgorithmMultiHost(
                    SamplingStrategy("RANDOM_GRID", 300), sink, meta, plan,
                    coord, inner=inner)
                algo.process_batch(PointBuffer(halves[index].copy()), bounds)
                algo.finalize(bounds)
                shards[index] = list(getattr(inner.exchange,
                                             "owned_points", []))
            except BaseException as err:
                errors.append((index, err))

        threads = [threading.Thread(target=host, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
        return shards

    run("schwarzwald_tpu", tmp_path / "jax", jax_mesh(2, backend="cpu"),
        None)
    shards = run("schwarzwald_tpu_torch", tmp_path / "port",
                 [torch.device("cpu")] * 2, use_device)
    got = file_bytes(tmp_path / "port")
    assert got == file_bytes(tmp_path / "jax")
    # both of each host's shards owned points of its block
    assert all(len(s) == 2 and all(s) for s in shards.values())
    from schwarzwald_tpu_torch.io.bin_persistence import BinaryPersistence
    sink = BinaryPersistence(str(tmp_path / "port"))
    deep = sum(sink.retrieve_points(f[:-4]).count for f in got
               if len(f[:-4]) - 1 >= 3)
    assert deep == n
    assert "r.bin" in got


# -- two CLI subprocesses ------------------------------------------------------------

def test_two_host_cli_subprocesses(tmp_path):
    """Two processes through the port's CLI with `--use-device cpu`, met
    only through the output directory: the tree of the JAX CLI's two hosts
    (threads of this process), byte for byte."""
    files = write_parts(tmp_path, 2, 3000, 25)

    def argv(out, index):
        return ["--tiler", "-i", *files, "-o", str(out), "--spacing", "5",
                "--max-points-per-node", "400", "--sampling", "RANDOM_GRID",
                "--output-format", "BIN", "--multihost", str(index), "2"]

    out = tmp_path / "port"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "schwarzwald_tpu_torch.cli", *argv(out, i),
         "--use-device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=ROOT, SCHWARZWALD_TPU_NO_UI="1"))
        for i in range(2)]
    try:
        outputs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        stop(procs)
    for p, text in zip(procs, outputs):
        assert p.returncode == 0, text[-2000:]

    errors = []

    def jax_host(index):
        try:
            assert cli("schwarzwald_tpu", argv(tmp_path / "jax", index)) == 0
        except BaseException as err:
            errors.append((index, err))

    threads = [threading.Thread(target=jax_host, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    assert_same_tree(tmp_path / "jax", out)
    assert not os.path.exists(out / ".mh-exchange")

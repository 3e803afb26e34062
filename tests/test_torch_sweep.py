"""The port's octree sweep (schwarzwald_tpu_torch/ops/device_tiling.py) and
its engine wiring against the JAX package on the CPU: the int8 levels of
octree_select_grid for the three grid samplers, the engine node for node
(FAST and ACCURATE, device and host), and the CLI byte for byte. Every
comparison is exact.

The JAX engine and CLI runs of RANDOM_GRID and GRID_CENTER use
SCHWARZWALD_SWEEP_MODE=while, the JAX package's fast-compiling sweep
program, which its own tests hold bit for bit against the unrolled one
(tests/test_device_tiling.py). JITTERED runs use the unrolled program: on
the clustered CLI input below the while program's levels differ from the
host run's (the unrolled program and the port equal it). The direct sweep
comparisons use the unrolled octree_select_grid itself."""
import importlib

import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
import jax
import jax.numpy as jnp
from schwarzwald_tpu.ops import device_tiling as jax_tiling
from schwarzwald_tpu.ops import indexing
from schwarzwald_tpu_torch.ops import device_tiling

from test_torch_slice import assert_same_tree, cli

torch.set_num_threads(1)

EXTENT = 64.0
BMIN = np.zeros(3)
BMAX = np.full(3, EXTENT)


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def jax_sweep_program(monkeypatch, sampler: str) -> None:
    """The JAX engine's sweep program for `sampler` (module docstring)."""
    monkeypatch.setenv("SCHWARZWALD_SWEEP_MODE",
                       "unrolled" if sampler == "JITTERED" else "while")


# -- the sweep: int8 levels ----------------------------------------------------

def sorted_batch(pos):
    keys, cpos = indexing.index_points(pos.copy(), BMIN, BMAX)
    order = indexing.sort_by_key(keys)
    return keys[order], cpos[order]


def both_sweeps(skeys, spos, strategy, spacing, max_points, max_depth=100,
                min_node_level=-1):
    """(JAX levels, port levels) of the same sorted batch."""
    cands = tuple(jax_tiling.candidate_levels(EXTENT, spacing, max_depth))
    assert list(cands) == device_tiling.candidate_levels(EXTENT, spacing,
                                                         max_depth)
    jkw = dict(strategy=strategy, min_node_level=min_node_level)
    tkw = dict(jkw)
    if strategy != "RANDOM_GRID":
        jkw.update(positions=jnp.asarray(spos), root_min=jnp.asarray(BMIN),
                   root_max=jnp.asarray(BMAX))
        tkw.update(positions=torch.from_numpy(spos), root_min=list(BMIN),
                   root_max=list(BMAX))
    if strategy == "JITTERED":
        jkw["jit_cfgs"] = jax_tiling.jittered_static_configs(
            EXTENT, spacing, max_depth)
        tkw["jit_cfgs"] = device_tiling.jittered_static_configs(
            EXTENT, spacing, max_depth)
        assert tkw["jit_cfgs"] == jkw["jit_cfgs"]
    hi = (skeys >> np.uint64(32)).astype(np.uint32)
    lo = skeys.astype(np.uint32)
    want = np.asarray(jax_tiling.octree_select_grid(
        jnp.asarray(hi), jnp.asarray(lo), cands, max_points, max_depth,
        **jkw))
    got = device_tiling.octree_select_grid(
        device_tiling.keys_tensor(skeys, "cpu"), list(cands), max_points,
        max_depth, **tkw)
    assert got.dtype == torch.int8
    return want, got.numpy()


# tests/test_device_tiling.py:57-207, plus a FAST start level and a deep
# tree whose cells need more than the hi word (3 * groups > 31)
SWEEP_CASES = {
    # name: (strategy, n, spacing, max_points, max_depth, min_node_level,
    #        extent of the uniform cloud)
    "random_grid_20000": ("RANDOM_GRID", 20000, 8.0, 300, 100, -1, EXTENT),
    "random_grid_5000": ("RANDOM_GRID", 5000, 8.0, 100, 100, -1, EXTENT),
    "random_grid_coarse": ("RANDOM_GRID", 20000, 40.0, 50, 100, -1, EXTENT),
    "random_grid_takeall": ("RANDOM_GRID", 3000, 8.0, 10000, 100, -1,
                            EXTENT),
    "random_grid_max_depth3": ("RANDOM_GRID", 5000, 8.0, 50, 3, -1, EXTENT),
    "random_grid_start_level2": ("RANDOM_GRID", 12000, 6.0, 300, 100, 1,
                                 EXTENT),
    "random_grid_deep": ("RANDOM_GRID", 6000, 0.05, 50, 100, 2, 4.0),
    "grid_center_8000": ("GRID_CENTER", 8000, 8.0, 200, 100, -1, EXTENT),
    "grid_center_start_level2": ("GRID_CENTER", 8000, 2.0, 100, 100, 1,
                                 EXTENT),
    "jittered_8000": ("JITTERED", 8000, 2.0, 100, 100, -1, EXTENT),
    "jittered_max_depth3": ("JITTERED", 6000, 2.0, 50, 3, -1, EXTENT),
}


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_sweep_levels_equal_jax(on_cpu, case):
    strategy, n, spacing, max_points, max_depth, minlv, ext = \
        SWEEP_CASES[case]
    pos = np.random.default_rng(20260816).uniform(0.0, ext, (n, 3))
    skeys, spos = sorted_batch(pos)
    want, got = both_sweeps(skeys, spos, strategy, spacing, max_points,
                            max_depth, minlv)
    np.testing.assert_array_equal(got, want)
    assert (want > 0).any()
    if strategy != "JITTERED":
        assert (want > 0).all()
    if case == "random_grid_deep":
        # assigned at cells of 12+ octant digits: bits of JAX's lo word
        assert want.max() - 2 >= 2 and device_tiling.candidate_levels(
            EXTENT, spacing, max_depth)[minlv + 1] + 1 > 10


def test_sweep_reroot_leaves_points_unassigned(on_cpu):
    """A cluster whose candidate levels pass the 21-level Morton range:
    both sweeps stop and leave the same points at 0."""
    center = np.array([10.0, 20.0, 30.0])
    pos = center + np.random.default_rng(5).uniform(0, 1e-4, (3000, 3))
    skeys, spos = sorted_batch(pos)
    want, got = both_sweeps(skeys, spos, "RANDOM_GRID", EXTENT / 2 ** 18,
                            100)
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any()


def test_segment_helpers_equal_jax(on_cpu):
    """_segment_fields and _segment_min on random segmentations."""
    rng = np.random.default_rng(11)
    n = 4000
    first = rng.random(n) < 0.05
    first[0] = True
    remaining = rng.random(n) < 0.7
    values = np.where(remaining, rng.random(n), np.inf)
    iota = np.arange(n)
    jf = [np.asarray(a) for a in jax.jit(jax_tiling._segment_fields)(
        jnp.asarray(first), jnp.asarray(remaining),
        jnp.asarray(iota, jnp.int32))]
    tf = [a.numpy() for a in device_tiling._segment_fields(
        torch.from_numpy(first), torch.from_numpy(remaining),
        torch.from_numpy(iota))]
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(
        device_tiling._segment_min(torch.from_numpy(first),
                                   torch.from_numpy(values)).numpy(),
        np.asarray(jax.jit(jax_tiling._segment_min)(jnp.asarray(first),
                                                    jnp.asarray(values))))


@pytest.mark.parametrize("groups", [0, 1, 10, 11, 17, 21])
def test_first_in_cell_equals_jax(on_cpu, groups):
    """Cell starts from the int64 key, including cell ids that take bits
    of JAX's lo word (groups >= 11)."""
    rng = np.random.default_rng(12)
    skeys, _ = sorted_batch(np.concatenate(
        [rng.uniform(0.0, EXTENT, (2000, 3)),
         rng.uniform(0.0, 1e-3, (1000, 3))]))
    hi = (skeys >> np.uint64(32)).astype(np.uint32)
    lo = skeys.astype(np.uint32)
    want = np.asarray(jax_tiling._first_in_cell(jnp.asarray(hi),
                                                jnp.asarray(lo), groups))
    got = device_tiling._first_in_cell(
        device_tiling.keys_tensor(skeys, "cpu"), groups).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 1 or groups == 0


# -- the engine: node for node ---------------------------------------------------

def run_engine(pkg, tiling, sampler, use_device, batches, spacing=6.0,
               max_points=300, start_level=3, group_points=None,
               bounds_extent=EXTENT, concurrency=4):
    PointBuffer = mod(pkg, "core.pointbuffer").PointBuffer
    AABB = mod(pkg, "core.aabb").AABB
    MemoryPersistence = mod(pkg, "io.memory").MemoryPersistence
    SamplingStrategy = mod(pkg, "ops.sampling").SamplingStrategy
    tiling_mod = mod(pkg, "tiling")
    bounds = AABB([0.0] * 3, [bounds_extent] * 3)
    persistence = MemoryPersistence()
    meta = tiling_mod.TilerMetaParameters(
        spacing_at_root=spacing, max_points_per_node=max_points,
        concurrency=concurrency, use_device=use_device)
    algo = tiling_mod.make_tiling_algorithm(
        tiling_mod.TilingStrategy(tiling),
        SamplingStrategy(sampler, max_points), persistence, meta)
    if tiling == "FAST":
        algo.level_of_start_nodes = start_level
    if group_points is not None:
        algo.DEVICE_SWEEP_GROUP_POINTS = group_points
    for pos in batches:
        algo.process_batch(PointBuffer(pos.copy()), bounds)
    algo.finalize(bounds)
    nodes = {name: persistence.retrieve_points(name).positions
             for name in persistence.node_names()}
    return algo, nodes


def assert_same_nodes(got: dict, want: dict):
    assert set(got) == set(want)
    for name, positions in want.items():
        np.testing.assert_array_equal(got[name], positions, err_msg=name)


def engine_four_ways(tiling, sampler, batches, **kw):
    """JAX host, JAX device (cpu), port host and port device (cpu): all
    four must persist the same nodes. Returns the port's device engine."""
    _, jax_host = run_engine("schwarzwald_tpu", tiling, sampler, None,
                             batches, **kw)
    jax_algo, jax_dev = run_engine("schwarzwald_tpu", tiling, sampler, "cpu",
                                   batches, **kw)
    _, port_host = run_engine("schwarzwald_tpu_torch", tiling, sampler, None,
                              batches, **kw)
    port_algo, port_dev = run_engine("schwarzwald_tpu_torch", tiling, sampler,
                                     "cpu", batches, **kw)
    assert jax_algo.device_fallbacks == 0
    for other in (jax_dev, port_host, port_dev):
        assert_same_nodes(other, jax_host)
    return port_algo


@pytest.mark.parametrize("tiling", ["FAST", "ACCURATE"])
@pytest.mark.parametrize("sampler", ["RANDOM_GRID", "GRID_CENTER",
                                     "JITTERED"])
def test_engine_port_equals_jax(on_cpu, monkeypatch, tiling, sampler):
    """Batch 1 fills the lower half (fresh: the device sweep), batch 2
    revisits it and opens fresh start nodes in the upper half
    (tests/test_device_tiling.py:211-294)."""
    jax_sweep_program(monkeypatch, sampler)
    rng = np.random.default_rng(20260816)
    batches = [rng.uniform(0.0, 32.0, (5000, 3)),
               rng.uniform(0.0, 64.0, (5000, 3))]
    spacing = 2.0 if sampler == "JITTERED" else 6.0
    algo = engine_four_ways(tiling, sampler, batches, spacing=spacing)
    # FAST sweeps the fresh start nodes of both batches; ACCURATE the
    # first batch from the root (its second batch is a host revisit)
    assert algo.device_sweeps_ok == (2 if tiling == "FAST" else 1)
    assert algo.device_reroots == 0


@pytest.mark.parametrize("tiling", ["FAST", "ACCURATE"])
def test_engine_reroot_depths_go_to_the_host(on_cpu, monkeypatch, tiling):
    """A cluster forcing candidate levels past the 21-level Morton range
    (tests/test_device_tiling.py:297): the sweep leaves points at 0, the
    engine counts it and tiles the range on the host, equal to the host
    run, for the fresh first batch and the revisit batch."""
    jax_sweep_program(monkeypatch, "RANDOM_GRID")
    rng = np.random.default_rng(3)
    center = np.array([10.0, 20.0, 30.0])
    batches = [center + rng.uniform(0, 1e-4, (3000, 3)) for _ in range(2)]
    algo = engine_four_ways(tiling, "RANDOM_GRID", batches,
                            spacing=EXTENT / 2 ** 18, max_points=100)
    assert algo.device_reroots == 1
    assert algo.device_sweeps_ok == 0


def test_engine_pipelined_groups_equal_one_sweep(on_cpu, monkeypatch):
    """Many small pipelined groups persist exactly what one sweep and the
    host run persist (tests/test_device_tiling.py:329)."""
    pos = [np.random.default_rng(4).uniform(0.0, 64.0, (12_000, 3))]
    _, host = run_engine("schwarzwald_tpu", "FAST", "RANDOM_GRID", None, pos,
                         start_level=2)
    single_algo, single = run_engine("schwarzwald_tpu_torch", "FAST",
                                     "RANDOM_GRID", "cpu", pos,
                                     start_level=2, group_points=10 ** 9)
    port_fast = mod("schwarzwald_tpu_torch", "tiling.engine")
    monkeypatch.setattr(port_fast.TilingAlgorithmFast,
                        "DEVICE_SWEEP_GROUP_POINTS", 1_000)
    multi_algo, multi = run_engine("schwarzwald_tpu_torch", "FAST",
                                   "RANDOM_GRID", "cpu", pos, start_level=2)
    assert single_algo.device_sweeps_ok == 1
    assert multi_algo.device_sweeps_ok >= 3
    assert multi_algo.device_reroots == 0
    assert_same_nodes(single, host)
    assert_same_nodes(multi, host)


@pytest.mark.parametrize("sampler", ["RANDOM_GRID", "GRID_CENTER"])
def test_engine_deep_tree_assigned_on_the_device(on_cpu, monkeypatch,
                                                 sampler):
    """Tiny spacing and node capacity drive assignments deep past the hi
    word's 10-level reach (tests/test_device_tiling.py:375). The JAX
    package's hi-only upload sends such RANDOM_GRID groups to the host;
    the port keeps int64 keys and assigns them on the device, and the
    persisted nodes are the same."""
    jax_sweep_program(monkeypatch, sampler)
    pos = [np.random.default_rng(6).uniform(0.0, 4.0, (6000, 3))]
    _, jax_host = run_engine("schwarzwald_tpu", "FAST", sampler, None, pos,
                             spacing=0.05, max_points=50, concurrency=2)
    _, jax_dev = run_engine("schwarzwald_tpu", "FAST", sampler, "cpu", pos,
                            spacing=0.05, max_points=50, concurrency=2)
    algo, port_dev = run_engine("schwarzwald_tpu_torch", "FAST", sampler,
                                "cpu", pos, spacing=0.05, max_points=50,
                                concurrency=2)
    assert algo.device_sweeps_ok == 1 and algo.device_reroots == 0
    assert_same_nodes(jax_dev, jax_host)
    assert_same_nodes(port_dev, jax_host)


def test_engine_min_distance_keeps_its_route(on_cpu):
    """The Poisson samplers have no sweep: under --use-device their fresh
    start nodes go to the per-node recursion, as before."""
    pos = [np.random.default_rng(7).uniform(0.0, 64.0, (6000, 3))]
    algo, nodes = run_engine("schwarzwald_tpu_torch", "FAST", "MIN_DISTANCE",
                             "cpu", pos, start_level=1)
    _, host = run_engine("schwarzwald_tpu_torch", "FAST", "MIN_DISTANCE",
                         None, pos, start_level=1)
    assert algo.device_sweeps_ok == 0 and algo.device_reroots == 0
    assert_same_nodes(nodes, host)


# -- the CLI: byte for byte ------------------------------------------------------

def write_clustered_las(path, n, seed, extent=100.0):
    las = mod("schwarzwald_tpu", "io.las")
    PointBuffer = mod("schwarzwald_tpu", "core.pointbuffer").PointBuffer
    AABB = mod("schwarzwald_tpu", "core.aabb").AABB
    rng = np.random.default_rng(seed)
    centers = rng.uniform(10.0, extent - 10.0, (6, 3))
    pos = np.concatenate([c + rng.normal(0.0, 2.0, (n // 6, 3))
                          for c in centers])
    las.write_las(str(path), PointBuffer(np.clip(pos, 1.0, extent - 1.0)),
                  AABB([0.0] * 3, [extent] * 3))


@pytest.mark.parametrize("sampler", ["RANDOM_GRID", "GRID_CENTER",
                                     "JITTERED"])
def test_cli_device_run_byte_identical(tmp_path, monkeypatch, sampler):
    """`--use-device cpu --sampling X` in the port writes the tree of the
    JAX CLI with the same arguments and of the host run."""
    jax_sweep_program(monkeypatch, sampler)
    src = tmp_path / "in.las"
    write_clustered_las(src, 30_000, 9)
    base = ["--tiler", "-i", str(src), "--sampling", sampler,
            "--max-points-per-node", "1000"]
    outs = {}
    for pkg, extra in (("schwarzwald_tpu", []),
                       ("schwarzwald_tpu", ["--use-device", "cpu"]),
                       ("schwarzwald_tpu_torch", ["--use-device", "cpu"])):
        out = tmp_path / f"{pkg}{len(extra)}"
        assert cli(pkg, base + ["-o", str(out)] + extra) == 0
        outs[(pkg, bool(extra))] = out
    ref = outs[("schwarzwald_tpu", False)]
    assert_same_tree(ref, outs[("schwarzwald_tpu", True)])
    assert_same_tree(ref, outs[("schwarzwald_tpu_torch", True)])


def test_tiler_process_reports_device_stats(tmp_path):
    """TilerProcess.device_stats counts the sweeps of a device run."""
    src = tmp_path / "in.las"
    write_clustered_las(src, 30_000, 10)
    tp = mod("schwarzwald_tpu_torch", "process.tiler_process")
    proc = tp.TilerProcess(tp.TilerArguments(
        sources=[str(src)], output_directory=str(tmp_path / "out"),
        diagonal_fraction=250, sampling_strategy="RANDOM_GRID",
        max_points_per_node=1000, use_device="cpu"))
    proc.run()
    assert proc.device_stats["device_sweeps_ok"] >= 1
    assert proc.device_stats["device_reroots"] == 0

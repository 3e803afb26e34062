"""The port's default tiler path against the JAX package, end to end on the
CPU: the engine node for node, the CLI byte for byte (the tiler and the
converter), a run interrupted in one package and resumed in the other, and
the port's refusals (no card, no `auto`). Every comparison is exact."""
import importlib
import json
import os

import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
import schwarzwald_tpu_torch  # noqa: F401
from schwarzwald_tpu_torch.ops import poisson_cuda

torch.set_num_threads(1)

PACKAGES = ("schwarzwald_tpu", "schwarzwald_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def write_las(path, n, seed, extent=100.0):
    las = mod("schwarzwald_tpu", "io.las")
    PointBuffer = mod("schwarzwald_tpu", "core.pointbuffer").PointBuffer
    AABB = mod("schwarzwald_tpu", "core.aabb").AABB
    rng = np.random.default_rng(seed)
    las.write_las(str(path), PointBuffer(rng.uniform(1, extent - 1, (n, 3))),
                  AABB([0.0] * 3, [extent] * 3))


def tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            full = os.path.join(d, f)
            with open(full, "rb") as fh:
                data = fh.read()
            rel = os.path.relpath(full, root)
            if rel == "properties.json":
                doc = json.loads(data)
                doc["performance_stats"].pop("prepare_duration")
                doc["performance_stats"].pop("indexing_duration")
                data = doc
            out[rel] = data
    return out


def assert_same_tree(a, b):
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        assert ta[rel] == tb[rel], rel
    assert any(rel.endswith((".pnts", ".bin", ".las")) for rel in ta)


# -- engine: node for node ---------------------------------------------------

BOUNDS_EXTENT = 64.0


def run_engine(pkg, tiling, sampler, use_device, pos):
    PointBuffer = mod(pkg, "core.pointbuffer").PointBuffer
    AABB = mod(pkg, "core.aabb").AABB
    MemoryPersistence = mod(pkg, "io.memory").MemoryPersistence
    SamplingStrategy = mod(pkg, "ops.sampling").SamplingStrategy
    tiling_mod = mod(pkg, "tiling")
    bounds = AABB([0.0] * 3, [BOUNDS_EXTENT] * 3)
    persistence = MemoryPersistence()
    meta = tiling_mod.TilerMetaParameters(
        spacing_at_root=1.0, max_points_per_node=500, concurrency=4,
        use_device=use_device)
    algo = tiling_mod.make_tiling_algorithm(
        tiling_mod.TilingStrategy(tiling), SamplingStrategy(sampler, 500),
        persistence, meta)
    if tiling == "FAST":
        # the points fill two octants: two start nodes of ~6000 points, each
        # sampled and large enough (>= 4096) for the device Poisson path,
        # and a root rebuilt at finalize from ~12000 points
        algo.level_of_start_nodes = 1
    algo.process_batch(PointBuffer(pos.copy()), bounds)
    algo.finalize(bounds)
    return {name: persistence.retrieve_points(name).positions
            for name in persistence.node_names()}


@pytest.mark.parametrize("tiling", ["FAST", "ACCURATE"])
@pytest.mark.parametrize("sampler", ["MIN_DISTANCE", "MIN_DISTANCE_FAST"])
def test_engine_port_equals_jax(on_cpu, tiling, sampler):
    half = BOUNDS_EXTENT / 2
    pos = np.random.default_rng(20260816).uniform(
        [0.0, 0.0, 0.0], [BOUNDS_EXTENT, half, half], (12_000, 3))
    jax_host = run_engine("schwarzwald_tpu", tiling, sampler, None, pos)
    jax_dev = run_engine("schwarzwald_tpu", tiling, sampler, "cpu", pos)
    port_host = run_engine("schwarzwald_tpu_torch", tiling, sampler, None,
                           pos)
    poisson_cuda.reset_counters()
    port_dev = run_engine("schwarzwald_tpu_torch", tiling, sampler, "cpu",
                          pos)
    counts = poisson_cuda.snapshot()
    if tiling == "FAST":
        # the fresh start nodes and the root went through the plain-torch
        # version of the kernel
        assert counts["plain"] == 3, counts
    assert counts["launches"] == 0
    for other in (jax_dev, port_host, port_dev):
        assert set(other) == set(jax_host)
        for name, want in jax_host.items():
            np.testing.assert_array_equal(other[name], want, err_msg=name)


# -- CLI: byte for byte --------------------------------------------------------

def cli(pkg, argv):
    return mod(pkg, "cli").main(argv)


def test_cli_default_run_byte_identical(tmp_path):
    """The JAX CLI's default run (the native host run) is the port's
    `--use-device host` and `--use-device cpu` runs, byte for byte."""
    src = tmp_path / "in.las"
    write_las(src, 30_000, 1)
    outs = {}
    for pkg, extra in (("schwarzwald_tpu", []),
                       ("schwarzwald_tpu_torch", ["--use-device", "host"]),
                       ("schwarzwald_tpu_torch", ["--use-device", "cpu"])):
        out = tmp_path / f"{pkg}_{'_'.join(extra)}"
        assert cli(pkg, ["--tiler", "-i", str(src), "-o", str(out)]
                   + extra) == 0
        outs[extra[-1] if extra else "jax"] = out
    assert_same_tree(outs["jax"], outs["host"])
    assert_same_tree(outs["jax"], outs["cpu"])


# the port's host run: its CLI defaults to the card
PORT_HOST = ["--use-device", "host"]


@pytest.mark.parametrize("sampler", ["RANDOM_GRID", "GRID_CENTER",
                                     "MIN_DISTANCE", "MIN_DISTANCE_FAST",
                                     "JITTERED"])
def test_cli_host_runs_of_every_sampler(tmp_path, sampler):
    src = tmp_path / "in.las"
    write_las(src, 6000, 2)
    outs = []
    for pkg in PACKAGES:
        out = tmp_path / pkg
        extra = PORT_HOST if pkg == "schwarzwald_tpu_torch" else []
        assert cli(pkg, ["--tiler", "-i", str(src), "-o", str(out),
                         "--sampling", sampler] + extra) == 0
        outs.append(out)
    assert_same_tree(*outs)


# -- refusals ----------------------------------------------------------------

def test_port_refuses_cuda_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    src = tmp_path / "in.las"
    write_las(src, 1000, 3)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli("schwarzwald_tpu_torch", ["--tiler", "-i", str(src), "-o",
                                      str(out), "--use-device", "cuda"])
    assert not out.exists()  # refused before touching the output


def test_port_auto_resolves_to_host_without_a_card():
    """`auto` (which once carried on on the host without a card) is
    refused, and the default, cuda, raises without a card: the host run is
    reached only through an explicit `host`."""
    from schwarzwald_tpu_torch.ops.device import resolve_use_device
    from schwarzwald_tpu_torch.process.tiler_process import TilerArguments

    for refused in ("auto", None):
        with pytest.raises(ValueError, match="cuda, cpu or host"):
            resolve_use_device(refused)
    default = TilerArguments(sources=[], output_directory="").use_device
    assert default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_use_device(default)
    assert resolve_use_device("cpu") == "cpu"
    assert resolve_use_device("host") is None


def test_cli_without_use_device_raises_without_a_card(tmp_path):
    src = tmp_path / "in.las"
    write_las(src, 1000, 3)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError) as err:
        cli("schwarzwald_tpu_torch", ["--tiler", "-i", str(src), "-o",
                                      str(out)])
    assert "host" in str(err.value) and "cpu" in str(err.value)
    assert not out.exists()


def test_tile_defaults_to_the_card(tmp_path):
    src = tmp_path / "in.las"
    write_las(src, 1000, 3)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        schwarzwald_tpu_torch.tile([str(src)], str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_cli_refuses_auto(tmp_path, capsys):
    with pytest.raises(SystemExit):
        cli("schwarzwald_tpu_torch", ["--tiler", "-i", str(tmp_path),
                                      "-o", str(tmp_path / "out"),
                                      "--use-device", "auto"])
    assert "invalid choice: 'auto'" in capsys.readouterr().err


# the cases keep the ids they had when the port refused --multichip and
# --multihost as not ported yet (ROADMAP items 6 and 7)
@pytest.mark.parametrize("argv", [["--multichip", "2"],
                                  ["--multihost", "0", "2"]],
                         ids=["argv0-item 6", "argv1-item 7"])
def test_port_refuses_what_is_not_ported(tmp_path, argv):
    """--multichip and --multihost run on the card by default: without one
    they raise before the output directory exists, and put no shard on the
    CPU."""
    src = tmp_path / "in.las"
    write_las(src, 1000, 4)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli("schwarzwald_tpu_torch",
            ["--tiler", "-i", str(src), "-o", str(out)] + argv)
    assert not out.exists()


def test_cli_converter_writes_the_jax_tree(tmp_path):
    """The default tiler tree (3D Tiles, MIN_DISTANCE) converted to LAZ by
    the port's --converter and by the JAX package's, byte for byte."""
    src = tmp_path / "in.las"
    write_las(src, 8000, 6)
    tiled = tmp_path / "tiled"
    assert cli("schwarzwald_tpu", ["--tiler", "-i", str(src), "-o",
                                   str(tiled)]) == 0
    outs = []
    for pkg in PACKAGES:
        out = tmp_path / f"conv_{pkg}"
        assert cli(pkg, ["--converter", "-i", str(tiled), "-o", str(out),
                         "--output-format", "LAZ"]) == 0
        outs.append(out)
    a, b = (sorted(os.listdir(o)) for o in outs)
    assert a == b and "r.laz" in a
    for name in a:
        assert (outs[0] / name).read_bytes() == (outs[1] / name).read_bytes()


# -- state across packages: a JAX run resumed by the port ----------------------

def tiler_args(pkg, src, out):
    tp = mod(pkg, "process.tiler_process")
    return tp.TilerArguments(
        sources=[str(src)], output_directory=str(out), spacing=8.0,
        sampling_strategy="MIN_DISTANCE", tiling_strategy="FAST",
        internal_cache_size=3000, max_batch_read_size=3000,
        checkpoint_interval_s=0.0)  # per-batch: the test kills batch 3


# the host run's case keeps the id it had when the host run was the
# port's default (use_device None)
@pytest.mark.parametrize("use_device", ["host", "cpu"], ids=["None", "cpu"])
def test_port_resumes_interrupted_jax_run(tmp_path, use_device):
    src = tmp_path / "in.las"
    write_las(src, 9000, 5)

    ref = tmp_path / "ref"
    mod("schwarzwald_tpu", "process.tiler_process").TilerProcess(
        tiler_args("schwarzwald_tpu", src, ref)).run()

    # interrupt a JAX-package run during the read of batch 3
    out = tmp_path / "out"
    tiler_mod = mod("schwarzwald_tpu", "process.tiler")
    orig_plain = tiler_mod.Tiler._read_batch
    orig_region = tiler_mod.Tiler._read_batch_into_slot
    calls = {"n": 0}

    def poison():
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated crash during batch 3 read")

    def poisoned_plain(self, rc):
        poison()
        return orig_plain(self, rc)

    def poisoned_region(self, rc, slot):
        poison()
        return orig_region(self, rc, slot)

    tiler_mod.Tiler._read_batch = poisoned_plain
    tiler_mod.Tiler._read_batch_into_slot = poisoned_region
    try:
        with pytest.raises(KeyboardInterrupt):
            mod("schwarzwald_tpu", "process.tiler_process").TilerProcess(
                tiler_args("schwarzwald_tpu", src, out)).run()
    finally:
        tiler_mod.Tiler._read_batch = orig_plain
        tiler_mod.Tiler._read_batch_into_slot = orig_region
    state = json.load(open(out / "tiler_state.json"))
    assert 0 < state["points_processed"] < 9000

    # resume with the port
    args = tiler_args("schwarzwald_tpu_torch", src, out)
    args.resume = True
    args.use_device = use_device
    mod("schwarzwald_tpu_torch", "process.tiler_process").TilerProcess(
        args).run()
    assert not (out / "tiler_state.json").exists()
    assert_same_tree(ref, out)

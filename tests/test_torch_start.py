"""The tiler's start, each case in a fresh interpreter: importing the CLI
and the tiler imports no torch; the host run imports none (it runs where
torch cannot be imported) and writes the JAX package's tree; under
--use-device cpu or cuda, torch's import and the card's set-up
(ops/device_start.py) fail the run before it touches its output, and
`resolve_use_device("cuda")` refuses a torch that sees no card."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
from schwarzwald_tpu.cli import main as jax_cli
from schwarzwald_tpu.core.aabb import AABB
from schwarzwald_tpu.core.pointbuffer import PointBuffer
from schwarzwald_tpu.io import las

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_UI = "SCHWARZWALD_TPU_NO_UI"

def python(code: str, *args, timeout=300):
    """`code` in a fresh interpreter at the repo's root."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env[NO_UI] = "1"
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def cli_code(prelude: str = "") -> str:
    """cli.main on the arguments, then whether torch was imported."""
    return (f"import sys\n{prelude}\n"
            "from schwarzwald_tpu_torch import cli\n"
            "rc = cli.main(sys.argv[1:])\n"
            "print('torch imported:', 'torch' in sys.modules)\n"
            "sys.exit(rc)\n")


def write_las(path, n, seed, extent=100.0):
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


def test_importing_the_cli_and_the_tiler_imports_no_torch():
    proc = python("import sys\n"
                  "import schwarzwald_tpu_torch.cli\n"
                  "import schwarzwald_tpu_torch.process.tiler_process\n"
                  "import schwarzwald_tpu_torch.ops.device_start\n"
                  "print(sorted(m for m in sys.modules\n"
                  "             if m == 'torch' or m.startswith('torch.')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_the_host_run_imports_no_torch_and_writes_the_jax_tree(tmp_path):
    src = tmp_path / "in.las"
    write_las(src, 30_000, 5)
    port, ref = tmp_path / "port", tmp_path / "ref"
    proc = python(cli_code(), "--tiler", "-i", str(src), "-o", str(port),
                  "--use-device", "host")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "torch imported: False" in proc.stdout
    assert "start split: " in proc.stdout
    # the JAX package's default is its host run
    assert jax_cli(["--tiler", "-i", str(src), "-o", str(ref)]) == 0
    got, want = tree(port), tree(ref)
    assert sorted(got) == sorted(want)
    assert all(got[rel] == want[rel] for rel in want)
    assert any(rel.endswith(".pnts") for rel in want)


@pytest.mark.parametrize("use_device", ["cpu", "host"])
def test_a_run_without_torch(tmp_path, use_device):
    """torch cannot be imported: a cpu run fails in its set-up before it
    touches the output; the host run never imports torch and succeeds."""
    src = tmp_path / "in.las"
    write_las(src, 1_000, 3)
    out = tmp_path / "out"
    proc = python(cli_code("sys.modules['torch'] = None"), "--tiler", "-i",
                  str(src), "-o", str(out), "--use-device", use_device)
    if use_device == "host":
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert (out / "properties.json").exists()
        return
    assert proc.returncode != 0
    # ModuleNotFoundError is the ImportError that the import raises here
    assert re.search(r"(ImportError|ModuleNotFoundError): import of torch",
                     proc.stderr)
    assert "in set_up\n" in proc.stderr
    assert not out.exists()


@pytest.mark.parametrize("entry", ["resolve_use_device", "cli"])
def test_a_card_torch_cannot_use_fails_before_the_output(tmp_path, entry):
    """torch (built for the CPU here) sees no card: `resolve_use_device`
    raises the no-card message, and a cuda run raises it before the output
    exists."""
    if entry == "resolve_use_device":
        proc = python("from schwarzwald_tpu_torch.ops.device import "
                      "resolve_use_device\n"
                      "try:\n"
                      "    resolve_use_device('cuda')\n"
                      "except RuntimeError as err:\n"
                      "    print('raised:', err)\n")
        assert proc.returncode == 0, proc.stderr
        said = proc.stdout
        assert "raised: " in said
    else:
        src = tmp_path / "in.las"
        write_las(src, 1_000, 4)
        out = tmp_path / "out"
        proc = python(cli_code(), "--tiler", "-i", str(src), "-o", str(out),
                      "--use-device", "cuda")
        assert proc.returncode != 0
        said = proc.stderr
        assert not out.exists()
    assert "no CUDA card" in said
    assert "torch.cuda.is_available() is False" in said
    assert "host" in said and "cpu" in said


def test_each_run_of_a_process_logs_its_own_split(tmp_path):
    """Two CLI runs in one process: each `start split:` line holds its own
    run's parts; only the first holds the interpreter's start."""
    src = tmp_path / "in.las"
    write_las(src, 1_000, 6)
    code = ("import sys\n"
            "from schwarzwald_tpu_torch import cli\n"
            "for out in sys.argv[1:]:\n"
            "    assert cli.main(['--tiler', '-i', " + repr(str(src)) +
            ", '-o', out, '--use-device', 'host']) == 0\n")
    proc = python(code, str(tmp_path / "a"), str(tmp_path / "b"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line.split("start split: ", 1)[1])
             for line in (proc.stdout + proc.stderr).splitlines()
             if "start split: " in line]
    assert len(lines) == 2
    first, second = lines
    assert "interpreter to cli.main" in first
    assert "interpreter to cli.main" not in second
    assert "native library" in first and "native library" not in second

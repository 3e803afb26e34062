"""The port (schwarzwald_tpu_torch) stands alone: it never imports JAX or
the JAX package, and its modules import on a machine without CUDA."""
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "schwarzwald_tpu_torch")

# an import of jax, or of the JAX package (not of schwarzwald_tpu_torch)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax\b|schwarzwald_tpu(?!_torch)\b)")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out.extend(os.path.join(d, f) for f in files if f.endswith(".py"))
    return sorted(out)


@pytest.mark.parametrize("modules", [
    ("schwarzwald_tpu_torch",),
    ("schwarzwald_tpu_torch.cli", "schwarzwald_tpu_torch.tiling.engine",
     "schwarzwald_tpu_torch.ops.poisson_cuda"),
    ("schwarzwald_tpu_torch.process.tiler_process",
     "schwarzwald_tpu_torch.ops.device_poisson",
     "schwarzwald_tpu_torch.io.persistence"),
    ("schwarzwald_tpu_torch.parallel.multidevice",
     "schwarzwald_tpu_torch.parallel.multihost",
     "schwarzwald_tpu_torch.entry",
     "schwarzwald_tpu_torch.process.converter"),
])
def test_import_pulls_in_no_jax(modules):
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'schwarzwald_tpu' or "
              "m.startswith('schwarzwald_tpu.'))\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_source_scan_finds_no_jax_import():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for no, line in enumerate(f, 1):
                if _FORBIDDEN.match(line):
                    offenders.append(f"{os.path.relpath(path, ROOT)}:{no}: "
                                     f"{line.strip()}")
    assert not offenders, offenders


def test_source_scan_pattern_catches_imports():
    """The scan's pattern itself: it must flag the JAX package and JAX,
    and only those."""
    assert _FORBIDDEN.match("import jax")
    assert _FORBIDDEN.match("    from jax import numpy")
    assert _FORBIDDEN.match("from schwarzwald_tpu.ops import device")
    assert _FORBIDDEN.match("import schwarzwald_tpu as sz")
    assert not _FORBIDDEN.match("import schwarzwald_tpu_torch as sz")
    assert not _FORBIDDEN.match("from schwarzwald_tpu_torch.ops import x")
    assert not _FORBIDDEN.match("import jaxtyping")


# a path component naming the JAX package's tree (not schwarzwald_tpu_torch)
_JAX_TREE = re.compile(r"(?:^|[/\\])schwarzwald_tpu(?:$|[/\\])")


def _jax_tree_paths(source: str) -> list:
    """Line numbers where `source` builds a path into the JAX package's
    tree: a string naming it passed to a call (os.path.join, open, Path,
    subprocess) or joined with `/` (pathlib). Docstrings, comments and data
    that only name a reference file are not paths built."""
    import ast

    def names_tree(node):
        return (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and _JAX_TREE.search(node.value))

    lines = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call):
            args = [*node.args, *(k.value for k in node.keywords)]
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            args = [node.left, node.right]
        else:
            continue
        lines += [a.lineno for a in args if names_tree(a)]
    return sorted(lines)


def test_source_scan_finds_no_path_into_the_jax_tree():
    """The port builds and reads nothing under schwarzwald_tpu/ (its native
    C++ is its own copy in native/src)."""
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            offenders += [f"{os.path.relpath(path, ROOT)}:{no}"
                          for no in _jax_tree_paths(f.read())]
    assert not offenders, offenders


def test_path_scan_catches_paths_into_the_jax_tree():
    """The path scan itself: the loader's old source directory, a path
    literal and a pathlib join are caught; the `replaces` label of a
    kernel, a docstring and the port's own tree are not."""
    old_loader = ('_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(\n'
                  '    os.path.dirname(os.path.abspath(__file__)))), '
                  '"schwarzwald_tpu",\n    "native", "src")\n')
    assert _jax_tree_paths(old_loader) == [2]
    assert _jax_tree_paths('open("schwarzwald_tpu/native/src/laz.cpp")\n')
    assert _jax_tree_paths('p = ROOT / "schwarzwald_tpu" / "native"\n')
    assert not _jax_tree_paths(
        '"""Replaces schwarzwald_tpu/ops/device.py:217."""\n'
        'k = {"replaces": "schwarzwald_tpu/ops/poisson_pallas.py:135"}\n'
        'os.path.join(ROOT, "schwarzwald_tpu_torch", "native", "src")\n')
    with open(os.path.join(PORT, "native", "loader.py")) as f:
        assert not _jax_tree_paths(f.read())


def test_chip_smoke_refuses_without_cuda():
    """No card here: the smoke exits non-zero and prints no result."""
    import torch

    assert not torch.cuda.is_available()
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

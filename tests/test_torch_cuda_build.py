"""The build of the CUDA kernel libraries (ops/_cuda_build) without a card
or nvcc: a stand-in nvcc compiles a C source with gcc and logs each call,
so the test sees when a library is rebuilt: at first use, when its source
is newer, and when the flags it was built with differ from NVCC_FLAGS."""
import os
import shutil
import stat

import pytest

from schwarzwald_tpu_torch.ops import _cuda_build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
for last; do :; done
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
exec gcc -x c -shared -fPIC -o "$out" "$last"
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    if shutil.which("gcc") is None:
        pytest.skip("needs gcc for the stand-in nvcc")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "answer.cu").write_text("int answer(void) { return 42; }\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_cuda_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", str(csrc / "build"))
    monkeypatch.setattr(_cuda_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_cuda_build, "_loaded", {})
    monkeypatch.setattr(_cuda_build, "build_info", {})

    def load():
        """Load anew (as a new process would) and return nvcc's calls."""
        _cuda_build._loaded.clear()
        lib = _cuda_build.load_kernel_library("answer")
        assert lib.answer() == 42
        return log.read_text().splitlines() if log.exists() else []

    return csrc, load


def test_a_library_is_built_once_for_its_source_and_flags(fake_build):
    csrc, load = fake_build
    calls = load()
    assert len(calls) == 1 and "-lineinfo" in calls[0].split()
    assert load() == calls  # up to date: no second build
    assert _cuda_build.build_info["answer"]["seconds"] == 0.0
    so = os.path.join(str(csrc / "build"), "libanswer.so")
    with open(f"{so}.flags") as f:
        assert f.read().split() == _cuda_build.NVCC_FLAGS


def test_changed_flags_rebuild_the_library(fake_build, monkeypatch):
    """A build from before a change to NVCC_FLAGS (such as -lineinfo) is
    stale, though its source is older than the library."""
    _, load = fake_build
    assert len(load()) == 1
    monkeypatch.setattr(_cuda_build, "NVCC_FLAGS",
                        [*_cuda_build.NVCC_FLAGS, "-DEXTRA"])
    calls = load()
    assert len(calls) == 2 and calls[-1].split()[-4] == "-DEXTRA"
    assert len(load()) == 2


def test_a_library_without_a_stamp_or_older_than_its_source_is_rebuilt(
        fake_build):
    csrc, load = fake_build
    assert len(load()) == 1
    so = os.path.join(str(csrc / "build"), "libanswer.so")
    os.remove(f"{so}.flags")  # built before builds were stamped
    assert len(load()) == 2
    earlier = os.path.getmtime(csrc / "answer.cu") - 10
    os.utime(so, (earlier, earlier))  # the source was edited since
    assert len(load()) == 3
    assert len(load()) == 3

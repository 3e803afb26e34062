"""ThreadSanitizer over the port's native library (native/tsan_check.sh):
both modes run here, and the verdict that judges them is held to its
rules on made-up output. Skips only where gcc has no libtsan."""
import os
import shutil
import subprocess

import pytest

from schwarzwald_tpu_torch.native import tsan_stress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "schwarzwald_tpu_torch", "native",
                      "tsan_check.sh")


def _libtsan() -> str | None:
    if shutil.which("gcc") is None or shutil.which("g++") is None:
        return None
    path = subprocess.run(["gcc", "-print-file-name=libtsan.so"],
                          capture_output=True, text=True).stdout.strip()
    return path if os.path.isfile(path) else None


@pytest.fixture(scope="module")
def tsan_check():
    """One run of the script in both modes: (exit code, output lines)."""
    if _libtsan() is None:
        pytest.skip("gcc has no libtsan.so")
    proc = subprocess.run(["bash", SCRIPT, "AB"], capture_output=True,
                          text=True, timeout=900)
    return proc.returncode, (proc.stdout + proc.stderr).splitlines()


def _verdict_block(lines, mode, run):
    """The verdict line of one run and the site lines under it."""
    head = f"tsan mode {mode} {run}: "
    at = [i for i, line in enumerate(lines) if line.startswith(head)]
    assert len(at) == 1, lines
    block = [lines[at[0]]]
    for line in lines[at[0] + 1:]:
        if not line.startswith("  "):
            break
        block.append(line)
    return block


def test_tsan_check_passes(tsan_check):
    rc, lines = tsan_check
    assert rc == 0, "\n".join(lines)


@pytest.mark.parametrize("mode", ["A", "B"])
def test_stress_run_reports_nothing(tsan_check, mode):
    """Six workloads from 8 threads at once, twice: no report, exit code
    0, every thread's results equal to the main thread's."""
    _, lines = tsan_check
    block = _verdict_block(lines, mode, "stress")
    assert block == [f"tsan mode {mode} stress: rc 0, 0 reports, results ok "
                     f"-> pass"], "\n".join(lines)


@pytest.mark.parametrize("mode", ["A", "B"])
def test_canary_races_are_seen(tsan_check, mode):
    """ThreadSanitizer sees both known races in each mode and nothing at
    the hand-off that only a parallel region's fork and join order."""
    _, lines = tsan_check
    block = _verdict_block(lines, mode, "canary")
    assert block[0].startswith(f"tsan mode {mode} canary: rc 66, ")
    assert block[0].endswith("results ok -> pass")
    sites = " ".join(block[1:])
    assert "in canary_callers" in sites and "in canary_team" in sites
    assert "canary_handoff" not in sites


STRESS_OK = ("tsan stress: 2 waves of 8 threads, 6 workloads each: "
             "results_differ=0 errors=0")
CANARY_OK = "tsan canary: handoff ok"


def _report(site: str, kind: str = "data race") -> str:
    return "\n".join([
        "==================",
        f"WARNING: ThreadSanitizer: {kind} (pid=123)",
        "  Write of size 8 at 0x7b0400000010 by thread T2:",
        f"    #0 {site.split(' in ')[-1]} /src/x.cpp:15 (lib.so+0x1234)",
        "",
        f"SUMMARY: ThreadSanitizer: {kind} /src/{site}",
        "=================="])


def test_reports_are_counted_with_their_sites():
    text = "\n".join([STRESS_OK, _report("a.cpp:15 in f"),
                      _report("b.cpp:7 in g._omp_fn.0"),
                      _report("c.cpp:9 in h", "heap-use-after-free")])
    assert tsan_stress.reports(text) == [
        ("data race", "a.cpp:15 in f"), ("data race", "b.cpp:7 in g._omp_fn.0"),
        ("heap-use-after-free", "c.cpp:9 in h")]


@pytest.mark.parametrize("rc,text,passed", [
    (0, STRESS_OK, True),
    (66, STRESS_OK + "\n" + _report("x.cpp:1 in f"), False),
    (0, STRESS_OK + "\n" + _report("x.cpp:1 in f"), False),  # count decides
    (66, STRESS_OK, False),
    (0, STRESS_OK.replace("results_differ=0", "results_differ=2"), False),
    (0, "", False),  # no result line: the run never finished
    # the JAX script's shape: a success line printed whatever happened
    (66, "tsan stress run completed without reports\n"
     + _report("laz.cpp:2542 in laz_encode_stream._omp_fn.0"), False),
])
def test_stress_verdict(rc, text, passed):
    assert tsan_stress.verdict("A", "stress", rc, text)[0] is passed


@pytest.mark.parametrize("rc,sites,passed", [
    (66, ["t.cpp:15 in canary_callers", "t.cpp:23 in canary_team._omp_fn.0"],
     True),
    (66, ["t.cpp:15 in canary_callers"], False),  # the team race unseen
    (66, ["t.cpp:15 in canary_callers", "t.cpp:23 in canary_team._omp_fn.0",
          "t.cpp:36 in canary_handoff"], False),  # fork/join not told
    (0, ["t.cpp:15 in canary_callers", "t.cpp:23 in canary_team._omp_fn.0"],
     False),
])
def test_canary_verdict(rc, sites, passed):
    text = "\n".join([CANARY_OK] + [_report(s) for s in sites])
    assert tsan_stress.verdict("B", "canary", rc, text)[0] is passed


def test_canary_verdict_needs_the_handoff_right():
    text = "\n".join(["tsan canary: handoff WRONG",
                      _report("t.cpp:15 in canary_callers"),
                      _report("t.cpp:23 in canary_team._omp_fn.0")])
    assert not tsan_stress.verdict("A", "canary", 66, text)[0]

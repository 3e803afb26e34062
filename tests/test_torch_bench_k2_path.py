"""bench_k2_path.py, the MIN_DISTANCE range path's probe, rehearsed on the
CPU: md_10M_terrain_3dtiles's rehearsal input, the host run, a traced run,
the paired runs of two checkouts (here both this one) and the card/host
pairs, every tree held against the rehearsal manifest; the unexplained
wall of a traced range's part. The numbers are the CPU's; the probe's
device readings run on the card only."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_probe_rehearses_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "bench_k2_path.py", "--rehearse", "--threads",
         "default", "--parent", ROOT, "--pairs", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    labels = [r["label"] for r in result["runs"]]
    assert labels == ["host", "this, traced, threads default",
                      "parent, traced, threads default",
                      "parent, timed, pair 0", "this, timed, pair 0",
                      "this, timed, pair 0", "parent, timed, pair 0"]
    files = {r["files"] for r in result["runs"]}
    assert len(files) == 1 and files.pop() > 0
    # on the CPU no range reaches the card: nothing traced, no launch
    assert all(r["ranges"] == 0 and r["k2"]["launches"] == 0
               for r in result["runs"])
    assert result["this_over_parent_points_per_s"] > 0
    assert not os.path.exists(os.path.join(ROOT, ".bench_k2_path_work"))


def test_unexplained_wall_is_what_neither_clock_explains():
    """A part's unexplained wall is its wall less the larger of its stream
    time and its thread's CPU time, and never below 0; a record without
    the part reads 0."""
    import bench_k2_path

    record = {"upload_ms": 2.0, "host_upload_ms": 5.0, "cpu_upload_ms": 1.0,
              "kernel_ms": 9.0, "host_kernel_ms": 4.0, "cpu_kernel_ms": 3.0,
              "prep_ms": 1.0, "host_prep_ms": 6.0, "cpu_prep_ms": 2.5}
    assert bench_k2_path.unexplained_ms(record, "upload") == 3.0
    assert bench_k2_path.unexplained_ms(record, "kernel") == 0.0
    assert bench_k2_path.unexplained_ms(record, "prep") == 3.5
    assert bench_k2_path.unexplained_ms(record, "download") == 0.0


def test_host_pairs_rehearse_on_the_cpu():
    """--host-pairs: pairs of untraced runs host, card, card, host (on the
    CPU the "card" runs are --use-device cpu), every tree held against the
    rehearsal manifest, each card run set against the host run beside it;
    the traced run carries the unexplained wall of every part."""
    proc = subprocess.run(
        [sys.executable, "bench_k2_path.py", "--rehearse", "--threads", "1",
         "--host-pairs", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    labels = [r["label"] for r in result["runs"]]
    assert labels == ["host", "this, traced, threads 1",
                      "host, timed, pair 0", "card, timed, pair 0",
                      "card, timed, pair 0", "host, timed, pair 0"]
    files = {r["files"] for r in result["runs"]}
    assert len(files) == 1 and files.pop() > 0
    traced = result["runs"][1]
    assert all(traced[f"unexplained_{p}_ms"] == 0.0
               for p in ("upload", "prep", "kernel", "download"))
    gaps = [c["tile_s"] - h["tile_s"] for c, h in zip(
        result["runs"][3:5], (result["runs"][2], result["runs"][5]))]
    assert result["card_minus_host_tile_s_median"] == pytest.approx(
        sum(gaps) / 2)
    assert "this_over_parent_points_per_s" not in result
    assert not os.path.exists(os.path.join(ROOT, ".bench_k2_path_work"))

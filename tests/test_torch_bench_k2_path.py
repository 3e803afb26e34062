"""bench_k2_path.py, the MIN_DISTANCE range path's probe, rehearsed on the
CPU: md_10M_terrain_3dtiles's rehearsal input, the host run, a traced run
and the paired runs of two checkouts (here both this one), every tree held
against the rehearsal manifest. The numbers are the CPU's; the probe's
device readings run on the card only."""
import json
import os
import subprocess
import sys

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

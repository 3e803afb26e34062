"""bench_sweep.py, the grid samplers' sweep probe, rehearsed on the CPU:
both grid cells' rehearsal inputs, one instrumented run each, every step
of each sweep group timed, the native host sweep's levels held against
the sweep's, every tree held against the rehearsal manifest. The numbers
are the CPU's; the card readings (span, busy time) run on the card only."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("keys_upload_ms", "positions_ms", "sweep_ms", "materialize_ms",
         "persist_ms", "host_sweep_ms", "replay_wall_ms")


def test_the_probe_rehearses_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "bench_sweep.py", "--rehearse"], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    cells = {c["cell"]: c for c in result["cells"]}
    assert set(cells) == {"rg_10M_terrain_3dtiles", "gc_10M_laz_entwine"}
    for name, sampler in (("rg_10M_terrain_3dtiles", "RANDOM_GRID"),
                          ("gc_10M_laz_entwine", "GRID_CENTER")):
        cell = cells[name]
        assert cell["rc"] == 0 and cell["files"] > 0
        assert cell["groups"], name
        for g in cell["groups"]:
            assert g["sampler"] == sampler and g["device"] == "cpu"
            assert g["host_equal"] and all(g[k] >= 0 for k in STEPS)
            # no card: no span or busy time, and no kernel launched
            assert "replay_busy_ms" not in g and g.get("x2_launches", 0) == 0
        assert sum(g["points"] for g in cell["groups"]) > 0
    assert not os.path.exists(os.path.join(ROOT, ".bench_sweep_work"))

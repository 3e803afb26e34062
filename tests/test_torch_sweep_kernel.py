"""The octree sweep X2's kernel wrapper (schwarzwald_tpu_torch/ops/
device_tiling.py) without a card: the level plan both routes run, held
against the decisions of the JAX package's sweep loop; the CPU route; the
wrapper's argument checks, which raise before the kernel's library is
built or loaded; the plan as the kernel reads it. The kernel itself runs
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
import jax
import jax.numpy as jnp
from schwarzwald_tpu.ops import device_tiling as jax_tiling
from schwarzwald_tpu_torch.ops import _cuda_build, device_tiling
from schwarzwald_tpu_torch.ops import sanitize_kernels

from test_torch_sweep import EXTENT, SWEEP_CASES, sorted_batch

PLAN_CASES = dict(SWEEP_CASES, reroot=("RANDOM_GRID", 3000,
                                       EXTENT / 2 ** 18, 100, 100, -1,
                                       EXTENT))


def jax_decisions(monkeypatch, strategy, cands, max_depth, jit_cfgs,
                  min_node_level):
    """The levels the JAX package's sweep loop runs, as (node_level,
    terminal, cand, cfg): its Python loop run as written on 8 dummy keys,
    each non-terminal level read from the lax.cond it hands its level body
    to (the body is not run: the decisions do not depend on the data), the
    terminal level from its one jnp.where with a scalar level."""
    levels = []

    def cond(pred, body, identity, operand):
        node_level, cand, cfg, _ = body.__defaults__
        levels.append((node_level, False, cand, cfg))
        return operand

    class Where:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def where(mask, value, other):
            levels.append((int(value) - 2, True, None, None))
            return jnp.where(mask, value, other)

    monkeypatch.setattr(jax.lax, "cond", cond)
    monkeypatch.setattr(jax_tiling, "jnp", Where())
    words = jnp.zeros(8, jnp.uint32)
    jax_tiling.octree_select_grid.__wrapped__(
        words, words, tuple(cands), 100, max_depth, strategy=strategy,
        jit_cfgs=jit_cfgs, min_node_level=min_node_level)
    return levels


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_level_plan_equals_the_jax_loop(monkeypatch, case):
    strategy, _, spacing, _, max_depth, minlv, _ = PLAN_CASES[case]
    cands = device_tiling.candidate_levels(EXTENT, spacing, max_depth)
    cfgs = device_tiling.jittered_static_configs(EXTENT, spacing, max_depth)
    plan = device_tiling.level_plan(strategy, cands, max_depth, cfgs, minlv)
    want = jax_decisions(monkeypatch, strategy, cands, max_depth,
                         jax_tiling.jittered_static_configs(
                             EXTENT, spacing, max_depth), minlv)
    got = [(lv["node_level"], lv["terminal"],
            None if lv["terminal"] else lv["cand"],
            None if lv["terminal"] else lv["cfg"]) for lv in plan]
    assert got == want
    assert plan, "every case runs at least one level"
    if case == "reroot":
        assert not plan[-1]["terminal"]  # stopped at re-rooting depths
    for lv in plan:
        assert lv["node_groups"] == lv["node_level"] + 1
        if strategy == "JITTERED" and not lv["terminal"]:
            assert lv["pick_groups"] == lv["cfg"][1] + 1
        elif lv["cand"] is not None and lv["cand"] >= 0 \
                and not lv["terminal"]:
            assert lv["pick_groups"] == lv["cand"] + 1


def test_a_cpu_tensor_takes_the_plain_route(monkeypatch):
    """octree_select_grid on CPU tensors is octree_select_grid_torch: no
    launch counted, no library built."""
    monkeypatch.setattr(device_tiling, "_c_fn", None)
    monkeypatch.setattr(_cuda_build, "load_kernel_library",
                        lambda name: pytest.fail("loaded a kernel library"))
    device_tiling.reset_counters()
    pos = np.random.default_rng(3).uniform(0.0, EXTENT, (3000, 3))
    skeys, spos = sorted_batch(pos)
    key = device_tiling.keys_tensor(skeys, "cpu")
    cands = device_tiling.candidate_levels(EXTENT, 4.0, 100)
    kw = dict(strategy="GRID_CENTER", positions=torch.from_numpy(spos),
              root_min=[0.0] * 3, root_max=[EXTENT] * 3)
    got = device_tiling.octree_select_grid(key, cands, 100, 100, **kw)
    want = device_tiling.octree_select_grid_torch(key, cands, 100, 100, **kw)
    assert torch.equal(got, want) and (got > 0).all()
    assert device_tiling.snapshot() == {"x2_launches": 0}


def bad_inputs():
    key = torch.arange(10, dtype=torch.int64)
    pos = torch.zeros(10, 3, dtype=torch.float64)
    gc = dict(strategy="GRID_CENTER", positions=pos, root_min=[0.0] * 3,
              root_max=[1.0] * 3)
    return {
        "key_dtype": ((key.to(torch.int32),), {}, TypeError, "dtype"),
        "key_shape": ((key.view(2, 5),), {}, ValueError, "shape"),
        "key_contiguous": ((torch.arange(20, dtype=torch.int64)[::2],), {},
                           ValueError, "contiguous"),
        "sampler": ((key,), {"strategy": "MIN_DISTANCE"}, ValueError,
                    "sampler"),
        "positions_missing": ((key,), {"strategy": "GRID_CENTER"},
                              ValueError, "needs positions"),
        "positions_dtype": ((key,), dict(gc, positions=pos.float()),
                            TypeError, "dtype"),
        "positions_shape": ((key,), dict(gc, positions=pos[:9]),
                            ValueError, "shape"),
        "positions_contiguous": ((key,), dict(gc, positions=torch.zeros(
            3, 10, dtype=torch.float64).t()), ValueError, "contiguous"),
        "positions_device": ((key,), dict(gc, positions=pos.to("meta")),
                             ValueError, "are on"),
        "bounds": ((key,), dict(gc, root_min=[0.0] * 2), ValueError,
                   "three values"),
        "jit_cfgs": ((key,), dict(gc, strategy="JITTERED"), ValueError,
                     "jit_cfgs"),
        "cpu_tensors": ((key,), gc, ValueError, "CUDA tensors"),
    }


@pytest.mark.parametrize("case", sorted(bad_inputs()))
def test_the_wrapper_raises_before_any_library_load(monkeypatch, case):
    monkeypatch.setattr(device_tiling, "_c_fn", None)
    monkeypatch.setattr(_cuda_build, "load_kernel_library",
                        lambda name: pytest.fail("loaded a kernel library"))
    device_tiling.reset_counters()
    args, kw, exc, match = bad_inputs()[case]
    with pytest.raises(exc, match=match):
        device_tiling.octree_select_grid_cuda(*args, [0] * 22, 100, 100,
                                              **kw)
    assert device_tiling.snapshot() == {"x2_launches": 0}


def test_the_packed_plan_is_the_kernels_layout():
    """_pack_plan's rows: LEVEL_INTS int32 a level, the jitter tables'
    first plen entries of each of the three rows."""
    cands = device_tiling.candidate_levels(EXTENT, 2.0, 100)
    cfgs = device_tiling.jittered_static_configs(EXTENT, 2.0, 100)
    plan = device_tiling.level_plan("JITTERED", cands, 100, cfgs, -1)
    packed = device_tiling._pack_plan(plan)
    assert packed.shape == (len(plan), device_tiling.LEVEL_INTS)
    assert packed.dtype == np.int32 and packed.flags.c_contiguous
    for row, lv in zip(packed, plan):
        assert row[:6].tolist() == [lv["node_level"], lv["terminal"],
                                    lv["node_groups"], lv["pick_groups"],
                                    lv["pick"], lv["depth"]]
        if lv["terminal"]:
            assert not row[6:].any()
            continue
        levels, _, actual, plen, perms = lv["cfg"]
        assert row[6:9].tolist() == [levels, actual, plen]
        for a in range(3):
            tab = row[9 + 64 * a:9 + 64 * (a + 1)]
            assert tab[:plen].tolist() == list(perms[a][:plen])
            assert not tab[plen:].any()
    assert device_tiling._pack_plan([]).shape == (1, device_tiling.LEVEL_INTS)


def test_the_deepest_plan_fits_the_kernels_plan_buffer():
    """A plan runs from node level -1 to MAX_LEVELS - 1 at most
    (MAX_PLAN_LEVELS levels, RANDOM_GRID reaches it); it goes to the kernel
    in a device buffer of LEVEL_INTS int32 a level, so every depth fits,
    and a deeper list raises."""
    cands = device_tiling.candidate_levels(EXTENT, 17.43, 20)
    plan = device_tiling.level_plan("RANDOM_GRID", cands, 20)
    assert len(plan) == device_tiling.MAX_PLAN_LEVELS == 22
    packed = device_tiling._pack_plan(plan)
    assert packed.nbytes == 22 * device_tiling.LEVEL_INTS * 4
    assert packed.flags.c_contiguous and packed.dtype == np.int32
    assert [lv["node_level"] for lv in plan] == list(range(-1, 21))
    with pytest.raises(ValueError, match="at most"):
        device_tiling._pack_plan(plan + plan[-1:])


def test_kernel_times_bins_ranges_by_blocks():
    """The prep's per-range times by block count (bench_kernels.py
    ranges): each range in the bin of its block count, empty bins left
    out."""
    import bench_kernels

    rows = bench_kernels.by_blocks([(4096, 0.01, 1), (4097, 0.03, 1),
                                   (102_400, 0.02, None),
                                   (5_490_148, 0.4, 2)])
    assert [(r["blocks"], r["ranges"], r["launches"]) for r in rows] == [
        ("1-8", 1, 1), ("9-16", 1, 1), ("129-200", 1, None),
        ("4097-2147483648", 1, 2)]
    assert rows[0]["sum_ms"] == 0.01 and rows[-1]["max_ms"] == 0.4


def test_sweep_cases_hold_what_they_promise():
    """The checker's X2 cases (phase 2 and 8 of chip_smoke.py): sorted keys,
    the mirrored pairs tie exactly at a GRID_CENTER pick, the re-root plan
    stops early, max_points above n."""
    names = {"single_1", "equal_5000", "mirrored_ties", "reroot_3000",
             "above_n_3000"}
    cases = {c[0]: c for c in sanitize_kernels.sweep_cases(names)}
    assert set(cases) == names
    for _, keys, pos, *_ in cases.values():
        assert keys.dtype == np.uint64 and (np.diff(keys) >= 0).all()
        assert pos.shape == (keys.size, 3) and pos.flags.c_contiguous
    assert np.unique(cases["equal_5000"][1]).size == 1
    assert cases["above_n_3000"][5] > cases["above_n_3000"][1].size
    key, args, kw = sanitize_kernels.sweep_args(cases["mirrored_ties"],
                                                "GRID_CENTER", "cpu")
    level = device_tiling.level_plan("GRID_CENTER", args[0], 100)[0]
    centre = device_tiling._cell_centers(key, level["depth"], [0.0] * 3,
                                         [EXTENT] * 3)
    dist = device_tiling._sq_dist(kw["positions"], *centre).numpy()
    cell = cases["mirrored_ties"][1] >> np.uint64(63 - 3 * level["depth"])
    tied = sum(int((dist[cell == c] == dist[cell == c].min()).sum() > 1)
               for c in np.unique(cell))
    assert tied >= 40
    key, args, kw = sanitize_kernels.sweep_args(cases["reroot_3000"],
                                                "RANDOM_GRID", "cpu")
    levels = device_tiling.octree_select_grid(key, *args, **kw)
    assert (levels == 0).any() and (levels > 0).any()

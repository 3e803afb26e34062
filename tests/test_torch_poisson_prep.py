"""The range path of the port's Poisson-disk sampler on the CPU
(ops/poisson_cuda): the prep kernels' plain version (`prep_torch`, which
the card's prep kernels are held against) against the numpy `_pair_csr`
and the JAX package's `poisson_pallas._prep`, element for element; the
whole range path (`_range_mask`, the kernels' plain versions on CPU
tensors) on a reused workspace against fresh ones and the native host
kernel; the workspaces handed from thread to thread with their streams;
the memory caps; the trace record that bench_torch.py reads. Every
comparison is exact."""
import threading

import numpy as np
import pytest
import torch

import bench_torch
from schwarzwald_tpu.ops import poisson_pallas
from schwarzwald_tpu_torch import native
from schwarzwald_tpu_torch.ops import poisson_cuda
from schwarzwald_tpu_torch.ops.sanitize_kernels import ball_blocks
from test_torch_poisson_phases import (clustered, fresh_pool,
                                       recorder_maker, run_pool,
                                       sorted_uniform, spacing_edge)

torch.set_num_threads(1)

EXTENT = 64.0
BLOCK = poisson_cuda.BLOCK


def duplicates():
    pos = sorted_uniform(6000, 6)
    pos[2000:2600] = pos[1999]
    return pos


def analyze_every(n, stride):
    mask = np.zeros(n, dtype=bool)
    mask[::stride] = True
    return mask


# name: (positions, spacing, analyze stride)
PREP_CASES = {
    "uniform_5000": (lambda: sorted_uniform(5000, 1), 2.0, None),
    "clustered_6000": (lambda: clustered(6000, 3), 0.6, None),
    "duplicates_6000": (duplicates, 1.0, None),
    "analyze3_5000": (lambda: sorted_uniform(5000, 8), 3.0, 3),
    "edge_x": (lambda: spacing_edge(0, block=BLOCK), 0.1, None),
    "edge_y": (lambda: spacing_edge(1, block=BLOCK), 0.1, None),
    "edge_z": (lambda: spacing_edge(2, block=BLOCK), 0.1, None),
    # 191 blocks: 191 * 190 / 2 = 95 * 191 cross pairs, the gate's capacity
    "gate_at_limit": (lambda: ball_blocks(191), 5.0, None),
    # 192 + 1 blocks: 192 * 191 / 2 = 95 * 193 + 1, one past it
    "gate_one_past": (lambda: ball_blocks(192, far=1), 5.0, None),
}


def cross_pairs_of_jax_prep(pos, spacing, analyze):
    """The cross pairs (bi, bj < bi) of the JAX package's host prep (f32
    AABBs; pad blocks pair with nothing), as CSR, or None past its gate."""
    prepped = poisson_pallas._prep(pos, spacing, analyze)
    if prepped is None:
        return None
    _, _, pair_bi, pair_bj, _, valid, n, _ = prepped
    nb = -(-n // BLOCK)
    keep = (valid != 0) & (pair_bj < pair_bi)
    bi, bj = pair_bi[keep], pair_bj[keep]
    assert (np.diff(bi) >= 0).all()
    return (np.concatenate([[0], np.cumsum(np.bincount(bi, minlength=nb))]),
            bj)


def check_plain_prep(pos, spacing, analyze, precision):
    """prep_torch against the numpy prep (and the JAX one in f32)."""
    n = pos.shape[0]
    nb = -(-n // BLOCK)
    ana = None if analyze is None else torch.from_numpy(
        analyze.astype(np.uint8))
    planes, ptr, bj, head = poisson_cuda.prep_torch(
        torch.from_numpy(pos), ana, spacing, precision)
    dtype = np.float64 if precision == "f64" else np.float32
    want = pos.astype(dtype).T.copy()
    if analyze is not None:
        want[0, ~analyze] = np.nan
    assert planes.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(planes.numpy().view(np.uint8),
                                  want.view(np.uint8))
    assert ptr.dtype == torch.int32 and bj.dtype == torch.int32
    assert bj.numel() == poisson_cuda.gate_capacity(nb)
    assert ptr.numel() == nb + 1 and head.dtype == torch.int64
    gate, n_cross = head.tolist()
    p = poisson_cuda.prep(pos, spacing, analyze, precision)
    assert gate == (p is None)
    assert n_cross == int(ptr[-1])
    if p is not None:
        np.testing.assert_array_equal(ptr.numpy(), p.pair_ptr)
        np.testing.assert_array_equal(bj[:n_cross].numpy(), p.pair_bj)
    if precision == "f32" and n <= poisson_pallas.MAX_POINTS:
        jax_csr = cross_pairs_of_jax_prep(pos, spacing, analyze)
        assert (jax_csr is None) == bool(gate)
        if jax_csr is not None:
            np.testing.assert_array_equal(ptr.numpy(), jax_csr[0])
            np.testing.assert_array_equal(bj[:n_cross].numpy(), jax_csr[1])
    return gate, n_cross, p


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_plain_prep_equals_numpy_and_jax(case, precision):
    make, spacing, stride = PREP_CASES[case]
    pos = make()
    analyze = None if stride is None else analyze_every(pos.shape[0], stride)
    gate, n_cross, p = check_plain_prep(pos, spacing, analyze, precision)
    nb = -(-pos.shape[0] // BLOCK)
    if case == "gate_at_limit":
        assert (gate, n_cross) == (0, poisson_cuda.gate_capacity(nb))
    elif case == "gate_one_past":
        assert (gate, n_cross) == (1, poisson_cuda.gate_capacity(nb) + 1)
    else:
        assert gate == 0 and 0 < n_cross
    if case.startswith("edge"):
        assert p.pair_bj[p.pair_ptr[1]:p.pair_ptr[2]].tolist() == [0]


def test_plain_prep_above_2_20_points():
    n = (1 << 20) + 4096
    pos = sorted_uniform(n, 13, extent=256.0)
    gate, n_cross, _ = check_plain_prep(pos, 2.0, None, "f64")
    assert gate == 0 and n_cross > 0


def test_range_prep_on_the_cpu_is_the_plain_version():
    pos = torch.from_numpy(sorted_uniform(3000, 2))
    got = poisson_cuda.range_prep(pos, None, 1.5, "f32")
    want = poisson_cuda.prep_torch(pos, None, 1.5, "f32")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("parts", [poisson_cuda.PARTS, ("prep", "k2"),
                                   ("k2",)])
def test_a_workspace_lists_the_buffers_of_each_part(parts):
    """`_Workspace.arrays` is the one list of the range path's buffers:
    the range path takes every part, `range_prep` the prep's and K2's,
    `accept_mask_cuda` K2's; a buffer of a part left out is None."""
    n, nb = 3000, -(-3000 // BLOCK)
    buf = poisson_cuda._Workspace("cpu", counted=False).arrays(
        n, "f32", True, parts)
    shapes = {"up": (3 * n,), "up_ana": (n,), "pos": (3 * n,),
              "planes": (3, n), "bj": (poisson_cuda.gate_capacity(nb),),
              "head": (2 + nb,), "counts": (nb * BLOCK,), "out": (n,),
              "offsets": (nb * BLOCK + 1,),
              "gbox": (6 * poisson_cuda.prep_groups(nb),),
              "gcount": (poisson_cuda.prep_groups(nb),), "ready": (1 + nb,),
              "status": (nb,)}
    part_of = {"up": "host", "up_ana": "host", "pos": "upload",
               "planes": "prep", "bj": "prep", "head": "prep",
               "counts": "k2", "out": "k2", "offsets": "k2",
               "gbox": "prep", "gcount": "prep", "ready": "prep",
               "status": "prep"}
    for name, shape in shapes.items():
        t = getattr(buf, name)
        if part_of[name] in parts:
            assert tuple(t.shape) == shape, name
        else:
            assert t is None, name
    assert buf.planes is None or buf.planes.dtype == torch.float32
    assert buf.offsets[0] == 0


PREP_ONE = poisson_cuda.PREP_ONE_LAUNCH


@pytest.mark.parametrize("n_blocks, launches", [
    (0, 0), (1, 1), (8, 1), (200, 1), (PREP_ONE - 1, 1), (PREP_ONE, 1),
    (PREP_ONE + 1, 2), (8192, 2), (10_723, 2)])
def test_the_prep_takes_one_launch_up_to_its_limit(n_blocks, launches):
    """One prep launch for a range of at most PREP_ONE_LAUNCH blocks (which
    covers the main path's ranges of 8-200 blocks), two above, with a
    group box per PREP_GROUP blocks."""
    assert PREP_ONE >= 200
    assert poisson_cuda.prep_launches_per_range(n_blocks) == launches
    assert poisson_cuda.prep_groups(n_blocks) == max(
        1, -(-n_blocks // poisson_cuda.PREP_GROUP))


@pytest.mark.parametrize("n_blocks, grouped", [
    (PREP_ONE + 1, False), (poisson_cuda.PREP_GROUPED_FROM - 1, False),
    (poisson_cuda.PREP_GROUPED_FROM, True), (10_723, True)])
def test_the_two_launch_prep_tests_group_boxes_from_its_limit(n_blocks,
                                                              grouped):
    """Above one launch the second launch tests every earlier block (a CTA
    a row) up to PREP_GROUPED_FROM blocks, and group boxes first from
    there (the root-sized ranges)."""
    assert PREP_ONE < poisson_cuda.PREP_GROUPED_FROM <= 10_723
    assert poisson_cuda.prep_grouped(n_blocks) is grouped
    assert poisson_cuda.prep_launches_per_range(n_blocks) == 2


@pytest.mark.parametrize("counted", [True, False])
def test_the_prep_tickets_and_flags_start_at_zero(monkeypatch, counted):
    """The prep's ticket, flags and status words are zero when their
    buffers are made, even under the checker's poison, and a grown buffer
    is zero again; each one-launch prep takes the workspace's next epoch,
    and the flags are zeroed again when the epochs wrap."""
    from schwarzwald_tpu_torch.ops import sanitize_kernels

    monkeypatch.setattr(sanitize_kernels, "POISON", True)
    ws = poisson_cuda._Workspace("cpu", counted=counted)
    with sanitize_kernels.poisoned():
        for n in (3000, 600_000, 3000):
            buf = ws.arrays(n, "f64", False, ("prep",))
            nb = -(-n // BLOCK)
            assert buf.ready.numel() == 1 + nb and buf.status.numel() == nb
            assert buf.gcount.numel() == poisson_cuda.prep_groups(nb)
            assert not (buf.ready.any() or buf.status.any()
                        or buf.gcount.any())
    assert [ws.prep_epoch() for _ in range(3)] == [1, 2, 3]
    last = poisson_cuda.PREP_EPOCHS - 1
    ws._epoch = last - 1
    buf.ready.fill_(7)
    buf.status.fill_(7)
    assert ws.prep_epoch() == last and buf.ready.eq(7).all()
    assert ws.prep_epoch() == 1
    assert not (buf.ready.any() or buf.status.any())


# -- the range path on a workspace ------------------------------------------------

def native_mask(pos, spacing, analyze):
    return native.poisson_sample_kernel()(pos, np.zeros(3),
                                          np.full(3, EXTENT), spacing,
                                          analyze)


# (points, spacing, analyze stride, close-list budget): they grow, shrink
# and grow again; the last runs in several windows
RANGES = [(3000, 2.0, None, poisson_cuda.CLOSE_BUDGET),
          (9000, 2.5, 4, poisson_cuda.CLOSE_BUDGET),
          (1500, 3.0, None, poisson_cuda.CLOSE_BUDGET),
          (6000, 2.0, 3, 40)]


def test_a_reused_workspace_gives_the_masks_of_fresh_ones(monkeypatch):
    ws = poisson_cuda._Workspace("cpu")
    before = None
    for k, (n, spacing, stride, budget) in enumerate(RANGES):
        monkeypatch.setattr(poisson_cuda, "CLOSE_BUDGET", budget)
        pos = sorted_uniform(n, 40 + k)
        analyze = None if stride is None else analyze_every(n, stride)
        for precision in ("f64", "f32"):
            got = poisson_cuda._range_mask(ws, pos, spacing, analyze,
                                           precision)
            fresh = poisson_cuda._range_mask(
                poisson_cuda._Workspace("cpu"), pos, spacing, analyze,
                precision)
            np.testing.assert_array_equal(got, fresh)
            if precision == "f64":
                np.testing.assert_array_equal(got,
                                              native_mask(pos, spacing,
                                                          analyze))
        held = {name: (t.numel(), t.data_ptr())
                for name, t in ws._bufs.items()}
        if k == 2:  # the shrink takes views: nothing grows or moves
            assert held == before
        before = held
    assert not ws.pending
    # every buffer a power of two of elements
    assert all(t.numel() & (t.numel() - 1) == 0 for t in ws._bufs.values())


def test_a_range_past_the_gate_returns_none_and_leaves_nothing_pending():
    ws = poisson_cuda._Workspace("cpu")
    pos = ball_blocks(192, far=1)
    assert poisson_cuda._range_mask(ws, pos, 5.0, None, "f64") is None
    assert not ws.pending
    pos = sorted_uniform(2000, 9)
    np.testing.assert_array_equal(
        poisson_cuda._range_mask(ws, pos, 2.0, None, "f64"),
        native_mask(pos, 2.0, None))


def test_a_workspace_past_the_caps_sends_the_range_to_one_off_buffers(
        monkeypatch):
    held = dict.fromkeys(poisson_cuda._ws_held, 0)
    monkeypatch.setattr(poisson_cuda, "_ws_held", held)
    ws = poisson_cuda._Workspace("cpu")
    small, large = sorted_uniform(1000, 21), sorted_uniform(6000, 22)
    want = {n: native_mask(p, 2.0, None) for n, p in ((1000, small),
                                                      (6000, large))}
    np.testing.assert_array_equal(
        poisson_cuda._range_mask(ws, small, 2.0, None, "f64"), want[1000])
    sizes = {name: t.numel() for name, t in ws._bufs.items()}
    monkeypatch.setattr(poisson_cuda, "PINNED_CAP", held["host"] + 1000)
    np.testing.assert_array_equal(
        poisson_cuda._range_mask(ws, large, 2.0, None, "f64"), want[6000])
    assert held["one_off"] == 1
    assert {name: t.numel() for name, t in ws._bufs.items()} == sizes
    monkeypatch.setattr(poisson_cuda, "PINNED_CAP", 2 << 30)
    monkeypatch.setattr(poisson_cuda, "DEVICE_CAP", held["device"] + 1000)
    np.testing.assert_array_equal(
        poisson_cuda._range_mask(ws, large, 2.0, None, "f64"), want[6000])
    assert held["one_off"] == 2 and not ws.pending
    monkeypatch.setattr(poisson_cuda, "DEVICE_CAP", 8 << 30)
    np.testing.assert_array_equal(
        poisson_cuda._range_mask(ws, large, 2.0, None, "f64"), want[6000])
    assert held["one_off"] == 2
    host = {"up", "down", "head_host"}
    assert held["host"] == held["peak_host"] == sum(
        t.nbytes for name, t in ws._bufs.items() if name in host)
    assert held["device"] == held["peak_device"] == sum(
        t.nbytes for name, t in ws._bufs.items() if name not in host)


def test_successive_pools_reuse_their_workspaces(monkeypatch):
    """10 successive pools of 8 threads, all alive at once in each, make 8
    workspaces, each going with its stream."""
    made, maker = recorder_maker()
    pool = fresh_pool(monkeypatch, maker)

    def take(_):
        stream = poisson_cuda.thread_stream("cuda:0")
        return stream, pool.workspace(stream)

    handed = [run_pool(8, take) for _ in range(10)]
    assert pool.workspaces_made() == 8 == len(made)
    by_stream = {}
    for stream, ws in (pair for h in handed for pair in h):
        assert by_stream.setdefault(id(stream), ws) is ws
    assert len({id(ws) for _, ws in handed[0]}) == 8
    assert poisson_cuda.workspace_stats()["made"] == 8


def test_a_thread_that_raises_gives_its_workspace_back(monkeypatch):
    """A thread whose range raises after it took its stream and workspace
    (here: no card for the pinned buffers) gives both back when it ends,
    and the next thread sends on them."""
    made, maker = recorder_maker()
    pool = fresh_pool(monkeypatch, maker)
    errors, taken = [], []

    def send():
        try:
            poisson_cuda.range_mask_cuda(sorted_uniform(4096, 3), 2.0,
                                         device="cuda:0")
        except Exception as exc:  # the range fails part way
            errors.append(exc)
        stream = poisson_cuda.thread_stream("cuda:0")
        taken.append((stream, pool.workspace(stream)))

    for _ in range(3):
        worker = threading.Thread(target=send)
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
    assert len(errors) == 3
    assert pool.workspaces_made() == 1 and len(made) == 1
    assert all(s is made[0] and ws is taken[0][1] for s, ws in taken)
    assert not taken[0][1].pending


class FakeEvent:
    """A CUDA event without a card: the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        import time

        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_trace_records_hold_what_the_benchmark_reads(monkeypatch):
    """A traced range's record holds every key bench_torch.py's
    k2_ranges_summary reads, and the parts it sums; without a trace the
    path records no CUDA event."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(poisson_cuda, "trace", [])
    pos = sorted_uniform(3000, 5)
    ws = poisson_cuda._Workspace("cpu")
    poisson_cuda._range_mask(ws, pos, 2.0, None, "f64")
    records = poisson_cuda.trace
    assert len(records) == 1
    r = records[0]
    for part in ("upload", "prep", "kernel", "download"):
        for kind in ("", "host_", "cpu_"):
            assert r[f"{kind}{part}_ms"] >= 0.0
    assert r["n"] == 3000 and r["t0"] <= r["t1"]
    assert r["windows"] == 1 and set(r) >= {"A", "B", "wait_ms", "thread",
                                            "stream", "device"}
    summary = bench_torch.k2_ranges_summary(records)
    assert summary["ranges"] == 1
    assert summary["sender_wall_ms"] == pytest.approx(
        (r["t1"] - r["t0"]) * 1e3)

    def no_event(*args, **kwargs):
        raise AssertionError("a CUDA event without a trace")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(poisson_cuda, "trace", None)
    np.testing.assert_array_equal(
        poisson_cuda._range_mask(ws, pos, 2.0, None, "f64"),
        native_mask(pos, 2.0, None))


def test_workspace_accounting_holds_under_threads(monkeypatch):
    """16 threads grow workspaces of their own at once, with a short
    switch interval: the bytes held are the sum of every workspace's
    buffers (no lost update), and each peak is the total reached."""
    import sys

    held = dict.fromkeys(poisson_cuda._ws_held, 0)
    monkeypatch.setattr(poisson_cuda, "_ws_held", held)
    spaces = [poisson_cuda._Workspace("cpu") for _ in range(16)]

    def grow(ws):
        for n in (100, 700, 3000, 1200, 9000):
            assert ws.arrays(n, "f64", n % 2 == 0) is not None

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=grow, args=(ws,)) for ws in spaces]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    host = {"up", "down", "head_host", "up_ana"}
    total = {"host": 0, "device": 0}
    for ws in spaces:
        for name, t in ws._bufs.items():
            total["host" if name in host else "device"] += t.nbytes
    assert (held["host"], held["device"]) == (total["host"], total["device"])
    assert (held["peak_host"], held["peak_device"]) == (total["host"],
                                                        total["device"])

"""The pieces of the port's two-phase Poisson-disk path (ops/poisson_cuda)
on CPU tensors: the pair CSR built in torch ops against the numpy
`_pair_csr`, phase A's close lists against a brute-force O(n^2) list, the
block dependency set against the AABB pairs, and the window plan. The masks
of the whole path are held against the JAX package in
test_torch_poisson.py. Every comparison is exact."""
import numpy as np
import pytest
import torch

from schwarzwald_tpu_torch.ops import indexing, poisson_cuda

torch.set_num_threads(1)

EXTENT = 64.0


def sorted_uniform(n, seed, extent=EXTENT, lo=0.0):
    pos = np.random.default_rng(seed).uniform(lo, extent, (n, 3))
    keys, pos = indexing.index_points(pos, np.zeros(3), np.full(3, extent))
    return pos[indexing.sort_by_key(keys)]


def clustered(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(4.0, EXTENT - 4.0, (n // 200, 3))
    pos = np.concatenate([c + rng.normal(0.0, 0.8, (200, 3))
                          for c in centers])
    pos = np.clip(pos, 0.0, EXTENT - 1e-9)
    keys, pos = indexing.index_points(pos, np.zeros(3), np.full(3, EXTENT))
    return pos[indexing.sort_by_key(keys)]


def spacing_edge(axis, block=128, s=0.1):
    """Two blocks: the first ends with anchors, the second starts with one
    point per anchor at exactly, and a hair inside and outside, the
    float32 spacing along `axis` (as test_torch_poisson's prune test)."""
    other = (axis + 1) % 3
    sf = float(np.float32(s))
    dists = (sf, np.nextafter(sf, 0.0), np.nextafter(sf, 1.0),
             sf * (1 - 1e-7), sf * (1 + 1e-7), sf * (1 - 1e-6),
             sf * (1 + 1e-6))
    far = np.zeros((block, 3))
    far[:, axis] = -10.0 * s * np.arange(block, 0, -1)
    near = np.full((block, 3), 50.0)
    near[:, other] = 50.0 + 10.0 * s * np.arange(block)
    for k, d in enumerate(dists):
        anchor = block - len(dists) + k
        far[anchor] = 0.0
        far[anchor, other] = 20.0 * s * k
        near[k] = far[anchor]
        near[k, axis] = d
    return np.concatenate([far, near])


def tensors(p):
    return [None if a is None else torch.from_numpy(a)
            for a in (p.planes, p.analyze, p.pair_ptr, p.pair_bj)]


def with_analyze(n, stride):
    if stride is None:
        return None
    analyze = np.zeros(n, dtype=bool)
    analyze[::stride] = True
    return analyze


def brute_force_lists(p):
    """Each point's earlier close points, by the definition: analyzed i
    and j < i, d2 = (dx*dx + dy*dy) + dz*dz < sq in the mode's dtype."""
    x = p.planes
    sq = x.dtype.type(p.sq)
    n = p.n
    ok = np.ones(n, dtype=bool) if p.analyze is None else p.analyze != 0
    d = [x[a][:, None] - x[a][None, :] for a in range(3)]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    close = (d2 < sq) & np.tri(n, k=-1, dtype=bool)
    close &= ok[:, None] & ok[None, :]
    return [np.nonzero(row)[0] for row in close]


# -- the pair CSR on the device's side ------------------------------------------

CSR_CASES = {
    "uniform_5000": (lambda: sorted_uniform(5000, 1), 2.0, 512),
    "uniform_small_blocks": (lambda: sorted_uniform(3000, 2), 1.0, 64),
    "clustered_6000": (lambda: clustered(6000, 3), 0.6, 128),
    "partial_block_4099": (lambda: sorted_uniform(4099, 4), 4.0, 512),
}


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_pair_csr_torch_equals_numpy(case, precision):
    make, spacing, block = CSR_CASES[case]
    pos = make()
    p = poisson_cuda.prep(pos, spacing, None, precision, block=block)
    planes = torch.from_numpy(p.planes)
    ptr, bj = poisson_cuda.pair_csr_torch(
        planes, poisson_cuda.inflation(spacing),
        poisson_cuda.MAX_PAIRS_PER_BLOCK * p.n_blocks, block)
    assert ptr.dtype == torch.int32 and bj.dtype == torch.int32
    np.testing.assert_array_equal(ptr.numpy(), p.pair_ptr)
    np.testing.assert_array_equal(bj.numpy(), p.pair_bj)
    assert p.pair_bj.size > 0


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pair_csr_torch_keeps_pairs_at_exactly_spacing(precision, axis):
    pos = spacing_edge(axis)
    p = poisson_cuda.prep(pos, 0.1, None, precision, block=128)
    ptr, bj = poisson_cuda.pair_csr_torch(
        torch.from_numpy(p.planes), poisson_cuda.inflation(0.1),
        poisson_cuda.MAX_PAIRS_PER_BLOCK * p.n_blocks, 128)
    assert bj[ptr[1]:ptr[2]].tolist() == [0]
    np.testing.assert_array_equal(ptr.numpy(), p.pair_ptr)
    np.testing.assert_array_equal(bj.numpy(), p.pair_bj)


def test_pair_csr_torch_above_2_20_points():
    n = (1 << 20) + 4096
    pos = sorted_uniform(n, 13, extent=256.0)
    p = poisson_cuda.prep(pos, 2.0)
    ptr, bj = poisson_cuda.pair_csr_torch(
        torch.from_numpy(p.planes), poisson_cuda.inflation(2.0),
        poisson_cuda.MAX_PAIRS_PER_BLOCK * p.n_blocks)
    assert ptr.numel() == p.n_blocks + 1
    np.testing.assert_array_equal(ptr.numpy(), p.pair_ptr)
    np.testing.assert_array_equal(bj.numpy(), p.pair_bj)


def test_pair_csr_torch_gate():
    """All points inside one spacing ball: the gate trips in both."""
    pos = np.random.default_rng(11).uniform(0.0, 0.01, (200_000, 3))
    planes = torch.from_numpy(np.ascontiguousarray(pos.T))
    nb = -(-pos.shape[0] // poisson_cuda.BLOCK)
    assert poisson_cuda.prep(pos, 5.0) is None
    assert poisson_cuda.pair_csr_torch(
        planes, poisson_cuda.inflation(5.0),
        poisson_cuda.MAX_PAIRS_PER_BLOCK * nb) is None


# -- phase A: the close lists ----------------------------------------------------

PHASE_CASES = {
    "uniform": (lambda: sorted_uniform(2000, 5), 2.5, None),
    "duplicates": (lambda: np.concatenate(
        [sorted_uniform(1000, 6)[:500], np.repeat(
            sorted_uniform(1000, 6)[500:501], 30, axis=0),
         sorted_uniform(1000, 6)[501:]]), 1.0, None),
    "clustered": (lambda: clustered(2000, 7), 0.6, None),
    "analyze3": (lambda: sorted_uniform(2000, 8), 3.0, 3),
}


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(PHASE_CASES))
def test_close_lists_equal_brute_force(case, precision):
    make, spacing, stride = PHASE_CASES[case]
    pos = make()
    analyze = with_analyze(pos.shape[0], stride)
    block = 128
    p = poisson_cuda.prep(pos, spacing, analyze, precision, block=block)
    planes, ana, ptr, bj = tensors(p)
    offsets, idx, blocked = poisson_cuda.close_lists_torch(
        planes, ana, p.sq, ptr, bj, block)
    nb, n = p.n_blocks, p.n
    assert offsets.shape == (nb * block + 1,) and idx.dtype == torch.int32
    want = brute_force_lists(p)
    offsets, idx = offsets.numpy(), idx.numpy()
    for i in range(n):
        got = idx[offsets[i]:offsets[i + 1]]
        np.testing.assert_array_equal(np.sort(got), want[i], err_msg=str(i))
    assert (offsets[n:] == offsets[n]).all()  # padding lists nothing
    ok = np.ones(n, dtype=bool) if analyze is None else analyze
    np.testing.assert_array_equal(blocked.numpy()[:n], ~ok)
    assert blocked.numpy()[n:].all()
    assert sum(w.size for w in want) > 0

    # the wait set of phase B: earlier blocks that hold a close point, a
    # subset of the block's AABB pairs
    deps = poisson_cuda.block_deps(torch.from_numpy(offsets),
                                   torch.from_numpy(idx), n, block)
    assert len(deps) == nb
    for b, ds in enumerate(deps):
        pairs = set(p.pair_bj[p.pair_ptr[b]:p.pair_ptr[b + 1]].tolist())
        assert set(ds) <= pairs, b
        assert ds == sorted(set(ds)) and all(d < b for d in ds)
    chain = poisson_cuda.longest_chain(deps)
    assert 1 <= chain <= nb


def test_close_lists_order_is_pair_order():
    """Within a point's list: the listed blocks bj ascending, then its own
    block, each in point order (the kernel's filling order)."""
    pos = sorted_uniform(3000, 9)
    p = poisson_cuda.prep(pos, 4.0, block=128)
    offsets, idx, _ = poisson_cuda.close_lists_torch(*tensors(p)[:2], p.sq,
                                                     *tensors(p)[2:], 128)
    for i in range(p.n):
        got = idx[offsets[i]:offsets[i + 1]].numpy()
        assert (np.diff(got) > 0).all()
        assert (got < i).all()


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_decide_torch_equals_block_sequential(precision):
    pos = clustered(3000, 10)
    p = poisson_cuda.prep(pos, 0.5, None, precision, block=128)
    planes, ana, ptr, bj = tensors(p)
    lists = poisson_cuda.close_lists_torch(planes, ana, p.sq, ptr, bj, 128)
    got = poisson_cuda.decide_torch(p.n, *lists, 128)
    want = poisson_cuda.accept_mask_torch(planes, ana, p.sq, ptr, bj, 128)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < p.n


# -- windows -----------------------------------------------------------------------

@pytest.mark.parametrize("stride", [None, 4])
@pytest.mark.parametrize("share", [0.0, 0.1, 0.6])
def test_windows_leave_the_mask_unchanged(share, stride):
    """A budget of `share` of the range's close pairs (at least 1)."""
    pos = sorted_uniform(4000, 11)
    analyze = with_analyze(4000, stride)
    p = poisson_cuda.prep(pos, 3.0, analyze, block=128)
    planes, ana, ptr, bj = tensors(p)
    offsets, _, _ = poisson_cuda.close_lists_torch(planes, ana, p.sq, ptr,
                                                   bj, 128)
    totals = (offsets[128::128] - offsets[:-1:128]).numpy()
    budget = max(1, int(totals.sum() * share))
    assert len(poisson_cuda.plan_windows(totals, budget)) > 1
    got = poisson_cuda.accept_mask_two_phase_torch(planes, ana, p.sq, ptr,
                                                   bj, 128, budget)
    want = poisson_cuda.accept_mask_torch(planes, ana, p.sq, ptr, bj, 128)
    assert torch.equal(got, want)


def test_window_lists_hold_only_pairs_inside_the_window():
    """A later window lists only close points inside itself; a close point
    of an earlier window that was accepted blocks the point instead."""
    pos = sorted_uniform(2000, 12)
    p = poisson_cuda.prep(pos, 3.0, block=128)
    planes, ana, ptr, bj = tensors(p)
    out = poisson_cuda.accept_mask_torch(planes, ana, p.sq, ptr, bj, 128)
    b0, b1 = 5, 9
    offsets, idx, blocked = poisson_cuda.close_lists_torch(
        planes, ana, p.sq, ptr, bj, 128, b0, b1, out)
    assert offsets.shape == ((b1 - b0) * 128 + 1,)
    assert (idx >= b0 * 128).all()
    want = brute_force_lists(p)
    for li in range((b1 - b0) * 128):
        i = b0 * 128 + li
        early = want[i][want[i] < b0 * 128]
        assert bool(blocked[li]) == bool(out[early].any()), i
        inside = want[i][want[i] >= b0 * 128]
        got = idx[offsets[li]:offsets[li + 1]].numpy()
        np.testing.assert_array_equal(got, inside)
    mask = poisson_cuda.decide_torch(p.n, offsets, idx, blocked, 128, b0,
                                     b1, out.clone())
    assert torch.equal(mask, out)


def test_plan_windows():
    totals = np.array([5, 5, 5, 50, 1, 1, 1], dtype=np.int64)
    assert poisson_cuda.plan_windows(totals, 10) == [
        (0, 2), (2, 3), (3, 4), (4, 7)]
    assert poisson_cuda.plan_windows(totals, 1000) == [(0, 7)]
    assert poisson_cuda.plan_windows(totals, 0) == [
        (b, b + 1) for b in range(7)]
    # a window past the budget is one block, which then stores at most its
    # own intra pairs
    assert poisson_cuda._list_capacity(totals, [(0, 2), (2, 3), (3, 4)],
                                       10, 8) == 28


def test_longest_chain():
    assert poisson_cuda.longest_chain([[], [0], [1], [0], [2, 3]]) == 4
    assert poisson_cuda.longest_chain([[], [], []]) == 1
    assert poisson_cuda.longest_chain([]) == 0


def test_phase_kernels_need_cuda_tensors():
    p = poisson_cuda.prep(sorted_uniform(4096, 3), 2.0)
    planes, ana, ptr, bj = tensors(p)
    before = poisson_cuda.snapshot()["launches"]
    with pytest.raises(ValueError, match="CUDA"):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj)
    with pytest.raises(ValueError, match="CUDA"):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj,
                                      stats={})
    with pytest.raises(ValueError, match="CUDA"):
        poisson_cuda.range_mask_cuda(sorted_uniform(4096, 3), 2.0,
                                     device="cpu")
    assert poisson_cuda.snapshot()["launches"] == before


def test_each_thread_keeps_one_stream(monkeypatch):
    """thread_stream hands a thread the same stream on every call, whether
    the device names its index or not, and another thread another stream
    (the stream maker, `own_stream`, stood in for by a recorder, as this
    machine has no card)."""
    import threading

    made = []

    class Recorder:
        def __init__(self, device):
            self.device = torch.device(device)
            made.append(self)

    monkeypatch.setattr(poisson_cuda, "_tls", threading.local())
    monkeypatch.setattr(poisson_cuda, "own_stream", Recorder)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mine = [poisson_cuda.thread_stream(d)
            for d in (torch.device("cuda"), "cuda", "cuda:0",
                      torch.device("cuda", 0))]
    assert all(s is mine[0] for s in mine)
    assert mine[0].device == torch.device("cuda", 0)
    other = []
    worker = threading.Thread(target=lambda: other.extend(
        poisson_cuda.thread_stream("cuda") for _ in range(3)))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    assert all(s is other[0] for s in other) and other[0] is not mine[0]
    assert len(made) == 2


def test_thread_stream_needs_a_cuda_device():
    """As range_mask_cuda: a CPU device raises, and no stream is made."""
    for dev in ("cpu", torch.device("cpu")):
        with pytest.raises(ValueError, match="CUDA device"):
            poisson_cuda.thread_stream(dev)


class _FakeStreamLib:
    """poisson_stream_create without a card: each call hands out a new
    handle and records it."""

    def __init__(self):
        import ctypes

        self.made = []

        def create(out):
            self.made.append(0x1000 + len(self.made))
            ctypes.cast(out, ctypes.POINTER(ctypes.c_void_p))[0] = \
                self.made[-1]
            return 0

        self.poisson_stream_create = create


def test_each_thread_gets_a_stream_made_for_it(monkeypatch):
    """Each thread's stream comes from the stream maker outside PyTorch's
    pool (poisson_stream_create, wrapped as an ExternalStream on the
    thread's device), once per thread: 8 threads alive at once get 8
    handles, a thread's later calls its own, and a thread that moves to
    another device a new one. No handle is made twice, so none can reach
    two threads."""
    import contextlib
    import threading

    from schwarzwald_tpu_torch.ops import _cuda_build

    lib = _FakeStreamLib()

    class External:
        def __init__(self, handle, device):
            self.cuda_stream, self.device = handle, device

    monkeypatch.setattr(poisson_cuda, "_tls", threading.local())
    monkeypatch.setattr(_cuda_build, "load_kernel_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "ExternalStream", External)
    monkeypatch.setattr(torch.cuda, "Stream", None)  # the pool is not asked
    handles, ready = [], threading.Barrier(8)

    def send():
        handles.append(poisson_cuda.thread_stream("cuda:0").cuda_stream)
        assert poisson_cuda.thread_stream("cuda:0").cuda_stream == handles[-1]
        ready.wait(timeout=30)  # all eight alive at once

    threads = [threading.Thread(target=send) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(handles) == lib.made and len(set(handles)) == 8
    first = poisson_cuda.thread_stream("cuda:0")
    assert first.device == torch.device("cuda", 0)
    moved = poisson_cuda.thread_stream("cuda:1")
    assert moved.device == torch.device("cuda", 1)
    assert len(set(lib.made)) == len(lib.made) == 10

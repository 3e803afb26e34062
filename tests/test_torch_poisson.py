"""The port's Poisson-disk accept mask (ops/poisson_cuda plain-torch
versions: the block-sequential one and the kernels' two-phase path, windows
included) against the JAX package: the Pallas kernel in interpret mode and
the f32 greedy oracle (f32 mode), the XLA relaxation on the cpu backend and
the native host kernel (f64 mode). Every comparison is exact: a mask is a
sequence of comparisons, with no reduction whose order could differ."""
import numpy as np
import pytest
import torch

from schwarzwald_tpu.core.aabb import AABB
from schwarzwald_tpu.ops import indexing as jax_indexing
from schwarzwald_tpu.ops import poisson_pallas, sampling as jax_sampling
from schwarzwald_tpu.ops.device_poisson import \
    poisson_accept_mask_device as jax_device_mask
from schwarzwald_tpu_torch import native as port_native
from schwarzwald_tpu_torch.ops import device_poisson, poisson_cuda
from test_poisson_pallas import oracle_f32, sorted_uniform

torch.set_num_threads(1)

BOUNDS = AABB([0.0, 0.0, 0.0], [64.0, 64.0, 64.0])


def two_phase_masks(p):
    """The two-phase plain path of a prepped range, in one window and with
    a budget so small that every block is a window of its own."""
    t = [None if a is None else torch.from_numpy(a)
         for a in (p.planes, p.analyze, p.pair_ptr, p.pair_bj)]
    return [poisson_cuda.accept_mask_two_phase_torch(
                t[0], t[1], p.sq, t[2], t[3], p.block, budget).numpy()
            .view(bool) for budget in (poisson_cuda.CLOSE_BUDGET, 1)]


def port_mask(pos, spacing, analyze=None, precision="f64",
              block=poisson_cuda.BLOCK):
    """The block-sequential plain mask, after checking that the two-phase
    plain path gives the same."""
    p = poisson_cuda.prep(pos, spacing, analyze, precision, block=block)
    assert p is not None
    mask = poisson_cuda.accept_mask(p, "cpu")
    for two_phase in two_phase_masks(p):
        np.testing.assert_array_equal(two_phase, mask)
    return mask


def native_mask(pos, spacing, analyze=None):
    kernel = port_native.poisson_sample_kernel()
    assert kernel is not None
    return kernel(pos, BOUNDS.min, BOUNDS.max, spacing, analyze)


def sorted_cloud(rng, n):
    pos = rng.uniform(BOUNDS.min, BOUNDS.max, (n, 3))
    keys, pos = jax_indexing.index_points(pos, BOUNDS.min, BOUNDS.max)
    order = jax_indexing.sort_by_key(keys)
    return keys[order], pos[order]


# -- f32 mode: Pallas kernel (interpret) and oracle_f32 ----------------------

@pytest.mark.parametrize("n,spacing,seed", [(4096, 2.0, 7), (6000, 1.0, 8)])
def test_f32_matches_pallas_and_oracle(n, spacing, seed):
    pos = sorted_uniform(n, seed)
    got = port_mask(pos, spacing, precision="f32")
    pallas = poisson_pallas.poisson_accept_mask_pallas(pos, spacing,
                                                       interpret=True)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle_f32(pos, spacing))
    assert 0 < got.sum() < n


def test_f32_analyze_mask_strided():
    pos = sorted_uniform(4096, 9)
    analyze = np.zeros(4096, dtype=bool)
    analyze[::3] = True
    got = port_mask(pos, 2.5, analyze, precision="f32")
    pallas = poisson_pallas.poisson_accept_mask_pallas(pos, 2.5, analyze,
                                                       interpret=True)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle_f32(pos, 2.5, analyze))
    assert not got[~analyze].any()


def test_f32_duplicate_points_first_wins():
    pos = sorted_uniform(4096, 10)
    pos[100:110] = pos[99]
    got = port_mask(pos, 1.0, precision="f32")
    pallas = poisson_pallas.poisson_accept_mask_pallas(pos, 1.0,
                                                       interpret=True)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle_f32(pos, 1.0))
    assert not got[100:110].any()


# -- f64 mode: JAX relaxation (cpu backend) and the native kernel ------------

@pytest.mark.parametrize("spacing,n", [(8.0, 5000), (2.0, 8000), (0.5, 8000)])
def test_f64_matches_jax_relax_and_native(rng, on_cpu, spacing, n):
    keys, pos = sorted_cloud(rng, n)
    got = device_poisson.poisson_accept_mask_device(keys, pos, 64.0, spacing,
                                                    backend="cpu")
    want = jax_device_mask(keys, pos, 64.0, spacing, backend="cpu")
    assert want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native_mask(pos, spacing))
    for two_phase in two_phase_masks(poisson_cuda.prep(pos, spacing)):
        np.testing.assert_array_equal(two_phase, want)
    assert 0 < got.sum() < n


def test_f64_clustered_matches_jax_relax(rng, on_cpu):
    centers = rng.uniform(1.0, 63.0, (40, 3))
    pos = np.concatenate([c + rng.normal(0, 0.8, (120, 3)) for c in centers])
    pos = np.clip(pos, 0.0, 64.0 - 1e-9)
    keys, pos = jax_indexing.index_points(pos, BOUNDS.min, BOUNDS.max)
    order = jax_indexing.sort_by_key(keys)
    keys, pos = keys[order], pos[order]
    got = port_mask(pos, 0.6)
    want = jax_device_mask(keys, pos, 64.0, 0.6, backend="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native_mask(pos, 0.6))


def test_f64_analyze_mask_matches_jax_relax(rng, on_cpu):
    keys, pos = sorted_cloud(rng, 6000)
    analyze = np.zeros(6000, dtype=bool)
    analyze[::4] = True
    got = device_poisson.poisson_accept_mask_device(
        keys, pos, 64.0, 2.0, analyze, backend="cpu")
    want = jax_device_mask(keys, pos, 64.0, 2.0, analyze, backend="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_sampling._poisson_accept_mask(pos, BOUNDS.min, BOUNDS.max,
                                               2.0, analyze))
    for two_phase in two_phase_masks(poisson_cuda.prep(pos, 2.0, analyze)):
        np.testing.assert_array_equal(two_phase, want)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_mask_independent_of_block_size(precision):
    pos = sorted_uniform(5000, 12)
    masks = [port_mask(pos, 2.0, precision=precision, block=b)
             for b in (512, 128)]
    np.testing.assert_array_equal(masks[0], masks[1])
    ref = (native_mask(pos, 2.0) if precision == "f64"
           else oracle_f32(pos, 2.0))
    np.testing.assert_array_equal(masks[0], ref)


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_prune_keeps_pairs_at_exactly_spacing(precision, axis):
    """Block 0 ends with anchor points on the plane axis == 0; block 1
    starts with one point per anchor at exactly `spacing` from it, and a
    hair inside and outside that distance, along `axis`. The AABB prune
    must pair the blocks, and the close test alone decides (strict <:
    exactly `spacing` is not close)."""
    block = 128
    s = 0.1  # not a binary fraction: float32 rounding is in play
    other = (axis + 1) % 3
    sf = float(np.float32(s))
    dists = (sf, np.nextafter(sf, 0.0), np.nextafter(sf, 1.0),
             sf * (1 - 1e-7), sf * (1 + 1e-7), sf * (1 - 1e-6),
             sf * (1 + 1e-6))
    far = np.zeros((block, 3))
    far[:, axis] = -10.0 * s * np.arange(block, 0, -1)  # 10s apart
    near = np.full((block, 3), 50.0)
    near[:, other] = 50.0 + 10.0 * s * np.arange(block)
    for k, d in enumerate(dists):
        anchor = block - len(dists) + k
        far[anchor] = 0.0
        far[anchor, other] = 20.0 * s * k  # anchors 20s apart
        near[k] = far[anchor]
        near[k, axis] = d
    pos = np.concatenate([far, near])
    p = poisson_cuda.prep(pos, s, None, precision, block=block)
    assert p.pair_bj[p.pair_ptr[1]:p.pair_ptr[2]].tolist() == [0]
    got = poisson_cuda.accept_mask(p, "cpu")
    want = (native_mask(pos, s) if precision == "f64"
            else oracle_f32(pos, s))
    np.testing.assert_array_equal(got, want)
    for two_phase in two_phase_masks(p):
        np.testing.assert_array_equal(two_phase, want)
    assert got[:block].all()  # block 0's points are all >= 10s apart
    k_in = dists.index(sf * (1 - 1e-6))
    k_out = dists.index(sf * (1 + 1e-6))
    assert not got[block + k_in] and got[block + k_out]


# -- gates -------------------------------------------------------------------

def test_pair_gate_dense_adjacency():
    """All points inside one spacing ball: every block pairs with every
    other, the gate trips in both packages, and the port counts it."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0.0, 0.01, (200_000, 3))
    assert poisson_pallas._prep(pos, 5.0, None) is None
    assert poisson_cuda.prep(pos, 5.0) is None
    before = poisson_cuda.snapshot()["pair_gate"]
    keys = np.zeros(pos.shape[0], dtype=np.uint64)
    assert device_poisson.poisson_accept_mask_device(
        keys, pos, 1.0, 5.0, backend="cpu") is None
    assert poisson_cuda.snapshot()["pair_gate"] == before + 1


def test_range_above_2_20_gets_a_pair_list():
    """The Pallas kernel's VMEM cap (2^20 points) is not the port's."""
    n = (1 << 20) + 4096
    rng = np.random.default_rng(13)
    pos = rng.uniform(0.0, 256.0, (n, 3))
    keys, pos = jax_indexing.index_points(pos, np.zeros(3), np.full(3, 256.0))
    pos = pos[jax_indexing.sort_by_key(keys)]
    assert poisson_pallas._prep(pos, 2.0, None) is None
    p = poisson_cuda.prep(pos, 2.0)
    assert p is not None
    assert p.n_blocks == -(-n // poisson_cuda.BLOCK)
    assert p.planes.shape == (3, n) and p.planes.dtype == np.float64
    assert p.pair_ptr[-1] == p.pair_bj.size
    assert (np.diff(p.pair_ptr) >= 0).all()
    rows = np.repeat(np.arange(p.n_blocks), np.diff(p.pair_ptr))
    assert (p.pair_bj < rows).all()
    assert p.pair_bj.size + p.n_blocks <= (poisson_cuda.MAX_PAIRS_PER_BLOCK
                                           * p.n_blocks)


def test_empty_and_nonpositive_spacing():
    assert poisson_cuda.prep(np.zeros((0, 3)), 1.0) is None
    assert poisson_cuda.prep(np.zeros((16, 3)), -1.0) is None
    assert device_poisson.poisson_accept_mask_device(
        np.zeros(0, np.uint64), np.zeros((0, 3)), 1.0, 1.0,
        backend="cpu").shape == (0,)


def test_squared_spacing_is_the_float32_product():
    s = 0.1
    want = np.float32(s) * np.float32(s)
    assert poisson_cuda.squared_spacing(s, "f64") == float(want)
    assert np.float32(poisson_cuda.squared_spacing(s, "f32")) == want


# -- the wrapper refuses what the kernel does not take ------------------------

def test_kernel_wrapper_needs_cuda_tensors():
    p = poisson_cuda.prep(sorted_uniform(4096, 3), 2.0)
    planes = torch.from_numpy(p.planes)
    with pytest.raises(ValueError, match="CUDA"):
        poisson_cuda.accept_mask_cuda(planes, None, p.sq,
                                      torch.from_numpy(p.pair_ptr),
                                      torch.from_numpy(p.pair_bj))
    assert poisson_cuda.snapshot()["launches"] == 0


def test_device_backend_must_be_known():
    pos = sorted_uniform(4096, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        device_poisson.poisson_accept_mask_device(
            np.zeros(4096, np.uint64), pos, 64.0, 2.0, backend="tpu")


# -- counters under concurrent callers -----------------------------------------

def test_counters_lose_no_update_under_threads():
    """The engine samples from a thread pool: counts must not race."""
    import sys
    import threading

    poisson_cuda.reset_counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [poisson_cuda.count("plain") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert poisson_cuda.snapshot()["plain"] == 16 * 2000
    poisson_cuda.reset_counters()
    assert poisson_cuda.snapshot() == {"launches": 0, "below_floor": 0,
                                       "pair_gate": 0, "kernel": 0,
                                       "plain": 0}

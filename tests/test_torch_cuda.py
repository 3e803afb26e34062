"""The Poisson CUDA kernel (csrc/poisson.cu) against its plain-torch version
on the card, on small cases. Needs a CUDA card and nvcc; skipped without
a card. Imports nothing of JAX, so on a machine without it run:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from schwarzwald_tpu_torch import native
from schwarzwald_tpu_torch.core.aabb import AABB
from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
from schwarzwald_tpu_torch.io.memory import MemoryPersistence
from schwarzwald_tpu_torch.ops import indexing, poisson_cuda
from schwarzwald_tpu_torch.ops.sampling import SamplingStrategy
from schwarzwald_tpu_torch.tiling import (TilerMetaParameters, TilingStrategy,
                                          make_tiling_algorithm)

pytestmark = pytest.mark.cuda

EXTENT = 64.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def sorted_uniform(n, seed, lo=(0.0, 0.0, 0.0), hi=(EXTENT,) * 3):
    pos = np.random.default_rng(seed).uniform(lo, hi, (n, 3))
    keys, pos = indexing.index_points(pos, np.zeros(3), np.full(3, EXTENT))
    return pos[indexing.sort_by_key(keys)]


def on_card(p, device):
    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)
    return t(p.planes), t(p.analyze), t(p.pair_ptr), t(p.pair_bj)


def cases():
    dup = sorted_uniform(4096, 3)
    dup[100:140] = dup[99]
    analyze = np.zeros(5000, dtype=bool)
    analyze[::3] = True
    return {
        "uniform_4096": (sorted_uniform(4096, 1), 2.0, None),
        "partial_block_5000": (sorted_uniform(5000, 2), 1.0, None),
        "single_block_300": (sorted_uniform(300, 4), 8.0, None),
        "duplicates_4096": (dup, 1.0, None),
        "analyze3_5000": (sorted_uniform(5000, 5), 2.0, analyze),
    }


@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", sorted(cases()))
def test_kernel_matches_plain_version(cuda, precision, case):
    pos, spacing, analyze = cases()[case]
    p = poisson_cuda.prep(pos, spacing, analyze, precision)
    planes, ana, ptr, bj = on_card(p, cuda)
    got = poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj)
    want = poisson_cuda.accept_mask_torch(planes, ana, p.sq, ptr, bj)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    if precision == "f64":
        host = native.poisson_sample_kernel()(
            pos, np.zeros(3), np.full(3, EXTENT), spacing, analyze)
        np.testing.assert_array_equal(got.cpu().numpy().view(bool), host)


def test_each_launch_counts_once(cuda):
    p = poisson_cuda.prep(sorted_uniform(4096, 6), 2.0)
    planes, ana, ptr, bj = on_card(p, cuda)
    before = poisson_cuda.snapshot()["launches"]
    for _ in range(3):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj)
    poisson_cuda.accept_mask_torch(planes, ana, p.sq, ptr, bj)
    assert poisson_cuda.snapshot()["launches"] == before + 3


def test_wrapper_checks_its_inputs(cuda):
    p = poisson_cuda.prep(sorted_uniform(4096, 7), 2.0)
    planes, ana, ptr, bj = on_card(p, cuda)
    with pytest.raises(TypeError):
        poisson_cuda.accept_mask_cuda(planes.to(torch.int32), ana, p.sq,
                                      ptr, bj)
    with pytest.raises(ValueError, match="contiguous"):
        poisson_cuda.accept_mask_cuda(planes.t().contiguous().t(), ana,
                                      p.sq, ptr, bj)
    with pytest.raises(ValueError, match="pair_ptr"):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr[:-1], bj)
    with pytest.raises(ValueError, match="pair_bj"):
        poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr, bj.cpu())


@pytest.mark.parametrize("sampler", ["MIN_DISTANCE", "MIN_DISTANCE_FAST"])
def test_engine_through_the_kernel_equals_host(cuda, sampler):
    pos = np.random.default_rng(8).uniform([0.0] * 3,
                                           [EXTENT, EXTENT / 2, EXTENT / 2],
                                           (12_000, 3))
    bounds = AABB([0.0] * 3, [EXTENT] * 3)

    def run(use_device):
        persistence = MemoryPersistence()
        meta = TilerMetaParameters(spacing_at_root=1.0,
                                   max_points_per_node=500, concurrency=4,
                                   use_device=use_device)
        algo = make_tiling_algorithm(TilingStrategy.Fast,
                                     SamplingStrategy(sampler, 500),
                                     persistence, meta)
        algo.level_of_start_nodes = 1
        algo.process_batch(PointBuffer(pos.copy()), bounds)
        algo.finalize(bounds)
        return persistence

    host = run(None)
    before = poisson_cuda.snapshot()["launches"]
    dev = run("cuda")
    assert poisson_cuda.snapshot()["launches"] == before + 3
    assert set(host.node_names()) == set(dev.node_names())
    for name in host.node_names():
        np.testing.assert_array_equal(dev.retrieve_points(name).positions,
                                      host.retrieve_points(name).positions,
                                      err_msg=name)

"""The kernels' sanitizer checker (ops/sanitize_kernels.py) without a card:
its cases do not depend on which are asked for, its checks run the plain
versions it holds the kernels against, and it refuses to run without a
card. On the card it runs in chip_smoke.py's phase 8 and in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from schwarzwald_tpu_torch import native
from schwarzwald_tpu_torch.ops import morton_cuda, poisson_cuda
from schwarzwald_tpu_torch.ops import sanitize_kernels as sk


def test_a_case_is_the_same_whichever_others_are_asked_for():
    """The cases are drawn in one order from one seed, so the checker's
    subset holds the points phase 2 times."""
    alone = sk.poisson_cases({"dense_92160"})
    both = sk.poisson_cases({"uniform_4096", "dense_92160"})
    assert [c[0] for c in alone] == ["dense_92160"]
    assert [c[0] for c in both] == ["uniform_4096", "dense_92160"]
    np.testing.assert_array_equal(alone[0][1], both[1][1])
    assert alone[0][2:5:2] == (6.0, 10.0)


def test_edited_cases_hold_their_edits():
    dup, ana = sk.poisson_cases({"duplicates_262144", "analyze3_262144"})
    assert (dup[1][5000:6000] == dup[1][4999]).all() and dup[3] is None
    assert ana[3].sum() == -(-262_144 // 3) and ana[3][::3].all()
    for name, pos, _, _, ext, modes in (dup, ana):
        assert pos.shape == (262_144, 3) and modes == ("f64", "f32")
        assert (pos >= 0).all() and (pos <= ext).all()


def test_sanitized_cases_are_phase_2_cases():
    names = {c[0] for c in sk.poisson_cases(set(sk.SANITIZED_CASES))}
    assert names == set(sk.SANITIZED_CASES) and sk.THREADS_CASE in names


def test_edge_and_gate_cases_sit_where_they_claim():
    """The prep's edge cases: 1 block, and one launch's limit less one, at
    it and one past it, and the group boxes' limit less one and at it; the
    gate cases at and one past the pair gate's capacity, in one launch and
    in two, a CTA a row and with group boxes."""
    nbs = {c[0]: (-(-c[1].shape[0] // poisson_cuda.BLOCK), c[3] is not None)
           for c in sk.poisson_cases(set(sk.EDGE_CASES))}
    one = poisson_cuda.PREP_ONE_LAUNCH
    assert nbs == {"uniform_300": (1, False),
                   "analyze3_261532": (one - 1, True),
                   "edge_262144": (one, False),
                   "uniform_262145": (one + 1, False),
                   "uniform_1637888": (poisson_cuda.PREP_GROUPED_FROM - 1,
                                       False),
                   "uniform_1637889": (poisson_cuda.PREP_GROUPED_FROM,
                                       False)}
    assert set(sk.EDGE_CASES) <= set(sk.SANITIZED_CASES)
    launches = []
    for name, pos, spacing in sk.gate_cases():
        planes = torch.from_numpy(pos).t().contiguous()
        nb = -(-pos.shape[0] // poisson_cuda.BLOCK)
        _, bj = poisson_cuda.pair_csr_torch(
            planes, poisson_cuda.inflation(spacing), 1 << 62)
        cap = poisson_cuda.gate_capacity(nb)
        assert bj.numel() == (cap if "at_limit" in name else cap + 1), name
        launches.append((poisson_cuda.prep_launches_per_range(nb),
                         poisson_cuda.prep_grouped(nb)))
    assert [c[0] for c in sk.gate_cases()] == list(sk.GATE_CASES)
    assert launches == [(1, False), (1, False), (2, False), (2, False),
                        (2, True), (2, True)]


def test_edge_coords_hold_the_one_hot_rows():
    axes = sk.edge_coords(1000, 1)
    oh = [1 << i for i in range(21)] + [0, (1 << 21) - 1]
    for a in range(3):
        assert axes[a].dtype == np.int32 and axes[a].max() < 1 << 21
        assert axes[a][a * 23:(a + 1) * 23].tolist() == oh
    keys = morton_cuda.interleave21(*(torch.from_numpy(a) for a in axes))
    assert keys[22].item() == 0x1249249249249249 << 2  # x all ones
    assert keys[23 + 22].item() == 0x1249249249249249 << 1  # y all ones


def test_plain_mask_is_the_native_host_kernels():
    """The plain mask the checker holds K2 against, on the CPU: the native
    host kernel's mask of the same range."""
    name, pos, spacing, analyze, ext, _ = sk.poisson_cases(
        {"analyze3_262144"})[0]
    pos, analyze = pos[:20_000], analyze[:20_000]
    p, tensors, mask = sk.plain_mask(pos, spacing, analyze, "f64", "cpu")
    assert p.n == 20_000 and tensors[0].shape == (3, 20_000)
    want = native.poisson_sample_kernel()(pos, np.zeros(3), np.full(3, ext),
                                          spacing, analyze)
    np.testing.assert_array_equal(mask.numpy().view(bool), want)


def test_k2_check_needs_a_card():
    """On CPU tensors the kernel's wrapper raises before any launch."""
    case = sk.poisson_cases({"uniform_4096"})[0]
    before = poisson_cuda.snapshot()["launches"]
    with pytest.raises(ValueError):
        sk.check_k2(case, "f64", torch.device("cpu"))
    assert poisson_cuda.snapshot()["launches"] == before


@pytest.mark.parametrize("poison", [True, False])
def test_poisoned_fills_empty_tensors_only_inside(monkeypatch, poison):
    """Under --poison the kernels' torch.empty buffers hold NaN or the
    type's largest value, and only inside `poisoned()`: the plain versions
    outside run in the mode the caller had."""
    monkeypatch.setattr(sk, "POISON", poison)
    before = torch.are_deterministic_algorithms_enabled()
    with sk.poisoned():
        assert torch.are_deterministic_algorithms_enabled() is (poison
                                                                or before)
        if poison:
            assert torch.isnan(torch.empty(1000, dtype=torch.float64)).all()
            assert (torch.empty(1000, dtype=torch.uint8) == 255).all()
            assert (torch.empty(100, dtype=torch.int64)
                    == torch.iinfo(torch.int64).max).all()
    assert torch.are_deterministic_algorithms_enabled() is before


def test_checker_refuses_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert sk.main(["--self-check"]) == 1
    assert "no CUDA card" in capsys.readouterr().err

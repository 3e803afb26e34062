"""The port's batch step (schwarzwald_tpu_torch/ops/device.py) against the
JAX package on the CPU: the plain version of kernel K1 against JAX's
interleave21 and against the Pallas kernel run in interpret mode, the
encode + sort + histogram steps against JAX and the host encode, and the
port's entry() against __graft_entry__.entry(). Tolerance 0 everywhere:
the work is integer, and the float64 normalization takes the same
operations in the same order."""
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
import jax
import jax.numpy as jnp
from schwarzwald_tpu.ops import device as jax_device
from schwarzwald_tpu_torch.core import morton
from schwarzwald_tpu_torch.ops import device, indexing, morton_cuda

torch.set_num_threads(1)

BMIN = np.zeros(3)
BMAX = np.full(3, 64.0)


def coords_with_edges(n, seed):
    """n random 21-bit coordinates per axis plus the one-hot rows of
    tests/test_device.py:30-35 (each bit alone, 0 and 2^21 - 1 on one axis
    with the other two at 0)."""
    rng = np.random.default_rng(seed)
    x, y, z = (rng.integers(0, 1 << 21, n).astype(np.uint32)
               for _ in range(3))
    oh = np.array([1 << i for i in range(21)] + [0, (1 << 21) - 1],
                  dtype=np.uint32)
    zo = np.zeros_like(oh)
    return (np.concatenate([x, oh, zo, zo]), np.concatenate([y, zo, oh, zo]),
            np.concatenate([z, zo, zo, oh]))


def torch_coords(*axes):
    return [torch.from_numpy(a.view(np.int32)) for a in axes]


# -- kernel K1's plain version ---------------------------------------------------

def test_interleave_equals_jax_and_host(on_cpu):
    x, y, z = coords_with_edges(50_000, 1)
    got = device.interleave21(*torch_coords(x, y, z))
    assert got.dtype == torch.int64 and (got >= 0).all()
    hi, lo = device.keys_to_hi_lo(got)
    want_hi, want_lo = jax_device.interleave21(jnp.asarray(x), jnp.asarray(y),
                                               jnp.asarray(z))
    np.testing.assert_array_equal(hi, np.asarray(want_hi))
    np.testing.assert_array_equal(lo, np.asarray(want_lo))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  morton.from_grid_coords(x, y, z))


def test_interleave_equals_pallas_kernel_in_interpret_mode(on_cpu,
                                                           monkeypatch):
    """The Pallas kernel K1 runs on the CPU only in interpret mode; the
    patch reaches it through the module attribute its body looks up."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x, y, z = coords_with_edges(4096 - 69, 2)  # 69 edge rows: n = 4096
    hi, lo = jax_device.morton_interleave_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    got_hi, got_lo = device.keys_to_hi_lo(
        device.interleave21(*torch_coords(x, y, z)))
    np.testing.assert_array_equal(got_hi, np.asarray(hi))
    np.testing.assert_array_equal(got_lo, np.asarray(lo))


def test_interleave_reads_only_21_bits_per_coordinate():
    """Bits above 20 are ignored, as the JAX interleave masks them."""
    rng = np.random.default_rng(3)
    x, y, z = (rng.integers(0, 1 << 31, 1000).astype(np.int32)
               for _ in range(3))
    got = device.interleave21(*(torch.from_numpy(a) for a in (x, y, z)))
    want = device.interleave21(*(torch.from_numpy(a & 0x1FFFFF)
                                 for a in (x, y, z)))
    assert torch.equal(got, want)


def test_interleave_dispatch_on_the_cpu_counts_no_launch():
    x, y, z = torch_coords(*coords_with_edges(100, 4))
    morton_cuda.reset_counters()
    assert torch.equal(morton_cuda.interleave(x, y, z),
                       morton_cuda.interleave21(x, y, z))
    assert morton_cuda.snapshot()["launches"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        morton_cuda.interleave_cuda(x, y, z)


# -- the batch step ------------------------------------------------------------

def host_grid_coords(pos):
    keys, _ = indexing.index_points(pos.copy(), BMIN, BMAX)
    return keys, morton.grid_coords(keys, 21)


@pytest.mark.parametrize("level", [1, 3, 7])
def test_encode_sort_grid_equals_jax(on_cpu, level):
    pos = np.random.default_rng(5).uniform(BMIN, BMAX, (10_000, 3))
    pos[:500] = pos[500:1000]  # duplicate keys: the sort must be stable
    host_keys, (gx, gy, gz) = host_grid_coords(pos)
    gx, gy, gz = (a.astype(np.uint32) for a in (gx, gy, gz))
    want = jax_device.encode_sort_grid(jnp.asarray(gx), jnp.asarray(gy),
                                       jnp.asarray(gz), level=level)
    got = device.encode_sort_grid(gx, gy, gz, level=level, device="cpu")
    hi, lo = device.keys_to_hi_lo(got.keys)
    np.testing.assert_array_equal(hi, np.asarray(want.key_hi))
    np.testing.assert_array_equal(lo, np.asarray(want.key_lo))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.node_histogram.numpy(),
                                  np.asarray(want.node_histogram))
    sk, order = indexing.sort_with_keys(host_keys)
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint64), sk)
    np.testing.assert_array_equal(got.order.numpy(), order)


@pytest.mark.parametrize("level", [1, 3, 10])
def test_cells_at_level_equal_jax(level):
    """The start-level cell of a key, up to JAX's hi-word limit (level 10;
    a level-10 histogram would hold 8^10 counts, so this compares the cell
    ids the histogram is built from)."""
    x, y, z = coords_with_edges(5000, 6)
    keys = device.interleave21(*torch_coords(x, y, z))
    hi, _ = device.keys_to_hi_lo(keys)
    np.testing.assert_array_equal(
        device._cells_at_level(keys, level).numpy(),
        np.asarray(jax_device._cells_at_level(jnp.asarray(hi), level)))


EDGES = np.array([[0, 0, 0], [64, 64, 64], [63.9999999, 0, 64],
                  [-5, 70, 32]], dtype=np.float64)


def test_encode_sort_batch_equals_jax_and_host(on_cpu):
    rng = np.random.default_rng(7)
    pos = np.concatenate([EDGES, rng.uniform(BMIN, BMAX, (4092, 3))])
    want = jax_device.encode_sort_batch(jnp.asarray(pos), jnp.asarray(BMIN),
                                        jnp.asarray(BMAX - BMIN), level=3)
    got = device.encode_sort_batch(pos, BMIN, BMAX - BMIN, level=3,
                                   device="cpu")
    hi, lo = device.keys_to_hi_lo(got.keys)
    np.testing.assert_array_equal(hi, np.asarray(want.key_hi))
    np.testing.assert_array_equal(lo, np.asarray(want.key_lo))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.node_histogram.numpy(),
                                  np.asarray(want.node_histogram))
    host_keys, _ = indexing.index_points(pos.copy(), BMIN, BMAX)
    sk, order = indexing.sort_with_keys(host_keys)
    np.testing.assert_array_equal(got.keys.numpy().view(np.uint64), sk)
    np.testing.assert_array_equal(got.order.numpy(), order)
    np.testing.assert_array_equal(
        got.node_histogram.numpy(),
        np.bincount(morton.truncate_to_level(sk, 2).astype(np.int64),
                    minlength=512))


def test_encode_points_edges_equal_jax(on_cpu):
    """The edge coordinates of tests/test_device.py:52-59: clamped,
    normalized and encoded as JAX and the host do."""
    hi, lo, jpos = jax_device.encode_points(
        jnp.asarray(EDGES), jnp.asarray(BMIN), jnp.asarray(BMAX - BMIN))
    keys, pos = device.encode_points(torch.from_numpy(EDGES), BMIN,
                                     BMAX - BMIN)
    got_hi, got_lo = device.keys_to_hi_lo(keys)
    np.testing.assert_array_equal(got_hi, np.asarray(hi))
    np.testing.assert_array_equal(got_lo, np.asarray(lo))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    want, _ = indexing.index_points(EDGES.copy(), BMIN, BMAX)
    np.testing.assert_array_equal(keys.numpy().view(np.uint64), want)


def grid_step(inputs):
    return device.encode_sort_grid(*inputs[:3], level=3, device=inputs[3])


def batch_step(inputs):
    return device.encode_sort_batch(inputs[0], BMIN, BMAX - BMIN, level=3,
                                    device=inputs[1])


STEPS = {"encode_sort_grid": (grid_step, lambda pos: host_grid_coords(pos)[1]),
         "encode_sort_batch": (batch_step, lambda pos: (pos,))}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_batch_step_defaults_to_the_card(step):
    """numpy input under device=None means the card, as the JAX functions
    run on the default accelerator: without a card it raises, naming the
    host and the CPU, and launches nothing."""
    assert not torch.cuda.is_available()
    fn, inputs = STEPS[step]
    pos = np.random.default_rng(8).uniform(BMIN, BMAX, (1000, 3))
    morton_cuda.reset_counters()
    with pytest.raises(RuntimeError, match="no CUDA card") as err:
        fn((*inputs(pos), None))
    assert "host" in str(err.value) and "cpu" in str(err.value)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn((*inputs(pos), "cuda"))
    assert morton_cuda.snapshot()["launches"] == 0


@pytest.mark.parametrize("step", sorted(STEPS))
def test_batch_step_keeps_a_cpu_tensor_on_the_cpu(step):
    """A CPU tensor under device=None stays on the CPU (its own device) and
    gives what device="cpu" gives."""
    fn, inputs = STEPS[step]
    pos = np.random.default_rng(9).uniform(BMIN, BMAX, (3000, 3))
    tensors = [torch.from_numpy(np.asarray(a).view(np.int32)
                                if np.asarray(a).dtype == np.uint32
                                else np.asarray(a)) for a in inputs(pos)]
    got = fn((*tensors, None))
    want = fn((*inputs(pos), "cpu"))
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        assert torch.equal(g, w)


# -- the flagship step -----------------------------------------------------------

def load_graft_entry():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_equals_graft_entry(on_cpu):
    from schwarzwald_tpu_torch.entry import entry

    jax_fn, jax_args = load_graft_entry().entry()
    jax_batch, jax_levels = jax.jit(jax_fn)(*jax_args)
    fn, args = entry("cpu")
    for a, b in zip(args, jax_args):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    batch, levels = fn(*args)
    hi, lo = device.keys_to_hi_lo(batch.keys)
    np.testing.assert_array_equal(hi, np.asarray(jax_batch.key_hi))
    np.testing.assert_array_equal(lo, np.asarray(jax_batch.key_lo))
    np.testing.assert_array_equal(batch.order.numpy(),
                                  np.asarray(jax_batch.order))
    np.testing.assert_array_equal(batch.node_histogram.numpy(),
                                  np.asarray(jax_batch.node_histogram))
    assert levels.dtype == torch.int8
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jax_levels))
    assert (levels.numpy() > 0).all()


def test_entry_defaults_to_the_card():
    """entry() with no argument runs on the card, as the JAX entry runs on
    the default accelerator: without one it raises, naming the host and the
    CPU."""
    from schwarzwald_tpu_torch.entry import entry

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA card") as err:
        entry()
    assert "host" in str(err.value) and "cpu" in str(err.value)
    x, y, z = entry("cpu")[1]
    assert x.device.type == y.device.type == z.device.type == "cpu"

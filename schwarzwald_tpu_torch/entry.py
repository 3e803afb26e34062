"""The port's flagship step, the counterpart of the JAX package's
`__graft_entry__.entry()`: the batch step (Morton interleave on kernel K1,
stable key sort with the point index as payload, start-level histogram) and
the complete level-synchronous octree selection under RANDOM_GRID, over
65,536 random 21-bit grid coordinates.

    fn, args = entry()       # on the card; entry("cpu") on the CPU
    batch, levels = fn(*args)

`dryrun_multichip(n)` is the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: the multi-device batch step over n
shards. Each shard encodes and sorts its span of the batch on its own device
(kernel K1 once per shard), the lossless exchange routes the (key, id) pairs
to their owners, and a miniature end-to-end tile over the shards must equal
the single-device FAST run node for node. The JAX dry run's lossy
fixed-capacity step (`make_sharded_encode_sort`, which drops points past its
capacity) has no counterpart: the exchange here is the production one.

    dryrun_multichip(4)                # 4 shards on the card(s)
    dryrun_multichip(4, device="cpu")  # 4 CPU shards
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import device, device_tiling

N_POINTS = 1 << 16
DRYRUN_POINTS_PER_SHARD = 256
DRYRUN_TILE_POINTS = 10_000


def entry(device_name: str = "cuda"):
    """(fn, (x, y, z)): fn runs the step on the inputs' device and returns
    (SortedBatch, int8 levels). The inputs are int32 tensors on
    `device_name`, drawn as the JAX entry draws them. The card by default,
    as the JAX entry runs on the default accelerator; raises without one
    (`entry("cpu")` for the CPU)."""
    if torch.device(device_name).type == "cuda":
        device.resolve_use_device("cuda")
    rng = np.random.default_rng(0)
    x, y, z = (torch.from_numpy(
        rng.integers(0, 1 << 21, N_POINTS).astype(np.int32)).to(device_name)
        for _ in range(3))
    cands = device_tiling.candidate_levels(
        root_extent_x=64.0, spacing_at_root=2.0, max_depth=100)

    def fn(x, y, z):
        batch = device.encode_sort_grid(x, y, z, level=3, device=x.device)
        levels = device_tiling.octree_select_random_grid(
            batch.keys, cands, 20_000, 100)
        return batch, levels

    return fn, (x, y, z)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """The multi-device step on tiny shapes over `n_devices` shards on
    `device` ("cuda": shard d on cuda:(d % cards); "cpu"). Raises on any
    violation of conservation, ownership, the stable order or the
    single-device tree."""
    from .core.aabb import AABB
    from .core.pointbuffer import PointBuffer
    from .io.memory import MemoryPersistence
    from .ops import indexing
    from .ops.device import ShardedExchange, encode_sort_batch
    from .ops.sampling import SamplingStrategy
    from .parallel import multidevice
    from .tiling import (TilerMetaParameters, TilingStrategy,
                         make_tiling_algorithm)

    mesh = multidevice.make_mesh(n_devices, device)
    n = n_devices * DRYRUN_POINTS_PER_SHARD
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, 64.0, (n, 3))
    bmin, bext = np.zeros(3), np.full(3, 64.0)

    # each shard encodes and sorts its contiguous span on its device (K1
    # once per shard); the exchange routes the sorted spans to the owners
    per = -(-n // n_devices)
    keys, ids, hist = [], [], 0
    for d, dev in enumerate(mesh):
        lo, hi = min(d * per, n), min((d + 1) * per, n)
        batch = encode_sort_batch(pos[lo:hi], bmin, bext, level=3,
                                  device=dev)
        keys.append(batch.keys)
        ids.append(batch.order + lo)
        hist = hist + batch.node_histogram.cpu().numpy()
    exchange = ShardedExchange(mesh, level=3)
    owned, routed_hist = exchange.route_shards(keys, ids)
    host_keys, _ = indexing.index_points(pos.copy(), bmin, bmin + bext)
    routed_hist = routed_hist.cpu().numpy()
    multidevice.check_routed(
        [(k.cpu().numpy().view(np.uint64), i.cpu().numpy()) for k, i in owned],
        routed_hist, host_keys, np.arange(n, dtype=np.int64), n_devices)
    if not np.array_equal(routed_hist, hist):
        raise RuntimeError("the exchange's histogram differs from the "
                           "shards' own")

    # the production step from host-encoded keys (multidevice.dryrun)
    multidevice.dryrun(mesh, n_per_device=DRYRUN_POINTS_PER_SHARD)

    # a miniature end-to-end tile over the shards against the
    # single-device FAST run at the same start level, node for node
    bounds = AABB(np.zeros(3), np.full(3, 64.0))
    tile_pos = rng.uniform(0.0, 64.0, (DRYRUN_TILE_POINTS, 3))
    meta = TilerMetaParameters(spacing_at_root=6.0, max_points_per_node=400,
                               concurrency=4, use_device=device)
    single = MemoryPersistence()
    ref = make_tiling_algorithm(TilingStrategy.Fast,
                                SamplingStrategy("RANDOM_GRID", 400),
                                single, meta)
    ref.level_of_start_nodes = 3
    ref.process_batch(PointBuffer(tile_pos.copy()), bounds)
    ref.finalize(bounds)
    multi = MemoryPersistence()
    malgo = multidevice.TilingAlgorithmMultiDevice(
        SamplingStrategy("RANDOM_GRID", 400), multi, meta, mesh=mesh,
        ownership_level=3)
    malgo.process_batch(PointBuffer(tile_pos.copy()), bounds)
    malgo.finalize(bounds)
    if set(single.node_names()) != set(multi.node_names()):
        raise RuntimeError("the multi-device tile has another node set")
    for name in single.node_names():
        if not np.array_equal(single.retrieve_points(name).positions,
                              multi.retrieve_points(name).positions):
            raise RuntimeError(f"multi-device node {name} differs from the "
                               f"single-device run")

"""Multi-device (single-process) tiling: `--multichip N`.

The port of schwarzwald_tpu/parallel/multidevice.py. The mesh owns a static
partition of the octree at a fixed start-node level (the multi-device
analogue of the FAST strategy's fixed level, TilingAlgorithms.cpp:
1473-1535): each batch is Morton-encoded on the host (the fused native read
path), cut into contiguous shards, sorted per shard and exchanged
losslessly to the owning shards (ops.device.ShardedExchange), and every
owner's subtree is then tiled with the standard engine semantics; under
--use-device each owner's fresh start nodes of a grid sampler run the
octree sweep on that owner's device.

Because the exchange preserves the global stable key order and the
ownership blocks partition the start level exactly, a multi-device run
writes the octree of the single-device FAST run at the same start level,
byte for byte.

The mesh is a list of torch devices, one per shard. Under --use-device
cuda shard d runs on cuda:(d % the number of cards), so N shards run on
fewer cards (one card runs every shard); without a card the mesh raises.
Under cpu or host the shards are CPU devices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import morton
from ..core.aabb import AABB
from ..core.pointbuffer import PointBuffer
from ..ops import indexing
from ..ops.device import GRID_SAMPLERS, ShardedExchange
from ..tiling.arena import PointArena
from ..tiling.engine import NodeTask, TilingAlgorithmFast
from ..util import log


def make_mesh(n_devices: int, use_device: str | None = "cuda") -> list:
    """The devices of `n_devices` shards for the engine's use_device
    ("cuda", "cpu" or None for the host run)."""
    if n_devices < 1:
        raise ValueError(f"need at least one shard, got {n_devices}")
    if use_device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--multichip {n_devices} with --use-device cuda: "
                f"torch.cuda.is_available() is False (no CUDA card visible)")
        cards = torch.cuda.device_count()
        log.info(f"multichip: {n_devices} shards on {cards} card(s), shard d "
                 f"on cuda:(d % {cards})")
        return [torch.device("cuda", d % cards) for d in range(n_devices)]
    if use_device in ("cpu", None):
        return [torch.device("cpu")] * n_devices
    raise ValueError(f"use_device must be cuda, cpu or None, "
                     f"got {use_device!r}")


class TilingAlgorithmMultiDevice(TilingAlgorithmFast):
    """FAST-semantics tiling with the per-batch sort and start-level split
    run across a mesh of shards.

    The start-node level doubles as the ownership level; it is fixed up
    front (ownership must be static across batches), by default the FAST
    estimator's MIN_LEVEL.
    """

    def __init__(self, sampling_strategy, persistence, meta,
                 progress_reporter=None, mesh=None, ownership_level: int = 3,
                 cell_range=None):
        """`cell_range=(lo, hi)` stripes only that block of level-
        `ownership_level` cells over the mesh: the multihost composition
        passes its plan's owned block so that all local shards share the
        host's subset (the global stripe would leave (hosts-1)/hosts of
        them idle)."""
        super().__init__(sampling_strategy, persistence, meta,
                         progress_reporter)
        if mesh is None:
            mesh = make_mesh(meta.multichip, meta.use_device)
        self.level_of_start_nodes = ownership_level
        self.exchange = ShardedExchange(mesh, level=ownership_level,
                                        cell_range=cell_range)
        self.mesh = self.exchange.mesh

    def process_batch(self, buffer: PointBuffer, bounds: AABB) -> None:
        if not buffer.count:
            return
        keys = self.index_batch(buffer, bounds)
        arena = PointArena()
        ids = arena.append(buffer)
        self.process_sorted(arena, keys, ids, self._make_root(bounds))

    def process_sorted(self, arena, keys, ids, root) -> None:
        """Tile an indexed (key, arena-id) stream over the mesh: the entry
        the multi-host layer uses for its owned subset after host-level
        routing (keys need not be sorted; the exchange sorts per shard)."""
        level = self.level_of_start_nodes
        per_device, _hist = self.exchange.route(keys, ids)

        # Each owner's fresh start nodes of a grid sampler run the octree
        # sweep on that owner's device. The sweep's kernel reads nothing
        # back, so every owner's sweep is enqueued before the first is
        # copied back: the cards sweep together, and owner d's host
        # persistence overlaps the later owners' sweeps. The Poisson
        # samplers have no sweep: their
        # start nodes take the per-node recursion, whose sampler runs K2 on
        # meta.use_device. Revisited subtrees (and ranges the sweep leaves
        # at re-rooting depths) take the host path.
        sweep = (self.meta.use_device and level > 0
                 and self.sampling_strategy.name in GRID_SAMPLERS)
        pending = []  # (device levels, fresh nodes, fresh keys, fresh ids)
        host_nodes = []
        for device, (owned_keys, owned_ids) in zip(self.mesh, per_device):
            if owned_keys.size == 0:
                continue
            shard_nodes = list(
                self._split_at_start_level(owned_keys, owned_ids, root))
            if not sweep:
                host_nodes.extend(shard_nodes)
                continue
            fresh = []
            for sn in shard_nodes:
                (fresh if not self.persistence.node_exists(sn[0].name)
                 else host_nodes).append(sn)
            if fresh:
                fk = np.concatenate([sn[1] for sn in fresh])
                fi = np.concatenate([sn[2] for sn in fresh])
                pending.append((self._device_select_levels(
                    arena, fk, fi, root, min_node_level=level - 1,
                    device=device, materialize=False), fresh, fk, fi))

        for lv, fresh, fk, fi in pending:
            levels = self._materialize_levels(lv)
            if levels is None:
                host_nodes.extend(fresh)
                continue
            self._persist_device_assignment(arena, fk, fi, levels, root)
            for node, _, _ in fresh:
                self._start_nodes_used.add(
                    (morton.parse_node_name(node.name)[0], level))

        self._journal_start_nodes(host_nodes)
        if level > 0:
            self._start_nodes_used.update(
                (morton.parse_node_name(node.name)[0], level)
                for node, _, _ in host_nodes)
        self._tile_start_nodes_parallel(
            arena, [NodeTask(node, root, k, i) for node, k, i in host_nodes])


def dryrun(mesh, n_per_device: int = 256) -> None:
    """The multi-device step on tiny shapes: host Morton encode, sharded
    sort, lossless exchange, per-owner split. Raises on any violation of
    conservation or ownership."""
    n_dev = len(mesh)
    n = n_dev * n_per_device
    rng = np.random.default_rng(0)
    bounds = AABB(np.zeros(3), np.full(3, 64.0))
    pos = rng.uniform(0.0, 64.0, (n, 3))
    keys, _ = indexing.index_points(pos, bounds.min, bounds.max)
    ids = np.arange(n, dtype=np.int64)

    per_device, hist = ShardedExchange(mesh, level=3).route(keys, ids)
    check_routed(per_device, hist, keys, ids, n_dev)


def check_routed(per_device, hist, keys, ids, n_dev: int) -> None:
    """Raise unless the routed (uint64 keys, ids) per shard conserve the
    batch (no id lost or duplicated, the histogram complete), every key
    sits on the shard owning its level-3 cell, and the shards, in order,
    are the stable sort of `keys` (with `ids` as payload)."""
    n = keys.size
    total = sum(k.size for k, _ in per_device)
    if total != n:
        raise RuntimeError(f"exchange lost points ({total}/{n})")
    if int(hist.sum()) != n:
        raise RuntimeError("histogram lost points")
    if not np.array_equal(np.sort(np.concatenate([i for _, i in per_device])),
                          np.sort(ids)):
        raise RuntimeError("exchange duplicated or lost ids")
    for d, (k, _) in enumerate(per_device):
        cells = (k >> np.uint64(63 - 9)).astype(np.int64)  # level-3 cells
        if not ((cells * n_dev) // 512 == d).all():
            raise RuntimeError(f"shard {d} received foreign points")
    order = indexing.sort_by_key(keys)
    if not (np.array_equal(np.concatenate([k for k, _ in per_device]),
                           keys[order])
            and np.array_equal(np.concatenate([i for _, i in per_device]),
                               ids[order])):
        raise RuntimeError("the shards are not the stable sort of the batch")

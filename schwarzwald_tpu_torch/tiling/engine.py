"""Tiling algorithms: the octree-construction core.

Re-implements the reference's recursive per-node task graph
(schwarzwald/core/tiling/TilingAlgorithms.cpp) as an iterative,
vectorized-per-node engine:

  - tile_node / tile_internal_node / tile_terminal_node semantics
    (TilingAlgorithms.cpp:206-492) including the cached-point re-read with
    prefix-preserving Morton re-derivation (:50-109), the
    always-adhere-after-first-sample rule (:260-275), terminal nodes at
    min(20, max_depth), and >21-level re-rooting (:444-483).
  - ACCURATE == TilingAlgorithmV1 (:565-626): global sort, recurse from root.
  - FAST == TilingAlgorithmV3 (:1195-1784): fixed start-node level estimated
    from the first batch (:1473-1535), per-batch split at that level, and
    finalize-time reconstruction of all skipped ancestors (:1661-1784).

Known deviation from the reference (documented on purpose): when a node
re-roots its Morton indices (level >= ~14 with grid samplers), the reference
partitions children using the ABSOLUTE key level on keys that were just
re-derived relative to the node (TilingAlgorithms.cpp:116-124 via
tile_internal_node after :444-483), which reads meaningless octant digits.
We split at the level relative to the current key root, which is the
behavior the surrounding code clearly intends.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ..core import morton
from ..core.aabb import AABB, octant_bounds
from ..core.node import NodeStructure
from ..core.pointbuffer import PointBuffer
from ..ops import indexing, sampling
from ..ops.sampling import GRID_SAMPLERS, SamplingBehaviour, SamplingStrategy
from .arena import PointArena
from .meta import TilerMetaParameters, TilingStrategy

MAX_OCTREE_LEVELS = morton.MAX_LEVELS  # 21

_U = np.uint64


class _LazyQuantized:
    """Node-cache placeholder for a lossy sink: holds the pre-quantization
    buffer and its bounds; materialized into the exact re-read result
    (persistence.simulate_retrieve) on first cache hit."""

    __slots__ = ("points", "bounds")

    def __init__(self, points: PointBuffer, bounds: AABB):
        self.points = points
        self.bounds = bounds

    @property
    def nbytes(self) -> int:  # LRU sizing
        total = self.points.positions.nbytes
        for arr in self.points.columns.values():
            total += arr.nbytes
        return total


@dataclasses.dataclass
class NodeTask:
    node: NodeStructure
    root: NodeStructure
    keys: np.ndarray  # uint64, sorted (in the key space of `root`)
    ids: np.ndarray   # int64 global arena ids, aligned with keys


class TilingAlgorithmBase:
    def __init__(self, sampling_strategy: SamplingStrategy, persistence,
                 meta: TilerMetaParameters, progress_reporter=None):
        self.sampling_strategy = sampling_strategy
        self.persistence = persistence
        self.meta = meta
        self.progress = progress_reporter
        if meta.use_device and sampling_strategy.name in (
                "MIN_DISTANCE", "MIN_DISTANCE_FAST"):
            # Poisson-disk sampling runs the device kernel for large ranges
            # (ops/device_poisson); host kernel otherwise. The grid
            # samplers' device path is the octree sweep
            # (_device_select_levels).
            sampling_strategy.device_backend = meta.use_device
        # LRU node cache over node contents. For LOSSLESS sinks the
        # persisted buffer equals what a re-read returns, so it is cached
        # at persist time. For LOSSY sinks (LAS/LAZ quantization) parity
        # demands the QUANTIZED re-read result, so the cache stores what
        # retrieve returned and is invalidated when the node is rewritten
        # — every visit after the first re-read is then served from
        # memory either way (SURVEY hard-part #5: out-of-core node merge
        # traffic; LAZ node re-decodes dominated ENTWINE_LAZ runs).
        self._node_cache = None
        if meta.cache_size_bytes:
            from ..core.lru_cache import LRUCache
            self._node_cache = LRUCache(meta.cache_size_bytes)
        # NodeStructure memo: out-of-core sweeps re-derive the same few
        # thousand nodes every batch (name + bounds descent, ~20 us each,
        # tens of thousands of calls per run). Keyed by (key, depth);
        # invalidated if the root ever changes (it never does in a run).
        self._node_struct_cache: dict = {}
        self._node_struct_root = None
        self._node_struct_root_obj = None
        # Device sweep observability: sweeps whose levels were persisted,
        # and sweeps that left points at re-rooting depths (level 0), whose
        # whole group then went to the host per-node recursion — the JAX
        # package's own rule. A device fault is not counted: it fails the
        # run.
        self.device_sweeps_ok = 0
        self.device_reroots = 0

    def _persist_node(self, points: PointBuffer, bounds: AABB,
                      name: str) -> None:
        self.persistence.persist_points(points, bounds, name)
        if self._node_cache is not None:
            if self.persistence.is_lossless and points.count:
                # detach_base: cached slice views of a level gather would
                # pin the whole gather (see PointBuffer.detach_base)
                self._node_cache.put(name, points.detach_base())
            elif points.count and hasattr(self.persistence,
                                          "simulate_retrieve"):
                # lossy sink: cache what a re-read would return — computed
                # LAZILY on first retrieve (in-memory encode+decode
                # roundtrip; IO and entropy coding are lossless and
                # skipped), so nodes never revisited cost nothing
                self._node_cache.put(
                    name, _LazyQuantized(points.detach_base(), bounds))
            else:
                self._node_cache.remove(name)  # quantized re-read differs

    # -- helpers ------------------------------------------------------------

    def _make_root(self, bounds: AABB) -> NodeStructure:
        return NodeStructure(
            name="r", morton_key=0, bounds=bounds, level=-1,
            max_spacing=self.meta.spacing_at_root,
            max_depth=self.meta.max_depth)

    def _report_indexed(self, count: int) -> None:
        if self.progress is not None and count:
            self.progress.increment("indexing", count)

    def _node_struct(self, node_key: int, levels: int,
                     root: NodeStructure) -> NodeStructure:
        """Memoized node_from_index (nodes are immutable; root is fixed
        for the lifetime of a run)."""
        # two-tier root identity: object identity first (hot path — the
        # same root NodeStructure is passed thousands of times per batch;
        # the tobytes() value key alone cost ~0.2 s/run), value equality
        # as the fallback so recreated-but-equal roots keep the cache
        if root is not self._node_struct_root_obj:
            root_id = (root.bounds.min.tobytes(), root.bounds.max.tobytes(),
                       root.max_spacing, root.max_depth)
            if self._node_struct_root != root_id:
                self._node_struct_cache.clear()
                self._node_struct_root = root_id
            self._node_struct_root_obj = root
        key = (node_key, levels)
        node = self._node_struct_cache.get(key)
        if node is None:
            from ..core.node import node_from_index
            node = node_from_index(node_key, levels, root)
            self._node_struct_cache[key] = node
        return node

    def _retrieve_node(self, name: str) -> PointBuffer:
        if self._node_cache is not None:
            cached = self._node_cache.try_get(name)
            if isinstance(cached, _LazyQuantized):
                cached = self.persistence.simulate_retrieve(cached.points,
                                                            cached.bounds)
                self._node_cache.put(name, cached)
            if cached is not None:
                return cached
        result = self.persistence.retrieve_points(name)
        if self._node_cache is not None and result.count:
            self._node_cache.put(name, result)
        return result

    def _read_cached_points(self, node: NodeStructure, arena: PointArena):
        """read_pnts_from_disk (TilingAlgorithms.cpp:50-109): fetch the
        node's previously persisted points and re-derive their Morton keys
        below the node's own prefix to dodge FP boundary errors.

        The re-derived (and, for lossy sinks, re-sorted) keys are memoized
        on the cached buffer: a node revisit whose content is unchanged in
        the cache skips the encode + sort entirely. A rewrite replaces the
        cache entry (a fresh buffer without the memo), so staleness is
        impossible."""
        cached = self._retrieve_node(node.name)
        if not cached.count:
            return None, None
        memo = getattr(cached, "_rederived_keys", None)
        if memo is not None and memo[0] == node.name:
            return memo[1], arena.append(cached)
        start_level = node.level + 1
        if start_level >= MAX_OCTREE_LEVELS:
            sub = np.zeros(cached.count, dtype=np.uint64)
        else:
            # Unlike index_point, the reference does NOT clamp here; points
            # epsilon-outside the node bounds would hit UB in the float->uint
            # cast. We clamp to the node bounds first (deterministic, and
            # identical for all in-bounds points). One fused native pass
            # (clamp+encode) on a COPY — the cached buffer itself must keep
            # its unclamped values (they are what a rewrite persists).
            sub, _ = indexing.index_points(cached.positions.copy(),
                                           node.bounds.min, node.bounds.max)
        keys = np.uint64(node.morton_key) | (sub >> _U(3 * start_level))
        if not self.persistence.is_lossless \
                and not indexing.is_sorted(keys):
            order = indexing.sort_by_key(keys)
            keys = keys[order]
            # reorder the buffer itself so the memoized keys align with it
            cached = cached.take(order)
        ids = arena.append(cached)
        if self._node_cache is not None:
            cached._rederived_keys = (node.name, keys)
            self._node_cache.put(node.name, cached)
        return keys, ids

    @staticmethod
    def _merge_sorted(keys_a, ids_a, keys_b, ids_b):
        """std::merge stability (Node.cpp:3-22): ties keep first-arg items
        (the incoming batch) before second-arg items (cached).

        True two-way merge of the presorted runs (two searchsorted passes +
        scatter) instead of re-sorting the concatenation: a-element i goes
        after the b-elements strictly below it, b-element j after the
        a-elements at-or-below it (a wins ties)."""
        if keys_a is None or keys_a.size == 0:
            return keys_b, ids_b
        if keys_b is None or keys_b.size == 0:
            return keys_a, ids_a
        if keys_b.size > 1 and not (keys_b[:-1] <= keys_b[1:]).all():
            # out-of-contract cached content (e.g. a pre-populated output
            # dir written by another tool): restore the sorted invariant
            order = indexing.sort_by_key(keys_b)
            keys_b, ids_b = keys_b[order], ids_b[order]
        n, m = keys_a.size, keys_b.size
        pos_a = np.arange(n, dtype=np.int64)
        pos_a += np.searchsorted(keys_b, keys_a, side="left")
        pos_b = np.arange(m, dtype=np.int64)
        pos_b += np.searchsorted(keys_a, keys_b, side="right")
        keys = np.empty(n + m, dtype=keys_a.dtype)
        ids = np.empty(n + m, dtype=ids_a.dtype)
        keys[pos_a] = keys_a
        keys[pos_b] = keys_b
        ids[pos_a] = ids_a
        ids[pos_b] = ids_b
        return keys, ids

    def _required_depth(self, node_level: int, root: NodeStructure) -> int:
        return sampling.required_morton_index_depth(
            self.sampling_strategy, node_level,
            float(root.bounds.extent()[0]), root.max_spacing)

    # -- node tiling --------------------------------------------------------

    def _do_tiling_for_node(self, arena: PointArena, task: NodeTask) -> None:
        stack = [task]
        while stack:
            children = self._tile_node(arena, stack.pop())
            stack.extend(children)

    def _tile_node(self, arena: PointArena, task: NodeTask):
        node, root = task.node, task.root

        sample_from = self._required_depth(node.level, root)
        requires_deeper = sample_from > node.level
        max_level = min(MAX_OCTREE_LEVELS - 1, node.max_depth)

        # Terminal nodes never sample: on an append-capable sink the new
        # batch extent is appended WITHOUT re-reading or rewriting the
        # existing content (the store returns extents newest-first, which
        # IS tile_terminal_node's [batch, previous content] concat order,
        # TilingAlgorithms.cpp:206-241). This turns the out-of-core
        # terminal cost from O(batches x node size) to O(new points).
        terminal = (sample_from >= max_level if not requires_deeper
                    else node.level >= max_level)
        if terminal and hasattr(self.persistence, "append_points"):
            if task.ids.size:
                self.persistence.append_points(
                    arena.gather(task.ids), node.bounds, node.name)
                if self._node_cache is not None:
                    self._node_cache.remove(node.name)
                self._report_indexed(task.ids.size)
            return []

        cached_keys, cached_ids = self._read_cached_points(node, arena)
        cached_count = 0 if cached_ids is None else cached_ids.size

        if not requires_deeper:
            if sample_from >= max_level:
                self._tile_terminal_node(arena, task, cached_ids, cached_count)
                return []
            keys, ids = self._merge_sorted(task.keys, task.ids,
                                           cached_keys, cached_ids)
            return self._tile_internal_node(arena, keys, ids, node, root,
                                            cached_count)

        if node.level >= max_level:
            self._tile_terminal_node(arena, task, cached_ids, cached_count)
            return []

        if sample_from >= MAX_OCTREE_LEVELS:
            # Deep-node re-rooting (TilingAlgorithms.cpp:444-483): merge
            # unsorted, recompute all keys with this node as key-space root,
            # sort, and continue with an adjusted root structure.
            ids = task.ids if cached_ids is None else np.concatenate(
                [task.ids, cached_ids])
            pos = indexing.clamp_to_bounds(
                arena.positions(ids), node.bounds.min, node.bounds.max)
            keys = morton.encode(pos, node.bounds.min, node.bounds.extent())
            order = indexing.sort_by_key(keys)
            keys, ids = keys[order], ids[order]
            new_root = dataclasses.replace(
                node, max_depth=node.max_depth - node.level)
            return self._tile_internal_node(arena, keys, ids, node, new_root,
                                            cached_count)

        keys, ids = self._merge_sorted(task.keys, task.ids,
                                       cached_keys, cached_ids)
        return self._tile_internal_node(arena, keys, ids, node, root,
                                        cached_count)

    def _tile_terminal_node(self, arena, task: NodeTask, cached_ids,
                            cached_count: int) -> None:
        """tile_terminal_node (TilingAlgorithms.cpp:206-241): take all points
        without sampling (merge order: batch points then cached)."""
        ids = task.ids if cached_ids is None else np.concatenate(
            [task.ids, cached_ids])
        if ids.size == 0:
            return
        self._persist_node(arena.gather(ids), task.node.bounds,
                           task.node.name)
        self._report_indexed(ids.size - cached_count)

    def _tile_internal_node(self, arena, keys, ids, node: NodeStructure,
                            root: NodeStructure, cached_count: int):
        """tile_internal_node (TilingAlgorithms.cpp:247-349)."""
        if ids.size == 0:
            raise RuntimeError(
                f"tile_internal_node: Got zero points to tile @ node {node.name}")
        behaviour = (SamplingBehaviour.AlwaysAdhereToMinSpacing
                     if cached_count > 0
                     else SamplingBehaviour.TakeAllWhenCountBelowMaxPoints)
        node_level_rel = node.level - (root.level + 1)
        # The position gather is the deep-recursion hot spot (every level
        # re-gathers its subset); skip it when the sampler won't read it
        # (take-all nodes — most leaves — and RANDOM_GRID), and gather into
        # the arena's reused scratch otherwise (sample() consumes positions
        # and never retains them).
        positions = (arena.positions_scratch(ids)
                     if self.sampling_strategy.needs_positions(
                         ids.size, behaviour) else None)
        result = self.sampling_strategy.sample(
            keys, positions, node.morton_key, node_level_rel,
            root.bounds.min, root.bounds.max, root.max_spacing, behaviour)
        if result.order is not None:
            keys = keys[result.order]
            ids = ids[result.order]
        taken = result.selected_count

        if node_level_rel >= 16 and taken < 0.01 * ids.size:
            self._dump_broken_node(arena, keys, ids, taken, node)

        self._persist_node(arena.gather(ids[:taken]), node.bounds,
                           node.name)
        self._report_indexed(taken - cached_count)

        return self._split_into_child_tasks(keys[taken:], ids[taken:],
                                            node, root, node_level_rel)

    def _dump_broken_node(self, arena, keys, ids, taken: int,
                          node: NodeStructure) -> None:
        """Forensic dump when <1% of a deep node's points get taken
        (potentially broken node, TilingAlgorithms.cpp:292-328). On the
        base class: every algorithm's _tile_internal_node can hit this."""
        import os

        from ..util import log
        from ..util.config import global_config

        log.write_log(f"Discovered potentially broken node {node.name}")
        path = os.path.join(global_config().root_directory,
                            f"broken_{node.name}.txt")
        try:
            positions = arena.positions(ids)
            with open(path, "w") as f:
                f.write(f"Bounds:       {node.bounds}\n")
                f.write(f"Points taken: {taken}\n")
                f.write(f"Total points: {ids.size}\n\n")
                for i in range(ids.size):
                    tick = "[x]" if i < taken else "[ ]"
                    f.write(f"{tick} {positions[i].tolist()} "
                            f"[{int(keys[i]):016x}]\n")
        except OSError as err:
            log.warn(f"Could not dump broken node {node.name}: {err}")

    def _split_into_child_tasks(self, keys, ids, node: NodeStructure,
                                root: NodeStructure, node_level_rel: int):
        """split_range_into_child_nodes (TilingAlgorithms.cpp:116-162), with
        the octant digit read at the level relative to the current key space
        (see module docstring on the re-rooting deviation)."""
        if keys.size == 0:
            return []
        child_level = node.level + 1
        rel_level = node_level_rel + 1
        bounds = indexing.child_octant_boundaries(keys, 0, keys.size, rel_level)
        tasks = []
        for octant in range(8):
            lo, hi = bounds[octant], bounds[octant + 1]
            if lo == hi:
                continue
            child_key = (np.uint64(node.morton_key)
                         | (_U(octant) << _U(3 * (MAX_OCTREE_LEVELS - child_level - 1)))) \
                if child_level < MAX_OCTREE_LEVELS else np.uint64(node.morton_key)
            child = NodeStructure(
                name=node.name + str(octant),
                morton_key=int(child_key),
                bounds=octant_bounds(octant, node.bounds),
                level=child_level,
                max_spacing=node.max_spacing / 2,
                max_depth=node.max_depth)
            tasks.append(NodeTask(child, root, keys[lo:hi], ids[lo:hi]))
        return tasks

    # -- device octree sweep (grid samplers) ----------------------------------

    def _device_select_levels(self, arena, sorted_keys, sorted_ids,
                              root: NodeStructure, min_node_level: int = -1,
                              device=None, materialize: bool = True):
        """One level-synchronous sweep (ops/device_tiling) over a
        Morton-sorted fresh range on `device` (default meta.use_device; the
        multi-device path runs one sweep per shard on that shard's device).
        Returns the host levels of _materialize_levels, or with
        materialize=False the int8 levels (node_level + 2) as a tensor on
        the device, not yet copied back: on the card the sweep's kernel
        (csrc/sweep.cu) is enqueued whole, level plan and all, and reads
        nothing back, so the caller can persist one range while the next
        one's sweep runs, and then calls _materialize_levels. Every fault
        raises: there is no host fallback for a failing device."""
        import torch

        from ..ops import device_tiling
        from ..util.trace import trace_span

        name = self.sampling_strategy.name
        device = torch.device(self.meta.use_device if device is None
                              else device)
        root_ext_x = float(root.bounds.extent()[0])
        kwargs = {}
        if name in ("GRID_CENTER", "JITTERED"):
            kwargs["positions"] = torch.from_numpy(
                arena.positions(sorted_ids)).to(device)
            kwargs["root_min"] = [float(v) for v in root.bounds.min]
            kwargs["root_max"] = [float(v) for v in root.bounds.max]
        if name == "JITTERED":
            kwargs["jit_cfgs"] = device_tiling.jittered_static_configs(
                root_ext_x, root.max_spacing, root.max_depth)
        cands = device_tiling.candidate_levels(root_ext_x, root.max_spacing,
                                               root.max_depth)
        with trace_span("device_octree_sweep", "device"):
            key = device_tiling.keys_tensor(sorted_keys, device)
            levels = device_tiling.octree_select_grid(
                key, cands, self.meta.max_points_per_node, root.max_depth,
                strategy=name, min_node_level=min_node_level, **kwargs)
        return self._materialize_levels(levels) if materialize else levels

    def _materialize_levels(self, device_levels):
        """Copy a sweep's levels to the host. None when any point was left
        at a re-rooting depth (level 0): the JAX package's rule sends the
        whole range to the host per-node recursion then, and the count of
        such sweeps is device_reroots."""
        from ..util.trace import trace_span

        with trace_span("sweep_materialize", "device"):
            levels = device_levels.cpu().numpy()
        if (levels == 0).any():
            self.device_reroots += 1
            return None
        self.device_sweeps_ok += 1
        return levels

    # -- level assignment persistence ----------------------------------------

    def _persist_device_assignment(self, arena, sorted_keys, sorted_ids,
                                   levels, root: NodeStructure) -> None:
        """Persist a device assignment: group by (level, node prefix) over
        the sorted order — ONE arena gather per level, then per-node slice
        views into it (no per-node fancy indexing)."""
        from ..util.trace import trace_span
        with trace_span("persist_fresh", "engine"):
            self._persist_device_assignment_inner(arena, sorted_keys,
                                                  sorted_ids, levels, root)

    def _persist_device_assignment_inner(self, arena, sorted_keys,
                                         sorted_ids, levels,
                                         root: NodeStructure) -> None:
        for lv in np.unique(levels):
            node_level = int(lv) - 2
            mask = levels == lv
            idx = np.flatnonzero(mask)
            level_buf = arena.gather(sorted_ids[idx])
            if node_level == -1:
                self._persist_node(level_buf, root.bounds, root.name)
                self._report_indexed(idx.size)
                continue
            prefixes = morton.truncate_to_level(sorted_keys[mask],
                                                node_level)
            starts = indexing.run_starts(prefixes)
            ends = np.append(starts[1:], idx.size)
            for s, e in zip(starts, ends):
                node = self._node_struct(int(prefixes[s]), node_level + 1,
                                         root)
                self._persist_node(level_buf.slice(int(s), int(e)),
                                   node.bounds, node.name)
                self._report_indexed(int(e - s))

    # -- revisit subtree gathering (host revisit sweep) -----------------------

    # NOTE (round-5): the DEVICE revisit sweep was retired. Measured on a
    # quiet box (benchmark/revisit_retirement.md): its XLA level-sweep
    # executes the merged subtree ~8x slower than the native host sweep
    # (0.39 s vs 0.05 s for the same 4-sweep workload) — a kernel-exec
    # gap, not transfer — and the device sweep's measured compute-only
    # rate (4.7 Mpts/s on real v5e) also loses to the native sweep
    # (>20 Mpts/s/core). Revisits are owned by _host_revisit_start_nodes;
    # fresh batches keep the device sweep (no merge, pure selection).

    def _gather_revisit_subtrees(self, arena, revisit_nodes, root,
                                 min_incoming, max_ratio):
        """Phase 1 of a (device or host) revisit sweep: gather every
        accepted subtree's cached points (guards applied per start node),
        re-derive keys per node exactly as the host merge path does, and
        order everything by (key, tier) with incoming-before-cached ties
        and shallower-cache-first. Subtrees are disjoint key ranges, so
        all accepted start nodes run as ONE sweep. Returns (handled,
        keys, ids, tiers, cached_counts) or None when nothing qualifies."""
        if not hasattr(self.persistence, "node_names"):
            return None
        try:
            all_names = self.persistence.node_names()
        except Exception:
            return None
        from ..util.trace import trace_span
        with trace_span("gather_revisit_subtrees", "engine"):
            return self._gather_revisit_subtrees_inner(
                arena, revisit_nodes, root, min_incoming, max_ratio,
                all_names)

    def _gather_revisit_subtrees_inner(self, arena, revisit_nodes, root,
                                       min_incoming, max_ratio, all_names):
        import bisect

        # Subtree lookup by bisecting the sorted name list: names under a
        # prefix are lexicographically contiguous (continuations are the
        # octant digits 0-7 < "8"), so each start node costs O(log names)
        # instead of a full startswith scan.
        sorted_names = sorted(all_names)
        handled = []
        parts_k, parts_i, parts_t = [], [], []
        cached_counts: dict = {}
        for node, in_keys, in_ids in revisit_nodes:
            if in_keys.size < min_incoming:
                continue
            prefix = node.name
            i0 = bisect.bisect_left(sorted_names, prefix)
            i1 = bisect.bisect_left(sorted_names, prefix + "8")
            subtree = [n for n in sorted_names[i0:i1]
                       if n == prefix or n[len(prefix):].isdigit()]
            node_k = [in_keys]
            node_i = [in_ids]
            node_t = [np.full(in_keys.size, -128, dtype=np.int8)]
            node_counts = {}
            total_cached = 0
            ok = True
            for name in sorted(subtree, key=len):  # shallower first
                depth = len(name) - 1
                sub_node = self._node_struct(
                    morton.parse_node_name(name)[0], depth, root) \
                    if depth > 0 else root
                ck, ci = self._read_cached_points(sub_node, arena)
                if ci is None:
                    continue
                node_counts[name] = ci.size
                total_cached += ci.size
                if total_cached > max_ratio * in_keys.size:
                    ok = False
                    break
                node_k.append(ck)
                node_i.append(ci)
                # loop-level of the cached node: depth D node is sampled
                # at sweep level D-1
                node_t.append(np.full(ci.size, depth - 1, dtype=np.int8))
            if not ok:
                continue
            parts_k.extend(node_k)
            parts_i.extend(node_i)
            parts_t.extend(node_t)
            cached_counts.update(node_counts)
            handled.append(node)
        if not handled:
            return None

        keys = np.concatenate(parts_k)
        ids = np.concatenate(parts_i)
        tiers = np.concatenate(parts_t)
        # Required order: (key asc, tier asc) with incoming (-128) before
        # cached and shallower cache before deeper — the host merge
        # precedence. A STABLE sort by keys alone produces exactly that:
        # equal keys can only collide within one subtree (start nodes own
        # disjoint key ranges), and each subtree's parts are concatenated
        # in ascending-tier order (incoming, then cached shallow-first) —
        # so the stable tie order IS the tier order. The native stable
        # radix argsort replaces np.lexsort((tiers, keys)) (~7x at
        # out-of-core merge sizes).
        order = indexing.sort_by_key(keys)
        keys, ids, tiers = keys[order], ids[order], tiers[order]
        return handled, keys, ids, tiers, cached_counts

    def _sweep_is_terminal(self, node_level: int, root) -> bool:
        """Host-side replica of octree_select_grid's terminal rule for a
        node at sweep level `node_level` (persist-order decisions)."""
        max_level = min(MAX_OCTREE_LEVELS - 1, root.max_depth)
        if self.sampling_strategy.name in ("JITTERED", "MIN_DISTANCE",
                                           "MIN_DISTANCE_FAST"):
            # MIN_DISTANCE*: required depth == node level (Sampling.cpp:
            # 29-47), so requires_deeper never holds and terminality is
            # purely the max-level rule.
            return node_level >= max_level
        cands = sampling.candidate_levels(
            float(root.bounds.extent()[0]), root.max_spacing, root.max_depth)
        cand = cands[node_level + 1]
        return (node_level >= max_level if cand > node_level
                else cand >= max_level)

    def _persist_revisit_assignment(self, arena, keys, ids, tiers, levels,
                                    root, cached_counts: dict) -> None:
        """Persist a revisit sweep: array order is already the host's
        merged (key, tier) order for internal nodes; TERMINAL nodes
        concatenate (incoming/demoted stream) then (own cache in file
        order) — _tile_terminal_node's concat, not a merge. Nodes whose
        selected set is exactly their unchanged own cache are skipped
        (re-selection of an accepted set is idempotent for the grid
        samplers, so the bytes would be identical)."""
        from ..util.trace import trace_span
        with trace_span("persist_revisit", "engine"):
            self._persist_revisit_assignment_inner(
                arena, keys, ids, tiers, levels, root, cached_counts)

    def _persist_revisit_assignment_inner(self, arena, keys, ids, tiers,
                                          levels, root,
                                          cached_counts: dict) -> None:
        for lv in np.unique(levels):
            node_level = int(lv) - 2
            idx = np.flatnonzero(levels == lv)
            node_keys = keys[idx]
            node_tiers = tiers[idx]
            if node_level == -1:  # the root is a single segment
                prefixes = np.zeros(idx.size, dtype=np.uint64)
                starts = np.zeros(1 if idx.size else 0, dtype=np.int64)
            else:
                prefixes = morton.truncate_to_level(node_keys, node_level)
                starts = indexing.run_starts(prefixes)
            ends = np.append(starts[1:], idx.size)
            terminal = (node_level >= 0
                        and self._sweep_is_terminal(node_level, root))
            # ONE arena gather for the whole level, then per-node slice
            # views — per-node gathers cost ~0.25 ms each at out-of-core
            # node counts (chunk location + run grouping per call)
            level_buf = arena.gather(ids[idx])
            for s, e in zip(starts, ends):
                sel = idx[s:e]
                own = node_tiers[s:e] == node_level
                node = self._node_struct(int(prefixes[s]), node_level + 1,
                                         root) if node_level >= 0 else root
                n_own = int(own.sum())
                cached = cached_counts.get(node.name, 0)
                if n_own == sel.size and n_own == cached:
                    continue  # unchanged: host would not rewrite it either
                if terminal and n_own:
                    # own cache last, in file order (= arena append order,
                    # ascending ids) — _tile_terminal_node concatenates the
                    # incoming stream with the cached file, it never merges
                    sel_own = sel[own]
                    sel = np.concatenate(
                        [sel[~own],
                         sel_own[np.argsort(ids[sel_own], kind="stable")]])
                    buf = arena.gather(ids[sel])
                else:
                    buf = level_buf.slice(int(s), int(e))
                self._persist_node(buf, node.bounds, node.name)
                self._report_indexed(sel.size - cached)

    # -- host level-synchronous sweep (native octree_sweep) -------------------

    # Strategies covered by the native host sweep kernel
    # (native/src/schwarzwald_native.cpp octree_sweep).
    HOST_SWEEP_STRATEGIES = ("MIN_DISTANCE", "MIN_DISTANCE_FAST",
                             "RANDOM_GRID", "GRID_CENTER", "JITTERED")
    # Revisit guards: unlike the device sweep there is no transfer cost,
    # but the sweep re-reads and re-samples a start node's WHOLE subtree
    # while the recursion touches only nodes on incoming paths — tiny
    # localized top-ups (tiled flight-line input) stay on the recursion.
    HOST_REVISIT_MIN_INCOMING = 256
    HOST_REVISIT_MAX_CACHE_RATIO = 32.0

    def _host_sweep_enabled(self) -> bool:
        import os

        if os.environ.get("SCHWARZWALD_NO_HOST_SWEEP"):
            return False
        if getattr(self, "_host_sweep_broken", False):
            return False
        if self.sampling_strategy.name not in self.HOST_SWEEP_STRATEGIES:
            return False
        from .. import native
        lib = native._lib()
        return lib is not None and hasattr(lib, "octree_sweep")

    def _host_sweep_levels(self, arena, keys, ids, root: NodeStructure,
                           min_node_level: int = -1, tiers=None):
        """One native level-synchronous sweep (octree_sweep) computing
        every point's octree assignment on the HOST — the out-of-core
        twin of the JAX package's device sweep, extended to the Poisson
        samplers.
        Returns int8 levels (node_level + 2) or None to fall back to the
        per-node recursion (re-rooting depths / unavailable kernel)."""
        from .. import native

        lib = native._lib()
        name = self.sampling_strategy.name
        root_ext_x = float(root.bounds.extent()[0])
        cands = None
        if name in ("MIN_DISTANCE_FAST", "RANDOM_GRID", "GRID_CENTER"):
            cands = sampling.candidate_levels(
                root_ext_x, root.max_spacing, root.max_depth)
        elif name == "JITTERED":
            # per-level REQUIRED index depth via the reference's
            # approximate-extent formula (Sampling.cpp:48-59) — the
            # re-root decision must mirror the recursion's, which uses
            # this and not the descended node extent
            from ..ops.sampling import required_morton_index_depth
            cands = np.array(
                [required_morton_index_depth(
                    self.sampling_strategy, lv, root_ext_x,
                    root.max_spacing)
                 for lv in range(-1, min(MAX_OCTREE_LEVELS - 1,
                                         root.max_depth) + 1)],
                dtype=np.int32)
        positions = None
        if name != "RANDOM_GRID":
            # grow-only scratch (consumed synchronously by the native
            # call): a fresh ~100 MB allocation per batch costs seconds in
            # first-touch page faults on this deployment
            positions = arena.positions_scratch(ids)
        from ..util.trace import trace_span
        with trace_span("host_octree_sweep", "engine"):
            levels = lib.octree_sweep(
                keys, tiers, positions, name, min_node_level,
                root.max_depth, self.meta.max_points_per_node,
                root.bounds.min, root.bounds.max, root.max_spacing, cands)
        if (levels == 0).any():
            # re-rooting depths (RANDOM_GRID cand >= 21): the recursion
            # owns those — and will for every batch of this run, so stop
            # paying the sweep attempt
            self._host_sweep_broken = True
            return None
        return levels

    def _host_revisit_start_nodes(self, arena, revisit_nodes, root,
                                  level: int):
        """Host-native revisit sweep over start-node subtrees: the same
        gather + (key, tier) merge order + persist as the device revisit
        path, with selection in one octree_sweep call. Byte-identical to
        the per-node recursion (tests/test_host_sweep.py). Returns the
        start nodes handled; the caller recurses the rest."""
        gathered = self._gather_revisit_subtrees(
            arena, revisit_nodes, root, self.HOST_REVISIT_MIN_INCOMING,
            self.HOST_REVISIT_MAX_CACHE_RATIO)
        if gathered is None:
            return []
        handled, keys, ids, tiers, cached_counts = gathered
        lv = self._host_sweep_levels(arena, keys, ids, root,
                                     min_node_level=level - 1, tiers=tiers)
        if lv is None:
            return []
        self._persist_revisit_assignment(arena, keys, ids, tiers, lv,
                                         root, cached_counts)
        return handled

    def _host_sweep_batch_start_nodes(self, arena, start_nodes, root,
                                      level: int):
        """Host sweep over a batch's start nodes: fresh subtrees as one
        concatenated sweep (they are disjoint ascending key ranges),
        revisited subtrees through the gather+sweep path. Returns the
        start nodes the per-node recursion still has to tile."""
        if not start_nodes or not self._host_sweep_enabled():
            return start_nodes
        if not hasattr(self.persistence, "node_exists"):
            return start_nodes
        fresh, revisit = [], []
        for sn in start_nodes:
            (revisit if self.persistence.node_exists(sn[0].name)
             else fresh).append(sn)
        leftovers = []
        if fresh:
            fk = np.concatenate([sn[1] for sn in fresh])
            fi = np.concatenate([sn[2] for sn in fresh])
            levels = self._host_sweep_levels(arena, fk, fi, root,
                                             min_node_level=level - 1)
            if levels is None:
                leftovers.extend(fresh)
            else:
                self._persist_device_assignment(arena, fk, fi, levels, root)
        if revisit:
            handled = self._host_revisit_start_nodes(arena, revisit, root,
                                                     level)
            handled_names = {n.name for n in handled}
            leftovers.extend(sn for sn in revisit
                             if sn[0].name not in handled_names)
        return leftovers

    # -- batch API ----------------------------------------------------------

    def index_batch(self, buffer: PointBuffer, bounds: AABB):
        """Clamp + Morton-encode a batch, writing clamped positions back into
        the buffer (index_point mutates positions in place,
        OctreeAlgorithms.h:157-170). Uses keys precomputed by the fused
        read path when present."""
        if buffer.morton_keys is not None:
            return buffer.morton_keys
        keys, clamped = indexing.index_points(buffer.positions,
                                              bounds.min, bounds.max)
        buffer.positions = clamped
        return keys

    def process_batch(self, buffer: PointBuffer, bounds: AABB) -> None:
        raise NotImplementedError

    def finalize(self, bounds: AABB) -> None:
        pass


class TilingAlgorithmAccurate(TilingAlgorithmBase):
    """TilingAlgorithmV1 (ACCURATE): global sort, recurse from the root."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._any_batch_processed = False

    def process_batch(self, buffer: PointBuffer, bounds: AABB) -> None:
        if not buffer.count:
            return
        keys = self.index_batch(buffer, bounds)
        arena = PointArena()
        arena.append(buffer)
        # fresh arena: ids are 0..n-1, so the sorted ids ARE the sort order
        skeys, order = indexing.sort_with_keys(keys)
        root = self._make_root(bounds)
        # The device sweep persists node contents computed from this batch
        # alone; it must never overwrite nodes persisted by an earlier
        # (resumed / pre-populated) run — under ACCURATE the root is always
        # written, so its existence detects any prior output.
        if (self.meta.use_device and not self._any_batch_processed
                and not self.persistence.node_exists("r")
                and self._device_batch(arena, skeys, order, root)):
            self._any_batch_processed = True
            return
        self._any_batch_processed = True
        # Host level-synchronous sweep (native octree_sweep) for whatever
        # the device sweep did not take: the fresh first batch as one sweep
        # from the root, later batches as a root-rooted revisit.
        remaining = self._host_sweep_batch_start_nodes(
            arena, [(root, skeys, order)], root, 0)
        if not remaining:
            return
        self._do_tiling_for_node(arena, NodeTask(root, root, skeys, order))

    def _device_batch(self, arena, sorted_keys, sorted_ids,
                      root: NodeStructure) -> bool:
        """First-batch device path of the grid samplers: the whole octree
        assignment in one device sweep from the root — valid only for fresh
        nodes (no cached merges). False when the sampler has no sweep (the
        Poisson samplers) or the sweep reached re-rooting depths; the host
        engine then tiles the batch."""
        if self.sampling_strategy.name not in GRID_SAMPLERS:
            return False
        levels = self._device_select_levels(arena, sorted_keys, sorted_ids,
                                            root)
        if levels is None:
            return False
        self._persist_device_assignment(arena, sorted_keys, sorted_ids,
                                        levels, root)
        return True


class TilingAlgorithmFast(TilingAlgorithmBase):
    """TilingAlgorithmV3 (FAST): fixed start-node level, per-batch split,
    ancestor reconstruction at finalize."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.level_of_start_nodes: int | None = None
        # (key, levels) of every start node ever tiled — makes finalize
        # O(start nodes used) instead of probing 8**level names
        # (checkpointed for --resume so a resumed run reconstructs the
        # ancestors of nodes written by the interrupted run too).
        self._start_nodes_used: set[tuple] = set()

    def process_batch(self, buffer: PointBuffer, bounds: AABB) -> None:
        if not buffer.count:
            return
        keys = self.index_batch(buffer, bounds)
        arena = PointArena()
        arena.append(buffer)
        # fresh arena: ids are 0..n-1, so ids[order] IS order; sorted keys
        # come straight from the native sort (no keys[order] gather)
        keys, ids = indexing.sort_with_keys(keys)

        if self.level_of_start_nodes is None:
            self.level_of_start_nodes = self._estimate_start_node_level(keys)
            self._journal_string(
                f"Level of start nodes: {self.level_of_start_nodes}")

        root = self._make_root(bounds)
        start_nodes = list(self._split_at_start_level(keys, ids, root))
        self._journal_start_nodes(start_nodes)
        self._tile_split_start_nodes(arena, start_nodes, root,
                                     self.level_of_start_nodes)

    def _tile_split_start_nodes(self, arena, start_nodes, root,
                                level: int) -> None:
        """The post-split tiling pipeline for one batch's start nodes:
        with a device, fresh start nodes go to the device octree sweep
        (grid samplers) or straight to the per-node recursion (whose
        sampler runs the device Poisson kernel); then the host
        level-synchronous sweep, then the per-node recursion for whatever
        the sweep declined."""
        if level > 0:
            self._start_nodes_used.update(
                (morton.parse_node_name(node.name)[0], level)
                for node, _, _ in start_nodes)
        if self.meta.use_device and level > 0:
            # Fresh start nodes (no persisted file yet) have no cached
            # merges anywhere in their subtree, so their complete octree
            # assignment runs as device sweeps from the start level. The
            # Poisson samplers have no sweep: the JAX engine hands their
            # fresh start nodes to the per-node recursion, skipping the
            # native host sweep, which would sample them on the host; the
            # same hand-off here keeps that routing and persist order.
            # Revisited subtrees take the host sweep.
            fresh = [sn for sn in start_nodes
                     if not self.persistence.node_exists(sn[0].name)]
            if self.sampling_strategy.name in GRID_SAMPLERS:
                self._device_fresh_sweep_pipelined(arena, fresh, root, level)
            else:
                self._tile_start_nodes_parallel(
                    arena, [NodeTask(node, root, k, i)
                            for node, k, i in fresh])
            fresh_names = {node.name for node, _, _ in fresh}
            start_nodes = [sn for sn in start_nodes
                           if sn[0].name not in fresh_names]
        # Host level-synchronous sweep (native octree_sweep): whatever the
        # device path did not take — fresh subtrees in one concatenated
        # call, revisited subtrees via gather+sweep — leaving only guard
        # rejections / re-rooting depths to the per-node recursion.
        start_nodes = self._host_sweep_batch_start_nodes(
            arena, start_nodes, root, level)
        self._tile_start_nodes_parallel(
            arena, [NodeTask(node, root, k, i)
                    for node, k, i in start_nodes])

    # Fresh-sweep group size. The sweep's kernel takes a few ms a 4M-point
    # group on an H100, the persist of a group about half a second (PERF.md
    # section 5), so group g's sweep runs on the card inside group g-1's
    # persist; the size was kept as it was: nothing measured asks for
    # another.
    DEVICE_SWEEP_GROUP_POINTS = 4_000_000

    def _device_fresh_sweep_pipelined(self, arena, fresh, root,
                                      level: int) -> None:
        """Fresh start nodes as a pipeline of device sweeps: the fresh list
        is cut into contiguous groups of ~DEVICE_SWEEP_GROUP_POINTS points.
        For each group: launch its sweep, persist the previous group's
        levels on the host, then copy this group's levels back. On the card
        the sweep is enqueued whole and nothing comes back before that copy,
        so the whole sweep and its copy overlap the previous group's
        persist. Start-node subtrees are disjoint
        Morton prefixes at `level`, so per-group sweeps give exactly the
        single sweep's assignment (cells never span a start-node boundary
        at min_node_level = level - 1). A group that reached re-rooting
        depths goes to the host per-node recursion."""
        groups = []
        cur, cur_pts = [], 0
        for sn in fresh:
            cur.append(sn)
            cur_pts += sn[1].size
            if cur_pts >= self.DEVICE_SWEEP_GROUP_POINTS:
                groups.append(cur)
                cur, cur_pts = [], 0
        if cur:
            groups.append(cur)

        def flush(pending):
            if pending is None:
                return
            levels, fk, fi, group = pending
            if levels is None:
                self._tile_start_nodes_parallel(
                    arena, [NodeTask(node, root, k, i)
                            for node, k, i in group])
            else:
                self._persist_device_assignment(arena, fk, fi, levels, root)

        pending = None
        for group in groups:
            fk = np.concatenate([sn[1] for sn in group])
            fi = np.concatenate([sn[2] for sn in group])
            device_levels = self._device_select_levels(
                arena, fk, fi, root, min_node_level=level - 1,
                materialize=False)
            flush(pending)  # persist g-1 while g finishes on the card
            pending = (self._materialize_levels(device_levels), fk, fi,
                       group)
        flush(pending)

    def _tile_start_nodes_parallel(self, arena, tasks) -> None:
        """Host multi-core fan-out over disjoint start-node subtrees
        (round-3 verdict item 3; the reference's per-node Taskflow
        subflows, TilingAlgorithms.cpp:524-560, README.md:6 'dozens of
        logical cores'). Subtrees are disjoint key ranges, so workers
        never touch the same node; shared structures are individually
        locked (arena appends, node cache, sink trees, progress). The
        heavy kernels (native Poisson, radix sort, LAZ encode, numpy
        gathers) release the GIL, so threads scale on real cores.
        Output is byte-identical to the serial order because every node
        file's content depends only on its own subtree's points
        (asserted by tests/test_threaded_tiling.py)."""
        workers = min(self.meta.concurrency, len(tasks))
        if workers <= 1 or len(tasks) <= 1:
            for task in tasks:
                self._do_tiling_for_node(arena, task)
            return
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(self._do_tiling_for_node, arena, task)
                       for task in tasks]
            for f in futures:
                f.result()  # propagate the first worker exception

    @staticmethod
    def _journal_string(message: str) -> None:
        from ..util.config import global_config
        from ..util.journal import JournalStore

        cfg = global_config()
        if not cfg.is_journaling_enabled:
            return
        store = JournalStore.global_store()
        journal = store.get_journal("tiling_log")
        if journal is None:
            journal = store.new_journal("tiling_log").with_flat_type() \
                .as_text(cfg.journal_directory).into_single_file().build()
        journal.add_record(message)

    def _journal_start_nodes(self, start_nodes) -> None:
        """start_nodes graphviz journal (journal_start_nodes,
        TilingAlgorithms.cpp:27-43, 1305-1312)."""
        from ..util.config import global_config
        from ..util.journal import JournalStore

        cfg = global_config()
        if not cfg.is_journaling_enabled:
            return
        store = JournalStore.global_store()
        journal = store.get_journal("start_nodes")
        if journal is None:
            journal = store.new_journal("start_nodes").with_flat_type() \
                .as_text(cfg.journal_directory).into_unique_files().build()
        lines = ["digraph start_nodes {"]
        for node, k, _ in start_nodes:
            lines.append(f'  "{node.name}" [label="{node.name} - {k.size}"];')
        lines.append("}")
        journal.add_record("\n".join(lines))

    def _estimate_start_node_level(self, sorted_keys: np.ndarray) -> int:
        """estimate_start_node_level_in_octree (TilingAlgorithms.cpp:
        1473-1535): split progressively deeper until enough large ranges
        exist for the configured concurrency."""
        MIN_LEVEL, MAX_LEVEL, MIN_SCORE, LARGE = 3, 6, 1.0, 100_000
        # DOCUMENTED DEVIATION: the reference estimates from the first
        # batch alone and returns MAX_LEVEL when no range reaches LARGE
        # points — with batches < 100k that means up to 8^6 singleton
        # start nodes and an O(nodes) per-visit cost explosion (measured
        # 200k points / 50k batches: 182k node persists, 138 s). The
        # total dataset size is known from the metadata scan, so cap the
        # level at the smallest one whose node count covers
        # total/LARGE subtrees.
        max_level = MAX_LEVEL
        total = getattr(self, "total_points_hint", None)
        if total:
            want = max(1, -(-int(total) // LARGE))  # ceil(total / LARGE)
            cap = MIN_LEVEL
            while 8 ** cap < want and cap < MAX_LEVEL:
                cap += 1
            max_level = cap
        concurrency = self.meta.concurrency
        ranges = [(0, sorted_keys.size)]
        for level in range(max_level):
            new_ranges = []
            for lo, hi in ranges:
                b = indexing.child_octant_boundaries(sorted_keys, lo, hi, level)
                for o in range(8):
                    if b[o] < b[o + 1]:
                        new_ranges.append((int(b[o]), int(b[o + 1])))
            ranges = new_ranges
            if len(ranges) <= concurrency // 2:
                score = 0.0
            else:
                num_large = sum(1 for lo, hi in ranges if hi - lo >= LARGE)
                score = num_large / float(concurrency)
            if score >= MIN_SCORE:
                return min(max(level + 1, MIN_LEVEL), max_level)
        return max_level

    def _split_at_start_level(self, keys, ids, root: NodeStructure):
        """split_indexed_points_into_subranges (TilingAlgorithms.cpp:
        1537-1578) — all non-empty nodes at the start level, with their
        NodeStructure (cpp:1327-1343)."""
        level = self.level_of_start_nodes
        if level == 0:
            yield root, keys, ids
            return
        prefixes = morton.truncate_to_level(keys, level - 1)
        starts = indexing.run_starts(prefixes)
        ends = np.append(starts[1:], keys.size)
        for s, e in zip(starts, ends):
            node_key = int(prefixes[s])
            yield self._start_node_structure(node_key, level, root), \
                keys[s:e], ids[s:e]

    def _start_node_structure(self, node_key: int, levels: int,
                              root: NodeStructure) -> NodeStructure:
        return self._node_struct(node_key, levels, root)

    def finalize(self, bounds: AABB) -> None:
        """reconstruct_left_out_nodes (TilingAlgorithms.cpp:1717-1784),
        walking up from the start nodes actually tiled rather than probing
        all 8**level possible names."""
        if self.level_of_start_nodes is None or self.level_of_start_nodes == 0:
            return
        root = self._make_root(bounds)

        to_reconstruct: set[tuple] = set()
        for key, lv in self._start_nodes_used:
            while lv > 0:
                key >>= 3
                lv -= 1
                to_reconstruct.add((key, lv))

        # deepest first: children must exist before parents sample from them
        self._reconstruct_levels(to_reconstruct, root)

    def _reconstruct_levels(self, to_reconstruct, root) -> None:
        """Reconstruct ancestors deepest level first; nodes WITHIN a level
        are independent (each reads only its children, written by the
        previous level), so they fan out over the worker pool — the same
        multi-core surface as the reference's reconstruct pass
        (TilingAlgorithms.cpp:1717-1784 runs per-node tasks)."""
        by_level: dict[int, list] = {}
        for key, lv in to_reconstruct:
            by_level.setdefault(lv, []).append(key)
        workers = self.meta.concurrency
        for lv in sorted(by_level, reverse=True):
            keys = sorted(by_level[lv])
            if workers <= 1 or len(keys) <= 1:
                for key in keys:
                    self._reconstruct_single_node(key, lv, root)
                continue
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(
                    max_workers=min(workers, len(keys))) as pool:
                for f in [pool.submit(self._reconstruct_single_node,
                                      key, lv, root) for key in keys]:
                    f.result()

    def _reconstruct_single_node(self, node_key: int, levels: int,
                                 root: NodeStructure) -> None:
        """reconstruct_single_node (TilingAlgorithms.cpp:1661-1715): gather
        direct children's persisted points, re-index from root bounds,
        sample with AlwaysAdhere, persist the selected prefix only."""
        buffers = []
        for octant in range(8):
            child_name = "r" + morton.node_name_simple(
                (node_key << 3) | octant, levels + 1)
            child_points = self._retrieve_node(child_name)
            if child_points.count:
                buffers.append(child_points)
        if not buffers:
            return
        n_total = sum(b.count for b in buffers)
        if (self.persistence.is_lossless
                and not self.sampling_strategy.needs_positions(
                    n_total, SamplingBehaviour.AlwaysAdhereToMinSpacing)):
            # RANDOM_GRID selects purely on keys, and on a lossless sink
            # the children's stored positions are already root-clamped —
            # so index each child in a reused scratch (L2-resident; the
            # in-place clamp must not touch the cached buffer) and copy
            # only the SELECTED rows. Skips concatenating the full
            # payload, whose fresh-page allocation for every unselected
            # point dominated the non-sampler reconstruction cost.
            # Differentially tested against the generic path
            # (tests/test_tiling.py::test_reconstruct_keys_only_path).
            self._reconstruct_node_keys_only(node_key, levels, root, buffers)
            return
        if self._reconstruct_node_scratch(node_key, levels, root, buffers,
                                          n_total):
            return
        data = PointBuffer.concatenate(buffers)
        keys, clamped = indexing.index_points(data.positions,
                                              root.bounds.min, root.bounds.max)
        data.positions = clamped
        if not self.persistence.is_lossless \
                and not indexing.is_sorted(keys):
            order = indexing.sort_by_key(keys)
            keys = keys[order]
            data = data.take(order)

        node = self._start_node_structure(node_key, levels, root) \
            if levels > 0 else root
        result = self.sampling_strategy.sample(
            keys, data.positions, node.morton_key, levels - 1,
            root.bounds.min, root.bounds.max, root.max_spacing,
            SamplingBehaviour.AlwaysAdhereToMinSpacing)
        # only the selected prefix is persisted; gather just that —
        # selected_indices() avoids materializing the rest-half of the
        # sampling permutation (never needed at finalize)
        sel_idx = result.selected_indices()
        selected = (data.slice(0, result.selected_count).copy()
                    if sel_idx is None else data.take(sel_idx))
        if selected.count:
            self._persist_node(selected, node.bounds, node.name)

    # reused per-thread scratch for the keys-only reconstruction (children
    # are <= node size, so it stays cache-resident; reconstruction fans
    # out per level over the worker pool, hence thread-local)
    _reconstruct_scratch = threading.local()

    def _reconstruct_node_keys_only(self, node_key: int, levels: int,
                                    root: NodeStructure, buffers) -> None:
        """Keys-only twin of _reconstruct_single_node for samplers that
        never read positions (RANDOM_GRID under AlwaysAdhere): per-child
        key derivation in a reused scratch, selection on the concatenated
        keys, then a per-child gather of just the selected rows — byte
        identical to the generic concat-everything path."""
        tls = self._reconstruct_scratch
        scratch = getattr(tls, "pos", None)
        key_parts = []
        for b in buffers:
            n = b.count
            if scratch is None or scratch.shape[0] < n:
                scratch = tls.pos = np.empty((max(n, 4096), 3),
                                             dtype=np.float64)
            # index_points clamps IN PLACE; the cached buffer must keep
            # its stored values, so index a scratch copy
            np.copyto(scratch[:n], b.positions)
            k, _ = indexing.index_points(scratch[:n], root.bounds.min,
                                         root.bounds.max)
            key_parts.append(k)
        keys = (key_parts[0] if len(key_parts) == 1
                else np.concatenate(key_parts))
        node = self._start_node_structure(node_key, levels, root) \
            if levels > 0 else root
        result = self.sampling_strategy.sample(
            keys, None, node.morton_key, levels - 1,
            root.bounds.min, root.bounds.max, root.max_spacing,
            SamplingBehaviour.AlwaysAdhereToMinSpacing)
        sel = result.selected_indices()
        if sel is None:  # identity prefix (first-point / cand == -1 case)
            sel = np.arange(result.selected_count, dtype=np.int64)
        if not sel.size:
            return
        offsets = np.zeros(len(buffers) + 1, dtype=np.int64)
        np.cumsum([b.count for b in buffers], out=offsets[1:])
        cut = np.searchsorted(sel, offsets)  # sel is ascending
        parts = [buffers[i].take(sel[cut[i]:cut[i + 1]] - offsets[i])
                 for i in range(len(buffers)) if cut[i + 1] > cut[i]]
        selected = (parts[0] if len(parts) == 1
                    else PointBuffer.concatenate(parts))
        if selected.count:
            self._persist_node(selected, node.bounds, node.name)

    def _reconstruct_node_scratch(self, node_key: int, levels: int,
                                  root: NodeStructure, buffers,
                                  n_total: int) -> bool:
        """Positions-dependent twin of _reconstruct_node_keys_only: the
        children's positions concatenate into a reused scratch (clamped
        there; cached buffers keep their stored values), the sampler runs
        over the scratch, and only the SELECTED rows materialize —
        positions from the (clamped) scratch, attribute columns gathered
        per child. Byte-identical to the concat-everything path; returns
        False (caller falls back) when the derived keys are out of order
        (out-of-contract children need the full sort machinery)."""
        tls = self._reconstruct_scratch
        scratch = getattr(tls, "pos", None)
        if scratch is None or scratch.shape[0] < n_total:
            scratch = tls.pos = np.empty((max(n_total, 4096), 3),
                                         dtype=np.float64)
        offsets = np.zeros(len(buffers) + 1, dtype=np.int64)
        np.cumsum([b.count for b in buffers], out=offsets[1:])
        for i, b in enumerate(buffers):
            np.copyto(scratch[offsets[i]:offsets[i + 1]], b.positions)
        positions = scratch[:n_total]
        keys, _ = indexing.index_points(positions, root.bounds.min,
                                        root.bounds.max)
        if not self.persistence.is_lossless \
                and not indexing.is_sorted(keys):
            return False
        node = self._start_node_structure(node_key, levels, root) \
            if levels > 0 else root
        result = self.sampling_strategy.sample(
            keys, positions, node.morton_key, levels - 1,
            root.bounds.min, root.bounds.max, root.max_spacing,
            SamplingBehaviour.AlwaysAdhereToMinSpacing)
        sel = result.selected_indices()
        if sel is None:  # identity prefix (first-point / cand == -1 case)
            sel = np.arange(result.selected_count, dtype=np.int64)
        if not sel.size:
            return True
        # positions come from the scratch (the CLAMPED values the generic
        # path persists); columns gather per child, selected rows only
        selected = PointBuffer(positions[sel])
        cut = np.searchsorted(sel, offsets)  # sel is ascending
        common = set(buffers[0].columns)
        for b in buffers[1:]:
            common &= set(b.columns)
        for attr in common:
            parts = [buffers[i].columns[attr][sel[cut[i]:cut[i + 1]]
                                              - offsets[i]]
                     for i in range(len(buffers)) if cut[i + 1] > cut[i]]
            # fancy indexing already copied; single-part needs no concat
            selected.columns[attr] = (parts[0] if len(parts) == 1
                                      else np.concatenate(parts))
        self._persist_node(selected, node.bounds, node.name)
        return True


class TilingAlgorithmAdaptive(TilingAlgorithmFast):
    """TilingAlgorithmV2 semantics (TilingAlgorithms.cpp:630-1192): instead
    of a fixed start-node level, each batch splits the sorted range
    largest-range-first until at least `concurrency` start ranges exist
    (split_indexed_points_into_subranges, :792-869). Ancestors of every
    start node ever used are reconstructed at finalize — but only where no
    genuinely tiled node already exists, preserving point conservation
    across batches with differing start depths (the reference's
    reconstruct_* pass, :1113-1190, re-samples skipped nodes from their
    children the same way)."""

    def process_batch(self, buffer: PointBuffer, bounds: AABB) -> None:
        if not buffer.count:
            return
        keys = self.index_batch(buffer, bounds)
        arena = PointArena()
        arena.append(buffer)
        keys, ids = indexing.sort_with_keys(keys)
        self.level_of_start_nodes = max(self.level_of_start_nodes or 0, 0)

        root = self._make_root(bounds)
        tasks = []
        for node_key, levels, lo, hi in self._adaptive_split(keys):
            node = (root if levels == 0
                    else self._start_node_structure(node_key, levels, root))
            self._start_nodes_used.add((node_key, levels))
            tasks.append(NodeTask(node, root, keys[lo:hi], ids[lo:hi]))
        self._tile_start_nodes_parallel(arena, tasks)

    def _adaptive_split(self, sorted_keys: np.ndarray):
        """Largest-range-first octant splitting until >= concurrency
        ranges (or ranges cannot split further)."""
        target = max(1, self.meta.concurrency)
        ranges = [(0, 0, 0, sorted_keys.size)]  # (node_key, levels, lo, hi)
        while len(ranges) < target:
            ranges.sort(key=lambda r: r[3] - r[2], reverse=True)
            node_key, levels, lo, hi = ranges[0]
            if levels >= MAX_OCTREE_LEVELS - 1 or hi - lo <= 1:
                break
            b = indexing.child_octant_boundaries(sorted_keys, lo, hi, levels)
            children = [((node_key << 3) | o, levels + 1,
                         int(b[o]), int(b[o + 1]))
                        for o in range(8) if b[o] < b[o + 1]]
            if len(children) == 1 and children[0][2:] == (lo, hi):
                # all points in one octant: descend without gaining ranges
                ranges[0] = children[0]
                continue
            ranges = ranges[1:] + children
        return sorted(ranges, key=lambda r: r[2])

    def finalize(self, bounds: AABB) -> None:
        if not self._start_nodes_used:
            return
        root = self._make_root(bounds)
        to_reconstruct: set[tuple] = set()
        for key, lv in self._start_nodes_used:
            while lv > 0:
                key >>= 3
                lv -= 1
                name = ("r" + morton.node_name_simple(key, lv)) if lv else "r"
                if not self.persistence.node_exists(name):
                    to_reconstruct.add((key, lv))
        self._reconstruct_levels(to_reconstruct, root)


def make_tiling_algorithm(strategy: TilingStrategy,
                          sampling_strategy: SamplingStrategy, persistence,
                          meta: TilerMetaParameters, progress_reporter=None):
    if meta.multichip > 0:
        from ..parallel.multidevice import TilingAlgorithmMultiDevice

        return TilingAlgorithmMultiDevice(sampling_strategy, persistence,
                                          meta, progress_reporter)
    cls = {TilingStrategy.Accurate: TilingAlgorithmAccurate,
           TilingStrategy.Fast: TilingAlgorithmFast,
           TilingStrategy.Adaptive: TilingAlgorithmAdaptive}[strategy]
    return cls(sampling_strategy, persistence, meta, progress_reporter)

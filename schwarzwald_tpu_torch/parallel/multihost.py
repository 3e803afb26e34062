"""Multi-host tiling coordination: `--multihost I N`.

The port of schwarzwald_tpu/parallel/multihost.py. The reference is strictly
single-process (SURVEY.md §2.5: its "distributed backend" is a thread
scheduler); scaling past one host is new functionality. The design (SURVEY.md
§2.5 communication plan / §7 multi-host):

  1. **File assignment** (metadata only): every host reads all file headers
     (cheap) and takes a deterministic, size-balanced subset of the input
     files, the ReadCommand queue generalized across hosts.
  2. **Global bounds**: each host unions its local file bounds; the global
     cubic root bounds come from an all-gather over the caller's
     torch.distributed process group (min/max per axis), so every host
     tiles against identical root bounds (required for identical Morton
     keys).
  3. **Octree ownership**: start nodes (the FAST strategy's fixed level)
     are partitioned over hosts by contiguous Morton blocks, the scheme the
     multi-device exchange uses per shard (ops.device.ShardedExchange).
     Each host tiles only the start nodes it owns; points read on one host
     and owned by another travel through the shared output filesystem
     (MultiHostCoordinator below).
  4. **Ancestor reconstruction**: after all hosts finalize their subtrees,
     the shared ancestors above the start level are reconstructed
     distributed and level-synchronously: each host reconstructs the
     ancestors rooted in its own Morton block, and a per-level barrier
     publishes each level's files on the shared filesystem before the next
     (shallower) level reads them. Every ancestor is a deterministic
     function of its children's persisted bytes, so the output is
     byte-identical to one host doing it alone.

Planning (1-3) is pure functions testable in one process;
`all_reduce_bounds` uses torch.distributed when the caller has initialized
a process group and is the identity otherwise. The rest is host code, the
JAX package's own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np

from ..core.aabb import AABB


@dataclasses.dataclass
class MultiHostPlan:
    process_index: int
    process_count: int
    local_files: list
    global_bounds_cubic: AABB
    # (start_key_lo, start_key_hi) of level-`start_level` node keys owned
    # by this host (contiguous Morton block partition)
    start_level: int
    owned_node_range: tuple


def assign_files(files_with_counts, process_index: int,
                 process_count: int) -> list:
    """Deterministic size-balanced file assignment: greedy largest-first
    onto the least-loaded host (every host computes the same plan)."""
    order = sorted(files_with_counts, key=lambda fc: (-fc[1], fc[0]))
    loads = [0] * process_count
    mine = []
    for path, count in order:
        target = int(np.argmin(loads))
        loads[target] += count
        if target == process_index:
            mine.append(path)
    return mine


def owned_node_block(process_index: int, process_count: int,
                     start_level: int) -> tuple:
    """Contiguous Morton block of level-`start_level` node keys owned by
    this host (mirrors the per-device level-3 cell blocks of
    ops.device.make_sharded_encode_sort)."""
    total = 8 ** start_level
    lo = (total * process_index) // process_count
    hi = (total * (process_index + 1)) // process_count
    return lo, hi


def _distributed_initialized() -> bool:
    """True only when the caller has initialized a torch.distributed
    process group. The probe initializes nothing: planning never starts a
    process group and never touches CUDA, so the filesystem-coordinated
    multihost path plans without any device. A caller that initialized a
    group has imported torch.distributed, so the probe imports no torch
    (the host run imports none)."""
    dist = sys.modules.get("torch.distributed")
    return (dist is not None and dist.is_available()
            and dist.is_initialized())


def all_reduce_bounds(local_bounds: AABB) -> AABB:
    """Global bounds union across processes: an all-gather of [min, max]
    over the caller's default process group when its world size is above 1;
    the local bounds otherwise.

    A LIVE collective is never allowed to degrade silently: if the group is
    initialized and the all-gather fails on one host, that host would tile
    against its local bounds while the others use the union (different
    cubic roots, different Morton keys, silently corrupt merged output), so
    its failure raises. With NCCL the gathered tensor lives on the group's
    device (the caller's current CUDA device), with gloo on the CPU."""
    if not (_distributed_initialized()
            and sys.modules["torch.distributed"].get_world_size() > 1):
        return AABB(local_bounds.min, local_bounds.max)
    import torch
    import torch.distributed as dist

    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.tensor(np.concatenate([local_bounds.min, local_bounds.max]),
                        dtype=torch.float64, device=device)
    gathered = [torch.empty_like(mine)
                for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, mine)
    gathered = torch.stack(gathered).cpu().numpy()
    return AABB(gathered[:, :3].min(axis=0), gathered[:, 3:].max(axis=0))


def plan_multihost_tiling(files_with_counts, local_bounds: AABB,
                          start_level: int = 3,
                          process_index: int | None = None,
                          process_count: int | None = None) -> MultiHostPlan:
    """Build this host's deterministic share of a multi-host tiling run.
    Without explicit indices, the rank and world size of an initialized
    process group, else a single process."""
    if process_index is None or process_count is None:
        if _distributed_initialized():
            import torch.distributed as dist

            process_index = dist.get_rank()
            process_count = dist.get_world_size()
        else:
            process_index, process_count = 0, 1

    bounds = all_reduce_bounds(local_bounds).cubic()
    return MultiHostPlan(
        process_index=process_index,
        process_count=process_count,
        local_files=assign_files(files_with_counts, process_index,
                                 process_count),
        global_bounds_cubic=bounds,
        start_level=start_level,
        owned_node_range=owned_node_block(process_index, process_count,
                                          start_level),
    )


# ---------------------------------------------------------------------------
# Filesystem-coordinated multi-host execution
# ---------------------------------------------------------------------------
#
# A real multi-host run needs points read by host A but owned by host B to
# reach B. Within a host that is the shard exchange (parallel.multidevice);
# ACROSS hosts this framework uses the shared persistence filesystem as the
# transport (SURVEY §2.5): each host spills foreign points as lossless BIN
# batches into a per-owner exchange directory, and barriers are marker
# files. This needs
# no network runtime beyond the shared filesystem every multi-host tiling
# deployment already requires for its output.


class MultiHostCoordinator:
    """Exchange directory + barrier protocol for one tiling run.

    Run identity: host 0 wipes `.mh-exchange/`, generates a fresh nonce,
    creates `.mh-exchange/<nonce>/` and atomically publishes the nonce in
    the `prepared_0` marker; other hosts block in the constructor until
    the marker exists and join the nonce-named directory. Markers and
    spills from a crashed earlier run can therefore never be confused
    with this run's: a stale nonce names a directory host 0 has deleted,
    so a host that raced onto it fails loudly at the next barrier timeout
    instead of silently ingesting stale spills (round-2 advisor finding).

    Protocol per host i (of n):
      1. tile own files; spill points of foreign start nodes to
         .mh-exchange/<nonce>/to_<owner>/from<i>_<seq>.bin
      2. touch spills_done_<i>; wait for all spills_done_*
      3. ingest every to_<i>/ spill as a normal batch (all its points land
         in host i's owned start nodes); write start_nodes_<i>.json
      4. touch subtree_done_<i>; ALL hosts wait for all subtree_done_*,
         union the manifests and reconstruct their own Morton block's
         share of the shared ancestors, one recon_l<level>_<i> barrier
         per tree level (deepest first)
    """

    POLL_SECONDS = 0.2

    def __init__(self, output_directory: str, process_index: int,
                 process_count: int, timeout: float = 3600.0):
        import os
        import shutil
        import time
        import uuid

        base = os.path.join(output_directory, ".mh-exchange")
        self.process_index = process_index
        self.process_count = process_count
        self.timeout = timeout
        prepared = os.path.join(base, "prepared_0")
        if process_index == 0:
            shutil.rmtree(base, ignore_errors=True)
            nonce = uuid.uuid4().hex[:12]
            self.dir = os.path.join(base, nonce)
            os.makedirs(os.path.join(self.dir, "to_0"))
            tmp = prepared + ".tmp"
            with open(tmp, "w") as f:
                f.write(nonce)
            os.replace(tmp, prepared)
        else:
            deadline = time.monotonic() + timeout
            while not os.path.exists(prepared):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        "multi-host barrier 'prepared' timed out waiting "
                        "for host 0")
                time.sleep(self.POLL_SECONDS)
            nonce = open(prepared).read().strip()
            self.dir = os.path.join(base, nonce)
            os.makedirs(os.path.join(self.dir, f"to_{process_index}"),
                        exist_ok=True)
        self._prepared_path = prepared
        self._nonce = nonce

    def spill_dir(self, owner: int) -> str:
        import os

        path = os.path.join(self.dir, f"to_{owner}")
        os.makedirs(path, exist_ok=True)
        return path

    def mark(self, phase: str) -> None:
        import os

        open(os.path.join(self.dir, f"{phase}_{self.process_index}"),
             "w").close()

    def wait_all(self, phase: str) -> None:
        self._wait(phase, list(range(self.process_count)))

    def _wait(self, phase: str, hosts) -> None:
        import os
        import time

        deadline = time.monotonic() + self.timeout
        while True:
            missing = [i for i in hosts
                       if not os.path.exists(
                           os.path.join(self.dir, f"{phase}_{i}"))]
            if not missing:
                return
            # Fast stale-run detection: if the published nonce no longer
            # matches ours, we joined a crashed run's leftovers and a
            # fresh host 0 has since started a new run — fail now rather
            # than blocking until the timeout.
            try:
                current = open(self._prepared_path).read().strip()
            except OSError:
                current = None
            if current != self._nonce:
                raise RuntimeError(
                    f"multi-host run superseded: exchange nonce changed "
                    f"while waiting at barrier '{phase}' (this host "
                    f"joined a stale run)")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"multi-host barrier '{phase}' timed out waiting for "
                    f"hosts {missing}")
            time.sleep(self.POLL_SECONDS)

    def write_manifest(self, start_nodes_used) -> None:
        import json
        import os

        with open(os.path.join(
                self.dir, f"start_nodes_{self.process_index}.json"),
                "w") as f:
            json.dump(sorted([int(k), int(lv)] for k, lv in
                             start_nodes_used), f)

    def union_manifests(self) -> set:
        import json
        import os

        out = set()
        for i in range(self.process_count):
            path = os.path.join(self.dir, f"start_nodes_{i}.json")
            if os.path.exists(path):
                out.update((int(k), int(lv)) for k, lv in
                           json.load(open(path)))
        return out

    def cleanup(self) -> None:
        import os
        import shutil

        shutil.rmtree(os.path.dirname(self.dir), ignore_errors=True)


class TilingAlgorithmMultiHost:
    """FAST-semantics tiling of this host's owned octree block, spilling
    foreign points through the coordinator. Wraps a TilingAlgorithmFast
    pinned to the plan's start level.

    Observability: `seconds`, the wall seconds of each step of the run on
    this host: own_batches (tiling the owned points of its own files, the
    spill writes included), spill_writes, wait_spills, ingest, publish,
    wait_subtrees, reconstruct (the per-level barriers included),
    wait_levels, and on host 0 wait_finalize."""

    def __init__(self, sampling_strategy, persistence, meta,
                 plan: MultiHostPlan, coordinator: MultiHostCoordinator,
                 progress_reporter=None, inner=None):
        from ..io.bin_persistence import BinaryPersistence
        from ..tiling.engine import TilingAlgorithmFast

        self.plan = plan
        self.coordinator = coordinator
        if inner is not None:
            self.inner = inner
        elif meta.multichip > 0:
            # multihost x multichip composition: this host's owned subset
            # fans out over its LOCAL device mesh (SURVEY §2.5 plan:
            # filesystem routing between hosts, the shard exchange within).
            # The exchange stripes the host's OWNED cell block — striping
            # the global space would leave (hosts-1)/hosts of the local
            # devices with nothing to do on every batch.
            from .multidevice import TilingAlgorithmMultiDevice, make_mesh
            self.inner = TilingAlgorithmMultiDevice(
                sampling_strategy, persistence, meta, progress_reporter,
                mesh=make_mesh(meta.multichip, meta.use_device),
                ownership_level=plan.start_level,
                cell_range=plan.owned_node_range)
        else:
            self.inner = TilingAlgorithmFast(sampling_strategy, persistence,
                                             meta, progress_reporter)
        self.inner.level_of_start_nodes = plan.start_level
        self._spill_sinks = {
            owner: BinaryPersistence(coordinator.spill_dir(owner))
            for owner in range(plan.process_count)
            if owner != plan.process_index}
        self._spill_seq = 0
        self.seconds: dict = {}

    @contextlib.contextmanager
    def _timed(self, step: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[step] = (self.seconds.get(step, 0.0)
                                  + time.perf_counter() - t0)

    # -- owner routing --------------------------------------------------

    def _owner_of(self, node_key: int) -> int:
        """Exact inverse of owned_node_block's floor(total*i/count)
        boundaries: (k*c) // total disagrees at block edges whenever count
        does not divide the cell count (e.g. node 170 of 512 with 3 hosts)."""
        count = self.plan.process_count
        total = 8 ** self.plan.start_level
        return (node_key * count + count - 1) // total

    def process_batch(self, buffer, bounds) -> None:
        with self._timed("own_batches"):
            self._process_own_batch(buffer, bounds)

    def _process_own_batch(self, buffer, bounds) -> None:
        from ..core import morton
        from ..ops import indexing
        from ..tiling.arena import PointArena

        if not buffer.count:
            return
        inner = self.inner
        keys = inner.index_batch(buffer, bounds)
        arena = PointArena()
        arena.append(buffer)
        keys, ids = indexing.sort_with_keys(keys)
        root = inner._make_root(bounds)
        level = self.plan.start_level
        lo_own, hi_own = self.plan.owned_node_range

        owned_k, owned_i = [], []
        owned_nodes = []
        foreign: dict = {}  # owner -> [ids]; one spill file per owner/batch
        for node, k, i in inner._split_at_start_level(keys, ids, root):
            node_key = morton.parse_node_name(node.name)[0]
            if lo_own <= node_key < hi_own:
                if hasattr(inner, "process_sorted"):
                    # multichip inner: collect the owned stream and fan it
                    # out over the local mesh in one routed pass
                    owned_k.append(k)
                    owned_i.append(i)
                else:
                    # _tile_split_start_nodes records _start_nodes_used
                    owned_nodes.append((node, k, i))
            else:
                foreign.setdefault(self._owner_of(node_key), []).append(i)
        with self._timed("spill_writes"):
            for owner, id_parts in foreign.items():
                # ingest re-derives Morton keys and re-splits, so per-node
                # spill granularity buys nothing: one file per (owner,
                # batch) instead of per (owner, batch, start node)
                name = f"from{self.plan.process_index}_{self._spill_seq:06d}"
                self._spill_seq += 1
                self._spill_sinks[owner].persist_points(
                    arena.gather(np.concatenate(id_parts)
                                 if len(id_parts) > 1 else id_parts[0]),
                    root.bounds, name)
        if owned_nodes:
            # The single-host engine's post-split pipeline (device fresh/
            # revisit sweeps when --use-device, host level-synchronous
            # native sweep, per-node recursion for what the sweeps
            # decline) — shared via _tile_split_start_nodes so multihost
            # owned batches take the same device path a single-host run
            # does. Byte-identical to recursing every node
            # (tests/test_multihost_e2e.py).
            inner._tile_split_start_nodes(arena, owned_nodes, root, level)
        if owned_k:
            inner.process_sorted(arena, np.concatenate(owned_k),
                                 np.concatenate(owned_i), root)

    def ingest_foreign(self, bounds) -> int:
        """Step 3: process every spill batch addressed to this host.

        Spill files are COALESCED into full-size batches before
        processing: each sender emits one small file per (batch x foreign
        start node), and once this host's subtree exists, every
        process_batch pays a whole-subtree revisit merge — per tiny file
        that is O(spill_files x tree) (measured 2.3 s to ingest 250k pts
        on the config-5 bench, longer than tiling the host's own 500k).
        One coalesced pass re-merges the tree once per internal-cache
        window instead."""
        import os

        from ..core.pointbuffer import PointBuffer
        from ..io.bin_persistence import BinaryPersistence

        spill_dir = self.coordinator.spill_dir(self.plan.process_index)
        sink = BinaryPersistence(spill_dir)
        cap = max(1, int(getattr(self.inner.meta, "internal_cache_size",
                                 10_000_000)))
        total = 0
        pending: list = []
        pending_count = 0

        def flush():
            nonlocal pending, pending_count, total
            if not pending:
                return
            buf = (pending[0] if len(pending) == 1
                   else PointBuffer.concatenate(pending))
            # spilled positions are already clamped; re-deriving their
            # Morton keys is idempotent, so a normal batch pass lands
            # them in this host's owned start nodes
            self.inner.process_batch(buf, bounds)
            total += buf.count
            pending, pending_count = [], 0

        for name in sorted(os.listdir(spill_dir)):
            if not name.endswith(".bin"):
                continue
            buf = sink.retrieve_points(name[:-4])
            if not buf.count:
                continue
            pending.append(buf)
            pending_count += buf.count
            if pending_count >= cap:
                flush()
        flush()
        return total

    def finalize(self, bounds) -> None:
        """Steps 2-4 of the coordinator protocol."""
        coord = self.coordinator
        coord.mark("spills_done")
        with self._timed("wait_spills"):
            coord.wait_all("spills_done")
        with self._timed("ingest"):
            self.ingest_foreign(bounds)
        with self._timed("publish"):
            self._publish_subtree()
        coord.mark("subtree_done")
        with self._timed("wait_subtrees"):
            coord.wait_all("subtree_done")
        self.inner._start_nodes_used = coord.union_manifests()
        with self._timed("reconstruct"):
            self._reconstruct_distributed(bounds)
        # Cleanup handshake: a host inside wait_all polls the exchange
        # dir, so host 0 must not delete it until every host has LEFT its
        # last barrier. finalize_done is marked after the final recon
        # barrier and no host polls after marking it.
        coord.mark("finalize_done")
        if self.plan.process_index == 0:
            with self._timed("wait_finalize"):
                coord.wait_all("finalize_done")
            coord.cleanup()

    def _publish_subtree(self) -> None:
        coord = self.coordinator
        sink = getattr(self.inner, "persistence", None)
        # Publish this host's subtree as REAL files before the barrier:
        # drain the per-host packed spill arena (if any) and flush any
        # write-behind queue — EVERY host's reconstruction share reads
        # other hosts' files right after wait_all("subtree_done"). The
        # engine's persistence is unwrapped to the real sink so the
        # reconstruction writes below are real files too (the spill
        # scratch is gone; its fds are closed).
        if hasattr(sink, "drain_and_discard"):
            sink.drain_and_discard()
            self.inner.persistence = sink = sink.inner
        if hasattr(sink, "commit_batch"):
            sink.commit_batch()  # drains async writers; staging inert
        coord.write_manifest(self.inner._start_nodes_used)

    def _reconstruct_distributed(self, bounds) -> None:
        """Step 4: reconstruct_left_out_nodes distributed over the hosts.

        The single-host finalize walks the ancestor pyramid deepest level
        first; nodes WITHIN a level are independent (each reads only its
        children, written by the previous level). Here each level is
        additionally partitioned ACROSS hosts: host i reconstructs the
        ancestors whose first start-level descendant falls in its owned
        Morton block (cache locality — those children were tiled here),
        then a recon_l<level> barrier makes the level's files visible on
        the shared filesystem before any host ascends. Each ancestor is a
        deterministic function of its children's persisted bytes, so
        which host reconstructs it cannot change the output
        (byte-identity vs a single-host run is asserted in
        tests/test_multihost_e2e.py). On a 1-core box the hosts
        timeshare; on real deployments this divides the previous
        host-0-only finalize floor by the host count."""
        inner = self.inner
        start_level = self.plan.start_level
        if not start_level:
            return
        root = inner._make_root(bounds)
        by_level: dict = {}
        for key, lv in inner._start_nodes_used:
            while lv > 0:
                key >>= 3
                lv -= 1
                by_level.setdefault(lv, set()).add(key)
        coord = self.coordinator
        sink = getattr(inner, "persistence", None)
        self.reconstructed_nodes = 0
        for lv in sorted(by_level, reverse=True):
            mine = {(k, lv) for k in by_level[lv]
                    if self._owner_of(k << (3 * (start_level - lv)))
                    == self.plan.process_index}
            if mine:
                inner._reconstruct_levels(mine, root)
                self.reconstructed_nodes += len(mine)
                if hasattr(sink, "commit_batch"):
                    sink.commit_batch()  # publish write-behind files
            coord.mark(f"recon_l{lv}")
            with self._timed("wait_levels"):
                coord.wait_all(f"recon_l{lv}")

    # passthroughs used by the Tiler / checkpointing
    @property
    def level_of_start_nodes(self):
        return self.inner.level_of_start_nodes

    @level_of_start_nodes.setter
    def level_of_start_nodes(self, value):
        # The ownership level is fixed by the multihost plan; a
        # fixed_start_level that contradicts it would desynchronize the
        # hosts' exchange blocks — accept only the plan's own level.
        if int(value) != int(self.plan.start_level):
            raise ValueError(
                f"multihost start level is pinned to plan.start_level="
                f"{self.plan.start_level}; cannot set {value}")
        self.inner.level_of_start_nodes = int(value)

    @property
    def _start_nodes_used(self):
        return self.inner._start_nodes_used

"""Tiler meta parameters (TilingAlgorithms.h TilerMetaParameters +
TilingStrategy, schwarzwald/core/process/Tiler.h:24-78)."""
from __future__ import annotations

import dataclasses
import enum


class TilingStrategy(enum.Enum):
    Accurate = "ACCURATE"  # TilingAlgorithmV1
    Fast = "FAST"          # TilingAlgorithmV3 (default)
    Adaptive = "ADAPTIVE"  # TilingAlgorithmV2 (not exposed by the
    #                        reference CLI either, TilingAlgorithms.h:150)


@dataclasses.dataclass
class TilerMetaParameters:
    spacing_at_root: float = 0.0
    max_depth: int = 100
    max_points_per_node: int = 20_000
    internal_cache_size: int = 10_000_000
    batch_read_size: int = 1_000_000
    tiling_strategy: TilingStrategy = TilingStrategy.Fast
    shift_points_to_origin: bool = False
    # Parallelism hint used by the FAST strategy's start-node-level
    # estimation (the reference uses the indexing thread count,
    # TilingAlgorithms.cpp:1294-1295); here it sizes the number of
    # independently processed start-node segments.
    concurrency: int = 8
    # Device path: None = host only; "cuda"/"cpu" = run the fresh octree
    # selection of the grid samplers as the device sweep
    # (ops/device_tiling) and the Poisson samplers' large ranges through
    # their kernel on that torch device; host engine for revisits.
    use_device: str | None = None
    # In-memory node cache (bytes) backing the per-visit cached-point
    # re-reads. The reference parses --cache-size but never wires its
    # LRUCache into the main path (SURVEY §2.3); here it skips the
    # disk read-back for hot nodes. Only active with LOSSLESS persistence
    # (lossy sinks must re-read quantized points for parity). 0 = off.
    cache_size_bytes: int = 0
    # Multi-chip: >0 shards every batch's sort + start-level split across
    # an n-device mesh (parallel.multidevice, lossless payload exchange).
    # Forces FAST semantics with the ownership level as start-node level.
    multichip: int = 0

"""Tiling engine: batched octree construction over Morton-sorted points."""

from .meta import TilerMetaParameters, TilingStrategy  # noqa: F401
from .engine import make_tiling_algorithm, TilingAlgorithmAccurate, TilingAlgorithmFast  # noqa: F401

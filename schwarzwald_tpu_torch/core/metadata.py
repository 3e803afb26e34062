"""Dataset metadata aggregation.

Parity: DatasetMetadata (schwarzwald/core/pointcloud/FileStats.{h,cpp}):
per-file (count, bounds) map, running total count, tight bounds union and
the cubic root bounds derived from the tight union; cubic-at-origin used for
the 3DTILES center shift.
"""
from __future__ import annotations

from .aabb import AABB


class DatasetMetadata:
    def __init__(self):
        self._per_file: dict[str, tuple] = {}
        self._total_count = 0
        self._tight = AABB()

    def add_file_metadata(self, path: str, points_count: int,
                          bounds: AABB) -> None:
        if path in self._per_file:
            raise ValueError(f"Metadata for file {path} has already been added!")
        self._per_file[path] = (points_count, bounds)
        self._total_count += points_count
        self._tight.update(bounds)

    def get_all_files_metadata(self):
        return dict(self._per_file)

    def total_points_count(self) -> int:
        return self._total_count

    def total_bounds_tight(self) -> AABB:
        return AABB(self._tight.min, self._tight.max)

    def total_bounds_cubic(self) -> AABB:
        return self._tight.cubic()

    def total_bounds_cubic_at_origin(self) -> AABB:
        cubic = self.total_bounds_cubic()
        center = cubic.center()
        return AABB(cubic.min - center, cubic.max - center)

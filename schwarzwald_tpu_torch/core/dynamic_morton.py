"""Runtime-depth Morton index.

Parity: DynamicMortonIndex (schwarzwald/core/datastructures/
DynamicMortonIndex.{h,cpp}): an octant sequence of arbitrary depth with
parse/print in the three naming conventions (Simple / Potree / Entwine),
child/parent/truncate navigation, and conversion to the packed node-key
(key, levels) representation used by core.morton / core.octree.
"""
from __future__ import annotations

from . import morton


class DynamicMortonIndex:
    __slots__ = ("octants",)

    def __init__(self, octants=()):
        self.octants = tuple(int(o) & 0b111 for o in octants)

    # -- construction -------------------------------------------------------

    @classmethod
    def parse_string(cls, text: str) -> "DynamicMortonIndex":
        key, levels = morton.parse_node_name(text)
        return cls.from_node_key(key, levels)

    @classmethod
    def from_node_key(cls, key: int, levels: int) -> "DynamicMortonIndex":
        return cls(((key >> (3 * (levels - 1 - i))) & 0b111
                    for i in range(levels)))

    # -- navigation ---------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.octants)

    def child(self, octant: int) -> "DynamicMortonIndex":
        return DynamicMortonIndex(self.octants + (octant,))

    def parent(self) -> "DynamicMortonIndex":
        if not self.octants:
            raise ValueError("Root index has no parent")
        return DynamicMortonIndex(self.octants[:-1])

    def truncate_to_depth(self, depth: int) -> "DynamicMortonIndex":
        if depth > self.depth:
            raise ValueError(f"truncate_to_depth({depth}) on depth "
                             f"{self.depth} index")
        return DynamicMortonIndex(self.octants[:depth])

    def to_node_key(self):
        key = 0
        for o in self.octants:
            key = (key << 3) | o
        return key, self.depth

    # -- naming -------------------------------------------------------------

    def to_string(self, convention: str = "potree") -> str:
        key, levels = self.to_node_key()
        if convention == "potree":
            return morton.node_name_potree(key, levels)
        if convention == "simple":
            return morton.node_name_simple(key, levels)
        if convention == "entwine":
            return morton.node_name_entwine(key, levels)
        raise ValueError(f"Unknown naming convention {convention!r}")

    def __eq__(self, other) -> bool:
        return (isinstance(other, DynamicMortonIndex)
                and self.octants == other.octants)

    def __hash__(self) -> int:
        return hash(self.octants)

    def __repr__(self) -> str:
        return f"DynamicMortonIndex({list(self.octants)})"

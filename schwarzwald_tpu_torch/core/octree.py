"""Generic sparse octree container.

Equivalent of Octree<T> (schwarzwald/core/datastructures/Octree.h:28-490): a
hash map from node index (key, levels) to values, with parent/child/sibling
navigation, level/pre/post-order traversal, structural transform_merge and a
graphviz dump. Node indices follow core.morton node-key semantics: a node at
depth d is identified by the low 3*d bits of `key`.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

NodeIndex = tuple  # (key: int, levels: int)

ROOT: NodeIndex = (0, 0)


def parent(index: NodeIndex) -> NodeIndex:
    key, levels = index
    if levels == 0:
        raise ValueError("Root node has no parent")
    return key >> 3, levels - 1


def child(index: NodeIndex, octant: int) -> NodeIndex:
    key, levels = index
    return (key << 3) | (octant & 0b111), levels + 1


def octant_of(index: NodeIndex) -> int:
    key, levels = index
    if levels == 0:
        raise ValueError("Root node is not an octant of anything")
    return key & 0b111


def parent_at_level(index: NodeIndex, level: int) -> NodeIndex:
    """Ancestor with `level` levels (OctreeNodeIndex.h:318-340)."""
    key, levels = index
    if level > levels:
        raise ValueError(f"parent_at_level({level}) of depth-{levels} node")
    return key >> (3 * (levels - level)), level


class Octree:
    """Sparse octree: dict of NodeIndex -> value.

    Unlike the reference (which materializes a root), an empty tree has no
    nodes; inserting a node does not implicitly create ancestors (matching
    Octree<T>::insert semantics where lookups of absent nodes fail).
    """

    def __init__(self, items=None):
        self._nodes: dict = dict(items or {})

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, index: NodeIndex) -> bool:
        return tuple(index) in self._nodes

    def __getitem__(self, index: NodeIndex):
        return self._nodes[tuple(index)]

    def __setitem__(self, index: NodeIndex, value) -> None:
        self._nodes[tuple(index)] = value

    def get(self, index: NodeIndex, default=None):
        return self._nodes.get(tuple(index), default)

    def insert(self, index: NodeIndex, value) -> None:
        self._nodes[tuple(index)] = value

    def erase(self, index: NodeIndex) -> None:
        del self._nodes[tuple(index)]

    def indices(self):
        return self._nodes.keys()

    def items(self):
        return self._nodes.items()

    def children_of(self, index: NodeIndex):
        return [child(index, o) for o in range(8) if child(index, o) in self]

    def is_leaf(self, index: NodeIndex) -> bool:
        return not self.children_of(index)

    def max_depth(self) -> int:
        return max((levels for _, levels in self._nodes), default=0)

    # -- traversals ---------------------------------------------------------

    def traverse_level_order(self) -> Iterator[NodeIndex]:
        for index in sorted(self._nodes, key=lambda i: (i[1], i[0])):
            yield index

    def traverse_preorder(self, start: Optional[NodeIndex] = None):
        roots = ([start] if start is not None else
                 [i for i in self.traverse_level_order()
                  if i[1] == 0 or parent(i) not in self])
        stack = list(reversed(roots))
        while stack:
            index = stack.pop()
            yield index
            stack.extend(reversed(self.children_of(index)))

    def traverse_postorder(self, start: Optional[NodeIndex] = None):
        out = list(self.traverse_preorder(start))
        # children before parents: reverse of preorder with child order flip
        # is a valid postorder for our independent-subtree visits
        for index in sorted(out, key=lambda i: -i[1]):
            yield index

    # -- merge --------------------------------------------------------------

    @staticmethod
    def transform_merge(left: "Octree", right: "Octree",
                        transform: Callable, merge: Callable) -> "Octree":
        """Structural union with per-value transform on right-tree values and
        merge on conflicts (Octree.h:290-318). `left` values are assumed to
        already be in target form."""
        out = Octree(left._nodes)
        for index, value in right.items():
            transformed = transform(value)
            if index in out:
                out[index] = merge(out[index], transformed)
            else:
                out[index] = transformed
        return out

    def to_graphviz(self, label_fn: Callable = None) -> str:
        from . import morton as m

        def name(index):
            return m.node_name_potree(index[0], index[1])

        lines = ["digraph octree {"]
        for index in self.traverse_level_order():
            label = label_fn(index, self[index]) if label_fn else name(index)
            lines.append(f'  "{name(index)}" [label="{label}"];')
            if index[1] > 0 and parent(index) in self:
                lines.append(f'  "{name(parent(index))}" -> "{name(index)}";')
        lines.append("}")
        return "\n".join(lines)

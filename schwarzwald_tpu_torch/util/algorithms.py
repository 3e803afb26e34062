"""Range algorithms.

Parity: util/algorithms/Algorithm.h — stable_partition_with_jumps (:24-78,
the engine under the grid sampling strategies; the production samplers in
ops/sampling are its vectorized equivalents, this scalar version is the
semantic reference and oracle), split_range_into_chunks (:87-101, see
util.parallel), and the N-ary merge_ranges (:113-150).
"""
from __future__ import annotations

import heapq
from typing import Callable, Sequence

import numpy as np


def stable_partition_with_jumps(n: int, pred: Callable):
    """pred(cur, end) -> (selected_index, next_index); selected == next
    means nothing selected in [cur, next). Returns (selected_indices,
    unselected_indices), both in original order."""
    selected, unselected = [], []
    cur = 0
    while cur < n:
        sel, nxt = pred(cur, n)
        if nxt <= cur:
            raise RuntimeError("predicate must advance")
        if sel == nxt:
            unselected.extend(range(cur, nxt))
        else:
            unselected.extend(range(cur, sel))
            selected.append(sel)
            unselected.extend(range(sel + 1, nxt))
        cur = nxt
    return selected, unselected


def merge_ranges(ranges: Sequence[np.ndarray],
                 key: Callable | None = None) -> np.ndarray:
    """N-ary merge of sorted runs; stable across run order on ties
    (Algorithm.h:113-150 semantics: the earliest run wins ties)."""
    arrays = [np.asarray(r) for r in ranges if len(r)]
    if not arrays:
        return np.empty(0)
    if key is None:
        merged = np.concatenate(arrays)
        order = np.argsort(np.concatenate(
            [np.asarray(a, dtype=np.uint64) for a in arrays]), kind="stable")
        return merged[order]
    heap = []
    for run_idx, arr in enumerate(arrays):
        heap.append((key(arr[0]), run_idx, 0))
    heapq.heapify(heap)
    out = []
    while heap:
        _, run_idx, pos = heapq.heappop(heap)
        out.append(arrays[run_idx][pos])
        if pos + 1 < len(arrays[run_idx]):
            heapq.heappush(heap,
                           (key(arrays[run_idx][pos + 1]), run_idx, pos + 1))
    return np.array(out)

"""Host parallel primitives.

Parity: the reference's Taskflow-based helpers and hand-rolled pool
(schwarzwald/util/threading/): parallel::for_each / transform / scatter
(Parallel.h:13-224) and the promise-based TaskSystem (TaskSystem.h:14-68)
with Awaitable combinators (Async.h:8-53). On this framework's target
topology the host is a feeder core and the TPU is the parallel engine, so
these are thin concurrent.futures wrappers used for I/O-bound fan-out
(persistence writes, converter jobs, read commands).
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, Iterable, Sequence


class TaskSystem:
    """Thread pool with future-based results (TaskSystem.h:14-68)."""

    def __init__(self, num_threads: int | None = None):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=num_threads or 4)

    def push(self, fn: Callable, *args, **kwargs) -> concurrent.futures.Future:
        return self._pool.submit(fn, *args, **kwargs)

    def run(self) -> None:  # the reference starts threads lazily; no-op here
        pass

    def stop_and_join(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_and_join()
        return False


def all_of(futures: Iterable[concurrent.futures.Future]) -> list:
    """async::all combinator (Async.h): wait for all, gather results."""
    return [f.result() for f in list(futures)]


def split_range_into_chunks(num_chunks: int, n: int):
    """Equal chunks, remainder in the last (Algorithm.h:87-101).
    Returns (start, end) index pairs."""
    num_chunks = max(1, min(num_chunks, n)) if n else 1
    chunk = n // num_chunks
    out = []
    for i in range(num_chunks - 1):
        out.append((i * chunk, (i + 1) * chunk))
    out.append(((num_chunks - 1) * chunk, n))
    return out


def parallel_for_each(items: Sequence, fn: Callable,
                      num_threads: int = 4) -> None:
    """parallel::for_each (Parallel.h:38-76)."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as p:
        list(p.map(fn, items))


def parallel_transform(items: Sequence, fn: Callable,
                       num_threads: int = 4) -> list:
    """parallel::transform (Parallel.h:110-162)."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as p:
        return list(p.map(fn, items))


def parallel_scatter(n: int, fn: Callable, num_threads: int = 4) -> list:
    """parallel::scatter (Parallel.h:165-224): fn(begin, end, task_index)
    over N contiguous chunks."""
    chunks = split_range_into_chunks(num_threads, n)
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as p:
        futures = [p.submit(fn, lo, hi, i)
                   for i, (lo, hi) in enumerate(chunks)]
        return [f.result() for f in futures]


class Semaphore:
    """Counting semaphore (util/threading/Semaphore.h:5-17)."""

    def __init__(self, count: int = 0):
        self._sem = threading.Semaphore(count)

    def notify(self) -> None:
        self._sem.release()

    def wait(self) -> None:
        self._sem.acquire()

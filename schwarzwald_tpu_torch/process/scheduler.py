"""Read/index scheduling policies.

Parity: TilingScheduler (schwarzwald/core/util/Scheduler.{h,cpp}):
FixedThreadsScheduler keeps a user-fixed read/index split; AdaptiveScheduler
re-balances per iteration by solving R*tr = I*ti, R + I = total from
measured per-thread throughputs (Scheduler.cpp:121-168), with read threads
capped by the number of unfinished files.
"""
from __future__ import annotations

import dataclasses
import math

from ..util.progress import ThroughputSampler


@dataclasses.dataclass
class FixedThreadCount:
    num_threads_for_reading: int
    num_threads_for_indexing: int


@dataclasses.dataclass
class AdaptiveThreadCount:
    num_threads: int


class FixedThreadsScheduler:
    def __init__(self, read_threads: int, index_threads: int):
        self.read_threads = max(1, read_threads)
        self.index_threads = max(1, index_threads)

    def get_read_and_index_concurrency(self, remaining_files: int):
        return (max(1, min(self.read_threads, max(remaining_files, 1))),
                self.index_threads)


class AdaptiveScheduler:
    def __init__(self, num_threads: int, read_sampler: ThroughputSampler,
                 index_sampler: ThroughputSampler):
        self.total = max(2, num_threads)
        self.read_sampler = read_sampler
        self.index_sampler = index_sampler
        self.num_read_threads = max(1, self.total // 2)
        self.num_index_threads = self.total - self.num_read_threads

    def get_read_and_index_concurrency(self, remaining_files: int):
        remaining_files = max(remaining_files, 1)
        read_tp = (self.read_sampler.get_throughput_per_second()
                   / max(self.num_read_threads, 1))
        index_tp = (self.index_sampler.get_throughput_per_second()
                    / max(self.num_index_threads, 1))

        self.num_read_threads = min(self.num_read_threads, remaining_files)
        self.num_index_threads = self.total - self.num_read_threads

        if read_tp == 0 or index_tp == 0:
            return self.num_read_threads, self.num_index_threads

        exact_index = self.total / (1 + index_tp / read_tp)
        exact_read = self.total - exact_index
        max_read = min(self.total - 1, remaining_files)
        self.num_read_threads = int(min(max_read, math.ceil(exact_read)))
        self.num_read_threads = max(1, self.num_read_threads)
        self.num_index_threads = self.total - self.num_read_threads
        return self.num_read_threads, self.num_index_threads


def make_scheduler(thread_config, read_sampler, index_sampler):
    if isinstance(thread_config, FixedThreadCount):
        return FixedThreadsScheduler(thread_config.num_threads_for_reading,
                                     thread_config.num_threads_for_indexing)
    return AdaptiveScheduler(thread_config.num_threads, read_sampler,
                             index_sampler)

"""Asynchronous write-behind for per-node output files.

The tiler's final outputs are thousands of small files (585 .pnts for the
1M bench cloud); on this deployment's filesystem a single open() costs
~0.4 ms, putting ~0.5 s of pure kernel latency on the critical path of
every 1M-point run. The reference hides this behind its dozens of worker
threads (TilingAlgorithms.cpp per-node Taskflow subflows each do their own
IO); here a small IO pool does the same for the 1-thread engine: node
payloads are ENCODED synchronously into pooled recycled buffers (so the
point arrays never need to outlive the call and warm pages are reused —
first-touch faults cost ~45 MB/s on this VM), then the open/write/close
ride worker threads that overlap the engine's GIL-released native kernels.

Coherence contract:
  * submit() keys the in-flight write by the exact filesystem path;
  * wait(path) blocks until that path's write (if any) has retired —
    persistence sinks call it before reading or stat-ing a node file;
  * drain() blocks until the queue is empty — sinks call it before a
    staging commit (renames must see completed files) and at close();
  * the first worker exception is re-raised on the caller thread at the
    next submit()/wait()/drain(), so a failing disk aborts the run.
"""
from __future__ import annotations

import os
import queue
import threading


class AsyncFileWriter:
    """Fixed thread pool writing (path, buffer, nbytes) jobs; buffers are
    recycled through a free list once written."""

    def __init__(self, threads: int = 4, queue_depth: int = 16):
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._free: list[bytearray] = []
        self._pending: dict[str, int] = {}
        self._lock = threading.Lock()
        self._retired = threading.Condition(self._lock)
        self._err: BaseException | None = None
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"write-behind-{i}")
            for i in range(max(1, threads))]
        for t in self._threads:
            t.start()

    # -- buffer pool --------------------------------------------------------

    def alloc(self, size: int) -> bytearray:
        """A buffer of at least `size` bytes, recycled when possible."""
        with self._lock:
            for i, buf in enumerate(self._free):
                if len(buf) >= size:
                    return self._free.pop(i)
            if self._free:
                # grow the largest instead of faulting a fresh allocation;
                # grow geometrically (nodes arrive in mixed sizes — exact
                # fits re-extend on nearly every call, a realloc+copy each)
                largest = max(range(len(self._free)),
                              key=lambda i: len(self._free[i]))
                buf = self._free.pop(largest)
                buf.extend(bytes(max(size, 2 * len(buf)) - len(buf)))
                return buf
        return bytearray(size)

    def _recycle(self, buf: bytearray) -> None:
        with self._lock:
            if len(self._free) < 32:
                self._free.append(buf)

    # -- submission / coherence ---------------------------------------------

    def _raise_pending_error(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, path: str, buf: bytearray, nbytes: int) -> None:
        with self._retired:
            self._raise_pending_error()
            # serialize re-writes of the same path: two queued writes to
            # one file could retire in either order across workers
            while self._pending.get(path):
                self._retired.wait()
            self._pending[path] = 1
        self._q.put((path, buf, nbytes))

    def wait(self, path: str) -> None:
        with self._retired:
            while self._pending.get(path):
                self._retired.wait()
            self._raise_pending_error()

    def drain(self) -> None:
        with self._retired:
            while self._pending:
                self._retired.wait()
            self._raise_pending_error()

    def close(self) -> None:
        self.drain()
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join()

    # -- worker --------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                return
            path, buf, nbytes = job
            try:
                with open(path, "wb") as f:
                    f.write(memoryview(buf)[:nbytes])
            except BaseException as e:  # surfaced at next submit/wait/drain
                with self._lock:
                    if self._err is None:
                        self._err = e
            finally:
                with self._retired:
                    n = self._pending.get(path, 0) - 1
                    if n <= 0:
                        self._pending.pop(path, None)
                    else:
                        self._pending[path] = n
                    self._retired.notify_all()
                self._recycle(buf)


def writer_from_env(threads: int = 4) -> AsyncFileWriter | None:
    """None when SCHWARZWALD_NO_WRITE_BEHIND is set (tests force the
    synchronous path to diff outputs against it). '0'/'false'/'' follow
    the usual env convention and leave write-behind ON."""
    if os.environ.get("SCHWARZWALD_NO_WRITE_BEHIND", "").lower() \
            not in ("", "0", "false"):
        return None
    return AsyncFileWriter(threads=threads)

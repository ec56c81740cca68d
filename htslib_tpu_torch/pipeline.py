"""An ordered batch pipeline on host threads (the port's copy of
htslib_tpu/pipeline.py; reference thread_pool.c, bgzf.c:1598).

htslib threads per-block jobs through a shared worker pool with
serial-number-ordered result queues (thread_pool.c:518).  Here the
stages are batch functions (inflate a chunk of members, parse a chunk of
SAM lines) run ahead on an executor with a bounded window: results come
in submission order, and the window is the back-pressure (the in and out
queue limits of hts_tpool_process, thread_pool_internal.h:106).  The
stages run on host threads only: no device work is queued from them, so
every CUDA launch stays on the caller's thread.
"""
from __future__ import annotations

import concurrent.futures as _fut
from collections import deque
from typing import Callable, Iterator, Iterable, Optional, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_shared_pool: Optional[_fut.ThreadPoolExecutor] = None


def shared_pool(max_workers: Optional[int] = None) -> _fut.ThreadPoolExecutor:
    """One process-wide pool shared by all streams (the hts_set_thread_pool
    model, hts.c:1934)."""
    global _shared_pool
    if _shared_pool is None:
        import os
        _shared_pool = _fut.ThreadPoolExecutor(
            max_workers=max_workers or os.cpu_count() or 2)
    return _shared_pool


def pipeline_map(fn: Callable[[T], U], items: Iterable[T],
                 window: int = 4,
                 pool: Optional[_fut.ThreadPoolExecutor] = None,
                 ) -> Iterator[U]:
    """Ordered map with up-to-`window` tasks in flight (the ordered
    hts_tpool_next_result_wait drain, thread_pool.c:224)."""
    pool = pool or shared_pool()
    pending: deque = deque()
    it = iter(items)
    try:
        for item in it:
            pending.append(pool.submit(fn, item))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        for f in pending:
            f.cancel()


def chunked_bgzf_batches(path: str, blocks_per_batch: int = 256,
                         window: int = 3) -> Iterator[bytes]:
    """Stream a BGZF file as uncompressed chunks, inflating batches of
    blocks ahead of the consumer on host threads, zlib with each CRC32
    checked (the bgzf_mt_reader decode-ahead, bgzf.c:1598, as batch
    prefetch)."""
    import numpy as np

    from htslib_tpu_torch.bgzf import inflate_host, scan_blocks

    raw = np.fromfile(path, dtype=np.uint8)
    table = scan_blocks(raw)
    n = table.n
    spans = []
    for s in range(0, n, blocks_per_batch):
        e = min(s + blocks_per_batch, n)
        c0 = int(table.coffsets[s])
        c1 = (int(table.coffsets[e - 1]) + int(table.csizes[e - 1]))
        spans.append((c0, c1))

    def inflate(span):
        c0, c1 = span
        part = raw[c0:c1]
        return inflate_host(part, scan_blocks(part))

    return pipeline_map(inflate, spans, window=window)


class QueueFull(Exception):
    """Non-blocking dispatch refused: the input side is at its limit
    (hts_tpool_dispatch3's nonblock path returning EAGAIN)."""


class ProcessQueue:
    """hts_tpool_process equivalent (thread_pool.c:725-956): a
    per-stream queue attached to the shared pool with bounded input and
    output sides, non-blocking dispatch, and serial-number-ordered
    result draining.  Many queues can share one pool
    (hts_tpool_attach model).

    Semantics follow the reference worker loop (thread_pool.c:518-723):

    * jobs sit on a bounded *input* deque; blocking dispatch waits while
      the input side is at its limit (hts_tpool_dispatch3,
      thread_pool.c:878);
    * a worker gates on output room *before pulling* a job
      (``qsize - n_output > n_processing``, thread_pool.c:536) — never
      after computing it — and pulling frees input space immediately
      (``n_input--`` at thread_pool.c:599), so dispatchers unblock as
      soon as work starts, and a stored result never holds a lock the
      consumer is waiting behind;
    * once pulled, the result slot is reserved, so storage is
      unconditional.

    One deliberate extension: when the input side is full and nothing is
    processing (a producer blocked in dispatch with undrained results),
    a worker may pull one job past the output limit.  The reference has
    the same wedge and escapes it by growing qsize on the fly
    (thread_pool.c:956-960); we apply the equivalent pressure release
    eagerly so a dispatch-then-poll producer always makes progress.
    """

    def __init__(self, pool: Optional[_fut.ThreadPoolExecutor] = None,
                 in_limit: int = 8, out_limit: int = 8):
        import threading
        import time
        self._pool = pool or shared_pool()
        self._in_limit = max(1, in_limit)
        self._out_limit = max(1, out_limit)
        self._lock = threading.Condition()
        self._input: deque = deque()  # (serial, fn, args, kwargs)
        self._next_serial = 0        # next serial to assign
        self._next_out = 0           # next serial to hand to the consumer
        self._n_processing = 0       # pulled but not yet stored
        self._results: dict = {}
        self._runners = 0            # pool tasks alive for this queue
        self._shutdown = False
        # wall/wait accounting (the working form of the reference's
        # vestigial hts_tpool.total_time/wait_time,
        # thread_pool_internal.h:162): job execution time plus how long
        # each side of the queue spent blocked on the other.
        self._t0 = time.monotonic()
        self._busy_time = 0.0        # sum of job execution durations
        self._producer_wait = 0.0    # dispatch blocked on a full input
        self._consumer_wait = 0.0    # next_result blocked on results
        self._n_jobs = 0

    # -- worker side ----------------------------------------------------
    def _pullable(self) -> bool:
        # caller holds the lock
        if self._shutdown or not self._input:
            return False
        if self._n_processing + len(self._results) < self._out_limit:
            return True
        # pressure release (thread_pool.c:956 qsize bump): input full,
        # nothing in flight => the producer may be wedged in dispatch
        # with the consumer unable to run; allow one over-limit pull.
        return (self._n_processing == 0
                and len(self._input) >= self._in_limit)

    def _maybe_spawn(self) -> None:
        # caller holds the lock
        if self._pullable() and self._runners < self._in_limit:
            self._runners += 1
            self._pool.submit(self._run_loop)

    def _run_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    if not self._pullable():
                        return
                    serial, fn, args, kwargs = self._input.popleft()
                    self._n_processing += 1
                    self._lock.notify_all()   # input space freed
                import time
                t_run = time.monotonic()
                try:
                    res, err = fn(*args, **kwargs), None
                except Exception as e:        # propagated to the consumer
                    res, err = None, e
                t_run = time.monotonic() - t_run
                with self._lock:
                    self._results[serial] = (res, err)
                    self._n_processing -= 1
                    self._busy_time += t_run
                    self._n_jobs += 1
                    self._lock.notify_all()
        finally:
            with self._lock:
                self._runners -= 1
                # work may have become pullable between our last check
                # and this decrement
                self._maybe_spawn()

    # -- producer side --------------------------------------------------
    def dispatch(self, fn, *args, **kwargs) -> None:
        """Blocking dispatch: waits while the input side is full
        (hts_tpool_dispatch)."""
        import time
        with self._lock:
            while (len(self._input) >= self._in_limit
                   and not self._shutdown):
                self._maybe_spawn()
                t_w = time.monotonic()
                self._lock.wait(1.0)
                self._producer_wait += time.monotonic() - t_w
            if self._shutdown:
                raise RuntimeError("queue is shut down")
            self._input.append((self._next_serial, fn, args, kwargs))
            self._next_serial += 1
            self._maybe_spawn()

    def try_dispatch(self, fn, *args, **kwargs) -> bool:
        """Non-blocking dispatch (hts_tpool_dispatch3 nonblock):
        returns False instead of waiting when the input side is full."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("queue is shut down")
            if len(self._input) >= self._in_limit:
                self._maybe_spawn()
                return False
            self._input.append((self._next_serial, fn, args, kwargs))
            self._next_serial += 1
            self._maybe_spawn()
            return True

    # -- consumer side --------------------------------------------------
    def next_result(self, wait: bool = True):
        """The next result in dispatch order (hts_tpool_next_result
        / _wait).  Returns None when nothing is pending and wait is
        False; raises the task's exception if it failed."""
        with self._lock:
            while True:
                if self._next_out in self._results:
                    res, err = self._results.pop(self._next_out)
                    self._next_out += 1
                    self._maybe_spawn()       # output space freed
                    self._lock.notify_all()
                    if err is not None:
                        raise err
                    return res
                if not wait:
                    return None
                if (self._next_out >= self._next_serial
                        and self._n_processing == 0
                        and not self._input):
                    return None          # fully drained
                self._maybe_spawn()
                import time
                t_w = time.monotonic()
                self._lock.wait(1.0)
                self._consumer_wait += time.monotonic() - t_w

    def flush(self):
        """Drain every outstanding result in order (hts_tpool_process_
        flush + drain)."""
        out = []
        while True:
            with self._lock:
                done = (self._next_out >= self._next_serial
                        and self._n_processing == 0
                        and not self._input
                        and not self._results)
            if done:
                return out
            r = self.next_result(wait=True)
            if r is None and self._next_out >= self._next_serial:
                return out
            out.append(r)

    def stats(self) -> dict:
        """Queue accounting in seconds: wall time since creation, job
        execution time, and blocked time on each side (the usable form
        of hts_tpool's total_time/wait_time debug fields)."""
        import time
        with self._lock:
            return {
                "total_time": time.monotonic() - self._t0,
                "busy_time": self._busy_time,
                "producer_wait": self._producer_wait,
                "consumer_wait": self._consumer_wait,
                "n_jobs": self._n_jobs,
            }

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

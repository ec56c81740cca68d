"""Run a function as every rank of a torch.distributed world, one spawned
process a rank, and collect what each returns.

    results = run_ranks(fn, 4, args=(path,), backend="gloo", timeout=120)

`fn` must be importable by the spawned processes (a module-level
function); it is called as fn(rank, n, *args) after `initialize` has
joined the process to the world, which meets at a file under a temporary
directory unless a coordinator address is given.  A rank that raises
fails the whole run at once: the others are killed, and the call raises
with that rank's traceback.

The function and its arguments are pickled once into a file that each
rank loads: `Process.start` writes what it is given into a pipe that the
new process drains only as it unpickles, so arguments handed to it hold
each start until the process before has imported what they need.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch.distributed as dist


def _rank_main(call: str, rank: int, n: int, init: str, backend: str,
               out: str) -> None:
    entered = time.time()
    from htslib_tpu_torch.parallel.distributed import initialize
    try:
        with open(call, "rb") as fp:
            fn, args = pickle.load(fp)
        loaded = time.time()
        initialize(init, n, rank, backend)
        joined = time.time()
        result = fn(rank, n, *args)
        with open(f"{out}.tmp", "wb") as fp:
            pickle.dump((entered, loaded, joined, time.time(), result), fp)
        os.replace(f"{out}.tmp", out)
    except BaseException:
        with open(f"{out}.err", "w") as fp:
            fp.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, args: Sequence = (),
              backend: str = "gloo", timeout: float = 300.0,
              coordinator: Optional[str] = None,
              timing: Optional[dict] = None) -> List[Any]:
    """fn(rank, n, *args) in n processes, each rank `rank` of a world of n
    on `backend`, meeting at `coordinator` ("host:port") or, where it is
    None, at a file in a temporary directory; returns their results in
    rank order.  `timing`, where given, gets each rank's seconds on the
    host clock, lists in rank order: start_s (from the first spawn to
    the rank's entry: the interpreter and torch's import), load_s (the
    function and its arguments, with the imports they need), join_s
    (the rendezvous), run_s (fn), and the whole call's wall_s.
    Once a rank fails the others are killed, and the call raises
    RuntimeError with the traceback of every rank that raised; it raises
    TimeoutError when a rank is still running after `timeout` seconds.
    No rank process is left running either way."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init = coordinator or "file://" + os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as fp:
            pickle.dump((fn, tuple(args)), fp)
        procs = [ctx.Process(target=_rank_main, args=(
            call, r, n, init, backend, outs[r]), daemon=True)
            for r in range(n)]
        deadline = time.monotonic() + timeout
        t0 = time.time()
        try:
            for p in procs:
                p.start()
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    hung = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"ranks {hung} of {n} still running "
                                       f"after {timeout} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in running], timeout=left)
                running = [p for p in running if p.is_alive()]
                if any(p.exitcode for p in procs if not p.is_alive()):
                    break
        finally:
            for p in procs:
                if p.pid is None:
                    continue
                if p.is_alive():
                    p.kill()
                p.join()
        # a rank's failure makes its peers' collectives fail too: report
        # every rank that raised (each wrote its traceback), then the rest
        failed = [r for r, p in enumerate(procs) if p.exitcode]
        if failed:
            errs = []
            for r in failed:
                if os.path.exists(f"{outs[r]}.err"):
                    with open(f"{outs[r]}.err") as fp:
                        errs.append(f"rank {r} of {n} failed:\n{fp.read()}")
            raise RuntimeError("\n".join(errs) or f"ranks {failed} of {n} "
                               "ended without a result")
        stamps = []
        for out in outs:
            with open(out, "rb") as fp:
                stamps.append(pickle.load(fp))
    if timing is not None:
        timing.update(start_s=[e - t0 for e, _, _, _, _ in stamps],
                      load_s=[a - e for e, a, _, _, _ in stamps],
                      join_s=[j - a for _, a, j, _, _ in stamps],
                      run_s=[d - j for _, _, j, d, _ in stamps],
                      wall_s=time.time() - t0)
    return [r for *_, r in stamps]

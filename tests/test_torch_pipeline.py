"""The port's host pipeline (htslib_tpu_torch/pipeline.py) against the
JAX package's (htslib_tpu/pipeline.py): `pipeline_map`'s order and
window, `chunked_bgzf_batches` over a seeded BGZF file, and
`ProcessQueue`'s ordered results, back-pressure, non-blocking dispatch,
errors, flush and accounting, with `shared_pool` as its default pool."""
import threading
import time

import numpy as np
import pytest

from htslib_tpu import pipeline as jp
from htslib_tpu_torch import pipeline as tp
from htslib_tpu_torch.bgzf import BgzfReader, BgzfWriter


@pytest.mark.parametrize("window", [1, 3, 8])
def test_pipeline_map_order_and_window(window):
    lock = threading.Lock()
    live = {"now": 0, "most": 0}

    def work(x):
        with lock:
            live["now"] += 1
            live["most"] = max(live["most"], live["now"])
        time.sleep(0.001 * (x % 3))
        with lock:
            live["now"] -= 1
        return x * x

    got = list(tp.pipeline_map(work, range(40), window=window))
    assert got == list(jp.pipeline_map(lambda x: x * x, range(40),
                                       window=window))
    assert live["most"] <= window


def test_pipeline_map_raises_the_stage_error():
    def work(x):
        if x == 5:
            raise ValueError("stage 5")
        return x

    it = tp.pipeline_map(work, range(10), window=2)
    assert [next(it) for _ in range(5)] == list(range(5))
    with pytest.raises(ValueError, match="stage 5"):
        next(it)


@pytest.mark.parametrize("per_batch", [1, 4, 256])
def test_chunked_bgzf_batches_match_jax(tmp_path, per_batch):
    rng = np.random.default_rng(9)
    data = rng.integers(0, 4, 600_000, dtype=np.uint8).tobytes()
    p = str(tmp_path / "x.gz")
    with BgzfWriter(p, level=1) as w:
        w.write(data)
    got = list(tp.chunked_bgzf_batches(p, blocks_per_batch=per_batch))
    want = list(jp.chunked_bgzf_batches(p, blocks_per_batch=per_batch))
    assert got == want and b"".join(got) == data
    with BgzfReader(p) as r:
        assert r.read(-1) == data


def test_shared_pool_is_one_pool():
    assert tp.shared_pool() is tp.shared_pool()


def test_process_queue_order_and_stats():
    """Results in dispatch order (hts_tpool_next_result), blocked time on
    each side and the jobs' time accounted (thread_pool_internal.h:162),
    as the JAX queue gives them."""
    for mod in (tp, jp):
        q = mod.ProcessQueue(in_limit=2, out_limit=2)
        for i in range(6):
            q.dispatch(lambda x: (time.sleep(0.01 * (x % 2)), x)[1], i)
        assert [q.next_result() for _ in range(6)] == list(range(6))
        assert q.next_result(wait=False) is None
        s = q.stats()
        assert s["n_jobs"] == 6 and s["busy_time"] >= 0.025
        assert s["total_time"] >= s["busy_time"] / 8
        q.shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            q.dispatch(lambda: 0)


def test_process_queue_nonblocking_errors_and_flush():
    gate = threading.Event()
    q = tp.ProcessQueue(in_limit=1, out_limit=1)
    q.dispatch(lambda: gate.wait(5) and "first")
    accepted = [q.try_dispatch(lambda i=i: i) for i in range(4)]
    assert accepted.count(False) >= 1
    gate.set()
    q.dispatch(lambda: 1 / 0)
    q.dispatch(lambda: "after")
    got = [q.next_result()]
    while True:
        try:
            r = q.next_result()
        except ZeroDivisionError:
            got.append("error")
            continue
        if r is None:
            break
        got.append(r)
    assert got == (["first"] + [i for i, ok in zip(range(4), accepted)
                                if ok] + ["error", "after"])
    q2 = tp.ProcessQueue(in_limit=4, out_limit=4)
    for i in range(7):
        q2.dispatch(lambda x=i: x * 2)
    assert q2.flush() == [i * 2 for i in range(7)]
    assert q2.flush() == []

"""Port vs reference: the dev-mode runtime sanitizers
(ray_tpu_torch/analysis/sanitizers.py).

The ports of tests/test_static_analysis.py's sanitizer tests (the linter's
are Queue A item 5): a lock-order cycle found single-threaded and reported
once with both stacks, no false positive on a consistent order, a sanitized
condition's wait and notify, the io-loop watchdog catching a blocked loop,
the thread-affinity assert, and the counts in ``summarize_metrics()``. Then
a small cluster graph under ``RAY_TPU_SANITIZE=1`` (tests/conftest.py sets
it for the whole suite, and every daemon and worker inherits it): tasks
that get tasks, an actor, a stream and a put, with zero lock-order and
zero affinity violations in the driver and in the daemons, whose
``sanitizer_violations_total`` reaches the GCS's merged series.
"""

import os
import threading
import time

import ray_tpu_torch
from ray_tpu_torch.analysis import sanitizers as san


def test_lock_order_cycle_detected_single_threaded():
    san.enable(True)
    with san.scoped(drop_prefixes=("t.",)):
        base = san.violation_counts()
        a = san.SanitizedLock("t.A")
        b = san.SanitizedLock("t.B")
        with a:
            with b:
                pass
        assert san.violation_counts() == base
        with b:
            with a:        # inversion: closes the A->B cycle
                pass
        counts = san.violation_counts()
        assert counts.get("lock_order", 0) == base.get("lock_order", 0) + 1
        v = san.violations("lock_order")[-1]
        assert len([s for s in v["stacks"] if s]) == 2  # both stacks
        with b:
            with a:
                pass
        assert san.violation_counts().get("lock_order", 0) == \
            base.get("lock_order", 0) + 1


def test_lock_order_no_false_positive_consistent_order():
    san.enable(True)
    with san.scoped(drop_prefixes=("c.",)):
        base = san.violation_counts()
        a, b = san.SanitizedLock("c.A"), san.SanitizedLock("c.B")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert san.violation_counts() == base


def test_sanitized_condition_wait_notify():
    san.enable(True)
    with san.scoped(drop_prefixes=("t.",)):
        base = san.violation_counts()
        cond = san.make_condition("t.cond")
        hits = []

        def waiter():
            with cond:
                while not hits:
                    cond.wait(timeout=5)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.1)
        with cond:
            hits.append(1)
            cond.notify_all()
        t.join(timeout=5)
        assert not t.is_alive()
        assert san.violation_counts() == base


def test_loop_watchdog_catches_blocked_loop():
    from ray_tpu_torch.core.config import _config
    from ray_tpu_torch.core.rpc import EventLoopThread

    san.enable(True)
    old_stall = _config.sanitize_loop_stall_s
    old_ping = _config.sanitize_loop_ping_interval_s
    _config.sanitize_loop_stall_s = 0.3
    _config.sanitize_loop_ping_interval_s = 0.1
    elt = None
    try:
        with san.scoped(drop_prefixes=("watchdog-test",)):
            base = san.violation_counts().get("loop_stall", 0)
            elt = EventLoopThread(name="watchdog-test-io")

            async def block():
                # deliberately blocks the loop; longer than the reference's
                # 1.2 s: a watchdog an earlier cluster started may sleep
                # out its old 1 s ping interval before it reads the 0.1 s
                time.sleep(2.5)

            elt.spawn(block())
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if san.violation_counts().get("loop_stall", 0) > base:
                    break
                time.sleep(0.05)
            assert san.violation_counts().get("loop_stall", 0) > base, \
                "watchdog missed a 2.5s loop block"
            v = san.violations("loop_stall")[-1]
            assert "heartbeat" in v["detail"]
    finally:
        _config.sanitize_loop_stall_s = old_stall
        _config.sanitize_loop_ping_interval_s = old_ping
        if elt is not None:
            elt.stop()


def test_thread_affinity_assert():
    san.enable(True)
    with san.scoped(drop_prefixes=("t.",)):
        base = san.violation_counts()
        san.assert_thread_affinity("t.struct", threading.get_ident())
        assert san.violation_counts() == base
        san.assert_thread_affinity("t.struct", threading.get_ident() + 1)
        assert san.violation_counts().get("affinity", 0) == \
            base.get("affinity", 0) + 1


def test_sanitizer_counts_in_summarize_metrics():
    from ray_tpu_torch.util import state

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    try:
        san.enable(True)
        with san.scoped(drop_prefixes=("test",)):
            san.record_violation("loop_stall", "test", "fixture violation")
            m = state.summarize_metrics()
            assert m["sanitizer_violations"].get("loop_stall", 0) >= 1
    finally:
        ray_tpu_torch.shutdown()


def test_a_sanitized_cluster_graph_has_no_lock_order_or_affinity_violation():
    from ray_tpu_torch.core.config import _config
    from ray_tpu_torch.util import state

    assert os.environ.get("RAY_TPU_SANITIZE") == "1" and san.enabled()
    ray_tpu_torch.shutdown()
    saved = _config.metrics_report_interval_ms
    os.environ["RAY_TPU_METRICS_REPORT_INTERVAL_MS"] = "300"
    _config.metrics_report_interval_ms = 300
    before = san.violation_counts()
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0)
        rt = ray_tpu_torch

        @rt.remote
        def leaf(i):
            return i + 1

        @rt.remote
        def mid(i):
            return sum(rt.get([leaf.remote(i), leaf.remote(-i)], timeout=60))

        @rt.remote
        def stream(n):
            for i in range(n):
                yield i

        @rt.remote
        class Acc:
            def __init__(self):
                self.total = 0

            def add(self, x):
                self.total += x
                return self.total

        assert rt.get([mid.remote(i) for i in range(8)], timeout=60) == [2] * 8
        acc = Acc.remote()
        assert rt.get([acc.add.remote(i) for i in range(4)],
                      timeout=60) == [0, 1, 3, 6]
        gen = stream.options(num_returns="streaming").remote(5)
        assert [rt.get(r, timeout=60) for r in gen] == list(range(5))
        assert rt.get(rt.put(list(range(100))), timeout=60) == list(range(100))

        after = san.violation_counts()
        for kind in ("lock_order", "affinity"):
            assert after.get(kind, 0) == before.get(kind, 0), san.report()
        # the daemons' and workers' counts ride their metrics flush; wait
        # for a few flush periods with the workers' series present
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            names = {s["name"] for s in state._gcs_call("collect_metrics")}
            if "raylet_workers" in names and "rpc_frames_sent" in names:
                break
            time.sleep(0.3)
        time.sleep(1.0)

        def by_kind(series_list):
            vio = next((s for s in series_list
                        if s["name"] == "sanitizer_violations_total"), None)
            return {dict(k).get("kind"): v
                    for k, v in (vio["points"].items() if vio else ())}

        # the merge holds this driver's own counter too, which the tests
        # above tripped on purpose: what the daemons and workers add is the
        # merge less the driver's registry
        from ray_tpu_torch.util.metrics import get_registry

        merged = by_kind(state._gcs_call("collect_metrics"))
        mine = by_kind(get_registry().collect())
        daemons = {k: merged.get(k, 0) - mine.get(k, 0) for k in merged}
        assert not daemons.get("lock_order") and not daemons.get("affinity"), (
            merged, mine)
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_METRICS_REPORT_INTERVAL_MS", None)
        _config.metrics_report_interval_ms = saved

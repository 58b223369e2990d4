"""Port vs reference: pipelined submission with work stealing and the
requeue bound (ray_tpu_torch/core/core_worker.py, worker_main.py).

The port's copies of tests/test_work_stealing.py's two tests, then what the
reference's tests leave implicit: twenty tasks on a one-CPU cluster ride
one lease with more than one spec in flight and never more than
``worker_max_tasks_in_flight``; with stealing off a spec stuck behind a
blocked worker bounces back after ``worker_requeue_after_ms`` and runs on
the idle one; and a graph of tasks that get tasks (pipelined specs hand the
run slot on while they block) gives the reference's results.

A worker reads ``worker_requeue_after_ms`` from the environment it starts
with, so each cluster here is started with its own value; the owner's
``worker_stealing_enabled`` and ``worker_max_tasks_in_flight`` are the
driver's config. Every cluster get has a timeout.
"""

import contextlib
import os
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.core.config import _config


@contextlib.contextmanager
def _cluster(num_cpus, requeue_ms):
    saved_env = os.environ.get("RAY_TPU_WORKER_REQUEUE_AFTER_MS")
    saved_cfg = _config.worker_requeue_after_ms
    os.environ["RAY_TPU_WORKER_REQUEUE_AFTER_MS"] = str(requeue_ms)
    _config.worker_requeue_after_ms = requeue_ms
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=num_cpus, num_gpus=0)
    try:
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()
        if saved_env is None:
            os.environ.pop("RAY_TPU_WORKER_REQUEUE_AFTER_MS", None)
        else:
            os.environ["RAY_TPU_WORKER_REQUEUE_AFTER_MS"] = saved_env
        _config.worker_requeue_after_ms = saved_cfg


@contextlib.contextmanager
def _driver_config(**fields):
    saved = {k: getattr(_config, k) for k in fields}
    for k, v in fields.items():
        setattr(_config, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(_config, k, v)


def _lease_stats():
    return dict(ray_tpu_torch.api._global_worker().backend.core.lease_stats)


# the fallback requeue timer is pinned HIGH so only stealing can rescue the
# queued specs — the first test's bound would fail on the timer alone
@pytest.fixture(scope="module")
def stealing_cluster():
    with _cluster(2, 5000) as rt:
        yield rt


def test_spec_queued_behind_blocked_worker_migrates(stealing_cluster):
    """A spec committed to a busy worker completes on an idle one within
    bounded time: far sooner than the blocker finishes (2s) and far sooner
    than the requeue fallback (pinned at 5s)."""
    rt = stealing_cluster

    @rt.remote
    def blocker():
        time.sleep(2.0)  # out-of-band block: holds the run slot throughout
        return "blocked"

    @rt.remote
    def quick(i):
        return i

    # warm the 2-worker pool so placement (not process spawn) is measured
    assert rt.get([quick.remote(i) for i in range(8)], timeout=60) == list(range(8))

    before = _lease_stats()
    b = blocker.remote()
    time.sleep(0.1)  # the blocker takes its run slot
    t0 = time.perf_counter()
    # breadth-first placement stacks roughly half of these behind the
    # blocker; stealing migrates them to the idle worker
    out = rt.get([quick.remote(i) for i in range(12)], timeout=30)
    dt = time.perf_counter() - t0
    assert out == list(range(12))
    assert dt < 1.5, (
        f"quick tasks took {dt:.2f}s — queued specs were NOT stolen off "
        "the blocked worker (blocker=2s, requeue fallback=5s)"
    )
    assert _lease_stats()["stolen"] > before["stolen"]
    assert rt.get(b, timeout=30) == "blocked"


def test_stealing_disabled_falls_back_to_requeue_timer(stealing_cluster):
    """With stealing off, the same shape stalls until the blocker ends or
    the requeue timer fires — the contrast that proves the steal (not
    placement luck) rescued the queued specs above."""
    rt = stealing_cluster
    with _driver_config(worker_stealing_enabled=False):
        @rt.remote
        def blocker():
            time.sleep(1.2)
            return "blocked"

        @rt.remote
        def quick(i):
            return i

        rt.get([quick.remote(i) for i in range(8)], timeout=60)
        before = _lease_stats()
        b = blocker.remote()
        time.sleep(0.1)
        t0 = time.perf_counter()
        out = rt.get([quick.remote(i) for i in range(12)], timeout=30)
        dt = time.perf_counter() - t0
        assert out == list(range(12))
        # the queued half waits out the blocker (requeue pinned at 5s)
        assert dt > 0.6, (
            f"drain took only {dt:.2f}s with stealing OFF — the test no "
            "longer queues specs behind the blocker, fix the shape"
        )
        assert _lease_stats()["stolen"] == before["stolen"]
        assert rt.get(b, timeout=30) == "blocked"


def _graph(remote, get):
    """Tasks that get tasks: each mid task blocks in get on three leaves,
    so pipelined specs behind it must be handed the run slot."""

    @remote
    def leaf(i):
        return i * i + 1

    @remote
    def mid(i):
        return sum(get([leaf.remote(3 * i + j) for j in range(3)], timeout=60))

    @remote
    def root(n):
        return get([mid.remote(i) for i in range(n)], timeout=60)

    return get(root.remote(8), timeout=120)


def test_a_task_graph_gives_the_references_results(stealing_cluster):
    rt = stealing_cluster
    got = _graph(rt.remote, rt.get)
    ray_tpu.shutdown()
    ray_tpu.init(local_mode=True)
    try:
        want = _graph(ray_tpu.remote, ray_tpu.get)
    finally:
        ray_tpu.shutdown()
    assert got == want
    assert got == [sum((3 * i + j) ** 2 + 1 for j in range(3)) for i in range(8)]


def test_twenty_tasks_on_one_cpu_ride_one_lease():
    """One CPU: every task shares the one leased worker. The owner keeps
    more than one spec in flight on it (pipelining), never more than the
    configured depth."""
    depth = 4
    with _cluster(1, 5000) as rt, _driver_config(
            worker_max_tasks_in_flight=depth):
        @rt.remote
        def tagged(i):
            time.sleep(0.02)
            return i, os.getpid()

        rt.get(tagged.remote(-1), timeout=60)  # the worker is up
        out = rt.get([tagged.remote(i) for i in range(20)], timeout=60)
        assert [i for i, _ in out] == list(range(20))
        assert len({pid for _, pid in out}) == 1
        peak = _lease_stats()["max_inflight"]
        assert 2 <= peak <= depth, peak


def test_requeue_bound_moves_a_spec_when_stealing_is_off():
    """Stealing off: a spec queued behind a blocked worker bounces back
    once it has waited worker_requeue_after_ms and runs on the idle
    worker, long before the blocker ends."""
    with _cluster(2, 300) as rt, _driver_config(worker_stealing_enabled=False):
        @rt.remote
        def blocker():
            time.sleep(3.0)
            return "blocked"

        @rt.remote
        def quick(i):
            return i

        rt.get([quick.remote(i) for i in range(8)], timeout=60)
        before = _lease_stats()
        b = blocker.remote()
        time.sleep(0.1)
        t0 = time.perf_counter()
        out = rt.get([quick.remote(i) for i in range(12)], timeout=30)
        dt = time.perf_counter() - t0
        after = _lease_stats()
        assert out == list(range(12))
        assert after["requeued"] > before["requeued"]
        assert after["stolen"] == before["stolen"]
        assert dt < 2.5, f"requeued specs took {dt:.2f}s (blocker 3s)"
        assert rt.get(b, timeout=30) == "blocked"

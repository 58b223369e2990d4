"""Port vs reference: task events, the timeline, trace and deadline
propagation (ray_tpu_torch/tracing/, the backends' task events, the GCS
aggregator, the raylet's WAL recovery).

The pure parts are held equal to ``ray_tpu.tracing`` on the same seeded
inputs: the Chrome trace of one event list, deterministic sampling of 1,000
ids, the buffer's bound and drop count, the aggregator's per-task cap, and
an event WAL written by either package and read by the other. One graph
(nested tasks, an actor, a failing task) gives the same per-task state
sequences and the same ``summarize_tasks()`` in both packages' local modes.
On the port's cluster: the lifecycle of one task seen by owner, raylet and
worker; deadline shedding and ``remaining_time_s`` (tests/test_overload.py
without serve); and a SIGKILLed worker's unflushed events recovered from its
WAL (tests/test_slo_observability.py, with ``os.kill`` in the place of the
chaos plane). Every cluster get has a timeout.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import tracing as ref_tracing
from ray_tpu_torch import tracing as port_tracing

REQUIRED_TRACE_KEYS = {"pid", "tid", "ts", "ph", "name"}


def _seeded_events(seed=0, n_tasks=12):
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    events = []
    for t in range(n_tasks):
        tid = f"{t:032x}"
        node = f"n{rng.integers(0, 3)}"
        owner, worker = f"w{rng.integers(0, 2)}", f"w{rng.integers(2, 6)}"
        ts = t0 + float(rng.uniform(0, 10))
        last = "FAILED" if rng.random() < 0.25 else "FINISHED"
        for state, who in (("SUBMITTED", owner), ("LEASED", "raylet"),
                           ("DISPATCHED", owner), ("RUNNING", worker),
                           ("EXECUTED", worker), (last, owner)):
            ts += float(rng.uniform(1e-4, 0.05))
            events.append({"task_id": tid, "name": f"f{t % 3}",
                           "state": state, "ts": ts, "attempt": 0,
                           "node_id": node, "worker": who,
                           "trace_id": f"{t % 4:032x}"})
        events.append({"task_id": tid, "name": "span", "state": "PROFILE",
                       "ts": ts - 0.01, "dur": float(rng.uniform(1e-4, 5e-3)),
                       "node_id": node, "worker": worker})
    events.append({"task_id": None, "name": "free-span", "state": "PROFILE",
                   "ts": t0 + 1.0, "node_id": "n0", "worker": "w0"})
    rng.shuffle(events)
    return events


# ---------------------------------------------------------------- unit level
def test_chrome_trace_equals_the_references():
    events = _seeded_events()
    got = port_tracing.build_chrome_trace([dict(e) for e in events])
    want = ref_tracing.build_chrome_trace([dict(e) for e in events])
    assert got == want
    assert all(REQUIRED_TRACE_KEYS <= set(e) for e in got)
    assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_sampling_keeps_and_drops_the_references_ids(rate):
    from ray_tpu.core.config import _config as ref_cfg
    from ray_tpu.tracing import events as ref_events
    from ray_tpu_torch.core.config import _config as port_cfg
    from ray_tpu_torch.tracing import events as port_events

    rng = np.random.default_rng(1234)
    ids = ["".join(f"{b:02x}" for b in rng.integers(0, 256, 16))
           for _ in range(1000)]
    saved = (ref_cfg.task_events_sample_rate, port_cfg.task_events_sample_rate)
    ref_cfg.task_events_sample_rate = port_cfg.task_events_sample_rate = rate
    try:
        got = [port_events._sampled(i, None) for i in ids]
        want = [ref_events._sampled(i, None) for i in ids]
        by_task = [port_events._sampled(None, i) for i in ids]
    finally:
        ref_cfg.task_events_sample_rate, port_cfg.task_events_sample_rate = saved
    assert got == want == by_task
    assert 0 < sum(got) < len(ids)
    assert abs(sum(got) / len(ids) - rate) < 0.05


def test_buffer_bound_and_drop_count_equal_the_references():
    def run(tracing):
        buf = tracing.TaskEventBuffer(capacity=100)
        kept = [buf.record(task_id=f"{i:032x}", name="t", state="SUBMITTED")
                for i in range(150)]
        size, dropped_before = len(buf), buf.dropped
        events, dropped = buf.drain()
        ts = [e.pop("ts") for e in events]
        assert ts == sorted(ts) and len(set(ts)) == len(ts)
        return kept, size, dropped_before, events, dropped, len(buf)

    got, want = run(port_tracing), run(ref_tracing)
    assert got == want
    assert got[1:3] == (100, 50) and got[4] == 50


def test_aggregator_cap_never_drops_terminal_states():
    """A span-heavy task must not overflow its record into a phantom
    RUNNING: the per-task cap truncates PROFILE spans only, in both."""
    events = [{"task_id": "t", "name": "f", "state": "SUBMITTED", "ts": 1.0}]
    events += [{"task_id": "t", "name": "s", "state": "PROFILE",
                "ts": 1.0 + i * 1e-3} for i in range(20)]
    events += [{"task_id": "t", "name": "f", "state": "RUNNING", "ts": 2.0},
               {"task_id": "t", "name": "f", "state": "FINISHED", "ts": 3.0}]
    out = []
    for tracing in (port_tracing, ref_tracing):
        agg = tracing.TaskEventAggregator(max_tasks=10, max_events_per_task=5)
        agg.ingest([dict(e) for e in events])
        t = agg.get_task("t")
        assert t["state"] == "FINISHED"
        assert sum(1 for e in t["events"] if e["state"] == "PROFILE") == 5
        assert agg.truncated_events == 15
        out.append((t, agg.summarize(), agg.stats()))
    assert out[0] == out[1]


@pytest.mark.parametrize("writer,reader", [
    (ref_tracing, port_tracing), (port_tracing, ref_tracing)])
def test_event_wal_reads_back_in_the_other_package(tmp_path, writer, reader):
    wal = str(tmp_path / "wal.jsonl")
    buf = writer.TaskEventBuffer(capacity=100)
    assert buf.enable_wal(wal)
    for i in range(5):
        buf.record(task_id=f"{i:032x}", name="t", state="RUNNING",
                   args={"i": i})
    buf.record_profile("span", dur=0.25)
    with open(wal, "ab") as f:   # a torn final line, as a SIGKILL leaves
        f.write(b'{"task_id": "fff')
    events = reader.read_wal(wal)
    assert events == writer.read_wal(wal)
    assert [e["state"] for e in events] == ["RUNNING"] * 5 + ["PROFILE"]
    assert [e.get("args") for e in events[:5]] == [{"i": i} for i in range(5)]
    # the bounded tail read of the shipping plane agrees too
    assert reader.read_wal(wal, max_bytes=200) == writer.read_wal(
        wal, max_bytes=200)


# --------------------------------------------------------------- local mode
def _local_graph(rt):
    """Nested tasks, an actor and a failing task; returns the per-task
    state sequences by name and summarize_tasks()."""
    from importlib import import_module

    state = import_module(f"{rt.__name__}.util.state")

    @rt.remote
    def child(x):
        with rt.profile_span("child-work"):
            return x * 2

    @rt.remote
    def parent(n):
        return sum(rt.get([child.remote(i) for i in range(n)]))

    @rt.remote
    def broken():
        raise ValueError("boom")

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

    assert rt.get(parent.remote(3)) == 6
    c = Counter.remote()
    assert rt.get([c.add.remote(1), c.add.remote(2)]) == [1, 3]
    with pytest.raises(Exception):
        rt.get(broken.remote())
    time.sleep(0.05)
    seqs = sorted(
        (row["name"], tuple(
            e["state"] for e in state.get_task(row["task_id"])["events"]
            if e["state"] != "PROFILE"))
        for row in state.list_tasks()
    )
    spans = sorted(
        (row["name"], sum(
            1 for e in state.get_task(row["task_id"])["events"]
            if e["state"] == "PROFILE"))
        for row in state.list_tasks()
    )
    return seqs, spans, state.summarize_tasks()


def test_local_graph_state_sequences_equal_the_references():
    out = []
    for rt, tracing in ((ray_tpu_torch, port_tracing), (ray_tpu, ref_tracing)):
        rt.shutdown()
        rt.init(local_mode=True)
        tracing.get_buffer().drain()  # events of earlier clusters
        try:
            out.append(_local_graph(rt))
        finally:
            rt.shutdown()
    assert out[0] == out[1]
    seqs, _, summary = out[0]
    assert ("child", ("SUBMITTED", "RUNNING", "FINISHED")) in seqs
    assert ("broken", ("SUBMITTED", "RUNNING", "FAILED")) in seqs
    assert summary["tasks"]["child"] == {"FINISHED": 3}
    assert summary["tasks"]["broken"] == {"FAILED": 1}


def test_local_deadline_shed_and_remaining_time():
    """An expired deadline sheds a task and an actor call typed before user
    code runs; remaining_time_s is visible inside a task — in both
    packages' local modes."""
    for rt in (ray_tpu_torch, ray_tpu):
        rt.shutdown()
        rt.init(local_mode=True)
        try:
            ran = []

            @rt.remote
            def f(x):
                ran.append(x)
                return x

            @rt.remote
            class A:
                def m(self, x):
                    ran.append(x)
                    return x

            @rt.remote
            def budget():
                return rt.remaining_time_s()

            a = A.remote()
            with rt.tracing.deadline_context(time.time() - 0.1):
                r1, r2 = f.remote(1), a.m.remote(2)
            for r in (r1, r2):
                with pytest.raises(rt.exceptions.DeadlineExceededError):
                    rt.get(r, timeout=10)
            assert ran == []
            assert rt.get(budget.remote(), timeout=10) is None
            with rt.tracing.deadline_context(time.time() + 30):
                left = rt.get(budget.remote(), timeout=10)
            assert left is not None and 0 < left <= 30
        finally:
            rt.shutdown()


# -------------------------------------------------------------- cluster mode
@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _wait_task(task_id, pred, timeout=20.0):
    from ray_tpu_torch.util import state

    deadline = time.monotonic() + timeout
    t = None
    while time.monotonic() < deadline:
        t = state.get_task(task_id)
        if t is not None and pred(t):
            return t
        time.sleep(0.25)
    return t


def test_cluster_full_lifecycle_events(cluster):
    rt = cluster

    @rt.remote
    def work():
        with rt.profile_span("work-span"):
            return 1

    ref = work.remote()
    assert rt.get(ref, timeout=60) == 1
    # owner, raylet and worker flush on independent ~1 s loops
    t = _wait_task(ref.task_id.hex(), lambda t: {
        "SUBMITTED", "DISPATCHED", "RUNNING", "EXECUTED", "FINISHED"}
        <= {e["state"] for e in t["events"]})
    states = {e["state"] for e in t["events"]}
    assert {"SUBMITTED", "DISPATCHED", "RUNNING", "EXECUTED",
            "FINISHED"} <= states, states
    assert t["state"] == "FINISHED"
    workers = {e["worker"] for e in t["events"] if e.get("worker")}
    assert len(workers) >= 2  # driver + executing worker
    trace = rt.timeline()
    assert all(REQUIRED_TRACE_KEYS <= set(e) for e in trace)
    run = next(e for e in trace if e["name"] == "work" and e["ph"] == "X")
    span = next(e for e in trace if e["name"] == "work-span")
    # the span lies inside its task's RUNNING slice, on the same row
    assert (span["pid"], span["tid"]) == (run["pid"], run["tid"])
    assert run["ts"] <= span["ts"] and (
        span["ts"] + span["dur"] <= run["ts"] + run["dur"])


def test_cluster_deadline_shed_and_remaining_time(cluster, tmp_path):
    rt = cluster

    @rt.remote
    def f(path):
        with open(path, "a") as fh:
            fh.write("ran\n")
        return 1

    @rt.remote
    def budget():
        return rt.remaining_time_s()

    @rt.remote
    def nested_budget():
        return rt.get(budget.remote(), timeout=30)

    path = str(tmp_path / "ran")
    with rt.tracing.deadline_context(time.time() - 0.1):
        ref = f.remote(path)
    with pytest.raises(rt.exceptions.DeadlineExceededError):
        rt.get(ref, timeout=30)
    assert not os.path.exists(path)
    assert rt.get(budget.remote(), timeout=30) is None
    with rt.tracing.deadline_context(time.time() + 30):
        left = rt.get(budget.remote(), timeout=30)
        nested = rt.get(nested_budget.remote(), timeout=30)
    assert left is not None and 0 < left <= 30
    # a nested task inherits its parent's deadline
    assert nested is not None and 0 < nested <= 30
    t = _wait_task(ref.task_id.hex(), lambda t: t["state"] == "FAILED")
    assert t["state"] == "FAILED"


def test_sigkilled_worker_events_are_recovered_from_its_wal():
    """A SIGKILLed worker's unflushed events are recovered from its WAL by
    the raylet: the killed call's worker-side RUNNING and the previous
    call's profile span reach the aggregator, and the timeline ends
    FAILED."""
    rt = ray_tpu_torch
    from ray_tpu_torch.util import state

    rt.shutdown()
    # workers flush every 60 s: every worker-side event of this test stays
    # unflushed and only the WAL can deliver it. The driver keeps its 1 s
    # flush (its config was read before the variable was set).
    os.environ["RAY_TPU_TASK_EVENTS_FLUSH_INTERVAL_MS"] = "60000"
    try:
        rt.init(num_cpus=2, num_gpus=0)
        try:
            @rt.remote(max_restarts=0)
            class Victim:
                def work(self, die):
                    with rt.profile_span("last-breath"):
                        pass
                    if die:
                        os.kill(os.getpid(), signal.SIGKILL)
                    return 1

            v = Victim.remote()
            assert rt.get(v.work.remote(False), timeout=60) == 1
            dead_ref = v.work.remote(True)
            with pytest.raises(rt.exceptions.RayTpuError):
                rt.get(dead_ref, timeout=60)
            t = _wait_task(
                dead_ref.task_id.hex(),
                lambda t: t["state"] == "FAILED" and "RUNNING" in [
                    e["state"] for e in t["events"]],
                timeout=30)
            states = [e["state"] for e in (t or {}).get("events", [])]
            assert t is not None and t["state"] == "FAILED", states
            assert "RUNNING" in states, (
                f"worker-side RUNNING not recovered from the WAL: {states}")
            lifecycle = [s for s in states if s != "PROFILE"]
            assert lifecycle[-1] == "FAILED", lifecycle
            spans = [e for e in state.timeline_events()
                     if e.get("state") == "PROFILE"
                     and e.get("name") == "last-breath"]
            assert len(spans) >= 2, "the WAL's profile spans never surfaced"
        finally:
            rt.shutdown()
    finally:
        os.environ.pop("RAY_TPU_TASK_EVENTS_FLUSH_INTERVAL_MS", None)

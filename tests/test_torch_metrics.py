"""Port vs reference: the metrics plane (ray_tpu_torch/util/metrics.py, the
workers' and the raylet's flush, the GCS merge and time series, util.state).

The ports of tests/test_observability.py's four tests (the cluster one reads
the GCS's merged series through ``render_prometheus``, the dashboard not
being ported) and of tests/test_slo_observability.py's tests that need
neither serve nor the dashboard; then ``render_prometheus``,
``merge_snapshots``, ``counter_rate``, ``window_percentile`` and
``sketch_percentile`` held equal to ``ray_tpu.util.metrics`` on seeded
samples. Series names here are this file's own: every process keeps one
registry per package.
"""

import random
import re
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu.util import metrics as ref_m
from ray_tpu_torch.util import metrics as port_m
from ray_tpu_torch.util.metrics import (
    Counter,
    Gauge,
    Histogram,
    get_registry,
    merge_snapshots,
    render_prometheus,
)


# --------------------------------------------------------------- unit level
def test_counter_gauge_histogram_collect():
    c = Counter("pt_requests", description="req", tag_keys=("route",))
    c.inc(2.0, tags={"route": "/a"})
    c.inc(1.0, tags={"route": "/a"})
    c.inc(5.0, tags={"route": "/b"})
    g = Gauge("pt_qsize")
    g.set(3)
    g.set(7)
    h = Histogram("pt_latency", boundaries=[1, 10])
    h.observe(0.5)
    h.observe(5)
    h.observe(50)

    snaps = {s["name"]: s for s in get_registry().collect()}
    assert snaps["pt_requests"]["points"][(("route", "/a"),)] == 3.0
    assert snaps["pt_requests"]["points"][(("route", "/b"),)] == 5.0
    assert snaps["pt_qsize"]["points"][()] == 7.0
    hp = snaps["pt_latency"]["points"][()]
    assert hp[:3] == [1, 1, 1] and hp[-2] == 55.5 and hp[-1] == 3


def test_counter_rejects_negative_and_undeclared_tags():
    c = Counter("pt_neg", tag_keys=("k",))
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        c.inc(1, tags={"other": "x"})
    with pytest.raises(ValueError):
        Gauge("pt_neg")  # name already registered as counter


def test_merge_and_render():
    now = time.time()
    mk = lambda kind, pts, **kw: {
        "name": "m", "kind": kind, "description": "d",
        "boundaries": kw.get("boundaries", []), "points": pts,
    }
    # counters sum across sources; gauges get a source label
    merged = merge_snapshots({
        "w1": (now, [mk("counter", {(): 2.0})]),
        "w2": (now, [mk("counter", {(): 3.0})]),
        "stale": (now - 1e6, [mk("counter", {(): 100.0})]),
    })
    assert merged[0]["points"][()] == 5.0
    merged_g = merge_snapshots({
        "w1": (now, [mk("gauge", {(): 1.0})]),
        "w2": (now, [mk("gauge", {(): 2.0})]),
    })
    assert len(merged_g[0]["points"]) == 2

    text = render_prometheus([
        {"name": "app_lat", "kind": "histogram", "description": "lat",
         "boundaries": [1, 10], "points": {(): [1, 2, 3, 55.5, 6]}},
        {"name": "app_req", "kind": "counter", "description": "",
         "points": {(("route", "/a"),): 3.0}, "boundaries": []},
    ])
    assert '# TYPE app_lat histogram' in text
    assert 'app_lat_bucket{le="1"} 1' in text
    assert 'app_lat_bucket{le="10"} 3' in text
    assert 'app_lat_bucket{le="+Inf"} 6' in text
    assert 'app_lat_sum 55.5' in text and 'app_lat_count 6' in text
    assert 'app_req{route="/a"} 3.0' in text


def _lint_prometheus(text: str) -> None:
    """Mini exposition-format lint: every histogram's buckets must be
    cumulative and non-decreasing in file order, the +Inf bucket must equal
    _count for the same tag set, and no raw (unescaped) newline may appear
    inside a label value (a quote-parity scan per line)."""
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        assert line.count('"') % 2 == 0, f"unbalanced quotes: {line!r}"
    buckets = {}
    counts = {}
    for line in text.splitlines():
        m = re.match(r"^(\w+)_bucket\{(.*)\}\s+(\S+)$", line)
        if m:
            name, tags, val = m.groups()
            le = re.search(r'le="([^"]*)"', tags).group(1)
            rest = re.sub(r',?le="[^"]*"', "", tags)
            buckets.setdefault((name, rest), []).append((le, float(val)))
            continue
        m = re.match(r"^(\w+)_count(?:\{(.*)\})?\s+(\S+)$", line)
        if m:
            name, tags, val = m.groups()
            counts[(name, tags or "")] = float(val)
    assert buckets, "no histogram buckets in exposition"
    for (name, tags), rows in buckets.items():
        vals = [v for _, v in rows]
        assert vals == sorted(vals), f"{name}{{{tags}}} not cumulative: {rows}"
        assert rows[-1][0] == "+Inf", f"{name}{{{tags}}} missing +Inf"
        assert rows[-1][1] == counts[(name, tags)]


def test_prometheus_tag_value_escaping():
    text = render_prometheus([
        {"name": "esc_total", "kind": "counter", "description": 'a\\b "c"\nd',
         "boundaries": [],
         "points": {(("route", 'x\\y"z"\nw'),): 2.0}},
    ])
    assert r'route="x\\y\"z\"\nw"' in text
    assert "# HELP esc_total a\\\\b \"c\"\\nd" in text
    for line in text.splitlines():
        assert line.count('"') % 2 == 0


def test_prometheus_histogram_exposition_lint():
    text = render_prometheus([
        {"name": "lat_ms", "kind": "histogram", "description": "lat",
         "boundaries": [1, 10],
         "points": {
             (("deployment", "A"),): [3, 2, 1, 25.0, 6],
             (("deployment", "B"),): [0, 0, 4, 400.0, 4],
         }},
    ])
    _lint_prometheus(text)
    assert 'lat_ms_bucket{deployment="A",le="+Inf"} 6' in text


def test_timeseries_ring_bounds_and_query():
    ts = port_m.MetricsTimeSeries(depth=5)
    for i in range(12):
        ts.sample(
            [{"name": "c", "kind": "counter", "description": "",
              "boundaries": [], "points": {(): float(i)}},
             {"name": "other", "kind": "gauge", "description": "",
              "boundaries": [], "points": {(): 1.0}}],
            ts=float(i),
        )
    assert len(ts) == 5  # bounded: oldest evicted
    samples = ts.query()
    assert [s["ts"] for s in samples] == [7.0, 8.0, 9.0, 10.0, 11.0]
    filtered = ts.query(names=["c"], limit=2)
    assert len(filtered) == 2
    assert all(len(s["series"]) == 1 and s["series"][0]["name"] == "c"
               for s in filtered)


def test_rate_and_percentile_helpers():
    from ray_tpu_torch.util.metrics import (
        counter_rate,
        histogram_percentile,
        window_percentile,
    )

    mk = lambda t, v: {
        "ts": t,
        "series": [{"name": "c", "kind": "counter", "description": "",
                    "boundaries": [], "points": {(): v}}],
    }
    assert counter_rate([mk(0, 0.0), mk(10, 50.0)], "c") == 5.0
    # counter reset (process restart) clamps to 0, never negative
    assert counter_rate([mk(0, 100.0), mk(10, 20.0)], "c") == 0.0
    assert counter_rate([mk(0, 1.0)], "c") is None  # one sample: no rate

    assert histogram_percentile([10, 100], [10, 0, 0], 0.5) == 5.0
    assert histogram_percentile([10, 100], [0, 10, 0], 1.0) == 100.0
    assert histogram_percentile([10, 100], [0, 0, 0], 0.5) is None

    h = lambda t, pts: {
        "ts": t,
        "series": [{"name": "h", "kind": "histogram", "description": "",
                    "boundaries": [10, 100], "points": {(): pts}}],
    }
    samples = [h(0, [100, 0, 0, 100.0, 100]),
               h(10, [100, 50, 0, 3000.0, 150])]
    p = window_percentile(samples, "h", 0.5)
    assert p is not None and p > 10

    tagged = [{
        "ts": 0.0,
        "series": [{"name": "c", "kind": "counter", "description": "",
                    "boundaries": [],
                    "points": {(("deployment", "A"),): 1.0,
                               (("deployment", "B"),): 100.0}}],
    }, {
        "ts": 1.0,
        "series": [{"name": "c", "kind": "counter", "description": "",
                    "boundaries": [],
                    "points": {(("deployment", "A"),): 3.0,
                               (("deployment", "B"),): 100.0}}],
    }]
    assert counter_rate(tagged, "c", {"deployment": "A"}) == 2.0


def test_aggregator_per_job_retention():
    from ray_tpu_torch.tracing import TaskEventAggregator

    agg = TaskEventAggregator(max_tasks=1000, max_tasks_per_job=5)
    for i in range(20):
        agg.ingest([{"task_id": f"noisy-{i}", "name": "spam",
                     "state": "FINISHED", "ts": float(i), "job_id": "j1"}])
    for i in range(3):
        agg.ingest([{"task_id": f"quiet-{i}", "name": "rare",
                     "state": "FINISHED", "ts": 100.0 + i, "job_id": "j2"}])
    summary = agg.summarize()
    assert summary["tasks"]["spam"]["FINISHED"] == 5      # capped per job
    assert summary["tasks"]["rare"]["FINISHED"] == 3      # untouched
    assert summary["evicted_per_job"]["j1"] == 15
    assert agg.get_task("noisy-0") is None
    assert agg.get_task("noisy-19") is not None
    assert agg.get_task("quiet-0") is not None
    agg.ingest([{"task_id": "nojob", "name": "x", "state": "FINISHED",
                 "ts": 1.0}])
    assert agg.get_task("nojob") is not None


def test_aggregator_derives_task_duration_histograms():
    from ray_tpu_torch.tracing import TaskEventAggregator

    agg = TaskEventAggregator(max_tasks=100)
    agg.ingest([
        {"task_id": "d1", "name": "pt_dur_fn", "state": "SUBMITTED", "ts": 1.0},
        {"task_id": "d1", "name": "pt_dur_fn", "state": "RUNNING", "ts": 1.1},
        {"task_id": "d1", "name": "pt_dur_fn", "state": "EXECUTED", "ts": 1.3},
        {"task_id": "d1", "name": "pt_dur_fn", "state": "FINISHED", "ts": 1.4},
    ])
    snaps = {s["name"]: s for s in get_registry().collect()}
    key = (("name", "pt_dur_fn"),)
    e2e = snaps["task_e2e_ms"]["points"][key]
    ex = snaps["task_exec_ms"]["points"][key]
    assert e2e[-1] == 1 and abs(e2e[-2] - 400.0) < 1      # count, sum(ms)
    assert ex[-1] == 1 and abs(ex[-2] - 200.0) < 1


def test_wal_append_read_truncate(tmp_path):
    from ray_tpu_torch.tracing import TaskEventBuffer, read_wal

    wal = str(tmp_path / "w.jsonl")
    buf = TaskEventBuffer(capacity=100)
    assert buf.enable_wal(wal)
    for i in range(4):
        buf.record(task_id=f"{i:032x}", name="t", state="RUNNING")
    events = read_wal(wal)
    assert [e["task_id"] for e in events] == [f"{i:032x}" for i in range(4)]
    with open(wal, "ab") as f:
        f.write(b'{"task_id": "fff')
    assert len(read_wal(wal)) == 4
    drained, _ = buf.drain()
    assert len(drained) == 4
    buf.wal_flushed()
    assert read_wal(wal) == []
    buf.record(task_id="a" * 32, name="t", state="FAILED")
    assert [e["state"] for e in read_wal(wal)] == ["FAILED"]
    buf.drain()
    buf.wal_flushed()
    buf.record(task_id="b" * 32, name="t", state="RUNNING")
    buf.drain()
    buf.record(task_id="c" * 32, name="t", state="RUNNING")  # post-drain
    buf.wal_flushed()  # buffer non-empty: rewrite, not skip
    assert [e["task_id"] for e in read_wal(wal)] == ["c" * 32]
    buf.record(task_id="d" * 32, name="t", state="EXECUTED")
    assert [e["task_id"] for e in read_wal(wal)] == ["c" * 32, "d" * 32]


def test_local_timeseries_history_and_state_helpers():
    from ray_tpu_torch.core.config import _config
    from ray_tpu_torch.util import state

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(local_mode=True)
    saved = _config.metrics_report_interval_ms
    _config.metrics_report_interval_ms = 100
    try:
        c = Counter("pt_slo_local_total", tag_keys=("deployment",))
        h = Histogram("pt_slo_local_ms", boundaries=[1, 10, 100],
                      tag_keys=("deployment",))
        tags = {"deployment": "L"}
        c.inc(3.0, tags)
        h.observe(5.0, tags)
        time.sleep(0.35)  # let the sampler take periodic samples
        c.inc(3.0, tags)
        h.observe(50.0, tags)
        samples = state.get_metrics_timeseries(
            names=["pt_slo_local_total", "pt_slo_local_ms"])
        assert len(samples) >= 2
        assert samples[-1]["ts"] >= samples[0]["ts"]
        rate = state.metric_rate("pt_slo_local_total", tags, samples=samples)
        assert rate is not None and rate > 0
        p99 = state.metric_percentile("pt_slo_local_ms", 0.99, tags,
                                      samples=samples)
        p50 = state.metric_percentile("pt_slo_local_ms", 0.5, tags,
                                      samples=samples)
        assert p50 is not None and p99 is not None and p50 <= p99
    finally:
        _config.metrics_report_interval_ms = saved
        ray_tpu_torch.shutdown()


def test_quantile_sketch_accuracy_and_merge():
    h = port_m.Histogram("pt_sketch_lat_ms", boundaries=[1, 10, 100, 1000],
                         tag_keys=("k",))
    rng = random.Random(7)
    vals = [rng.lognormvariate(3.0, 1.2) for _ in range(4000)]
    for v in vals:
        h.observe(v, {"k": "a"})
    snap = next(s for s in port_m.get_registry().collect()
                if s["name"] == "pt_sketch_lat_ms")
    assert "sketches" in snap
    sk = snap["sketches"][(("k", "a"),)]
    vals.sort()
    for q in (0.5, 0.9, 0.99):
        est = port_m.sketch_percentile(sk, q)
        true = vals[int(q * (len(vals) - 1))]
        assert abs(est - true) / true < 0.03, (q, est, true)
    pt = snap["points"][(("k", "a"),)]
    assert sum(pt[:-2]) == pt[-1] == len(vals)
    merged = port_m.merge_snapshots({
        "s1": (time.time(), [snap]), "s2": (time.time(), [snap]),
    })
    msnap = next(s for s in merged if s["name"] == "pt_sketch_lat_ms")
    msk = msnap["sketches"][(("k", "a"),)]
    assert sum(msk["c"].values()) == 2 * sum(sk["c"].values())
    est = port_m.sketch_percentile(msk, 0.99)
    true = vals[int(0.99 * (len(vals) - 1))]
    assert abs(est - true) / true < 0.03


def test_window_percentile_prefers_sketch_and_falls_back():
    boundaries = [1, 10, 100, 1000]

    def series(count_hi, sketch):
        s = {"name": "pt_wp_sketch", "kind": "histogram",
             "boundaries": boundaries,
             "points": {(): [0, 0, 0, count_hi, 0, 0.0, count_hi]}}
        if sketch is not None:
            s["sketches"] = {(): sketch}
        return s

    def sk_of(values):
        sk = {"z": 0, "c": {}}
        for v in values:
            idx = port_m._sketch_index(v)
            sk["c"][idx] = sk["c"].get(idx, 0) + 1
        return sk

    first = {"ts": 100.0, "series": [series(10, sk_of([500.0] * 10))]}
    last = {"ts": 110.0, "series": [
        series(30, sk_of([500.0] * 10 + [880.0] * 20))]}
    p = port_m.window_percentile([first, last], "pt_wp_sketch", 0.5)
    assert p is not None and abs(p - 880.0) / 880.0 < 0.02, p
    first_nb = {"ts": 100.0, "series": [series(10, None)]}
    last_nb = {"ts": 110.0, "series": [series(30, None)]}
    p2 = port_m.window_percentile([first_nb, last_nb], "pt_wp_sketch", 0.5)
    assert p2 is not None and 100.0 <= p2 <= 1000.0


# ------------------------------------------------ held equal to the reference
def _seeded_snapshots(m, seed):
    """Per-source registry snapshots of one tagged counter, one gauge and
    one tagged histogram with its sketch, from seeded values, built by the
    package ``m``'s own sketch code."""
    import bisect

    rng = np.random.default_rng(seed)
    bounds = [1, 5, 25, 125, 625]
    out = {}
    for src in range(3):
        counter = {(("route", r),): float(rng.integers(0, 100))
                   for r in ("/a", "/b")}
        points, sketches = {}, {}
        for r in ("/a", "/b"):
            pts = [0] * (len(bounds) + 1) + [0.0, 0]
            sk = {"z": 0, "c": {}}
            for v in rng.lognormal(2.5, 1.0, size=200):
                pts[bisect.bisect_left(bounds, v)] += 1
                pts[-2] += float(v)
                pts[-1] += 1
                m._sketch_observe(sk, float(v))
            points[(("route", r),)] = pts
            sketches[(("route", r),)] = sk
        out[f"s{src}"] = [
            {"name": "eq_requests_total", "kind": "counter",
             "description": "reqs", "boundaries": [], "points": counter},
            {"name": "eq_depth", "kind": "gauge", "description": "depth",
             "boundaries": [], "points": {(): float(src + 1)}},
            {"name": "eq_lat_ms", "kind": "histogram", "description": "lat",
             "boundaries": bounds, "points": points, "sketches": sketches},
        ]
    return out


def test_merge_render_rates_and_percentiles_equal_the_references():
    now = time.time()
    got_s, want_s = [], []
    for step in range(3):
        port_per = _seeded_snapshots(port_m, 10 * step)
        ref_per = _seeded_snapshots(ref_m, 10 * step)
        assert port_per == ref_per
        port_in = {k: (now + step, v) for k, v in port_per.items()}
        ref_in = {k: (now + step, v) for k, v in ref_per.items()}
        got, want = port_m.merge_snapshots(port_in), ref_m.merge_snapshots(ref_in)
        assert got == want
        assert port_m.render_prometheus(got) == ref_m.render_prometheus(want)
        got_s.append({"ts": now + step, "series": got})
        want_s.append({"ts": now + step, "series": want})
    for tags in (None, {"route": "/a"}):
        assert port_m.counter_rate(got_s, "eq_requests_total", tags) == \
            ref_m.counter_rate(want_s, "eq_requests_total", tags)
        for q in (0.5, 0.9, 0.99):
            assert port_m.window_percentile(got_s, "eq_lat_ms", q, tags) == \
                ref_m.window_percentile(want_s, "eq_lat_ms", q, tags)
    sk = got_s[-1]["series"]
    sketch = next(s for s in sk if s["name"] == "eq_lat_ms")["sketches"]
    for key, value in sketch.items():
        for q in (0.1, 0.5, 0.99):
            assert port_m.sketch_percentile(value, q) == \
                ref_m.sketch_percentile(value, q)


# ---------------------------------------------------------- cluster level
def test_worker_print_reaches_driver_and_metrics_export(capfd):
    """A print() inside a remote task appears on the driver (the log
    monitor → GCS pubsub → driver path), and metrics recorded in a worker
    reach the GCS's merged series with the raylet's core series."""
    import os

    from ray_tpu_torch.core.config import _config
    from ray_tpu_torch.util import state

    ray_tpu_torch.shutdown()
    saved = _config.metrics_report_interval_ms
    os.environ["RAY_TPU_METRICS_REPORT_INTERVAL_MS"] = "500"
    _config.metrics_report_interval_ms = 500
    try:
        ray_tpu_torch.init(num_cpus=2, num_gpus=0)

        @ray_tpu_torch.remote
        def noisy(x):
            from ray_tpu_torch.util.metrics import Counter

            print(f"hello-from-worker-{x}")
            Counter("pt_worker_tasks", description="tasks run").inc()
            return x

        assert ray_tpu_torch.get(
            [noisy.remote(i) for i in range(3)], timeout=60) == [0, 1, 2]

        deadline = time.monotonic() + 15
        seen = ""
        while time.monotonic() < deadline:
            seen += capfd.readouterr().err
            if len(re.findall(r"hello-from-worker-\d", seen)) >= 3:
                break
            time.sleep(0.3)
        assert len(re.findall(r"hello-from-worker-\d", seen)) >= 3, seen
        assert "(worker-" in seen  # source prefix

        deadline = time.monotonic() + 20
        text = ""
        while time.monotonic() < deadline:
            text = render_prometheus(state._gcs_call("collect_metrics"))
            if "pt_worker_tasks 3.0" in text and "task_e2e_ms_bucket" in text:
                break
            time.sleep(0.5)
        assert "# TYPE pt_worker_tasks counter" in text
        assert "pt_worker_tasks 3.0" in text, text
        # core raylet metrics ride the same plane; the GCS derives the
        # task latency histograms from the task events
        assert "raylet_workers" in text
        assert "object_store_used_bytes" in text
        assert "raylet_lease_grant_ms_bucket" in text
        assert 'task_e2e_ms_bucket{name="noisy"' in text
        _lint_prometheus(text)
        p50 = state.metric_percentile("task_e2e_ms", 0.5, {"name": "noisy"})
        assert p50 is None or p50 > 0
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_METRICS_REPORT_INTERVAL_MS", None)
        _config.metrics_report_interval_ms = saved

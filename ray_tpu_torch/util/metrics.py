"""User-defined and core metrics: Counter / Gauge / Histogram.

Parity: python/ray/util/metrics.py (the user API over the Cython metric
bindings) and src/ray/stats/metric.h:103 (core metric definitions). Design
here: every process keeps one in-memory `MetricsRegistry`; the runtime
(core_worker, raylet, GCS) flushes snapshots to the GCS over the existing
control connections, and the dashboard renders the cluster-wide aggregate as
a Prometheus text endpoint (`/metrics`) — the role the reference fills with
its per-node OpenCensus agent + prometheus_exporter.py.

Usage (identical shape to the reference):

    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

    requests = Counter("app_requests", description="...", tag_keys=("route",))
    requests.inc(1.0, tags={"route": "/predict"})
    qsize = Gauge("app_queue_size")
    qsize.set(3)
    latency = Histogram("app_latency_ms", boundaries=[1, 10, 100, 1000])
    latency.observe(12.5)

Metrics are registered process-wide on construction; constructing the same
name twice returns independent handles onto the same underlying series.

The port's copy of ray_tpu/util/metrics.py. The dashboard that renders
``/metrics`` is not ported yet: ``render_prometheus`` gives the same text
from the GCS's merged series. The reference's ``KNOWN_METRICS`` catalog,
which only its linter reads, comes with the linter (ROADMAP Queue A).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_TagTuple = Tuple[Tuple[str, str], ...]

# ----------------------------------------------------------------------- #
# Quantile sketch (DDSketch-style): log-spaced buckets with a guaranteed
# RELATIVE accuracy, so tail percentiles (p99/p999) come out within
# ±_SKETCH_ALPHA of the true value instead of being interpolated across a
# fixed exposition bucket that may span 2-4x. Every Histogram keeps one
# sketch per tag combination alongside the Prometheus buckets; sketches are
# mergeable (bucket-wise sums) and ride snapshots as an additive field, so
# readers without sketch support (the dashboard JSON path) silently fall
# back to the bucket interpolation.
# ----------------------------------------------------------------------- #

_SKETCH_ALPHA = 0.01  # 1% relative accuracy
_SKETCH_GAMMA = (1.0 + _SKETCH_ALPHA) / (1.0 - _SKETCH_ALPHA)
_SKETCH_INV_LOG_GAMMA = 1.0 / math.log(_SKETCH_GAMMA)
# backstop on distinct sketch buckets per point (values spanning the full
# float range at 1% accuracy stay well under this; a runaway series
# collapses its lowest buckets instead of growing without bound)
_SKETCH_MAX_BUCKETS = 2048


def _sketch_index(value: float) -> int:
    """Bucket i covers (gamma^(i-1), gamma^i]: every value in it is within
    alpha (relative) of the bucket's representative value."""
    return math.ceil(math.log(value) * _SKETCH_INV_LOG_GAMMA)


def _sketch_value(index: int) -> float:
    """Representative (midpoint) value of sketch bucket ``index``."""
    return 2.0 * _SKETCH_GAMMA ** index / (_SKETCH_GAMMA + 1.0)


def _sketch_observe(sk: dict, value: float) -> None:
    """Record one observation into a per-point sketch ``{"z": zero_count,
    "c": {index: count}}`` (values <= 0 land in "z")."""
    if value <= 0:
        sk["z"] += 1
        return
    counts = sk["c"]
    idx = _sketch_index(value)
    counts[idx] = counts.get(idx, 0) + 1
    if len(counts) > _SKETCH_MAX_BUCKETS:
        # collapse the lowest bucket into its neighbor (tail accuracy is
        # what the sketch is for; the low end degrades gracefully)
        lo = min(counts)
        nxt = min(k for k in counts if k != lo)
        counts[nxt] = counts.get(nxt, 0) + counts.pop(lo)


def _sketch_merge(into: dict, other: dict) -> None:
    into["z"] += other.get("z", 0)
    c = into["c"]
    for k, v in other.get("c", {}).items():
        k = int(k)  # JSON round trips stringify int keys
        c[k] = c.get(k, 0) + v


def sketch_percentile(sk: Optional[dict], q: float) -> Optional[float]:
    """q-th percentile (q in [0,1]) from a sketch, accurate to
    ±_SKETCH_ALPHA relative error; None for an empty/missing sketch."""
    if not sk:
        return None
    counts = {int(k): v for k, v in sk.get("c", {}).items()}
    zero = sk.get("z", 0)
    total = zero + sum(counts.values())
    if total <= 0:
        return None
    rank = q * total
    cum = zero
    if cum >= rank and zero:
        return 0.0
    for idx in sorted(counts):
        cum += counts[idx]
        if cum >= rank:
            return _sketch_value(idx)
    return _sketch_value(max(counts)) if counts else 0.0

# shared latency bucket boundaries (ms) for the built-in SLO histograms
# (serve router/replica/proxy, raylet lease grants, cgraph execute): sub-ms
# dispatch through multi-second model calls. One list so a bucket tweak
# lands everywhere at once.
LATENCY_MS_BOUNDS = [1, 2, 5, 10, 25, 50, 100, 250, 500,
                     1000, 2500, 5000, 10000, 30000]


def _tags_key(tags: Optional[Dict[str, str]]) -> _TagTuple:
    return tuple(sorted((tags or {}).items()))


class _Series:
    """One named metric's state across all tag combinations."""

    def __init__(self, name: str, kind: str, description: str,
                 boundaries: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind  # counter | gauge | histogram
        self.description = description
        self.boundaries = list(boundaries or [])
        # hot leaf lock (every inc/observe), never nested inside another
        # named lock — left plain so the sanitizer costs nothing here
        self.lock = threading.Lock()
        # counter/gauge: tags -> float
        # histogram: tags -> [bucket_counts..., +inf_count, sum, count]
        self.points: Dict[_TagTuple, object] = {}
        # histogram only: tags -> quantile sketch {"z": int, "c": {idx: n}}
        # (kept beside the exposition buckets, never instead of them — the
        # /metrics endpoint's format is bucket-defined)
        self.sketches: Dict[_TagTuple, dict] = {}

    def snapshot(self) -> dict:
        with self.lock:
            pts = {
                k: (list(v) if isinstance(v, list) else v)
                for k, v in self.points.items()
            }
            sks = {
                k: {"z": v["z"], "c": dict(v["c"])}
                for k, v in self.sketches.items()
            }
        out = {
            "name": self.name,
            "kind": self.kind,
            "description": self.description,
            "boundaries": self.boundaries,
            "points": pts,
        }
        if sks:
            out["sketches"] = sks
        return out


class MetricsRegistry:
    def __init__(self):
        from ray_tpu_torch.analysis.sanitizers import make_lock

        self._lock = make_lock("metrics.registry")
        self._series: Dict[str, _Series] = {}

    def series(self, name: str, kind: str, description: str,
               boundaries=None) -> _Series:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = _Series(name, kind, description, boundaries)
                self._series[name] = s
            elif s.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {s.kind}"
                )
            return s

    def collect(self) -> List[dict]:
        with self._lock:
            series = list(self._series.values())
        return [s.snapshot() for s in series if s.points]


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


class _Metric:
    KIND = ""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None, **kw):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self._tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._series = _registry.series(name, self.KIND, description, **kw)

    @property
    def name(self) -> str:
        return self._series.name

    def set_default_tags(self, tags: Dict[str, str]):
        """Tags merged under every record (reference API parity)."""
        self._default_tags = dict(tags)
        return self

    def _resolve_tags(self, tags: Optional[Dict[str, str]]) -> _TagTuple:
        merged = {**self._default_tags, **(tags or {})}
        extra = set(merged) - set(self._tag_keys)
        if extra and self._tag_keys:
            raise ValueError(
                f"tags {sorted(extra)} not declared in tag_keys for "
                f"metric {self.name!r}"
            )
        return _tags_key(merged)


class Counter(_Metric):
    """Monotonically increasing value (aggregated as a sum across processes)."""

    KIND = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("Counter.inc() value must be >= 0")
        key = self._resolve_tags(tags)
        s = self._series
        with s.lock:
            s.points[key] = s.points.get(key, 0.0) + value


class Gauge(_Metric):
    """Last-write-wins value (exported per process, `source` label added)."""

    KIND = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        s = self._series
        with s.lock:
            s.points[key] = float(value)


class Histogram(_Metric):
    """Bucketed distribution with Prometheus-style cumulative export."""

    KIND = "histogram"

    def __init__(self, name, description: str = "", boundaries=None,
                 tag_keys=None):
        if not boundaries:
            boundaries = [0.001, 0.01, 0.1, 1, 10, 100, 1000]
        if list(boundaries) != sorted(boundaries):
            raise ValueError("histogram boundaries must be sorted")
        super().__init__(name, description, tag_keys, boundaries=boundaries)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        s = self._series
        with s.lock:
            pt = s.points.get(key)
            if pt is None:
                pt = [0] * (len(s.boundaries) + 1) + [0.0, 0]
                s.points[key] = pt
            # C-level bisect replaces the Python boundary loop (hot path:
            # every serve request / raylet lease observes)
            pt[bisect.bisect_left(s.boundaries, value)] += 1
            pt[-2] += value
            pt[-1] += 1
            sk = s.sketches.get(key)
            if sk is None:
                sk = s.sketches[key] = {"z": 0, "c": {}}
            _sketch_observe(sk, value)


# ----------------------------------------------------------------------- #
# Aggregation + Prometheus text rendering (used by GCS/dashboard)
# ----------------------------------------------------------------------- #

def merge_snapshots(per_source: Dict[str, Tuple[float, List[dict]]],
                    stale_after_s: float = 120.0) -> List[dict]:
    """Merge {source: (ts, [series snapshots])} into one list. Counters and
    histograms sum across sources; gauges keep one point per source (a
    `source` tag is added so concurrent reporters don't clobber each other)."""
    now = time.time()
    merged: Dict[str, dict] = {}
    for source, (ts, series_list) in per_source.items():
        if now - ts > stale_after_s:
            continue
        for snap in series_list:
            m = merged.setdefault(
                snap["name"],
                {**snap, "points": {}, "sketches": {}},
            )
            for tags, val in snap["points"].items():
                if snap["kind"] == "gauge":
                    key = tags + (("source", source),)
                    m["points"][key] = val
                elif snap["kind"] == "histogram":
                    cur = m["points"].get(tags)
                    if cur is None:
                        m["points"][tags] = list(val)
                    else:
                        m["points"][tags] = [a + b for a, b in zip(cur, val)]
                else:
                    m["points"][tags] = m["points"].get(tags, 0.0) + val
            for tags, sk in (snap.get("sketches") or {}).items():
                cur = m["sketches"].get(tags)
                if cur is None:
                    m["sketches"][tags] = {"z": sk.get("z", 0),
                                           "c": dict(sk.get("c", {}))}
                else:
                    _sketch_merge(cur, sk)
    out = []
    for m in merged.values():
        if not m.get("sketches"):
            m.pop("sketches", None)  # counters/gauges: no empty clutter
        out.append(m)
    return out


def _escape_tag_value(v: str) -> str:
    """Prometheus text exposition label-value escaping: backslash, double
    quote and newline must be escaped or the line (and every line after it)
    is unparseable."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    """HELP text escaping: backslash and newline (quotes are legal here)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_tags(tags: _TagTuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_tag_value(v)}"' for k, v in tags]
    parts += [extra] if extra else []
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus(series_list: List[dict]) -> str:
    """Prometheus text exposition format (text/plain; version=0.0.4)."""
    out: List[str] = []
    for s in sorted(series_list, key=lambda s: s["name"]):
        name, kind = s["name"], s["kind"]
        ptype = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram"}[kind]
        if s.get("description"):
            out.append(f"# HELP {name} {_escape_help(s['description'])}")
        out.append(f"# TYPE {name} {ptype}")
        for tags, val in sorted(s["points"].items()):
            if kind == "histogram":
                cum = 0
                for i, b in enumerate(s["boundaries"]):
                    cum += val[i]
                    le = 'le="%s"' % b
                    out.append(
                        f"{name}_bucket{_fmt_tags(tags, le)} {cum}"
                    )
                cum += val[len(s["boundaries"])]
                le_inf = 'le="+Inf"'
                out.append(
                    f"{name}_bucket{_fmt_tags(tags, le_inf)} {cum}"
                )
                out.append(f"{name}_sum{_fmt_tags(tags)} {val[-2]}")
                out.append(f"{name}_count{_fmt_tags(tags)} {val[-1]}")
            else:
                out.append(f"{name}{_fmt_tags(tags)} {val}")
    return "\n".join(out) + "\n"


# ----------------------------------------------------------------------- #
# Time series: bounded ring of merged snapshots (SLO observability)
# ----------------------------------------------------------------------- #

class MetricsTimeSeries:
    """Bounded ring of merged metric snapshots, sampled on a fixed period.

    The GCS samples its cluster-wide merge every
    ``metrics_report_interval_ms`` (the local backend samples its in-process
    registry the same way), so "what was p99 five minutes ago" is answerable
    from ``depth`` points of history instead of only the latest snapshot.
    Each sample is ``{"ts": float, "series": [merged series snapshots]}``.
    """

    def __init__(self, depth: Optional[int] = None):
        from collections import deque

        from ray_tpu_torch.core.config import _config

        from ray_tpu_torch.analysis.sanitizers import make_lock

        self.depth = max(2, depth or _config.metrics_timeseries_depth)
        self._lock = make_lock("metrics.timeseries")
        self._ring: "deque" = deque(maxlen=self.depth)

    def sample(self, series_list: List[dict], ts: Optional[float] = None):
        with self._lock:
            self._ring.append({"ts": ts or time.time(),
                               "series": series_list})

    def dump(self) -> List[dict]:
        """Copy-out for the GCS durability snapshot: a restarted head keeps
        its metric history instead of an empty ring (samples are replaced
        wholesale by ``sample()``, so shallow copies are safe)."""
        with self._lock:
            return list(self._ring)

    def restore(self, samples: Sequence[dict]) -> None:
        with self._lock:
            for s in samples:
                self._ring.append(s)

    def query(self, names: Optional[Sequence[str]] = None,
              limit: Optional[int] = None) -> List[dict]:
        """Newest-last window of samples; ``names`` filters series."""
        with self._lock:
            samples = list(self._ring)
        if limit is not None:
            limit = int(limit)
            samples = samples[-limit:] if limit > 0 else []
        if names is None:
            return samples
        keep = set(names)
        return [
            {"ts": s["ts"],
             "series": [x for x in s["series"] if x["name"] in keep]}
            for s in samples
        ]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


def _find_points(sample: dict, name: str,
                 tags: Optional[Dict[str, str]] = None):
    """(series, summed/selected point) for one sample, or (None, None).
    Counter/gauge points sum over every tag combination that is a superset
    of ``tags``; histogram points sum bucket-wise the same way."""
    for s in sample.get("series", ()):
        if s["name"] != name:
            continue
        want = set((tags or {}).items())
        acc = None
        for ptags, val in s["points"].items():
            if not want <= set(ptags):
                continue
            if isinstance(val, list):
                acc = list(val) if acc is None else [
                    a + b for a, b in zip(acc, val)
                ]
            else:
                acc = val if acc is None else acc + val
        return s, acc
    return None, None


def counter_rate(samples: List[dict], name: str,
                 tags: Optional[Dict[str, str]] = None) -> Optional[float]:
    """Per-second rate of a cumulative counter over the sample window
    (first→last), or None when fewer than two samples carry the series.
    Robust to counter resets (a restart): negative deltas clamp to 0."""
    seen = []
    for s in samples:
        _, v = _find_points(s, name, tags)
        if v is not None:
            seen.append((s["ts"], v))
    if len(seen) < 2:
        return None
    (t0, v0), (t1, v1) = seen[0], seen[-1]
    if t1 <= t0:
        return None
    return max(0.0, v1 - v0) / (t1 - t0)


def histogram_percentile(boundaries: Sequence[float], counts: Sequence[float],
                         q: float) -> Optional[float]:
    """Estimate the q-th percentile (q in [0,1]) from per-bucket counts
    (NON-cumulative, the registry's internal layout: one count per boundary
    plus the +Inf bucket). Linear interpolation inside the winning bucket,
    prometheus histogram_quantile style; the +Inf bucket reports the last
    finite boundary."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    lo = 0.0
    for i, b in enumerate(boundaries):
        prev = cum
        cum += counts[i]
        if cum >= rank:
            frac = 0.0 if counts[i] == 0 else (rank - prev) / counts[i]
            return lo + (b - lo) * frac
        lo = b
    return boundaries[-1] if boundaries else None


def _find_sketch(sample: dict, name: str,
                 tags: Optional[Dict[str, str]] = None) -> Optional[dict]:
    """Summed quantile sketch for one sample (tag-superset selection like
    _find_points), or None when the series carries no sketches (e.g. it
    crossed a JSON boundary that drops additive fields)."""
    for s in sample.get("series", ()):
        if s["name"] != name:
            continue
        want = set((tags or {}).items())
        acc: Optional[dict] = None
        for ptags, sk in (s.get("sketches") or {}).items():
            if not want <= set(ptags):
                continue
            if acc is None:
                acc = {"z": sk.get("z", 0), "c": dict(sk.get("c", {}))}
            else:
                _sketch_merge(acc, sk)
        return acc
    return None


def _sketch_delta(last: dict, first: Optional[dict]) -> dict:
    """Sketch of what happened BETWEEN two cumulative sketches (clamped at
    zero per bucket — a restart resets the counters)."""
    if first is None:
        return last
    fc = {int(k): v for k, v in first.get("c", {}).items()}
    counts = {
        int(k): v - fc.get(int(k), 0)
        for k, v in last.get("c", {}).items()
        if v - fc.get(int(k), 0) > 0
    }
    return {"z": max(0, last.get("z", 0) - first.get("z", 0)), "c": counts}


def window_percentile(samples: List[dict], name: str, q: float,
                      tags: Optional[Dict[str, str]] = None,
                      ) -> Optional[float]:
    """Percentile of a histogram series OVER the sample window: the bucket
    deltas between the window's first and last samples (what happened in the
    window), falling back to the cumulative last sample when the series only
    appears once. When the samples carry quantile sketches the estimate is
    sketch-based (±1% relative accuracy on the tails) instead of linear
    interpolation inside an exposition bucket."""
    seen = []
    sk_seen = []
    boundaries = None
    for s in samples:
        series, v = _find_points(s, name, tags)
        if v is not None:
            boundaries = series.get("boundaries") or boundaries
            seen.append(v)
            sk_seen.append(_find_sketch(s, name, tags))
    if not seen or boundaries is None:
        return None
    # sketch path: accurate tails, same window-delta semantics. Requires a
    # sketch on BOTH window endpoints (or a single-sample window) — a
    # sketchless first sample (pre-upgrade snapshot, JSON-crossing source)
    # would silently turn "the window's p99" into the all-time cumulative
    # p99, so that case falls back to bucket deltas instead.
    if sk_seen and sk_seen[-1] is not None \
            and (len(sk_seen) == 1 or sk_seen[0] is not None):
        delta = _sketch_delta(
            sk_seen[-1], sk_seen[0] if len(sk_seen) > 1 else None
        )
        if delta.get("z", 0) + sum(delta.get("c", {}).values()) <= 0:
            delta = sk_seen[-1]  # nothing in the window: cumulative
        est = sketch_percentile(delta, q)
        if est is not None:
            return est
    last = seen[-1]
    nb = len(boundaries) + 1  # + the +Inf bucket; tail is [sum, count]
    counts = list(last[:nb])
    if len(seen) > 1:
        first = seen[0]
        delta = [max(0.0, a - b) for a, b in zip(counts, first[:nb])]
        if sum(delta) > 0:
            counts = delta
    return histogram_percentile(boundaries, counts, q)


# ------------------------------------------------- overload-protection series
_deadline_expired: Optional["Counter"] = None


def deadline_expired_counter() -> Optional["Counter"]:
    """``task_deadline_expired_total``: work shed because its request
    deadline expired before dispatch (owner side) or before execution
    (worker side). Recorded by the core planes — the serve layer keeps its
    own deployment-tagged ``serve_deadline_expired_total``. None when the
    built-in instrumentation is off."""
    from ray_tpu_torch.core.config import _config

    global _deadline_expired
    if not _config.metrics_enabled:
        return None
    if _deadline_expired is None:
        _deadline_expired = Counter(
            "task_deadline_expired_total",
            "tasks shed pre-dispatch/pre-execution on an expired deadline",
            tag_keys=("where",),
        )
    return _deadline_expired

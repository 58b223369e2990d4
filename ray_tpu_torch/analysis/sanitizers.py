"""Dev-mode runtime sanitizers, gated by ``RAY_TPU_SANITIZE=1``.

The static rules (rules.py) catch what is visible in the source; these
catch what only manifests at runtime, the way Ray's C++ CI runs under
TSan. Three sanitizers, all recording into one violation log plus the
``sanitizer_violations_total{kind=...}`` registry Counter (so daemon
processes' trips flow to the GCS through the existing metrics flush loops
and are visible from the driver via ``summarize_metrics()`` /
``scripts metrics``):

- **Lock-order** (``kind="lock_order"``): ``make_lock("name")`` /
  ``make_condition("name")`` wrap the named core-plane locks. Each
  process keeps a per-thread stack of held lock names and a global
  first-seen acquisition-order graph; an acquisition that closes a cycle
  in that graph is a potential-deadlock violation recorded with BOTH
  stacks (the current one and the one that established the reverse
  edge). Detection is order-based, so single-threaded tests catch
  inversions that would only deadlock under concurrency.
- **io-loop watchdog** (``kind="loop_stall"``): every ``EventLoopThread``
  registers with a singleton watchdog thread that schedules a heartbeat
  callback on each loop; a heartbeat not run within
  ``sanitize_loop_stall_s`` means something is blocking the loop — the
  violation captures the loop thread's CURRENT stack via
  ``sys._current_frames``, i.e. the blocker itself.
- **Thread affinity** (``kind="affinity"``): ``assert_loop_affinity`` /
  ``assert_thread_affinity`` guards on structures documented as
  loop-only (the rpc outbox, the EventLoopThread call queue).

With the gate off every entry point is a cheap flag check and
``make_lock`` returns a plain ``threading.Lock`` — zero production cost.

The port's copy of ray_tpu/analysis/sanitizers.py, unchanged but for the
package name: the same lock names and violation kinds, so a sanitized port
cluster reports what a sanitized reference cluster reports.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_ENABLED = os.environ.get("RAY_TPU_SANITIZE", "").lower() in (
    "1", "true", "yes")


def enabled() -> bool:
    return _ENABLED


def enable(flag: bool = True) -> None:
    """Flip the gate (tests). Locks created before enabling stay plain."""
    global _ENABLED
    _ENABLED = flag


# --------------------------------------------------------------------------
# Violation log
# --------------------------------------------------------------------------
_vio_lock = threading.Lock()  # plain on purpose: the sanitizer's own lock
_violations: List[Dict[str, Any]] = []
_counts: Dict[str, int] = {}
_MAX_VIOLATIONS = 200  # bounded: a hot violation site must not OOM us


def record_violation(kind: str, name: str, detail: str,
                     stacks: Optional[List[str]] = None) -> None:
    v = {
        "kind": kind, "name": name, "detail": detail,
        "stacks": list(stacks or []), "pid": os.getpid(), "ts": time.time(),
    }
    with _vio_lock:
        _counts[kind] = _counts.get(kind, 0) + 1
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(v)
    logger.error("SANITIZER[%s] %s: %s", kind, name, detail)
    # The metrics export below acquires the (sanitized) metrics.registry
    # lock, whose _note_acquired can re-enter record_violation on this
    # same thread — and registry.series would then re-acquire a lock this
    # frame already holds. Skip the export on re-entry: the inner
    # violation is still logged and counted above, only its counter inc
    # is dropped.
    if getattr(_tls, "in_record", False):
        return
    _tls.in_record = True
    try:  # best-effort: surfacing must never take the process down
        from ray_tpu_torch.util import metrics as metrics_api

        metrics_api.Counter(
            "sanitizer_violations_total",
            "runtime sanitizer violations (lock-order cycles, io-loop "
            "stalls, thread-affinity breaks) by kind",
            tag_keys=("kind",),
        ).inc(1, tags={"kind": kind})
    except Exception:  # noqa: BLE001
        pass
    finally:
        _tls.in_record = False


def violations(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    with _vio_lock:
        out = list(_violations)
    return [v for v in out if kind is None or v["kind"] == kind]


def violation_counts() -> Dict[str, int]:
    with _vio_lock:
        return dict(_counts)


def reset() -> None:
    """Clear recorded violations AND the lock-order graph (tests)."""
    with _vio_lock:
        _violations.clear()
        _counts.clear()
    with _graph_lock:
        _edges.clear()
        _cycles_seen.clear()


def scoped(drop_prefixes: tuple = ()):
    """Context manager for tests that deliberately trip the sanitizers.

    On exit it removes ONLY the violations recorded during the scope
    whose ``name`` starts with one of ``drop_prefixes`` (the fixture's
    own lock/loop/tag names) and restores the lock-order graph. Anything
    recorded before the scope is untouched, and a REAL violation another
    thread records concurrently (a watchdog trip, a flush-loop lock
    inversion) survives the exit — a blanket :func:`reset` here would
    silently defeat the suite-wide zero-violations gate in conftest."""
    from contextlib import contextmanager

    @contextmanager
    def _scope():
        with _vio_lock:
            vios, counts = list(_violations), dict(_counts)
        with _graph_lock:
            edges, cycles = dict(_edges), set(_cycles_seen)
        try:
            yield
        finally:
            with _vio_lock:
                kept = [
                    v for v in _violations[len(vios):]
                    if not any(v["name"].startswith(p)
                               for p in drop_prefixes)
                ]
                _violations[:] = vios + kept
                _counts.clear()
                _counts.update(counts)
                for v in kept:
                    _counts[v["kind"]] = _counts.get(v["kind"], 0) + 1
            with _graph_lock:
                # same keep-the-real-deltas rule for the ordering graph:
                # erasing an edge another thread first-observed during the
                # scope would let the REVERSE order become canonical later
                # and hide a genuine inversion
                def _mine(name: str) -> bool:
                    return any(name.startswith(p) for p in drop_prefixes)

                kept_edges = {
                    e: s for e, s in _edges.items()
                    if e not in edges and not (_mine(e[0]) or _mine(e[1]))
                }
                kept_cycles = {
                    c for c in _cycles_seen
                    if c not in cycles and not any(_mine(n) for n in c)
                }
                _edges.clear()
                _edges.update(edges)
                _edges.update(kept_edges)
                _cycles_seen.clear()
                _cycles_seen.update(cycles)
                _cycles_seen.update(kept_cycles)

    return _scope()


# --------------------------------------------------------------------------
# Lock-order sanitizer
# --------------------------------------------------------------------------
_graph_lock = threading.Lock()
_edges: Dict[tuple, str] = {}  # (held_name, acquired_name) -> stack at 1st obs
_cycles_seen: set = set()
_tls = threading.local()


def _held() -> List[str]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _find_path(src: str, dst: str) -> Optional[List[tuple]]:
    """DFS over the edge graph: a path of edges src -> ... -> dst."""
    stack = [(src, [])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        for (a, b) in _edges:
            if a != node or b in seen:
                continue
            npath = path + [(a, b)]
            if b == dst:
                return npath
            seen.add(b)
            stack.append((b, npath))
    return None


def _note_acquired(name: str) -> None:
    held = _held()
    if held:
        cur_stack = None
        # violations are recorded OUTSIDE _graph_lock: record_violation
        # takes _vio_lock and the metrics registry locks — which may
        # themselves be sanitized locks re-entering this function
        found: List[tuple] = []
        with _graph_lock:
            for h in dict.fromkeys(held):  # unique, order kept
                if h == name:
                    continue  # recursion / same-name class: no self-edges
                edge = (h, name)
                if edge not in _edges:
                    if cur_stack is None:
                        cur_stack = "".join(traceback.format_stack(limit=12))
                    _edges[edge] = cur_stack
                    # does acquiring `name` while holding `h` close a cycle
                    # (a recorded path name -> ... -> h)?
                    path = _find_path(name, h)
                    if path is not None:
                        cycle = tuple(sorted({name, h}.union(
                            x for e in path for x in e)))
                        if cycle not in _cycles_seen:
                            _cycles_seen.add(cycle)
                            found.append(
                                (h, path, cur_stack,
                                 _edges.get(path[0], "")))
        held.append(name)
        for h, path, stack, rev_stack in found:
            record_violation(
                "lock_order", name,
                f"lock-order cycle: acquired {name!r} while holding "
                f"{h!r}, but the reverse order "
                f"{' -> '.join(a for a, _ in path)} -> {h} was recorded "
                f"earlier — potential deadlock",
                stacks=[stack, rev_stack],
            )
        return
    held.append(name)


def _note_released(name: str) -> None:
    held = getattr(_tls, "held", None)
    if held:
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                break


def _note_released_all(name: str) -> None:
    held = getattr(_tls, "held", None)
    if held:
        _tls.held = [h for h in held if h != name]


class SanitizedLock:
    """threading.Lock wrapper feeding the per-process acquisition graph.

    API-compatible where the runtime needs it (acquire/release/context
    manager/locked) and usable as the lock behind ``threading.Condition``
    — Condition's default ``_release_save``/``_acquire_restore``/
    ``_is_owned`` fallbacks only use acquire/release."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, lock_factory=threading.Lock):
        self.name = name
        self._lock = lock_factory()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquired(self.name)
        return ok

    def release(self) -> None:
        _note_released(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"SanitizedLock({self.name!r}, {self._lock!r})"


class SanitizedRLock:
    """RLock wrapper for Condition use: exposes the ``_release_save`` /
    ``_acquire_restore`` / ``_is_owned`` trio Condition.wait() relies on
    for recursive locks, keeping the tracking balanced across waits."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquired(self.name)
        return ok

    def release(self) -> None:
        _note_released(self.name)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition.wait integration: releases every recursion level at once
    def _release_save(self):
        _note_released_all(self.name)
        return self._lock._release_save()

    def _acquire_restore(self, state):
        self._lock._acquire_restore(state)
        _note_acquired(self.name)

    def _is_owned(self):
        return self._lock._is_owned()

    def __repr__(self):
        return f"SanitizedRLock({self.name!r}, {self._lock!r})"


def make_lock(name: str):
    """A named core-plane lock: sanitized when the gate is on, a plain
    ``threading.Lock`` otherwise (zero overhead in production)."""
    return SanitizedLock(name) if _ENABLED else threading.Lock()


def make_rlock(name: str):
    return SanitizedRLock(name) if _ENABLED else threading.RLock()


def make_condition(name: str, lock=None):
    """A ``threading.Condition`` over a named sanitized (R)Lock. Pass
    ``lock`` to share an existing named lock (condvar-over-state-lock
    idiom)."""
    return threading.Condition(lock if lock is not None else make_rlock(name))


def lock_order_edges() -> Dict[tuple, str]:
    with _graph_lock:
        return dict(_edges)


# --------------------------------------------------------------------------
# io-loop watchdog
# --------------------------------------------------------------------------
class _WatchEntry:
    __slots__ = ("ref", "ping_sent", "ping_done", "reported")

    def __init__(self, elt):
        self.ref = weakref.ref(elt)
        self.ping_sent: Optional[float] = None
        self.ping_done = True
        self.reported = False


class _LoopWatchdog:
    """One daemon thread per process pinging every registered
    EventLoopThread; a heartbeat that does not run within the stall
    threshold records a violation carrying the loop thread's live stack."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: List[_WatchEntry] = []
        self._thread: Optional[threading.Thread] = None

    def register(self, elt) -> None:
        with self._lock:
            self._entries.append(_WatchEntry(elt))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="raylint-loop-watchdog",
                    daemon=True)
                self._thread.start()

    def _config(self):
        from ray_tpu_torch.core.config import _config

        return (max(0.05, _config.sanitize_loop_ping_interval_s),
                max(0.1, _config.sanitize_loop_stall_s))

    def _run(self) -> None:
        while True:
            try:
                self._run_once()
            except Exception:  # noqa: BLE001 - one bad entry/teardown race
                # must not kill the singleton: a dead watchdog silently
                # disables loop-stall coverage for the process lifetime
                logger.exception("loop watchdog iteration failed")
                time.sleep(1.0)

    def _run_once(self) -> None:
        interval, stall_s = self._config()
        time.sleep(interval)
        with self._lock:
            entries = list(self._entries)
        now = time.monotonic()
        dead = []
        for e in entries:
            elt = e.ref()
            if elt is None or getattr(elt.loop, "is_closed", bool)():
                dead.append(e)
                continue
            thread = getattr(elt, "_thread", None)
            if thread is not None and not thread.is_alive():
                # stop() leaves the loop stopped-but-not-closed: a
                # pending heartbeat will never run, which is shutdown,
                # not a stall (and the ident may already be reused)
                dead.append(e)
                continue
            if not e.ping_done and e.ping_sent is not None:
                if not e.reported and now - e.ping_sent >= stall_s:
                    e.reported = True
                    self._report_stall(elt, now - e.ping_sent)
                continue  # wait for the outstanding ping
            e.ping_sent = now
            e.ping_done = False
            e.reported = False

            def _pong(entry=e):
                entry.ping_done = True

            try:
                elt.loop.call_soon_threadsafe(_pong)
            except RuntimeError:  # loop closed between checks
                dead.append(e)
        if dead:
            with self._lock:
                self._entries = [x for x in self._entries
                                 if x not in dead]

    @staticmethod
    def _report_stall(elt, waited: float) -> None:
        stack = ""
        ident = getattr(getattr(elt, "_thread", None), "ident", None)
        if ident is not None:
            frame = sys._current_frames().get(ident)
            if frame is not None:
                stack = "".join(traceback.format_stack(frame, limit=20))
        record_violation(
            "loop_stall",
            getattr(getattr(elt, "_thread", None), "name", "io-loop"),
            f"event loop did not run a scheduled heartbeat for "
            f"{waited:.1f}s — a blocking call is squatting the loop",
            stacks=[stack] if stack else None,
        )


_watchdog = _LoopWatchdog()


def watch_event_loop_thread(elt) -> None:
    """Register an EventLoopThread-shaped object (``.loop``, ``._thread``)
    with the watchdog. No-op unless sanitizing."""
    if _ENABLED:
        _watchdog.register(elt)


# --------------------------------------------------------------------------
# Thread-affinity assertions
# --------------------------------------------------------------------------
def assert_loop_affinity(tag: str, loop) -> None:
    """Record a violation when the caller is NOT running on ``loop`` —
    for structures documented as loop-only (the rpc outbox)."""
    if not _ENABLED or loop is None:
        return
    import asyncio

    running = asyncio._get_running_loop()
    if running is not loop:
        record_violation(
            "affinity", tag,
            f"touched from thread {threading.current_thread().name!r} "
            f"(running loop: {running!r}) but documented loop-only",
            stacks=["".join(traceback.format_stack(limit=12))],
        )


def assert_thread_affinity(tag: str, thread_ident: Optional[int]) -> None:
    """Record a violation when the caller is not the expected thread."""
    if not _ENABLED or thread_ident is None:
        return
    if threading.get_ident() != thread_ident:
        record_violation(
            "affinity", tag,
            f"touched from thread {threading.current_thread().name!r} "
            f"but pinned to thread id {thread_ident}",
            stacks=["".join(traceback.format_stack(limit=12))],
        )


def report() -> str:
    """Human-readable multi-line summary (conftest terminal summary)."""
    counts = violation_counts()
    if not counts:
        return "sanitizers: 0 violations"
    lines = ["sanitizers: " + ", ".join(
        f"{k}={v}" for k, v in sorted(counts.items()))]
    for v in violations()[:10]:
        lines.append(f"  [{v['kind']}] {v['name']}: {v['detail']}")
        for s in v["stacks"][:2]:
            lines.extend("    " + ln for ln in s.splitlines()[-6:])
    return "\n".join(lines)

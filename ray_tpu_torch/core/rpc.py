"""Asyncio RPC: length-prefixed frames over TCP, with server push.

The port's copy of ray_tpu/core/rpc.py: the same wire format (v2), batching,
out-of-band buffers, protocol-version preamble and auth token (read from
``RAY_TPU_TOKEN`` at import, but never exported: see set_auth_token), the
lock/loop sanitizers, the process-wide wire counters mirrored into the
metrics registry, and ``rpc.flush`` profile spans. The chaos injection
points are cut with the chaos plane.

Role parity: src/ray/rpc/ (GrpcServer/ClientCall). A fresh design rather than
gRPC: the control plane is Python end-to-end here, so a compact asyncio framing
with pipelined request/response and subscription push keeps latency low without
protobuf codegen. The wire format is private to the framework.

Wire format (v2):

    [8-byte LE frame length][u32 nbuf][u64 size]*nbuf [pickled msg][buffers]

The pickled message is ``(msg_type, msg_id, method, payload)``; msg_type:
0=request, 1=response, 2=error, 3=push (server-initiated, msg_id is
subscription id), 4=batch (payload is a list of request tuples sharing one
frame). Buffers are the frame's out-of-band segment table: pickle
protocol-5 ``PickleBuffer``s at least ``rpc_oob_threshold_bytes`` large
(``Oob``-wrapped byte payloads, numpy arrays) are written directly from
their source memory and mapped as zero-copy views over the frame body on
receive — mirroring ``core/serialization.py``'s in-band/out-of-band split,
one copy saved per hop in each direction.

Sending is coalesced: ``_send`` appends to a per-connection outbox that a
single flusher task drains once per loop tick (or immediately past
``rpc_max_coalesce_bytes``) with one gather-write + one ``drain()``.
``rpc_max_outstanding_bytes`` of un-flushed bytes block producers
(backpressure). Sockets run with ``TCP_NODELAY`` — batching is explicit in
the outbox, not implicit in Nagle.
"""

from __future__ import annotations

import asyncio
import hmac
import itertools
import logging
import os
import pickle
import socket as _socket
import struct
import threading
import time
import traceback
from collections import deque
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.config import _config

logger = logging.getLogger(__name__)

REQUEST, RESPONSE, ERROR, PUSH, BATCH = 0, 1, 2, 3, 4
_MAX_FRAME = 1 << 34  # 16 GiB guard

# --------------------------------------------------------------------------
# Cluster auth: a per-session shared secret. Frames are pickled, so an
# unauthenticated peer that can reach any daemon port gets arbitrary code
# execution — the handshake is table stakes (advisor finding r1/r2). The
# dialing side of a connection trusts the address it chose and sends the
# token as its first frame; the accepting side dispatches nothing until a
# valid token arrives. Set via RAY_TPU_TOKEN (cluster start generates one
# and passes it to every daemon/worker through the environment).
# --------------------------------------------------------------------------
# Wire-protocol revision. The preamble doubles as the version handshake
# (reference analog: the protobuf schema rev in src/ray/protobuf/ — here the
# frames are pickled, so cross-version compatibility is gated explicitly):
# bump PROTOCOL_VERSION whenever the frame format or a message's payload
# contract changes incompatibly. A peer with a different rev is rejected
# with a logged reason instead of failing deep inside unpickling.
#
# v1 → v2: frames grew the out-of-band segment table and the BATCH message
# type; every peer of a session must speak v2 (restart all daemons/drivers
# together — there is no mixed-rev operation).
PROTOCOL_VERSION = 2
_AUTH_PREFIX = b"RAYTPU-AUTH"
_AUTH_MAGIC = _AUTH_PREFIX + str(PROTOCOL_VERSION).encode() + b" "
_auth_token: Optional[str] = os.environ.get("RAY_TPU_TOKEN") or None

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


def set_auth_token(token: Optional[str]) -> None:
    """This process's cluster token. Unlike the reference's, it is not
    exported into ``os.environ``: ray_tpu's daemons take their token from
    the environment they inherit, so a port cluster started beside a
    reference cluster in one process would hand the reference's next
    daemons the port's token. The port passes its token to its own daemons
    explicitly (cluster_backend.daemon_env)."""
    global _auth_token
    _auth_token = token or None


def get_auth_token() -> Optional[str]:
    return _auth_token


def _auth_frame_payload() -> bytes:
    return _AUTH_MAGIC + (_auth_token or "").encode()


class RpcError(Exception):
    pass


class RemoteCallError(RpcError):
    """The handler on the far side raised; carries its traceback string."""

    def __init__(self, method, cls_name, tb):
        self.method, self.cls_name, self.tb = method, cls_name, tb
        super().__init__(f"rpc {method} failed with {cls_name}\n{tb}")


class ConnectionLost(RpcError):
    pass


# --------------------------------------------------------------------------
# Zero-copy frame encoding
# --------------------------------------------------------------------------
class Oob:
    """Marks a byte buffer for out-of-band transport in a frame.

    Wrap large ``bytes``/``memoryview`` payloads (serialized objects, spec
    blobs, shm contents) in ``Oob`` before putting them in an RPC payload:
    the frame encoder then writes them straight from their source buffer
    via the v2 segment table instead of copying them into the pickle
    stream, and the receiver gets a zero-copy ``memoryview`` over the frame
    body. Unwrap with :func:`unwrap_oob`. ``keepalive`` pins a resource
    (e.g. an mmap'd shm buffer) until the frame is written and released.
    """

    __slots__ = ("data", "keepalive")

    def __init__(self, data, keepalive=None):
        self.data = data
        self.keepalive = keepalive

    def raw(self):
        return self.data

    def __reduce_ex__(self, protocol):
        if protocol >= 5:
            return (Oob, (pickle.PickleBuffer(self.data),))
        return (Oob, (bytes(self.data),))


def unwrap_oob(x):
    """Payload value → underlying buffer (bytes/memoryview), Oob-transparent."""
    return x.data if isinstance(x, Oob) else x


def _encode_frame(msg) -> Tuple[List[Any], int, int]:
    """Encode one message into v2 wire chunks.

    Returns ``(chunks, nbytes, oob_bytes)``: ``chunks[0]`` holds the length
    header + segment table + pickled payload; remaining chunks are the raw
    out-of-band buffers, written directly from their source memory.
    """
    bufs: List[Any] = []
    limit = _config.rpc_oob_threshold_bytes

    def cb(pb: pickle.PickleBuffer):
        raw = pb.raw()
        if raw.nbytes < limit:
            return True  # keep small buffers in-band
        bufs.append(raw)
        return False

    try:
        payload = pickle.dumps(msg, protocol=5, buffer_callback=cb)
    except Exception:  # noqa: BLE001 - closures/local classes in payloads
        del bufs[:]
        import cloudpickle

        payload = cloudpickle.dumps(msg, protocol=5, buffer_callback=cb)
    oob = sum(b.nbytes for b in bufs)
    body_len = 4 + 8 * len(bufs) + len(payload) + oob
    head = bytearray(12 + 8 * len(bufs))
    _U64.pack_into(head, 0, body_len)
    _U32.pack_into(head, 8, len(bufs))
    off = 12
    for b in bufs:
        _U64.pack_into(head, off, b.nbytes)
        off += 8
    chunks: List[Any] = [bytes(head) + payload]
    chunks.extend(bufs)
    return chunks, 8 + body_len, oob


def encode_frame_bytes(msg) -> bytes:
    """One message as a single contiguous wire frame (tests, raw sockets)."""
    chunks, _, _ = _encode_frame(msg)
    return b"".join(
        c if isinstance(c, (bytes, bytearray)) else bytes(c) for c in chunks
    )


def advance_chunks(chunks: List[Any], sent: int) -> List[Any]:
    """Drop ``sent`` bytes from the front of a chunk list — the resume point
    after a partial gather-write. The partially-written chunk comes back as
    a memoryview sliced at the exact byte offset, so a retry continues
    mid-frame without duplicating or skipping bytes (frame-boundary
    integrity under partial ``sendmsg``/``writev``)."""
    for i, c in enumerate(chunks):
        mv = c if isinstance(c, memoryview) else memoryview(c)
        if mv.format != "B" or mv.ndim != 1:
            mv = mv.cast("B")
        n = mv.nbytes
        if sent >= n:
            sent -= n
            continue
        rest = [mv[sent:] if sent else mv]
        rest.extend(chunks[i + 1:])
        return rest
    return []


_IOV_CAP = 1024  # conservative IOV_MAX bound for one sendmsg call


def _decode_body(body) -> Any:
    """Parse a v2 frame body. Out-of-band buffers come back as zero-copy
    memoryviews over ``body`` (numpy arrays reconstruct over them)."""
    mv = memoryview(body)
    nbuf = _U32.unpack_from(mv, 0)[0]
    if 12 + 8 * nbuf > mv.nbytes + 8:
        raise RpcError(f"corrupt frame: segment table of {nbuf} entries")
    off = 4
    sizes = []
    for _ in range(nbuf):
        sizes.append(_U64.unpack_from(mv, off)[0])
        off += 8
    tail = sum(sizes)
    end = mv.nbytes - tail
    if end < off:
        raise RpcError("corrupt frame: segment table exceeds frame body")
    payload = mv[off:end]
    buffers = []
    p = end
    for s in sizes:
        buffers.append(mv[p:p + s])
        p += s
    return pickle.loads(payload, buffers=buffers)


async def _read_frame(reader: asyncio.StreamReader):
    header = await reader.readexactly(8)
    n = int.from_bytes(header, "little")
    if n > _MAX_FRAME:
        raise RpcError(f"frame too large: {n}")
    body = await reader.readexactly(n)
    return _decode_body(body)


def _tune_socket(writer: asyncio.StreamWriter) -> None:
    """TCP_NODELAY: coalescing is explicit (the outbox), never Nagle's."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except (OSError, ValueError):
            pass


# process-wide aggregates across all connections (per-connection numbers
# live on Connection.stats); surfaced through get_metrics
_STAT_KEYS = (
    "rpc_frames_sent", "rpc_bytes_sent", "rpc_frames_coalesced",
    "rpc_oob_bytes", "rpc_flushes", "rpc_frames_recv",
)
_TOTALS: Dict[str, int] = {k: 0 for k in _STAT_KEYS}


def stats_snapshot() -> Dict[str, int]:
    """Process-wide RPC wire counters (sum over all connections)."""
    return dict(_TOTALS)


_PUBLISHED: Dict[str, int] = {}
_STAT_HELP = {
    "rpc_frames_sent": "frames written to the wire",
    "rpc_bytes_sent": "bytes written to the wire",
    "rpc_frames_coalesced": "frames that shared a gather-write",
    "rpc_oob_bytes": "bytes sent via out-of-band segment tables",
    "rpc_flushes": "outbox gather-writes",
    "rpc_frames_recv": "frames read from the wire",
}


def publish_wire_counters() -> None:
    """Mirror this process's rpc_* wire totals into the metrics registry as
    real Counters, so the periodic registry flush carries them to the GCS
    and they AGGREGATE cluster-wide (fixing the summarize_metrics caveat
    that dispatch-plane telemetry was only visible from the calling driver).
    Delta-based: safe to call from any flush loop, any number of times."""
    from ray_tpu_torch.util import metrics as metrics_api

    for k, v in stats_snapshot().items():
        prev = _PUBLISHED.get(k, 0)
        if v > prev:
            metrics_api.Counter(k, description=_STAT_HELP.get(k, "")).inc(
                v - prev
            )
            _PUBLISHED[k] = v


_tracing_mod = None


def _tracing():
    # lazy: ray_tpu_torch.tracing imports during package init would cycle
    global _tracing_mod
    if _tracing_mod is None:
        from ray_tpu_torch import tracing

        _tracing_mod = tracing
    return _tracing_mod


class Connection:
    """One bidirectional connection: concurrent requests + pushes both ways."""

    def __init__(self, reader, writer, handler=None, on_close=None, name="",
                 trusted: bool = True):
        self.reader = reader
        self.writer = writer
        self.handler = handler  # object with async handle_<method>(**payload)
        self.on_close = on_close
        self.name = name
        # inbound trust: dialed-out connections trust their chosen peer;
        # accepted connections read a first-frame auth preamble (and require
        # the session token when one is configured)
        self._accepted = not trusted
        self._next_id = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._push_handlers: Dict[str, Callable] = {}
        self._closed = False
        self._reader_task: Optional[asyncio.Task] = None
        # strong refs to in-flight dispatch tasks (create_task results are
        # otherwise GC-able mid-flight — a classic asyncio footgun)
        self._bg_tasks: set = set()
        # ---- coalesced send path ----
        self._outbox: List[Any] = []      # wire chunks awaiting one flush
        self._outbox_bytes = 0
        self._outbox_frames = 0
        self._staged: List[tuple] = []    # requests staged for a BATCH frame
        self._flush_handle = None         # scheduled call_soon/call_later
        self._flusher: Optional[asyncio.Task] = None
        # adaptive coalescing: EWMA of wire frames per flush. A connection
        # that keeps putting many frames into each gather-write is a bulk
        # path (reply fan-in, pipelined pushes) — it trades a bounded delay
        # (rpc_adaptive_coalesce_max_ms) for even bigger writes; a
        # request-response connection (EWMA ~1) keeps flushing on the next
        # loop tick so its round-trip latency never pays the window.
        self._flush_ewma = 0.0
        self._flushed_waiters: deque = deque()  # backpressure parks here
        self._enqueue_lock = asyncio.Lock()     # FIFO enqueue order
        self._loop: Optional[asyncio.AbstractEventLoop] = None  # set in start()
        self.stats: Dict[str, int] = {k: 0 for k in _STAT_KEYS}

    def _spawn(self, coro):
        t = asyncio.create_task(coro)
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return t

    def start(self):
        self._loop = asyncio.get_running_loop()
        self._reader_task = asyncio.create_task(self._read_loop())
        return self

    @property
    def peername(self) -> str:
        try:
            return str(self.writer.get_extra_info("peername"))
        except Exception:  # noqa: BLE001
            return "?"

    async def call(self, method: str, timeout: Optional[float] = None, **payload):
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed")
        fut = await self.call_start(method, **payload)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError as e:
            raise RpcError(f"rpc {method} timed out after {timeout}s") from e

    async def call_start(self, method: str, **payload) -> asyncio.Future:
        """Enqueue the request frame now, return the response future
        unawaited.

        Pipelined senders (actor call windows) need the ENQUEUE to happen at
        a controlled point — frames on one TCP connection deliver in enqueue
        order — while responses are awaited concurrently. `call` = await
        `call_start`.
        """
        return await self._start_request(method, payload, batched=False)

    async def call_start_batched(self, method: str, **payload) -> asyncio.Future:
        """Like ``call_start``, but the request may share one BATCH frame
        with other batched requests staged in the same loop tick (multi-spec
        frames: one pickle header + one length prefix for the whole group).
        FIFO order against all other sends on this connection is kept."""
        return await self._start_request(method, payload, batched=True)

    async def call_batched(self, method: str, timeout: Optional[float] = None,
                           **payload):
        fut = await self.call_start_batched(method, **payload)
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError as e:
            raise RpcError(f"rpc {method} timed out after {timeout}s") from e

    async def _start_request(self, method, payload, batched) -> asyncio.Future:
        if self._closed:
            raise ConnectionLost(f"connection {self.name} closed")
        msg_id = next(self._next_id)
        loop = self._loop or asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending[msg_id] = fut
        fut.add_done_callback(lambda f: self._pending.pop(msg_id, None))
        msg = (REQUEST, msg_id, method, payload)
        try:
            await self._enqueue(msg, staged=batched)
        except ConnectionLost:
            if fut.done():
                fut.exception()  # consume, the raise below carries the error
            else:
                self._pending.pop(msg_id, None)
            raise
        return fut

    async def notify(self, method: str, **payload):
        """One-way message (no response expected)."""
        await self._send((REQUEST, 0, method, payload))

    async def notify_batched(self, method: str, **payload):
        """One-way message that may share a BATCH frame (hot push paths)."""
        await self._enqueue((REQUEST, 0, method, payload), staged=True)

    async def push(self, channel: str, payload: Any):
        await self._send((PUSH, 0, channel, payload))

    def on_push(self, channel: str, fn: Callable[[Any], Any]):
        self._push_handlers[channel] = fn

    def off_push(self, channel: str) -> None:
        """Remove a channel's push handler (pairs with on_push; callers must
        not reach into _push_handlers)."""
        self._push_handlers.pop(channel, None)

    # ------------------------------------------------------- coalesced send
    async def _send(self, msg):
        await self._enqueue(msg)

    async def _enqueue(self, msg, staged: bool = False):
        """Append one frame (or stage one batched request) in strict FIFO
        order, blocking while the un-flushed outbox exceeds the
        backpressure bound."""
        async with self._enqueue_lock:
            if self._closed:
                raise ConnectionLost(f"connection {self.name} closed")
            limit = max(1 << 16, _config.rpc_max_outstanding_bytes)
            while self._outbox_bytes >= limit and not self._closed:
                fut = (self._loop or asyncio.get_running_loop()).create_future()
                self._flushed_waiters.append(fut)
                self._schedule_flush(immediate=True)
                await fut
            if self._closed:
                raise ConnectionLost(f"connection {self.name} closed")
            if staged:
                self._staged.append(msg)
            else:
                self._append_frame(msg)
            self._schedule_flush()

    def _append_encoded(self, msg) -> None:
        # the outbox and its byte counters are loop-only state: appends
        # interleave only at await points (the flusher's empty-check
        # depends on it) — a cross-thread append would corrupt framing
        _san.assert_loop_affinity("rpc.Connection.outbox", self._loop)
        chunks, nbytes, oob = _encode_frame(msg)
        self._outbox.extend(chunks)
        self._outbox_bytes += nbytes
        self._outbox_frames += 1
        st = self.stats
        st["rpc_frames_sent"] += 1
        st["rpc_bytes_sent"] += nbytes
        st["rpc_oob_bytes"] += oob
        _TOTALS["rpc_frames_sent"] += 1
        _TOTALS["rpc_bytes_sent"] += nbytes
        _TOTALS["rpc_oob_bytes"] += oob

    def _append_frame(self, msg) -> None:
        # staged batched requests always drain BEFORE a directly-sent frame
        # so enqueue order == wire order across both paths
        self._drain_staged()
        self._append_encoded(msg)

    def _drain_staged(self) -> None:
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        if len(staged) == 1:
            self._append_staged_one(staged[0])
            return
        try:
            self._append_encoded((BATCH, 0, "", staged))
        except Exception:  # noqa: BLE001 - one poisoned payload
            # must not sink its co-staged peers (or the unrelated caller
            # whose direct send triggered this drain): encode each message
            # alone so only the bad one fails, typed, on ITS future
            for m in staged:
                self._append_staged_one(m)
            return
        self.stats["rpc_frames_coalesced"] += len(staged) - 1
        _TOTALS["rpc_frames_coalesced"] += len(staged) - 1

    def _append_staged_one(self, msg) -> None:
        """Encode one staged message; an encode failure (unpicklable
        payload, non-contiguous buffer) fails the message's own response
        future instead of hanging it — staged sends have left their
        caller's try block by flush time."""
        try:
            self._append_encoded(msg)
        except Exception as e:  # noqa: BLE001
            fut = self._pending.get(msg[1])
            if fut is not None and not fut.done():
                fut.set_exception(
                    RpcError(f"cannot encode {msg[2]!r} frame: {e!r}")
                )
            else:  # notify (msg_id 0): best-effort, drop with a trace
                logger.exception(
                    "dropping unencodable staged %r frame on %s",
                    msg[2], self.name,
                )

    def _schedule_flush(self, immediate: bool = False) -> None:
        if self._closed:
            return
        if not immediate and self._outbox_bytes >= max(
                1, _config.rpc_max_coalesce_bytes):
            immediate = True
        if immediate:
            if self._flush_handle is not None:
                self._flush_handle.cancel()
                self._flush_handle = None
            self._ensure_flusher()
            return
        if self._flush_handle is None:
            loop = self._loop or asyncio.get_running_loop()
            delay = self._coalesce_delay_s()
            if delay > 0:
                self._flush_handle = loop.call_later(delay, self._on_flush_timer)
            else:
                self._flush_handle = loop.call_soon(self._on_flush_timer)

    def _coalesce_delay_s(self) -> float:
        """Per-connection gather window before the scheduled flush:
        the configured floor, stretched to rpc_adaptive_coalesce_max_ms
        while this connection's recent flushes ran busy (EWMA frames/flush
        over rpc_adaptive_coalesce_min_frames)."""
        delay = _config.rpc_coalesce_delay_ms / 1000.0
        if (_config.rpc_adaptive_coalesce
                and self._flush_ewma >= _config.rpc_adaptive_coalesce_min_frames):
            delay = max(delay, _config.rpc_adaptive_coalesce_max_ms / 1000.0)
        return delay

    def _on_flush_timer(self) -> None:
        self._flush_handle = None
        self._ensure_flusher()

    def _ensure_flusher(self) -> None:
        if self._flusher is None or self._flusher.done():
            self._flusher = self._spawn(self._flush_outbox())

    def _wake_flushed(self) -> None:
        while self._flushed_waiters:
            fut = self._flushed_waiters.popleft()
            if not fut.done():
                fut.set_result(None)

    @staticmethod
    def _send_vectored(writer: asyncio.StreamWriter, chunks: List[Any]):
        """Write as much of ``chunks`` as the kernel will take with vectored
        ``socket.sendmsg`` calls (one syscall per gather instead of one
        transport ``write()`` copy per chunk); returns the unsent remainder
        for the transport fallback. Only runs while the transport's write
        buffer is EMPTY — bytes queued there must reach the wire first, so
        a partial flush falls back instead of reordering."""
        sock = writer.get_extra_info("socket")
        transport = getattr(writer, "transport", None)
        # asyncio hands back a TransportSocket wrapper: its sendmsg is
        # deprecated on 3.10 and REMOVED on 3.11+, so operate on the raw
        # socket underneath — falling back to the transport write path
        # whenever no usable raw socket is exposed
        sock = getattr(sock, "_sock", sock)
        if (sock is None or transport is None
                or not hasattr(sock, "sendmsg")):
            return chunks
        while chunks:
            try:
                if transport.get_write_buffer_size() > 0:
                    return chunks
            except (AttributeError, RuntimeError):
                return chunks
            try:
                sent = sock.sendmsg(chunks[:_IOV_CAP] if len(chunks) > _IOV_CAP
                                    else chunks)
            except (BlockingIOError, InterruptedError):
                return chunks  # kernel buffer full: let drain() wait it out
            if sent <= 0:
                return chunks
            chunks = advance_chunks(chunks, sent)
        return chunks

    async def _flush_outbox(self):
        """Single flusher per connection: one gather-write + one drain per
        batch of queued frames. Loops until the outbox is empty (appends
        only interleave at await points, so the empty-check is race-free)."""
        while not self._closed:
            self._drain_staged()
            if not self._outbox:
                return
            chunks = self._outbox
            nbytes, nframes = self._outbox_bytes, self._outbox_frames
            self._outbox, self._outbox_bytes, self._outbox_frames = [], 0, 0
            # busy-ness signal for the adaptive gather window (wire frames
            # per flush; BATCH frames count once — they are already one
            # gather-write, so batched submit paths never read as busy)
            self._flush_ewma = 0.75 * self._flush_ewma + 0.25 * nframes
            self._wake_flushed()
            t0 = time.perf_counter()
            try:
                writer = self.writer
                # vectored fast path: one sendmsg gather-write per syscall
                # straight on the socket while the transport has nothing
                # buffered (FIFO safety); whatever the kernel would not
                # take resumes — mid-chunk — through the transport
                chunks = self._send_vectored(writer, chunks)
                for c in chunks:
                    writer.write(c)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError, RuntimeError,
                    OSError) as e:
                logger.debug("flush failed on %s: %s", self.name, e)
                await self._handle_close()
                return
            self.stats["rpc_flushes"] += 1
            _TOTALS["rpc_flushes"] += 1
            if nframes > 1:
                self.stats["rpc_frames_coalesced"] += nframes - 1
                _TOTALS["rpc_frames_coalesced"] += nframes - 1
            dur = time.perf_counter() - t0
            if dur >= 0.001:
                # batching stalls (slow peer, huge batch) show up in
                # ray_tpu_torch.timeline() instead of hiding in the io loop
                try:
                    buf = _tracing().get_buffer()
                    if buf.enabled():
                        buf.record_profile(
                            "rpc.flush", dur=dur, component="rpc",
                            args={"frames": nframes, "nbytes": nbytes,
                                  "conn": self.name},
                        )
                except Exception:  # noqa: BLE001 - stats must not break io
                    pass

    # ------------------------------------------------------------- receive
    async def _read_loop(self):
        try:
            if self._accepted:
                if not await self._accept_first_frame():
                    return  # finally: close
            while True:
                msg = await _read_frame(self.reader)
                self.stats["rpc_frames_recv"] += 1
                _TOTALS["rpc_frames_recv"] += 1
                self._process(*msg)
                # drop the decoded message BEFORE parking on the next read:
                # payloads now carry live objects (TaskSpecs with ObjectRefs,
                # zero-copy views), and a ref held across an idle wait pins
                # them — and every distributed free behind them — until the
                # next frame happens to arrive
                del msg
        except (
            asyncio.IncompleteReadError,
            ConnectionResetError,
            BrokenPipeError,
            asyncio.CancelledError,
            asyncio.TimeoutError,
        ):
            pass
        except Exception:  # noqa: BLE001
            logger.exception("rpc read loop error on %s", self.name)
        finally:
            await self._handle_close()

    async def _accept_first_frame(self) -> bool:
        """Server side of the auth handshake. The first frame from a dialing
        peer is read RAW and checked for the auth preamble before anything is
        unpickled — unpickling attacker bytes IS the code-exec vector the
        handshake exists to close. Timeout-bounded so an idle unauthenticated
        socket can't hold a server slot forever. Returns False to reject."""
        header = await asyncio.wait_for(self.reader.readexactly(8), timeout=15)
        n = int.from_bytes(header, "little")
        if n <= 0 or n > _MAX_FRAME:
            return False
        data = await asyncio.wait_for(self.reader.readexactly(n), timeout=60)
        if data.startswith(_AUTH_PREFIX) and not data.startswith(_AUTH_MAGIC):
            # right framework, wrong protocol rev: say so loudly — the
            # alternative is an opaque unpickling failure later
            sep = data.find(b" ", 0, 32)  # bounded: never echo frame bytes
            theirs = data[len(_AUTH_PREFIX):sep] if sep != -1 else b"?"
            logger.warning(
                "protocol version mismatch on %s from %s: peer speaks rev "
                "%s, this node speaks rev %d; closing",
                self.name, self.peername, theirs.decode("ascii", "replace"),
                PROTOCOL_VERSION,
            )
            return False
        if data.startswith(_AUTH_MAGIC):
            if _auth_token is not None and not hmac.compare_digest(
                    data, _auth_frame_payload()):
                logger.warning(
                    "bad auth token on %s from %s; closing",
                    self.name, self.peername,
                )
                return False
            return True  # preamble consumed (token-less servers accept any)
        if _auth_token is not None:
            logger.warning(
                "unauthenticated connection on %s from %s; closing",
                self.name, self.peername,
            )
            return False
        # v2 requires the version-carrying preamble even without a token:
        # a bare first frame is a v1-era (or foreign) peer — reject with a
        # clear reason instead of failing deep inside the v2 frame parser.
        logger.warning(
            "peer on %s from %s sent no protocol preamble (pre-v%d frame?); "
            "closing — every peer of a session must speak wire rev %d",
            self.name, self.peername, PROTOCOL_VERSION, PROTOCOL_VERSION,
        )
        return False

    def _process(self, msg_type, msg_id, method, payload):
        if msg_type == REQUEST:
            self._spawn(self._dispatch(msg_id, method, payload))
        elif msg_type == BATCH:
            # one frame, many requests: dispatch each in list order (the
            # sender staged them FIFO, receivers must observe that order)
            for sub in payload:
                self._process(*sub)
        elif msg_type == RESPONSE:
            fut = self._pending.get(msg_id)
            if fut and not fut.done():
                fut.set_result(payload)
        elif msg_type == ERROR:
            fut = self._pending.get(msg_id)
            if fut and not fut.done():
                fut.set_exception(
                    RemoteCallError(method, payload["cls"], payload["tb"])
                )
        elif msg_type == PUSH:
            fn = self._push_handlers.get(method)
            if fn:
                res = fn(payload)
                if asyncio.iscoroutine(res):
                    self._spawn(res)

    async def _dispatch(self, msg_id, method, payload):
        try:
            fn = getattr(self.handler, f"handle_{method}", None)
            if fn is None:
                raise RpcError(f"no handler for {method!r} on {self.handler}")
            result = fn(self, **payload)
            if asyncio.iscoroutine(result) or isinstance(result, Awaitable):
                result = await result
            if msg_id:
                await self._send((RESPONSE, msg_id, method, result))
        except ConnectionLost:
            pass
        except Exception as e:  # noqa: BLE001
            if msg_id:
                try:
                    await self._send(
                        (
                            ERROR,
                            msg_id,
                            method,
                            {"cls": type(e).__name__, "tb": traceback.format_exc()},
                        )
                    )
                except ConnectionLost:
                    pass
            else:
                logger.exception("error in one-way handler %s", method)

    async def _handle_close(self):
        if self._closed:
            return
        self._closed = True
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        # frames still in the outbox/stage never reach the wire: their
        # pending response futures fail right here with the typed,
        # retryable ConnectionLost (submitters map it to WorkerCrashedError)
        self._outbox, self._outbox_bytes, self._outbox_frames = [], 0, 0
        self._staged = []
        self._wake_flushed()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost(f"connection {self.name} lost"))
        self._pending.clear()
        try:
            self.writer.close()
        except Exception:  # noqa: BLE001
            pass
        if self.on_close:
            res = self.on_close(self)
            if asyncio.iscoroutine(res):
                await res

    async def close(self):
        # best-effort final flush so frames enqueued just before a graceful
        # close (unsubscribes, last notifies) still reach the wire
        if not self._closed and (self._outbox or self._staged):
            try:
                self._drain_staged()
                self._ensure_flusher()
                if self._flusher is not None:
                    await asyncio.wait_for(asyncio.shield(self._flusher), 1.0)
            except Exception:  # noqa: BLE001
                pass
        if self._reader_task:
            self._reader_task.cancel()
        await self._handle_close()

    @property
    def closed(self):
        return self._closed


class RpcServer:
    """TCP server dispatching to a handler object (async handle_<method>)."""

    def __init__(self, handler, host="127.0.0.1", port=0):
        self.handler = handler
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set = set()

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def _on_connect(self, reader, writer):
        _tune_socket(writer)
        conn = Connection(
            reader,
            writer,
            handler=self.handler,
            on_close=self._on_conn_close,
            name=f"server<-{writer.get_extra_info('peername')}",
            trusted=False,
        ).start()
        self.connections.add(conn)
        cb = getattr(self.handler, "on_connection", None)
        if cb:
            res = cb(conn)
            if asyncio.iscoroutine(res):
                await res

    def _on_conn_close(self, conn):
        self.connections.discard(conn)
        cb = getattr(self.handler, "on_disconnection", None)
        if cb:
            return cb(conn)

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    async def close(self):
        for conn in list(self.connections):
            await conn.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()


async def connect(
    address: str, handler=None, name: str = "", retries: int = 30,
    retry_delay: float = 0.1,
) -> Connection:
    host, port_s = address.rsplit(":", 1)
    last_err = None
    for _ in range(retries):
        try:
            reader, writer = await asyncio.open_connection(host, int(port_s))
            _tune_socket(writer)
            # always send the preamble (empty token when none configured):
            # uniform first frame regardless of auth config, so mismatches
            # fail at the auth gate with a clear log, not as UnpicklingError
            payload = _auth_frame_payload()
            writer.write(len(payload).to_bytes(8, "little") + payload)
            await writer.drain()
            return Connection(reader, writer, handler=handler, name=name).start()
        except (ConnectionRefusedError, OSError) as e:
            last_err = e
            await asyncio.sleep(retry_delay)
    raise ConnectionLost(f"cannot connect to {address}: {last_err}")


class EventLoopThread:
    """A dedicated asyncio loop thread (drivers/workers embed the RPC plane
    next to user code, like the CoreWorker's io_service thread)."""

    def __init__(self, name="ray-tpu-io"):
        self.loop = asyncio.new_event_loop()
        # spawn_batched state: queued (fn, args) pairs + a dirty flag so a
        # burst of cross-thread submissions costs ONE self-pipe wake
        self._calls: list = []
        self._calls_lock = _san.make_lock("rpc.io_calls")
        self._calls_scheduled = False
        self._held_tasks: set = set()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()
        # dev-mode: the io-loop watchdog records a violation (with the
        # loop thread's live stack) if this loop stops running callbacks
        _san.watch_event_loop_thread(self)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout: Optional[float] = None):
        """Run a coroutine on the loop from a foreign thread, blocking."""
        if threading.get_ident() == self._thread.ident:
            # blocking on our own loop can never complete; fail loudly
            # instead of deadlocking the whole process (reachable via GC
            # running a __del__ on the loop thread)
            coro.close()
            raise RuntimeError(
                "EventLoopThread.run() called from the loop thread itself"
            )
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def spawn(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def call_batched(self, fn, *args) -> None:
        """Fire-and-forget `fn(*args)` on the loop (`fn` may also be a bare
        coroutine object, scheduled as a task). Unlike call_soon_threadsafe
        — one self-pipe write (a ~50us syscall on slow-syscall kernels) PER
        CALL — a burst of these from user threads pays one wake: only the
        empty->nonempty queue transition writes to the self-pipe; the drain
        callback runs everything queued since. FIFO order across
        call_batched calls is preserved."""
        with self._calls_lock:
            self._calls.append((fn, args))
            wake = not self._calls_scheduled
            self._calls_scheduled = True
        if wake:
            try:
                self.loop.call_soon_threadsafe(self._drain_calls)
            except RuntimeError:     # loop closed (shutdown): drop, like
                self._close_queued()  # call_soon_threadsafe callers do

    def _close_queued(self) -> None:
        with self._calls_lock:
            batch, self._calls = self._calls, []
            self._calls_scheduled = False
        for fn, _ in batch:
            if asyncio.iscoroutine(fn):
                fn.close()  # silence "never awaited" at interpreter exit

    def _drain_calls(self) -> None:
        # loop-only: ensure_future below binds tasks to THIS loop; running
        # it anywhere else would strand them on a foreign loop
        _san.assert_thread_affinity("rpc.EventLoopThread._drain_calls",
                                    self._thread.ident)
        with self._calls_lock:
            batch, self._calls = self._calls, []
            self._calls_scheduled = False
        for fn, args in batch:
            try:
                if asyncio.iscoroutine(fn):
                    self._hold_task(asyncio.ensure_future(fn))
                    continue
                res = fn(*args)
                if asyncio.iscoroutine(res):
                    self._hold_task(asyncio.ensure_future(res))
            except Exception:  # noqa: BLE001 - one bad call must not
                logger.exception("call_batched callback failed")  # drop rest

    def _hold_task(self, t: "asyncio.Task") -> None:
        # strong ref until done: a bare ensure_future result is GC-able
        # mid-flight (same footgun Connection._spawn guards against) — a
        # collected _submit_and_track would hang its ray.get forever
        self._held_tasks.add(t)
        t.add_done_callback(self._held_tasks.discard)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5)

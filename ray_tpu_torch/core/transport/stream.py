"""Seq-framed, credit-gated stream connections between worker processes.

One stream carries ONE channel's messages from one writer process to one
reader process (SPSC, matching the compiled-graph channel discipline). The
reader side binds a per-process :class:`StreamListener` (one TCP port per
process, shared by every channel it reads) and registers a
:class:`ReaderState` per channel; the writer dials the advertised
``(host, port)`` and authenticates. Threads + blocking sockets, not asyncio:
channel read/write is called from actor dispatch threads that block by
design, and keeping the transport off the rpc io-loop means a saturated
data stream can never starve control-plane traffic.

Handshake (writer → listener, one text line, nothing is unpickled from an
unauthenticated peer)::

    RTSTREAM1 <session_token|-> <channel_id> <channel_token>\\n

reply ``OK <initial_credits>\\n`` or ``ERR <reason>\\n``. Both the cluster
session token (``rpc.get_auth_token()``) and the per-channel token minted by
the channel's creator must match.

Frames after the handshake (binary, little-endian)::

    DATA   [u8=1][u64 seq][u32 plen][u32 nbuf][u64 size]*nbuf payload bufs…
    CREDIT [u8=2][u64 n]          (reader → writer)
    CLOSE  [u8=3][u64 0]          (either direction, graceful)

Flow control is credit-based: the reader's handshake reply grants
``max_msgs`` initial credits, each DATA frame consumes one, and the reader
returns one credit only when the consumer has DECODED the message
(``recv_obj``) — so ``max_msgs`` bounds end-to-end unconsumed messages
exactly like a shm ring's ``max_in_flight``, across the wire. Every DATA
frame carries a monotonically increasing ``seq``; a gap severs the stream
(typed error) rather than silently misaligning a pipeline.

Large payload buffers (numpy arrays etc., split out-of-band by
:func:`dumps_oob`) are never concatenated: the writer sends them straight
from their source memory (vectored ``sendmsg``), and the reader lands them
in a spool file in the node's tmpfs shm directory, received directly into
the file's mmap — so a zero-copy consumer reads the payload as views over
node-local shared memory, same as a local shm-ring channel.

An EOF or socket error WITHOUT a prior CLOSE frame marks the stream severed
(``StreamSeveredError``); a CLOSE frame marks it closed
(``StreamClosedError``), and buffered messages still deliver before the
closed state surfaces — the same closed-on-empty rule the shm ring uses.

The port's copy of ray_tpu/core/transport/stream.py, the same wire format
(a reference writer and a port reader speak to each other). It reads the
port's ``rpc.get_auth_token()``; its locks are the reference's named
sanitizer locks. In the port its one user is the object plane's chunked
pull (object_store/chunk_transfer.py); the compiled graphs' channels come
with cgraph.
"""

from __future__ import annotations

import hmac
import logging
import mmap
import os
import pickle
import re
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.analysis import sanitizers as _san
from ray_tpu_torch.core.config import _config

logger = logging.getLogger(__name__)

MAGIC = b"RTSTREAM1"
DATA, CREDIT, CLOSE = 1, 2, 3
_HDR = struct.Struct("<BQ")          # frame type + seq/credits
_DATA_HDR = struct.Struct("<II")     # payload len + buffer count
_U64 = struct.Struct("<Q")
_MAX_LINE = 512
_MAX_PAYLOAD = 1 << 31
_MAX_BUFS = 1 << 16
_MAX_BUF_BYTES = 1 << 34             # 16 GiB guard, matches rpc._MAX_FRAME

# buffers at least this large are split out-of-band by dumps_oob (written
# from source memory, landed in the reader's shm spool)
OOB_MIN = 1 << 12


class TransportError(exc.RayTpuError):
    """Base for stream-transport failures."""


class StreamSeveredError(TransportError):
    """The stream's connection was lost while the channel was open
    (network cut, peer process death, seq gap). Recoverable by
    re-materializing the channel — never a silent hang."""


class StreamAuthError(StreamSeveredError):
    """The listener rejected the handshake (bad session/channel token)."""


class StreamClosedError(TransportError):
    """The peer closed the stream gracefully (teardown)."""


class StreamTimeoutError(exc.GetTimeoutError):
    """A stream operation did not complete within its timeout."""


def dumps_oob(obj: Any) -> Tuple[bytes, List[Any]]:
    """Pickle ``obj`` splitting large buffers out-of-band.

    Returns ``(payload, bufs)``: the in-band pickle stream plus the raw
    source buffers (numpy data, bytes) at least :data:`OOB_MIN` large, to be
    transported without ever being concatenated into one blob. Shared by the
    shm ring channel and the stream transport so both planes split
    identically."""
    bufs: List[Any] = []

    def cb(pb: pickle.PickleBuffer):
        try:
            raw = pb.raw()
        except BufferError:  # non-contiguous: keep in-band
            return True
        if raw.nbytes < OOB_MIN:
            return True
        bufs.append(raw)
        return False

    try:
        return pickle.dumps(obj, protocol=5, buffer_callback=cb), bufs
    except Exception:  # noqa: BLE001 - closures, local classes
        del bufs[:]
        import cloudpickle

        return cloudpickle.dumps(obj, protocol=5, buffer_callback=cb), bufs


# ------------------------------------------------------------ socket helpers
def _shutdown_close(sock: socket.socket) -> None:
    """shutdown(2) BEFORE close: a bare close() while another thread is
    blocked in recv on the same fd defers the real teardown (the in-flight
    syscall pins the file), so the peer would never see EOF. shutdown sends
    the FIN immediately and wakes the blocked recv."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r
    return bytes(buf)


def _recv_into_exact(sock: socket.socket, view: memoryview) -> None:
    got = 0
    n = view.nbytes
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError("peer closed mid-frame")
        got += r


def _sendall_vectored(sock: socket.socket, chunks: List[Any]) -> None:
    """One gather-write per syscall where the OS allows: large out-of-band
    buffers go straight from their source memory, never concatenated."""
    from ray_tpu_torch.core.rpc import advance_chunks

    views = [
        c if isinstance(c, memoryview) else memoryview(c) for c in chunks
    ]
    views = [v.cast("B") if v.format != "B" or v.ndim != 1 else v
             for v in views]
    if not hasattr(sock, "sendmsg"):
        for v in views:
            sock.sendall(v)
        return
    while views:
        sent = sock.sendmsg(views[:1024])
        views = advance_chunks(views, sent)


# ---------------------------------------------------------------- reader side
class _Msg:
    __slots__ = ("seq", "payload", "sizes", "spool_path", "spool_mm",
                 "spool_f")

    def __init__(self, seq, payload, sizes, spool_path=None, spool_mm=None,
                 spool_f=None):
        self.seq = seq
        self.payload = payload
        self.sizes = sizes
        self.spool_path = spool_path
        self.spool_mm = spool_mm
        self.spool_f = spool_f

    def release(self) -> None:
        """Close + unlink the spool file (mmap views taken over it survive
        via refcount until the consumer drops them, POSIX unlink rules)."""
        for closer in (self.spool_mm, self.spool_f):
            try:
                if closer is not None:
                    closer.close()
            except (BufferError, OSError):
                pass
        if self.spool_path:
            try:
                os.unlink(self.spool_path)
            except OSError:
                pass
        self.spool_mm = self.spool_f = self.spool_path = None


class ReaderState:
    """Receiving end of one channel's stream: registered with the process
    listener, fed by the connection's recv thread, drained by the consumer
    through :meth:`recv_obj`."""

    def __init__(self, channel_id: str, token: str, max_msgs: int,
                 spool_dir: str):
        self.channel_id = channel_id
        self.token = token
        self.max_msgs = max(1, int(max_msgs))
        self.spool_dir = spool_dir
        self._cond = _san.make_condition("transport.reader")
        self._q: deque = deque()
        self._conn: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._ended: Optional[Tuple[str, str]] = None  # ("closed"|"severed", why)
        self._next_seq = 0
        self._held: Optional[_Msg] = None  # zero-copy: released at next recv
        self._spool_counter = 0

    # -------------------------------------------------- listener-side plumbing
    def attach(self, sock: socket.socket) -> bool:
        """Bind the accepted (authenticated) connection; one writer at a
        time — a second dial while the first is live is rejected."""
        with self._cond:
            if self._ended is not None:
                return False
            if self._conn is not None:
                return False
            self._conn = sock
        return True

    def run_recv_loop(self, sock: socket.socket) -> None:
        """Parse frames until CLOSE/EOF/error (runs on the listener's
        per-connection thread)."""
        try:
            while True:
                head = _recv_exact(sock, _HDR.size)
                ftype, arg = _HDR.unpack(head)
                if ftype == CLOSE:
                    self._end("closed", "peer closed")
                    return
                if ftype != DATA:
                    self._end("severed", f"unexpected frame type {ftype}")
                    return
                self._recv_data(sock, arg)
        except (ConnectionError, OSError, ValueError) as e:
            self._end("severed", f"connection lost mid-stream ({e})")
        finally:
            _shutdown_close(sock)

    def _recv_data(self, sock: socket.socket, seq: int) -> None:
        plen, nbuf = _DATA_HDR.unpack(_recv_exact(sock, _DATA_HDR.size))
        if plen > _MAX_PAYLOAD or nbuf > _MAX_BUFS:
            raise ValueError(f"oversized frame (plen={plen}, nbuf={nbuf})")
        sizes = [
            _U64.unpack(_recv_exact(sock, 8))[0] for _ in range(nbuf)
        ]
        if sum(sizes) > _MAX_BUF_BYTES:
            raise ValueError("oversized segment table")
        if seq != self._next_seq:
            raise ValueError(
                f"stream seq gap: expected {self._next_seq}, got {seq}"
            )
        self._next_seq += 1
        payload = _recv_exact(sock, plen)
        msg = _Msg(seq, payload, sizes)
        if nbuf:
            # land the out-of-band buffers straight in this node's shm dir:
            # recv_into the file's mmap, so a zero-copy consumer reads them
            # as views over node-local tmpfs with no extra copy
            os.makedirs(self.spool_dir, exist_ok=True)
            self._spool_counter += 1
            # pid-tagged name: the raylet's session sweep reclaims spool
            # files whose reader process died without releasing them
            # (SIGKILL mid-read) — see sweep_spool_dir()
            path = os.path.join(
                self.spool_dir,
                f"p{os.getpid()}_{self.channel_id}_{self._spool_counter}",
            )
            total = sum(sizes)
            f = open(path, "w+b")
            f.truncate(max(total, 1))
            mm = mmap.mmap(f.fileno(), max(total, 1))
            off = 0
            for s in sizes:
                _recv_into_exact(sock, memoryview(mm)[off:off + s])
                off += s
            msg.spool_path, msg.spool_mm, msg.spool_f = path, mm, f
        with self._cond:
            self._q.append(msg)
            self._cond.notify_all()

    def _end(self, kind: str, why: str) -> None:
        with self._cond:
            if self._ended is None:
                self._ended = (kind, why)
            conn, self._conn = self._conn, None
            self._cond.notify_all()
        if conn is not None:
            _shutdown_close(conn)

    # -------------------------------------------------------- consumer side
    @property
    def closed(self) -> bool:
        return self._ended is not None

    def recv_obj(self, timeout: Optional[float] = None,
                 zero_copy: bool = False) -> Any:
        """Pop + decode the next message; grants the writer one credit.

        Buffered messages deliver even after close/sever (closed-on-empty
        rule). With ``zero_copy``, out-of-band numpy payloads come back as
        READ-ONLY views over the spool mmap, valid until the NEXT
        ``recv_obj`` on this channel."""
        if self._held is not None:
            self._held.release()
            self._held = None
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._q:
                if self._ended is not None:
                    kind, why = self._ended
                    if kind == "closed":
                        raise StreamClosedError(
                            f"stream {self.channel_id} closed ({why})"
                        )
                    raise StreamSeveredError(
                        f"stream {self.channel_id} severed ({why})"
                    )
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise StreamTimeoutError(
                        f"stream {self.channel_id} read timed out"
                    )
                self._cond.wait(
                    0.2 if remaining is None else min(remaining, 0.2)
                )
            msg = self._q.popleft()
        obj = self._decode(msg, zero_copy)
        self._grant_credit()
        return obj

    def _decode(self, msg: _Msg, zero_copy: bool) -> Any:
        if not msg.sizes:
            return pickle.loads(msg.payload)
        mv = memoryview(msg.spool_mm)
        buffers: List[Any] = []
        off = 0
        if zero_copy:
            for s in msg.sizes:
                buffers.append(mv[off:off + s].toreadonly())
                off += s
            obj = pickle.loads(msg.payload, buffers=buffers)
            self._held = msg  # spool lives until the next recv_obj
        else:
            for s in msg.sizes:
                # bytearray, not bytes: copied-out numpy arrays stay
                # writable, matching the shm ring's copy mode
                buffers.append(bytearray(mv[off:off + s]))
                off += s
            obj = pickle.loads(msg.payload, buffers=buffers)
            del mv
            msg.release()
        return obj

    def _grant_credit(self, n: int = 1) -> None:
        with self._send_lock:
            conn = self._conn
            if conn is None:
                return
            try:
                conn.sendall(_HDR.pack(CREDIT, n))
            except OSError:
                pass  # recv loop will surface the connection loss

    def close(self) -> None:
        """Graceful consumer-side close: tell the writer, drop buffers."""
        with self._send_lock:
            conn = self._conn
            if conn is not None:
                try:
                    conn.sendall(_HDR.pack(CLOSE, 0))
                except OSError:
                    pass
        self._end("closed", "reader closed")
        self._drop_buffers()

    def sever(self, why: str = "severed") -> None:
        """Abrupt consumer-side kill WITHOUT a CLOSE frame: the writer
        observes a mid-stream connection loss (typed severed, not a
        graceful close) — used when the consuming loop itself died of a
        sever, so peers classify the failure correctly."""
        self._end("severed", why)
        self._drop_buffers()

    def _drop_buffers(self) -> None:
        with self._cond:
            pending = list(self._q)
            self._q.clear()
        for m in pending:
            m.release()
        if self._held is not None:
            self._held.release()
            self._held = None


# ---------------------------------------------------------------- writer side
class WriterState:
    """Sending end of one channel's stream (created by
    :func:`connect_writer`): serializes, waits for credits, gather-writes."""

    def __init__(self, sock: socket.socket, channel_id: str, credits: int):
        self.channel_id = channel_id
        self._sock = sock
        self._cond = _san.make_condition("transport.writer")
        self._credits = credits
        self._seq = 0
        self._ended: Optional[Tuple[str, str]] = None
        self._send_lock = threading.Lock()
        self._recv_thread = threading.Thread(
            target=self._recv_loop, name=f"rt-stream-w-{channel_id[:12]}",
            daemon=True,
        )
        self._recv_thread.start()

    def _recv_loop(self) -> None:
        try:
            while True:
                head = _recv_exact(self._sock, _HDR.size)
                ftype, arg = _HDR.unpack(head)
                if ftype == CREDIT:
                    with self._cond:
                        self._credits += arg
                        self._cond.notify_all()
                elif ftype == CLOSE:
                    self._end("closed", "peer closed")
                    return
                else:
                    self._end("severed", f"unexpected frame type {ftype}")
                    return
        except (ConnectionError, OSError, ValueError) as e:
            self._end("severed", f"connection lost mid-stream ({e})")

    def _end(self, kind: str, why: str) -> None:
        with self._cond:
            if self._ended is None:
                self._ended = (kind, why)
            self._cond.notify_all()
        _shutdown_close(self._sock)

    def _check_ended(self) -> None:
        if self._ended is not None:
            kind, why = self._ended
            if kind == "closed":
                raise StreamClosedError(
                    f"stream {self.channel_id} closed ({why})"
                )
            raise StreamSeveredError(
                f"stream {self.channel_id} severed ({why})"
            )

    @property
    def closed(self) -> bool:
        return self._ended is not None

    def send_obj(self, obj: Any,
                 timeout: Optional[float] = None) -> Tuple[int, float]:
        """Serialize + send one message slot; blocks while the reader owes
        no credits (``max_msgs`` unconsumed messages are already in flight).
        Returns ``(bytes_sent, credit_stall_seconds)``."""
        payload, bufs = dumps_oob(obj)
        return self.send_frame(payload, bufs, timeout=timeout)

    def send_frame(self, payload: bytes, bufs: List[Any],
                   timeout: Optional[float] = None) -> Tuple[int, float]:
        """Send one pre-serialized DATA frame (payload + out-of-band
        buffers written straight from their source memory). The raw-frame
        twin of :meth:`send_obj` — the object-plane chunk protocol rides
        this with a struct header payload and the chunk's mmap slice as
        the single buffer, skipping pickle entirely."""
        bufs = [b if isinstance(b, memoryview) else memoryview(b)
                for b in bufs]
        deadline = None if timeout is None else time.monotonic() + timeout
        stall = 0.0
        with self._cond:
            while self._credits <= 0:
                self._check_ended()
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise StreamTimeoutError(
                        f"stream {self.channel_id} write timed out awaiting "
                        "credits (max_in_flight messages unconsumed)"
                    )
                t0 = time.monotonic()
                self._cond.wait(
                    0.2 if remaining is None else min(remaining, 0.2)
                )
                stall += time.monotonic() - t0
            self._check_ended()
            self._credits -= 1
        head = bytearray(_HDR.size + _DATA_HDR.size + 8 * len(bufs))
        _HDR.pack_into(head, 0, DATA, self._seq)
        _DATA_HDR.pack_into(head, _HDR.size, len(payload), len(bufs))
        off = _HDR.size + _DATA_HDR.size
        for b in bufs:
            _U64.pack_into(head, off, b.nbytes)
            off += 8
        nbytes = len(head) + len(payload) + sum(b.nbytes for b in bufs)
        with self._send_lock:
            self._check_ended()
            try:
                _sendall_vectored(self._sock, [head, payload, *bufs])
            except (OSError, socket.timeout) as e:
                self._end("severed", f"send failed ({e})")
                self._check_ended()
            self._seq += 1
        return nbytes, stall

    def close(self) -> None:
        """Graceful close: CLOSE frame, then drop the socket."""
        with self._send_lock:
            if self._ended is None:
                try:
                    self._sock.sendall(_HDR.pack(CLOSE, 0))
                except OSError:
                    pass
        self._end("closed", "writer closed")

    def sever(self, why: str = "severed") -> None:
        """Abrupt kill of the connection WITHOUT a CLOSE frame — the peer
        observes a mid-stream connection loss (chaos ``channel.send``)."""
        self._end("severed", why)


def connect_writer(host: str, port: int, channel_id: str, token: str,
                   session_token: Optional[str] = None,
                   timeout: Optional[float] = None) -> WriterState:
    """Dial a reader's listener, authenticate, return the writer handle."""
    timeout = timeout if timeout is not None else \
        _config.transport_connect_timeout_s
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
    except OSError as e:
        raise StreamSeveredError(
            f"cannot connect stream {channel_id} to {host}:{port}: {e}"
        ) from e
    try:
        sock.settimeout(timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        stoken = session_token if session_token is not None else \
            _session_token()
        line = b" ".join(
            (MAGIC, (stoken or "-").encode(), channel_id.encode(),
             token.encode())
        ) + b"\n"
        sock.sendall(line)
        reply = _read_line(sock)
        if reply.startswith(b"OK "):
            credits = int(reply.split()[1])
            sock.settimeout(_config.transport_io_timeout_s)
            return WriterState(sock, channel_id, credits)
        reason = reply[4:].decode("ascii", "replace").strip() or "rejected"
        if "auth" in reason:
            raise StreamAuthError(
                f"stream {channel_id} handshake rejected: {reason}"
            )
        raise StreamSeveredError(
            f"stream {channel_id} handshake rejected: {reason}"
        )
    except socket.timeout as e:
        sock.close()
        raise StreamTimeoutError(
            f"stream {channel_id} handshake timed out"
        ) from e
    except TransportError:
        sock.close()
        raise
    except (ConnectionError, OSError, ValueError, IndexError) as e:
        sock.close()
        raise StreamSeveredError(
            f"stream {channel_id} handshake failed: {e}"
        ) from e


def _read_line(sock: socket.socket) -> bytes:
    out = bytearray()
    while not out.endswith(b"\n"):
        b = sock.recv(1)
        if not b:
            raise ConnectionError("peer closed during handshake")
        out += b
        if len(out) > _MAX_LINE:
            raise ValueError("handshake line too long")
    return bytes(out)


def _session_token() -> Optional[str]:
    from ray_tpu_torch.core import rpc

    return rpc.get_auth_token()


# ------------------------------------------------------------------- listener
class StreamListener:
    """Per-process accept loop: one TCP port serving every channel this
    process reads. Channels register a :class:`ReaderState`; writers dial
    and are routed to it by the authenticated handshake."""

    def __init__(self, host: Optional[str] = None):
        self.host = host or _config.transport_bind_host
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, 0))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._readers: Dict[str, ReaderState] = {}
        self._lock = _san.make_lock("transport.listener")
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="rt-stream-listener", daemon=True
        )
        self._thread.start()

    @property
    def advertise_host(self) -> str:
        """Host peers should DIAL for this listener. Resolution order:
        ``transport_advertise_host`` (explicit multi-host config) → the
        bound host when it is a real address → loopback. (The reference
        also takes a node default that its compiled-graph channels set;
        they are not ported.)"""
        if _config.transport_advertise_host:
            return _config.transport_advertise_host
        if self.host not in ("0.0.0.0", ""):
            return self.host
        return "127.0.0.1"

    def register(self, reader: ReaderState) -> Tuple[str, int]:
        with self._lock:
            self._readers[reader.channel_id] = reader
        return self.advertise_host, self.port

    def deregister(self, channel_id: str) -> None:
        with self._lock:
            self._readers.pop(channel_id, None)

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(sock,),
                name="rt-stream-conn", daemon=True,
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            sock.settimeout(15.0)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            line = _read_line(sock)
            parts = line.strip().split(b" ")
            if len(parts) != 4 or parts[0] != MAGIC:
                self._reject(sock, "bad handshake")
                return
            stoken = parts[1].decode("ascii", "replace")
            cid = parts[2].decode("ascii", "replace")
            ctoken = parts[3].decode("ascii", "replace")
            expected = _session_token()
            if expected is not None and not hmac.compare_digest(
                    stoken, expected):
                self._reject(sock, "auth (bad session token)")
                return
            with self._lock:
                reader = self._readers.get(cid)
            if reader is None:
                self._reject(sock, f"unknown channel {cid}")
                return
            if not hmac.compare_digest(ctoken, reader.token):
                self._reject(sock, "auth (bad channel token)")
                return
            if not reader.attach(sock):
                self._reject(sock, "busy (channel already has a writer)")
                return
            sock.sendall(b"OK %d\n" % reader.max_msgs)
            sock.settimeout(_config.transport_io_timeout_s)
            reader.run_recv_loop(sock)
        except (ConnectionError, OSError, ValueError, socket.timeout):
            _shutdown_close(sock)

    def _reject(self, sock: socket.socket, reason: str) -> None:
        logger.warning(
            "stream listener on :%d rejected a connection: %s",
            self.port, reason,
        )
        try:
            sock.sendall(b"ERR " + reason.encode() + b"\n")
        except OSError:
            pass
        _shutdown_close(sock)

    def close(self) -> None:
        self._closed = True
        _shutdown_close(self._sock)  # also wakes the blocked accept()


_listener: Optional[StreamListener] = None
_listener_lock = _san.make_lock("transport.listener_registry")


def get_listener() -> StreamListener:
    """The process-wide listener (lazily bound on first reader attach)."""
    global _listener
    with _listener_lock:
        if _listener is None or _listener._closed:
            _listener = StreamListener()
        return _listener


# ------------------------------------------------------------- spool hygiene
_SPOOL_PID_RE = re.compile(r"^p(\d+)_")


def sweep_spool_dir(path: str, min_age_s: float = 30.0) -> int:
    """Reclaim spool files whose reader process is gone.

    Spool files (`p<pid>_<channel>_<n>`) are unlinked by the reader when
    the message is released — but a SIGKILLed reader leaves them pinned in
    the tmpfs session dir until session teardown. The raylet calls this on
    its periodic session sweep: a file whose embedded pid is no longer
    alive is deleted; files older than 10 minutes are reclaimed regardless
    (legacy names / pid reuse backstop). ``min_age_s`` protects files a
    live reader just created. Returns the number of files removed."""
    removed = 0
    try:
        names = os.listdir(path)
    except OSError:
        return 0
    now = time.time()
    for name in names:
        p = os.path.join(path, name)
        try:
            st = os.stat(p)
        except OSError:
            continue
        age = now - st.st_mtime
        if age < min_age_s:
            continue
        m = _SPOOL_PID_RE.match(name)
        if m is not None:
            pid = int(m.group(1))
            try:
                os.kill(pid, 0)
                alive = True
            except ProcessLookupError:
                alive = False
            except PermissionError:
                alive = True
            if alive and age < 600.0:
                continue
        elif age < 600.0:
            continue  # un-tagged (pre-sweep) file: age out only
        try:
            os.unlink(p)
            removed += 1
        except OSError:
            pass
    if removed:
        logger.info("reclaimed %d orphaned spool file(s) under %s",
                    removed, path)
    return removed

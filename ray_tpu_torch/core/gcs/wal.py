"""GCS write-ahead log: crash-consistent durability for the head plane.

Parity: the reference GCS survives restarts through a Redis-backed
store_client (src/ray/gcs/store_client/) that persists every table mutation
before the RPC reply. File-backed equivalent here: each durable-table
mutation appends ONE framed record to the active WAL segment *inside the
handler* — i.e. before the rpc plane can send the acknowledgement — so a
SIGKILL at any instant loses at most mutations whose callers never saw a
reply. Restore = newest snapshot + replay of every record with a sequence
number past the snapshot's.

Record framing (binary, torn-tail tolerant):

    <u32 length> <u32 crc32(payload)> <payload = pickle((seq, op, data))>

A crash mid-write leaves a short or CRC-failing final record; the reader
stops there and keeps the intact prefix (the PR-8 task-event WAL pattern,
binary instead of JSON lines because KV values and actor spec blobs are
arbitrary bytes).

Segments + compaction: the writer appends to one segment file named
``<base>.<first_seq:012d>.seg``. Compaction rotates to a fresh segment
FIRST, then snapshots the full tables (carrying ``wal_seq`` = the last
sequence of the old segment), then prunes every segment whose records the
snapshot covers. Every replayed op is an idempotent state *set* (never an
increment), so a snapshot capturing a few post-rotate mutations and then
replaying them again converges to the same state. Crash windows:

* after rotate, before snapshot replace → old snapshot + both segments
  replay (old segment's seqs are past the old snapshot's wal_seq);
* after replace, before prune → stale segment replays as no-ops (its seqs
  are <= the new snapshot's wal_seq and are skipped).

The port's copy of ray_tpu/core/gcs/wal.py without its chaos injection
point.
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.core.config import _config

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<II")
_SEG_SUFFIX = ".seg"


def _segment_path(base: str, first_seq: int) -> str:
    return f"{base}.{first_seq:012d}{_SEG_SUFFIX}"


def list_segments(base: str) -> List[Tuple[int, str]]:
    """Existing ``(first_seq, path)`` segments of ``base``, oldest first."""
    d = os.path.dirname(base) or "."
    prefix = os.path.basename(base) + "."
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if not (name.startswith(prefix) and name.endswith(_SEG_SUFFIX)):
            continue
        body = name[len(prefix):-len(_SEG_SUFFIX)]
        if body.isdigit():
            out.append((int(body), os.path.join(d, name)))
    out.sort()
    return out


def _scan_segment(path: str) -> Tuple[List[Tuple[int, str, dict]], int]:
    """Decode one segment's intact record prefix as ``(seq, op, data)``
    tuples, plus the byte offset that prefix ends at. Tolerates the torn
    final record a SIGKILL mid-append leaves (short header, short payload,
    or CRC mismatch): the tail is dropped, everything before it is kept."""
    out: List[Tuple[int, str, dict]] = []
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return out, 0
    off = 0
    while off + _HEADER.size <= len(blob):
        length, crc = _HEADER.unpack_from(blob, off)
        start = off + _HEADER.size
        end = start + length
        if end > len(blob):
            break  # torn tail: record was being written at the crash
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            # torn/overwritten tail (or corruption): stop at the last
            # intact record — records are strictly append-ordered, so
            # nothing after a bad frame can be trusted
            break
        try:
            seq, op, data = pickle.loads(payload)
        except Exception:  # noqa: BLE001 - defensive: treat as torn
            break
        out.append((int(seq), str(op), data))
        off = end
    return out, off


def read_segment(path: str) -> List[Tuple[int, str, dict]]:
    """The intact record prefix of one segment (see _scan_segment)."""
    return _scan_segment(path)[0]


def replay(base: str, after_seq: int = 0) -> Iterator[Tuple[int, str, dict]]:
    """Yield every durable record with ``seq > after_seq`` across all
    segments of ``base``, oldest first."""
    for _, path in list_segments(base):
        for seq, op, data in read_segment(path):
            if seq > after_seq:
                yield seq, op, data


class GcsWal:
    """Append side of the log. One instance per GCS process; ``append``
    runs inline in the mutating handler (event-loop thread), so the record
    is in the kernel's page cache before the handler returns and the reply
    frame is even queued."""

    def __init__(self, base: str):
        self.base = base
        self.seq = 0             # last appended (or replayed) sequence
        self._fd: Optional[int] = None
        self._segment_start = 0  # first seq of the active segment
        self._segment_bytes = 0
        self._poisoned = False   # a failed append left irreparable garbage
        self._m_records = None
        self._m_bytes = None

    # ------------------------------------------------------------ lifecycle
    def open(self, start_seq: int) -> None:
        """Start appending after ``start_seq`` (the max of the snapshot's
        wal_seq and any replayed record). Appends continue into the newest
        existing segment when one is already on disk (a restart without
        compaction), else a fresh segment starts at ``start_seq + 1``."""
        self.seq = start_seq
        segs = list_segments(self.base)
        if segs:
            first, path = segs[-1]
            self._segment_start = first
            # a previous kill mid-append leaves a torn tail; replay dropped
            # it, so TRUNCATE it before appending — records written after
            # surviving garbage would be unreachable to every future replay
            _, intact = _scan_segment(path)
            try:
                size = os.path.getsize(path)
                if intact < size:
                    fd = os.open(path, os.O_WRONLY)
                    try:
                        os.ftruncate(fd, intact)
                    finally:
                        os.close(fd)
                    logger.warning(
                        "WAL %s: truncated torn tail (%d -> %d bytes)",
                        path, size, intact,
                    )
                self._segment_bytes = intact
            except OSError:
                self._segment_bytes = 0
        else:
            self._segment_start = start_seq + 1
            path = _segment_path(self.base, self._segment_start)
            self._segment_bytes = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    # -------------------------------------------------------------- append
    def _observe(self, nbytes: int) -> None:
        if not _config.metrics_enabled:
            return
        if self._m_records is None:
            from ray_tpu_torch.util.metrics import Counter

            self._m_records = Counter(
                "gcs_wal_records_total",
                "durable-table mutations appended to the GCS WAL",
            )
            self._m_bytes = Counter(
                "gcs_wal_bytes_total", "bytes appended to the GCS WAL"
            )
        self._m_records.inc(1.0)
        self._m_bytes.inc(float(nbytes))

    def append(self, op: str, data: Dict[str, Any]) -> int:
        """Durably log one mutation; returns its sequence number. MUST be
        called by the mutating handler before it returns (the reply to the
        caller is the acknowledgement the log backs). Raises on a failed
        or unrepairable write — the handler then errors and the mutation
        is never acknowledged, which is the contract's safe side."""
        if self._fd is None:
            return self.seq
        if self._poisoned:
            raise OSError(
                "GCS WAL poisoned by an earlier unrepairable append failure"
            )
        seq = self.seq + 1
        payload = pickle.dumps((seq, op, data),
                               protocol=pickle.HIGHEST_PROTOCOL)
        rec = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        try:
            # write-all loop: a short write (ENOSPC mid-record,
            # RLIMIT_FSIZE) must not leave a partial frame acked-around —
            # replay stops at the first bad frame, so garbage mid-file
            # makes every LATER acknowledged record unreachable
            mv = memoryview(rec)
            while mv:
                n = os.write(self._fd, mv)
                mv = mv[n:]
        except OSError:
            # roll the segment back to the last intact record so later
            # appends land clean; if even that fails, poison the log —
            # acking mutations written behind garbage would lose them
            try:
                os.ftruncate(self._fd, self._segment_bytes)
            except OSError:
                self._poisoned = True
                logger.exception(
                    "GCS WAL: failed append could not be rolled back; "
                    "refusing further appends"
                )
            raise
        self.seq = seq
        if _config.gcs_wal_fsync:
            os.fsync(self._fd)
        self._segment_bytes += len(rec)
        self._observe(len(rec))
        return self.seq

    # ---------------------------------------------------------- compaction
    def size(self) -> int:
        return self._segment_bytes

    def rotate(self) -> int:
        """Seal the active segment and open a fresh one; returns the last
        sequence the sealed segment covers (the snapshot's ``wal_seq``)."""
        sealed_seq = self.seq
        self.close()
        self._segment_start = self.seq + 1
        path = _segment_path(self.base, self._segment_start)
        self._fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self._segment_bytes = 0
        return sealed_seq

    def prune(self, covered_seq: int) -> int:
        """Delete sealed segments the snapshot now covers (first_seq <=
        covered_seq; the active segment always starts past it)."""
        n = 0
        for first, path in list_segments(self.base):
            if first <= covered_seq and first != self._segment_start:
                try:
                    os.unlink(path)
                    n += 1
                except OSError:
                    pass
        return n

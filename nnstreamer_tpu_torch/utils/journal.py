"""nns-armor: durable request journal (write-ahead log) for the query
front door (docs/ROBUSTNESS.md).

Port of ``nnstreamer_tpu/utils/journal.py``, copied whole: the same
record layout, so either package replays the other's journal.

Without a journal an ACCEPTED request dies silently with the
process.  This module closes that hole: the serversrc appends every
accepted request's wire payload to a segment-rotated, CRC'd journal
BEFORE the pipeline sees it, the serversink acknowledges the entry when
the answer leaves (the answered-offset watermark), and a restarted
pipeline (``Pipeline(journal_replay=True)``) re-admits exactly the
unanswered entries — seqno-deduped, so a double restart never
double-processes an already-answered request.

Record layout (little-endian, one stream of records per segment file):

    u32 magic ("JREQ" requests / "JACK" acks) | u64 seqno
    | u32 payload_len | u32 crc32(payload) | payload

Ack records carry no payload (len 0, crc of ``b""``).  Segments rotate
at ``segment_bytes``; fully-acknowledged segments are deleted at
rotation (the GC), so steady-state disk usage is bounded by the
unanswered window plus one segment.

Torn-tail policy (the crash-consistency contract the property test
pins): a record that fails its magic/length/CRC check ends the segment —
everything before it is recovered, everything from it on is dropped.  A
SIGKILL mid-append can only tear the LAST record of the LAST segment,
so no fully-CRC'd entry is ever lost and no torn bytes are ever
replayed.

fsync policy (``fsync=off|batch|always``):

* ``off``    — never fsync; durability = the OS page cache (survives a
  process kill, not a host power cut).
* ``batch``  — appends/acks are buffered writes; a background flusher
  thread fsyncs every ``batch_interval_s`` (with an inline
  ``batch_every`` backstop so a burst can never grow the loss window
  unboundedly).  The bounded-loss default: the fsync is OFF the
  request path, which is what keeps the journal-overhead A/B's p50
  delta under its 3% target.
* ``always`` — fsync every append before returning (survives power
  loss; pays one fsync per request).

Everything here is host-side file I/O, no device work.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from ..core.log import logger, metrics
from . import locks

log = logger(__name__)

MAGIC_REQ = 0x4A524551  # "JREQ"
MAGIC_ACK = 0x4A41434B  # "JACK"

_REC_FMT = "<IQII"
_REC_SIZE = struct.calcsize(_REC_FMT)

FSYNC_MODES = ("off", "batch", "always")

_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def pack_record(magic: int, seqno: int, payload: bytes = b"") -> bytes:
    return struct.pack(_REC_FMT, magic, seqno, len(payload),
                       _crc(payload)) + payload


def _segments(path: str) -> List[str]:
    try:
        names = os.listdir(path)
    except FileNotFoundError:
        return []
    segs = [n for n in names
            if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)]
    return [os.path.join(path, n) for n in sorted(segs)]


def _scan_segment(path: str) -> Tuple[List[Tuple[int, int, bytes]], int]:
    """Parse one segment file.  Returns ``(records, torn_bytes)`` where
    each record is ``(magic, seqno, payload)``; parsing stops at the
    first record whose header/length/CRC does not check out (the torn
    tail), with ``torn_bytes`` the dropped byte count."""
    with open(path, "rb") as f:
        raw = f.read()
    out: List[Tuple[int, int, bytes]] = []
    off = 0
    n = len(raw)
    while off + _REC_SIZE <= n:
        magic, seqno, plen, crc = struct.unpack_from(_REC_FMT, raw, off)
        if magic not in (MAGIC_REQ, MAGIC_ACK):
            break
        body_off = off + _REC_SIZE
        if body_off + plen > n:
            break  # truncated payload: torn tail
        payload = raw[body_off:body_off + plen]
        if _crc(payload) != crc:
            break  # corrupt payload: torn tail
        out.append((magic, seqno, payload))
        off = body_off + plen
    return out, n - off


class Journal:
    """Append-only request journal over a directory of rotated segments.

    One writer (the serversrc reader threads serialize on the lock), any
    number of out-of-band readers (:func:`replay_unanswered` reads the
    files directly — the yank_process soak inspects a killed server's
    journal this way)."""

    #: nns-tsan lock discipline (lint --threads verifies statically,
    #: NNS_TPU_TSAN=1 verifies live — docs/ANALYSIS.md "Threads pass")
    _GUARDED_BY = {
        "_file": "_lock", "_file_bytes": "_lock", "_seg_index": "_lock",
        "_unsynced": "_lock", "_live_unacked": "_lock",
        "_seg_seqnos": "_lock", "_cur_seqnos": "_lock",
        "_next_seq": "_lock",
    }

    def __init__(self, path: str, *, fsync: str = "batch",
                 segment_bytes: int = 8 << 20, batch_every: int = 256,
                 batch_interval_s: float = 0.05):
        if fsync not in FSYNC_MODES:
            raise ValueError(
                f"journal fsync must be one of {FSYNC_MODES}, got "
                f"{fsync!r}")
        self.path = path
        self.fsync = fsync
        self.segment_bytes = max(1 << 12, int(segment_bytes))
        self.batch_every = max(1, int(batch_every))
        self.batch_interval_s = max(0.001, float(batch_interval_s))
        os.makedirs(path, exist_ok=True)
        self._lock = locks.make_lock("Journal._lock")
        self._stop_flush = threading.Event()
        self._kick = threading.Event()  # batch_every backstop wakeup
        self._flusher: Optional[threading.Thread] = None
        self._file = None
        self._file_bytes = 0
        self._seg_index = 0
        self._unsynced = 0
        #: seqnos appended (REQ) into the CURRENT process's segments and
        #: not yet acked — the live watermark mirror (replay rebuilds
        #: the on-disk truth; this set only drives GC decisions)
        self._live_unacked: set = set()
        #: per-segment seqnos, for GC at rotation
        self._seg_seqnos: Dict[str, set] = {}
        # resume appending AFTER any existing segments (a replayed
        # journal keeps its history until acked + GC'd)
        #: the recovery SNAPSHOT: ``(seqno, payload)`` of every entry
        #: that was accepted-but-unanswered when this Journal opened.
        #: Replay consumers read THIS, not a later directory re-scan —
        #: anything accepted after open (e.g. a reconnected client's
        #: resend, once the server is listening again) is a new entry
        #: and must never be replayed on top of its own admission.
        #: Consumers should clear it once staged (the serversrc does):
        #: a large unanswered window's payload bytes must not stay
        #: pinned for the journal's whole lifetime.
        self.recovered_unanswered: List[Tuple[int, bytes]] = []
        existing = _segments(path)
        if existing:
            last = os.path.basename(existing[-1])
            self._seg_index = int(
                last[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]) + 1
            state = scan(path)
            self._next_seq = state.max_seqno + 1
            self._live_unacked = set(state.unanswered)
            self.recovered_unanswered = [
                (s, state.requests[s]) for s in state.unanswered]
        else:
            self._next_seq = 1
        self._open_segment()
        if self.fsync == "batch":
            # the fsync lives on THIS thread, off the request path: an
            # append is a buffered write, durability follows within
            # batch_interval_s (the bounded-loss contract)
            self._flusher = threading.Thread(
                target=self._flush_loop, name="nns-journal-flush",
                daemon=True)
            self._flusher.start()

    def _flush_loop(self) -> None:
        while True:
            self._kick.wait(self.batch_interval_s)
            self._kick.clear()
            if self._stop_flush.is_set():
                return
            with self._lock:
                if self._file is None or not self._unsynced:
                    continue
                # flush (userspace) under the lock, fsync OUTSIDE it: a
                # multi-ms fsync holding the lock would stall every
                # append colliding with it — exactly the latency the
                # batch mode exists to keep off the request path
                self._file.flush()
                self._unsynced = 0
                fd = self._file.fileno()
            try:
                os.fsync(fd)
            except OSError:
                pass  # racing a rotation: the next tick covers it

    # -- write path --------------------------------------------------------
    def _seg_path(self, index: int) -> str:
        return os.path.join(self.path,
                            f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}")

    def _open_segment(self) -> None:
        p = self._seg_path(self._seg_index)
        self._file = open(p, "ab")
        self._file_bytes = self._file.tell()
        # the CURRENT segment's seqno set, cached: append() is the hot
        # path and must not rebuild the path string per record
        self._cur_seqnos = self._seg_seqnos[p] = set()

    def _rotate_locked(self) -> None:
        self._sync_locked(force=True)
        self._file.close()
        # GC: delete the longest PREFIX of segments (oldest first)
        # whose every REQ seqno is acked, stopping at the first segment
        # holding an unacked request — bounded steady-state disk usage.
        # Strictly a prefix: an ACK record always lands at or after its
        # REQ, so a deleted old segment's acks can only reference
        # requests deleted with it, while a req whose ack lives in a
        # LATER segment leaves (at worst) a dangling ack the scanner
        # ignores.  Deleting an arbitrary fully-acked MIDDLE segment
        # would instead destroy acks for older retained requests and
        # resurrect answered work at the next replay.
        for p in _segments(self.path)[:-1]:
            seqs = self._seg_seqnos.get(p)
            if seqs is None:
                # pre-restart segment: scan it once for its REQ seqnos
                recs, _ = _scan_segment(p)
                seqs = {s for m, s, _pl in recs if m == MAGIC_REQ}
                self._seg_seqnos[p] = seqs
            if seqs & self._live_unacked:
                break  # prefix ends here
            try:
                os.unlink(p)
            except OSError:
                break
            self._seg_seqnos.pop(p, None)
            metrics.count("journal.segments_gcd")
        self._seg_index += 1
        self._open_segment()

    def _write_locked(self, rec: bytes) -> None:
        if self._file_bytes + len(rec) > self.segment_bytes \
                and self._file_bytes > 0:
            self._rotate_locked()
        self._file.write(rec)
        self._file_bytes += len(rec)

    def _sync_locked(self, force: bool = False) -> None:
        if self._unsynced == 0:
            return
        self._file.flush()
        if self.fsync != "off" or force:
            try:
                os.fsync(self._file.fileno())
            except OSError:
                pass
        self._unsynced = 0

    def _after_write_locked(self) -> None:
        """Per-record durability step: ``always`` fsyncs inline,
        ``off`` flushes to the page cache (a SIGKILL must not lose
        python-buffered bytes), ``batch`` leaves the write buffered and
        at most KICKS the flusher (the request path never fsyncs)."""
        if self.fsync == "always":
            self._sync_locked(force=True)
        elif self.fsync == "off":
            self._file.flush()
            self._unsynced = 0
        elif self._unsynced >= self.batch_every:
            self._kick.set()

    def append(self, payload: bytes, tenant: Optional[str] = None) -> int:
        """Append one accepted request payload; returns its journal
        seqno (the dedup key the ack + replay paths use), or 0 when
        the journal is already closed (a reader thread racing
        shutdown: the request is simply not journaled)."""
        with self._lock:
            if self._file is None:
                return 0
            seq = self._next_seq
            self._next_seq += 1
            self._write_locked(pack_record(MAGIC_REQ, seq, payload))
            self._live_unacked.add(seq)
            self._cur_seqnos.add(seq)
            self._unsynced += 1
            self._after_write_locked()
        metrics.count("journal.appends", tenant=tenant)
        return seq

    def ack(self, seqno: int) -> bool:
        """Record that entry ``seqno`` was answered (the watermark); an
        acked entry is never replayed.  IDEMPOTENT: only the first ack
        of a live unacked seqno writes a record (multiplicity stays 1
        even when several failure paths race to retire one entry), and
        a closed journal no-ops.  Returns True when the ack was
        recorded."""
        seqno = int(seqno)
        with self._lock:
            if self._file is None or seqno not in self._live_unacked:
                return False
            self._write_locked(pack_record(MAGIC_ACK, seqno))
            self._live_unacked.discard(seqno)
            self._unsynced += 1
            self._after_write_locked()
        metrics.count("journal.acks")
        return True

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._sync_locked(force=True)

    def close(self) -> None:
        self._stop_flush.set()
        self._kick.set()
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
            self._flusher = None
        with self._lock:
            if self._file is not None:
                self._sync_locked(force=True)
                self._file.close()
                self._file = None

    # -- stats -------------------------------------------------------------
    def unacked_count(self) -> int:
        with self._lock:
            return len(self._live_unacked)


class JournalState:
    """Result of :func:`scan`: what a journal directory durably holds."""

    def __init__(self):
        self.requests: Dict[int, bytes] = {}
        self.acked: set = set()
        self.torn_bytes = 0
        self.max_seqno = 0
        self.duplicate_seqnos = 0
        self.ack_multiplicity: Dict[int, int] = {}

    @property
    def unanswered(self) -> List[int]:
        return sorted(s for s in self.requests if s not in self.acked)


def scan(path: str) -> JournalState:
    """Read every segment in order, CRC-verifying each record; torn
    tails are dropped per segment (see module docstring)."""
    st = JournalState()
    segs = _segments(path)
    for i, p in enumerate(segs):
        recs, torn = _scan_segment(p)
        if torn:
            st.torn_bytes += torn
            if i != len(segs) - 1:
                # mid-history corruption (not a crash artifact): recover
                # what checks out, but say so loudly
                log.warning(
                    "journal %s: %d torn bytes in NON-final segment %s "
                    "(disk corruption?); recovered %d records before it",
                    path, torn, os.path.basename(p), len(recs))
        for magic, seqno, payload in recs:
            if magic == MAGIC_REQ:
                if seqno in st.requests:
                    st.duplicate_seqnos += 1
                    continue  # seqno dedup: first durable copy wins
                st.requests[seqno] = payload
            else:
                st.ack_multiplicity[seqno] = \
                    st.ack_multiplicity.get(seqno, 0) + 1
                st.acked.add(seqno)
            if seqno > st.max_seqno:
                st.max_seqno = seqno
    return st


def replay_unanswered(path: str) -> List[Tuple[int, bytes]]:
    """``(seqno, payload)`` for every fully-CRC'd accepted-but-unanswered
    entry, in append order — the ``Pipeline(journal_replay=True)``
    re-admission source.  Exactly-once composition: re-admitted entries
    keep their seqno, are acked when answered, and a further restart
    replays only what is STILL unanswered."""
    st = scan(path)
    return [(s, st.requests[s]) for s in st.unanswered]

"""Segmented write-ahead log for :class:`MutableIndex` durability.

Port of ``csvplus_tpu/storage/wal.py``, the same format (either package
replays segments the other wrote).

Format
------

A WAL directory holds segments ``wal-00000001.log``, ``wal-00000002.log``,
… (monotonic, never reused).  Each segment starts with one JSON header
line (magic, version, segment number, key columns) followed by binary
records::

    [u32 length][u32 crc32][payload bytes]

The payload is one UTF-8 JSON document reusing the v1 JSONL row
encoding of :meth:`Index.write_to` (``json.dumps(row, sort_keys=True,
separators=(",", ":"))`` per row)::

    {"lsn": 17, "op": "rows", "rows": [{...}, ...]}
    {"lsn": 18, "op": "del",  "key": ["k003"]}

``lsn`` is the tier sequence number assigned by the owning
``MutableIndex`` — one logical stream position per append batch or
tombstone, strictly increasing across segments.  The crc32 is over the
payload bytes; a record whose length prefix or checksum does not match
is **torn**.  A torn record at the tail of the NEWEST segment is the
expected crash shape and replay truncates the file back to the last
good record; a torn record anywhere else is corruption and raises
:class:`WalError`.

Sync policy (``CSVPLUS_WAL_SYNC``)
----------------------------------

* ``always`` (default) — flush + ``os.fsync`` before every append
  returns: an acked record can never be lost, at one fsync per batch.
* ``batch`` — flush per append, fsync deferred to :meth:`sync_now`
  (the serving tier calls it once per dispatch cycle BEFORE completing
  futures, so acks still imply durability; a crash between cycles can
  lose only unacked records).
* ``off`` — flush only; durability is best-effort (crash window = OS
  page cache).  For bulk loads that re-run on failure.

Thread model: ``append_record`` / ``sync_now`` / ``seal_active`` may be
called from any thread — every mutation of WAL state sits under
``self._lock``.  The ``storage:wal-write`` fault site fires at the top
of ``append_record`` (a crashed write acks nothing) and ``seal_active``
(a crash mid-seal leaves the old active segment replayable).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

from ..errors import CsvPlusError
from ..obs import flight as _flight
from ..utils.env import env_int, env_str
from ..resilience import faults

__all__ = ["Wal", "WalError", "wal_sync_mode"]

_MAGIC = "csvplus-tpu-wal"
_VERSION = 1
_HDR = struct.Struct("<II")  # (payload length, payload crc32)
_SEG_FMT = "wal-%08d.log"
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".log"
_MAX_RECORD = 1 << 31  # sanity bound: larger length prefixes are torn trash
_SYNC_MODES = ("always", "batch", "off")


class WalError(CsvPlusError):
    """Unrecoverable WAL damage: a torn record that is NOT the newest
    segment's tail, a bad segment header, or a non-monotonic LSN."""


def wal_sync_mode(explicit: Optional[str] = None) -> str:
    """Resolve the fsync policy: explicit argument beats the
    ``CSVPLUS_WAL_SYNC`` environment knob beats the ``always`` default.
    Unknown values raise (a typo'd durability knob must not silently
    weaken the ack contract the way a typo'd tuning knob may degrade)."""
    mode = explicit if explicit is not None else env_str(
        "CSVPLUS_WAL_SYNC", "always"
    )
    if mode not in _SYNC_MODES:
        raise ValueError(
            f"unknown CSVPLUS_WAL_SYNC mode {mode!r} (one of {_SYNC_MODES})"
        )
    return mode


def _fsync_dir(path: str) -> None:
    """Make a directory entry change (create/rename/unlink) durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _segment_path(directory: str, seg: int) -> str:
    return os.path.join(directory, _SEG_FMT % seg)


def _segment_number(name: str) -> Optional[int]:
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    try:
        return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
    except ValueError:
        return None


def list_segments(directory: str) -> List[Tuple[int, str]]:
    """(segment number, file name) pairs present in *directory*, sorted."""
    out = []
    for name in os.listdir(directory):
        n = _segment_number(name)
        if n is not None:
            out.append((n, name))
    out.sort()
    return out


def _scan_segment(path: str, is_last: bool) -> Tuple[List[Dict], int, bool]:
    """Decode one segment: (records, keep_bytes, torn).

    *keep_bytes* is the offset of the first torn byte (== file size when
    clean); *torn* reports whether a damaged tail was found.  Damage in
    a non-last segment raises :class:`WalError` — records there were
    sealed behind an fsync, so a bad checksum is disk corruption, not a
    crash shape."""
    records: List[Dict] = []
    with open(path, "rb") as f:
        header_line = f.readline()
        offset = len(header_line)
        try:
            header = json.loads(header_line)
            ok = header.get("magic") == _MAGIC and header.get("version") == _VERSION
        except (json.JSONDecodeError, UnicodeDecodeError):
            ok = False
        if not ok:
            if is_last:
                # crash during segment creation: the header itself is
                # torn — recover by rewriting the segment from scratch
                return [], 0, True
            raise WalError(f"{path}: bad WAL segment header")
        while True:
            hdr = f.read(_HDR.size)
            if not hdr:
                return records, offset, False
            if len(hdr) < _HDR.size:
                break
            length, crc = _HDR.unpack(hdr)
            if length > _MAX_RECORD:
                break
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            try:
                doc = json.loads(payload.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                break
            records.append(doc)
            offset += _HDR.size + length
    if not is_last:
        raise WalError(f"{path}: torn record in a sealed WAL segment")
    return records, offset, True


class Wal:
    """One directory's segmented write-ahead log.

    Create fresh with :meth:`create`, or :meth:`open` an existing
    directory to replay its tail (returning the decoded records newer
    than the manifest's ``applied_lsn``).  All public methods are safe
    to call from the appender and compactor threads concurrently.
    """

    def __init__(self, directory: str, *, sync: Optional[str] = None,
                 columns: Optional[List[str]] = None,
                 segment_bytes: Optional[int] = None):
        self.directory = directory
        self.sync = wal_sync_mode(sync)
        self._columns = list(columns or [])
        if segment_bytes is None:
            segment_bytes = env_int("CSVPLUS_WAL_SEGMENT_BYTES", 8 << 20)
        self._segment_bytes = int(segment_bytes)
        # reentrant: the public entries hold it across the internal
        # roll/open/drop helpers, which retake it for their own
        # mutations (every store is lexically guarded)
        self._lock = threading.RLock()
        self._f = None  # active segment file object
        self._seg = 0  # active segment number
        self._size = 0  # active segment bytes (append-mode tell() lies)
        self._seg_records = 0  # records in the active segment
        self._seg_max_lsn: Dict[int, int] = {}  # per-segment newest lsn
        self._last_lsn = 0
        # cycle-delta counters consumed by MutableIndex.wal_sync()
        self._bytes_total = 0
        self._fsyncs_total = 0
        self._records_total = 0
        self._reported = (0, 0, 0)

    # -- construction ------------------------------------------------------

    @classmethod
    def create(cls, directory: str, *, sync: Optional[str] = None,
               columns: Optional[List[str]] = None,
               segment_bytes: Optional[int] = None) -> "Wal":
        """Start a fresh log: segment 1, empty, header fsynced."""
        w = cls(directory, sync=sync, columns=columns,
                segment_bytes=segment_bytes)
        with w._lock:
            w._open_segment(1)
        return w

    @classmethod
    def open(cls, directory: str, applied_lsn: int, *,
             sync: Optional[str] = None, columns: Optional[List[str]] = None,
             segment_bytes: Optional[int] = None) -> Tuple["Wal", List[Dict], Dict]:
        """Recover: scan every segment in order, truncate a torn tail in
        the newest one, drop segments wholly covered by *applied_lsn*,
        and return ``(wal, records_to_replay, info)``.

        *records_to_replay* are the decoded payload docs with
        ``lsn > applied_lsn`` in LSN order; *info* reports what recovery
        did (for metrics)."""
        w = cls(directory, sync=sync, columns=columns,
                segment_bytes=segment_bytes)
        segments = list_segments(directory)
        replay: List[Dict] = []
        truncated = 0
        removed: List[str] = []
        last_lsn = int(applied_lsn)
        last_seg_records = 0
        with w._lock:
            for pos, (seg, name) in enumerate(segments):
                path = os.path.join(directory, name)
                is_last = pos == len(segments) - 1
                records, keep, torn = _scan_segment(path, is_last)
                if is_last:
                    last_seg_records = len(records)
                if torn:
                    size = os.path.getsize(path)
                    truncated = size - keep
                    with open(path, "r+b") as f:
                        f.truncate(keep)
                        f.flush()
                        os.fsync(f.fileno())
                seg_max = int(applied_lsn)
                for doc in records:
                    lsn = int(doc["lsn"])
                    seg_max = max(seg_max, lsn)
                    if lsn <= applied_lsn:
                        continue
                    if lsn <= last_lsn:
                        raise WalError(
                            f"{path}: non-monotonic LSN {lsn} after {last_lsn}"
                        )
                    last_lsn = lsn
                    replay.append(doc)
                w._seg_max_lsn[seg] = seg_max
            w._last_lsn = last_lsn
            if segments:
                # reopen the newest segment for appends; rewrite its
                # header if the torn tail swallowed it entirely
                seg, name = segments[-1]
                path = os.path.join(directory, name)
                if os.path.getsize(path) == 0:
                    os.unlink(path)
                    w._open_segment(seg)
                else:
                    w._seg = seg
                    w._f = open(path, "ab")
                    w._size = os.path.getsize(path)
                    w._seg_records = last_seg_records
            else:
                w._open_segment(1)
            w._drop_applied_locked(int(applied_lsn), removed)
        info = {
            "replayed": len(replay),
            "truncated_bytes": int(truncated),
            "removed_segments": removed,
            "segments": [name for _, name in list_segments(directory)],
        }
        _flight.note(
            "wal:recover", replayed=len(replay),
            truncated_bytes=int(truncated), segments=len(info["segments"]),
        )
        return w, replay, info

    # -- internals (caller holds self._lock) -------------------------------

    def _open_segment(self, seg: int) -> None:
        path = _segment_path(self.directory, seg)
        f = open(path, "xb")
        header = json.dumps(
            {"magic": _MAGIC, "version": _VERSION, "segment": seg,
             "key_columns": self._columns},
            sort_keys=True, separators=(",", ":"),
        )
        f.write(header.encode("utf-8"))
        f.write(b"\n")
        f.flush()
        os.fsync(f.fileno())
        _fsync_dir(self.directory)
        with self._lock:
            self._f = f
            self._seg = seg
            self._size = f.tell()
            self._seg_records = 0
            self._seg_max_lsn.setdefault(seg, self._last_lsn)

    def _roll_locked(self) -> None:
        with self._lock:
            f = self._f
            f.flush()
            os.fsync(f.fileno())
            self._fsyncs_total += 1
            f.close()
            self._open_segment(self._seg + 1)

    def _drop_applied_locked(self, applied_lsn: int, removed: List[str]) -> None:
        with self._lock:
            for seg, name in list_segments(self.directory):
                if seg == self._seg:
                    continue
                if self._seg_max_lsn.get(seg, applied_lsn + 1) <= applied_lsn:
                    os.unlink(os.path.join(self.directory, name))
                    self._seg_max_lsn.pop(seg, None)
                    removed.append(name)
            if removed:
                _fsync_dir(self.directory)

    # -- entries for any thread --------------------------------------------

    def append_record(self, lsn: int, doc: Dict) -> int:
        """Write one length-prefixed, crc32-checksummed record.  Under
        ``always`` the record is fsynced before return; the caller may
        ack.  Returns the bytes appended."""
        faults.inject("storage:wal-write")
        payload = json.dumps(doc, sort_keys=True, separators=(",", ":")).encode(
            "utf-8"
        )
        frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._f is None:
                raise WalError("WAL is closed")
            if int(lsn) <= self._last_lsn:
                raise WalError(
                    f"non-monotonic LSN {lsn} after {self._last_lsn}"
                )
            if self._size + len(frame) > self._segment_bytes and self._seg_records:
                # roll only a segment that already holds records — an
                # oversized single record still lands (in its own file)
                self._roll_locked()
            self._f.write(frame)
            self._size += len(frame)
            self._seg_records += 1
            self._f.flush()
            if self.sync == "always":
                os.fsync(self._f.fileno())
                self._fsyncs_total += 1
            self._last_lsn = int(lsn)
            self._seg_max_lsn[self._seg] = int(lsn)
            self._bytes_total += len(frame)
            self._records_total += 1
        return len(frame)

    def sync_now(self) -> None:
        """Force the active segment durable (the ``batch`` policy's
        per-cycle hook; a no-op under ``off``)."""
        with self._lock:
            if self._f is None or self.sync == "off":
                return
            self._f.flush()
            os.fsync(self._f.fileno())
            self._fsyncs_total += 1

    def seal_active(self) -> str:
        """Fsync + close the active segment and open the next one (the
        checkpoint boundary).  Returns the new active segment name."""
        faults.inject("storage:wal-write")
        with self._lock:
            if self._f is None:
                raise WalError("WAL is closed")
            self._roll_locked()
            name = _SEG_FMT % self._seg
        _flight.note("wal:seal", segment=name)
        return name

    def drop_applied(self, applied_lsn: int) -> List[str]:
        """Delete sealed segments wholly covered by *applied_lsn* (their
        records are folded into the persisted base)."""
        removed: List[str] = []
        with self._lock:
            self._drop_applied_locked(int(applied_lsn), removed)
        return removed

    # -- accounting --------------------------------------------------------

    def stats_delta(self) -> Dict[str, int]:
        """Counters accumulated since the previous call — the serving
        tier folds one delta per dispatch cycle into ServingMetrics."""
        with self._lock:
            cur = (self._records_total, self._bytes_total, self._fsyncs_total)
            prev = self._reported
            self._reported = cur
        return {
            "records": cur[0] - prev[0],
            "bytes": cur[1] - prev[1],
            "fsyncs": cur[2] - prev[2],
        }

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "sync": self.sync,
                "segment": self._seg,
                "last_lsn": self._last_lsn,
                "records": self._records_total,
                "bytes": self._bytes_total,
                "fsyncs": self._fsyncs_total,
            }

    def segment_names(self) -> List[str]:
        with self._lock:
            return [name for _, name in list_segments(self.directory)]

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                if self.sync != "off":
                    os.fsync(self._f.fileno())
                    self._fsyncs_total += 1
                self._f.close()
                self._f = None

"""Log-structured block store: segmented value log + WAL group commit +
cleanup-driven compaction.

The persistent tier of the p-bucket, built the way long-window streaming
stores are (RocksDB under Flink/Aion, Railgun's batched persistent
writes): blocks append to a fixed-size **segmented value log** instead of
one file per block, so spill pressure turns into sequential writes and a
batched fetch turns into one sweep per segment.

On-disk layout (``directory/``)::

    seg-00000000.log     sealed segment: records ... footer(index)
    seg-00000001.log     active segment: records ... (tail may be torn)
    wal.log              group-commit journal for the active segment

**Records** — ``header | payload | crc32``. The header carries the
``(window_start, window_end, block_id)`` key plus ``(fill, capacity,
width)``; the payload is the fill-sliced SoA event data (int32 keys,
float64 timestamps, float32 values — capacity padding is *not* written;
reads re-pad). A tombstone is a record with an empty payload.

**Group commit** — ``put``/``delete`` append to the active segment
through a buffered handle; ``commit()`` flushes + fsyncs the segment,
then appends an acknowledgement ``(segment, committed_offset)`` to the
WAL (flushed + fsynced). A crash after ``commit`` returns loses nothing
acknowledged; anything past the last WAL ack — a torn record from a
crash mid-spill, or fully-written-but-unacknowledged records — is
truncated away on reopen (those blocks still held their host copies; the
spill was never acknowledged).

**Recovery / open** — sealed segments rebuild the in-memory index
``(window_id, block_id) -> (segment, offset)`` from their footers (no
payload reads); the active segment is scanned record-by-record with
checksum validation up to the WAL ack and truncated there. Replay is in
``(segment, offset)`` order: later records supersede earlier ones,
tombstones delete.

**Compaction** — predictive cleanup's purge emits tombstones
(``delete``); ``compact_if_needed`` consumes them, rewriting a victim
segment's live records into the active segment and dropping the file,
until on-disk bytes <= max(ratio x live record bytes, one segment) — the
paper's §3.4 "storage consumption stays bounded" claim, now enforced and
tested. A tombstone is carried forward only while stale value records
for its key survive in other segments (the ``_key_copies`` refcount), so
deleted keys can never resurrect on replay.

**Readahead** — ``readahead(keys)`` batch-reads records (sorted by
segment/offset: sequential sweeps) into a bounded LRU byte-cache that
``get`` consumes; proactive pre-staging drives it ahead of demand, which
is what makes store readahead a measurable, first-class interface
(hit/miss/bytes counters in ``stats``).
"""
from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.storage.blockstore import (
    BlockKey, BlockStore, WindowKey, normalize_window_key, payload_nbytes,
)

REC_VALUE = 0
REC_TOMB = 1

_REC_MAGIC = 0xA10B10C5
_FOOT_MAGIC = 0xF007A10B
_WAL_MAGIC = 0x3A11A10B

# magic, rtype, block_id, wstart, wend, fill, capacity, width
_REC_HDR = struct.Struct("<IBQddIII")
_CRC = struct.Struct("<I")
# json_len, crc32(json), magic — the fixed footer trailer
_FOOT = struct.Struct("<III")
# magic, segment_id, committed_offset, crc32(first 16 bytes)
_WAL = struct.Struct("<IIQI")


class _Entry:
    """One record's metadata (index entry / footer row)."""
    __slots__ = ("rtype", "key", "fill", "cap", "width", "offset",
                 "rec_len")

    def __init__(self, rtype: int, key: BlockKey, fill: int, cap: int,
                 width: int, offset: int, rec_len: int):
        self.rtype = rtype
        self.key = key
        self.fill = fill
        self.cap = cap
        self.width = width
        self.offset = offset
        self.rec_len = rec_len

    def to_json(self):
        (ws, we), bid = self.key
        return [self.rtype, ws, we, bid, self.fill, self.cap, self.width,
                self.offset, self.rec_len]

    @staticmethod
    def from_json(row) -> "_Entry":
        rtype, ws, we, bid, fill, cap, width, offset, rec_len = row
        return _Entry(int(rtype), ((float(ws), float(we)), int(bid)),
                      int(fill), int(cap), int(width), int(offset),
                      int(rec_len))


class _Seg:
    __slots__ = ("sid", "path", "size", "sealed", "live_bytes",
                 "dead_bytes", "entries")

    def __init__(self, sid: int, path: Path):
        self.sid = sid
        self.path = path
        self.size = 0
        self.sealed = False
        self.live_bytes = 0          # record bytes of live value records
        self.dead_bytes = 0          # superseded/tombstoned + tombstones
        self.entries: List[_Entry] = []


def _encode_record(rtype: int, key: BlockKey, fill: int, cap: int,
                   width: int, payload: bytes) -> bytes:
    (ws, we), bid = key
    hdr = _REC_HDR.pack(_REC_MAGIC, rtype, bid, ws, we, fill, cap, width)
    crc = zlib.crc32(hdr[4:]) & 0xFFFFFFFF
    crc = zlib.crc32(payload, crc) & 0xFFFFFFFF
    return hdr + payload + _CRC.pack(crc)


def _payload_len(fill: int, width: int) -> int:
    return payload_nbytes(fill, width)


class LogBlockStore(BlockStore):
    """Segmented append-only value log with WAL recovery."""

    name = "log"
    durable_writes = True

    def __init__(self, directory: Path, *, segment_bytes: int = 1 << 20,
                 sim_spb: float = 0.0, readahead_bytes: int = 16 << 20,
                 fsync: bool = True, registry=None):
        super().__init__(sim_spb=sim_spb, registry=registry)
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = max(int(segment_bytes), 4096)
        self.readahead_bytes = readahead_bytes
        self._fsync = fsync
        self._lock = threading.RLock()
        self._segs: Dict[int, _Seg] = {}
        # (window_key, block_id) -> live record entry (entry.offset in
        # its segment); THE index the p-bucket keeps in memory
        self._index: Dict[BlockKey, Tuple[int, _Entry]] = {}
        # value-record instances per key across ALL segments (live or
        # dead) — the tombstone-drop rule at compaction
        self._key_copies: Dict[BlockKey, int] = {}
        self._live_payload = 0
        self._cache: "OrderedDict[BlockKey, Tuple[dict, int]]" = \
            OrderedDict()
        self._cache_bytes = 0
        # keys a readahead() was asked to prefetch and has not yet been
        # consumed/abandoned for — hit/miss counters measure READAHEAD
        # effectiveness, not plain demand reads that never had a
        # prefetch opportunity
        self._readahead_wanted: set = set()
        self._active_f = None
        self._wal_f = None
        self._dirty = False
        self.stats.update({
            "recovered_records": 0, "recovery_truncated_bytes": 0,
            "segments_sealed": 0, "wal_commits": 0,
            "segment_sweeps": 0, "sweep_bytes_read": 0,
            "coalesced_windows": 0, "coalesce_bytes": 0,
        })
        self._recover()

    # --------------------------------------------------------------- paths
    def _seg_path(self, sid: int) -> Path:
        return self.directory / f"seg-{sid:08d}.log"

    @property
    def _wal_path(self) -> Path:
        return self.directory / "wal.log"

    def active_segment_path(self) -> Path:
        """Path of the active segment (fault-injection hooks in tests)."""
        with self._lock:
            return self._active.path

    # ------------------------------------------------------------ recovery
    def _read_wal_ack(self) -> Tuple[Optional[int], int]:
        """(segment_id, committed_offset) of the last valid WAL entry."""
        sid, off = None, 0
        p = self._wal_path
        if not p.exists():
            return sid, off
        data = p.read_bytes()
        for i in range(0, len(data) - _WAL.size + 1, _WAL.size):
            try:
                magic, s, o, crc = _WAL.unpack_from(data, i)
            except struct.error:
                break
            if magic != _WAL_MAGIC:
                break
            if (zlib.crc32(data[i:i + 16]) & 0xFFFFFFFF) != crc:
                break
            sid, off = s, o
        return sid, off

    def _scan_segment(self, path: Path, limit: int) -> Tuple[List[_Entry],
                                                             int]:
        """Record-by-record scan with checksum validation, stopping at
        ``limit`` bytes or the first torn/corrupt record. Returns the
        entries of the valid prefix and its length."""
        entries: List[_Entry] = []
        size = path.stat().st_size
        end = min(size, limit)
        with open(path, "rb") as f:
            off = 0
            while off + _REC_HDR.size + _CRC.size <= end:
                f.seek(off)
                hdr = f.read(_REC_HDR.size)
                if len(hdr) < _REC_HDR.size:
                    break
                try:
                    magic, rtype, bid, ws, we, fill, cap, width = \
                        _REC_HDR.unpack(hdr)
                except struct.error:
                    break
                if magic != _REC_MAGIC:
                    break
                plen = _payload_len(fill, width) if rtype == REC_VALUE \
                    else 0
                rec_len = _REC_HDR.size + plen + _CRC.size
                if off + rec_len > end:
                    break                       # torn tail
                payload = f.read(plen)
                (crc,) = _CRC.unpack(f.read(_CRC.size))
                want = zlib.crc32(hdr[4:]) & 0xFFFFFFFF
                want = zlib.crc32(payload, want) & 0xFFFFFFFF
                if crc != want:
                    break                       # corrupt record
                entries.append(_Entry(rtype, ((ws, we), bid), fill, cap,
                                      width, off, rec_len))
                off += rec_len
        return entries, off

    def _parse_footer(self, path: Path) -> Optional[Tuple[List[_Entry],
                                                          int]]:
        """(entries, total_size) when ``path`` carries a valid seal
        footer, else None."""
        size = path.stat().st_size
        if size < _FOOT.size:
            return None
        with open(path, "rb") as f:
            f.seek(size - _FOOT.size)
            jlen, jcrc, magic = _FOOT.unpack(f.read(_FOOT.size))
            if magic != _FOOT_MAGIC or jlen > size - _FOOT.size:
                return None
            f.seek(size - _FOOT.size - jlen)
            raw = f.read(jlen)
        if (zlib.crc32(raw) & 0xFFFFFFFF) != jcrc:
            return None
        try:
            rows = json.loads(raw.decode("utf-8"))
        except ValueError:
            return None
        return [_Entry.from_json(r) for r in rows], size

    def _recover(self) -> None:
        wal_sid, wal_off = self._read_wal_ack()
        sids = sorted(int(p.stem.split("-")[1])
                      for p in self.directory.glob("seg-*.log"))
        replay: List[Tuple[int, _Entry]] = []
        active_sid = None
        for sid in sids:
            path = self._seg_path(sid)
            seg = _Seg(sid, path)
            footer = self._parse_footer(path)
            if footer is not None:
                seg.entries, seg.size = footer
                seg.sealed = True
            else:
                # unsealed: trust only what the WAL acknowledged
                limit = wal_off if sid == wal_sid else 0
                seg.entries, valid = self._scan_segment(path, limit)
                lost = path.stat().st_size - valid
                if lost > 0:
                    with open(path, "r+b") as f:
                        f.truncate(valid)
                    self.stats["recovery_truncated_bytes"] += lost
                seg.size = valid
                if seg.size == 0 and sid != max(sids):
                    # an empty torn segment in the middle: drop it
                    os.unlink(path)
                    continue
                active_sid = sid
            self._segs[sid] = seg
            for e in seg.entries:
                replay.append((sid, e))
        # replay in (segment, offset) order: later supersedes earlier,
        # tombstones delete
        for sid, e in replay:
            self._apply_entry(sid, e)
            self.stats["recovered_records"] += 1
        if active_sid is None:
            active_sid = (max(sids) + 1) if sids else 0
            seg = _Seg(active_sid, self._seg_path(active_sid))
            seg.path.touch()
            self._segs[active_sid] = seg
        self._active_sid = active_sid
        self._active_f = open(self._active.path, "ab")
        self._reset_wal()

    def _apply_entry(self, sid: int, e: _Entry) -> None:
        """Replay one record into the index/accounting state."""
        if e.rtype == REC_VALUE:
            old = self._index.get(e.key)
            if old is not None:
                self._kill(old)
            self._index[e.key] = (sid, e)
            self._segs[sid].live_bytes += e.rec_len
            self._live_payload += _payload_len(e.fill, e.width)
            self._key_copies[e.key] = self._key_copies.get(e.key, 0) + 1
        else:
            old = self._index.pop(e.key, None)
            if old is not None:
                self._kill(old)
            self._segs[sid].dead_bytes += e.rec_len  # tombstones are
            # dead weight themselves, reclaimable under the copies rule

    def _kill(self, loc: Tuple[int, _Entry]) -> None:
        """Move a live record to the dead ledger of its segment."""
        sid, e = loc
        seg = self._segs.get(sid)
        if seg is not None:
            seg.live_bytes -= e.rec_len
            seg.dead_bytes += e.rec_len
        self._live_payload -= _payload_len(e.fill, e.width)

    # ---------------------------------------------------------- active seg
    @property
    def _active(self) -> _Seg:
        return self._segs[self._active_sid]

    def _reset_wal(self) -> None:
        """Start a fresh WAL generation acknowledging the active segment
        at its current size (sealed segments carry their own footers).

        The new WAL is written to a temp file and renamed over the old
        one — truncating in place would open a crash window in which the
        only ack covering the active segment is gone and recovery would
        wrongly truncate acknowledged records to offset 0."""
        if self._wal_f is not None:
            self._wal_f.close()
        tmp = self._wal_path.with_suffix(".tmp")
        self._wal_f = open(tmp, "wb")
        self._append_wal_ack()
        os.replace(tmp, self._wal_path)
        # reopen under the final name so later acks append to the real
        # WAL, not a dangling inode
        self._wal_f.close()
        self._wal_f = open(self._wal_path, "ab")

    def _append_wal_ack(self) -> None:
        head = _WAL.pack(_WAL_MAGIC, self._active_sid,
                         self._active.size, 0)[:16]
        self._wal_f.write(head + _CRC.pack(zlib.crc32(head) & 0xFFFFFFFF))
        self._wal_f.flush()
        if self._fsync:
            os.fsync(self._wal_f.fileno())
        self.stats["wal_commits"] += 1

    def _maybe_roll(self, incoming_len: int) -> None:
        a = self._active
        if a.size > 0 and a.size + incoming_len > self.segment_bytes:
            self._commit_locked()
            self._seal_active()

    def _seal_active(self) -> None:
        """Footer the committed active segment and open a fresh one."""
        a = self._active
        raw = json.dumps([e.to_json() for e in a.entries],
                         separators=(",", ":")).encode("utf-8")
        self._active_f.write(raw + _FOOT.pack(
            len(raw), zlib.crc32(raw) & 0xFFFFFFFF, _FOOT_MAGIC))
        self._active_f.flush()
        if self._fsync:
            os.fsync(self._active_f.fileno())
        self._active_f.close()
        a.size += len(raw) + _FOOT.size
        a.sealed = True
        self.stats["segments_sealed"] += 1
        sid = self._active_sid + 1
        seg = _Seg(sid, self._seg_path(sid))
        seg.path.touch()
        self._segs[sid] = seg
        self._active_sid = sid
        self._active_f = open(seg.path, "ab")
        self._dirty = False
        self._reset_wal()

    def _append_record(self, rtype: int, key: BlockKey, fill: int,
                       cap: int, width: int, payload: bytes) -> Tuple[int,
                                                                      int]:
        rec = _encode_record(rtype, key, fill, cap, width, payload)
        self._maybe_roll(len(rec))
        a = self._active
        offset = a.size
        self._active_f.write(rec)
        e = _Entry(rtype, key, fill, cap, width, offset, len(rec))
        a.entries.append(e)
        a.size += len(rec)
        self._dirty = True
        self.stats["bytes_written"] += len(rec)
        self._apply_entry(a.sid, e)
        return a.sid, offset

    # ------------------------------------------------------------- writes
    def put(self, window_key, block_id, arrays, fill):
        wk = normalize_window_key(window_key)
        key = (wk, int(block_id))
        fill = int(fill)
        cap = int(arrays["keys"].shape[0])
        width = int(arrays["values"].shape[1])
        payload = (
            np.ascontiguousarray(arrays["keys"][:fill],
                                 np.int32).tobytes()
            + np.ascontiguousarray(arrays["timestamps"][:fill],
                                   np.float64).tobytes()
            + np.ascontiguousarray(arrays["values"][:fill],
                                   np.float32).tobytes())
        with self._lock:
            self._cache_drop(key)
            ref = self._append_record(REC_VALUE, key, fill, cap, width,
                                      payload)
            self.stats["puts"] += 1
            self.stats["logical_bytes_written"] += len(payload)
            return ref

    def delete(self, window_key, block_id) -> None:
        key = (normalize_window_key(window_key), int(block_id))
        with self._lock:
            self._cache_drop(key)
            if key not in self._index:
                return
            self._append_record(REC_TOMB, key, 0, 0, 0, b"")
            self.stats["deletes"] += 1

    def commit(self) -> None:
        with self._lock:
            self._commit_locked()

    def _commit_locked(self) -> None:
        if not self._dirty:
            return
        self._active_f.flush()
        if self._fsync:
            os.fsync(self._active_f.fileno())
        self._append_wal_ack()
        self._dirty = False
        self.stats["commits"] += 1

    # -------------------------------------------------------------- reads
    def _cache_drop(self, key: BlockKey) -> None:
        hit = self._cache.pop(key, None)
        if hit is not None:
            self._cache_bytes -= hit[1]

    def _cache_add(self, key: BlockKey, arrays: dict, nbytes: int) -> None:
        self._cache_drop(key)
        self._cache[key] = (arrays, nbytes)
        self._cache_bytes += nbytes
        while self._cache_bytes > self.readahead_bytes and self._cache:
            _, (_, nb) = self._cache.popitem(last=False)
            self._cache_bytes -= nb

    def _decode(self, e: _Entry, payload: bytes) -> dict:
        """Full-capacity SoA arrays from a record payload (re-pad)."""
        n0 = e.fill * 4
        n1 = n0 + e.fill * 8
        keys = np.zeros((e.cap,), np.int32)
        ts = np.zeros((e.cap,), np.float64)
        vals = np.zeros((e.cap, e.width), np.float32)
        if e.fill:
            keys[:e.fill] = np.frombuffer(payload[:n0], np.int32)
            ts[:e.fill] = np.frombuffer(payload[n0:n1], np.float64)
            vals[:e.fill] = np.frombuffer(
                payload[n1:], np.float32).reshape(e.fill, e.width)
        return {"keys": keys, "timestamps": ts, "values": vals}

    @staticmethod
    def _record_payload(rec: bytes) -> Optional[bytes]:
        """CRC-validated payload of one raw record, or None if torn or
        corrupt."""
        payload = rec[_REC_HDR.size:-_CRC.size]
        (crc,) = _CRC.unpack(rec[-_CRC.size:])
        want = zlib.crc32(rec[4:_REC_HDR.size]) & 0xFFFFFFFF
        want = zlib.crc32(payload, want) & 0xFFFFFFFF
        return payload if crc == want else None

    def _read_records(self, locs: List[Tuple[BlockKey, int, _Entry]]
                      ) -> Dict[BlockKey, dict]:
        """Batched record reads, one sequential sweep per segment."""
        out: Dict[BlockKey, dict] = {}
        by_seg: Dict[int, List[Tuple[BlockKey, _Entry]]] = {}
        for key, sid, e in locs:
            by_seg.setdefault(sid, []).append((key, e))
        for sid, items in by_seg.items():
            seg = self._segs.get(sid)
            if seg is None:
                continue
            if sid == self._active_sid:
                self._active_f.flush()     # make buffered tail readable
            with open(seg.path, "rb") as f:
                for key, e in sorted(items, key=lambda it: it[1].offset):
                    f.seek(e.offset)
                    rec = f.read(e.rec_len)
                    if len(rec) < e.rec_len:
                        continue
                    payload = self._record_payload(rec)
                    if payload is None:
                        continue
                    out[key] = self._decode(e, payload)
                    self.stats["bytes_read"] += e.rec_len
        return out

    def get(self, window_key, block_id):
        key = (normalize_window_key(window_key), int(block_id))
        with self._lock:
            hit = self._cache.pop(key, None)
            if hit is not None:
                self._cache_bytes -= hit[1]
                self.stats["gets"] += 1
                if key in self._readahead_wanted:
                    self._readahead_wanted.discard(key)
                    self.stats["readahead_hits"] += 1
                return hit[0]
            loc = self._index.get(key)
            if loc is None:
                return None
            self.stats["gets"] += 1
            if key in self._readahead_wanted:
                # a prefetch was requested but the entry is gone
                # (evicted, or invalidated by a re-put): that is a
                # readahead miss; plain demand reads with no prefetch
                # opportunity do not count
                self._readahead_wanted.discard(key)
                self.stats["readahead_misses"] += 1
            got = self._read_records([(key, loc[0], loc[1])])
            return got.get(key)

    def get_many(self, keys: List[BlockKey]):
        with self._lock:
            self.stats["batched_reads"] += 1
            normed = [(normalize_window_key(wk), int(bid))
                      for wk, bid in keys]
            results: Dict[BlockKey, Optional[dict]] = {}
            misses: List[Tuple[BlockKey, int, _Entry]] = []
            for key in normed:
                hit = self._cache.pop(key, None)
                if hit is not None:
                    self._cache_bytes -= hit[1]
                    if key in self._readahead_wanted:
                        self._readahead_wanted.discard(key)
                        self.stats["readahead_hits"] += 1
                    results[key] = hit[0]
                    continue
                loc = self._index.get(key)
                if loc is None:
                    results[key] = None
                else:
                    if key in self._readahead_wanted:
                        self._readahead_wanted.discard(key)
                        self.stats["readahead_misses"] += 1
                    misses.append((key, loc[0], loc[1]))
            got = self._read_records(misses)
            self.stats["gets"] += len(normed)
            return [results[key] if key in results else got.get(key)
                    for key in normed]

    def readahead(self, keys: Iterable[BlockKey]) -> None:
        with self._lock:
            want: List[Tuple[BlockKey, int, _Entry]] = []
            for wk, bid in keys:
                key = (normalize_window_key(wk), int(bid))
                loc = self._index.get(key)
                if loc is None:
                    continue
                self._readahead_wanted.add(key)
                if key in self._cache:
                    continue
                want.append((key, loc[0], loc[1]))
            if not want:
                return
            got = self._read_records(want)
            for key, _, e in want:
                arrays = got.get(key)
                if arrays is not None:
                    # budget the cache by what actually sits in memory:
                    # the decoded FULL-CAPACITY arrays, not the
                    # fill-sliced on-disk record (a near-empty tail
                    # block decodes to capacity-sized arrays)
                    decoded = payload_nbytes(e.cap, e.width)
                    self._cache_add(key, arrays, decoded)
                    self.stats["readahead_bytes"] += e.rec_len

    # ------------------------------------------- segment-granular prefetch
    def segments_for(self, keys):
        """Physical placement of the live records behind ``keys``:
        ``segment_id -> [(key, offset, record_len)]``, offsets ascending.
        Pure index query (no payload reads) — the learned prefetch
        planner merges this across windows into per-segment sweeps."""
        out: Dict[int, List[Tuple[BlockKey, int, int]]] = {}
        with self._lock:
            for wk, bid in keys:
                key = (normalize_window_key(wk), int(bid))
                loc = self._index.get(key)
                if loc is None:
                    continue
                sid, e = loc
                out.setdefault(sid, []).append((key, e.offset, e.rec_len))
        for items in out.values():
            items.sort(key=lambda it: it[1])
        return out

    def readahead_segments(self, sid, keys):
        """Sweep segment ``sid`` once — one contiguous read spanning
        ``keys``'s records — and cache the decoded blocks. Records whose
        live copy moved to another segment (re-put, compaction) since
        planning are skipped; a very sparse span degrades gracefully to
        the per-record batched path. Returns blocks cached."""
        with self._lock:
            seg = self._segs.get(sid)
            if seg is None:
                return 0
            want: List[Tuple[BlockKey, _Entry]] = []
            for wk, bid in keys:
                key = (normalize_window_key(wk), int(bid))
                loc = self._index.get(key)
                if loc is None or loc[0] != sid:
                    continue
                self._readahead_wanted.add(key)
                if key in self._cache:
                    continue
                want.append((key, loc[1]))
            if not want:
                return 0
            want.sort(key=lambda it: it[1].offset)
            lo = want[0][1].offset
            hi = max(e.offset + e.rec_len for _, e in want)
            rec_bytes = sum(e.rec_len for _, e in want)
            span = hi - lo
            if span > 4 * rec_bytes and span - rec_bytes > (64 << 10):
                # plan went stale (compaction/superseding holes): the
                # sequential read would mostly drag dead bytes — fall
                # back to the per-record sweep
                got = self._read_records([(k, sid, e) for k, e in want])
            else:
                if sid == self._active_sid:
                    self._active_f.flush()
                with open(seg.path, "rb") as f:
                    f.seek(lo)
                    blob = f.read(span)
                self.stats["bytes_read"] += len(blob)
                self.stats["sweep_bytes_read"] += len(blob)
                got = {}
                for key, e in want:
                    rec = blob[e.offset - lo:e.offset - lo + e.rec_len]
                    if len(rec) < e.rec_len:
                        continue
                    payload = self._record_payload(rec)
                    if payload is not None:
                        got[key] = self._decode(e, payload)
            self.stats["segment_sweeps"] += 1
            for key, e in want:
                arrays = got.get(key)
                if arrays is not None:
                    decoded = payload_nbytes(e.cap, e.width)
                    self._cache_add(key, arrays, decoded)
                    self.stats["readahead_bytes"] += e.rec_len
            return len(got)

    def _window_locs(self, wk: WindowKey
                     ) -> List[Tuple[BlockKey, int, _Entry]]:
        return sorted(((key, sid, e)
                       for key, (sid, e) in self._index.items()
                       if key[0] == wk),
                      key=lambda t: (t[1], t[2].offset))

    def window_scatter(self, window_key):
        """(records, segments, span_bytes, record_bytes) for a window's
        live records — span is summed per segment, so a freshly
        coalesced window reports span == record_bytes."""
        wk = normalize_window_key(window_key)
        with self._lock:
            locs = self._window_locs(wk)
            if not locs:
                return (0, 0, 0, 0)
            per_seg: Dict[int, List[_Entry]] = {}
            for _, sid, e in locs:
                per_seg.setdefault(sid, []).append(e)
            span = sum(max(e.offset + e.rec_len for e in es)
                       - min(e.offset for e in es)
                       for es in per_seg.values())
            rec_bytes = sum(e.rec_len for _, _, e in locs)
            return (len(locs), len(per_seg), span, rec_bytes)

    def coalesce_windows(self, window_keys) -> int:
        """Rewrite each window's scattered live records into one
        contiguous run at the log tail, so a predicted re-stage becomes
        a single dense sequential sweep. Windows already dense in one
        segment are skipped (idempotent); the superseded copies become
        dead bytes that cleanup-driven compaction reclaims. Commits
        before returning."""
        rewrote = 0
        with self._lock:
            for window_key in window_keys:
                wk = normalize_window_key(window_key)
                locs = self._window_locs(wk)
                if len(locs) < 2:
                    continue
                _, n_segs, span, rec_bytes = self.window_scatter(wk)
                if rec_bytes >= self.segment_bytes:
                    continue    # bigger than a segment: can't be one run
                # already dense: contiguous per segment, in at most two
                # segments (a tail rewrite may straddle one roll) —
                # rewriting again would churn bytes for no read benefit
                if n_segs <= 2 and span <= 1.5 * rec_bytes:
                    continue
                by_seg: Dict[int, List[Tuple[BlockKey, _Entry]]] = {}
                for key, sid, e in locs:
                    by_seg.setdefault(sid, []).append((key, e))
                for sid in sorted(by_seg):
                    seg = self._segs.get(sid)
                    if seg is None:
                        continue
                    if sid == self._active_sid:
                        self._active_f.flush()
                    with open(seg.path, "rb") as f:
                        for key, e in by_seg[sid]:
                            loc = self._index.get(key)
                            if loc is None or loc[0] != sid \
                                    or loc[1].offset != e.offset:
                                continue       # raced with a re-put
                            f.seek(e.offset)
                            rec = f.read(e.rec_len)
                            if len(rec) < e.rec_len:
                                continue
                            payload = self._record_payload(rec)
                            if payload is None:
                                continue
                            self._cache_drop(key)
                            # raw payload re-append: the new record
                            # supersedes the scattered copy in-index
                            self._append_record(REC_VALUE, key, e.fill,
                                                e.cap, e.width, payload)
                rewrote += 1
                self.stats["coalesced_windows"] += 1
                self.stats["coalesce_bytes"] += rec_bytes
            if rewrote:
                self._commit_locked()
        return rewrote

    # ---------------------------------------------------------- inventory
    def current_fill(self, window_key, block_id):
        key = (normalize_window_key(window_key), int(block_id))
        with self._lock:
            loc = self._index.get(key)
            return None if loc is None else loc[1].fill

    def locate(self, window_key, block_id):
        key = (normalize_window_key(window_key), int(block_id))
        with self._lock:
            loc = self._index.get(key)
            return None if loc is None else (loc[0], loc[1].offset)

    def keys(self) -> List[BlockKey]:
        with self._lock:
            return list(self._index)

    def live_bytes(self) -> int:
        with self._lock:
            return self._live_payload

    def live_record_bytes(self) -> int:
        """Live bytes including record framing (the on-disk comparable)."""
        with self._lock:
            return sum(s.live_bytes for s in self._segs.values())

    def on_disk_bytes(self) -> int:
        with self._lock:
            return sum(s.size for s in self._segs.values())

    # ------------------------------------------------- space reclamation
    def compact_if_needed(self, max_ratio: float = 2.0) -> int:
        """Consume tombstones: rewrite victims' live records into the
        active segment and drop the victim files until on-disk bytes <=
        max(``max_ratio`` x live record bytes, one segment)."""
        reclaimed = 0
        with self._lock:
            self._commit_locked()
            while True:
                live = self.live_record_bytes()
                target = max(max_ratio * live, float(self.segment_bytes))
                if self.on_disk_bytes() <= target:
                    break
                victim = None
                best = 0
                for seg in self._segs.values():
                    if seg.sealed and seg.dead_bytes > best:
                        victim, best = seg, seg.dead_bytes
                if victim is None:
                    a = self._active
                    if a.dead_bytes > 0 and a.size > 0:
                        # dead weight only in the active segment: seal
                        # it (committed above) so it becomes a victim
                        self._commit_locked()
                        self._seal_active()
                        continue
                    break
                reclaimed += self._compact_segment(victim)
            if reclaimed:
                self._commit_locked()
                self.stats["compactions"] += 1
        return reclaimed

    def _compact_segment(self, victim: _Seg) -> int:
        """Rewrite ``victim``'s live records (and still-needed
        tombstones) into the active segment, then drop the file."""
        victim_copies: Dict[BlockKey, int] = {}
        for e in victim.entries:
            if e.rtype == REC_VALUE:
                victim_copies[e.key] = victim_copies.get(e.key, 0) + 1
        moved_bytes = 0
        with open(victim.path, "rb") as f:
            for e in victim.entries:
                if e.rtype == REC_VALUE:
                    loc = self._index.get(e.key)
                    if loc is None or loc[0] != victim.sid \
                            or loc[1].offset != e.offset:
                        continue               # superseded or deleted
                    f.seek(e.offset + _REC_HDR.size)
                    payload = f.read(e.rec_len - _REC_HDR.size
                                     - _CRC.size)
                    # re-append through the normal write path (the new
                    # record supersedes the victim's copy in the index)
                    self._append_record(REC_VALUE, e.key, e.fill, e.cap,
                                        e.width, payload)
                    moved_bytes += e.rec_len
                else:
                    # keep the tombstone while stale value records for
                    # its key survive outside this victim — dropping it
                    # early would resurrect them on replay
                    remaining = self._key_copies.get(e.key, 0) \
                        - victim_copies.get(e.key, 0)
                    if e.key not in self._index and remaining > 0:
                        self._append_record(REC_TOMB, e.key, 0, 0, 0, b"")
        # the victim's value records are gone: drop their copy counts
        for key, n in victim_copies.items():
            left = self._key_copies.get(key, 0) - n
            if left > 0:
                self._key_copies[key] = left
            else:
                self._key_copies.pop(key, None)
        # durability order: new copies are fsynced before the old file
        # disappears
        self._commit_locked()
        size = victim.size
        del self._segs[victim.sid]
        os.unlink(victim.path)
        self.stats["bytes_compacted"] += size
        return size - moved_bytes

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            self._commit_locked()
            if self._active_f is not None:
                self._active_f.close()
                self._active_f = None
            if self._wal_f is not None:
                self._wal_f.close()
                self._wal_f = None

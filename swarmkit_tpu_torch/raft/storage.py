"""Encrypted raft log persistence: write-ahead log + snapshots.

Behavioral reference: manager/state/raft/storage/ (EncryptedRaftLogger
storage.go:37, walwrap.go, snapwrap.go) — every record is wrapped in a
MaybeEncryptedRecord envelope so the log is encrypted at rest with a DEK, the
DEK can rotate without closing the WAL (old records decrypt via a
MultiDecrypter), and old WALs/snapshots are GC'd after a snapshot.

Design differences (deliberate): instead of etcd's wal/snap packages we use
self-contained WAL segments — `save_snapshot` writes the snapshot file AND
starts a fresh segment seeded with the entries beyond the snapshot index, so
boot = read newest valid snapshot + replay exactly one segment.  Records are
length+crc32 framed; a torn tail record is dropped (crash tolerance), and a
corrupt record mid-file raises.

The port's own copy of the JAX package's raft/storage.py.  Its records
pack with raft/wire.py's ``packb``/``unpackb`` (byte for byte msgpack's,
which the JAX package uses), so a state_dir one package writes bootstraps
the other's node; the frames go through native/'s compiled codec, built
at the first write or read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

from swarmkit_tpu_torch.encryption import (
    Decrypter, Encrypter, MaybeEncryptedRecord, MultiDecrypter, NopCrypter,
)
from swarmkit_tpu_torch.raft.messages import Entry, EntryType, HardState, Snapshot, SnapshotMeta
from swarmkit_tpu_torch.raft.wire import packb, unpackb

# record types
_REC_HARDSTATE = 1
_REC_ENTRY = 2

# frame layout lives in native/wal_codec.cpp: u32 len, u32 crc32, body


class DataCorrupt(Exception):
    pass


@dataclass
class BootstrapResult:
    hard_state: Optional[HardState]
    entries: list
    snapshot: Optional[Snapshot]


def _pack_entry(e: Entry) -> bytes:
    return packb((e.index, e.term, int(e.type), e.data))


def _unpack_entry(raw: bytes) -> Entry:
    index, term, typ, data = unpackb(raw)
    return Entry(index=index, term=term, type=EntryType(typ), data=data)


def _pack_hardstate(hs: HardState) -> bytes:
    return packb((hs.term, hs.vote, hs.commit))


def _unpack_hardstate(raw: bytes) -> HardState:
    term, vote, commit = unpackb(raw)
    return HardState(term=term, vote=vote, commit=commit)


def _pack_snapshot(s: Snapshot) -> bytes:
    return packb(
        (s.meta.index, s.meta.term, list(s.meta.voters), s.data))


def _unpack_snapshot(raw: bytes) -> Snapshot:
    index, term, voters, data = unpackb(raw)
    return Snapshot(meta=SnapshotMeta(index=index, term=term,
                                      voters=tuple(voters)), data=data)


class _Segment:
    """One append-only WAL file of framed, enveloped records."""

    def __init__(self, path: str, encrypter: Encrypter) -> None:
        self.path = path
        self.encrypter = encrypter
        self._f = open(path, "ab")

    def append(self, rec_type: int, payload: bytes) -> None:
        self.append_many([(rec_type, payload)])

    def append_many(self, records: list[tuple[int, bytes]]) -> None:
        """Batch-frame records in one native call (native/wal_codec.cpp —
        the analog of etcd/wal's compiled encoder)."""
        from swarmkit_tpu_torch.native import wal_codec

        bodies = [self.encrypter.encrypt(
            packb((rt, pl))).encode() for rt, pl in records]
        self._f.write(wal_codec().frame(bodies))

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self.sync()
        except (OSError, ValueError):
            pass
        self._f.close()


def _read_segment(path: str, decrypter: Decrypter) -> list[tuple[int, bytes]]:
    """Validated scan via the native codec (torn tails dropped, mid-WAL
    corruption fatal — matching etcd/wal semantics)."""
    from swarmkit_tpu_torch.native import STATUS_CORRUPT, wal_codec

    with open(path, "rb") as f:
        blob = f.read()
    bodies, status = wal_codec().scan(blob)
    if status == STATUS_CORRUPT:
        raise DataCorrupt(f"crc mismatch mid-WAL in {path}")
    records = []
    for body in bodies:
        raw = decrypter.decrypt(MaybeEncryptedRecord.decode(body))
        rec_type, payload = unpackb(raw)
        records.append((rec_type, payload))
    return records


class EncryptedRaftLogger:
    """reference: storage.EncryptedRaftLogger storage.go:37."""

    def __init__(self, state_dir: str,
                 encrypter: Optional[Encrypter] = None,
                 decrypter: Optional[Decrypter] = None) -> None:
        self.state_dir = state_dir
        self.raft_dir = os.path.join(state_dir, "raft")
        nop = NopCrypter()
        self.encrypter: Encrypter = encrypter or nop
        # always able to read plaintext records too (pre-autolock logs)
        self.decrypter: Decrypter = MultiDecrypter(decrypter or nop, nop)
        self._segment: Optional[_Segment] = None

    # -- paths -------------------------------------------------------------
    def _wal_path(self, index: int) -> str:
        return os.path.join(self.raft_dir, f"wal-{index:016x}.log")

    def _snap_path(self, index: int) -> str:
        return os.path.join(self.raft_dir, f"snap-{index:016x}.bin")

    def _list(self, prefix: str) -> list[tuple[int, str]]:
        if not os.path.isdir(self.raft_dir):
            return []
        out = []
        for name in os.listdir(self.raft_dir):
            if name.startswith(prefix):
                hex_part = name[len(prefix):].split(".")[0]
                try:
                    out.append((int(hex_part, 16),
                                os.path.join(self.raft_dir, name)))
                except ValueError:
                    continue
        return sorted(out)

    def has_existing_state(self) -> bool:
        return bool(self._list("wal-") or self._list("snap-"))

    # -- bootstrap ---------------------------------------------------------
    def bootstrap_new(self) -> None:
        """reference: BootstrapNew storage.go:144."""
        os.makedirs(self.raft_dir, exist_ok=True)
        self._segment = _Segment(self._wal_path(0), self.encrypter)

    def bootstrap_from_disk(self) -> BootstrapResult:
        """reference: BootstrapFromDisk storage.go:52 — newest readable
        snapshot + its segment replayed."""
        snapshot = None
        snap_index = 0
        for index, path in reversed(self._list("snap-")):
            try:
                with open(path, "rb") as f:
                    raw = self.decrypter.decrypt(
                        MaybeEncryptedRecord.decode(f.read()))
                snapshot = _unpack_snapshot(raw)
                snap_index = index
                break
            except Exception:
                continue  # fall back to an older snapshot
        # choose the newest segment at-or-below the snapshot index (each
        # segment is self-contained from its snapshot)
        segs = self._list("wal-")
        chosen = None
        for index, path in segs:
            if index <= snap_index or chosen is None:
                chosen = (index, path)
            # also prefer exactly the snapshot's own segment if present
        for index, path in segs:
            if index == snap_index:
                chosen = (index, path)
        hard_state: Optional[HardState] = None
        entries: list[Entry] = []
        if chosen is not None:
            for rec_type, payload in _read_segment(chosen[1], self.decrypter):
                if rec_type == _REC_HARDSTATE:
                    hard_state = _unpack_hardstate(payload)
                elif rec_type == _REC_ENTRY:
                    e = _unpack_entry(payload)
                    # later appends at same index override (term conflicts)
                    while entries and entries[-1].index >= e.index:
                        entries.pop()
                    entries.append(e)
        if snapshot is not None:
            entries = [e for e in entries if e.index > snap_index]
        os.makedirs(self.raft_dir, exist_ok=True)
        seg_path = chosen[1] if chosen is not None else self._wal_path(snap_index)
        self._segment = _Segment(seg_path, self.encrypter)
        return BootstrapResult(hard_state, entries, snapshot)

    # -- writes ------------------------------------------------------------
    def save(self, hard_state: Optional[HardState],
             entries: Sequence[Entry]) -> None:
        """Persist one Ready batch (reference: SaveEntries storage.go:320);
        single fsync per batch, like wal.Save."""
        if self._segment is None:
            raise RuntimeError("logger not bootstrapped")
        records: list[tuple[int, bytes]] = []
        if hard_state is not None:
            records.append((_REC_HARDSTATE, _pack_hardstate(hard_state)))
        records.extend((_REC_ENTRY, _pack_entry(e)) for e in entries)
        if records:
            self._segment.append_many(records)
            self._segment.sync()

    def save_snapshot(self, snapshot: Snapshot,
                      retained_entries: Sequence[Entry] = (),
                      hard_state: Optional[HardState] = None) -> None:
        """Write snapshot + start a fresh self-contained segment
        (reference: SaveSnapshot storage.go:198)."""
        index = snapshot.meta.index
        tmp = self._snap_path(index) + ".tmp"
        os.makedirs(self.raft_dir, exist_ok=True)
        with open(tmp, "wb") as f:
            f.write(self.encrypter.encrypt(_pack_snapshot(snapshot)).encode())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path(index))
        old = self._segment
        seg_path = self._wal_path(index)
        if old is not None and os.path.abspath(old.path) == os.path.abspath(seg_path):
            return  # re-snapshot at same index; keep segment
        self._segment = _Segment(seg_path, self.encrypter)
        if hard_state is not None:
            self._segment.append(_REC_HARDSTATE, _pack_hardstate(hard_state))
        for e in retained_entries:
            if e.index > index:
                self._segment.append(_REC_ENTRY, _pack_entry(e))
        self._segment.sync()
        if old is not None:
            old.close()

    def gc(self, snap_index: int) -> None:
        """Drop WALs/snapshots older than the given snapshot
        (reference: GC storage.go:221)."""
        for index, path in self._list("snap-"):
            if index < snap_index:
                os.unlink(path)
        keep = {os.path.abspath(self._segment.path)} if self._segment else set()
        for index, path in self._list("wal-"):
            if index < snap_index and os.path.abspath(path) not in keep:
                os.unlink(path)

    # -- key rotation ------------------------------------------------------
    def rotate_encryption_key(self, encrypter: Encrypter,
                              decrypter: Decrypter) -> None:
        """Switch the DEK for subsequent writes without closing the WAL
        (reference: RotateEncryptionKey storage.go:175).  Full re-encryption
        of history completes at the next snapshot, which starts a fresh
        segment under the new key."""
        self.encrypter = encrypter
        self.decrypter = MultiDecrypter(decrypter, self.decrypter)
        if self._segment is not None:
            self._segment.encrypter = encrypter

    def close(self) -> None:
        if self._segment is not None:
            self._segment.close()
            self._segment = None

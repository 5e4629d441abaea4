"""In-memory raft log with compaction watermark.

Behavioral reference: vendor/github.com/coreos/etcd/raft/log.go (raftLog:
maybeAppend/commitTo/isUpToDate) and storage.go (MemoryStorage compaction).
The stable/unstable split is collapsed: the host shell persists entries from
Ready before sending messages, which preserves the durability ordering the
reference gets from its two-level log.
"""

from __future__ import annotations

from typing import Optional, Sequence

from swarmkit_tpu_torch.raft.messages import Entry, Snapshot, SnapshotMeta


class CompactedError(Exception):
    """Requested index was already compacted away."""


class UnavailableError(Exception):
    """Requested index is beyond the last index."""


class RaftLog:
    def __init__(self, snapshot: Optional[Snapshot] = None):
        snap = snapshot or Snapshot()
        # offset = index of the entry *before* entries[0] (the snapshot index).
        self.offset = snap.meta.index
        self.offset_term = snap.meta.term
        self.entries: list[Entry] = []
        self.committed = snap.meta.index
        self.applied = snap.meta.index
        # Highest index known persisted to stable storage (WAL). Entries above
        # this appear in Ready.entries for the shell to persist.
        self.stable = snap.meta.index
        self.pending_snapshot: Optional[Snapshot] = snap if not snap.empty else None

    # -- indexes -----------------------------------------------------------
    def first_index(self) -> int:
        return self.offset + 1

    def last_index(self) -> int:
        return self.offset + len(self.entries)

    def term(self, i: int) -> int:
        if i == self.offset:
            return self.offset_term
        if i < self.offset:
            raise CompactedError(i)
        if i > self.last_index():
            raise UnavailableError(i)
        return self.entries[i - self.offset - 1].term

    def zero_term(self, i: int) -> int:
        """term() but 0 on compacted/unavailable (zeroTermOnErrCompacted)."""
        try:
            return self.term(i)
        except (CompactedError, UnavailableError):
            return 0

    def last_term(self) -> int:
        return self.zero_term(self.last_index())

    def match_term(self, i: int, t: int) -> bool:
        try:
            return self.term(i) == t
        except (CompactedError, UnavailableError):
            return False

    def is_up_to_date(self, lasti: int, term: int) -> bool:
        return term > self.last_term() or (
            term == self.last_term() and lasti >= self.last_index())

    # -- slices ------------------------------------------------------------
    def slice(self, lo: int, hi: int, limit: Optional[int] = None) -> list[Entry]:
        """Entries in [lo, hi); raises on compacted lo."""
        if lo <= self.offset:
            raise CompactedError(lo)
        hi = min(hi, self.last_index() + 1)
        out = self.entries[lo - self.offset - 1: hi - self.offset - 1]
        if limit is not None:
            out = out[:limit]
        return list(out)

    def entries_from(self, i: int, limit: Optional[int] = None) -> list[Entry]:
        if i > self.last_index():
            return []
        return self.slice(i, self.last_index() + 1, limit)

    def unapplied_entries(self) -> list[Entry]:
        if self.committed <= self.applied:
            return []
        return self.slice(self.applied + 1, self.committed + 1)

    # -- mutation ----------------------------------------------------------
    def append(self, ents: Sequence[Entry]) -> int:
        if not ents:
            return self.last_index()
        after = ents[0].index - 1
        if after < self.committed:
            raise ValueError(f"append after {after} < committed {self.committed}")
        # Truncate any conflicting suffix, then extend.
        self.entries = self.entries[: after - self.offset]
        self.entries.extend(ents)
        self.stable = min(self.stable, after)
        return self.last_index()

    def find_conflict(self, ents: Sequence[Entry]) -> int:
        for e in ents:
            if not self.match_term(e.index, e.term):
                return e.index
        return 0

    def maybe_append(self, index: int, log_term: int, committed: int,
                     ents: Sequence[Entry]) -> Optional[int]:
        """Follower append path (raftLog.maybeAppend). Returns new last index
        on success, None on prev-entry mismatch."""
        if not self.match_term(index, log_term):
            return None
        lastnewi = index + len(ents)
        ci = self.find_conflict(ents)
        if ci != 0:
            if ci <= self.committed:
                raise ValueError(f"conflict {ci} <= committed {self.committed}")
            self.append([e for e in ents if e.index >= ci])
        self.commit_to(min(committed, lastnewi))
        return lastnewi

    def commit_to(self, tocommit: int) -> None:
        if tocommit > self.committed:
            if tocommit > self.last_index():
                raise ValueError(
                    f"commit {tocommit} out of range [last {self.last_index()}]")
            self.committed = tocommit

    def maybe_commit(self, max_index: int, term: int) -> bool:
        if max_index > self.committed and self.zero_term(max_index) == term:
            self.commit_to(max_index)
            return True
        return False

    def applied_to(self, i: int) -> None:
        if i == 0:
            return
        if i < self.applied or i > self.committed:
            raise ValueError(
                f"applied({i}) out of [{self.applied}, {self.committed}]")
        self.applied = i

    def compact(self, i: int) -> None:
        """Drop entries <= i (they live in a snapshot now)."""
        if i <= self.offset:
            return
        if i > self.applied:
            raise ValueError(f"compact {i} > applied {self.applied}")
        t = self.term(i)
        self.entries = self.entries[i - self.offset:]
        self.offset = i
        self.offset_term = t

    def restore(self, snap: Snapshot) -> None:
        self.entries = []
        self.offset = snap.meta.index
        self.offset_term = snap.meta.term
        self.committed = snap.meta.index
        self.applied = snap.meta.index
        self.stable = snap.meta.index
        self.pending_snapshot = snap

    def unstable_entries(self) -> list[Entry]:
        if self.stable >= self.last_index():
            return []
        return self.slice(max(self.stable + 1, self.first_index()),
                          self.last_index() + 1)

    def stabilized(self, to: int) -> None:
        self.stable = max(self.stable, min(to, self.last_index()))

    def snapshot_meta(self) -> SnapshotMeta:
        return SnapshotMeta(index=self.offset, term=self.offset_term)

"""The plain reference: what a fault-free raft cluster's log must hold.

NumPy only; it imports nothing of the program.  Its input is the run's
schedule as the harness recorded it (``Record``): the ticks at which the
client offered proposals, the ticks during which the sitting leader was
held down, and the tick and term of each election won.  From that it
builds the log every row must agree on, entry by entry:

- an election won at tick t appends one empty entry (term, data 0);
- a tick t at which a leader is up appends the `count` offered proposals
  in order, entry k carrying the payload ``(t * 2**16 + k + 1) mod 2**32``
  with bit 31 cleared (the traffic's payload, as run_ticks documents it)
  and the leader's term;
- nothing is appended at a tick whose leader is held down.

``judge`` holds the program's final state (host copies, read after the
window) to that log: one leader, every offered proposal committed in its
tick on the synchronous wire (or within the mix's ``commit_lag_entries``
of it), the leader's commit on a majority of rows, cursors in order, no
row more than the mix's ``behind_batches`` batches behind, each row's
apply and snapshot checksums equal to the sum of entry checksums over its
prefix, and, on sampled rows, every slot of the ring between the
snapshot and the row's last index.  With reads, no read refused, every
served batch at or past its goal, and the count served inside the
protocol's bounds.  Every number is an exact count with the limit 0.

The reference follows the program's elections (their tick and term come
from the program's trace rows): it cannot predict which row wins.  What
that skips is checked by itself.  The first entry of each term must be
the empty entry at the index the reference gives it, so a win reported
at another tick shifts every later entry and fails the log's slots and
checksums.  Each election's term must pass the one before it
(``term_order``), and, where one round of votes always wins (the
fault-free synchronous wire, where every voter grants the lowest
candidate of a tick; ``one_round_elections``), be exactly one more
(``term_rounds``): a program that kept or reused a term fails there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MASK = 0xFFFF_FFFF
PAYLOAD_MASK = 0x7FFF_FFFF
LEADER = 2                 # the state's role code of a leader


@dataclass
class Record:
    """The run's schedule, in the order the harness drove it."""
    n: int
    log_len: int
    read_batch: int = 0
    # ("elect", tick, term), ("props", first_tick, n_ticks, count),
    # ("down", first_tick, last_tick): the leader held down, inclusive
    events: list = field(default_factory=list)

    def elect(self, tick: int, term: int) -> None:
        self.events.append(("elect", int(tick), int(term)))

    def props(self, tick: int, n_ticks: int, count: int) -> None:
        if n_ticks > 0 and count > 0:
            self.events.append(("props", int(tick), int(n_ticks),
                                int(count)))

    def down(self, first: int, last: int) -> None:
        self.events.append(("down", int(first), int(last)))


def hash32(u: np.ndarray) -> np.ndarray:
    """splitmix32-style mix of uint64 values below 2**32 (uint64
    arithmetic wraps mod 2**64, which keeps the low 32 bits exact)."""
    u = u ^ (u >> np.uint64(16))
    u = (u * np.uint64(0x7FEB352D)) & np.uint64(MASK)
    u = u ^ (u >> np.uint64(15))
    u = (u * np.uint64(0x846CA68B)) & np.uint64(MASK)
    return u ^ (u >> np.uint64(16))


def entry_chk(idx: np.ndarray, data: np.ndarray) -> np.ndarray:
    """The state machine's checksum of one entry (order-independent: the
    checksum of a prefix is the sum of its entries' mod 2**32)."""
    u = ((idx.astype(np.uint64) * np.uint64(0x01000193)) & np.uint64(MASK)) \
        ^ (data.astype(np.uint64) & np.uint64(MASK))
    return hash32(u)


def payloads(ticks: np.ndarray, count: int) -> np.ndarray:
    """[len(ticks) * count] uint64 payloads, tick-major."""
    t = ticks.astype(np.uint64)[:, None] << np.uint64(16)
    k = np.arange(count, dtype=np.uint64)[None, :] + np.uint64(1)
    return (((t + k) & np.uint64(MASK)) & np.uint64(PAYLOAD_MASK)).ravel()


@dataclass
class Log:
    """The expected log: term[i], data[i] and prefix checksum chk[i] of
    index i (1-based; index 0 is the empty prefix)."""
    term: np.ndarray
    data: np.ndarray
    chk: np.ndarray
    offered: int           # proposals offered
    appended: int          # proposals the log holds

    @property
    def last(self) -> int:
        return len(self.term) - 1


def expected_log(rec: Record) -> Log:
    downs = [(e[1], e[2]) for e in rec.events if e[0] == "down"]
    # (tick, order, kind, ...): proposals at a tick's start, elections won
    # at its end
    items = []
    offered = 0
    for e in rec.events:
        if e[0] == "elect":
            items.append((e[1], 1, e))
        elif e[0] == "props":
            t0, nt, cnt = e[1], e[2], e[3]
            offered += nt * cnt
            ticks = np.arange(t0, t0 + nt, dtype=np.int64)
            keep = np.ones(nt, dtype=bool)
            for a, b in downs:
                keep &= ~((ticks >= a) & (ticks <= b))
            items.append((t0, 0, ("props", ticks[keep], cnt)))
    items.sort(key=lambda x: (x[0], x[1]))
    terms, datas = [np.zeros(1, np.int64)], [np.zeros(1, np.uint64)]
    term = 0
    appended = 0
    for _, _, e in items:
        if e[0] == "elect":
            term = e[2]
            terms.append(np.array([term], np.int64))
            datas.append(np.zeros(1, np.uint64))
        else:
            ticks, cnt = e[1], e[2]
            if len(ticks) == 0:
                continue
            if term == 0:
                raise ValueError("proposals before any election")
            d = payloads(ticks, cnt)
            datas.append(d)
            terms.append(np.full(len(d), term, np.int64))
            appended += len(d)
    term_a = np.concatenate(terms)
    data_a = np.concatenate(datas)
    idx = np.arange(len(term_a), dtype=np.uint64)
    c = entry_chk(idx, data_a)
    c[0] = 0
    chk = np.cumsum(c, dtype=np.uint64) & np.uint64(MASK)
    return Log(term_a, data_a, chk, offered, appended)


@dataclass
class Outputs:
    """The program's outputs the judge reads (host arrays, int64; the
    checksums and ring payloads as their unsigned 32 bits)."""
    role: np.ndarray
    term: np.ndarray
    last: np.ndarray
    commit: np.ndarray
    applied: np.ndarray
    snap_idx: np.ndarray
    apply_chk: np.ndarray
    snap_chk: np.ndarray
    rows: np.ndarray               # sampled row ids
    ring_term: np.ndarray          # [len(rows), log_len]
    ring_data: np.ndarray
    reads: dict | None = None      # served/blocked deltas, srv_idx/goal


def sample_rows(n: int, seed: int, k: int = 32) -> np.ndarray:
    """k distinct rows drawn from the seed (the leader is added by the
    caller)."""
    rng = np.random.default_rng(seed & MASK)
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def election_terms(rec: Record) -> dict:
    """{name: (number, limit)}: the terms of the recorded elections
    against each other (the first against term 0)."""
    terms = [0] + [e[2] for e in rec.events if e[0] == "elect"]
    steps = np.diff(np.array(terms, np.int64))
    return {"term_order": (int((steps <= 0).sum()), 0),
            "term_rounds": (int((steps != 1).sum()), 0)}


def judge(out: Outputs, log: Log, rec: Record, max_props: int,
          window_ticks: int = 0, commit_lag_entries: int = 0,
          behind_batches: int = 2, one_round_elections: bool = True
          ) -> dict:
    """{name: (number, limit)}: each an exact count that must not pass
    its limit.  The keyword arguments after `window_ticks` are the mix's
    ``judge`` parameters."""
    n, L, M = rec.n, rec.log_len, log.last
    quorum = n // 2 + 1
    checks: dict = {}
    leaders = np.flatnonzero(out.role == LEADER)
    checks["leaders_off"] = (abs(len(leaders) - 1), 0)
    lead_commit = int(out.commit[leaders].max()) if len(leaders) else 0
    lead_term = int(out.term[leaders].max()) if len(leaders) else -1
    # the leader's commit lies in [M - commit_lag_entries, M]
    checks["commit_gap"] = (max(0, M - commit_lag_entries - lead_commit)
                            + max(0, lead_commit - M), 0)
    checks["term_rows"] = (int((out.term != lead_term).sum()), 0)
    terms = election_terms(rec)
    checks["term_order"] = terms["term_order"]
    if one_round_elections:
        checks["term_rounds"] = terms["term_rounds"]
    # a majority holds what must be committed, and the leader's commit
    need = max(lead_commit, M - commit_lag_entries)
    checks["minority"] = (max(0, quorum - int((out.last >= need).sum())),
                          0)
    order = (out.snap_idx < 0) | (out.snap_idx > out.applied) \
        | (out.applied > out.commit) | (out.commit > out.last) \
        | (out.last > M)
    checks["order_rows"] = (int(order.sum()), 0)
    # a row more than behind_batches batches behind has stopped following
    checks["stalled_rows"] = (
        int((out.applied < M - behind_batches * max_props).sum()), 0)
    ok = ~order
    app = np.where(ok, out.applied, 0)
    snp = np.where(ok, out.snap_idx, 0)
    checks["apply_chk_rows"] = (
        int((ok & (out.apply_chk != log.chk[app].astype(np.int64))).sum())
        + int(order.sum()), 0)
    checks["snap_chk_rows"] = (
        int((ok & (out.snap_chk != log.chk[snp].astype(np.int64))).sum())
        + int(order.sum()), 0)
    bad = 0
    for j, r in enumerate(out.rows):
        lo, hi = int(out.snap_idx[r]), min(int(out.last[r]), M)
        if hi <= lo:
            continue
        idx = np.arange(lo + 1, hi + 1)
        slot = (idx - 1) % L
        bad += int((out.ring_term[j, slot] != log.term[idx]).sum())
        bad += int((out.ring_data[j, slot]
                    != log.data[idx].astype(np.int64)).sum())
    checks["log_slots"] = (bad, 0)
    if rec.read_batch and out.reads is not None:
        rd, rb = out.reads, rec.read_batch
        checks["reads_blocked"] = (int(rd["blocked"]), 0)
        checks["stale_reads_rows"] = (
            int((rd["srv_idx"] < rd["srv_goal"]).sum()), 0)
        # the leader serves a batch a tick; a follower's batch waits a
        # tick for its commit, so it serves every other tick at least;
        # no row serves more than a batch a tick
        low = rb * (window_ticks + (n - 1) * (window_ticks // 2))
        high = rb * n * window_ticks
        checks["reads_short"] = (max(0, low - int(rd["served"])), 0)
        checks["reads_over"] = (max(0, int(rd["served"]) - high), 0)
    return checks


def control_outputs(log: Log, rec: Record, max_props: int, seed: int,
                    reads: dict | None = None) -> Outputs:
    """The reference put in the program's place with one guarantee
    broken: its leader commits each batch before any follower holds it
    (a quorum of one), so at the end the followers hold the log but its
    last batch.  Everything else is the reference's own log."""
    n, L, M = rec.n, rec.log_len, log.last
    role = np.zeros(n, np.int64)
    role[0] = LEADER
    term = np.full(n, int(log.term[-1]), np.int64)
    f_last = M - max_props
    last = np.full(n, f_last, np.int64)
    last[0] = M
    commit = np.full(n, f_last, np.int64)
    commit[0] = M
    applied = commit.copy()
    snap = np.maximum(applied - 500, 0)
    rows = np.union1d(sample_rows(n, seed), [0])
    ring_t = np.zeros((len(rows), L), np.int64)
    ring_d = np.zeros((len(rows), L), np.int64)
    for j, r in enumerate(rows):
        idx = np.arange(max(int(last[r]) - L + 1, 1), int(last[r]) + 1)
        ring_t[j, (idx - 1) % L] = log.term[idx]
        ring_d[j, (idx - 1) % L] = log.data[idx].astype(np.int64)
    return Outputs(role=role, term=term, last=last, commit=commit,
                   applied=applied, snap_idx=snap,
                   apply_chk=log.chk[applied].astype(np.int64),
                   snap_chk=log.chk[snap].astype(np.int64), rows=rows,
                   ring_term=ring_t, ring_data=ring_d, reads=reads)

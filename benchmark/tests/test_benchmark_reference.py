"""The yardstick's arithmetic by hand: the expected log and its
checksums, the judge and its mix parameters, the election terms, the
failover accounting on synthetic trace rows, and the band copy's byte
count."""

import types

import numpy as np
import pytest
import torch

from benchmark import drive, reference
from benchmark.kernel_bytes import band_bytes


def _hash32(u):
    u &= 0xFFFFFFFF
    u ^= u >> 16
    u = (u * 0x7FEB352D) & 0xFFFFFFFF
    u ^= u >> 15
    u = (u * 0x846CA68B) & 0xFFFFFFFF
    return u ^ (u >> 16)


def _chk(idx, data):
    return _hash32(((idx * 0x01000193) & 0xFFFFFFFF) ^ data)


def test_expected_log_by_hand():
    rec = reference.Record(n=5, log_len=16)
    rec.elect(3, 1)
    rec.props(4, 2, 3)          # ticks 4, 5: three entries each
    rec.props(6, 3, 2)          # ticks 6, 7, 8; 7 and 8 held down
    rec.down(7, 8)
    rec.elect(8, 2)
    rec.props(9, 1, 2)
    log = reference.expected_log(rec)
    want = [(1, 0)] + [(1, (t << 16) + k + 1) for t in (4, 5)
                       for k in range(3)] \
        + [(1, (6 << 16) + k + 1) for k in range(2)] + [(2, 0)] \
        + [(2, (9 << 16) + k + 1) for k in range(2)]
    assert log.last == len(want)
    assert list(zip(log.term[1:].tolist(), log.data[1:].tolist())) == want
    assert log.offered == 6 + 6 + 2 and log.appended == 6 + 2 + 2
    total = 0
    for i, (_, d) in enumerate(want, start=1):
        total = (total + _chk(i, d)) & 0xFFFFFFFF
        assert int(log.chk[i]) == total
    assert int(log.chk[0]) == 0


def test_payload_clears_bit_31():
    d = reference.payloads(np.array([0x8000, 0x7FFF]), 2)
    assert d.tolist() == [1, 2, (0x7FFF << 16) + 1, (0x7FFF << 16) + 2]


def _consistent_outputs(log, rec, P):
    """Every row holds the whole log, applied and committed (the leader
    row 0), snapshotted at M - 4."""
    n, L, M = rec.n, rec.log_len, log.last
    role = np.zeros(n, np.int64)
    role[0] = reference.LEADER
    full = np.full(n, M, np.int64)
    snap = np.full(n, M - 4, np.int64)
    rows = np.arange(n)
    ring_t = np.zeros((n, L), np.int64)
    ring_d = np.zeros((n, L), np.int64)
    idx = np.arange(M - L + 1, M + 1)
    ring_t[:, (idx - 1) % L] = log.term[idx]
    ring_d[:, (idx - 1) % L] = log.data[idx].astype(np.int64)
    return reference.Outputs(
        role=role, term=np.full(n, int(log.term[-1])), last=full,
        commit=full.copy(), applied=full.copy(), snap_idx=snap,
        apply_chk=np.full(n, int(log.chk[M])),
        snap_chk=np.full(n, int(log.chk[M - 4])), rows=rows,
        ring_term=ring_t, ring_data=ring_d)


def test_judge_passes_the_log_and_fails_its_faults():
    rec = reference.Record(n=5, log_len=32)
    rec.elect(2, 1)
    rec.props(3, 6, 4)
    log = reference.expected_log(rec)
    out = _consistent_outputs(log, rec, 4)
    checks = reference.judge(out, log, rec, 4)
    assert all(v == 0 for v, _ in checks.values()), checks
    bad = _consistent_outputs(log, rec, 4)
    bad.ring_data[2, (log.last - 1) % 32] ^= 1   # the last entry altered
    assert reference.judge(bad, log, rec, 4)["log_slots"][0] == 1
    bad = _consistent_outputs(log, rec, 4)
    bad.apply_chk[3] += 1
    assert reference.judge(bad, log, rec, 4)["apply_chk_rows"][0] == 1
    bad = _consistent_outputs(log, rec, 4)
    bad.role[1] = reference.LEADER
    assert reference.judge(bad, log, rec, 4)["leaders_off"][0] == 1
    ctl = reference.control_outputs(log, rec, 4, seed=9)
    assert reference.judge(ctl, log, rec, 4)["minority"][0] > 0


def _planted(name):
    """A fault that only check `name` should see, planted in consistent
    outputs of a 5-row cluster with reads."""
    rec = reference.Record(n=5, log_len=32, read_batch=3)
    rec.elect(2, 1)
    rec.props(3, 6, 4)
    log = reference.expected_log(rec)
    out = _consistent_outputs(log, rec, 4)
    out.reads = {"served": 3 * (10 + 4 * 5), "blocked": 0,
                 "srv_idx": np.full(5, 20), "srv_goal": np.full(5, 20)}
    M = log.last
    if name == "term_rows":
        out.term[3] += 1
    elif name == "order_rows":
        out.applied[2] = M - 1
        out.commit[2] = M - 2
    elif name == "stalled_rows":
        out.applied[4] = out.commit[4] = M - 9
        out.snap_idx[4] = M - 12
        out.apply_chk[4] = int(log.chk[M - 9])
        out.snap_chk[4] = int(log.chk[M - 12])
    elif name == "snap_chk_rows":
        out.snap_chk[1] ^= 4
    elif name == "commit_gap":
        out.commit[0] = M - 1
    elif name == "reads_blocked":
        out.reads["blocked"] = 3
    elif name == "stale_reads_rows":
        out.reads["srv_idx"][2] = 19
    elif name == "reads_short":
        out.reads["served"] //= 2
    elif name == "reads_over":
        out.reads["served"] = 3 * 5 * 10 + 3
    return reference.judge(out, log, rec, 4, window_ticks=10)


@pytest.mark.parametrize("name", [
    "term_rows", "order_rows", "stalled_rows", "snap_chk_rows",
    "commit_gap", "reads_blocked", "stale_reads_rows", "reads_short",
    "reads_over"])
def test_each_number_sees_its_fault(name):
    checks = _planted(name)
    assert checks[name][0] > 0, checks
    assert all(v == 0 for k, (v, _) in checks.items()
               if k not in (name, "order_rows", "apply_chk_rows",
                            "snap_chk_rows", "stalled_rows")), checks


class _Fake:
    """raft.sim's run loops over a scripted cluster: each run_ticks call
    returns the next trace row of `rows`, [n_leaders, max_commit,
    max_term]; `calls` keeps each call's crash_every."""

    def __init__(self, rows, commit0=100, term=3):
        self.rows, self.commit0, self.calls = list(rows), commit0, []
        self.st = types.SimpleNamespace(term=torch.tensor([term, term + 1]))

    def committed_entries(self, st):
        return torch.tensor(self.commit0)

    def run_ticks(self, st, cfg, n, prop_count=0, crash_every=0,
                  down_for=5, device=None, **kw):
        self.calls.append(crash_every)
        return st, torch.tensor([self.rows.pop(0)] * n)

    def leader_mask(self, st):
        return torch.tensor([False, True])


def _driver(fake, max_down=6, crash_every=10):
    cfg = types.SimpleNamespace(n=3, log_len=64, read_batch=0)
    d = drive.Driver(cfg, {"proposals_per_tick": 2, "chunk_ticks": 4,
                           "crash_every": crash_every,
                           "max_down_ticks": max_down},
                     torch.device("cpu"), run=fake)
    d.st, d.tick = fake.st, 40
    return d


def test_failover_accounting_with_an_election():
    # held down 3 ticks; a new leader wins the 4th (two leaders counted)
    # and commits its empty entry in it
    rows = [[1, 100, 4], [1, 100, 4], [1, 100, 4], [2, 101, 4]] \
        + [[1, 120, 4]] * 2
    fake = _Fake(rows)
    d = _driver(fake)
    d.cycle()
    assert d.failovers == [(d.failovers[0][0], 4)]
    assert fake.calls[:4] == [1, 1, 1, 1] and fake.calls[4:] == [0, 0]
    ev = d.record.events
    assert ("down", 40, 43) in ev and ("elect", 43, 4) in ev
    assert d.tick == 50          # the cycle's 10 ticks: 4 + 4 + 2


def test_failover_accounting_without_an_election():
    # nobody wins in max_down ticks: the old leader comes back and its
    # next batch commits
    rows = [[1, 100, 3]] * 6 + [[1, 102, 3]] + [[1, 110, 3]] * 3
    fake = _Fake(rows)
    d = _driver(fake)
    d.cycle()
    assert d.failovers[0][1] == 7
    assert fake.calls[:7] == [1] * 6 + [0]
    ev = d.record.events
    assert ("down", 40, 45) in ev
    assert not any(e[0] == "elect" for e in ev)
    log = reference.expected_log(_with_first_election(d.record))
    # ticks 40-45 held: no entries; 46-49 append two each
    assert log.appended == 4 * 2


def _with_first_election(rec):
    out = reference.Record(rec.n, rec.log_len)
    out.elect(0, 3)
    out.events += rec.events
    return out


def test_band_bytes_by_hand():
    write = torch.tensor([[True, False, False, True],
                          [False, False, False, False],
                          [False, True, False, False]])
    assert band_bytes(write.numel(), int(write.sum())) == 12 + 3 * 16
    assert band_bytes(16, 0) == 16


def _elections(*terms):
    rec = reference.Record(n=5, log_len=32)
    for i, t in enumerate(terms):
        rec.elect(2 + 10 * i, t)
        rec.props(3 + 10 * i, 2, 4)
    return rec


@pytest.mark.parametrize("terms,order,rounds", [
    ((1, 2, 3), 0, 0),       # one round each
    ((1, 2, 4), 0, 1),       # a second round before the third win
    ((1, 1), 1, 1),          # a term reused
    ((2, 1), 1, 2),          # a term gone back (and the first not 1)
])
def test_election_terms(terms, order, rounds):
    rec = _elections(*terms)
    assert reference.election_terms(rec) == {
        "term_order": (order, 0), "term_rounds": (rounds, 0)}
    log = reference.expected_log(rec)
    out = _consistent_outputs(log, rec, 4)
    checks = reference.judge(out, log, rec, 4)
    assert checks["term_order"][0] == order
    assert checks["term_rounds"][0] == rounds
    relaxed = reference.judge(out, log, rec, 4, one_round_elections=False)
    assert "term_rounds" not in relaxed
    assert relaxed["term_order"][0] == order


def test_judge_takes_the_mix_parameters():
    rec = reference.Record(n=5, log_len=32)
    rec.elect(2, 1)
    rec.props(3, 6, 4)
    log = reference.expected_log(rec)
    M = log.last
    out = _consistent_outputs(log, rec, 4)
    # the leader a batch short of the log's end, two followers three
    # batches behind
    out.commit[0] = out.applied[0] = M - 4
    out.apply_chk[0] = int(log.chk[M - 4])
    for r in (3, 4):
        out.last[r] = out.commit[r] = out.applied[r] = M - 12
        out.snap_idx[r] = M - 16
        out.apply_chk[r] = int(log.chk[M - 12])
        out.snap_chk[r] = int(log.chk[M - 16])
    strict = reference.judge(out, log, rec, 4)
    assert strict["commit_gap"][0] == 4 and strict["stalled_rows"][0] == 2
    lax = reference.judge(out, log, rec, 4, commit_lag_entries=4,
                          behind_batches=3)
    assert all(v == 0 for v, _ in lax.values()), lax
    # a lag allowed is no licence to commit past the log
    out.commit[0] = M + 1
    assert reference.judge(out, log, rec, 4, commit_lag_entries=4)[
        "commit_gap"][0] == 1

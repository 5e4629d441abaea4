"""Host-side ring decoding: device tensors -> typed Python events."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from swarmkit_tpu_torch.flightrec.codes import (
    BLOCK_DEPOSED, BLOCK_LEASE, CODE_NAMES, EDGE_DOWN, EDGE_DROP, EDGE_UP,
    EVENT_WIDTH, EVENT_WIDTH_TAGGED, FAULT_EDGE,
)

_EDGE_NAMES = {EDGE_DOWN: "down", EDGE_UP: "up", EDGE_DROP: "drop"}
_BLOCK_NAMES = {BLOCK_DEPOSED: "deposed", BLOCK_LEASE: "lease_expired"}


@dataclass(frozen=True)
class FlightEvent:
    tick: int
    node: int
    code: int
    arg0: int
    arg1: int
    seq: int        # per-row cumulative event number (cursor position)
    tag: int = 0    # host trace tag (cfg.trace_tags rings; 0 = untagged)

    @property
    def name(self) -> str:
        return CODE_NAMES.get(self.code, f"CODE_{self.code}")

    def describe(self) -> str:
        """One human line; arg semantics per flightrec/codes.py."""
        a0, a1 = self.arg0, self.arg1
        body = {
            "ELECTION_WON": f"term={a0} last={a1}",
            "TERM_BUMP": f"term={a0} (was {a1})",
            "COMMIT_ADVANCE": f"commit={a0} (+{a1})",
            "SNAPSHOT_RESTORE": f"from=n{a0} snap_idx={a1}",
            "FALLBACK_TICK": f"chunks={a0} band_cap={a1}",
            "APPEND_REJECT": f"leader=n{a0} last={a1}",
            "READ_SERVED": f"applied={a0} batch={a1}",
            "READ_BLOCKED": f"reads={a0} "
                            f"reason={_BLOCK_NAMES.get(a1, a1)}",
            "LEASE_EXPIRED": f"expired_at={a0} bounced={a1}",
            "ATTACK_REJOIN": f"term={a0} timeout={a1}",
            "ATTACK_EQUIVOCATE": f"wiped_vote=n{a0} term={a1}",
            "ATTACK_FLOOD": f"extra={a0} tail={a1}",
            "ATTACK_TRANSFER": f"target=n{a0} cooldown={a1}",
        }.get(self.name)
        if self.code == FAULT_EDGE:
            edge = _EDGE_NAMES.get(a0, f"edge_{a0}")
            body = f"{edge}" + (f" degree={a1}" if a0 == EDGE_DROP else "")
        if body is None:
            body = f"arg0={a0} arg1={a1}"
        if self.tag:
            body = f"{body} tag={self.tag:#x}"
        return f"t={self.tick:>5} n{self.node:<4} {self.name:<16} {body}"

    def to_dict(self) -> dict:
        d = {"tick": self.tick, "node": self.node, "code": self.code,
             "name": self.name, "arg0": self.arg0, "arg1": self.arg1,
             "seq": self.seq}
        if self.tag:
            d["tag"] = self.tag
        return d


def _host(x) -> np.ndarray:
    """A device tensor (read back once) or array-like as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decode_rings(ev_buf, ev_pos) -> tuple[list[FlightEvent], np.ndarray]:
    """Drain rings into a (tick, node, seq)-ordered event list.

    ev_buf [N, cap, 4] (or [N, cap, 5] when the ring carries the
    trace-tag lane, cfg.trace_tags), ev_pos [N] cumulative cursors
    (device or numpy).  Returns (events, dropped[N]) where dropped
    counts per-row events overwritten before decoding (cursor -
    capacity, floored at 0).
    """
    buf, pos = _host(ev_buf), _host(ev_pos)
    if buf.ndim != 3 or buf.shape[-1] not in (EVENT_WIDTH,
                                              EVENT_WIDTH_TAGGED):
        raise ValueError(f"ev_buf must be [N, cap, {EVENT_WIDTH}] or "
                         f"[N, cap, {EVENT_WIDTH_TAGGED}], got {buf.shape}")
    tagged = buf.shape[-1] == EVENT_WIDTH_TAGGED
    n, cap, _ = buf.shape
    dropped = np.maximum(pos - cap, 0)
    events: list[FlightEvent] = []
    for node in range(n):
        for k in range(int(dropped[node]), int(pos[node])):
            vals = [int(v) for v in buf[node, k % cap]]
            t, code, a0, a1 = vals[:4]
            tag = vals[4] if tagged else 0
            events.append(FlightEvent(tick=t, node=node, code=code,
                                      arg0=a0, arg1=a1, seq=k, tag=tag))
    events.sort(key=lambda e: (e.tick, e.node, e.seq))
    return events, dropped


def decode_state(state) -> tuple[list[FlightEvent], np.ndarray]:
    """decode_rings over a SimState recorded with cfg.record_events."""
    if state.ev_buf is None or state.ev_pos is None:
        raise ValueError("state carries no event ring "
                         "(SimConfig.record_events was off)")
    return decode_rings(state.ev_buf, state.ev_pos)

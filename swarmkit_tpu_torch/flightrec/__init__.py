"""On-device flight recorder for the batched raft simulation (PyTorch port).

`SimConfig.record_events` threads a fixed-width event ring through the tick
(`codes.py` holds the coded event vocabulary and the ring appends the
kernel calls); the host side decodes rings into typed events
(`decoder.py`), wraps them with provenance into savable records
(`record.py`, the JAX package's JSON format), fits the tick to the wall
clock (`clock.py`) and exports merged device and tracer-span timelines as
Chrome-trace / Perfetto JSON (`export.py`).
"""

from swarmkit_tpu_torch.flightrec.clock import ClockFit, ClockSync, fit_from
from swarmkit_tpu_torch.flightrec.codes import (
    APPEND_REJECT, CODE_NAMES, COMMIT_ADVANCE, EDGE_DOWN, EDGE_DROP,
    EDGE_UP, ELECTION_WON, EVENT_WIDTH, EVENT_WIDTH_TAGGED, FALLBACK_TICK,
    FAULT_EDGE, READ_SERVED, SNAPSHOT_RESTORE, TAGGED_CODES, TERM_BUMP,
    ring_append,
)
from swarmkit_tpu_torch.flightrec.decoder import (
    FlightEvent, decode_rings, decode_state,
)
from swarmkit_tpu_torch.flightrec.export import (
    export_record, to_chrome_trace, validate_chrome_trace,
)
from swarmkit_tpu_torch.flightrec.record import (
    FlightRecord, capture, diff_records, load_record, save_record,
    summarize,
)

__all__ = [
    "APPEND_REJECT", "CODE_NAMES", "COMMIT_ADVANCE", "ClockFit",
    "ClockSync", "EDGE_DOWN", "EDGE_DROP", "EDGE_UP", "ELECTION_WON",
    "EVENT_WIDTH", "EVENT_WIDTH_TAGGED", "FALLBACK_TICK", "FAULT_EDGE",
    "READ_SERVED", "SNAPSHOT_RESTORE", "TAGGED_CODES", "TERM_BUMP",
    "FlightEvent",
    "FlightRecord", "capture", "decode_rings", "decode_state",
    "diff_records", "export_record", "fit_from", "load_record",
    "ring_append", "save_record", "summarize", "to_chrome_trace",
    "validate_chrome_trace",
]

"""The port's host observability modules against the JAX package's.

One short lockstep run (tests/test_torch_wire.py's lockstep: the mailbox
wire with reads, all three device planes on, tagged host calls) gives the
JAX package and the port the same carried state.  On it, and on the same
inputs otherwise, the port's decoder, telemetry summary and series
decoder, flight records (which load in either package), Chrome-trace
export, clock fit, metrics catalog, KernelObs / TelemetryObs registry
values, exposition and span tags must equal the JAX package's.  All the
compared values are integers, strings or floats computed by the same
arithmetic from the same inputs, so the comparisons are exact.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from swarmkit_tpu import flightrec as jfr
from swarmkit_tpu import telemetry as jtel
from swarmkit_tpu.metrics import catalog as jcatalog
from swarmkit_tpu.metrics import exposition as jexpo
from swarmkit_tpu.metrics import registry as jregistry
from swarmkit_tpu.metrics import trace as jtrace
from swarmkit_tpu.raft.sim import run as jrun
from swarmkit_tpu_torch import flightrec as tfr
from swarmkit_tpu_torch import telemetry as ttel
from swarmkit_tpu_torch.metrics import catalog as tcatalog
from swarmkit_tpu_torch.metrics import exposition as texpo
from swarmkit_tpu_torch.metrics import registry as tregistry
from swarmkit_tpu_torch.metrics import trace as ttrace
from swarmkit_tpu_torch.raft.sim import run as trun
from swarmkit_tpu_torch.telemetry import series as tseries

from tests.test_torch_wire import lockstep, one_torch_thread  # noqa: F401

CFG = dict(n=5, log_len=64, window=8, apply_batch=16, max_props=8, keep=4,
           election_tick=16, seed=503, latency=1, latency_jitter=2,
           pre_vote=True, read_batch=3, collect_stats=True,
           record_events=True, event_ring=16, collect_telemetry=True,
           trace_tags=True, telemetry_prop_ring=64, telemetry_window=8,
           telemetry_stride=2)

SPANS = [{"name": "raft.propose", "span_id": "00000000002a", "parent_id": None,
          "start": 1000.25, "duration": 0.004,
          "attrs": {"trace_tag": 0x2a, "node": "m1"}},
         {"name": "raft.read", "span_id": "00000000002b",
          "parent_id": "00000000002a", "start": 1000.5, "duration": 0.002,
          "attrs": {"trace_tag": 0x2b}},
         {"name": "store.update", "span_id": "00000000002c",
          "parent_id": None, "start": 1000.75, "duration": 0.001,
          "attrs": {"trace_tag": 0x7777}},
         {"name": "open.span", "span_id": "00000000002d", "parent_id": None,
          "start": 1001.0, "duration": None, "attrs": {}}]
SAMPLES = [(3, 1_000_250_000_000), (20, 1_000_400_000_000),
           (41, 1_000_610_000_000), (60, 1_000_790_000_000),
           (55, 1_000_700_000_000)]


@pytest.fixture(scope="module")
def carried():
    """The same state in both packages after 70 lockstep ticks (tags 0x2a /
    0x2b on the host proposes and reads, so COMMIT_ADVANCE and READ_SERVED
    events carry them)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    reads = {t: (2, None) for t in range(10, 70, 6)}
    r = lockstep(CFG, 70, 560, drop_rate=0.1, crash_prob=0.04,
                 reads_at=reads, tag_fn=lambda t: 0x2a if t % 2 else 0x2b)
    torch.set_num_threads(threads)
    from swarmkit_tpu.raft.sim.state import SimConfig as JCfg
    from swarmkit_tpu_torch.raft.sim.state import SimConfig as TCfg
    return r["js"], r["ts"], JCfg(**CFG), TCfg(**CFG)


def _clock(mod):
    cs = mod.ClockSync(fallback_tick_us=250.0)
    for t, ns in SAMPLES:
        cs.add(t, ns)
    return cs


def test_decode_state_equal(carried):
    js, ts, _, _ = carried
    jev, jdrop = jfr.decode_state(js)
    tev, tdrop = tfr.decode_state(ts)
    assert [e.to_dict() for e in tev] == [e.to_dict() for e in jev]
    assert [e.describe() for e in tev] == [e.describe() for e in jev]
    assert np.array_equal(tdrop, np.asarray(jdrop))
    assert any(e.tag for e in tev) and tdrop.sum() > 0


def test_summarize_state_and_decode_series_equal(carried):
    js, ts, jcfg, tcfg = carried
    want = jtel.summarize_state(js, jcfg)
    got = ttel.summarize_state(ts, tcfg)
    assert got == want and got["commit"]["total"] > 0
    assert ttel.decode_series(ts, tcfg) == jtel.decode_series(js, jcfg)
    for short, field in (("commit", "tel_commit_hist"),
                         ("election", "tel_elect_hist")):
        for q in (50, 99):
            dev = int(tseries.percentile_edge_device(getattr(ts, field), q))
            assert got[short][f"p{q}"] == min(
                dev, tseries.LATENCY_BUCKET_EDGES[-1])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_load_in_both_packages(carried, tmp_path, writer):
    """A record captured and saved by one package (events, spans, telemetry
    counters, clock samples) loads in the other's load_record to the same
    dict, and both captures are equal."""
    js, ts, jcfg, tcfg = carried
    meta = {"seed": 560, "what": "lockstep"}
    trec = tfr.capture(ts, trigger="manual", meta=meta, cfg=tcfg,
                       clock=_clock(tfr), obs=tregistry.MetricsRegistry())
    jrec = jfr.capture(js, trigger="manual", meta=meta, cfg=jcfg,
                       clock=_clock(jfr), obs=jregistry.MetricsRegistry())
    trec.spans = jrec.spans = [dict(s) for s in SPANS]
    assert trec.to_dict() == jrec.to_dict()
    path = str(tmp_path / "rec.json")
    if writer == "port":
        tfr.save_record(trec, path)
        back = jfr.load_record(path)
    else:
        jfr.save_record(jrec, path)
        back = tfr.load_record(path)
    assert back.to_dict() == trec.to_dict()
    assert tfr.summarize(trec) == jfr.summarize(jrec)
    assert tfr.diff_records(trec, back) == jfr.diff_records(jrec, back)


def test_chrome_trace_equal_with_flows(carried):
    """The same events, spans, counters and clock give the same trace in
    both packages: device instants on the fitted wall clock, flow arrows
    for the tags seen on both sides, orphans for the rest; both valid."""
    js, ts, jcfg, tcfg = carried
    jev, _ = jfr.decode_state(js)
    tev, _ = tfr.decode_state(ts)
    counters = [{"name": k, "tick": t, "value": v}
                for k, pts in sorted(ttel.decode_series(ts, tcfg).items())
                for t, v in pts]
    for clock in (None, _clock(tfr).to_dict()):
        got = tfr.to_chrome_trace(tev, SPANS, tick_us=2.0, counters=counters,
                                  clock=clock)
        want = jfr.to_chrome_trace(jev, SPANS, tick_us=2.0,
                                   counters=counters, clock=clock)
        assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                             sort_keys=True)
        assert tfr.validate_chrome_trace(got) == [] == \
            jfr.validate_chrome_trace(want)
        assert {e["ph"] for e in got["traceEvents"]} >= {"s", "f", "C"}


def test_clock_fits_equal():
    """Theil-Sen fits on the same samples: several points with one out of
    order, one point, all at one tick, none."""
    cases = [SAMPLES, SAMPLES[:1], [(7, 10), (7, 99)], []]
    for samples in cases:
        fits = []
        for mod in (tfr, jfr):
            cs = mod.ClockSync(fallback_tick_us=3.0)
            for t, ns in samples:
                cs.add(t, ns)
            f = cs.fit()
            fits.append(None if f is None else f.to_dict())
            assert mod.fit_from(cs.to_dict()) == (f if f is None else
                                                  mod.fit_from(f))
        assert fits[0] == fits[1], samples


def test_catalog_specs_equal_jax():
    """Every spec of the port's catalog is the JAX package's, by name,
    kind, help, labels and buckets; the telemetry ladder is series.py's."""
    want = {"swarm_kernel_", "swarm_telemetry_", "swarm_flightrec_",
            "swarm_trace_", "swarm_bench_"}
    for name, spec in tcatalog.CATALOG.items():
        j = jcatalog.CATALOG[name]
        assert dataclasses.astuple(spec) == dataclasses.astuple(j), name
    for name in jcatalog.CATALOG:
        if any(name.startswith(p) for p in want):
            assert name in tcatalog.CATALOG, name
    assert tcatalog._TEL_TICK_BUCKETS == tuple(
        float(e) for e in tseries.LATENCY_BUCKET_EDGES)


def test_kernel_and_telemetry_obs_scrape_like_jax(carried):
    """KernelObs and TelemetryObs publish the carried state into a fresh
    registry of each package: the same values, and a second publish of the
    same state adds nothing (the per-registry delta table)."""
    js, ts, jcfg, tcfg = carried
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    tko, jko = trun.KernelObs(treg), jrun.KernelObs(jreg)
    tto, jto = ttel.TelemetryObs(treg), jtel.TelemetryObs(jreg)
    for _ in range(2):
        assert tko.publish(ts) == jko.publish(js)
        assert tto.publish(ts, tcfg) == jto.publish(js, jcfg)
        assert treg.snapshot() == jreg.snapshot()
    assert tko.publish(ts)["commit_advance"] > 0
    assert treg.render() == jreg.render()


def test_kernel_obs_reads_wrapped_counters_unsigned(carried):
    """The device counters wrap mod 2**32 (the summed commit advance of a
    long n=4096 run does): publish reads them unsigned, so a counter never
    goes down; a reading below the last one at a later tick is a wrap and
    adds the exact advance, at the same tick it is a new run, and at an
    earlier tick too."""
    import dataclasses as dc

    import torch

    _, ts, _, _ = carried
    reg = tregistry.MetricsRegistry()
    obs = trun.KernelObs(reg)
    fam = tcatalog.get(reg, "swarm_kernel_commit_advance_total")
    apply_fam = tcatalog.get(reg, "swarm_kernel_apply_advance_total")
    started = tcatalog.get(reg, "swarm_kernel_elections_started_total")

    def publish(stats, dt):
        return obs.publish(dc.replace(
            ts, stats=torch.tensor(stats, dtype=torch.int32),
            tick=ts.tick + dt))

    got = publish([5, 1, -2, 2 ** 31 - 1], 0)
    assert got["commit_advance"] == 2 ** 32 - 2
    assert got["apply_advance"] == 2 ** 31 - 1
    assert fam.labels().value == 2 ** 32 - 2
    # ten ticks on the commit advance wrapped: -2 -> 3 is 5 entries
    got = publish([6, 1, 3, -2 ** 31], 10)
    assert got["commit_advance"] == 3 and got["apply_advance"] == 2 ** 31
    assert fam.labels().value == 2 ** 32 + 3
    assert apply_fam.labels().value == 2 ** 31
    assert started.labels().value == 6
    # the same tick again adds nothing
    publish([6, 1, 3, -2 ** 31], 10)
    assert fam.labels().value == 2 ** 32 + 3
    # an earlier tick is a new run, counted from zero
    publish([2, 0, 7, 7], 4)
    assert started.labels().value == 8
    assert fam.labels().value == 2 ** 32 + 10
    # at the same tick, a lower reading is a new run too
    publish([1, 0, 4, 4], 4)
    assert fam.labels().value == 2 ** 32 + 14
    assert apply_fam.labels().value == 2 ** 31 + 11


def test_exposition_and_span_tags_equal(carried):
    """render_all / snapshot_all with a tracer holding the same spans (the
    recent-events section reads each package's own captures), and
    span_trace_tag on spans and bare span-id strings."""
    js, ts, _, _ = carried
    tracers = {}
    for name, mod, fr, reg in (("port", ttrace, tfr, tregistry),
                               ("jax", jtrace, jfr, jregistry)):
        tr = mod.Tracer()
        for s in SPANS[:3]:
            tr.finish(mod.Span(name=s["name"], span_id=s["span_id"],
                               parent_id=s["parent_id"], start=s["start"],
                               end=s["start"] + s["duration"],
                               attrs=dict(s["attrs"])))
        fr.capture(ts if name == "port" else js, trigger="dst_violation",
                   obs=reg.MetricsRegistry())
        tracers[name] = tr
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    tcatalog.get(treg, "swarm_kernel_fsync_lag").set(3)
    jcatalog.get(jreg, "swarm_kernel_fsync_lag").set(3)
    got = texpo.render_all(treg, tracer=tracers["port"])
    assert got == jexpo.render_all(jreg, tracer=tracers["jax"])
    assert "# recent-event flightrec[dst_violation]" in got
    assert texpo.snapshot_all(treg, tracer=tracers["port"]) == \
        jexpo.snapshot_all(jreg, tracer=tracers["jax"])
    for sid in ("000000000001", "7fffffff0000", "ffffffffffff", "80000000"):
        assert ttrace.span_trace_tag(sid) == jtrace.span_trace_tag(sid)
    span = ttrace.Tracer().start("raft.propose")
    assert ttrace.span_trace_tag(span) == jtrace.span_trace_tag(span.span_id)

"""Port parity: ``repro_torch.telemetry.trace`` (spans, the Perfetto export,
attribution, SLO burn rate) against the JAX package's ``repro.telemetry.trace``.

Identity surface: the same event streams — built once as dict rows and read
through each package's ``from_dict`` — go through both packages' functions,
and everything that comes out is equal: ``det_id`` digests, span streams a
``SpanTracer`` emits on a ``CountingClock`` (field for field), the Perfetto
JSON (byte for byte, in memory and written to disk), ``validate_perfetto``'s
problem lists on good and corrupted payloads, ``format_tree`` and
``flame_summary`` text, ``attribute``'s rows (with a fitted planner and with
tune events) and ``format_attribution``'s text, and the SLO monitors' alerts
(field for field) on a healthy and a 2x-slowdown stream.  All pure Python:
no engine runs here.
"""
import _torch_threads  # noqa: F401  (sets this worker's torch threads)
import copy
import json

import numpy as np
import pytest

import repro.telemetry as ref_tel
import repro.telemetry.trace as ref_trace
import repro_torch.telemetry as port_tel
import repro_torch.telemetry.trace as port_trace
from repro.serve.planner import CapacityPlanner as RefPlanner
from repro_torch.serve.planner import CapacityPlanner as PortPlanner

PACKAGES = {"ref": (ref_tel, ref_trace, RefPlanner), "port": (port_tel, port_trace, PortPlanner)}


def _span_program(trace_mod, *, seed: int, replica: int):
    """A serve-like span tree on a tick clock: engine steps with prefill,
    decode and verify children, explicit-duration join spans, annotated and
    priced spans.  Returns the tracer's events."""
    tr = trace_mod.SpanTracer(trace=("serve", "qwen3-14b", seed, -1),
                              clock=trace_mod.CountingClock(tick=1e-3))
    tr.set_trace("serve", "qwen3-14b", seed, replica, replica=replica)
    for step in range(6):
        with tr.span("step", step=step, component="engine.step"):
            if step % 2 == 0:
                tr.emit_span("join", dur=0.0, step=step, component="scheduler.join",
                             rid=step, wait_steps=step % 3)
                with tr.span("prefill", step=step, component="engine.prefill", rid=step,
                             tokens=17 + step) as h:
                    h.set(skipped=step == 4)
            with tr.span("decode", step=step, component="engine.decode", batch=1 + step % 4,
                         predicted_s=0.002 if step < 3 else None):
                pass
            if step == 5:
                with tr.span("verify", step=step, component="engine.verify", batch=2,
                             rows=16) as h:
                    h.predict(0.01)
    return tr.tracker.events()


def _stream_rows(seed: int = 0):
    """Dict rows of a routed serve run: two replicas' spans, a router's
    dispatch spans and events, replica-tagged serve_step rows, tune rows
    for the paged decode at b 1, 2, 4 and a ckpt_cost row."""
    rows = []
    for replica in (0, 1):
        rows += [e.to_dict() for e in _span_program(port_trace, seed=seed, replica=replica)]
    router = port_trace.SpanTracer(trace=("router", seed, 2),
                                   clock=port_trace.CountingClock())
    for rid in range(4):
        with router.span("dispatch", step=rid, component="router.dispatch", rid=rid) as h:
            h.set(replica=rid % 2)
        rows.append(port_tel.RouterEvent(
            step=rid, rid=rid, replica=rid % 2, matched_pages=rid // 2, best_affinity=rid // 2,
            reason="affinity" if rid >= 2 else "load", prompt_pages=2, loads=[rid, 3]).to_dict())
    rows += [e.to_dict() for e in router.tracker.events()]
    rng = np.random.RandomState(seed)
    for step in range(12):
        for replica in (0, 1):
            batch = 1 + (step + replica) % 4
            rows.append(port_tel.ServeStepEvent(
                step=step, step_s=float(0.01 + 0.002 * batch + 1e-4 * rng.rand()), op="decode",
                batch=batch, committed=batch, replica=replica).to_dict())
    for b, us in ((1, 40.0), (2, 45.5), (4, 52.25)):
        rows.append(port_tel.TuneEvent(
            family="flash_decode_paged", shape={"b": b, "hk": 8, "g": 5, "d": 128, "page": 16,
                                                "npp": 6},
            dtype="bfloat16", backend="cuda", config={"pages_per_program": 4},
            us_per_call=us).to_dict())
    rows.append(port_tel.CkptCostEvent(step=3, op="migrate", wall_s=0.01, workload="qwen3-14b",
                                       nbytes=65536, n_shards=80, replica=0).to_dict())
    return json.loads(json.dumps(rows))


def _read(rows, pkg):
    tel = PACKAGES[pkg][0]
    return [tel.from_dict(copy.deepcopy(r)) for r in rows]


def _both(rows):
    return _read(rows, "ref"), _read(rows, "port")


def test_det_id_matches_reference():
    parts = [("trace", "serve", "qwen3-14b", 0, -1), ("trace", "router", 0, 2),
             ("x",), (3, 1.5, "a/b", None), ("serve", "deepseek-v2-236b", 7, 1)]
    for p in parts:
        assert port_trace.det_id(*p) == ref_trace.det_id(*p)
    assert port_trace.det_id("trace", 0) != port_trace.det_id("trace", 1)


@pytest.mark.parametrize("replica", [-1, 0, 1])
def test_span_tracer_emits_the_reference_stream(replica):
    ref = _span_program(ref_trace, seed=3, replica=replica)
    port = _span_program(port_trace, seed=3, replica=replica)
    assert len(port) == len(ref) > 0
    assert [e.to_dict() for e in port] == [e.to_dict() for e in ref]
    # re-keying after the first span is refused by both
    for mod in (ref_trace, port_trace):
        tr = mod.SpanTracer(clock=mod.CountingClock())
        with tr.span("a"):
            pass
        with pytest.raises(RuntimeError, match="re-key"):
            tr.set_trace("b")


def test_perfetto_bytes_match_reference(tmp_path):
    ref, port = _both(_stream_rows())
    want = json.dumps(ref_trace.to_perfetto(ref), sort_keys=True)
    assert json.dumps(port_trace.to_perfetto(port), sort_keys=True) == want
    assert (json.dumps(port_trace.to_perfetto(port, process_name="fleet"), sort_keys=True)
            == json.dumps(ref_trace.to_perfetto(ref, process_name="fleet"), sort_keys=True))
    n_ref = ref_trace.write_perfetto(tmp_path / "ref.json", ref)
    n_port = port_trace.write_perfetto(tmp_path / "port.json", port)
    assert n_port == n_ref == sum(1 for e in port if e.kind == "span")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert port_trace.load_perfetto(tmp_path / "port.json") == json.loads(want)


def _corruptions(payload):
    """Payloads each of the validator's checks should flag."""
    spans = [i for i, r in enumerate(payload["traceEvents"]) if r["ph"] == "X"]
    out = [None, [], {"traceEvents": 3}, {"traceEvents": []}]
    for edit in ("ph", "name", "ts", "dur_neg", "dur_bool", "span_id", "dup", "parent", "row"):
        bad = copy.deepcopy(payload)
        rows = bad["traceEvents"]
        r = rows[spans[1]]
        if edit == "ph":
            r["ph"] = "B"
        elif edit == "name":
            del r["name"]
        elif edit == "ts":
            r["ts"] = "0"
        elif edit == "dur_neg":
            r["dur"] = -1.0
        elif edit == "dur_bool":
            r["dur"] = True
        elif edit == "span_id":
            del r["args"]["span_id"]
        elif edit == "dup":
            r["args"]["span_id"] = rows[spans[0]]["args"]["span_id"]
        elif edit == "parent":
            r["args"]["parent_id"] = "0123456789abcdef"
        else:
            rows.append("not a row")
        out.append(bad)
    return out


def test_validate_perfetto_matches_reference_on_good_and_corrupted_payloads():
    ref, port = _both(_stream_rows())
    good = port_trace.to_perfetto(port)
    assert port_trace.validate_perfetto(good) == ref_trace.validate_perfetto(good) == []
    for bad in _corruptions(good):
        want = ref_trace.validate_perfetto(copy.deepcopy(bad))
        assert want, bad
        assert port_trace.validate_perfetto(copy.deepcopy(bad)) == want


def test_tree_and_flame_text_match_reference():
    ref, port = _both(_stream_rows())
    for kw in ({}, {"max_roots": 3, "max_children": 2}):
        assert port_trace.format_tree(port, **kw) == ref_trace.format_tree(ref, **kw)
    for width in (40, 10):
        assert (port_trace.flame_summary(port, width=width)
                == ref_trace.flame_summary(ref, width=width))
    assert port_trace.format_tree([]) == ref_trace.format_tree([]) == "(no spans)"
    assert [s.span_id for s in port_trace.span_roots(port)] == \
        [s.span_id for s in ref_trace.span_roots(ref)]
    for comp in (None, "engine.decode", "router.dispatch"):
        assert port_trace.total_span_time(port, comp) == ref_trace.total_span_time(ref, comp)


def _rows_of(attr):
    return [(r.component, r.n, r.measured_s, r.predicted_s, r.share, r.ratio) for r in attr.rows]


@pytest.mark.parametrize("with_planner", [False, True])
def test_attribution_matches_reference(with_planner):
    ref, port = _both(_stream_rows())
    planners = {}
    for pkg, evs in (("ref", ref), ("port", port)):
        if with_planner:
            p = PACKAGES[pkg][2]()
            p.ingest([e for e in evs if e.kind == "serve_step"])
            p.fit()
            planners[pkg] = p
        else:
            planners[pkg] = None
    want = ref_trace.attribute(ref, planner=planners["ref"], n_layers=40)
    got = port_trace.attribute(port, planner=planners["port"], n_layers=40)
    assert _rows_of(got) == _rows_of(want)
    assert any(r.component.startswith("kernel/flash_decode_paged@b") for r in got.rows)
    assert (got.total_measured_s, got.n_spans) == (want.total_measured_s, want.n_spans)
    assert port_trace.format_attribution(got) == ref_trace.format_attribution(want)
    worst, worst_ref = got.worst_ratio(), want.worst_ratio()
    assert (worst and worst.component) == (worst_ref and worst_ref.component)
    for busy in (got.total_measured_s, got.total_measured_s * 1.04, got.total_measured_s * 2, 0.0):
        assert got.reconcile(busy) == want.reconcile(busy)


def _latency_stream(seed: int, slowdown: bool):
    """serve_step decode rows and scheduler.join spans over 64 steps; with
    ``slowdown`` every step time doubles from the midpoint and joins wait."""
    rng = np.random.RandomState(seed)
    tr = port_trace.SpanTracer(trace=("slo", seed), clock=port_trace.CountingClock())
    rows = []
    for step in range(64):
        late = slowdown and step >= 32
        batch = 1 + step % 4
        step_s = 0.01 * batch * (1.0 + 0.05 * rng.rand()) * (2.0 if late else 1.0)
        rows.append(port_tel.ServeStepEvent(step=step, step_s=step_s, op="decode",
                                            batch=batch, committed=batch).to_dict())
        if step % 2 == 0:
            tr.emit_span("join", dur=0.0, step=step, component="scheduler.join", rid=step,
                         wait_steps=(4 if late else 0) + step % 2)
    rows += [e.to_dict() for e in tr.tracker.events()]
    rows.sort(key=lambda r: r["step"])
    return json.loads(json.dumps(rows))


@pytest.mark.parametrize("slowdown", [False, True])
def test_slo_monitors_match_reference(slowdown):
    rows = _latency_stream(0, slowdown)
    ref, port = _both(rows)
    per_token = [e.step_s / e.committed for e in port if e.kind == "serve_step"]
    target = 1.5 * float(np.median(per_token[:32]))
    kw = dict(window=8, min_points=2, cooldown=8)
    alerts = {}
    for pkg, evs in (("ref", ref), ("port", port)):
        mod = PACKAGES[pkg][1]
        alerts[pkg] = mod.monitor_serve_events(
            evs, per_token=mod.SloConfig(target=target, **kw),
            join_first_token=mod.SloConfig(target=2.0, **kw), name="serve")
    assert [a.to_dict() for a in alerts["port"]] == [a.to_dict() for a in alerts["ref"]]
    assert bool(alerts["port"]) == slowdown
    if slowdown:
        assert {a.objective for a in alerts["port"]} == {"per_token_latency",
                                                          "join_to_first_token"}
        assert min(a.step for a in alerts["port"]) >= 32
        planners = {pkg: PACKAGES[pkg][2]() for pkg in PACKAGES}
        for pkg in PACKAGES:
            planners[pkg].ingest(alerts[pkg])
        assert [a.to_dict() for a in planners["port"].slo_alerts] == \
            [a.to_dict() for a in planners["ref"].slo_alerts]
        assert planners["port"].last_slo_alert_step == planners["ref"].last_slo_alert_step


def test_slo_monitor_step_by_step_matches_reference():
    cfg = dict(target=1.0, budget=0.05, window=8, burn_threshold=2.0, min_points=2, cooldown=10)
    mons = {pkg: PACKAGES[pkg][1].SLOMonitor(PACKAGES[pkg][1].SloConfig(**cfg), name="svc",
                                             objective="latency") for pkg in PACKAGES}
    rng = np.random.RandomState(5)
    for step in range(60):
        value = float(0.5 + (2.0 if 20 <= step < 40 else 0.6) * rng.rand())
        got = mons["port"].observe(step, value)
        want = mons["ref"].observe(step, value)
        assert (got and got.to_dict()) == (want and want.to_dict())
        assert mons["port"].burn_rate == mons["ref"].burn_rate
        assert mons["port"].budget_remaining() == mons["ref"].budget_remaining()
    assert mons["port"].alerts
    for mod in (ref_trace, port_trace):
        with pytest.raises(ValueError, match="target"):
            mod.SloConfig(target=0.0)
        with pytest.raises(ValueError, match="budget"):
            mod.SloConfig(target=1.0, budget=1.0)


def test_trace_all_matches_reference():
    assert port_trace.__all__ == ref_trace.__all__

"""The port's observability (``paddle_tpu_torch/observability``) and
watchdog against the JAX reference's, on the CPU.

- Metrics: the port's and the reference's registries fed the same
  operations (labels and HELP text needing escapes, gauges up and down,
  histograms with exemplars in finite and +Inf buckets, bound children)
  give byte-identical ``to_prometheus`` text and equal ``snapshot`` and
  ``typed_snapshot``; the redeclare checks raise on both.
- ``parse_prometheus_text`` accepts and rejects what the reference's
  does, with equal results.
- ``EventLog``: ring bound and ``dropped``, filters, ``tail``, JSONL
  export and a file-backed log, sink faults: records equal to the
  reference's but for their clocks.
- Tracing: for the same ``pump``-driven replica set with an eviction
  and a scale-down mid-run, each request's trace (its fields, and each
  span's name and non-time fields) equals the reference's.
- Flight recorder: ring bound, kinds, lanes and a dump, against the
  reference's; the global recorder taps event sinks and trace spans.
- ``TelemetryServer`` over urllib on 127.0.0.1: /metrics through the
  strict parser, /healthz plain and verbose, /events, /flightrecorder,
  /snapshot, a 404 listing; /serving and /traces(/<id>) while a
  ``ReplicaSet`` runs and 404 after ``stop``; ``aggregator=`` raises.
- ``HangDetector`` with and without compile grace, ``escalate``, the
  stall dump; ``NanGuard`` policies and breaker against the reference's.
- ``FLAGS_enable_rpc_profiler`` makes the PS communicator write the
  reference's "ps_rpc" event instead of raising.
- Importing the port's observability, robustness and serving loads
  neither ``jax`` nor ``paddle_tpu``.

Flags, the event log and the global flight recorder are put back in a
``finally``. The file collects one test that runs every case
(``tests/torch_checks.py`` says why).
"""
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.observability as jobs
from paddle_tpu.distributed.ps import communicator as jcomm
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_presets as jax_presets
from paddle_tpu.observability import exposition as jexpo
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability.tracing import get_tracer as jax_tracer
from paddle_tpu.robustness import watchdog as jwatchdog
from paddle_tpu.serving import GPTDecodeModel as JaxDecodeModel
from paddle_tpu.serving import ReplicaSet as JaxReplicaSet
from paddle_tpu.serving import ServeRequest as JaxRequest
import paddle_tpu_torch.observability as tobs
from paddle_tpu_torch.distributed.ps import communicator as tcomm
from paddle_tpu_torch.framework.flags import flag, set_flags
from paddle_tpu_torch.models import GPTForCausalLM, gpt_presets
from paddle_tpu_torch.observability import exposition as texpo
from paddle_tpu_torch.observability import flight_recorder as tfr
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability.tracing import get_tracer
from paddle_tpu_torch.robustness import watchdog as twatchdog
from paddle_tpu_torch.serving import (GPTDecodeModel, ReplicaSet,
                                      ServeRequest)
from torch_checks import run_checks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCKS = ("time", "mono", "t_start", "t_end", "duration_ms", "ms")


def _no_clocks(rec):
    return {k: v for k, v in rec.items() if k not in CLOCKS}


# ---------------------------------------------------------------- metrics

def _feed(mod):
    """The same operations on a fresh registry of either framework."""
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", 'requests "served"\nby\\outcome',
                    labels=("outcome", "path"))
    c.labels(outcome="completed", path='a"b\\c\nd').inc()
    c.labels(outcome="rejected", path="/x").inc(3)
    solo = reg.counter("ops_total", "ops").bind()
    solo.inc(7)
    g = reg.gauge("depth", "queue depth")
    g.set(5)
    g.inc(2)
    g.dec(4)
    lg = reg.gauge("occ", labels=("replica",))
    lg.labels(replica="replica-0").set(0.25)
    lg.labels(replica="replica-1").set(1.0)
    h = reg.histogram("lat_ms", "latency", buckets=(1, 10, 100))
    for v, ex in ((0.5, "t1"), (5.0, None), (50.0, 't"2'), (500.0, "t3"),
                  (7.5, "t4")):
        h.observe(v, exemplar=ex)
    hl = reg.histogram("step_ms", labels=("kind",), buckets=(0.5, 2.5))
    hl.labels(kind="spec").observe(1.0)
    hl.labels(kind="decode").observe(3.0, exemplar="t9")
    assert reg.counter("ops_total", "other help") is reg.get("ops_total")
    for bad in (lambda: reg.gauge("ops_total"),
                lambda: reg.counter("req_total", labels=("outcome",))):
        with pytest.raises(ValueError):
            bad()
    return reg


def check_registries_expose_identical_text():
    t, j = _feed(tmetrics), _feed(jmetrics)
    assert t.to_prometheus() == j.to_prometheus()
    assert t.typed_snapshot() == j.typed_snapshot()
    assert t.snapshot() == j.snapshot()
    assert t.names() == j.names()
    assert t.get("depth").value == j.get("depth").value == 3
    with tempfile.TemporaryDirectory() as d:
        for reg, name in ((t, "t.jsonl"), (j, "j.jsonl")):
            reg.export_jsonl(os.path.join(d, name))
            reg.export_jsonl(os.path.join(d, name))
        lines = [[json.loads(x) for x in open(os.path.join(d, n))]
                 for n in ("t.jsonl", "j.jsonl")]
    assert [r["metrics"] for r in lines[0]] == [r["metrics"]
                                                for r in lines[1]]
    assert len(lines[0]) == 2
    t.reset()
    j.reset()
    assert t.to_prometheus() == j.to_prometheus()


_TEXTS = [
    '# HELP a_total x\n# TYPE a_total counter\na_total{k="v\\"q"} 3\n',
    '# TYPE h histogram\nh_bucket{le="1.0"} 1 # {trace_id="t1"} 0.5\n'
    'h_bucket{le="+Inf"} 2\nh_sum 3.5\nh_count 2\n',
    'plain 1.5 1700000000\n',
    '# TYPE g gauge\ng{a="1",b="x\\ny"} -Inf\n',
    'bad{k=v} 1\n',
    'bad{k="v\\q"} 1\n',
    '# TYPE x counter\n# TYPE x gauge\n',
    'x{k="v"} notanumber\n',
    'h_bucket{le="1.0"} 1 # {trace_id="t1"} nan-ish\n',
    '# TYPE z summary\nz{quantile="0.5"} 1\n',
    '# TYPE w bogus\n',
    '# HELP 9bad help\n',
]


def check_parser_accepts_and_rejects_as_reference():
    texts = _TEXTS + [_feed(tmetrics).to_prometheus()]
    for text in texts:
        outs = []
        for parse in (texpo.parse_prometheus_text,
                      jexpo.parse_prometheus_text):
            try:
                outs.append(("ok", parse(text)))
            except ValueError:
                outs.append(("raise", None))
        assert outs[0][0] == outs[1][0], (text, outs)
        if outs[0][0] == "ok":
            a, b = outs[0][1], outs[1][1]
            assert json.dumps(a, sort_keys=True, default=str) == \
                json.dumps(b, sort_keys=True, default=str), text
    assert [texpo.parse_prometheus_text(t) is not None
            for t in _TEXTS[:4]] == [True] * 4


# ----------------------------------------------------------------- events

def _events(mod, d):
    log = mod.EventLog(path=os.path.join(d, "log.jsonl"), max_memory=3)
    log.info("checkpoint", "saved", step=1)
    log.warning("nan_guard", "", step=2, action="skip_step")
    log.error("serving", "replica evicted", replica="replica-0")
    log.debug("ps_rpc", op="pull_sparse", n_keys=3)
    with pytest.raises(ValueError):
        log.log("x", severity="fatal")

    def broken(rec):
        raise RuntimeError("sink down")

    mod.add_event_sink(broken)
    try:
        log.info("serving", "after")
    finally:
        mod.remove_event_sink(broken)
    out = {
        "all": [_no_clocks(e) for e in log.events()],
        "kind": [_no_clocks(e) for e in log.events(kind="serving")],
        "sev": [_no_clocks(e) for e in log.events(severity="error")],
        "min": [_no_clocks(e) for e in log.events(min_severity="warning")],
        "tail": [_no_clocks(e) for e in log.tail(2)],
        "dropped": log.dropped, "len": len(log),
        "faults": log.sink_faults}
    log.export(os.path.join(d, "export.jsonl"))
    log.close()
    out["file"] = [_no_clocks(json.loads(x))
                   for x in open(os.path.join(d, "log.jsonl"))]
    out["export"] = [_no_clocks(json.loads(x))
                     for x in open(os.path.join(d, "export.jsonl"))]
    return out


def check_event_log_matches_reference():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t, j = _events(tobs, d1), _events(jobs, d2)
    assert t == j
    assert t["len"] == 3 and t["dropped"] == 2 and t["faults"] == 1
    assert len(t["file"]) == 5 and len(t["export"]) == 3


# ---------------------------------------------------------------- tracing

def _scenario(cls, dm, req_cls):
    rset = cls(dm, n_replicas=2, n_blocks=32, block_tokens=8, max_batch=2,
               codec="int8_block", prefix_cache=True)
    rs = np.random.RandomState(11)
    shared = rs.randint(0, 256, 16)
    reqs = [req_cls(prompt_ids=np.concatenate([shared,
                                               rs.randint(0, 256, 2 + i)])
                    if i % 2 else rs.randint(0, 256, 6 + i),
                    max_new_tokens=5, request_id=f"s{i}") for i in range(6)]
    for r in reqs:
        assert rset.submit(r)
    rset.pump(1)
    rset.evict(0, "hang")
    rset.pump(1)
    rset.scale_down(1)
    rset.scale_up()
    for _ in range(200):
        if len(rset.results) == len(reqs):
            break
        rset.pump()
    assert all(r.outcome == "completed" for r in rset.results.values())
    return {r.request_id: r.trace for r in rset.results.values()}


def _trace(store, ctx):
    rec = store.get(ctx.trace_id)
    return {"name": rec["name"], "request_id": rec["request_id"],
            "fields": rec.get("fields"), "dropped": rec["dropped_spans"],
            "spans": [(s["name"], s["fields"]) for s in rec["spans"]]}


def check_request_spans_match_reference(dms):
    jdm, tdm = dms
    jt = _scenario(JaxReplicaSet, jdm, JaxRequest)
    tt = _scenario(ReplicaSet, tdm, ServeRequest)
    assert sorted(tt) == sorted(jt)
    hops = set()
    for rid in tt:
        got = _trace(get_tracer().store, tt[rid])
        assert got == _trace(jax_tracer().store, jt[rid]), rid
        hops |= {n for n, _ in got["spans"]}
    assert {"queue_wait", "prefill", "decode_step", "drain", "eviction",
            "requeue_front", "scale_down", "retire"} <= hops


# --------------------------------------------------------- flight recorder

def _ring(mod, d):
    rec = mod.FlightRecorder(capacity=4, dump_dir=d, rank=0)
    for i in range(5):
        rec.note("trace", f"span{i}", trace="t", i=i)
    rec.lane("comm_launch:bucket3", bucket=3, group="world", phase="launch")
    rec._on_event({"mono": 1.0, "time": 2.0, "kind": "serving",
                   "severity": "error", "message": "evicted", "rank": 0,
                   "replica": "replica-0"})
    path = rec.dump("hang:heartbeat_stale")
    doc = json.load(open(path))
    return {"entries": [_no_clocks(e) for e in rec.entries()],
            "lanes": [_no_clocks(e) for e in rec.entries(kind="lane")],
            "last": [_no_clocks(e) for e in rec.entries(n=2)],
            "len": len(rec),
            "dump": {k: (v if k != "entries" else
                         [_no_clocks(e) for e in v])
                     for k, v in doc.items()
                     if k not in ("time", "mono", "pid")},
            "dumps": [d_["reason"] for d_ in rec.dumps],
            "off": mod.FlightRecorder(capacity=0, dump_dir=d).dump("x")}


def check_flight_recorder_matches_reference():
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        t, j = _ring(tfr, d1), _ring(jfr, d2)
    assert t == j
    assert t["len"] == 4 and t["dump"]["n_entries"] == 4
    assert t["off"] is None
    # the global recorder taps every event log and the tracer's commits
    with tempfile.TemporaryDirectory() as d:
        old = tfr._recorder
        try:
            rec = tfr.configure_flight_recorder(capacity=64, dump_dir=d)
            tobs.EventLog().warning("integrity", "divergence", step=3)
            ctx = get_tracer().start_trace("probe", request_id="p")
            get_tracer().record_span(ctx, "retire", outcome="completed")
            kinds = [(e["kind"], e["name"]) for e in rec.entries()]
            assert ("event", "integrity") in kinds
            assert ("trace", "retire") in kinds
            path = tfr.dump_flight_recorder("probe")
            assert os.path.dirname(path) == d
            assert json.load(open(path))["reason"] == "probe"
        finally:
            with tfr._install_lock:
                tfr._uninstall(tfr._recorder)
                tfr._recorder = (tfr._install(old) if old is not None
                                 else None)


# ------------------------------------------------------------- telemetry

def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read().decode()


def _status(url):
    try:
        return _get(url)[0]
    except urllib.error.HTTPError as e:
        return e.code


def check_telemetry_server_routes(dms):
    _, tdm = dms
    with pytest.raises(NotImplementedError, match="replicas and tracing"):
        texpo.TelemetryServer(aggregator=object())
    with pytest.raises(NotImplementedError, match="replicas and tracing"):
        texpo.start_exposition(port=0, aggregator=object())
    assert flag("FLAGS_telemetry_http_port") == 0
    assert texpo.start_exposition() is None      # the flag says off
    rset = ReplicaSet(tdm, n_replicas=1, n_blocks=16, block_tokens=8,
                      max_batch=2)
    with texpo.TelemetryServer(port=0) as srv:
        assert srv.host == "127.0.0.1" and srv.url.startswith(
            "http://127.0.0.1:")
        with rset:
            ids = []
            for i in range(3):
                r = ServeRequest(prompt_ids=np.arange(5 + i) % 256,
                                 max_new_tokens=4, request_id=f"h{i}")
                assert rset.submit(r)
                ids.append(r.request_id)
            res = rset.wait(ids, timeout=60)
            assert len(res) == 3
            code, text = _get(srv.url + "/metrics")
            fams = texpo.parse_prometheus_text(text)
            assert fams["serve_request_latency_ms"]["type"] == "histogram"
            assert fams["serve_request_latency_ms"]["exemplars"]
            doc = json.loads(_get(srv.url + "/serving")[1])
            assert doc["alive_replicas"] == 1 and doc["completed"] == 3
            assert doc["replicas"][0]["kv"]["codec"] == "fp32"
            idx = json.loads(_get(srv.url + "/traces")[1])
            tid = res["h0"].trace.trace_id
            assert tid in {t["trace_id"] for t in idx["traces"]}
            one = json.loads(_get(srv.url + "/traces/" + tid)[1])
            names = [s["name"] for s in one["spans"]]
            assert names[0] == "queue_wait" and names[-1] == "retire"
            assert _status(srv.url + "/traces/t0-nope") == 404
            verbose = json.loads(_get(srv.url + "/healthz?verbose=1")[1])
            assert {"/serving", "/traces", "/metrics"} <= set(
                verbose["paths"])
        assert _get(srv.url + "/healthz") == (200, "ok\n")
        assert _status(srv.url + "/traces") == 404
        assert _status(srv.url + "/serving") == 404
        ev = json.loads(_get(srv.url + "/events?n=2")[1])
        assert len(ev["events"]) <= 2
        fr = json.loads(_get(srv.url + "/flightrecorder?n=3")[1])
        assert len(fr["entries"]) <= 3 and "capacity" in fr
        snap = json.loads(_get(srv.url + "/snapshot")[1])
        assert snap["aggregated"] is False
        assert "serve_ttft_ms" in snap["metrics"]
        nf = _status(srv.url + "/nope")
        assert nf == 404
    srv2 = texpo.start_exposition(port=0)
    try:
        assert srv2 is texpo.get_telemetry_server()
        assert _get(srv2.url + "/healthz")[0] == 200
    finally:
        texpo.stop_exposition()
    assert texpo.get_telemetry_server() is None


# -------------------------------------------------------------- watchdog

def _wait_for(cond, limit=5.0):
    end = time.monotonic() + limit
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


def check_hang_detector_with_and_without_grace():
    with tempfile.TemporaryDirectory() as d:
        old = tfr._recorder
        try:
            rec = tfr.configure_flight_recorder(capacity=256, dump_dir=d)
            ages = []
            hd = twatchdog.HangDetector(timeout=0.3, on_hang=ages.append)
            with hd:
                # on_hang is the detector's last act on a stall: wait for
                # it, not for the count it bumps first
                assert _wait_for(lambda: len(ages) == 1)
                assert hd.hang_count == 1 and hd.stalled and ages[0] > 0.3
                hd.beat()
                assert not hd.stalled
            assert any(x["reason"] == "hang:heartbeat_stale"
                       for x in rec.dumps)
            state = {"s": "compiling"}
            hd = twatchdog.HangDetector(timeout=0.3, on_hang=ages.append,
                                        state_fn=lambda: state["s"],
                                        compile_grace=1.5)
            assert hd.effective_timeout() == 1.5
            with hd:
                time.sleep(0.8)
                assert hd.hang_count == 0       # inside the grace
                state["s"] = "serving"
                assert hd.effective_timeout() == 0.3
                assert _wait_for(lambda: len(ages) == 2)
                assert hd.hang_count == 1
            n = len(ages)
            hd = twatchdog.HangDetector(timeout=60, on_hang=ages.append)
            hd.escalate("collective retries exhausted")
            assert hd.hang_count == 1 and len(ages) == n + 1
            assert any(x["reason"].startswith("hang_escalated:")
                       for x in rec.dumps)
            for p in (os.path.join(d, f) for f in os.listdir(d)):
                assert json.load(open(p))["entries"] is not None
        finally:
            with tfr._install_lock:
                tfr._uninstall(tfr._recorder)
                tfr._recorder = (tfr._install(old) if old is not None
                                 else None)


def check_nan_guard_matches_reference():
    nan = float("nan")
    steps = [(1.0, None), (nan, None), (1.0, [np.array([np.inf])]),
             (nan, None, True), (2.0, None)]
    outs = []
    for mod, wrap in ((twatchdog, torch.tensor), (jwatchdog, np.asarray)):
        g = mod.NanGuard(policy="skip_step", max_consecutive_bad=3)
        got = []
        for s in steps:
            grads = [wrap(x) for x in s[1]] if s[1] else None
            got.append(g.check(loss=wrap(s[0]), grads=grads,
                               scaler_skipped=len(s) > 2))
        g2 = mod.NanGuard(policy="raise")
        try:
            g2.check(loss=wrap(nan))
            got.append("no raise")
        except mod.NanLossError:
            got.append("NanLossError")
        g3 = mod.NanGuard(policy="rollback", max_consecutive_bad=2)
        got.append(g3.check(loss=wrap(nan)))
        try:
            g3.check(loss=wrap(nan))
        except mod.CircuitBreakerTripped:
            got.append("breaker")
        got.append(g.state_dict())
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][:3] == ["ok", "skip_step", "skip_step"]


# -------------------------------------------------------------- rpc event

def check_rpc_profiler_records_reference_event():
    prev = (flag("FLAGS_enable_rpc_profiler"),
            jflags.flag("FLAGS_enable_rpc_profiler"))
    tprev = tobs.set_event_log(tobs.EventLog())
    jprev = jobs.set_event_log(jobs.EventLog())
    keys = np.arange(3, dtype=np.uint64)
    grads = np.ones((3, 4), np.float32)
    try:
        set_flags({"FLAGS_enable_rpc_profiler": True})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jflags.set_flags({"FLAGS_enable_rpc_profiler": True})
        assert tobs.rpc_profiler_enabled()
        for mod in (tcomm, jcomm):
            mod._record_rpc("push_sparse", 2, keys, grads)
            mod._record_rpc("pull_sparse", 2, keys)
        got = [_no_clocks(e) for e in tobs.get_event_log().events()]
        want = [_no_clocks(e) for e in jobs.get_event_log().events()]
        assert got == want
        assert [(e["op"], e["bytes"]) for e in got] == [
            ("push_sparse", 48), ("pull_sparse", None)]
        set_flags({"FLAGS_enable_rpc_profiler": False})
        tcomm._record_rpc("pull_sparse", 2, keys)
        assert len(tobs.get_event_log().events()) == 2
    finally:
        set_flags({"FLAGS_enable_rpc_profiler": prev[0]})
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jflags.set_flags({"FLAGS_enable_rpc_profiler": prev[1]})
        tobs.set_event_log(tprev)
        jobs.set_event_log(jprev)


def check_port_imports_no_jax():
    code = ("import paddle_tpu_torch.observability, "
            "paddle_tpu_torch.robustness, paddle_tpu_torch.serving, sys; "
            "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu') or "
            "m.startswith(('jax.', 'paddle_tpu.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_observability_matches_reference(fresh_mesh):
    dms = (JaxDecodeModel(JaxGPT(jax_presets("gpt-test"), seed=0)),
           GPTDecodeModel(GPTForCausalLM(gpt_presets("gpt-test"), seed=0,
                                         device="cpu")))
    run_checks([
        (check_registries_expose_identical_text, ()),
        (check_parser_accepts_and_rejects_as_reference, ()),
        (check_event_log_matches_reference, ()),
        (check_request_spans_match_reference, (dms,)),
        (check_flight_recorder_matches_reference, ()),
        (check_telemetry_server_routes, (dms,)),
        (check_hang_detector_with_and_without_grace, ()),
        (check_nan_guard_matches_reference, ()),
        (check_rpc_profiler_records_reference_event, ()),
        (check_port_imports_no_jax, ()),
    ])

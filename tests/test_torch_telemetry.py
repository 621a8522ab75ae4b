"""The port's telemetry against the reference, on the CPU: the registry,
the Prometheus exposition (text equal to the reference's for the same
calls), span nesting and tags, the bounded ring, the no-op mode's zero
allocations, ``traced``, the JSONL round trip, merge and the CLI, the
metrics-file export with its swallowed fault; and the spans the port's
grid and checkpoint calls record, equal to the reference's on the same
calls (the counterparts of ``tests/test_telemetry.py:42-279``).
"""

import json
import subprocess
import sys
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

from dccrg_tpu import resilience as ref_res
from dccrg_tpu import telemetry as ref_tel
from dccrg_tpu.grid import Grid as RefGrid
from torch_amr_fixture import mesh1

import torch

from dccrg_tpu_torch import Grid, faults, resilience, telemetry

REPO = Path(__file__).resolve().parents[1]


def _reset(tel):
    tel.configure(trace=False)
    tel.clear_trace()
    tel.registry().reset()
    tel._METRICS_STATE["last"] = None


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Tracing off, an empty ring and a fresh registry before and after
    every test, in both packages (the registries are process-global)."""
    for tel in (telemetry, ref_tel):
        _reset(tel)
    yield
    for tel in (telemetry, ref_tel):
        _reset(tel)
        tel.configure(ring=tel.trace_ring_default())


# -- registry ---------------------------------------------------------

def test_counters_gauges_histograms():
    telemetry.inc("dccrg_trips_total", kind="numerics")
    telemetry.inc("dccrg_trips_total", kind="numerics")
    telemetry.inc("dccrg_trips_total", kind="corrupt")
    telemetry.set_gauge("dccrg_arena_pool_hits", 7)
    telemetry.observe("dccrg_step_seconds", 0.01)
    telemetry.observe("dccrg_step_seconds", 0.02)
    reg = telemetry.registry()
    assert reg.counter_value("dccrg_trips_total", kind="numerics") == 2
    assert reg.counter_value("dccrg_trips_total", kind="corrupt") == 1
    assert reg.counter_total("dccrg_trips_total") == 3
    h = reg.histogram("dccrg_step_seconds")
    assert h.total == 2 and abs(h.sum_seconds - 0.03) < 1e-9
    assert h.quantile(0.5) >= 0.01
    merged = reg.histogram_total("dccrg_step_seconds")
    assert merged.counts == h.counts
    assert reg.histogram_total("nothing") is None


def test_log_histogram_matches_reference():
    mine, theirs = telemetry.LogHistogram(), ref_tel.LogHistogram()
    assert (mine.BASE, mine.N_BUCKETS) == (theirs.BASE, theirs.N_BUCKETS)
    for s in (0.0, 5e-5, 1e-4, 0.0123, 0.5, 3.0, 1e6, -1.0):
        mine.record(s)
        theirs.record(s)
    assert mine.counts == theirs.counts
    assert mine.buckets() == theirs.buckets()
    for q in (0.1, 0.5, 0.95, 1.0):
        assert mine.quantile(q) == theirs.quantile(q)
    assert mine.summary() == theirs.summary()
    assert telemetry.LogHistogram().summary() == "no steps recorded"


def _metric_calls(tel):
    tel.inc("dccrg_saves_total", kind="keyframe")
    tel.inc("dccrg_saves_total", 2, kind="delta")
    tel.inc("dccrg_loads_total")
    tel.set_gauge("dccrg_arena_pool_hits", 7)
    tel.set_gauge("dccrg_lane_suspects", 1.5, lane="0")
    tel.observe("dccrg_fleet_quantum_seconds", 0.004, job="a")
    tel.observe("dccrg_fleet_quantum_seconds", 0.3, job="a")
    tel.observe("dccrg_ckpt_save_seconds", 12.5, kind="keyframe")
    tel.inc("dccrg_fleet_trips_total", job='we"ird\\name\nx')


def test_dump_prometheus_text_equals_reference():
    _metric_calls(telemetry)
    _metric_calls(ref_tel)
    text = telemetry.dump_prometheus()
    assert text == ref_tel.dump_prometheus()
    assert "# TYPE dccrg_saves_total counter" in text
    assert 'dccrg_saves_total{kind="keyframe"} 1' in text
    assert "# TYPE dccrg_fleet_quantum_seconds histogram" in text
    assert 'dccrg_fleet_quantum_seconds_count{job="a"} 2' in text
    assert 'job="we\\"ird\\\\name\\nx"' in text
    lines = [ln for ln in text.splitlines()
             if ln.startswith("dccrg_fleet_quantum_seconds_bucket")]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert counts == sorted(counts) and counts[-1] == 2
    assert telemetry.parse_prometheus_histograms(text) == \
        ref_tel.parse_prometheus_histograms(text)
    telemetry.registry().reset()
    assert telemetry.dump_prometheus() == ""


# -- span tracer ------------------------------------------------------

def test_span_nesting_depth_and_parent():
    telemetry.configure(trace=True)
    with telemetry.span("outer"):
        with telemetry.span("inner", {"k": 3}):
            pass
    evs = telemetry.events()
    byname = {e["name"]: e for e in evs}
    assert byname["inner"]["depth"] == 1
    assert byname["inner"]["parent"] == "outer"
    assert byname["inner"]["k"] == 3
    assert byname["outer"]["depth"] == 0 and "parent" not in byname["outer"]
    assert all(e["dur"] >= 0 and e["rank"] == 0 for e in evs)


def test_ambient_tags_scope():
    telemetry.configure(trace=True)
    with telemetry.tags(job="j42"):
        with telemetry.span("ckpt.save"):
            pass
    with telemetry.span("ckpt.save"):
        pass
    evs = [e for e in telemetry.events() if e["name"] == "ckpt.save"]
    assert evs[0]["job"] == "j42" and "job" not in evs[1]


def test_trace_ring_is_bounded_and_drops_are_counted():
    telemetry.configure(trace=True, ring=32)
    for _ in range(100):
        with telemetry.span("s"):
            pass
    assert len(telemetry.events()) == 32
    assert telemetry.registry().counter_value(
        "dccrg_trace_dropped_total") == 68


def test_noop_mode_is_singleton_and_zero_allocation():
    """Tracing off: span() and tags() return ONE shared no-op object;
    no per-call allocation on the step path."""
    assert not telemetry.trace_enabled()
    assert telemetry.span("grid.step") is telemetry.span("fleet.quantum")
    assert telemetry.tags(job="x") is telemetry.span("grid.step")
    with telemetry.span("warmup"):
        pass
    tracemalloc.start()
    tracemalloc.reset_peak()
    c0, _ = tracemalloc.get_traced_memory()
    for _ in range(5000):
        with telemetry.span("grid.step"):
            pass
    c1, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert c1 - c0 < 512, "no-op spans retained allocations"
    assert peak - c0 < 4096, "no-op spans allocated per call"
    assert telemetry.events() == []


def test_record_span_and_traced_decorator():
    telemetry.configure(trace=True)
    telemetry.record_span("hybrid.classification", 0.125, {"n": 2})

    @telemetry.traced("fn.x", counter="dccrg_fn_x_total")
    def f(a):
        return a + 1

    assert f(1) == 2
    telemetry.configure(trace=False)
    assert f(2) == 3  # untraced call still counts
    telemetry.record_span("dropped", 1.0)
    evs = telemetry.events()
    assert [e["name"] for e in evs] == ["hybrid.classification", "fn.x"]
    assert evs[0]["dur"] == 0.125 and evs[0]["n"] == 2
    assert telemetry.registry().counter_value("dccrg_fn_x_total") == 2


def test_env_knobs(monkeypatch):
    for env, fn, default in (("DCCRG_TRACE", "trace_enabled_default", False),
                             ("DCCRG_TRACE_RING", "trace_ring_default", 65536),
                             ("DCCRG_METRICS_EVERY", "metrics_every_default",
                              10.0)):
        monkeypatch.delenv(env, raising=False)
        assert getattr(telemetry, fn)() == default
    monkeypatch.setenv("DCCRG_TRACE", "1")
    assert telemetry.trace_enabled_default()
    monkeypatch.setenv("DCCRG_TRACE", "off")
    assert not telemetry.trace_enabled_default()
    monkeypatch.setenv("DCCRG_TRACE_RING", "4")
    assert telemetry.trace_ring_default() == 16
    monkeypatch.setenv("DCCRG_TRACE_RING", "x")
    assert telemetry.trace_ring_default() == 65536
    monkeypatch.setenv("DCCRG_TRACE_FILE", "/t/{rank}.jsonl")
    assert telemetry.trace_file_default() == "/t/{rank}.jsonl"
    monkeypatch.setenv("DCCRG_METRICS_FILE", "/m.prom")
    assert telemetry.metrics_file_default() == "/m.prom"
    monkeypatch.setenv("DCCRG_TRACE", "1")
    telemetry.configure()
    assert telemetry.trace_enabled()


# -- JSONL export + merge ---------------------------------------------

def test_jsonl_roundtrip_and_flush_clears_ring(tmp_path):
    telemetry.configure(trace=True)
    with telemetry.span("a", {"job": "x"}):
        pass
    with telemetry.span("b"):
        pass
    p = tmp_path / "trace.jsonl"
    assert telemetry.flush_trace(str(p)) == 2 and telemetry.events() == []
    evs = telemetry.read_trace(str(p))
    assert [e["name"] for e in evs] == ["a", "b"]
    assert evs[0]["job"] == "x"
    assert all(set(e) >= {"name", "ts", "dur", "rank", "depth"}
               for e in evs)
    with telemetry.span("c"):
        pass
    assert telemetry.flush_trace(str(p)) == 1
    assert [e["name"] for e in telemetry.read_trace(str(p))] == \
        ["a", "b", "c"]
    assert telemetry.flush_trace(str(p)) == 0  # empty ring
    assert ref_tel.read_trace(str(p)) == telemetry.read_trace(str(p))


def test_flush_substitutes_rank(tmp_path, monkeypatch):
    telemetry.configure(trace=True)
    with telemetry.span("s"):
        pass
    monkeypatch.setenv("DCCRG_TRACE_FILE", str(tmp_path / "t{rank}.jsonl"))
    assert telemetry.flush_trace() == 1
    assert [e["name"] for e in telemetry.read_trace(
        str(tmp_path / "t0.jsonl"))] == ["s"]


def test_merge_traces_orders_across_ranks(tmp_path):
    r0, r1 = tmp_path / "r0.jsonl", tmp_path / "r1.jsonl"
    r0.write_text("".join(json.dumps(e) + "\n" for e in [
        {"name": "grid.step", "ts": 1.0, "dur": 0.5, "rank": 0, "depth": 0},
        {"name": "ckpt.save", "ts": 3.0, "dur": 0.2, "rank": 0,
         "depth": 0}]))
    r1.write_text("".join(json.dumps(e) + "\n" for e in [
        {"name": "grid.step", "ts": 2.0, "dur": 0.5, "rank": 1,
         "depth": 0}]) + "{torn line")
    evs = telemetry.merge_traces([str(r0), str(r1)])
    assert [(e["ts"], e["rank"]) for e in evs] == \
        [(1.0, 0), (2.0, 1), (3.0, 0)]
    assert evs == ref_tel.merge_traces([str(r0), str(r1)])
    stats = telemetry.span_stats(evs)
    assert stats == ref_tel.span_stats(evs)
    assert stats["grid.step"]["count"] == 2
    assert abs(stats["grid.step"]["total_s"] - 1.0) < 1e-9
    assert telemetry.root_coverage(evs, 2.4) == \
        ref_tel.root_coverage(evs, 2.4)


def test_cli_merge_and_summary(tmp_path, capsys):
    p = tmp_path / "t.jsonl"
    p.write_text(json.dumps({"name": "s", "ts": 1.0, "dur": 0.1,
                             "rank": 0, "depth": 0}) + "\n")
    _metric_calls(telemetry)
    prom = tmp_path / "m.prom"
    prom.write_text(telemetry.dump_prometheus())
    assert telemetry._main(["merge", str(p)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[0])["name"] == "s"
    assert telemetry._main(["summary", str(p), str(prom)]) == 0
    summ = json.loads(capsys.readouterr().out)
    assert ref_tel._main(["summary", str(p), str(prom)]) == 0
    assert summ == json.loads(capsys.readouterr().out)
    assert summ["events"] == 1 and summ["ranks"] == [0]
    assert summ["spans"]["s"]["count"] == 1
    assert 'dccrg_fleet_quantum_seconds{job="a"}' in summ["histograms"]


def test_cli_runs_as_module_without_jax(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text(json.dumps({"name": "s", "ts": 1.0, "dur": 0.1,
                             "rank": 0, "depth": 0}) + "\n")
    code = ("import runpy, sys\n"
            "sys.argv = ['x', 'summary', sys.argv[1]]\n"
            "try:\n"
            "    runpy.run_module('dccrg_tpu_torch.telemetry',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'dccrg_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code, str(p)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["spans"]["s"]["count"] == 1


# -- metrics file export ----------------------------------------------

def test_metrics_file_export(tmp_path, monkeypatch):
    telemetry.inc("dccrg_trips_total", kind="numerics")
    p = tmp_path / "metrics.prom"
    assert not telemetry.maybe_export_metrics(now=0.0)  # no knob: no-op
    monkeypatch.setenv("DCCRG_METRICS_FILE", str(p))
    assert telemetry.maybe_export_metrics(now=0.0)
    assert "dccrg_trips_total" in p.read_text()
    telemetry.inc("dccrg_trips_total", kind="numerics")
    assert not telemetry.maybe_export_metrics(now=1.0)
    assert telemetry.maybe_export_metrics(
        now=1.0 + telemetry.metrics_every_default())
    assert 'dccrg_trips_total{kind="numerics"} 2' in p.read_text()


def test_export_failure_is_swallowed_and_counted(tmp_path, monkeypatch):
    telemetry.configure(trace=True)
    with telemetry.span("s"):
        pass
    plan = faults.FaultPlan(seed=0)
    plan.telemetry_io_error(times=2)
    monkeypatch.setenv("DCCRG_METRICS_FILE", str(tmp_path / "m.prom"))
    with plan:
        assert telemetry.flush_trace(str(tmp_path / "t.jsonl")) == 0
        assert not telemetry.export_metrics()
    assert plan.fired("telemetry.export") == 2
    assert telemetry.registry().counter_value(
        "dccrg_telemetry_export_errors_total") == 2
    assert telemetry.events() == []
    assert not (tmp_path / "m.prom").exists()
    # a real I/O failure is swallowed the same way
    assert telemetry.export_metrics(str(tmp_path / "no" / "dir.prom")) is False


# -- the spans of the port's grid and checkpoint calls -----------------

def _ref_kernel(c, nbr, offs, mask):
    return {"v": jnp.float32(0.5) * c["v"] + jnp.float32(0.125) * jnp.sum(
        jnp.where(mask, nbr["v"], jnp.float32(0)), axis=1)}


def _port_kernel(c, nbr, offs, mask):
    return {"v": 0.5 * c["v"] + 0.125 * torch.sum(
        torch.where(mask, nbr["v"], 0.0), dim=1)}


def _traced_calls(make, tel, res, kernel, dtype, load_kw, path):
    """run_steps, stop_refining, run_steps, balance_load, a checkpoint
    save and load, traced; returns ``(name, depth, parent)`` per event."""
    tel.configure(trace=True)
    g = make(cell_data={"v": dtype}).set_initial_length((4, 4, 2)) \
        .set_periodic(True, True, False).set_maximum_refinement_level(1) \
        .set_neighborhood_length(1)
    g = g.initialize(load_kw.get("mesh", load_kw.get("device")))
    g.set("v", g.plan.cells, (g.plan.cells % 7).astype(np.float32))
    g.run_steps(kernel, ["v"], ["v"], 2)
    g.refine_completely(np.uint64(3))
    g.stop_refining()
    g.run_steps(kernel, ["v"], ["v"], 1)
    g.balance_load()
    res.save_checkpoint(g, path)
    res.load_checkpoint(path, {"v": dtype}, **load_kw)
    evs = tel.events()
    tel.configure(trace=False)
    return [(e["name"], e["depth"], e.get("parent")) for e in evs]


def test_grid_and_checkpoint_spans_equal_reference(tmp_path):
    """Same span names, nesting and counts as the reference's on the same
    calls. The hybrid builder's per-table sub-phases (``hybrid.tables[``)
    are marked by each package's own table builder and left out; every
    other hybrid phase, and the grid and checkpoint spans, compare."""
    want = _traced_calls(RefGrid, ref_tel, ref_res, _ref_kernel, jnp.float32,
                         {"mesh": mesh1()}, str(tmp_path / "r.dc"))
    got = _traced_calls(Grid, telemetry, resilience, _port_kernel,
                        torch.float32, {"device": "cpu"},
                        str(tmp_path / "p.dc"))

    def keep(evs):
        return [e for e in evs if not e[0].startswith("hybrid.tables[")]

    assert keep(got) == keep(want)
    names = [e[0] for e in got]
    for name, count in (("grid.step", 2), ("grid.adapt", 1),
                        ("grid.recommit", 2), ("grid.balance", 1),
                        ("ckpt.save", 1), ("ckpt.load", 1)):
        assert names.count(name) == count, name
    assert telemetry.registry().counter_value("dccrg_loads_total") == 1
    assert telemetry.registry().counter_value(
        "dccrg_saves_total", kind="keyframe") == 1
    assert telemetry.registry().histogram(
        "dccrg_ckpt_save_seconds", kind="keyframe").total == 1


def test_tracing_off_records_nothing_on_the_grid_path(tmp_path):
    g = Grid(cell_data={"v": torch.float32}).set_initial_length(
        (4, 4, 2)).initialize("cpu")
    g.run_steps(_port_kernel, ["v"], ["v"], 2)
    resilience.save_checkpoint(g, str(tmp_path / "x.dc"))
    assert telemetry.events() == []
    assert telemetry.registry().counter_value(
        "dccrg_saves_total", kind="keyframe") == 1

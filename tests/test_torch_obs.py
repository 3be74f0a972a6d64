"""The port's observability hooks (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

* **The copies.** ``obs/audit.py``, ``obs/metrics.py`` and ``obs/trace.py``
  give the originals' output on the same seeded inputs: the registry's
  Prometheus text and JSON, the audit's JSONL and CSV, and the trace of
  the same packed arrays and observer records are identical.
* **Sessions with every switch on, in both packages** (``torch_device=
  "cpu"`` on the port's side): ``smoke`` (8 frames), a ``cloud_only``
  baseline, ``fleet-16-congested`` orchestrated (3 frames) and the same
  fleet in scan mode with metrics and the trace. Audit rows equal (``kind``
  exact, floats at rtol 1e-4, atol 1e-5); metric family names, types and
  label sets equal, and their modelled values at that tolerance; trace
  events equal on the modelled lanes (streams, uplink, cloud GPUs); the
  same host-lane span names. Left out: wall-time values (the host spans'
  durations, the autotune table's seconds), the ``compiled`` flag and the
  ``moby_jit_*`` families, since JAX compiles on the CPU and the port
  does not.
* **Off is free.** An observed run equals the unobserved one bit for bit;
  scan mode with the audit on raises; ``export_artifacts`` expands its
  placeholders; a span in which the compile count grew is marked
  ``compiled``.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.obs import audit as jaudit  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.obs import audit, metrics, observe, trace  # noqa: E402
from repro_torch.serving import common  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
MODELLED_PIDS = (trace.PID_STREAMS, trace.PID_UPLINK, trace.PID_CLOUD)


def _all_on(pkg):
    return pkg.ObsConfig(metrics=True, trace=True, audit=True,
                         registry=pkg.MetricsRegistry())


def _pair(name, frames, scan=False, audit_on=True, **overrides):
    """The same observed run in both packages: (JAX report, port report)."""
    def cfg(pkg):
        return _all_on(pkg) if audit_on else pkg.ObsConfig(
            metrics=True, trace=True, registry=pkg.MetricsRegistry())
    want = japi.Session(japi.scenario(name, seed=0, backend="ref",
                                      **overrides),
                        obs=cfg(jobs)).run(frames, scan=scan)
    got = api.Session(api.scenario(name, seed=0, **overrides),
                      torch_device="cpu", obs=cfg(obs)).run(frames,
                                                            scan=scan)
    return want, got


@pytest.fixture(scope="module")
def smoke():
    return _pair("smoke", 8)


@pytest.fixture(scope="module")
def baseline():
    return _pair("smoke", 6, mode="cloud_only")


@pytest.fixture(scope="module")
def fleet():
    return _pair("fleet-16-congested", 3)


@pytest.fixture(scope="module")
def scan():
    return _pair("fleet-16-congested", 3, scan=True, audit_on=False)


RUNS = ("smoke", "baseline", "fleet", "scan")


# ---------------------------------------------------------------------------
# The copies
# ---------------------------------------------------------------------------


def _fill(mod, rng_seed):
    """The same observations into a registry of ``mod``."""
    rng = np.random.default_rng(rng_seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("moby_frames_total", "frames", labels=("kind",))
    g = reg.gauge("moby_p95", "p95 \"quoted\"\nhelp", labels=("dev", "s"))
    h = reg.histogram("moby_lat", "lat", labels=("kind",))
    h2 = reg.histogram("moby_span", "", labels=(), buckets=(1e-3, 1e-2))
    for k, v in zip(rng.integers(0, 3, 40), rng.exponential(0.2, 40)):
        kind = ("anchor", "test", "transform")[k]
        c.inc(float(rng.integers(1, 4)), kind=kind)
        h.observe(float(v), kind=kind)
    h.observe_many(rng.exponential(1.0, 7), kind="anchor")
    for s in range(5):
        g.set(float(rng.normal()), dev="jetson_tx2", s=s)
    g.set(float("inf"), dev="orin", s=0)
    h2.observe(0.005)
    reg.gauge("moby_empty", "no samples", labels=("x",))
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_copy_is_identical(seed):
    a, b = _fill(jmetrics, seed), _fill(metrics, seed)
    assert a.to_prometheus() == b.to_prometheus()
    assert a.to_json() == b.to_json()
    assert jmetrics.DEFAULT_BUCKETS == metrics.DEFAULT_BUCKETS
    with pytest.raises(ValueError, match="already registered"):
        b.gauge("moby_frames_total", labels=("kind",))
    with pytest.raises(ValueError, match="cannot decrease"):
        b.get("moby_frames_total").inc(-1, kind="test")


def _fake_report(pkg_common, seed):
    rng = np.random.default_rng(seed)
    s_n, f_n = 3, 6
    kind = rng.choice(["anchor", "test", "transform"], (s_n, f_n))
    return pkg_common.RunReport(
        kind=kind.astype("<U12"), latency_s=rng.exponential(0.2, (s_n, f_n)),
        onboard_s=rng.exponential(0.05, (s_n, f_n)),
        f1=rng.uniform(size=(s_n, f_n)), precision=rng.uniform(size=(s_n, f_n)),
        recall=rng.uniform(size=(s_n, f_n)), scenario="s", policy="fos",
        device=np.asarray(["jetson_tx2", "jetson_orin", "jetson_tx2"]),
        frame_dt=0.1)


def _observer(pkg_observe, seed):
    """An observer of ``pkg_observe`` with the same seeded records."""
    rng = np.random.default_rng(seed)
    o = pkg_observe.Observer(pkg_observe.ObsConfig(
        metrics=True, trace=True, audit=True), n_streams=3,
        devices=("jetson_tx2", "jetson_orin", "jetson_tx2"), policy="fos",
        frame_dt=0.1)
    for f in range(6):
        o.record_uplink("up", 0.1 * f, float(rng.uniform(0.1, 0.4)),
                        int(rng.integers(1, 4)), 870000,
                        float(rng.uniform(2, 30)))
        o.record_uplink("down", 0.1 * f + 0.5, float(rng.uniform(0, 0.01)),
                        1, 448, float(rng.uniform(2, 30)))
        o.on_cloud_batch(f % 2, 0.2 * f, 0.2 * f + 0.05, 2, 0.2 * f - 0.01)
        o.note_telemetry(rng.uniform(1, 9, 3), rng.uniform(0, 1, 3),
                         rng.uniform(0, 1, 3))
        o.audit_frame(f, rng.choice(["anchor", "transform"], 3),
                      rng.uniform(size=3), rng.integers(0, 9, 3))
        o.measured.append({"name": "fleet/dispatch", "t0": 0.01 * f,
                           "dur": 0.002, "frame": f})
    return o


@pytest.mark.parametrize("seed", [0, 3])
def test_trace_and_audit_copies_are_identical(seed):
    jrep, rep = _fake_report(common, seed), _fake_report(common, seed)
    jo, o = _observer(jobs.observe, seed), _observer(observe, seed)
    assert jo.audit.to_jsonl() == o.audit.to_jsonl()
    assert jo.audit.to_csv() == o.audit.to_csv()
    assert jaudit.AUDIT_FIELDS == audit.AUDIT_FIELDS
    for ob_j, ob_t in ((None, None), (jo, o)):
        assert json.dumps(jtrace.trace_from_report(jrep, ob_j).to_chrome()) \
            == json.dumps(trace.trace_from_report(rep, ob_t).to_chrome())
    # The report-filled registry, with the observer's own accounting.
    jo.finalize(jrep, busy_s_g=[0.5, 0.25])
    o.finalize(rep, busy_s_g=[0.5, 0.25])
    a, b = jmetrics.MetricsRegistry(), metrics.MetricsRegistry()
    jmetrics.fill_report_metrics(a, jrep)
    metrics.fill_report_metrics(b, rep)
    assert a.to_prometheus() == b.to_prometheus()


def test_obs_exports_match_jax():
    assert obs.__all__ == jobs.__all__
    assert "ObsConfig" in api.__all__ and api.ObsConfig is obs.ObsConfig
    assert [f.name for f in obs.ObsConfig.__dataclass_fields__.values()] \
        == [f.name for f in jobs.ObsConfig.__dataclass_fields__.values()]


# ---------------------------------------------------------------------------
# Sessions with every switch on, in both packages
# ---------------------------------------------------------------------------


def _close(g, w, what):
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("run", ["smoke", "baseline", "fleet"])
def test_audit_rows_match_jax(run, request):
    want, got = request.getfixturevalue(run)
    w_rows, g_rows = want.obs.audit.rows, got.obs.audit.rows
    assert len(g_rows) == len(w_rows) == want.kind.size
    for w, g in zip(w_rows, g_rows):
        assert g.keys() == w.keys()
        for k in ("stream", "frame", "policy", "device", "kind",
                  "frames_since_anchor"):
            assert g[k] == w[k], (k, w)
        for k in ("err_ewma", "bw_mbps", "edge_cost_s", "offload_cost_s"):
            _close(g[k], w[k], f"{k} {w}")
    # The JSONL export carries the same rows.
    assert len(got.to_audit().splitlines()) == len(g_rows)


def _families(reg):
    """{name: (type, labels, samples)} of a registry's JSON export, without
    the families that hold wall times or compile counts."""
    doc = json.loads(reg.to_json())["metrics"]
    return {m["name"]: m for m in doc
            if not m["name"].startswith(("moby_jit_", "moby_autotune_"))}


@pytest.mark.parametrize("run", RUNS)
def test_metric_families_match_jax(run, request):
    want, got = request.getfixturevalue(run)
    w, g = _families(want.metrics_registry()), \
        _families(got.metrics_registry())
    assert sorted(g) == sorted(w)
    for name, wm in w.items():
        gm = g[name]
        assert (gm["type"], gm["labels"], gm["help"]) == \
            (wm["type"], wm["labels"], wm["help"]), name
        assert [s["labels"] for s in gm["samples"]] == \
            [s["labels"] for s in wm["samples"]], name
        if name == "moby_host_span_seconds":
            # Wall time: the spans' names and counts only.
            assert [s["count"] for s in gm["samples"]] == \
                [s["count"] for s in wm["samples"]]
            continue
        for gs, ws in zip(gm["samples"], wm["samples"]):
            if wm["type"] == "histogram":
                assert gs["bucket_counts"] == ws["bucket_counts"], name
                assert gs["count"] == ws["count"], name
                _close(gs["sum"], ws["sum"], name)
            else:
                _close(gs["value"], ws["value"], f"{name} {ws['labels']}")
    assert got.to_prometheus().startswith("# HELP ")


def _events(doc, pids):
    return [e for e in doc["traceEvents"] if e["ph"] == "X"
            and e["pid"] in pids]


@pytest.mark.parametrize("run", RUNS)
def test_trace_matches_jax(run, request):
    want, got = request.getfixturevalue(run)
    w_doc, g_doc = want.to_trace(), got.to_trace()
    assert [e for e in g_doc["traceEvents"] if e["ph"] == "M"] == \
        [e for e in w_doc["traceEvents"] if e["ph"] == "M"]
    w_ev, g_ev = _events(w_doc, MODELLED_PIDS), _events(g_doc, MODELLED_PIDS)
    assert len(g_ev) == len(w_ev) > 0
    for g, w in zip(g_ev, w_ev):
        assert (g["name"], g["pid"], g["tid"]) == \
            (w["name"], w["pid"], w["tid"])
        # Microseconds: the golden tolerance's 1e-5 s is 10 us.
        np.testing.assert_allclose([g["ts"], g["dur"]], [w["ts"], w["dur"]],
                                   rtol=RTOL, atol=ATOL * 1e6,
                                   err_msg=str(w))
        assert g.get("args", {}).keys() == w.get("args", {}).keys()
        for k, v in w.get("args", {}).items():
            if isinstance(v, str):
                assert g["args"][k] == v
            else:
                _close(g["args"][k], v, f"{k} {w}")
    host = (trace.PID_HOST,)
    assert [e["name"] for e in _events(g_doc, host)] == \
        [e["name"] for e in _events(w_doc, host)]
    if run in ("fleet",):
        assert any(e["pid"] == trace.PID_CLOUD for e in g_ev)


# ---------------------------------------------------------------------------
# Off is free, and the hooks' contracts
# ---------------------------------------------------------------------------


def _same(a, b):
    for col in ("kind", "latency_s", "onboard_s", "f1"):
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col))


@pytest.mark.parametrize("run", RUNS)
def test_observed_run_equals_unobserved(run, request):
    _, got = request.getfixturevalue(run)
    name, frames, kw, scan = {
        "smoke": ("smoke", 8, {}, False),
        "baseline": ("smoke", 6, dict(mode="cloud_only"), False),
        "fleet": ("fleet-16-congested", 3, {}, False),
        "scan": ("fleet-16-congested", 3, {}, True)}[run]
    off = api.Session(api.scenario(name, seed=0, **kw),
                      torch_device="cpu").run(frames, scan=scan)
    assert off.obs is None and got.obs is not None
    _same(got, off)
    assert got.to_csv() == off.to_csv()


def test_all_off_config_attaches_nothing():
    rep = api.Session(api.scenario("smoke", seed=0), torch_device="cpu",
                      obs=obs.ObsConfig()).run(2)
    assert rep.obs is None
    assert obs.make_observer(None) is None
    assert obs.make_observer(obs.ObsConfig()) is None
    with pytest.raises(ValueError, match="no audit log"):
        rep.to_audit()


def test_scan_mode_refuses_audit():
    s = api.Session(api.scenario("smoke", seed=0), torch_device="cpu",
                    obs=obs.ObsConfig(audit=True))
    with pytest.raises(ValueError, match="scan"):
        s.run(2, scan=True)


def test_export_artifacts_expands_placeholders(tmp_path):
    base = pathlib.Path(tmp_path)
    cfg = obs.ObsConfig(
        trace_path=str(base / "t" / "{scenario}-{policy}-{n}.json"),
        metrics_path=str(base / "m" / "{scenario}-{n}.prom"),
        audit_path=str(base / "a" / "{policy}-{n}.csv"),
        registry=obs.MetricsRegistry())
    n = observe._RUN_COUNTER
    rep = api.Session(api.scenario("smoke", seed=0), torch_device="cpu",
                      obs=cfg).run(3)
    t = base / "t" / f"smoke-fos-{n}.json"
    assert json.loads(t.read_text())["traceEvents"]
    assert (base / "m" / f"smoke-{n}.prom").read_text() == \
        rep.to_prometheus()
    assert (base / "a" / f"fos-{n}.csv").read_text().splitlines()[0] == \
        ",".join(audit.AUDIT_FIELDS)
    assert observe._RUN_COUNTER == n + 1
    assert obs.export_artifacts(rep, None) == {}


def test_compile_count_marks_a_span_compiled():
    """A build or a graph capture inside a span (here a stub count, as the
    CPU neither builds nor captures) marks it and feeds the jit families."""
    reg = obs.MetricsRegistry()
    o = observe.Observer(obs.ObsConfig(metrics=True, registry=reg))
    count = [0]
    with o.measured_span("fleet/scan_dispatch", lambda: count[0],
                         n_frames=3):
        count[0] += 2
    with o.measured_span("fleet/scan_fetch", lambda: count[0]):
        pass
    with o.measured_span("moby/frame_stats_fetch", frame=0):
        count[0] += 1
    first, second, third = o.measured
    assert first["compiled"] and first["n_frames"] == 3
    assert "compiled" not in second and "compiled" not in third
    assert o.retraces == {"fleet/scan_dispatch": 2}
    rep = _fake_report(common, 0)
    o.finalize(rep)
    o.flush_metrics(rep)
    assert reg.get("moby_jit_retraces_total").value(
        step="fleet/scan_dispatch") == 2
    assert reg.get("moby_jit_compile_wall_seconds").value(
        step="fleet/scan_dispatch") == first["dur"]
    assert reg.get("moby_host_span_seconds").count(
        span="fleet/scan_fetch") == 1

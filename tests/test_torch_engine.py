"""The port's serving path end to end against the JAX package.

* ``repro_torch.api.Session(scenario("smoke", seed=0), torch_device="cpu")
  .run(16)`` equals a live JAX run and ``tests/goldens/smoke.csv``: ``kind``
  exact, floats within rtol 1e-4, atol 1e-5;
* so do ``kitti-urban`` (seeds 0 and 4, the latter on ``jetson_orin``)
  and ``lossy-uplink``, the KITTI-density presets;
* the baselines and ``moby_onboard`` equal the JAX engine, and so does a
  tape-driven engine;
* the preset table equals ``repro``'s field by field;
* the fleet's scan mode (``run(scan=True)``, ``run_scan``) runs, a
  baseline mode's scan raises, and a fleet preset's baselines run one
  stream (tests/test_torch_fleet.py and tests/test_torch_scan.py hold the
  fleet itself);
* every copied numpy data-plane module gives the original's output;
* importing and running the port pulls in neither jax nor ``repro``.
"""
import ast
import csv
import dataclasses
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.data import scenes as jscenes  # noqa: E402
from repro.fleet import cloud as jcloud  # noqa: E402
from repro.runtime import netsim as jnetsim  # noqa: E402
from repro.runtime import profiles as jprofiles  # noqa: E402
from repro.serving import common as jcommon  # noqa: E402
from repro.serving import engine as jengine  # noqa: E402
from repro.serving import tape as jtape  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.data import scenes  # noqa: E402
from repro_torch.fleet import cloud  # noqa: E402
from repro_torch.runtime import netsim, profiles  # noqa: E402
from repro_torch.serving import common, engine, tape  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "smoke.csv"
EXACT = ("stream", "frame", "kind", "scenario", "policy", "device")
FLOATS = ("latency_s", "onboard_s", "f1", "precision", "recall")


def _rows(text):
    return list(csv.DictReader(io.StringIO(text)))


def _assert_reports_match(got_csv, want_csv):
    got, want = _rows(got_csv), _rows(want_csv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        where = f"frame {w['frame']}"
        for k in EXACT:
            assert g[k] == w[k], f"{where}: {k} {g[k]!r} != {w[k]!r}"
        for k in FLOATS:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{where}: {k}")


@pytest.fixture(scope="module")
def jax_smoke_csv():
    """One live JAX smoke run, shared by the tests below."""
    return japi.Session(japi.scenario("smoke", seed=0, backend="ref")) \
        .run(16).to_csv()


@pytest.fixture(scope="module")
def port_smoke_csv():
    return api.Session(api.scenario("smoke", seed=0),
                       torch_device="cpu").run(16).to_csv()


def test_smoke_matches_live_jax_run(port_smoke_csv, jax_smoke_csv):
    _assert_reports_match(port_smoke_csv, jax_smoke_csv)


def test_smoke_matches_golden(port_smoke_csv):
    _assert_reports_match(port_smoke_csv, GOLDEN.read_text())
    kinds = {r["kind"] for r in _rows(port_smoke_csv)}
    assert {"anchor", "test", "transform"} <= kinds


@pytest.mark.parametrize("seed,policy", [(1, "fos"), (2, "fos"), (3, "fos"),
                                         (4, "adaptive")])
def test_smoke_seeds_match_jax(seed, policy):
    """More streams of the same preset: rare exact ties (association,
    degenerate RANSAC triplets) decide frame kinds, so parity is checked
    beyond the golden's seed."""
    want = japi.Session(japi.scenario("smoke", seed=seed, policy=policy,
                                      backend="ref")).run(16).to_csv()
    got = api.Session(api.scenario("smoke", seed=seed, policy=policy),
                      torch_device="cpu").run(16).to_csv()
    _assert_reports_match(got, want)


@pytest.mark.parametrize("name,seed,frames,overrides", [
    ("kitti-urban", 0, 12, {}),
    ("lossy-uplink", 2, 16, {}),
    ("kitti-urban", 4, 12, {"device": "jetson_orin"})])
def test_kitti_presets_match_jax(name, seed, frames, overrides):
    """Beyond ``smoke``: the KITTI-density presets (8,192 points, up to
    12 objects a frame), the lossy ``fcc1`` uplink and a non-default edge
    device, each a live JAX run against the port's."""
    want = japi.Session(japi.scenario(name, seed=seed, backend="ref",
                                      **overrides)).run(frames).to_csv()
    got = api.Session(api.scenario(name, seed=seed, **overrides),
                      torch_device="cpu").run(frames).to_csv()
    _assert_reports_match(got, want)
    assert {r["device"] for r in _rows(got)} == {
        overrides.get("device", "jetson_tx2")}


@pytest.mark.parametrize("mode,frames", [("edge_only", 6), ("cloud_only", 6),
                                         ("moby_onboard", 12)])
def test_modes_match_jax_engine(mode, frames):
    want = japi.Session(japi.scenario("smoke", seed=1, mode=mode,
                                      backend="ref")).run(frames).to_csv()
    got = api.Session(api.scenario("smoke", seed=1, mode=mode),
                      torch_device="cpu").run(frames).to_csv()
    _assert_reports_match(got, want)


def test_tape_driven_engine_matches_jax():
    scn = japi.scenario("smoke", seed=2)
    t = jtape.record_stream_tape(scn.scene, scn.detector, 10, seed=2)
    want = jengine.MobyEngine(scn.scene, scn.detector, seed=2, tape=t,
                              backend="ref").run(10)
    got = engine.MobyEngine(scn.scene, scn.detector, seed=2,
                            tape=tape.FrameTape(*t),
                            torch_device="cpu").run(10)
    _assert_reports_match(got.to_csv(), want.to_csv())
    with pytest.raises(ValueError, match="tape holds"):
        engine.MobyEngine(scn.scene, scn.detector, tape=tape.FrameTape(*t),
                          torch_device="cpu").run(11)


def _plain(x):
    """Dataclasses, NamedTuples and dicts of them as plain values, so the
    two packages' classes of the same name compare by value."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def test_preset_table_equals_jax():
    assert api.list_scenarios() == japi.list_scenarios()
    port_fields = {f.name for f in dataclasses.fields(api.Scenario)}
    jax_fields = {f.name for f in dataclasses.fields(japi.Scenario)}
    # The ops backend and the device mesh have no field in the port.
    assert port_fields == jax_fields - {"backend", "mesh"}
    for name in api.list_scenarios():
        got, want = api.scenario(name, seed=3), japi.scenario(name, seed=3)
        for f in sorted(port_fields):
            assert _plain(getattr(got, f)) == _plain(getattr(want, f)), \
                (name, f)
        assert got.stream_devices() == want.stream_devices()
        assert got.scheduler_params() == tuple(want.scheduler_params())
    with pytest.raises(KeyError, match="unknown scenario override"):
        api.scenario("smoke", nope=1)
    with pytest.raises(KeyError, match="registered scenarios"):
        api.scenario("nope")
    assert api.scenario("smoke", n_points=99).scene.n_points == 99


def test_scan_raises_until_ported():
    """Scan mode is ported (tests/test_torch_scan.py holds it to JAX): a
    single stream scans through a lazily built S=1 fleet slice, a fleet
    through its own engine; only a baseline mode, which has no fleet,
    raises (``ValueError``, as in the JAX package)."""
    one = api.Session(api.scenario("smoke"), torch_device="cpu")
    report = one.run(2, scan=True)
    assert report.kind.shape == (1, 2) and report.scenario == "smoke"
    assert one._scan_engine.n_streams == 1
    fleet = api.Session(api.scenario("fleet-16-congested"),
                        torch_device="cpu")
    assert fleet.n_streams == 16
    assert fleet._scan_engine is fleet.engine
    assert fleet.engine.run_scan(1).kind.shape == (16, 1)
    s = api.Session(api.scenario("fleet-16-congested", mode="edge_only"),
                    torch_device="cpu")
    assert s.n_streams == 1
    with pytest.raises(ValueError, match="moby modes"):
        s.run(2, scan=True)


# ---------------------------------------------------------------------------
# The copied numpy data plane
# ---------------------------------------------------------------------------


def test_scenes_copy_is_identical():
    cfg = jscenes.SceneConfig(max_obj=6, n_points=1024, img_h=48, img_w=160,
                              mean_objects=3, density_scale=4000.0)
    tcfg = scenes.SceneConfig(**dataclasses.asdict(cfg))
    for a, b in zip(jscenes.make_calibration(cfg),
                    scenes.make_calibration(tcfg)):
        np.testing.assert_array_equal(a, b)
    js, ts = jscenes.SceneStream(cfg, seed=4), scenes.SceneStream(tcfg, seed=4)
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for fj, ft in zip(js.frames(5), ts.frames(5)):
        for f in dataclasses.fields(fj):
            np.testing.assert_array_equal(getattr(fj, f.name),
                                          getattr(ft, f.name))
        noise = jscenes.DETECTOR_PROFILES["pointpillar"]
        for a, b in zip(jscenes.oracle_detect_3d(fj, rj, noise),
                        scenes.oracle_detect_3d(ft, rt, noise)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jscenes.oracle_detect_2d(fj, rj),
                        scenes.oracle_detect_2d(ft, rt)):
            np.testing.assert_array_equal(a, b)
    assert _plain(jscenes.DETECTOR_PROFILES) == \
        _plain(scenes.DETECTOR_PROFILES)


def test_tape_copy_is_identical():
    cfg = scenes.SceneConfig(max_obj=4, n_points=512, img_h=32, img_w=104)
    a = jtape.record_stream_tape(jscenes.SceneConfig(
        **dataclasses.asdict(cfg)), "pointpillar", 4, seed=5)
    b = tape.record_stream_tape(cfg, "pointpillar", 4, seed=5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    st = tape.stack_tapes(tape.record_fleet_tapes(cfg, "oracle", 2, 2))
    assert st.points.shape[:2] == (2, 2)


def test_netsim_and_cloud_copies_are_identical():
    for trace in ("belgium2", "fcc1"):
        a, b = jnetsim.NetworkSim(trace, seed=3), netsim.NetworkSim(trace,
                                                                    seed=3)
        for n in (1000, 870000, 64 * 7 * 4):
            assert a.transfer_time(n) == b.transfer_time(n)
            assert a.current_bw_mbps() == b.current_bw_mbps()
            assert a.transfer_breakdown(n, 0.5) == b.transfer_breakdown(n,
                                                                        0.5)
            a.advance(0.37)
            b.advance(0.37)
        np.testing.assert_array_equal(jnetsim.synthesize_trace(trace, 30.0),
                                      netsim.synthesize_trace(trace, 30.0))
    cfg = dict(infer_s=0.05, n_gpus=3, window_s=0.02, max_batch=4)
    ja = jcloud.CloudBatcher(jcloud.CloudBatcherConfig(**cfg))
    ta = cloud.CloudBatcher(cloud.CloudBatcherConfig(**cfg))
    rng = np.random.default_rng(0)
    for _ in range(5):
        arrive = list(rng.uniform(0, 0.2, 9))
        assert ja.submit_batch(arrive) == ta.submit_batch(arrive)
    assert ja.busy_s == ta.busy_s


def test_profiles_and_common_copies_are_identical():
    assert jprofiles.list_profiles() == profiles.list_profiles()
    for name in jprofiles.list_profiles():
        jp, tp = jprofiles.get_profile(name), profiles.get_profile(name)
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        assert dataclasses.asdict(jprofiles.component_times(jp)) == \
            dataclasses.asdict(profiles.component_times(tp))
        for det in jprofiles.DETECTOR_GFLOPS:
            assert profiles.detector_latency(det, tp) == \
                jprofiles.detector_latency(det, jp)
    assert profiles.DETECTOR_GFLOPS == jprofiles.DETECTOR_GFLOPS
    assert profiles.DETECTOR_EFFICIENCY == jprofiles.DETECTOR_EFFICIENCY
    mix = {"jetson_tx2": 0.75, "jetson_orin": 0.25}
    assert jprofiles.resolve_stream_devices(mix, 8) == \
        profiles.resolve_stream_devices(mix, 8)
    comp = jprofiles.component_times("jetson_tx2")
    tcomp = profiles.component_times("jetson_tx2")
    for na, nn, tba, fos in ((3, 1, True, True), (0, 0, False, True),
                             (2, 5, True, False)):
        assert jcommon.onboard_transform_time(comp, na, nn, tba, fos) == \
            common.onboard_transform_time(tcomp, na, nn, tba, fos)
    for onboard in (False, True):
        assert jcommon.modeled_frame_costs(
            comp, "pointpillar", 7.5, 0.03, True, True,
            onboard_anchors=onboard) == common.modeled_frame_costs(
            tcomp, "pointpillar", 7.5, 0.03, True, True,
            onboard_anchors=onboard)
    recs = [(t, k, 0.1 * t, 0.05, 0.5, 0.75, 0.25) for t, k in
            enumerate(("anchor", "transform", "test", "transform"))]
    a = jcommon.RunReport.from_records([jcommon.FrameRecord(*r) for r in recs],
                                       scenario="s", policy="p",
                                       device="jetson_tx2")
    b = common.RunReport.from_records([common.FrameRecord(*r) for r in recs],
                                      scenario="s", policy="p",
                                      device="jetson_tx2")
    assert a.to_csv() == b.to_csv()
    assert a.summary() == b.summary()
    assert [dataclasses.astuple(r) for r in a.records] == \
        [dataclasses.astuple(r) for r in b.records]


# ---------------------------------------------------------------------------
# Import hygiene
# ---------------------------------------------------------------------------


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_run_leaves_jax_and_repro_unimported():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'src')\n"
        "import repro_torch\n"
        "from repro_torch import api\n"
        "rep = api.Session(api.scenario('smoke', seed=0),"
        " torch_device='cpu').run(3)\n"
        "assert rep.n_frames == 3\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr

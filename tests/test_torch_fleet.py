"""The port's fleet (orchestrated mode) against the JAX package.

The JAX fleet is ``jax.vmap`` of the per-stream step; the port writes the
stream axis out. Compared here, on the same seeded inputs:

* the batched generator (``prng.split`` / ``randint`` on (S, 2) keys)
  against ``jax.vmap`` of ``jax.random``: exact;
* the stream-axis plain versions of K1's labels instance and K2 against
  ``jax.vmap`` of the JAX ops (``ref`` and the Pallas kernel in interpret
  mode): exact;
* the batched association against ``jax.vmap`` of JAX's and against the
  port's per-stream calls: exact;
* the batched scheduler against per-stream calls, for every built-in
  policy;
* ``make_fleet_step`` against JAX's, call by call (each state leaf, the
  packed stats), with a mixed anchor/transform call among them;
* ``FleetEngine`` at S=1 against the port's ``MobyEngine`` on one tape;
* the fleet presets (and a 4-stream ``smoke`` whose streams re-anchor
  after a failed test) against live JAX runs: ``kind``, ``stream``,
  ``frame`` and ``device`` exact, floats within rtol 1e-4, atol 1e-5.
"""
import csv
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import association as jassoc  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import transform as jtransform  # noqa: E402
from repro.data import scenes as jscenes  # noqa: E402
from repro.fleet import step as jstep  # noqa: E402
from repro.kernels.iou2d import ops as jiou_ops  # noqa: E402
from repro.kernels.iou2d import ref as jiou_ref  # noqa: E402
from repro.serving import tape as jtape  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import association, prng, projection  # noqa: E402
from repro_torch.core import scheduler, transform  # noqa: E402
from repro_torch.data import scenes  # noqa: E402
from repro_torch.fleet import FleetEngine  # noqa: E402
from repro_torch.fleet import step as step_lib  # noqa: E402
from repro_torch.kernels.iou2d import ops as iou_ops  # noqa: E402
from repro_torch.kernels.point_proj import ops as pp_ops  # noqa: E402
from repro_torch.serving import engine, tape  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-4, 1e-5
EXACT = ("stream", "frame", "kind", "scenario", "policy", "device")
FLOATS = ("latency_s", "onboard_s", "f1", "precision", "recall")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _jkeys(seeds):
    return jax.vmap(jax.random.key)(jnp.asarray(seeds, jnp.int32))


def _tkeys(seeds):
    return torch.stack([prng.key(s) for s in seeds])


# ---------------------------------------------------------------------------
# The generator on a batch of keys
# ---------------------------------------------------------------------------


SEEDS = [0, 1, 7, 12345, -3, 2 ** 31 - 1]


@pytest.mark.parametrize("num", [2, 5])
def test_batched_split_matches_vmap(num):
    want = jax.random.key_data(
        jax.vmap(lambda k: jax.random.split(k, num))(_jkeys(SEEDS)))
    got = prng.split(_tkeys(SEEDS), num)
    assert got.shape == (len(SEEDS), num, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


def test_batched_randint_and_bits_match_vmap():
    """Per-key bounds as RANSAC passes them; (S, O, 2) keys as the fleet
    splits them (a key an object of each stream)."""
    maxval = np.array([1, 2, 3, 17, 255, 256], np.int32)
    want = jax.vmap(lambda k, m: jax.random.randint(k, (7, 3), 0, m))(
        _jkeys(SEEDS), jnp.asarray(maxval))
    got = prng.randint(_tkeys(SEEDS), (7, 3), 0, _t(maxval))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    per_obj = jax.vmap(lambda k: jax.random.split(k, 4))(_jkeys(SEEDS))
    want = jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (3, 5))))(per_obj)
    got = prng.random_bits(prng.split(_tkeys(SEEDS), 4), (3, 5))
    assert got.shape == (len(SEEDS), 4, 3, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int64))


# ---------------------------------------------------------------------------
# K1's labels instance and K2 with a stream axis
# ---------------------------------------------------------------------------


def _fleet_frame(s_n, n_points, h, w, seed):
    """One frame of ``s_n`` rendered streams (points, label images) and
    their shared calibration."""
    cfg = jscenes.SceneConfig(max_obj=8, n_points=n_points, img_h=h,
                              img_w=w, mean_objects=4, seed=seed)
    fleet = jscenes.MultiStreamScenes(cfg, s_n, seed=seed)
    frames = [next(s.frames(1)) for s in fleet.streams]
    tr, p = jscenes.make_calibration(cfg)
    pts = np.stack([f.points for f in frames]).astype(np.float32)
    lab = np.stack([f.label_img for f in frames]).astype(np.int32)
    return pts, lab, tr, p, cfg


@pytest.mark.parametrize("s_n,n_points,h,w", [(1, 1024, 48, 160),
                                              (3, 1001, 48, 160),
                                              (16, 2048, 64, 208)])
def test_labels_instance_stream_axis_matches_vmap(s_n, n_points, h, w):
    pts, lab, tr, p, cfg = _fleet_frame(s_n, n_points, h, w, s_n)
    jcal = jproj.Calibration(tr=jnp.asarray(tr), p=jnp.asarray(p), height=h,
                             width=w)
    got = pp_ops.project_and_label(_t(pts), _t(tr), _t(p), _t(lab))
    assert got.shape == (s_n, n_points) and got.dtype == torch.int32
    for backend in ("ref", "pallas"):
        want = jax.vmap(functools.partial(
            jproj.project_and_label, calib=jcal, backend=backend))(
            jnp.asarray(pts), jnp.asarray(lab))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=backend)
    assert got.numpy().any()
    # Stream by stream, the 2-D call gives the same labels.
    for s in range(s_n):
        np.testing.assert_array_equal(
            pp_ops.project_and_label(_t(pts[s]), _t(tr), _t(p),
                                     _t(lab[s])).numpy(), got[s].numpy())


def _boxes(rng, *shape):
    xy = rng.uniform(0, 100, (*shape, 2))
    wh = rng.uniform(1, 30, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("s_n,n,m", [(1, 24, 12), (3, 7, 13), (16, 16, 8),
                                     (64, 12, 6)])
def test_iou2d_stream_axis_matches_vmap(s_n, n, m):
    rng = np.random.default_rng(s_n * 131 + n)
    a, b = _boxes(rng, s_n, n), _boxes(rng, s_n, m)
    got = iou_ops.iou2d(_t(a), _t(b))
    assert got.shape == (s_n, n, m)
    want_ref = jax.vmap(jiou_ref.iou2d_ref)(jnp.asarray(a), jnp.asarray(b))
    want_pallas = jax.vmap(functools.partial(jiou_ops.iou2d, interpret=True))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    for s in range(s_n):
        np.testing.assert_array_equal(
            iou_ops.iou2d(_t(a[s]), _t(b[s])).numpy(), got[s].numpy())


# ---------------------------------------------------------------------------
# Association and the scheduler over streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_n,d", [(1, 6), (5, 6), (16, 8)])
def test_batched_associate_matches_vmap_and_per_stream(s_n, d):
    """Tracks near the detections (so the auctions take rounds and tie),
    a random share of both masked out."""
    rng = np.random.default_rng(s_n * 7 + d)
    det = _boxes(rng, s_n, d)
    trk = np.concatenate([det + rng.normal(0, 3, det.shape),
                          _boxes(rng, s_n, d)], 1).astype(np.float32)
    trk_v = rng.uniform(size=(s_n, 2 * d)) < 0.7
    det_v = rng.uniform(size=(s_n, d)) < 0.8
    want = jax.vmap(functools.partial(jassoc.associate, backend="ref"))(
        *(jnp.asarray(x) for x in (trk, trk_v, det, det_v)))
    got = association.associate(*(_t(x) for x in (trk, trk_v, det, det_v)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1] >= 0).any()
    for s in range(s_n):
        one = association.associate(_t(trk[s]), _t(trk_v[s]), _t(det[s]),
                                    _t(det_v[s]))
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[s].numpy(), o.numpy())


@pytest.mark.parametrize("policy", ["fos", "periodic(3)", "always_anchor",
                                    "never_anchor", "adaptive"])
def test_batched_scheduler_equals_per_stream(policy):
    """Advancing S schedulers in one call equals stepping each stream's
    state machine on its own (tests/test_fleet.py does it for vmap)."""
    s_n, d = 5, 4
    rng = np.random.default_rng(0)
    sp = scheduler.SchedulerParams(n_t=3, q_t=0.6, policy=policy)
    batched = scheduler.init_scheduler_fleet(s_n, d)
    singles = [scheduler.init_scheduler(d) for _ in range(s_n)]
    for step in range(10):
        boxes = _t(rng.normal(size=(s_n, d, 7)).astype(np.float32))
        valid = _t(rng.uniform(size=(s_n, d)) < 0.7)
        arrived = _t(rng.uniform(size=(s_n,)) < 0.5)
        tboxes = _t(rng.normal(size=(s_n, d, 7)).astype(np.float32))
        tvalid = _t(rng.uniform(size=(s_n, d)) < 0.7)
        bw = rng.uniform(1, 20)
        edge = rng.uniform(0.05, 0.2, s_n)
        off = rng.uniform(0.1, 2.0, s_n)
        batched = scheduler.observe_telemetry(batched, bw_mbps=bw,
                                              edge_cost_s=edge,
                                              offload_cost_s=off)
        acts = scheduler.scheduler_pre(batched, sp)
        batched = scheduler.scheduler_post(batched, acts, boxes, valid,
                                           arrived, tboxes, tvalid, sp)
        for i in range(s_n):
            st = scheduler.observe_telemetry(singles[i], bw_mbps=bw,
                                             edge_cost_s=float(edge[i]),
                                             offload_cost_s=float(off[i]))
            a1 = scheduler.scheduler_pre(st, sp)
            assert bool(acts.run_as_anchor[i]) == bool(a1.run_as_anchor)
            assert bool(acts.send_test[i]) == bool(a1.send_test)
            singles[i] = scheduler.scheduler_post(
                st, a1, boxes[i], valid[i], arrived[i], tboxes[i],
                tvalid[i], sp)
            for name in scheduler.SchedulerState._fields:
                assert torch.equal(getattr(batched, name)[i],
                                   getattr(singles[i], name)), \
                    f"{policy}: {name} @ step {step}"


# ---------------------------------------------------------------------------
# One fleet step, call by call
# ---------------------------------------------------------------------------


def _leaves(state):
    """A fleet state as named numpy leaves (JAX's typed keys as words)."""
    def walk(x, path):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for k, v in zip(x._fields, x):
                yield from walk(v, f"{path}.{k}" if path else k)
        else:
            if isinstance(x, jax.Array) and jnp.issubdtype(
                    x.dtype, jax.dtypes.prng_key):
                x = jax.random.key_data(x)
            yield path, np.asarray(x)
    return dict(walk(state, ""))


def _assert_leaves_match(got, want, what):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (what, name)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{what}: {name}")


def test_fleet_step_matches_jax_call_by_call():
    """Four calls over a recorded 4-stream tape: all anchors, all
    transforms, a mixed call (streams 1 and 3 forced to anchor) with a
    test in flight, and a call where tests arrive on streams 1 and 3."""
    scn = japi.scenario("smoke", n_streams=4, seed=2)
    cfg, s_n = scn.scene, 4
    tapes = jtape.record_fleet_tapes(cfg, scn.detector, 4, s_n, seed=2)
    stack = jtape.stack_tapes(tapes)
    tr, p = jscenes.make_calibration(cfg)
    jcal = jproj.Calibration(tr=jnp.asarray(tr), p=jnp.asarray(p),
                             height=cfg.img_h, width=cfg.img_w)
    tcal = projection.Calibration(_t(tr), _t(p), cfg.img_h, cfg.img_w)
    jsp = jsched.SchedulerParams(n_t=2, q_t=0.9)
    tsp = scheduler.SchedulerParams(n_t=2, q_t=0.9)
    jfn = jstep.make_fleet_step(jcal, jtransform.TransformParams(
        backend="ref"), jsp)
    tfn = step_lib.make_fleet_step(tcal, transform.TransformParams(), tsp)
    jstate = jstep.init_fleet_state(s_n, cfg.max_obj, key_base=3)
    tstate = step_lib.init_fleet_state(s_n, cfg.max_obj, key_base=3)
    _assert_leaves_match(tstate, jstate, "init")
    arrivals = ([False] * 4, [False] * 4, [False] * 4,
                [False, True, False, True])
    kinds = []
    for t in range(4):
        if t == 2:
            force = np.array([False, True, False, True])
            jstate = jstate._replace(sched=jstate.sched._replace(
                anchor_pending=jstate.sched.anchor_pending
                | jnp.asarray(force)))
            tstate = tstate._replace(sched=tstate.sched._replace(
                anchor_pending=tstate.sched.anchor_pending | _t(force)))
        f = jtape.FrameTape(*(a[:, t] for a in stack))
        jinp = jstep.FrameInputs(*(jnp.asarray(x) for x in f))
        tinp = step_lib.FrameInputs(*(_t(x) for x in f))
        arrived = np.array(arrivals[t])
        jstate, jpk = jfn(jstate, jinp, jnp.asarray(arrived), jnp.int32(t))
        tstate, tpk = tfn(tstate, tinp, _t(arrived), t)
        np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), rtol=RTOL,
                                   atol=ATOL, err_msg=f"packed @ {t}")
        _assert_leaves_match(tstate, jstate, f"state after call {t}")
        kinds.append(tuple(np.asarray(jpk)[:, 0] > 0.5))
    # The calls took both branches, and one call took both at once.
    assert kinds[0] == (True,) * 4 and kinds[1] == (False,) * 4
    assert kinds[2] == (False, True, False, True)
    assert np.asarray(jstate.sched.tests_sent).any()


# ---------------------------------------------------------------------------
# Engines end to end
# ---------------------------------------------------------------------------


def _rows(text):
    return list(csv.DictReader(io.StringIO(text)))


def _assert_reports_match(got_csv, want_csv):
    got, want = _rows(got_csv), _rows(want_csv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        where = f"stream {w['stream']} frame {w['frame']}"
        for k in EXACT:
            assert g[k] == w[k], f"{where}: {k} {g[k]!r} != {w[k]!r}"
        for k in FLOATS:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{where}: {k}")


def test_fleet_s1_matches_moby_engine():
    """Same tape through both of the port's engines: identical kinds,
    accuracy and (uncontended) timing."""
    cfg = scenes.SceneConfig(max_obj=6, n_points=1024, img_h=48, img_w=160,
                             mean_objects=3, density_scale=4000.0, seed=5)
    t = tape.record_stream_tape(cfg, "pointpillar", 16, seed=5)
    moby = engine.MobyEngine(cfg, "pointpillar", seed=5, tape=t,
                             torch_device="cpu").run(16)
    fleet = FleetEngine(cfg, "pointpillar", n_streams=1, seed=5, tapes=[t],
                        torch_device="cpu").run(16)
    assert fleet.kinds(0) == [r.kind for r in moby.records]
    assert {"anchor", "test", "transform"} <= set(fleet.kinds(0))
    for name in ("f1", "precision", "recall", "onboard_s", "latency_s"):
        np.testing.assert_allclose(getattr(fleet, name)[0],
                                   getattr(moby, name)[0], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name,frames,overrides", [
    ("fleet-16-congested", 8, {}),
    ("fleet-64-mixed", 6, {}),
    ("smoke", 16, {"n_streams": 4, "sparams": (2, 0.999)})],
    ids=["fleet-16-congested", "fleet-64-mixed", "smoke-4-reanchor"])
def test_fleet_presets_match_jax(name, frames, overrides):
    """Live JAX runs (``backend="ref"``; the goldens of the first two
    drift from today's JAX engine, ROADMAP R1). In the ``smoke`` case
    every stream fails its test and re-anchors at frame 14."""
    jkw, tkw = dict(overrides), dict(overrides)
    if "sparams" in overrides:
        n_t, q_t = overrides["sparams"]
        jkw["sparams"] = jsched.SchedulerParams(n_t=n_t, q_t=q_t)
        tkw["sparams"] = scheduler.SchedulerParams(n_t=n_t, q_t=q_t)
    want = japi.Session(japi.scenario(name, backend="ref", **jkw)) \
        .run(frames).to_csv()
    session = api.Session(api.scenario(name, **tkw), torch_device="cpu")
    assert isinstance(session.engine, FleetEngine)
    assert session.n_streams == api.scenario(name, **tkw).n_streams
    got = session.run(frames).to_csv()
    _assert_reports_match(got, want)
    rows = _rows(got)
    assert {r["kind"] for r in rows} >= {"anchor", "transform"}
    if name == "smoke":
        assert all(r["kind"] == "anchor" for r in rows
                   if r["frame"] == "14")


def test_fleet_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cfg = scenes.SceneConfig(max_obj=4, n_points=256, img_h=32, img_w=104)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetEngine(cfg, "pointpillar", n_streams=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Session(api.scenario("fleet-16-congested"))
    # Scan mode runs on the CPU only when asked for (ROADMAP item 8, done).
    report = FleetEngine(cfg, "pointpillar", n_streams=2,
                         torch_device="cpu").run_scan(2)
    assert report.kind.shape == (2, 2)

"""``repro_torch.core`` against ``repro.core``, function by function.

The same numpy inputs (from a seed) go through the JAX function (``ref``
backend) and its port on the CPU. Integer and bool outputs must be equal;
floats agree within rtol 1e-5, atol 1e-5 unless a test states why not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import association as jassoc  # noqa: E402
from repro.core import box_estimation as jbox  # noqa: E402
from repro.core import boxes as jboxes  # noqa: E402
from repro.core import filtration as jfilt  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro.core import ransac as jransac  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import tracking as jtrack  # noqa: E402
from repro.data import scenes  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import association, box_estimation, boxes  # noqa: E402
from repro_torch.core import filtration, metrics, prng, projection  # noqa: E402
from repro_torch.core import ransac, scheduler, tracking  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return convert.to_tensor(np.asarray(a))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_boxes(rng, n, spread=20.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(2.0, 6.0, (n, 1)), rng.uniform(1.2, 2.5, (n, 1)),
        rng.uniform(1.2, 2.0, (n, 1)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def clusters():
    """Per-object clusters from a rendered kitti-like frame (the transform
    path's real inputs), plus keep masks from the JAX filtration."""
    cfg = scenes.SceneConfig(max_obj=8, n_points=4096, mean_objects=5,
                             density_scale=15000.0, seed=0)
    stream = scenes.SceneStream(cfg, seed=3)
    frame = next(stream.frames(1))
    labels = frame.point_labels
    pts, valid, _ = jproj.build_clusters(jnp.asarray(frame.points),
                                         jnp.asarray(labels), cfg.max_obj, 256)
    keep = jfilt.filter_clusters(pts, valid)
    return np.asarray(pts), np.asarray(valid), np.asarray(keep)


# ---------------------------------------------------------------------------
# core/boxes.py
# ---------------------------------------------------------------------------


def test_boxes_geometry():
    rng = np.random.default_rng(0)
    b = _random_boxes(rng, 9)
    np.testing.assert_allclose(_np(boxes.corners_bev(_t(b))),
                               np.asarray(jboxes.corners_bev(b)), **TOL)
    np.testing.assert_allclose(_np(boxes.corners_3d(_t(b))),
                               np.asarray(jboxes.corners_3d(b)), **TOL)
    np.testing.assert_allclose(_np(boxes.heading_vector(_t(b[:, 6]))),
                               np.asarray(jboxes.heading_vector(b[:, 6])),
                               **TOL)
    tr, p = scenes.make_calibration(scenes.SceneConfig())
    b[:, 0] = np.abs(b[:, 0]) + 6.0        # in front of the camera
    want = jax.vmap(lambda x: jboxes.project_box3d_to_2d(x, tr, p))(b)
    np.testing.assert_allclose(
        _np(boxes.project_box3d_to_2d(_t(b), _t(tr), _t(p))),
        np.asarray(want), rtol=1e-5, atol=1e-3)
    pts = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    for box in b[:4]:
        np.testing.assert_array_equal(
            _np(boxes.points_in_box_3d(_t(pts), _t(box))),
            np.asarray(jboxes.points_in_box_3d(pts, box)))
        np.testing.assert_array_equal(
            _np(boxes.points_in_box_bev(_t(pts[:, :2]), _t(box))),
            np.asarray(jboxes.points_in_box_bev(pts[:, :2], box)))


def test_boxes_pairwise_iou():
    """3D IoU (rotated-BEV intersection) over overlapping random pairs: the
    batched polygon clip equals the JAX ``fori_loop`` clip."""
    rng = np.random.default_rng(1)
    a = _random_boxes(rng, 12, spread=3.0)
    b = np.concatenate([a[:6] + rng.normal(0, 0.4, (6, 7)).astype(np.float32),
                        _random_boxes(rng, 6, spread=3.0)])
    b[:, 3:6] = np.abs(b[:, 3:6])
    want3 = np.asarray(jboxes.pairwise_iou_3d(a, b))
    assert (want3 > 0).sum() > 20
    np.testing.assert_allclose(_np(boxes.pairwise_iou_3d(_t(a), _t(b))),
                               want3, **TOL)
    np.testing.assert_allclose(_np(boxes.aabb_iou_2d(_t(b[:, :4]),
                                                     _t(a[:, :4]))),
                               np.asarray(jboxes.aabb_iou_2d(
                                   b[:, :4], a[:, :4], backend="ref")), **TOL)


# ---------------------------------------------------------------------------
# core/tracking.py
# ---------------------------------------------------------------------------


def _track_state(rng, t=8):
    """A JAX track state with some active tracks, boxes and 3D priors."""
    st = jtrack.init_tracks(t)
    det = np.concatenate([rng.uniform(0, 300, (t, 2)),
                          rng.uniform(0, 300, (t, 2)) + 20], 1)
    det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 5)
    det = det.astype(np.float32)
    val = rng.uniform(size=t) < 0.6
    st, _ = jtrack.spawn(st, det, val, jnp.full((t,), -1, jnp.int32))
    st = jtrack.set_box3d(st, jnp.arange(t, dtype=jnp.int32),
                          _random_boxes(rng, t), val)
    return st, det, val


def _assert_state_close(got, want, tol=TOL):
    for name, g, w in zip(want._fields, got, want):
        g, w = _np(g), np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, err_msg=name, **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_tracking_predict_update_spawn_set_box3d():
    rng = np.random.default_rng(2)
    jst, det, val = _track_state(rng)
    st = convert.from_jax(jax.tree_util.tree_map(np.asarray, jst))
    jst2, jpred = jtrack.predict(jst)
    st2, pred = tracking.predict(st)
    _assert_state_close(st2, jst2)
    np.testing.assert_allclose(_np(pred), np.asarray(jpred), **TOL)

    t2d = np.array([0, -1, 2, 3, -1, 5, 1, -1], np.int32)
    dets = (det + rng.normal(0, 2, det.shape)).astype(np.float32)
    jst3 = jtrack.update(jst2, t2d, dets)
    st3 = tracking.update(st2, _t(t2d), _t(dets))
    # The Kalman gain comes from a 4x4 solve (LU in XLA and in LAPACK);
    # the two factorizations round differently in the last bits.
    _assert_state_close(st3, jst3, dict(rtol=1e-4, atol=1e-4))

    d2t = np.array([-1, 0, -1, -1, 2, -1, -1, -1], np.int32)
    dval = np.array([1, 1, 1, 0, 1, 1, 0, 1], bool)
    jst4, jmap = jtrack.spawn(jst3, dets, dval, d2t)
    st4, dmap = tracking.spawn(st3, _t(dets), _t(dval), _t(d2t))
    _assert_state_close(st4, jst4, dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_array_equal(_np(dmap), np.asarray(jmap))

    b3 = _random_boxes(rng, 8)
    ok = rng.uniform(size=8) < 0.7
    jst5 = jtrack.set_box3d(jst4, jmap, b3, ok)
    st5 = tracking.set_box3d(st4, dmap, _t(b3), _t(ok))
    _assert_state_close(st5, jst5, dict(rtol=1e-4, atol=1e-4))


# ---------------------------------------------------------------------------
# core/association.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 6, 12])
def test_auction_matches_hungarian_and_jax(n):
    rng = np.random.default_rng(n)
    benefit = np.round(rng.uniform(0, 1, (n, n)) * 1000) / 1000
    benefit = benefit.astype(np.float32)
    got = _np(association.auction_assign(_t(benefit)))
    np.testing.assert_array_equal(got, np.asarray(
        jassoc.auction_assign(jnp.asarray(benefit))))
    assert sorted(got) == list(range(n))
    opt = association.hungarian_numpy(-benefit)
    assert benefit[np.arange(n), got].sum() == pytest.approx(
        benefit[np.arange(n), opt].sum(), abs=1e-6)
    np.testing.assert_array_equal(opt, jassoc.hungarian_numpy(-benefit))


def test_associate_matches_jax():
    rng = np.random.default_rng(4)
    t, d = 12, 6
    det = np.concatenate([rng.uniform(0, 200, (d, 2)),
                          rng.uniform(0, 200, (d, 2))], 1)
    det[:, 2:] = det[:, :2] + rng.uniform(10, 60, (d, 2))
    trk = np.concatenate([det, det[:3] + 80]) + rng.normal(0, 4, (9, 4))
    trk = np.concatenate([trk, rng.uniform(0, 300, (3, 4))]).astype(np.float32)
    trk[:, 2:] = np.maximum(trk[:, 2:], trk[:, :2] + 1)
    det = det.astype(np.float32)
    tval = rng.uniform(size=t) < 0.8
    dval = rng.uniform(size=d) < 0.9
    # The engines run association jitted (its rounding is the reference).
    want = jax.jit(jassoc.associate, static_argnums=(4, 5))(
        trk, tval, det, dval, 0.3, "ref")
    got = association.associate(_t(trk), _t(tval), _t(det), _t(dval), 0.3)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(_np(got[2]), np.asarray(want[2]), **TOL)
    assert (_np(got[1]) >= 0).sum() >= 3


# ---------------------------------------------------------------------------
# core/projection.py
# ---------------------------------------------------------------------------


def test_projection_and_clusters():
    cfg = scenes.SceneConfig(max_obj=6, n_points=2048, img_h=48, img_w=160,
                             mean_objects=4, density_scale=4000.0)
    stream = scenes.SceneStream(cfg, seed=2)
    frame = next(stream.frames(1))
    jcal = jproj.Calibration(jnp.asarray(stream.tr), jnp.asarray(stream.p),
                             cfg.img_h, cfg.img_w)
    cal = convert.from_jax(jax.tree_util.tree_map(np.asarray, jcal))
    assert isinstance(cal.height, int) and cal.width == cfg.img_w
    uv, depth, vis = projection.project_points(_t(frame.points), cal)
    juv, jdepth, jvis = jproj.project_points(jnp.asarray(frame.points), jcal,
                                             backend="ref")
    np.testing.assert_allclose(_np(uv), np.asarray(juv), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(_np(vis), np.asarray(jvis))
    labels = projection.project_and_label(_t(frame.points),
                                          _t(frame.label_img), cal)
    jlabels = jproj.project_and_label(jnp.asarray(frame.points),
                                      jnp.asarray(frame.label_img), jcal,
                                      backend="ref")
    np.testing.assert_array_equal(_np(labels), np.asarray(jlabels))
    for p in (64, 256):
        got = projection.build_clusters(_t(frame.points), labels, 6, p)
        want = jproj.build_clusters(jnp.asarray(frame.points), jlabels, 6, p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


# ---------------------------------------------------------------------------
# core/filtration.py
# ---------------------------------------------------------------------------


def test_filtration_matches_jax(clusters):
    pts, valid, _ = clusters
    rng = np.random.default_rng(5)
    centers = (pts[:, :1, :] + rng.normal(0, 1, (pts.shape[0], 1, 3)))[:, 0]
    has = rng.uniform(size=pts.shape[0]) < 0.5
    for params in (jfilt.FiltrationParams(),
                   jfilt.FiltrationParams(m_t=200, f_t=1.5, s_t=2.0)):
        tparams = convert.from_jax(params)
        want = jfilt.filter_clusters(pts, valid, params,
                                     centers.astype(np.float32), has)
        got = filtration.filter_clusters(_t(pts), _t(valid), tparams,
                                         _t(centers), _t(has))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        want = jfilt.filter_clusters(pts, valid, params)
        got = filtration.filter_clusters(_t(pts), _t(valid), tparams)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


# ---------------------------------------------------------------------------
# core/ransac.py
# ---------------------------------------------------------------------------


def test_ransac_same_key_same_triplets_and_planes(clusters):
    pts, _, keep = clusters
    for seed in (0, 7):
        jkey = jax.random.key(seed)
        keys = jax.random.split(jkey, pts.shape[0])
        want_tri = jax.vmap(lambda k, v: jransac._sample_triplets(k, v, 30))(
            keys, keep)
        got_tri = ransac._sample_triplets(prng.split(prng.key(seed),
                                                     pts.shape[0]),
                                          _t(keep), 30)
        np.testing.assert_array_equal(_np(got_tri), np.asarray(want_tri))
        jn, jd, jok = jax.vmap(jransac.plane_from_triplets)(pts, want_tri)
        n, d, ok = ransac.plane_from_triplets(_t(pts), got_tri)
        np.testing.assert_allclose(_np(n), np.asarray(jn), **TOL)
        np.testing.assert_allclose(_np(d), np.asarray(jd), **TOL)
        np.testing.assert_array_equal(_np(ok), np.asarray(jok))
        want = jransac.ransac_planes(jkey, pts, keep, backend="ref")
        got = ransac.ransac_planes(prng.key(seed), _t(pts), _t(keep))
        for name, g, w in zip(want._fields, got, want):
            if np.asarray(w).dtype.kind == "f":
                np.testing.assert_allclose(_np(g), np.asarray(w),
                                           err_msg=name, **TOL)
            else:
                np.testing.assert_array_equal(_np(g), np.asarray(w),
                                              err_msg=name)


# ---------------------------------------------------------------------------
# core/box_estimation.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["surface", "extent", "hybrid"])
def test_estimate_boxes_matches_jax(clusters, mode):
    pts, _, keep = clusters
    o = pts.shape[0]
    fit = jransac.ransac_planes(jax.random.key(1), pts, keep, backend="ref")
    rng = np.random.default_rng(6)
    assoc = rng.uniform(size=o) < 0.5
    prev = _random_boxes(rng, o)
    prev[:, :3] = np.asarray(pts[:, 0])
    avg = np.array([4.0, 1.7, 1.6], np.float32)
    params = jbox.BoxEstParams(center_mode=mode)
    want = jbox.estimate_boxes(pts, fit.inliers, keep, fit.normal, fit.ok,
                               assoc, prev, avg, params)
    args = [_t(x) for x in (pts, fit.inliers, keep, fit.normal, fit.ok,
                            assoc, prev, avg)]
    got = box_estimation.estimate_boxes(*args, convert.from_jax(params))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    one = box_estimation.estimate_box(box_estimation.EstimateInputs(
        *(a[2] for a in args[:7]), args[7]), convert.from_jax(params))
    np.testing.assert_allclose(_np(one[0]), np.asarray(want[0])[2], **TOL)


# ---------------------------------------------------------------------------
# core/metrics.py
# ---------------------------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    gt = _random_boxes(rng, 8, spread=15.0)
    det = gt + rng.normal(0, 0.3, gt.shape).astype(np.float32)
    det[5:] = _random_boxes(rng, 3, spread=15.0)
    dv = rng.uniform(size=8) < 0.9
    gv = rng.uniform(size=8) < 0.9
    iou = np.asarray(jboxes.pairwise_iou_3d(det, gt))
    for thresh in (0.1, 0.4):
        want = jmetrics.match_greedy(jnp.asarray(iou), dv, gv, thresh)
        got = metrics.match_greedy(_t(iou), _t(dv), _t(gv), thresh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    for args in ((det, dv, gt, gv), (det, np.zeros(8, bool), gt, gv),
                 (det, np.zeros(8, bool), gt, np.zeros(8, bool))):
        want = jmetrics.f1_score(*args)
        got = metrics.f1_score(*(_t(a) for a in args))
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], **TOL)


# ---------------------------------------------------------------------------
# core/scheduler.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["fos", "periodic(3)", "always_anchor",
                                    "never_anchor", "adaptive"])
def test_scheduler_policies_step_for_step(policy):
    """Both state machines driven through the same 14 frames of outputs,
    telemetry and test arrivals stay equal at every step."""
    rng = np.random.default_rng(8)
    jp = jsched.SchedulerParams(policy=policy, n_t=3)
    tp = convert.from_jax(jp)
    js = jsched.init_scheduler(6)
    ts = scheduler.init_scheduler(6)
    gt = _random_boxes(rng, 6, spread=10.0)
    for t in range(14):
        bw, edge, off = rng.uniform(1, 20), rng.uniform(0.05, 0.1), \
            rng.uniform(0.1, 0.6)
        js = jsched.observe_telemetry(js, bw_mbps=bw, edge_cost_s=edge,
                                      offload_cost_s=off)
        ts = scheduler.observe_telemetry(ts, bw_mbps=bw, edge_cost_s=edge,
                                         offload_cost_s=off)
        ja = jsched.scheduler_pre(js, jp)
        ta = scheduler.scheduler_pre(ts, tp)
        for g, w in zip(ta, ja):
            assert bool(g) == bool(w)
        out = (gt + rng.normal(0, 0.3 * t / 7, gt.shape)).astype(np.float32)
        ov = rng.uniform(size=6) < 0.9
        arrived = bool(t % 3 == 2)
        js = jsched.scheduler_post(js, ja, out, ov, jnp.bool_(arrived), gt,
                                   np.ones(6, bool), jp)
        ts = scheduler.scheduler_post(ts, ta, _t(out), _t(ov),
                                      torch.tensor(arrived), _t(gt),
                                      torch.ones(6, dtype=torch.bool), tp)
        _assert_state_close(ts, js)
        np.testing.assert_allclose(_np(scheduler.decision_telemetry(ts)),
                                   np.asarray(jsched.decision_telemetry(js)),
                                   **TOL)


def test_scheduler_registry_matches_jax():
    assert scheduler.list_policies() == jsched.list_policies()
    for name in ("fos", "periodic", "periodic(7)", "always_anchor",
                 "never_anchor", "adaptive"):
        assert scheduler.get_policy(name).name == jsched.get_policy(name).name
        assert scheduler.get_policy(name).uses_tests == \
            jsched.get_policy(name).uses_tests
    for bad in ("nope", "fos(2)", "periodic(0)"):
        with pytest.raises(KeyError):
            scheduler.get_policy(bad)

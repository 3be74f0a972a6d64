"""The port's detectors and optimizer against the JAX package's.

The same weights (JAX's ``init_params`` with key 0, carried across by
``convert.detector_params_from_jax``) and the same seeded frame (a scene
from ``repro.data.scenes`` with a seeded intensity column) go through
``repro.models.detector3d`` (jitted, ``ref`` backend) and
``repro_torch.models.detector3d`` at a small PointPillars config: each step
of ``forward`` (pillarize, the SAME padding, the normalisation axes, the
upsample, the head layout), ``assign_targets``, ``loss_fn`` with the
gradient of every leaf, ``detect`` and three AdamW steps; then the 2D
detector. Tolerances (``repro_torch.testing``, shared with
``chip_smoke.py``), relative to the largest magnitude of each tensor
compared, every gradient leaf on its own scale: 1e-5 for outputs and the
loss, 2e-5 for gradients (float32 sums taken in another order by the
matmul, the convolutions and the variance, carried through three
normalised conv blocks and back: the largest difference seen is 6.0e-6 of
a leaf's scale); cells, ids, masks and kept flags exact.

``tests/goldens/det3d_smoke.npz`` holds JAX's weights, frame, outputs,
gradients and three training steps at this config, so that
``chip_smoke.py`` can hold the card against JAX without JAX, through the
same ``testing.check_golden``. One test checks that JAX still produces it
(regenerate with ``MOBY_REGEN_GOLDENS=1``), another that the port matches
it.
"""
import dataclasses
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import boxes as jboxes  # noqa: E402
from repro.data import scenes as jscenes  # noqa: E402
from repro.models import detector2d as jdet2d  # noqa: E402
from repro.models import detector3d as jdet  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro_torch import convert, testing  # noqa: E402
from repro_torch.core import boxes  # noqa: E402
from repro_torch.models import cnn, detector2d, detector3d, params  # noqa
from repro_torch.testing import GRAD_TOL, OUT_TOL  # noqa: E402
from repro_torch.testing import close as _close  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

GOLDEN = pathlib.Path(__file__).parent / "goldens" / "det3d_smoke.npz"
# The small config: a 32x32 grid of 2 m pillars over the default ranges.
SMALL = dict(grid_h=32, grid_w=32, pillar=2.0, feat_dim=8,
             backbone_dims=(8, 16, 32))
ADAMW = dict(lr=1e-3, warmup_steps=2, total_steps=10)
N_POINTS, STEPS = 4096, 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfgs(**kw):
    return (jdet.PillarConfig(backend="ref", **kw),
            detector3d.PillarConfig(**kw))


def _frame(seed=0):
    """One scene frame: (N, 4) points with a seeded intensity, a mask,
    the ground-truth boxes and their flags."""
    sc = jscenes.SceneConfig(n_points=N_POINTS, max_obj=8)
    fr = next(jscenes.SceneStream(sc, seed=seed).frames(1))
    rng = np.random.default_rng(seed)
    inten = rng.uniform(0, 1, (N_POINTS, 1)).astype(np.float32)
    pts = np.concatenate([fr.points, inten], 1).astype(np.float32)
    valid = rng.uniform(size=N_POINTS) < 0.97
    return pts, valid, fr.gt_boxes.astype(np.float32), fr.gt_valid.copy()


def _tree(j):
    return jax.tree_util.tree_map(np.asarray, j)


def _port_loss_grads(p, cfg, frame):
    return testing.loss_grads(p, cfg, *map(_t, frame))


def _jax_run(jcfg, jparams, frame):
    """JAX's forward, loss, gradients, detect and STEPS training steps."""
    pts, valid, gtb, gtv = (jnp.asarray(a) for a in frame)
    fwd = jax.jit(lambda p: jdet.forward(p, jcfg, pts, valid))
    vg = jax.jit(jax.value_and_grad(
        lambda p: jdet.loss_fn(p, jcfg, pts, valid, gtb, gtv), has_aux=True))
    det = jax.jit(lambda p: jdet.detect(p, jcfg, pts, valid))
    ocfg = joptim.AdamWConfig(**ADAMW)
    upd = jax.jit(lambda g, s, p: joptim.update(ocfg, g, s, p))
    cls, box = fwd(jparams)
    (loss, parts), grads = vg(jparams)
    det_boxes, det_valid = det(jparams)
    p, state, losses, norms = jparams, joptim.init(jparams), [], []
    for _ in range(STEPS):
        (lv, _), g = vg(p)
        p, state, metrics = upd(g, state, p)
        losses.append(lv)
        norms.append(metrics["grad_norm"])
    return dict(cls=cls, box=box, loss=loss, loss_cls=parts["cls"],
                loss_box=parts["box"], grads=_tree(grads),
                det_boxes=det_boxes, det_valid=det_valid,
                trained=_tree(p), train_losses=np.stack(losses),
                train_grad_norms=np.stack(norms))


@pytest.fixture(scope="module")
def small():
    """JAX's run at the small config, shared by the tests below."""
    jcfg, cfg = _cfgs(**SMALL)
    jparams = jinit_params(jdet.detector_defs(jcfg), jax.random.key(0))
    frame = _frame()
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, tree=_tree(jparams),
                p=convert.detector_params_from_jax(_tree(jparams), cfg),
                frame=frame, jax=_jax_run(jcfg, jparams, frame))


# ---------------------------------------------------------------------------
# Configs, parameter trees, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, SMALL, dict(second_style=True)])
def test_config_and_defs_equal_jax(kw):
    jcfg, cfg = _cfgs(**kw)
    jfields = {f.name for f in dataclasses.fields(jcfg)} - {"backend"}
    assert jfields == {f.name for f in dataclasses.fields(cfg)}
    for name in jfields:
        assert getattr(jcfg, name) == getattr(cfg, name), name
    want = {path: d.shape for path, d in params.leaves(_tree_defs(jcfg))}
    got = {path: d.shape for path, d in
           params.leaves(detector3d.detector_defs(cfg))}
    assert got == want


def _tree_defs(jcfg):
    return jax.tree_util.tree_map(
        lambda d: d, jdet.detector_defs(jcfg),
        is_leaf=lambda x: hasattr(x, "logical_axes"))


def test_params_from_jax_checks_the_tree(small):
    tree = dict(small["tree"])
    tree["pnet_w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="pnet_w"):
        convert.detector_params_from_jax(tree, small["cfg"])


def test_params2d_from_jax_checks_the_tree(small2d):
    tree = _tree(small2d["jparams"])
    del tree["head_wh"]
    with pytest.raises(ValueError, match="head_wh"):
        convert.detector2d_params_from_jax(tree, small2d["cfg"])


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def test_iou_bev_matches_jax():
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.uniform(0, 8, (10, 3)), rng.uniform(1, 5, (10, 3)),
                        rng.uniform(-3, 3, (10, 1))], 1).astype(np.float32)
    b = np.concatenate([a[:5] + rng.normal(0, 0.5, (5, 7)),
                        a[5:7], a[7:] + 50.0]).astype(np.float32)
    b[:, 3:6] = np.abs(b[:, 3:6])
    want = np.asarray(jax.jit(jboxes.pairwise_iou_bev)(a, b))
    assert (want > 0).sum() > 10 and np.isclose(want[5, 5], 1.0)
    _close(boxes.pairwise_iou_bev(_t(a), _t(b)), want, 1e-5, "pairwise")
    one = np.asarray(jax.jit(jax.vmap(jboxes.iou_bev))(a, b))
    _close(boxes.iou_bev(_t(a), _t(b)), one, 1e-5, "iou_bev")


def _edge_points(cfg, rng, n=600):
    """Points on pillar edges (and one float32 ulp either side), on the
    z bounds, and beyond the grid."""
    ix = rng.integers(-2, cfg.grid_w + 2, n)
    iy = rng.integers(-2, cfg.grid_h + 2, n)
    x = (cfg.x_range[0] + ix * np.float32(cfg.pillar)).astype(np.float32)
    y = (cfg.y_range[0] + iy * np.float32(cfg.pillar)).astype(np.float32)
    step = rng.integers(-1, 2, (n, 2))
    x = np.nextafter(x, x + step[:, 0]).astype(np.float32)
    y = np.nextafter(y, y + step[:, 1]).astype(np.float32)
    z = rng.choice(np.array([cfg.z_range[0], cfg.z_range[1], -1.0,
                             np.nextafter(np.float32(cfg.z_range[1]), 9),
                             np.nextafter(np.float32(cfg.z_range[0]), -9)],
                            np.float32), n)
    pts = np.stack([x, y, z, rng.uniform(0, 1, n)], 1).astype(np.float32)
    return pts, rng.uniform(size=n) < 0.9


@pytest.mark.parametrize("kw", [{}, dict(second_style=True),
                                dict(pillar=0.16, grid_h=400, grid_w=400)])
def test_pillarize_matches_jax_on_cell_edges(kw):
    """Ids and masks exact, features within 1e-6, against the jitted JAX
    function (XLA compiles ``/ pillar`` as a multiply by the float32
    reciprocal, which decides the cell of a point on an edge at 0.16 m)."""
    jcfg, cfg = _cfgs(**kw)
    pts, valid = _edge_points(cfg, np.random.default_rng(len(kw)))
    jf, jpid, jok = jax.jit(lambda a, b: jdet.pillarize(jcfg, a, b))(
        pts, valid)
    f, pid, ok = detector3d.pillarize(cfg, _t(pts), _t(valid))
    assert pid.dtype == torch.int32
    np.testing.assert_array_equal(_np(pid), np.asarray(jpid))
    np.testing.assert_array_equal(_np(ok), np.asarray(jok))
    assert 0 < _np(ok).sum() < len(pts)
    np.testing.assert_allclose(_np(f), np.asarray(jf), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# forward, step by step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,k,stride", [((16, 16), 3, 2), ((15, 9), 3, 2),
                                           ((8, 6), 3, 1), ((7, 5), 1, 1)])
def test_same_padding_matches_jax(size, k, stride):
    """SAME at stride 2 pads (0, 1) on even sizes: F.conv2d(padding=1)
    would shift the map by a pixel."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, *size, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = cnn.conv2d_same(_t(x).permute(0, 3, 1, 2), _t(w), stride)
    _close(got.permute(0, 2, 3, 1), want, 1e-5, "conv")
    if stride == 2 and size[0] % 2 == 0:
        assert cnn.same_pads(size[0], 3, 2) == (0, 1)


def test_norm_axes_match_jax():
    """The 3D detector normalises over batch and H per (W, C); the 2D one
    over H and W per (B, C). Population variance in both."""
    rng = np.random.default_rng(0)
    x = rng.normal(2, 3, size=(2, 6, 5, 4)).astype(np.float32)
    scale = rng.uniform(0.5, 2, 4).astype(np.float32)
    xt = _t(x).permute(0, 3, 1, 2)
    _close(cnn.norm_relu(xt, _t(scale), (0, 2)).permute(0, 2, 3, 1),
           jdet._norm_relu(x, scale), 1e-5, "3d")
    _close(cnn.norm_relu(xt, _t(scale), (2, 3)).permute(0, 2, 3, 1),
           jdet2d._norm_relu(x, scale), 1e-5, "2d")


@pytest.mark.parametrize("src,dst", [((4, 4), (16, 16)), ((16, 16), (64, 64)),
                                     ((5, 3), (13, 7)), ((8, 8), (3, 5))])
def test_upsample_matches_jax(src, dst):
    x = np.arange(np.prod(src) * 2, dtype=np.float32).reshape(1, *src, 2)
    want = jax.image.resize(x, (1, *dst, 2), "nearest")
    got = detector3d._resize_nearest(_t(x).permute(0, 3, 1, 2), dst)
    np.testing.assert_array_equal(_np(got.permute(0, 2, 3, 1)),
                                  np.asarray(want))


def test_clip_gradient_splits_at_a_bound_as_jax():
    x = np.array([1e-7, 1.0, 0.5, 1e-9, 2.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.log(jnp.clip(v, 1e-7, 1.0))))(x)
    xt = _t(x).requires_grad_()
    torch.log(cnn.clip(xt, 1e-7, 1.0)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(want), rtol=1e-6)
    assert _np(xt.grad)[1] == 0.5


def test_forward_matches_jax(small):
    cls, box = detector3d.forward(small["p"], small["cfg"],
                                  *map(_t, small["frame"][:2]))
    hh = SMALL["grid_h"] // 2
    assert cls.shape == (hh, hh, 2) and box.shape == (hh, hh, 2, 7)
    _close(cls, small["jax"]["cls"], OUT_TOL, "cls")
    _close(box, small["jax"]["box"], OUT_TOL, "box")


def test_anchors_and_decode_match_jax(small):
    jcfg, cfg = small["jcfg"], small["cfg"]
    rng = np.random.default_rng(2)
    d = rng.normal(0, 0.3, (16, 16, 2, 7)).astype(np.float32)
    _close(detector3d.anchor_grid(cfg, 16, 16), jdet.anchor_grid(jcfg, 16, 16),
           1e-6, "anchors")
    _close(detector3d.decode_boxes(cfg, _t(d)), jdet.decode_boxes(jcfg, d),
           1e-6, "decode")


def test_assign_targets_matches_jax_with_shared_cells(small):
    """Two valid objects in one cell (the later wins), a third one there
    that is invalid, objects off the grid (clamped), a 90-degree yaw."""
    jcfg, cfg = small["jcfg"], small["cfg"]
    gt = np.array([[10.5, 3.0, -1, 4, 1.7, 1.5, 0.1],
                   [11.0, 2.5, -0.5, 3.5, 1.5, 1.4, 0.2],
                   [10.8, 2.8, -1, 4.2, 1.8, 1.6, 0.0],
                   [30.0, -20, -1, 4, 1.7, 1.5, 1.6],
                   [80.0, 40.0, -1, 4, 1.7, 1.5, 0.0],
                   [-5.0, -40.0, -1, 4, 1.7, 1.5, 3.0],
                   [30.2, -19.9, -1, 4.4, 1.9, 1.5, -1.5]], np.float32)
    valid = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    want = jdet.assign_targets(jcfg, 16, 16, jnp.asarray(gt),
                               jnp.asarray(valid))
    got = detector3d.assign_targets(cfg, 16, 16, _t(gt), _t(valid))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    _close(got[1], want[1], 1e-6, "box targets")
    # Objects 0 and 1 share a cell, so do 3 and 6 (both near 90 degrees);
    # 4 and 5 are clamped to corners.
    assert int(_np(got[2]).sum()) == 4


def test_loss_and_every_gradient_match_jax(small):
    loss, parts, grads = _port_loss_grads(small["p"], small["cfg"],
                                          small["frame"])
    want = small["jax"]
    _close(loss, want["loss"], OUT_TOL, "loss")
    _close(parts["cls"], want["loss_cls"], OUT_TOL, "cls loss")
    _close(parts["box"], want["loss_box"], OUT_TOL, "box loss")
    wg = dict(params.leaves(want["grads"]))
    got = dict(params.leaves(grads))
    assert sorted(got) == sorted(wg)
    for path, g in got.items():
        assert float(np.abs(wg[path]).max()) > 0, path
        _close(g, wg[path], GRAD_TOL, "/".join(path))


def test_detect_matches_jax(small):
    got_boxes, got_valid = detector3d.detect(small["p"], small["cfg"],
                                             *map(_t, small["frame"][:2]))
    np.testing.assert_array_equal(_np(got_valid),
                                  np.asarray(small["jax"]["det_valid"]))
    _close(got_boxes, small["jax"]["det_boxes"], OUT_TOL, "boxes")


def test_detect_breaks_score_ties_as_lax_top_k(small):
    """Every score equal (zero class weights, so every score is 0.5): the
    candidates are the lowest 64 anchor indices, in order, and the NMS
    keeps what JAX keeps."""
    jp = dict(small["jparams"], head_cls=jnp.zeros_like(
        small["jparams"]["head_cls"]))
    p = dict(small["p"], head_cls=torch.zeros_like(small["p"]["head_cls"]))
    pts, valid = small["frame"][:2]
    want = jax.jit(lambda q: jdet.detect(q, small["jcfg"], pts, valid,
                                         score_thresh=0.5))(jp)
    got = detector3d.detect(p, small["cfg"], _t(pts), _t(valid),
                            score_thresh=0.5)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    assert _np(got[1]).all()
    _close(got[0], want[0], OUT_TOL, "tied boxes")
    first = detector3d.decode_boxes(small["cfg"], detector3d.forward(
        p, small["cfg"], _t(pts), _t(valid))[1]).reshape(-1, 7)[:32]
    _close(got[0], first, OUT_TOL, "lowest indices first")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_three_steps_match_jax(small):
    """The same gradients into both optimizers, through the warm-up and
    into the cosine: parameters, moments, learning rate and norm."""
    jcfg_o = joptim.AdamWConfig(**ADAMW)
    cfg_o = optimizer.AdamWConfig(**ADAMW)
    assert tuple(jcfg_o) == tuple(cfg_o)
    rng = np.random.default_rng(5)
    jp, jstate = small["jparams"], joptim.init(small["jparams"])
    p, state = small["p"], optimizer.init(small["p"])
    upd = jax.jit(lambda g, s, q: joptim.update(jcfg_o, g, s, q))
    for _ in range(STEPS):
        g = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 2, a.shape).astype(np.float32), jp)
        jp, jstate, jm = upd(g, jstate, jp)
        p, state, m = optimizer.update(cfg_o, params.tree_map(_t, _tree(g)),
                                       state, p)
        _close(m["lr"], jm["lr"], 1e-6, "lr")
        _close(m["grad_norm"], jm["grad_norm"], 1e-6, "grad norm")
    assert int(state.step) == int(jstate.step) == STEPS
    for name, got, want in (("params", p, jp), ("m", state.m, jstate.m),
                            ("v", state.v, jstate.v)):
        wl = dict(params.leaves(_tree(want)))
        for path, t in params.leaves(got):
            _close(t, wl[path], 1e-6, f"{name}/{'/'.join(path)}")


def test_training_steps_match_jax(small):
    p, losses, norms, step_grads = testing.train(
        small["p"], small["cfg"], optimizer.AdamWConfig(**ADAMW),
        [_t(a) for a in small["frame"]], STEPS)
    want = small["jax"]
    _close(losses, want["train_losses"], OUT_TOL, "losses")
    _close(norms, want["train_grad_norms"], GRAD_TOL, "grad norms")
    testing.close_trained(p, dict(params.leaves(want["trained"])),
                          step_grads, ADAMW["lr"])


# ---------------------------------------------------------------------------
# The 2D detector
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small2d():
    kw = dict(img_h=32, img_w=64, dims=(4, 8, 16), max_det=6)
    jcfg, cfg = jdet2d.Det2DConfig(**kw), detector2d.Det2DConfig(**kw)
    jparams = jinit_params(jdet2d.detector2d_defs(jcfg), jax.random.key(1))
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (32, 64, 3)).astype(np.float32)
    xy = rng.uniform(0, 50, (5, 2))
    bx = np.concatenate([xy, xy + rng.uniform(4, 14, (5, 2))], 1)
    bx[1] = bx[0] + 0.5               # two boxes centred in one cell
    bx = bx.astype(np.float32)
    valid = np.array([1, 1, 1, 0, 1], bool)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, img=img, boxes=bx,
                valid=valid,
                p=convert.detector2d_params_from_jax(_tree(jparams), cfg))


def test_detector2d_forward_and_targets_match_jax(small2d):
    s = small2d
    hm, wh = detector2d.forward(s["p"], s["cfg"], _t(s["img"])[None])
    jhm, jwh = jax.jit(lambda q: jdet2d.forward(q, s["jcfg"], s["img"][None]))(
        s["jparams"])
    _close(hm, jhm, OUT_TOL, "heatmap")
    _close(wh, jwh, OUT_TOL, "box regression")
    got = detector2d.make_targets(s["cfg"], _t(s["boxes"]), _t(s["valid"]))
    want = jdet2d.make_targets(s["jcfg"], jnp.asarray(s["boxes"]),
                               jnp.asarray(s["valid"]))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    _close(got[1], want[1], 1e-6, "size targets")


def test_detector2d_loss_and_gradients_match_jax(small2d):
    s = small2d
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jdet2d.loss_fn(p, s["jcfg"], s["img"], jnp.asarray(
            s["boxes"]), jnp.asarray(s["valid"])), has_aux=True))(s["jparams"])
    leaves = params.tree_map(lambda t: t.clone().requires_grad_(), s["p"])
    loss, _ = detector2d.loss_fn(leaves, s["cfg"], _t(s["img"]),
                                 _t(s["boxes"]), _t(s["valid"]))
    grads = torch.autograd.grad(loss, [t for _, t in params.leaves(leaves)])
    _close(loss, jl, OUT_TOL, "loss")
    for (path, _), g in zip(params.leaves(leaves), grads):
        _close(g, dict(params.leaves(_tree(jg)))[path], GRAD_TOL,
               "/".join(path))


def test_detector2d_detect_matches_jax(small2d):
    s = small2d
    # Scale the heatmap head so that several scores clear 0.3.
    jp = dict(s["jparams"], head_hm=s["jparams"]["head_hm"] * 4.0)
    p = dict(s["p"], head_hm=s["p"]["head_hm"] * 4.0)
    jb, js, jlab = jax.jit(lambda q: jdet2d.detect(q, s["jcfg"], s["img"]))(
        jp)
    b, sc, lab = detector2d.detect(p, s["cfg"], _t(s["img"]))
    _close(sc, js, OUT_TOL, "scores")
    _close(b, jb, OUT_TOL, "boxes")
    np.testing.assert_array_equal(_np(lab), np.asarray(jlab))
    assert lab.dtype == torch.int32 and 0 < len(np.unique(_np(lab))) > 1


# ---------------------------------------------------------------------------
# The golden that chip_smoke.py holds the card against
# ---------------------------------------------------------------------------


def _golden_from_jax(small):
    j = small["jax"]
    pts, valid, gtb, gtv = small["frame"]
    out = {"params/" + "/".join(path): a
           for path, a in params.leaves(small["tree"])}
    out.update({"grads/" + "/".join(path): a
                for path, a in params.leaves(j["grads"])})
    out.update({"trained/" + "/".join(path): a
                for path, a in params.leaves(j["trained"])})
    out.update(config=np.array(json.dumps(SMALL)),
               adamw=np.array(json.dumps(ADAMW)), points=pts, valid=valid,
               gt_boxes=gtb, gt_valid=gtv, **{
                   k: np.asarray(j[k]) for k in (
                       "cls", "box", "loss", "loss_cls", "loss_box",
                       "det_boxes", "det_valid", "train_losses",
                       "train_grad_norms")})
    return out


def test_jax_reproduces_the_det3d_golden(small):
    fresh = _golden_from_jax(small)
    if os.environ.get("MOBY_REGEN_GOLDENS") == "1":
        np.savez_compressed(GOLDEN, **fresh)
    gold = testing.load_golden(GOLDEN)
    assert sorted(gold) == sorted(fresh)
    for k in gold:
        if gold[k].dtype.kind in "bUi":
            np.testing.assert_array_equal(fresh[k], gold[k], err_msg=k)
        else:
            np.testing.assert_allclose(fresh[k], gold[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_port_matches_the_det3d_golden():
    """Forward, loss, every gradient, detect and the AdamW steps on the
    CPU against the golden, by the check chip_smoke.py runs on the card."""
    res = testing.check_golden(GOLDEN, "cpu")
    assert res["steps"] == STEPS and res["n_grads"] == 11
    assert res["cfg"] == detector3d.PillarConfig(**SMALL)


@pytest.mark.cuda
def test_detector_on_card_matches_cpu(small):
    """Loss and every gradient on the card within the CPU parity
    tolerances of the port's CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    p_dev = params.tree_map(lambda t: t.to(dev), small["p"])
    frame_dev = [_t(a).to(dev) for a in small["frame"]]
    loss, _, grads = _port_loss_grads(small["p"], small["cfg"],
                                      small["frame"])
    loss_d, _, grads_d = testing.loss_grads(p_dev, small["cfg"], *frame_dev)
    _close(loss_d, loss, OUT_TOL, "loss")
    want = dict(params.leaves(grads))
    for path, gd in params.leaves(grads_d):
        _close(gd, want[path], GRAD_TOL, "/".join(path))

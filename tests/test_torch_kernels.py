"""The port's three kernel modules against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
that version against the JAX ``ref.py`` oracle and against the Pallas
kernel in interpret mode, at ``tests/test_kernels.py``'s shapes and
tolerances (counts, masks, flat indices and labels exact). The CUDA kernels
themselves run only on a card: ``test_kernels_match_plain_on_card`` is
marked ``cuda`` and skips without one (``python3 chip_smoke.py`` holds
every kernel against its plain version at the serving shapes).
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import scenes  # noqa: E402
from repro.kernels.iou2d import ops as jiou_ops  # noqa: E402
from repro.kernels.iou2d import ref as jiou_ref  # noqa: E402
from repro.kernels.point_proj import ops as jpp_ops  # noqa: E402
from repro.kernels.point_proj import ref as jpp_ref  # noqa: E402
from repro.kernels.ransac_score import ops as jrs_ops  # noqa: E402
from repro.kernels.ransac_score import ref as jrs_ref  # noqa: E402
from repro_torch import kernels, ops  # noqa: E402
from repro_torch.kernels.auction import ops as au_ops  # noqa: E402
from repro_torch.kernels.iou2d import ops as iou_ops  # noqa: E402
from repro_torch.kernels.iou2d import ref as iou_ref  # noqa: E402
from repro_torch.kernels.point_proj import ops as pp_ops  # noqa: E402
from repro_torch.kernels.point_proj import ref as pp_ref  # noqa: E402
from repro_torch.kernels.ransac_score import ops as rs_ops  # noqa: E402
from repro_torch.kernels.ransac_score import ref as rs_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


# ---------------------------------------------------------------------------
# ransac_score
# ---------------------------------------------------------------------------


# (o, p, k) -> an object whose points are all masked out.
DEAD_OBJECT = {(5, 33, 33): 2}


def _ransac_inputs(o, p, k):
    rng = np.random.default_rng(o * 100 + p + k)
    pts = rng.normal(0, 5, (o, p, 3)).astype(np.float32)
    valid = rng.uniform(size=(o, p)) < 0.8
    if (o, p, k) in DEAD_OBJECT:
        valid[DEAD_OBJECT[o, p, k]] = False
    nrm = rng.normal(size=(o, k, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    off = rng.normal(0, 3, (o, k)).astype(np.float32)
    return pts, valid, nrm.astype(np.float32), off


# The serving shape and others, then the card checks' edge cases
# (chip_smoke.py): one point and one plane, an object of invalid points,
# 4,000 points an object.
@pytest.mark.parametrize("o,p,k", [(1, 64, 30), (4, 256, 30), (8, 100, 60),
                                   (2, 256, 128), (12, 256, 30), (1, 1, 1),
                                   (5, 33, 33), (2, 4000, 5)])
def test_ransac_score_matches_jax(o, p, k):
    pts, valid, nrm, off = _ransac_inputs(o, p, k)
    got = rs_ops.ransac_score(_t(pts), _t(valid), _t(nrm), _t(off), 0.5)
    assert got.dtype == torch.int32 and got.shape == (o, k)
    want_ref = jrs_ref.ransac_score_ref(pts, valid, nrm, off, 0.5)
    want_pallas = jrs_ops.ransac_score(jnp.asarray(pts), jnp.asarray(valid),
                                       jnp.asarray(nrm), jnp.asarray(off),
                                       0.5, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    if (o, p, k) in DEAD_OBJECT:
        assert not got[DEAD_OBJECT[o, p, k]].any()


# ---------------------------------------------------------------------------
# iou2d
# ---------------------------------------------------------------------------


def _boxes(rng, cnt):
    xy = rng.uniform(0, 100, (cnt, 2))
    wh = rng.uniform(1, 30, (cnt, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# (32, 32) and (33, 33) sit on each side of the kernel's one-CTA limit
# (1024 outputs).
@pytest.mark.parametrize("n,m", [(1, 1), (7, 13), (24, 12), (128, 128),
                                 (130, 250), (32, 32), (33, 33)])
def test_iou2d_matches_jax(n, m):
    rng = np.random.default_rng(n * 97 + m)
    a, b = _boxes(rng, n), _boxes(rng, m)
    got = iou_ops.iou2d(_t(a), _t(b)).numpy()
    want_ref = np.asarray(jiou_ref.iou2d_ref(jnp.asarray(a), jnp.asarray(b)))
    want_pallas = np.asarray(jiou_ops.iou2d(jnp.asarray(a), jnp.asarray(b),
                                            interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-6)


def test_iou2d_degenerate_boxes():
    """Inverted and zero-area boxes: areas clamp at 0, IoU is 0 where the
    union vanishes."""
    a = np.array([[0, 0, 0, 0], [5, 5, 1, 1], [0, 0, 2, 2]], np.float32)
    b = np.array([[0, 0, 0, 0], [1, 1, 3, 3]], np.float32)
    got = iou_ops.iou2d(_t(a), _t(b)).numpy()
    want = np.asarray(jiou_ref.iou2d_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# point_proj and its labels instance (project_and_label)
# ---------------------------------------------------------------------------


def _proj_inputs(n, h, w, seed):
    rng = np.random.default_rng(seed)
    tr, p = scenes.make_calibration(scenes.SceneConfig(img_h=h, img_w=w))
    pts = rng.normal(0, 20, (n, 3)).astype(np.float32)
    lab = rng.integers(0, 9, (h, w)).astype(np.int32)
    return pts, tr, p, lab


def _unaligned(pts: np.ndarray, device="cpu") -> torch.Tensor:
    """The (N, 3) points as a contiguous view one row into a larger tensor
    (``big[1:]``): a base 12 bytes past the allocation."""
    big = torch.zeros((len(pts) + 1, 3), dtype=torch.float32, device=device)
    big[1:] = _t(pts).to(device)
    view = big[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 == 12
    return view


# N % 4 != 0 (77, 1001, 4099) and a points base that is not 16-byte
# aligned, as the card's kernel takes them.
@pytest.mark.parametrize("n,unaligned", [
    *(pytest.param(n, False, id=str(n))
      for n in (64, 512, 1000, 4096, 77, 1001, 4099)),
    pytest.param(1001, True, id="1001-unaligned")])
def test_point_proj_matches_jax(n, unaligned):
    h, w = 128, 416
    pts, tr, p, lab = _proj_inputs(n, h, w, n)
    pts_t = _unaligned(pts) if unaligned else _t(pts)
    uv, depth, vis, flat = pp_ops.point_proj(pts_t, _t(tr), _t(p), h, w)
    assert vis.dtype == torch.bool and flat.dtype == torch.int32
    uv_r, d_r, vis_r, flat_r = (np.asarray(x) for x in jpp_ref.point_proj_ref(
        jnp.asarray(pts), jnp.asarray(tr), jnp.asarray(p), h, w))
    uv_k, d_k, vis_k, flat_k = (np.asarray(x) for x in jpp_ops.point_proj(
        jnp.asarray(pts), jnp.asarray(tr), jnp.asarray(p), h, w,
        interpret=True))
    lab_r = np.asarray(jpp_ops.label_points(jnp.asarray(flat_r),
                                            jnp.asarray(vis_r),
                                            jnp.asarray(lab)))
    for uv_w, d_w, vis_w in ((uv_r, d_r, vis_r), (uv_k, d_k, vis_k)):
        np.testing.assert_allclose(uv.numpy(), uv_w, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(depth.numpy(), d_w, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(vis.numpy(), vis_w)
    # The plain version follows XLA's CPU ref step for step: every flat
    # index (visible or not) and every label equal.
    np.testing.assert_array_equal(flat.numpy(), flat_r)
    np.testing.assert_array_equal(flat.numpy()[vis_k], flat_k[vis_k])
    np.testing.assert_array_equal(
        ops.label_points(flat, vis, _t(lab)).numpy(), lab_r)
    np.testing.assert_array_equal(
        pp_ops.project_and_label(pts_t, _t(tr), _t(p), _t(lab)).numpy(),
        lab_r)


def test_project_and_label_matches_core_projection():
    """The fused op reproduces ``repro.core.projection``'s labeling on a
    rendered scene."""
    from repro.core import projection as jproj
    from repro_torch.core import projection
    cfg = scenes.SceneConfig(max_obj=8, n_points=2048, seed=3)
    stream = scenes.SceneStream(cfg, seed=5)
    frame = next(stream.frames(1))
    jcal = jproj.Calibration(tr=jnp.asarray(stream.tr), p=jnp.asarray(stream.p),
                             height=cfg.img_h, width=cfg.img_w)
    want = jproj.project_and_label(jnp.asarray(frame.points),
                                   jnp.asarray(frame.label_img), jcal,
                                   backend="ref")
    cal = projection.Calibration(_t(stream.tr), _t(stream.p), cfg.img_h,
                                 cfg.img_w)
    got = projection.project_and_label(_t(frame.points), _t(frame.label_img),
                                       cal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    uv, _, vis = projection.project_points(_t(frame.points), cal)
    np.testing.assert_array_equal(
        projection.label_points(uv, vis, _t(frame.label_img)).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("unaligned", [False, True],
                         ids=["aligned", "unaligned"])
def test_labels_instance_matches_core_projection(unaligned):
    """The labels-only wrapper (the serving path's launch on the card)
    reproduces ``repro.core.projection.project_and_label`` on a rendered
    scene, also from points at an unaligned base."""
    from repro.core import projection as jproj
    cfg = scenes.SceneConfig(max_obj=8, n_points=3001, seed=7)
    stream = scenes.SceneStream(cfg, seed=11)
    frame = next(stream.frames(1))
    jcal = jproj.Calibration(tr=jnp.asarray(stream.tr), p=jnp.asarray(stream.p),
                             height=cfg.img_h, width=cfg.img_w)
    want = np.asarray(jproj.project_and_label(
        jnp.asarray(frame.points), jnp.asarray(frame.label_img), jcal,
        backend="ref"))
    assert want.any()
    pts = _unaligned(frame.points) if unaligned else _t(frame.points)
    got = pp_ops.project_and_label(pts, _t(stream.tr), _t(stream.p),
                                   _t(frame.label_img))
    assert got.dtype == torch.int32 and got.shape == (len(frame.points),)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The package around the kernels
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_launch_a_kernel():
    kernels.reset_launch_counts()
    pts, tr, p, lab = _proj_inputs(100, 48, 160, 0)
    ops.project_and_label(_t(pts), _t(tr), _t(p), _t(lab))
    ops.point_proj(_t(pts), _t(tr), _t(p), 48, 160)
    ops.iou2d(_t(_boxes(np.random.default_rng(0), 3)),
              _t(_boxes(np.random.default_rng(1), 4)))
    au_ops.auction(torch.zeros((2, 5, 5)))
    au_ops.auction(torch.zeros((1, au_ops.ROW_MAX_N + 2,
                                au_ops.ROW_MAX_N + 2)))
    assert kernels.launch_counts() == {"point_proj": 0,
                                       "point_proj_labels": 0, "iou2d": 0,
                                       "ransac_score": 0,
                                       "flash_attention": 0,
                                       "flash_attention_tc": 0,
                                       "flash_attention_bwd": 0,
                                       "flash_attention_bwd_tc": 0,
                                       "decode_attention": 0,
                                       "decode_attention_bwd": 0,
                                       "mla_decode_attention": 0,
                                       "pillar_scatter": 0,
                                       "pillar_scatter_bwd": 0,
                                       "auction": 0, "auction_wide": 0}


def test_other_devices_raise():
    meta = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        iou_ops.iou2d(meta, meta)


def test_cuda_request_without_a_card_raises():
    from repro_torch import api, device
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Session(api.scenario("smoke"))


def test_wrappers_import_without_nvcc():
    """Importing the wrappers builds nothing: a fresh interpreter imports
    them with PATH emptied (no nvcc) and no library is loaded."""
    code = ("import sys; sys.path.insert(0, 'src');"
            "from repro_torch import kernels, ops;"
            "from repro_torch.kernels import _build;"
            "assert _build.load.cache_info().currsize == 0;"
            "print(sorted(kernels.launch_counts()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PATH": "", "PYTHONPATH": "src"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "point_proj" in out.stdout


def test_build_names_every_source_and_raises_without_nvcc(monkeypatch):
    from repro_torch.kernels import _build
    names = {p.name for p in _build.CSRC.iterdir()}
    assert set(_build.SOURCES) | set(_build.HEADERS) == names
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.library_path().parent == _build.BUILD_DIR
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel equals its plain version on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    pts, valid, nrm, off = _ransac_inputs(12, 256, 30)
    args = [_t(x).to(dev) for x in (pts, valid, nrm, off)]
    assert torch.equal(rs_ops.ransac_score(*args, 0.1),
                       rs_ref.ransac_score_ref(*args, 0.1))
    rng = np.random.default_rng(0)
    for n, m in ((24, 12), (33, 33)):
        a, b = _t(_boxes(rng, n)).to(dev), _t(_boxes(rng, m)).to(dev)
        assert torch.equal(iou_ops.iou2d(a, b), iou_ref.iou2d_ref(a, b))
    pts, tr, p, lab = _proj_inputs(5001, 375, 1242, 1)
    tr, p, lab = (_t(x).to(dev) for x in (tr, p, lab))
    for pts_t in (_t(pts).to(dev), _unaligned(pts, dev)):
        want = pp_ref.point_proj_ref(pts_t, tr, p, 375, 1242, lab)
        for g, w in zip(pp_ops.point_proj(pts_t, tr, p, 375, 1242), want):
            assert torch.equal(g, w)
        assert torch.equal(pp_ops.project_and_label(pts_t, tr, p, lab),
                           want[4])


@pytest.mark.cuda
def test_stream_axis_kernels_match_plain_on_card():
    """K1's labels instance and K2 with a stream axis, on the card: equal
    to their plain versions and, stream by stream, to the 2-D kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    for s_n, n, m in ((1, 24, 12), (3, 7, 13), (64, 12, 6)):
        a = _t(np.stack([_boxes(rng, n) for _ in range(s_n)])).to(dev)
        b = _t(np.stack([_boxes(rng, m) for _ in range(s_n)])).to(dev)
        got = iou_ops.iou2d(a, b)
        assert torch.equal(got, iou_ref.iou2d_ref(a, b))
        for s in range(s_n):
            assert torch.equal(got[s], iou_ops.iou2d(a[s], b[s]))
    for s_n, n in ((1, 5001), (3, 4099), (16, 2048)):
        ins = [_proj_inputs(n, 375, 1242, s) for s in range(s_n)]
        pts = _t(np.stack([x[0] for x in ins])).to(dev)
        lab = _t(np.stack([x[3] for x in ins])).to(dev)
        tr, p = _t(ins[0][1]).to(dev), _t(ins[0][2]).to(dev)
        got = pp_ops.project_and_label(pts, tr, p, lab)
        assert torch.equal(got, pp_ref.point_proj_ref(pts, tr, p, 375, 1242,
                                                      lab)[4])
        for s in range(s_n):
            assert torch.equal(got[s], pp_ops.project_and_label(
                pts[s], tr, p, lab[s]))

"""``anchor_step`` / ``transform_step`` of the port against the JAX package,
frame by frame over a recorded ``smoke`` tape.

Before every frame the JAX state is carried across into the port with
``repro_torch.convert``, so each frame is compared from the same state:
``valid`` and ``det_to_track`` exact, ``boxes3d`` within the golden
tolerance (rtol 1e-4, atol 1e-5), and the next state likewise.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import scenario as jscenario  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro.core import transform as jtransform  # noqa: E402
from repro.serving import tape as jtape  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import projection, transform  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

FRAMES = 16
ANCHORS = (0, 9)          # the smoke golden's anchor frames
RTOL, ATOL = 1e-4, 1e-5


def _numpy_state(state):
    """A JAX MobyState as numpy leaves, its typed key as key_data words."""
    state = state._replace(key=jax.random.key_data(state.key))
    return jax.tree_util.tree_map(np.asarray, state)


def _t(a):
    return convert.to_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def frames():
    """Run the JAX steps over the tape; keep each frame's input state,
    output and next state (as numpy)."""
    scn = jscenario("smoke", seed=0)
    cfg = scn.scene
    tape = jtape.record_stream_tape(cfg, scn.detector, FRAMES, seed=0)
    from repro.data import scenes
    tr, p = scenes.make_calibration(cfg)
    calib = jproj.Calibration(tr=jax.numpy.asarray(tr),
                              p=jax.numpy.asarray(p), height=cfg.img_h,
                              width=cfg.img_w)
    params = jtransform.TransformParams(backend="ref")
    anchor = jax.jit(jtransform.anchor_step, static_argnames=("params",))
    step = jax.jit(jtransform.transform_step, static_argnames=("params",))
    state = jtransform.init_state(2 * cfg.max_obj, jax.random.key(0))
    out = []
    for t in range(FRAMES):
        f = tape.frame(t)
        before = _numpy_state(state)
        if t in ANCHORS:
            state, o = anchor(state, f.det3d, f.val3d, calib, params=params)
        else:
            state, o = step(state, f.points, f.det2d, f.val2d, f.label_img,
                            calib, params=params)
        out.append((t, f, before, jax.tree_util.tree_map(np.asarray, o),
                    _numpy_state(state)))
    return calib, out


def _close(got, want, what):
    got = convert.to_numpy(got)
    for name, g, w in zip(want._fields, got, want):
        if isinstance(w, tuple):
            _close(g, w, f"{what}.{name}")
        elif np.asarray(w).dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("t", range(FRAMES))
def test_step_matches_jax(frames, t):
    jcal, out = frames
    _, f, before, want_out, want_state = out[t]
    calib = projection.Calibration(_t(jcal.tr), _t(jcal.p), jcal.height,
                                   jcal.width)
    state = convert.from_jax(before)
    if t in ANCHORS:
        state, got = transform.anchor_step(state, _t(f.det3d), _t(f.val3d),
                                           calib)
    else:
        state, got = transform.transform_step(
            state, _t(f.points), _t(f.det2d), _t(f.val2d), _t(f.label_img),
            calib)
    np.testing.assert_array_equal(got.valid.numpy(), want_out.valid)
    np.testing.assert_array_equal(got.det_to_track.numpy(),
                                  want_out.det_to_track)
    _close(got, want_out, f"frame {t} output")
    _close(state, want_state, f"frame {t} state")


def test_tape_exercises_the_path(frames):
    """The comparison is not vacuous: transform frames produce valid boxes
    and associations."""
    _, out = frames
    transform_frames = [o for o in out if o[0] not in ANCHORS]
    assert sum(int(o[3].valid.sum()) for o in transform_frames) > 10
    assert sum(int((o[3].det_to_track >= 0).sum())
               for o in transform_frames) > 10


def test_fused_step_branches(frames):
    """``fused_step`` with a host bool takes the matching branch."""
    jcal, out = frames
    calib = projection.Calibration(_t(jcal.tr), _t(jcal.p), jcal.height,
                                   jcal.width)
    for t in (0, 1):
        _, f, before, want_out, _ = out[t]
        _, got = transform.fused_step(
            convert.from_jax(before), _t(f.points), _t(f.det2d),
            _t(f.val2d), _t(f.label_img), _t(f.det3d), _t(f.val3d),
            t in ANCHORS, calib)
        _close(got, want_out, f"fused frame {t}")


def test_convert_rejects_unknown_and_drops_backend():
    params = convert.from_jax(jtransform.TransformParams(backend="pallas"))
    assert isinstance(params, transform.TransformParams)
    assert "backend" not in params._fields
    assert params.ransac == transform.TransformParams().ransac
    with pytest.raises(TypeError, match="cannot convert"):
        convert.to_tensor(np.array(["a"]))
    from typing import NamedTuple

    class Unknown(NamedTuple):
        x: int = 0
    with pytest.raises(TypeError, match="no port counterpart"):
        convert.from_jax(Unknown())

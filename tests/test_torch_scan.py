"""The port's fleet scan mode and its auction against the JAX package.

Compared here, on the same seeded inputs, on the CPU (plain versions):

* the auction's plain version (``kernels/auction/ref.py``) against
  ``repro.core.association``: the assignment of ``auction_assign`` and the
  final prices of its phases, exactly, over a batch axis (``jax.vmap``);
* ``onboard_time_vec`` against JAX's, exactly;
* the scan body's network and cloud model frame by frame against JAX's
  scan: both bodies driven by one scripted fleet step (the frame's
  decisions and detection counts come from the inputs; the packed row
  carries the test arrivals, i.e. the clocks ``walls`` against
  ``inflight_at``, and the telemetry, i.e. the trace index), so the trace
  index, the uplink share over ``n_up``, the pool's ``busy`` and ``rr``
  and the round trips show in every row, exactly;
* ``FleetEngine.run_scan`` against JAX's on ``fleet-16-congested`` and
  ``fleet-64-mixed`` (a 4-GPU pool), ``Session("smoke").run(scan=True)``
  (the S=1 slice), a ``moby_onboard`` and a ``use_fos=False`` case:
  ``stream``, ``frame``, ``kind`` and ``device`` exact, floats within rtol
  1e-4, atol 1e-5;
* ``fleet-256-congested``'s scan against its golden CSV's exact columns
  and modelled times (its accuracy columns drift with today's JAX, ROADMAP
  R1);
* the port's scan against its orchestrated run at S=1.

The auction kernel and the CUDA graph of the scan run only on a card
(``cuda``-marked tests here; ``python3 chip_smoke.py`` holds both there).
"""
import csv
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.core import association as jassoc  # noqa: E402
from repro.fleet import step as jstep  # noqa: E402
from repro.runtime import profiles as jprofiles  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import association  # noqa: E402
from repro_torch.fleet import FleetEngine  # noqa: E402
from repro_torch.fleet import step as step_lib  # noqa: E402
from repro_torch.kernels.auction import ops as au_ops  # noqa: E402
from repro_torch.kernels.auction import ref as au_ref  # noqa: E402
from repro_torch.runtime import profiles  # noqa: E402
from repro_torch.serving import tape  # noqa: E402
from repro_torch.data import scenes  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-4, 1e-5
EXACT = ("stream", "frame", "kind", "scenario", "policy", "device")
FLOATS = ("latency_s", "onboard_s", "f1", "precision", "recall")
GOLDEN_256 = pathlib.Path(__file__).parent / "goldens" \
    / "fleet-256-congested-scan.csv"


def _rows(text):
    return list(csv.DictReader(io.StringIO(text)))


def _assert_reports_match(got_csv, want_csv, floats=FLOATS, exact=EXACT):
    got, want = _rows(got_csv), _rows(want_csv)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        where = f"stream {w['stream']} frame {w['frame']}"
        for k in exact:
            assert g[k] == w[k], f"{where}: {k} {g[k]!r} != {w[k]!r}"
        for k in floats:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{where}: {k}")


# ---------------------------------------------------------------------------
# The auction
# ---------------------------------------------------------------------------


def _benefits(n, batch, seed, tied):
    """Benefits on the association's 1e-3 grid: 20 levels (many exact
    ties) or 1000, with a zero row and column (invalid pairs)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 20 if tied else 1000, (batch, n, n)) \
        * np.float32(1e-3)
    if n > 2:
        b[:, rng.integers(n), :] = 0.0
        b[:, :, rng.integers(n)] = 0.0
    return b.astype(np.float32)


@jax.jit
@jax.vmap
def _jax_auction(benefit):
    """``auction_assign``'s phases, keeping the final prices too."""
    n = benefit.shape[0]
    prices = jnp.zeros((n,), benefit.dtype)
    for eps in au_ref.phase_epsilons(1e-4):
        p2o, _, prices = jassoc._auction_phase(benefit, prices, eps, 4000)
    return p2o, prices, jassoc.auction_assign(benefit)


@pytest.mark.parametrize("n,batch", [(1, 3), (2, 4), (5, 6), (12, 8),
                                     (24, 4), (40, 2)])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "fine"])
def test_plain_auction_matches_jax(n, batch, tied):
    b = _benefits(n, batch, 10 * n + batch, tied)
    p2o, prices, rounds = au_ref.auction_ref(torch.from_numpy(b))
    want_p2o, want_prices, assigned = map(np.asarray, _jax_auction(b))
    np.testing.assert_array_equal(want_p2o, assigned)
    np.testing.assert_array_equal(p2o.numpy(), want_p2o)
    np.testing.assert_array_equal(prices.numpy().view(np.int32),
                                  want_prices.view(np.int32))
    assert rounds.dtype == torch.int32 and rounds.shape == (batch,)
    # At least one round a phase; every auction assigns a permutation.
    assert (rounds.numpy() >= len(au_ref.phase_epsilons(1e-4))).all()
    assert (np.sort(p2o.numpy(), -1) == np.arange(n)).all()
    # association.auction_assign returns the assignment alone.
    assert torch.equal(association.auction_assign(torch.from_numpy(b)), p2o)


def test_phase_epsilons_step_as_auction_assign():
    assert au_ref.phase_epsilons(1e-4) == [0.1, 0.01, 0.001, 0.0001]
    assert au_ref.phase_epsilons(0.1) == [0.1]
    assert au_ref.phase_epsilons(0.05) == [0.1, 0.05]


def test_auction_wrapper_on_the_cpu_is_the_plain_version():
    from repro_torch import kernels
    kernels.reset_launch_counts()
    b = torch.from_numpy(_benefits(12, 3, 0, True))
    for g, w in zip(au_ops.auction(b), au_ref.auction_ref(b)):
        assert torch.equal(g, w)
    assert kernels.launch_counts()["auction"] == 0
    with pytest.raises(ValueError, match="no implementation"):
        au_ops.auction(torch.zeros((2, 2), device="meta"))


def test_auction_instance_and_refusals():
    """Every n from 1 to ROW_MAX_N runs on the smallest row instance that
    takes it (32 x warps persons), n above on the wide instance
    (tests/test_torch_auction.py holds its bound); the kernel's limits
    raise before a launch."""
    for n in range(1, au_ops.ROW_MAX_N + 1):
        batch, got_n, eps, warps, tier = au_ops.plan((2, 3, n, n),
                                                     torch.float32, 1e-4)
        assert (batch, got_n, eps) == (6, n, au_ref.phase_epsilons(1e-4))
        assert tier is None
        assert warps in au_ops.WARPS and n <= 32 * warps
        assert warps == 1 or n > 16 * warps
    assert au_ops.ROW_MAX_N == 128
    assert au_ops.plan((1, 129, 129), torch.float32, 1e-4)[3] == \
        au_ops.WIDE_WARPS
    with pytest.raises(ValueError, match="persons"):
        au_ops.plan((1, 0, 0), torch.float32, 1e-4)
    with pytest.raises(ValueError, match="persons"):
        au_ops.plan((1, 20000, 20000), torch.float32, 1e-4)
    with pytest.raises(ValueError, match="phases"):
        au_ops.plan((1, 4, 4), torch.float32, 1e-9)
    assert len(au_ref.phase_epsilons(1e-9)) > au_ops.MAX_PHASES
    with pytest.raises(TypeError, match="dtype"):
        au_ops.plan((1, 4, 4), torch.float64, 1e-4)
    with pytest.raises(ValueError, match="shape"):
        au_ops.plan((4, 5), torch.float32, 1e-4)


@pytest.mark.cuda
def test_auction_kernel_matches_plain_on_card():
    """The kernel equals its plain version bit for bit (assignment,
    prices, rounds) on the same card tensors, on each side of the lane and
    warp boundaries and with every row equal (all persons bid on one
    object), and refuses what it does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    cases = [(_benefits(n, batch, n, tied), n) for n, batch, tied in (
        (1, 4, True), (12, 16, True), (24, 64, False), (31, 8, True),
        (32, 8, False), (33, 8, True), (40, 8, True), (64, 4, True),
        (au_ops.ROW_MAX_N, 2, True))]
    for n, batch in ((24, 16), (33, 4), (au_ops.ROW_MAX_N, 1)):
        b = _benefits(n, batch, 7 * n, True)
        cases.append((np.repeat(b[:, :1], n, axis=1), n))
    for b, n in cases:
        b = torch.from_numpy(np.ascontiguousarray(b)).to(dev)
        got, want = au_ops.auction(b), au_ref.auction_ref(b)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), n
    with pytest.raises(ValueError, match="persons"):
        au_ops.auction(torch.zeros((1, 20000, 20000), device=dev))
    with pytest.raises(TypeError, match="dtype"):
        au_ops.auction(torch.zeros((1, 4, 4), dtype=torch.float64,
                                   device=dev))


# ---------------------------------------------------------------------------
# The scan body's network and cloud model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["jetson_tx2", "jetson_orin",
                                    ["tx2", "orin", "orin"]],
                         ids=["tx2", "orin", "mixed"])
@pytest.mark.parametrize("use_tba,use_fos", [(True, True), (False, True),
                                             (True, False)])
def test_onboard_time_vec_matches_jax(device, use_tba, use_fos):
    rng = np.random.default_rng(0)
    s_n = 3
    n_assoc = rng.integers(0, 12, s_n).astype(np.float32)
    n_new = rng.integers(0, 12, s_n).astype(np.float32)
    want = jstep.onboard_time_vec(
        jprofiles.component_times_vector(
            jprofiles.profile_vector(device, s_n)),
        jnp.asarray(n_assoc), jnp.asarray(n_new), use_tba, use_fos)
    got = step_lib.onboard_time_vec(
        profiles.component_times_vector(profiles.profile_vector(device, s_n)),
        torch.from_numpy(n_assoc), torch.from_numpy(n_new), use_tba, use_fos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_scripted(state, inp, test_arrived, t, calib, params, sparams,
                  use_fos):
    """One stream's scripted step: the frame's decisions and counts come
    from the inputs; the state passes through."""
    is_anchor = inp.val2d[0]
    send_test = inp.val2d[1] & ~is_anchor
    packed = jnp.stack([
        is_anchor.astype(jnp.float32), send_test.astype(jnp.float32),
        test_arrived.astype(jnp.float32), state.sched.bw_mbps,
        state.sched.offload_cost_s, inp.det2d[0, 0], inp.det2d[0, 1]])
    return state, packed


def _torch_scripted(calib, params, sparams, use_fos=True):
    def step(state, inp, test_arrived, t):
        is_anchor = inp.val2d[:, 0]
        send_test = inp.val2d[:, 1] & ~is_anchor
        packed = torch.stack([
            is_anchor.float(), send_test.float(), test_arrived.float(),
            state.sched.bw_mbps, state.sched.offload_cost_s,
            inp.det2d[:, 0, 0], inp.det2d[:, 0, 1]], -1)
        return state, packed
    return step


def _script(s_n, frames, seed):
    """Seeded per-frame decisions (anchors ~15%, tests ~10%) and counts
    (0-12 valid detections, of them 0 to all associated) as inputs."""
    rng = np.random.default_rng(seed)
    val2d = np.stack([rng.uniform(size=(frames, s_n)) < 0.15,
                      rng.uniform(size=(frames, s_n)) < 0.1], -1)
    n_valid = rng.integers(0, 13, (frames, s_n))
    n_assoc = np.minimum(rng.integers(0, 14, (frames, s_n)), n_valid + 1)
    det2d = np.zeros((frames, s_n, 1, 4), np.float32)
    det2d[..., 0, 0], det2d[..., 0, 1] = n_assoc, n_valid

    def z(*shape, dtype=np.float32):
        return np.zeros((frames, s_n) + shape, dtype)
    return dict(points=z(1, 3), det2d=det2d, val2d=val2d,
                label_img=z(1, 1, dtype=np.int32), det3d=z(1, 7),
                val3d=z(1, dtype=bool), gt_boxes=z(1, 7),
                gt_visible=z(1, dtype=bool))


@pytest.mark.parametrize("name,frames,overrides", [
    ("fleet-16-congested", 160, {}),
    ("fleet-64-mixed", 160, {}),
    ("fleet-16-congested", 100, {"mode": "moby_onboard"}),
    ("fleet-16-congested", 100, {"use_fos": False}),
    ("smoke", 160, {})],
    ids=["fleet-16-congested", "fleet-64-mixed", "moby-onboard", "no-fos",
         "smoke-s1"])
def test_scan_body_matches_jax_frame_by_frame(monkeypatch, name, frames,
                                              overrides):
    """Every packed column of every frame bit for bit: the decisions, the
    test arrivals (walls >= inflight_at), the telemetry's bandwidth share
    (the trace index) and offload cost, and the latencies (the uplink
    share over n_up, the pool's busy clocks and round-robin pointer)."""
    monkeypatch.setattr(jstep, "_stream_step", _jax_scripted)
    monkeypatch.setattr(step_lib, "make_fleet_step", _torch_scripted)
    jses = japi.Session(japi.scenario(name, backend="ref", **overrides))
    tses = api.Session(api.scenario(name, **overrides), torch_device="cpu")
    jeng, teng = jses._fleet(1), tses._fleet(1)
    if name != "smoke":
        jeng, teng = jses.engine, tses.engine
    script = _script(teng.n_streams, frames, seed=frames)
    _, want = jeng._scan_fn()(
        jeng._init_state(),
        jstep.FrameInputs(**{k: jnp.asarray(v) for k, v in script.items()}),
        frames)
    _, got = teng._scan_fn().run(
        teng._init_state(),
        step_lib.FrameInputs(**{k: torch.from_numpy(v)
                                for k, v in script.items()}), frames)
    want, got = np.asarray(want), got.numpy()
    assert got.shape == want.shape == (frames, teng.n_streams, 9)
    for col in range(9):
        bad = np.argwhere(got[..., col] != want[..., col])
        assert not len(bad), (col, bad[:4].tolist())
    # The run exercised the model: anchors, tests that arrived, queueing.
    assert got[..., 0].any() and got[..., 2].any()


# ---------------------------------------------------------------------------
# run_scan end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,frames,overrides", [
    ("fleet-16-congested", 8, {}),
    ("fleet-64-mixed", 6, {}),
    ("smoke", 16, {}),
    ("fleet-16-congested", 6, {"mode": "moby_onboard"}),
    ("fleet-16-congested", 6, {"use_fos": False})],
    ids=["fleet-16-congested", "fleet-64-mixed", "smoke-s1", "moby-onboard",
         "no-fos"])
def test_run_scan_matches_jax(name, frames, overrides):
    """Live JAX scans (``backend="ref"``) through the facade; ``smoke``
    is the lazily built S=1 fleet slice."""
    want = japi.Session(japi.scenario(name, backend="ref", **overrides)) \
        .run(frames, scan=True).to_csv()
    session = api.Session(api.scenario(name, **overrides),
                          torch_device="cpu")
    got = session.run(frames, scan=True)
    _assert_reports_match(got.to_csv(), want)
    assert isinstance(session._scan_engine, FleetEngine)
    assert session._scan_engine.n_streams == (1 if name == "smoke" else
                                              session.n_streams)
    assert {"anchor", "transform"} <= set(got.kind.ravel())


def test_fleet_256_scan_matches_golden_times():
    """The scan golden's exact columns and modelled times; its F1,
    precision and recall drift from today's JAX engine (ROADMAP R1), so
    they are held by the live comparisons above instead."""
    got = api.Session(api.scenario("fleet-256-congested"),
                      torch_device="cpu").run(4, scan=True).to_csv()
    _assert_reports_match(got, GOLDEN_256.read_text(),
                          floats=("latency_s", "onboard_s"))


def test_scan_matches_orchestrated_decisions():
    """At S=1 the scan takes the orchestrated run's decisions and gives
    its accuracy (``tests/test_fleet.py``'s invariant)."""
    cfg = scenes.SceneConfig(max_obj=6, n_points=1024, img_h=48, img_w=160,
                             mean_objects=3, density_scale=4000.0, seed=5)
    t = tape.record_stream_tape(cfg, "pointpillar", 16, seed=5)
    fleet = FleetEngine(cfg, "pointpillar", n_streams=1, seed=5, tapes=[t],
                        torch_device="cpu")
    orch, scan = fleet.run(16), fleet.run_scan(16)
    assert orch.kinds(0) == scan.kinds(0)
    assert {"anchor", "test", "transform"} <= set(scan.kinds(0))
    np.testing.assert_allclose(orch.f1[0], scan.f1[0], atol=1e-5)
    assert set(fleet.scan_timing) == {"tape_s", "run_s"}


def test_scan_modes_raise_and_default_to_the_card():
    """A baseline mode has no fleet to scan (``ValueError``, as in JAX);
    the scan runs on the card unless the CPU is asked for."""
    s = api.Session(api.scenario("fleet-16-congested", mode="edge_only"),
                    torch_device="cpu")
    with pytest.raises(ValueError, match="moby modes"):
        s.run(2, scan=True)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cfg = scenes.SceneConfig(max_obj=4, n_points=256, img_h=32, img_w=104)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetEngine(cfg, "pointpillar", n_streams=2).run_scan(2)

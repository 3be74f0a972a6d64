"""The port's K4 ``pillar_scatter`` (forward and gradient) against the JAX
package's.

On the CPU the wrapper runs its plain versions (``kernels/pillar_scatter/
ref.py``): the forward is held to ``repro``'s ``ref.py`` oracle and to the
Pallas kernel in interpret mode, value for value (a max is exact); the
gradient, through the port's ``autograd.Function``, to ``jax.grad``
through ``repro.ops.pillar_scatter`` with the ``ref`` and the ``pallas``
backends (their shared VJP splits a pillar's cotangent among its tied
maxima), within rtol = atol = 1e-6 — and, where counted ties meet random
cotangents, bit for bit. ``test_card_cases_equal_jax_ref`` holds the plain
forward to JAX's oracle on the inputs of the card checks' special values,
one-pillar, sorted and 40-channel cases, and
``test_card_cases_gradient_matches_jax_grad`` the gradient on all but the
special values (XLA flushes subnormals). The CUDA kernels run only on a card:
``test_kernels_match_plain_on_card`` is marked ``cuda`` and skips without
one (``python3 chip_smoke.py`` holds them to these plain versions there).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import ops as jops  # noqa: E402
from repro.kernels.pillar_scatter import ops as jps_ops  # noqa: E402
from repro.kernels.pillar_scatter import ref as jps_ref  # noqa: E402
from repro_torch import kernels, ops  # noqa: E402
from repro_torch.kernels.pillar_scatter import ops as ps_ops  # noqa: E402
from repro_torch.kernels.pillar_scatter import ref as ps_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-6, atol=1e-6)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _inputs(n, c, g, seed, ties=False, p_valid=0.9):
    """Seeded features, ids in [0, G) and a mask. With ``ties`` the
    features are ReLU'd and rounded to one decimal, so most pillar
    channels hold several equal maxima (zeros among them)."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, c)).astype(np.float32)
    if ties:
        f = np.maximum(f, 0.0).round(1).astype(np.float32)
    idx = rng.integers(0, g, n).astype(np.int32)
    valid = rng.uniform(size=n) < p_valid
    return f, idx, valid


# (N, C, G) of tests/test_kernels.py, then tied and small cases.
SHAPES = [(256, 8, 512, False), (1000, 64, 1024, False),
          (4096, 32, 2048, False), (2000, 32, 64, True), (64, 8, 4, True)]


@pytest.mark.parametrize("n,c,g,ties", SHAPES)
def test_forward_equals_jax_ref_and_pallas(n, c, g, ties):
    f, idx, valid = _inputs(n, c, g, n + c + g, ties)
    got = ops.pillar_scatter(_t(f), _t(idx), _t(valid), g).numpy()
    want_ref = np.asarray(jps_ref.pillar_scatter_ref(
        jnp.asarray(f), jnp.asarray(idx), jnp.asarray(valid), g))
    want_pallas = np.asarray(jps_ops.pillar_scatter(
        jnp.asarray(f), jnp.asarray(idx), jnp.asarray(valid), g,
        interpret=True))
    assert got.shape == (g, c) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


def test_forward_drops_ids_outside_the_grid():
    """Valid points with ids < 0 or >= G are dropped, as in the Pallas
    kernel (JAX's ``ref.py`` wraps a negative id to G-1 instead; no caller
    passes one: ``pillarize`` gives -1 only to points it masks out)."""
    f, idx, valid = _inputs(512, 16, 32, 7)
    idx[::5] = -1
    idx[1::7] = 32
    idx[2::11] = 1000
    valid[:] = True
    got = ops.pillar_scatter(_t(f), _t(idx), _t(valid), 32).numpy()
    want = np.asarray(jps_ops.pillar_scatter(
        jnp.asarray(f), jnp.asarray(idx), jnp.asarray(valid), 32,
        interpret=True))
    np.testing.assert_array_equal(got, want)
    kept = (idx >= 0) & (idx < 32)
    np.testing.assert_array_equal(
        got, ps_ref.pillar_scatter_ref(_t(f[kept]), _t(idx[kept]),
                                       _t(valid[kept]), 32).numpy())


def _port_grad(f, idx, valid, g, ct):
    x = _t(f).clone().requires_grad_()
    out = ops.pillar_scatter(x, _t(idx), _t(valid), g)
    out.backward(_t(ct))
    return x.grad.numpy()


def _jax_grad(f, idx, valid, g, ct, backend):
    def loss(x):
        return jnp.sum(jops.pillar_scatter(x, jnp.asarray(idx),
                                           jnp.asarray(valid), g,
                                           backend=backend) * ct)
    return np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(f)))


def _grad_case(name):
    """(feats, ids, mask, G, cotangent) of one named case."""
    if name == "two-tied-points":
        # Three points in one pillar: two tie on both channels.
        f = np.array([[1, 0], [1, 0], [0.5, -1]], np.float32)
        return (f, np.zeros(3, np.int32), np.ones(3, bool), 2,
                np.array([[1, 10], [0, 0]], np.float32))
    n, c, g = {"random": (1000, 16, 128), "ties": (3000, 32, 64),
               "relu-zeros": (500, 8, 16), "all-invalid": (300, 8, 32),
               "dropped-ids": (800, 16, 64)}[name]
    f, idx, valid = _inputs(n, c, g, len(name), ties=name != "random")
    if name == "relu-zeros":
        f[:, :4] = 0.0                 # whole channels of tied zeros
    if name == "all-invalid":
        valid[:] = False
    if name == "dropped-ids":
        idx[::3] = g + np.arange(len(idx[::3])) % 5
    ct = np.random.default_rng(n).normal(size=(g, c)).astype(np.float32)
    return f, idx, valid, g, ct


GRAD_CASES = ["two-tied-points", "random", "ties", "relu-zeros", "all-invalid",
              "dropped-ids"]


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradient_matches_jax_grad(name, backend):
    f, idx, valid, g, ct = _grad_case(name)
    got = _port_grad(f, idx, valid, g, ct)
    want = _jax_grad(f, idx, valid, g, ct, backend)
    np.testing.assert_allclose(got, want, **TOL)
    if name == "two-tied-points":
        np.testing.assert_array_equal(got, [[0.5, 5], [0.5, 5], [0, 0]])
    if name == "all-invalid":
        assert not got.any()


def test_gradient_is_bitwise_jax_on_counted_ties():
    """Pillars with 1..9 tied points and random cotangents: ct * (1/count)
    is not always ct / count; the port takes the former, as JAX does."""
    rng = np.random.default_rng(3)
    counts = np.arange(1, 10)
    idx = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    f = np.ones((len(idx), 4), np.float32)
    ct = rng.normal(size=(len(counts), 4)).astype(np.float32)
    valid = np.ones(len(idx), bool)
    got = _port_grad(f, idx, valid, len(counts), ct)
    want = _jax_grad(f, idx, valid, len(counts), ct, "ref")
    np.testing.assert_array_equal(got, want)
    divided = ct[idx] / counts[idx][:, None].astype(np.float32)
    assert (divided != want).any()


def test_argmax_only_gradient_fails_the_check():
    """The tolerance has teeth: a gradient sent only to the first point
    attaining the maximum misses JAX's on tied pillars."""
    f, idx, valid, g, ct = _grad_case("ties")
    want = _jax_grad(f, idx, valid, g, ct, "ref")
    out = ps_ref.pillar_scatter_ref(_t(f), _t(idx), _t(valid), g).numpy()
    argmax_only = np.zeros_like(f)
    taken = np.zeros((g, f.shape[1]), bool)
    for p in np.flatnonzero(valid):
        hit = (f[p] == out[idx[p]]) & ~taken[idx[p]]
        argmax_only[p][hit] = ct[idx[p]][hit]
        taken[idx[p]] |= hit
    assert not np.allclose(argmax_only, want, **TOL)


def test_infinite_maximum_reads_zero_and_passes_no_gradient():
    """A pillar whose maximum is +inf reads 0 (JAX's where(isfinite)), and
    no point of it, not even one holding 0, takes gradient."""
    f = np.array([[np.inf, 1], [0, 2], [3, -np.inf], [-np.inf, -np.inf]],
                 np.float32)
    idx = np.array([0, 0, 1, 2], np.int32)
    valid = np.ones(4, bool)
    ct = np.arange(1, 7, dtype=np.float32).reshape(3, 2)
    out = ops.pillar_scatter(_t(f), _t(idx), _t(valid), 3).numpy()
    np.testing.assert_array_equal(out, [[0, 2], [3, 0], [0, 0]])
    np.testing.assert_array_equal(_port_grad(f, idx, valid, 3, ct),
                                  _jax_grad(f, idx, valid, 3, ct, "ref"))


def test_ids_and_mask_take_no_gradient_and_cpu_launches_nothing():
    kernels.reset_launch_counts()
    f, idx, valid = _inputs(100, 8, 16, 1)
    x = _t(f).clone().requires_grad_()
    out = ops.pillar_scatter(x, _t(idx), _t(valid), 16)
    assert out.grad_fn is not None
    out.sum().backward()
    assert x.grad is not None
    counts = kernels.launch_counts()
    assert counts["pillar_scatter"] == counts["pillar_scatter_bwd"] == 0


def test_other_devices_raise():
    meta = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ps_ops.pillar_scatter(meta, torch.zeros(4, dtype=torch.int32,
                                                device="meta"),
                              torch.ones(4, dtype=torch.bool, device="meta"),
                              8)


def _card_case(name):
    """(feats, ids, mask, G, cotangent) of the card checks' cases beyond
    ``GRAD_CASES``: ``specials`` (``chip_smoke.pillar_special_inputs``:
    +-0, +-inf, NaN of either sign, subnormals, all-negative pillars, a
    pillar of -inf only, an id at G - 1), ``one-pillar`` (every kept point
    in one pillar), ``sorted`` (points sorted by pillar) and ``rows-c40``
    (40 channels: the backward kernel's second mask word partial)."""
    if name == "specials":
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      ROOT / "chip_smoke.py")
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        f, idx, valid, g = chip_smoke.pillar_special_inputs(np)
    elif name == "rows-c40":
        f, idx, valid = _inputs(4096, 40, 512, 13)
        g = 512
    else:
        f, idx, valid = _inputs(4096, 32, 512, 11)
        g = 512
        if name == "one-pillar":
            idx[:] = g // 3
        else:
            order = np.argsort(idx, kind="stable")
            f, idx, valid = f[order], idx[order], valid[order]
    ct = np.random.default_rng(5).normal(size=(g, f.shape[1]))
    return f, idx, valid, g, ct.astype(np.float32)


CARD_CASES = ["specials", "one-pillar", "sorted", "rows-c40"]


@pytest.mark.parametrize("name", CARD_CASES)
def test_card_cases_equal_jax_ref(name):
    """The plain forward equals JAX's oracle value for value on the card
    checks' cases, except that XLA's CPU backend flushes subnormal values
    to zero (as a TPU does) where the port, like the card, keeps them."""
    f, idx, valid, g, _ = _card_case(name)
    got = ops.pillar_scatter(_t(f), _t(idx), _t(valid), g).numpy()
    want = np.asarray(jps_ref.pillar_scatter_ref(
        jnp.asarray(f), jnp.asarray(idx), jnp.asarray(valid), g))
    subnormal = (got != 0) & (np.abs(got) < np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(np.where(subnormal, 0.0, got), want)
    assert subnormal.any() == (name == "specials")
    if name == "specials":   # -inf only: 0; subnormals and zeros only: kept
        assert not got[8].any() and got[9].any()
        assert (got[:8] <= 0).all() and got[g - 1].any()


@pytest.mark.parametrize("name", ["one-pillar", "sorted", "rows-c40"])
def test_card_cases_gradient_matches_jax_grad(name):
    """The gradient on the card checks' cases, against ``jax.grad``
    through the ``ref`` backend (the VJP is the one the ``pallas`` backend
    shares). ``specials`` is left out: XLA flushes its subnormal maxima to
    zero, so the two sides tie on different values
    (``test_card_cases_equal_jax_ref``)."""
    f, idx, valid, g, ct = _card_case(name)
    got = _port_grad(f, idx, valid, g, ct)
    want = _jax_grad(f, idx, valid, g, ct, "ref")
    np.testing.assert_allclose(got, want, **TOL)
    assert got.any()


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Forward equal by value, backward bit for bit, on card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    for name in GRAD_CASES + CARD_CASES:
        case = _card_case(name) if name in CARD_CASES else _grad_case(name)
        f, idx, valid, g, ct = (
            _t(a).to(dev) if not isinstance(a, int) else a for a in case)
        out = ps_ops.pillar_scatter(f, idx, valid, g)
        want = ps_ref.pillar_scatter_ref(f, idx, valid, g)
        assert torch.equal(out, want), name
        got = ps_ops.pillar_scatter_bwd(f, idx, valid, out, ct)
        ref = ps_ref.pillar_scatter_bwd_ref(f, idx, valid, want, ct)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            name

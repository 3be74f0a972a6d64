"""The port's moe-family training path against the JAX package's.

moonshot-v1-16b-a3b (full attention) and deepseek-v2-236b (MLA, qk dim 24
/ value dim 16 at SMOKE) train through the same ``lm.loss_fn``,
``trainstep.make_train_step`` and ``loop.fit`` as the dense family. The
same seeded numpy inputs and JAX's SMOKE weights go through ``repro`` and
``repro_torch`` on the CPU, where every port op runs its plain version:

* flash attention's plain gradient at a value head dim unequal to the qk
  head dim (``flash_attention_bwd_ref`` at (24, 16)) against ``jax.vjp``
  of JAX's ``_dense_attention`` and ``_chunked_attention`` (what JAX's
  MLA differentiates), causal and not, G = 1 and 2, at 2e-5 (f32) and
  2e-2 (bf16) of each gradient's scale;
* ``lm.loss_fn`` and every gradient on both SMOKE configs in f32,
  ``remat`` "full" and "none", against ``jax.value_and_grad`` (the
  ``ref`` backend, and ``pallas`` in interpret mode, which reaches K5 at
  moonshot's equal head dims): loss within 1e-5, gradients within 2e-5 of
  their scale; the attention weights rescaled as ``test_torch_train.py``
  rescales them (see ``_jax_params``);
* a MoE layer whose expert 0 is over capacity: the dropped tokens' expert
  path gets no gradient (exactly 0), as in JAX, and the layer's gradients
  match ``jax.vjp``;
* three ``make_train_step`` steps (``grad_accum`` 1 and 2) for both
  configs; the batched f32-out GEMM's gradient arithmetic
  (``layers.bmm_f32_out_grads``, the card's ``_BmmF32Out.backward``)
  against ``jax.vjp`` of the experts' bf16 einsum; moe checkpoints
  written by either package restored by the other; ``fit`` on moonshot
  SMOKE cut and resumed;
* the backward's route at MLA's head dims, with a stand-in library (the
  CPU has no card), and a ``cuda``-marked check of the new kernel
  instances against their plain versions (skips here; ``python3
  chip_smoke.py`` runs them and MoE T / MLA T on the card).
"""
import contextlib
import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.runtime import checkpoint as jcheckpoint  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs, convert, kernels, ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import layers, lm, params  # noqa: E402
from repro_torch.runtime import checkpoint  # noqa: E402
from repro_torch.train import loop, optimizer, trainstep  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOONSHOT, DEEPSEEK = "moonshot_v1_16b_a3b", "deepseek_v2_236b"
ARCHS = (MOONSHOT, DEEPSEEK)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S = 4, 16


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_scaled(got, want, tol, what=""):
    """Within ``tol`` of the tensor's scale (its largest magnitude)."""
    want = _np(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(scale, 1e-30), err_msg=what)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Flash attention's gradient at MLA's head dims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(JDT))
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_flash_bwd_ref_at_mla_dims_matches_jax_vjp(path, causal, g, dtype):
    """dq and dk at the qk dim 24, dv at the value dim 16, against
    ``jax.vjp`` of JAX's dense attention (40 positions) and chunked
    attention (1,100: more than one of its 1,024-key chunks)."""
    sq = 40 if path == "dense" else 1100
    kv, hd, vd = 2, 24, 16
    rng = np.random.default_rng(sq + g + causal)
    arrays = [rng.normal(size=s) for s in ((1, sq, kv * g, hd),
                                           (1, sq, kv, hd), (1, sq, kv, vd),
                                           (1, sq, kv * g, vd))]
    jq, jk, jv, jdo = (jnp.asarray(a, JDT[dtype]) for a in arrays)
    fn = jlayers._dense_attention if path == "dense" else \
        jlayers._chunked_attention

    def attend(q, k, v):
        return fn(q.reshape(1, sq, kv, g, hd), k, v, causal).reshape(
            1, sq, kv * g, vd)
    _, vjp = jax.vjp(attend, jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = (torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])
                   .transpose(1, 2) for a in (jq, jk, jv, jdo))
    o = fa_ref.flash_attention_ref(q, k, v, causal)
    got = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == TDT[dtype]
        _close_scaled(x.transpose(1, 2), w, TOL[dtype], name)
    assert [tuple(x.shape[-1:]) for x in got] == [(hd,), (hd,), (vd,)]


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------


def _cfgs(arch, backend="ref", **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32,
                               backend=backend, **over)
    return jcfg, dataclasses.replace(configs.get_smoke(arch),
                                     dtype=torch.float32, **over)


def _rescale(attn, cfg) -> None:
    """JAX's fanin init takes fan_in = shape[-2] of the 3-d attention
    weights (the head count, or a head's dim for wo), so the SMOKE scores
    reach the tens, the softmax is nearly one-hot and the f32 gradient is
    ill-conditioned (no two summation orders agree to 2e-5: see
    ``test_torch_train.py::_jax_params``). Rescaled in place to the
    contracted dims' fan-in, the scores are of order 1."""
    if cfg.attn_kind == "mla":
        for name in ("wq_b", "wk_b", "wv_b"):      # (L, in, H, dim)
            w = attn[name]
            attn[name] = w * np.float32((w.shape[-2] / w.shape[1]) ** 0.5)
        wo = attn["wo"]                             # (L, H, v, D)
        attn["wo"] = wo * np.float32(
            (wo.shape[-2] / (wo.shape[1] * wo.shape[2])) ** 0.5)
        return
    for name in ("wq", "wk", "wv"):
        attn[name] = attn[name] * np.float32(
            (attn[name].shape[-2] / cfg.d_model) ** 0.5)
    attn["wo"] = attn["wo"] * np.float32(
        (attn["wo"].shape[-2] / cfg.d_head_total) ** 0.5)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """JAX's f32 SMOKE weights (key 0) as numpy arrays, attention
    rescaled (``_rescale``)."""
    jcfg, cfg = _cfgs(arch)
    tree = jax.tree_util.tree_map(
        np.array, jinit_params(jlm.model_defs(jcfg), jax.random.key(0)))
    for key, _ in lm.stacks(cfg):
        _rescale(tree[key]["attn"], cfg)
    return tree


def _batch(arch, seed=11, mask=False, n=B):
    vocab = configs.get_smoke(arch).vocab
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (n, S)).astype(np.int32),
           "labels": rng.integers(0, vocab, (n, S)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.uniform(size=(n, S)) < 0.7).astype(np.float32)
    return out


def _close_tree(got, want, tol, what):
    want = dict(params.leaves(want))
    got = dict(params.leaves(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        _close_scaled(got[path], w, tol, f"{what} {'/'.join(path)}")


def _port_grads(arch, cfg, batch):
    p = params.tree_map(lambda t: t.requires_grad_(),
                        convert.params_from_jax(_jax_params(arch), cfg))
    loss = lm.loss_fn(p, cfg, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in params.leaves(p)])
    return loss.detach(), params.from_leaves(zip(
        (path for path, _ in params.leaves(p)), grads))


@pytest.mark.parametrize("arch,remat,backend,mask", [
    (MOONSHOT, "full", "ref", False), (MOONSHOT, "none", "pallas", True),
    (DEEPSEEK, "full", "ref", True), (DEEPSEEK, "none", "pallas", False)])
def test_loss_fn_and_grads_match_jax(arch, remat, backend, mask):
    jcfg, cfg = _cfgs(arch, backend, remat=remat)
    batch = _batch(arch, mask=mask)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(
            jax.tree_util.tree_map(jnp.asarray, _jax_params(arch)),
            {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_grads(arch, cfg, batch)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    _close_tree(grads, jax.tree_util.tree_map(np.asarray, jgrads), 2e-5,
                f"{arch} grad ({remat}, {backend})")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_routing_and_gradients(arch):
    """``remat="full"`` recomputes every layer in the backward pass, the
    router included: the recomputed forward picks the same experts as the
    first (each MoE call's experts recorded, twice as many calls under
    remat, the second of each pair equal to the first), and the gradients
    equal ``remat="none"``'s bit for bit."""
    batch = _batch(arch)
    grads, calls = {}, {}
    route = layers.moe_route
    for remat in ("full", "none"):
        _, cfg = _cfgs(arch, remat=remat)
        seen = calls[remat] = []

        def recording(p, xt, c, seen=seen):
            out = route(p, xt, c)
            seen.append(out[2].clone())
            return out
        layers.moe_route = recording
        try:
            grads[remat] = _port_grads(arch, cfg, batch)[1]
        finally:
            layers.moe_route = route
    n_moe = cfg.n_layers - cfg.first_dense
    assert len(calls["none"]) == n_moe and len(calls["full"]) == 2 * n_moe
    # Forward: layer 0, 1, ...; the backward recomputes the layers in
    # reverse order.
    recomputed = calls["full"][n_moe:][::-1]
    for first, again, plain in zip(calls["full"][:n_moe], recomputed,
                                   calls["none"]):
        assert torch.equal(first, again) and torch.equal(first, plain)
    for (path, a), (_, b) in zip(params.leaves(grads["full"]),
                                 params.leaves(grads["none"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))


def test_dropped_tokens_get_no_expert_gradient():
    """``test_torch_moe.py``'s ``dropped`` inputs: expert 0's router column
    follows the inputs' sum, so all 320 tokens rank it first and the last
    192 are dropped past its 128-row capacity. With a cotangent on the
    dropped tokens alone, expert 0's weights get exactly zero gradient
    (the dropped rows reach no expert buffer row; the kept ones have a
    zero cotangent), in JAX and in the port; the layer's gradients (the
    input's, the router's, every expert's, the shared experts') match
    ``jax.vjp`` at 2e-5 of their scale, for a cotangent on every token
    too."""
    jcfg, cfg = _cfgs(MOONSHOT)
    tree = jax.tree_util.tree_map(
        np.array, jinit_params(jlm.model_defs(jcfg), jax.random.key(0)))
    jp_np = jax.tree_util.tree_map(lambda a: a[0],
                                   tree["moe_blocks"]["moe"])
    jp_np["router"][:, 0] = 0.5
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 160, cfg.d_model)).astype(np.float32) + 1.0
    cot = rng.normal(size=x.shape).astype(np.float32)
    cap = layers.moe_capacity(cfg, 320)
    assert cap == 128
    dropped = np.zeros(x.shape[:2], bool)
    dropped.reshape(-1)[cap:] = True
    for name, c in (("dropped only", np.where(dropped[..., None], cot, 0)),
                    ("every token", cot)):
        jp = jax.tree_util.tree_map(jnp.asarray, jp_np)
        _, vjp = jax.vjp(lambda p, xx: jlayers.moe_apply(p, xx, jcfg), jp,
                         jnp.asarray(x))
        jgp, jgx = vjp(jnp.asarray(c, jnp.float32))
        p = params.tree_map(lambda a: torch.from_numpy(a.copy())
                            .requires_grad_(), jp_np)
        xt = torch.from_numpy(x).requires_grad_()
        out = layers.moe_apply(p, xt, cfg)
        leaves = [t for _, t in params.leaves(p)]
        *gp, gx = torch.autograd.grad(out, leaves + [xt],
                                      torch.from_numpy(np.asarray(c)))
        got = params.from_leaves(zip((path for path, _ in
                                      params.leaves(p)), gp))
        if name == "dropped only":
            for w in ("w_gate", "w_up", "w_down"):
                assert not got[w][0].any(), w
                assert not np.asarray(jgp[w][0]).any(), w
                assert got[w][1:].abs().sum() > 0
        _close_tree(got, jax.tree_util.tree_map(np.asarray, jgp), 2e-5,
                    f"moe grad ({name})")
        _close_scaled(gx, jgx, 2e-5, f"moe input grad ({name})")


# ---------------------------------------------------------------------------
# The train step, the batched f32-out GEMM, checkpoints, fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, grad_accum):
    """Three steps from JAX's weights, as ``test_torch_train.py`` holds the
    dense family's: the loss within 1e-5, the gradient norm and both
    moments within 2e-5 of their scale, the parameters within 2e-5 of
    their scale plus the sum of the steps' learning rates."""
    jcfg, cfg = _cfgs(arch, grad_accum=grad_accum)
    ocfg = joptimizer.AdamWConfig()
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params(arch))
    jstate = joptimizer.init(jparams)
    jstep = jax.jit(jtrainstep.make_train_step(jcfg, ocfg))
    p = convert.params_from_jax(_jax_params(arch), cfg)
    state = optimizer.init(p)
    step = trainstep.make_train_step(cfg, optimizer.AdamWConfig(*ocfg))
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(arch, seed=20 + i)
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        p, state, m = step(p, state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
        _close_scaled(m["grad_norm"], jm["grad_norm"], 2e-5, "grad_norm")
        for name, got, want in (("m", state.m, jstate.m),
                                ("v", state.v, jstate.v)):
            _close_tree(got, jax.tree_util.tree_map(np.asarray, want), 2e-5,
                        f"step {i + 1} {name}")
        lr_sum += float(jm["lr"])
        want = dict(params.leaves(jax.tree_util.tree_map(np.asarray,
                                                         jparams)))
        for path, x in params.leaves(p):
            w = want[path]
            np.testing.assert_allclose(
                x.numpy(), w, rtol=0,
                atol=2e-5 * float(np.abs(w).max()) + lr_sum,
                err_msg=f"step {i + 1} params {'/'.join(path)}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bmm_f32_out_grads_match_jax_vjp(seed):
    """The experts' batched bf16 GEMM (moonshot SMOKE's expert buffer:
    8 experts x 128 rows, d_model @ d_model x moe_d_ff, f32 out): its
    gradient arithmetic (``bmm_f32_out_grads``, which the card's
    ``_BmmF32Out.backward`` runs; its products here bf16 values multiplied
    exactly and summed in f32, as the card's GEMM with f32 out) against
    ``jax.vjp`` of JAX's ``einsum('ecd,edf->ecf',
    preferred_element_type=float32)``: every entry within one bf16 ulp of
    JAX's plus 2^-16 of |dy| @ |w| (chip_smoke.F4_SLACK)."""
    cs = _chip_smoke()
    cfg = configs.get_smoke(MOONSHOT)
    e, c, d, f = cfg.n_experts, 128, cfg.d_model, cfg.moe_d_ff
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(e, c, d)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(e, d, f)) * d ** -0.5, jnp.bfloat16)
    dy = rng.normal(size=(e, c, f)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "ecd,edf->ecf", a, b, preferred_element_type=jnp.float32), x, w)
    want = [torch.from_numpy(np.array(t.astype(jnp.float32)))
            for t in vjp(jnp.asarray(dy))]
    xt, wt = (torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16()
              for t in (x, w))
    dyt = torch.from_numpy(dy)
    got = layers.bmm_f32_out_grads(dyt, xt, wt, lambda a, b: torch.bmm(
        a.float(), b.float()))
    scales = (torch.bmm(dyt.abs(), wt.float().abs().transpose(1, 2)),
              torch.bmm(xt.float().abs().transpose(1, 2), dyt.abs()))
    for g, wnt, sc in zip(got, want, scales):
        assert g.dtype == torch.bfloat16 and g.shape == wnt.shape
        _, excess = cs.bf16_departure(torch, g, wnt, sc)
        assert excess <= cs.F4_SLACK
    # Rounding the cotangent once to bf16 instead fails the same check.
    g16 = dyt.bfloat16().float()
    once = (torch.bmm(g16, wt.float().transpose(1, 2)).bfloat16(),
            torch.bmm(xt.float().transpose(1, 2), g16).bfloat16())
    assert any(cs.bf16_departure(torch, g, wnt, sc)[1] > cs.F4_SLACK
               for g, wnt, sc in zip(once, want, scales))


def _moe_train_state():
    """JAX's moonshot SMOKE weights and an AdamW state as trees of both
    packages: the expert leaves (L, E, D, F), the shared experts, the
    router and the dense first layer's stack."""
    tree = _jax_params(MOONSHOT)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(9)
    jm = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), jp)
    jv = jax.tree_util.tree_map(jnp.square, jm)
    jstate = joptimizer.OptState(step=jnp.asarray(5, jnp.int32), m=jm, v=jv)
    _, cfg = _cfgs(MOONSHOT)
    tstate = optimizer.OptState(
        step=torch.tensor(5, dtype=torch.int32),
        m=convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jm),
                                  cfg),
        v=convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jv),
                                  cfg))
    return ({"params": jp, "opt": jstate},
            {"params": convert.params_from_jax(tree, cfg), "opt": tstate})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_moe_checkpoints_cross_between_packages(tmp_path, writer):
    jtree, ttree = _moe_train_state()
    paths = [path for path, _ in params.leaves(ttree["params"])]
    assert ("moe_blocks", "moe", "w_gate") in paths
    assert ("moe_blocks", "moe", "shared", "wo") in paths
    assert ("dense_blocks", "mlp", "wi_gate") in paths
    assert len(checkpoint.flatten(ttree)) == \
        len(jax.tree_util.tree_leaves(jtree))
    if writer == "jax":
        jcheckpoint.CheckpointManager(str(tmp_path)).save(3, jtree)
        got = checkpoint.CheckpointManager(str(tmp_path)).restore(
            None, checkpoint.unflatten(ttree, iter(
                [torch.zeros_like(t) for t in checkpoint.flatten(ttree)])))
    else:
        checkpoint.CheckpointManager(str(tmp_path)).save(3, ttree)
        back = jcheckpoint.CheckpointManager(str(tmp_path)).restore(
            None, jax.tree_util.tree_map(jnp.zeros_like, jtree))
        got = checkpoint.unflatten(ttree, iter(
            torch.from_numpy(np.asarray(x))
            for x in jax.tree_util.tree_leaves(back)))
    assert int(got["opt"].step) == 5
    for a, b in zip(checkpoint.flatten(got), checkpoint.flatten(ttree)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fit_moe_cut_and_resumed_equals_uncut(tmp_path):
    """``fit`` on moonshot SMOKE (f32) for 4 steps, and the same run cut
    after 2 (its checkpoint at step 2) and resumed: the resumed steps'
    losses equal the uncut run's bit for bit."""
    _, cfg = _cfgs(MOONSHOT)
    kw = dict(global_batch=2, seq_len=16, ckpt_every=2, seed=1,
              torch_device="cpu", ocfg=optimizer.AdamWConfig(
                  lr=1e-3, warmup_steps=2, total_steps=4))
    uncut = loop.fit(cfg, 4, ckpt_dir=str(tmp_path / "a"), **kw)
    first = loop.fit(cfg, 2, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = loop.fit(cfg, 4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed.restored_from == 2
    assert first.losses == uncut.losses[:2]
    assert resumed.losses == uncut.losses[2:]
    assert all(np.isfinite(uncut.losses))


# ---------------------------------------------------------------------------
# The backward's route at MLA's head dims
# ---------------------------------------------------------------------------


def test_flash_bwd_routes_at_mla_dims(monkeypatch):
    """On the card ``flash_attention_bwd`` at MLA's head dims launches the
    kernel of ``route``, as the forward: bf16 (192, 128) the tensor-core
    one, f32 (192, 128) and both dtypes at (24, 16) the 3xTF32 one, each
    given the value head dim; dq and dk come back at the qk dim, dv at the
    value dim, in the model's (B, S, heads, dim) storage; the f32
    partials of dK and dV a query head are sized apart (B H SK (hd + vd)
    floats), and neither kernel gets any at G = 1. Here the
    library is a stand-in that records each call (the CPU has no card)."""
    from repro_torch.kernels import _build, _launch
    called = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                called.append((name, args))
                return 0
            return entry
    monkeypatch.setattr(_launch, "dispatch_device", lambda kernel, t: "cuda")
    monkeypatch.setattr(_launch, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(_launch, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    real_empty = torch.empty
    sizes = []

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes.append(t.numel())
        return t
    monkeypatch.setattr(torch, "empty", empty)
    for dtype, (hd, vd), h, kv, path in (
            (torch.bfloat16, (192, 128), 4, 4, "tc"),
            (torch.bfloat16, (192, 128), 4, 2, "tc"),
            (torch.float32, (192, 128), 4, 4, "tf32x3"),
            (torch.float32, (24, 16), 4, 4, "tf32x3"),
            (torch.bfloat16, (24, 16), 4, 2, "tf32x3")):
        assert fa_ops.route(dtype, hd, vd) == path
        q = torch.zeros(1, h, 77, hd, dtype=dtype)
        k = torch.zeros(1, kv, 77, hd, dtype=dtype)
        v = torch.zeros(1, kv, 77, vd, dtype=dtype)
        o = torch.zeros(1, h, 77, vd, dtype=dtype)
        kernels.reset_launch_counts()
        sizes.clear()
        dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, o, o, True)
        counts = kernels.launch_counts()
        name, args = called[-1]
        tc = path == "tc"
        assert name == ("moby_flash_attention_bwd_tc" if tc
                        else "moby_flash_attention_bwd")
        assert counts["flash_attention_bwd_tc" if tc
                      else "flash_attention_bwd"] == 1
        assert sum(counts.values()) == 1
        # Ten pointers and the strides, then b, h, kv, sq, sk, hd, vd.
        assert args[11:18] == (1, h, kv, 77, 77, hd, vd)
        assert float(args[-2]) == pytest.approx(hd ** -0.5)
        assert tuple(dq.shape) == (1, h, 77, hd) and \
            tuple(dk.shape) == (1, kv, 77, hd) and \
            tuple(dv.shape) == (1, kv, 77, vd)
        for t in (dq, dk, dv):
            assert t.transpose(1, 2).is_contiguous()
        part = sizes[3]
        assert part == (0 if h == kv else h * 77 * (hd + vd))


@pytest.mark.cuda
def test_mla_bwd_kernels_match_plain_on_card():
    """The gradient's new instances on card tensors against the plain
    gradient computed in float64 (``chip_smoke.grads_close``: f32 at 2e-5
    of the scale; bf16 within half a bf16 ulp, plus the tensor-core
    route's allowance for P and dS rounded to bf16), G = 1 and 2, ragged
    sequence lengths, causal and not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    cs = _chip_smoke()
    g = torch.Generator(device=dev).manual_seed(5)
    for dtype, hd, vd, h, kv, s, causal in (
            (torch.bfloat16, 192, 128, 4, 4, 300, True),
            (torch.bfloat16, 192, 128, 4, 2, 130, False),
            (torch.float32, 192, 128, 4, 4, 300, True),
            (torch.float32, 192, 128, 8, 2, 77, False),
            (torch.float32, 24, 16, 4, 4, 300, True),
            (torch.bfloat16, 24, 16, 4, 2, 77, False)):
        def act(heads, dim):
            return torch.randn(1, s, heads, dim, generator=g, device=dev,
                               dtype=dtype).transpose(1, 2)
        q, k, v = (act(h, hd).requires_grad_(), act(kv, hd).requires_grad_(),
                   act(kv, vd).requires_grad_())
        out = ops.flash_attention(q, k, v, causal)
        do = act(h, vd)
        out.backward(do)
        args = [t.detach().double() for t in (q, k, v, out, do)]
        want = fa_ref.flash_attention_bwd_ref(*args, causal)
        tc = fa_ops.route(dtype, hd, vd) == "tc"
        terms = cs.bwd_rounding_terms(torch, *args, causal) if tc else None
        cs.grads_close(torch, (q.grad, k.grad, v.grad), want,
                       f"flash bwd ({hd}, {vd}) {dtype}", terms)


def test_train_step_with_a_stack_of_no_layers():
    """deepseek-v2 SMOKE cut to its dense first layer (n_layers =
    first_dense, as MLA T's f32 correctness phase on the card runs it):
    the MoE stack has no layers, the loss does not reach its leaves, and
    the train step gives them zero gradients, as ``jax.grad`` does; a
    step matches JAX's (loss within 1e-5, gradient norm and moments within
    2e-5 of their scale)."""
    jcfg, cfg = _cfgs(DEEPSEEK, n_layers=1)
    jtree = jax.tree_util.tree_map(
        np.array, jinit_params(jlm.model_defs(jcfg), jax.random.key(1)))
    assert jtree["moe_blocks"]["moe"]["w_gate"].shape[0] == 0
    ocfg = joptimizer.AdamWConfig()
    jparams = jax.tree_util.tree_map(jnp.asarray, jtree)
    batch = _batch(DEEPSEEK, seed=5)
    jparams, jstate, jm = jax.jit(jtrainstep.make_train_step(jcfg, ocfg))(
        jparams, joptimizer.init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    p = convert.params_from_jax(jtree, cfg)
    p, state, m = trainstep.make_train_step(
        cfg, optimizer.AdamWConfig(*ocfg))(p, optimizer.init(p), batch)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    _close_scaled(m["grad_norm"], jm["grad_norm"], 2e-5, "grad_norm")
    for name, got, want in (("m", state.m, jstate.m),
                            ("v", state.v, jstate.v)):
        _close_tree(got, jax.tree_util.tree_map(np.asarray, want), 2e-5,
                    name)
    assert state.m["moe_blocks"]["moe"]["w_gate"].shape[0] == 0

"""The port's encoder-decoder family (whisper-small, the audio family)
against the JAX package's.

The same weights and the same seeded inputs go through ``repro.models``
and ``repro_torch.models`` at SMOKE size: the config and parameter tree
field by field, attention with ``kv_x`` (cross attention), the encoder
alone (``lm.encode``), the decode step's cross attention
(``decode.cross_decode_apply``), ``convert.decode_state_from_jax`` with
``enc_out``, prefill (``lm.forward(enc_embeds=)``) and four serving steps,
and ``loss_fn``. JAX runs on the CPU with its ``ref`` and ``pallas``
backends; the port runs its plain attention versions.

The JAX package's behaviour, which the port keeps (ROADMAP R4a-R4d):
``init_decode`` allocates the cross caches as zeros and no code fills
them (``enc_out`` is carried along and read by no step), so the tests
fill both packages' cross caches with the same seeded values; the decode
step's cross query is ``x @ wq`` with no ``bq`` (prefill's cross
attention adds its biases); the encoder gets RoPE on top of its learned
positions.

The weights are JAX's SMOKE weights (key 0) with the attention weights
rescaled as ``test_torch_train.py`` rescales them (fan_in = d_model, and
H * hd for ``wo``; the cross attention's too): at JAX's own fanin scale
(fan_in = the head count) the scores reach the tens, the softmax is
nearly one-hot, and through the 6 attentions of 2 + 2 layers JAX's f32
logits and the port's each land 2-4e-5 from the float64 logits of the
same weights, so no two f32 implementations agree to 1e-5
(``test_f32_logits_at_jax_scale_against_float64`` holds both within
5e-5 of float64 there). Rescaled,
the two agree within 4e-7. Tolerances: 1e-5 in f32, of the values' own
scale for layer outputs and caches; 3e-2 in bf16.

``tests/goldens/lm_whisper_small_smoke.npz`` holds those f32 weights, the
tokens, encoder embeddings, cross caches, decode tokens and JAX's logits,
so that ``chip_smoke.py`` (Audio A) holds the card against JAX without
JAX; regenerate with ``MOBY_REGEN_GOLDENS=1``.
"""
import dataclasses
import functools
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import decode as jdecode  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.params import ParamDef as JDef  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch import configs, convert, kernels  # noqa: E402
from repro_torch.models import decode, layers, lm, params  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper_small"
GOLDEN = (pathlib.Path(__file__).parent / "goldens"
          / f"lm_{ARCH}_smoke.npz")
B, S, MAX_LEN, STEPS = 2, 16, 32, 4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The JAX config fields the port drops (see repro_torch/models/config.py).
JAX_ONLY = {"backend", "rules_override", "seq_shard"}
# The attention weights of each stack.
ATTENTION = (("enc_blocks", "attn"), ("blocks", "attn"), ("blocks", "cross"))


def _cfgs(dtype="float32", backend="pallas"):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=JDT[dtype],
                               backend=backend)
    return jcfg, dataclasses.replace(configs.get_smoke(ARCH),
                                     dtype=TDT[dtype])


@functools.lru_cache(maxsize=None)
def _jax_params():
    """JAX's f32 SMOKE weights (key 0), attention rescaled (see the module
    docstring), as a tree of numpy arrays."""
    jcfg, cfg = _cfgs()
    tree = jax.tree_util.tree_map(
        np.array, jinit_params(jlm.model_defs(jcfg), jax.random.key(0)))
    for key, name in ATTENTION:
        attn = tree[key][name]
        for w in ("wq", "wk", "wv"):
            attn[w] = attn[w] * np.float32(
                (attn[w].shape[-2] / cfg.d_model) ** 0.5)
        attn["wo"] = attn["wo"] * np.float32(
            (attn["wo"].shape[-2] / cfg.d_head_total) ** 0.5)
    return tree


def _weights(cfg, tree=None):
    tree = _jax_params() if tree is None else tree
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        convert.params_from_jax(tree, cfg)


def _biased():
    """The weights with seeded nonzero q/k/v biases (JAX's are zeros)."""
    tree = jax.tree_util.tree_map(np.array, _jax_params())
    rng = np.random.default_rng(11)
    for key, name in ATTENTION:
        for b in ("bq", "bk", "bv"):
            a = tree[key][name][b]
            tree[key][name][b] = (rng.normal(size=a.shape) * 0.5) \
                .astype(np.float32)
    return tree


def _inputs(cfg, dtype="float32", seed=7):
    """Tokens (B, S), encoder embeddings (B, enc_seq, D), cross caches
    (L, B, enc_seq, KV, hd) and decode tokens, seeded; the floats
    rounded to ``dtype`` once (numpy f32 holding those values)."""
    rng = np.random.default_rng(seed)
    cross = (cfg.n_layers, B, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)

    def floats(shape):
        a = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return a.to(TDT[dtype]).float().numpy()
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "enc_embeds": floats((B, cfg.enc_seq, cfg.d_model)),
            "cross_k": floats(cross), "cross_v": floats(cross),
            "decode_tokens": rng.integers(0, cfg.vocab, (STEPS, B))
            .astype(np.int32)}


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def _close_scaled(got, want, tol, what=""):
    """Within ``tol`` of the values' own scale (see test_torch_lm.py)."""
    want = np.asarray(want, np.float32)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())), what)


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch.")
    return out


@functools.lru_cache(maxsize=None)
def _jit_forward():
    return jax.jit(jlm.forward, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _jit_decode():
    return jax.jit(jdecode.decode_step, static_argnums=1)


def _jax_state(jcfg, inp, enc_out=None):
    """JAX's empty decode state with its cross caches set to the seeded
    ones (JAX never fills them: R4a)."""
    state = jdecode.init_decode(jcfg, B, MAX_LEN, enc_out=enc_out)
    caches = dict(state.caches, **{k: jnp.asarray(inp[k]).astype(jcfg.dtype)
                                   for k in ("cross_k", "cross_v")})
    return state._replace(caches=caches)


def _port_state(cfg, inp):
    state = decode.init_decode(cfg, B, MAX_LEN, "cpu")
    for k in ("cross_k", "cross_v"):
        state.caches[k].copy_(torch.from_numpy(inp[k]))
    return state


def _jax_run(jcfg, jparams, inp):
    logits = _jit_forward()(jparams, jcfg, jnp.asarray(inp["tokens"]),
                            enc_embeds=jnp.asarray(inp["enc_embeds"])
                            .astype(jcfg.dtype))
    state = _jax_state(jcfg, inp)
    steps = []
    for t in inp["decode_tokens"]:
        lg, state = _jit_decode()(jparams, jcfg, state, jnp.asarray(t))
        steps.append(lg)
    return logits, steps, state


def _port_run(cfg, p, inp):
    logits = lm.forward(p, cfg, torch.from_numpy(inp["tokens"]),
                        enc_embeds=torch.from_numpy(inp["enc_embeds"])
                        .to(cfg.dtype))
    state = _port_state(cfg, inp)
    steps = []
    for t in inp["decode_tokens"]:
        lg, state = decode.decode_step(p, cfg, state, torch.from_numpy(t))
        steps.append(lg)
    return logits, steps, state


# ---------------------------------------------------------------------------
# Config and parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_config_equals_jax_field_by_field(which):
    got = _fields(getattr(configs, which)(ARCH))
    want = {k: v for k, v in _fields(getattr(jconfigs, which)(ARCH)).items()
            if k not in JAX_ONLY}
    assert got == want
    assert got["family"] == "audio" and got["is_encdec"]
    assert got["norm"] == "layernorm" and got["mlp_type"] == "gelu"


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_model_defs_equal_jax(which):
    jdefs = jax.tree_util.tree_leaves_with_path(
        jlm.model_defs(getattr(jconfigs, which)(ARCH)),
        is_leaf=lambda x: isinstance(x, JDef))
    want = {tuple(k.key for k in path): (d.shape, d.logical_axes,
                                         np.dtype(d.dtype).name)
            for path, d in jdefs}
    got = {path: (d.shape, d.logical_axes, str(d.dtype).removeprefix(
        "torch.")) for path, d in params.leaves(lm.model_defs(
            getattr(configs, which)(ARCH)))}
    assert got == want
    assert ("enc_pos",) in got and ("blocks", "cross", "wq") in got


def test_full_width_size():
    """whisper-small from its definitions alone: 12 encoder layers, 12
    decoder layers (with cross attention), 1,500 learned encoder positions
    and a tied 51,865 x 768 table."""
    defs = lm.model_defs(configs.get(ARCH))
    assert params.param_count(defs) == 239_343_360
    assert params.param_bytes(defs) == 4 * 239_343_360


def test_cast_params_keeps_the_norms_f32():
    _, cfg = _cfgs("bfloat16")
    _, p = _weights(cfg)
    cast = lm.cast_params(p, cfg)
    for key in ("final_norm", "enc_final_norm"):
        assert cast[key]["scale"].dtype == torch.float32
    for name in ("ln1", "ln2", "ln_cross"):
        assert cast["blocks"][name]["bias"].dtype == torch.float32
    assert cast["enc_pos"].dtype == torch.bfloat16
    assert cast["blocks"]["cross"]["wq"].dtype == torch.bfloat16
    drawn = lm.init_cast_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    assert {path: t.dtype for path, t in params.leaves(drawn)} == \
        {path: t.dtype for path, t in params.leaves(cast)}
    inp = _inputs(cfg, "bfloat16")
    args = (torch.from_numpy(inp["tokens"]),)
    kw = dict(enc_embeds=torch.from_numpy(inp["enc_embeds"]))
    torch.testing.assert_close(lm.forward(cast, cfg, *args, **kw),
                               lm.forward(p, cfg, *args, **kw), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# Cross attention, the encoder, the decode step's cross attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_attn_apply_with_kv_x_matches_jax(backend):
    """Cross attention: queries from x (S rows), keys and values from kv_x
    (enc_seq rows), biases added, no RoPE, not causal."""
    jcfg, cfg = _cfgs(backend=backend)
    jparams, p = _weights(cfg, _biased())
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["cross"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = layers.attn_apply(lm.layer(p, 0)["cross"], torch.from_numpy(x),
                            cfg, torch.from_numpy(pos), causal=False,
                            kv_x=torch.from_numpy(kv))
    want = jlayers.attn_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                              causal=False, kv_x=jnp.asarray(kv))
    _close_scaled(got, want, 1e-5)
    # No position encoding: other positions give the same output.
    again = layers.attn_apply(lm.layer(p, 0)["cross"], torch.from_numpy(x),
                              cfg, torch.from_numpy(pos + 5), causal=False,
                              kv_x=torch.from_numpy(kv))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def _jax_encoder(jparams, jcfg, enc_embeds):
    """The encoder branch of JAX's ``lm.forward`` (lm.py:227-234)."""
    enc = enc_embeds.astype(jcfg.dtype) + \
        jparams["enc_pos"][None, :enc_embeds.shape[1]].astype(jcfg.dtype)
    enc_cfg = dataclasses.replace(jcfg, n_kv_heads=jcfg.n_heads)
    body = functools.partial(
        jlm._attn_block_apply, cfg=enc_cfg, moe=False, causal=False,
        positions=jlm.default_positions(jcfg, enc.shape[0], enc.shape[1]))
    enc = jlm.scan_stack(lambda p, x: body(p, x), enc,
                         jparams["enc_blocks"], False)
    return jlayers.norm_apply(jparams["enc_final_norm"], enc, jcfg.norm)


@pytest.mark.parametrize("frames", [32, 20])
def test_encoder_matches_jax(frames):
    """The encoder alone, over all enc_seq frames and fewer (``enc_pos``
    sliced to the frames given). It takes RoPE on top of its learned
    positions, as JAX's does (R4c): without it the output moves."""
    jcfg, cfg = _cfgs(backend="ref")
    jparams, p = _weights(cfg)
    e = _inputs(cfg)["enc_embeds"][:, :frames]
    want = _jax_encoder(jparams, jcfg, jnp.asarray(e))
    got = lm.encode(p, cfg, torch.from_numpy(e))
    _close_scaled(got, want, 1e-5)
    no_rope = dataclasses.replace(cfg, pos_embedding="none")
    assert float((lm.encode(p, no_rope, torch.from_numpy(e)) - got)
                 .abs().max()) > 1e-2


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_cross_decode_apply_matches_jax(dtype, tol):
    """The decode step's cross attention against JAX's einsums
    (decode.py:255-266), with a nonzero ``bq`` that neither adds (R4b)."""
    jcfg, cfg = _cfgs(dtype)
    jparams, p = _weights(cfg, _biased())
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["cross"])
    inp = _inputs(cfg, dtype)
    x = np.random.default_rng(6).normal(size=(B, 1, cfg.d_model)) \
        .astype(np.float32)
    x = torch.from_numpy(x).to(cfg.dtype)
    jx = jnp.asarray(x.float().numpy()).astype(jcfg.dtype)
    xk, xv = (jnp.asarray(inp[k][0]).astype(jcfg.dtype)
              for k in ("cross_k", "cross_v"))
    hq, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = jnp.einsum("bsd,dhk->bshk", jx, jlayers.cast(jp["wq"], jcfg))
    s = jnp.einsum("bkgh,bskh->bkgs", q.reshape(B, kv, hq // kv, hd), xk,
                   preferred_element_type=jnp.float32) * hd ** -0.5
    w = jax.nn.softmax(s, axis=-1).astype(jcfg.dtype)
    o = jnp.einsum("bkgs,bskh->bkgh", w, xv).reshape(B, 1, hq, hd)
    want = jnp.einsum("bshk,hkd->bsd", o, jlayers.cast(jp["wo"], jcfg))
    lengths = torch.full((B,), cfg.enc_seq, dtype=torch.int32)
    got = decode.cross_decode_apply(
        lm.layer(p, 0)["cross"], x, cfg,
        *(torch.from_numpy(inp[k][0]).to(cfg.dtype)
          for k in ("cross_k", "cross_v")), lengths)
    assert got.dtype == cfg.dtype
    _close_scaled(got, want, tol)


# ---------------------------------------------------------------------------
# Decode state, the serving path and loss_fn
# ---------------------------------------------------------------------------


def test_init_decode_allocates_zero_cross_caches():
    """Both packages allocate the cross caches as zeros of enc_seq
    positions and carry ``enc_out`` without reading it (R4a)."""
    jcfg, cfg = _cfgs("bfloat16")
    jstate = jdecode.init_decode(jcfg, B, MAX_LEN)
    state = decode.init_decode(cfg, B, MAX_LEN, "cpu")
    assert state._fields == jstate._fields
    assert sorted(state.caches) == sorted(jstate.caches)
    for k in ("cross_k", "cross_v"):
        assert tuple(state.caches[k].shape) == jstate.caches[k].shape
        assert state.caches[k].dtype == torch.bfloat16
        assert not state.caches[k].any()
    assert tuple(state.caches["self"]["k"].shape) == \
        jstate.caches["self"]["k"].shape
    assert state.enc_out is None
    _, p = _weights(cfg)
    tokens = torch.zeros((B,), dtype=torch.int32)
    enc_out = torch.ones((B, cfg.enc_seq, cfg.d_model))
    a, _ = decode.decode_step(p, cfg, decode.init_decode(
        cfg, B, MAX_LEN, "cpu"), tokens)
    b, out = decode.decode_step(p, cfg, decode.init_decode(
        cfg, B, MAX_LEN, "cpu")._replace(enc_out=enc_out), tokens)
    assert out.enc_out is enc_out
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_state_from_jax():
    """A JAX state two steps in, ``enc_out`` included, converts; the port's
    next step from it equals JAX's."""
    jcfg, cfg = _cfgs("bfloat16")
    jparams, p = _weights(cfg)
    inp = _inputs(cfg, "bfloat16")
    enc_out = jnp.asarray(inp["enc_embeds"]).astype(jnp.bfloat16)
    jstate = _jax_state(jcfg, inp, enc_out)
    for t in inp["decode_tokens"][:2]:
        _, jstate = _jit_decode()(jparams, jcfg, jstate, jnp.asarray(t))
    state = convert.decode_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate))
    assert state.caches["self"]["k"].dtype == torch.bfloat16
    assert state.caches["cross_v"].dtype == torch.bfloat16
    assert state.enc_out.dtype == torch.bfloat16
    _close(state.enc_out, enc_out.astype(jnp.float32), 0)
    np.testing.assert_array_equal(state.cache_pos.numpy(), [2, 2])
    want, _ = _jit_decode()(jparams, jcfg, jstate,
                            jnp.asarray(inp["decode_tokens"][2]))
    got, _ = decode.decode_step(p, cfg, state,
                                torch.from_numpy(inp["decode_tokens"][2]))
    _close(got, want, 3e-2)


@pytest.mark.parametrize("dtype,backend,tol", [
    ("float32", "ref", 1e-5), ("float32", "pallas", 1e-5),
    ("bfloat16", "pallas", 3e-2)])
def test_serving_path_matches_jax(dtype, backend, tol):
    """Prefill (encoder, then decoder layers of self, cross and MLP) and
    four steps over the seeded cross caches."""
    jcfg, cfg = _cfgs(dtype, backend)
    jparams, p = _weights(cfg)
    inp = _inputs(cfg, dtype)
    want = _jax_run(jcfg, jparams, inp)
    kernels.reset_launch_counts()
    got = _port_run(cfg, p, inp)
    assert sum(kernels.launch_counts().values()) == 0   # plain versions
    _close(got[0], want[0], tol, "forward logits")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        _close(g, w, tol, f"decode step {i} logits")
    for name in ("k", "v"):
        assert got[2].caches["self"][name].dtype == cfg.dtype
        _close_scaled(got[2].caches["self"][name],
                      want[2].caches["self"][name], tol, name)
    np.testing.assert_array_equal(got[2].cache_pos.numpy(),
                                  np.asarray(want[2].cache_pos))


def test_biases_match_jax():
    """With nonzero biases: prefill's cross attention adds them, the decode
    step's cross query does not (R4b); both as JAX."""
    jcfg, cfg = _cfgs(backend="ref")
    jparams, p = _weights(cfg, _biased())
    inp = _inputs(cfg)
    want = _jax_run(jcfg, jparams, inp)
    got = _port_run(cfg, p, inp)
    _close(got[0], want[0], 1e-5, "forward logits")
    _close(torch.stack(got[1]), np.stack(want[1]), 1e-5, "decode logits")


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_f32_logits_at_jax_scale_against_float64(backend, monkeypatch):
    """Why the other tests rescale the attention: at JAX's own SMOKE
    weights (not rescaled) the port's f32 prefill logits and JAX's each
    lie within 5e-5 of float64 logits of the same weights and inputs, so
    the gap that keeps 1e-5 from holding between them there is both
    packages' f32 rounding, not the port's alone. The float64 logits come
    from the port's plain path with every tensor float64:
    ``Tensor.float()`` (the widening its norms, RoPE and f32 matmuls use)
    keeps float64 for that run; RoPE's frequencies stay f32, as both
    packages compute them."""
    jcfg, cfg = _cfgs(backend=backend)
    tree = jax.tree_util.tree_map(
        np.array, jinit_params(jlm.model_defs(jcfg), jax.random.key(0)))
    jparams, p = _weights(cfg, tree)
    inp = _inputs(cfg)
    tokens = torch.from_numpy(inp["tokens"])
    enc = torch.from_numpy(inp["enc_embeds"])
    want = np.asarray(_jit_forward()(jparams, jcfg, jnp.asarray(
        inp["tokens"]), enc_embeds=jnp.asarray(inp["enc_embeds"])))
    got = lm.forward(p, cfg, tokens, enc_embeds=enc).numpy()
    widen = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: t if
                        t.dtype == torch.float64 else widen(t, *a, **k))
    exact = lm.forward(
        jax.tree_util.tree_map(lambda t: t.double(), p),
        dataclasses.replace(cfg, dtype=torch.float64), tokens,
        enc_embeds=enc.double()).numpy()
    monkeypatch.undo()
    assert exact.dtype == np.float64
    np.testing.assert_allclose(got, exact, rtol=0, atol=5e-5,
                               err_msg="the port's f32 logits")
    np.testing.assert_allclose(want, exact, rtol=0, atol=5e-5,
                               err_msg="JAX's f32 logits")


def test_loss_fn_matches_jax():
    jcfg, cfg = _cfgs()
    jparams, p = _weights(cfg)
    inp = _inputs(cfg)
    labels = np.random.default_rng(5).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    want = jlm.loss_fn(jparams, jcfg, {
        "tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(labels),
        "enc_embeds": jnp.asarray(inp["enc_embeds"])})
    p = params.tree_map(lambda t: t.requires_grad_(), p)
    loss = lm.loss_fn(p, cfg, {
        "tokens": torch.from_numpy(inp["tokens"]),
        "labels": torch.from_numpy(labels),
        "enc_embeds": torch.from_numpy(inp["enc_embeds"])})
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    grads = dict(zip((path for path, _ in params.leaves(p)),
                     torch.autograd.grad(loss, [t for _, t in
                                                params.leaves(p)])))
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    for path in (("enc_pos",), ("enc_blocks", "attn", "wq"),
                 ("blocks", "cross", "wk")):
        assert bool(grads[path].any()), path
    with pytest.raises(ValueError, match="enc_embeds"):
        lm.forward(p, cfg, torch.from_numpy(inp["tokens"]))


# ---------------------------------------------------------------------------
# The golden that chip_smoke.py (Audio A) holds the card against
# ---------------------------------------------------------------------------


def _golden_from_jax():
    jcfg, cfg = _cfgs()
    jparams, _ = _weights(cfg)
    inp = _inputs(cfg)
    logits, steps, _ = _jax_run(jcfg, jparams, inp)
    out = {"params/" + "/".join(path): a for path, a in
           params.leaves(_jax_params())}
    out.update(inp, logits=np.asarray(logits),
               decode_logits=np.stack([np.asarray(s) for s in steps]))
    return out


def _golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_jax_reproduces_the_audio_golden():
    fresh = _golden_from_jax()
    if os.environ.get("MOBY_REGEN_GOLDENS") == "1":
        np.savez(GOLDEN, **fresh)
    gold = _golden()
    assert sorted(gold) == sorted(fresh)
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_port_matches_the_audio_golden():
    gold = _golden()
    _, cfg = _cfgs()
    tree = params.from_leaves((tuple(k.split("/")[1:]), v)
                              for k, v in gold.items()
                              if k.startswith("params/"))
    logits, steps, _ = _port_run(cfg, convert.params_from_jax(tree, cfg),
                                 gold)
    _close(logits, gold["logits"], 1e-5)
    _close(torch.stack(steps), gold["decode_logits"], 1e-5)

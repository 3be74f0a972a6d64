"""The port's moe family (moonshot-v1-16b-a3b) against the JAX package's.

The same weights (JAX's ``init_params`` with key 0, carried across by
``convert.params_from_jax``) and the same seeded inputs go through
``repro.models`` and ``repro_torch.models``: the config and parameter
tree field by field, ``moe_capacity``, ``moe_apply`` (its routing too:
the experts each token picks, in ``lax.top_k``'s order) on ordinary
inputs, with tokens dropped past the capacity and with exact ties, and
the serving path (prefill and four decode steps) at SMOKE size. JAX runs
on the CPU with its ``ref`` backend and with its ``pallas`` backend (the
attention kernels in interpret mode); the port runs its plain versions.

Tolerances: 1e-5 in f32, of the values' own scale for layer outputs and
caches (as ``test_torch_lm.py``). The end-to-end comparison is in f32
only: in bf16 the two packages' hidden states differ by rounding (the
dense tests allow 3e-2), enough to flip a router's near-tie and send a
token to another expert. ``moe_apply`` alone is also held in bf16, on
identical bf16 inputs, where the routing must be equal.

``tests/goldens/lm_moonshot_v1_16b_a3b_smoke.npz`` holds JAX's f32 SMOKE
weights, tokens and logits, so that ``chip_smoke.py`` (MoE A) holds the
card against JAX without JAX; regenerate with ``MOBY_REGEN_GOLDENS=1``.
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

ARCH = "moonshot_v1_16b_a3b"
GOLDEN = (pathlib.Path(__file__).parent / "goldens"
          / f"lm_{ARCH}_smoke.npz")
B, S, MAX_LEN, STEPS = 2, 16, 32, 4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The JAX config fields the port drops (see repro_torch/models/config.py).
JAX_ONLY = {"backend", "rules_override", "seq_shard"}


def _cfgs(dtype="float32", backend="pallas", **overrides):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=JDT[dtype],
                               backend=backend, **overrides)
    return jcfg, dataclasses.replace(configs.get_smoke(ARCH),
                                     dtype=TDT[dtype], **overrides)


@functools.lru_cache(maxsize=None)
def _jax_params(first_dense=1):
    """JAX's f32 SMOKE weights (key 0) as a tree of numpy arrays."""
    jcfg, _ = _cfgs(first_dense=first_dense)
    tree = jinit_params(jlm.model_defs(jcfg), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(cfg):
    tree = _jax_params(cfg.first_dense)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        convert.params_from_jax(tree, cfg)


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


# ---------------------------------------------------------------------------
# Config, parameter tree, capacity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_config_equals_jax_field_by_field(which):
    got = _fields(getattr(configs, which)(ARCH))
    want = {k: v for k, v in _fields(getattr(jconfigs, which)(ARCH)).items()
            if k not in JAX_ONLY}
    assert got == want
    assert got["family"] == "moe" and got["attn_kind"] == "full"


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
    assert {p[0] for p in got} == {"embed", "final_norm", "dense_blocks",
                                   "moe_blocks"}


def test_full_width_size():
    """28.4B parameters in all; 7.22B at 12 layers (1 dense + 11 MoE), the
    depth chip_smoke's MoE C serves on one card."""
    cfg = configs.get(ARCH)
    assert params.param_count(lm.model_defs(cfg)) == 28_386_592_768
    assert params.param_count(lm.model_defs(
        dataclasses.replace(cfg, n_layers=12))) == 7_223_560_192


@pytest.mark.parametrize("which,n_tokens,want", [
    ("get_smoke", 1, 128), ("get_smoke", 16, 128), ("get_smoke", 8192, 2560),
    ("get_smoke", 412, 128), ("get_smoke", 413, 256),
    ("get", 1, 128), ("get", 16, 128), ("get", 8192, 1024),
    ("get", 1100, 128), ("get", 1101, 256)])
def test_moe_capacity_matches_jax(which, n_tokens, want):
    got = layers.moe_capacity(getattr(configs, which)(ARCH), n_tokens)
    assert got == jlayers.moe_capacity(getattr(jconfigs, which)(ARCH),
                                       n_tokens) == want


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _moe_layer(cfg):
    """Layer 0 of the MoE stack: (JAX's params, the port's)."""
    jparams, p = _weights(cfg)
    return jax.tree_util.tree_map(lambda a: a[0],
                                  jparams["moe_blocks"]["moe"]), \
        lm.layer(p, 0, "moe_blocks")["moe"]


def _jax_route(jp, x, jcfg):
    """JAX's router as ``repro.models.layers.moe_apply`` computes it."""
    xt = x.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xt, jlayers.cast(jp["router"], jcfg),
                        preferred_element_type=jnp.float32)
    return jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)[1]


def _moe_inputs(kind, cfg, rng):
    """x (B, S, D) f32. ``dropped``: 320 tokens shifted by 1, which the
    test's router sends to expert 0 first: past its 128-row capacity;
    ``ties``: every other token a zero row, whose uniform probabilities
    tie all experts."""
    tokens = {"ordinary": (2, 24), "dropped": (2, 160), "ties": (2, 24)}
    x = rng.normal(size=tokens[kind] + (cfg.d_model,)).astype(np.float32)
    if kind == "ties":
        x[:, ::2] = 0.0
    if kind == "dropped":
        x += 1.0
    return x


@pytest.mark.parametrize("kind", ["ordinary", "dropped", "ties"])
def test_moe_apply_matches_jax(kind):
    """Output within 1e-5 and the same experts, in ``lax.top_k``'s order.
    ``dropped``: expert 0's router column follows the inputs' sum, so every
    token ranks it first; the first 128 tokens keep it and the rest lose
    its contribution (against a capacity that drops nothing). ``ties``:
    the zero rows pick experts 0..k-1."""
    jcfg, cfg = _cfgs()
    jp, p = _moe_layer(cfg)
    if kind == "dropped":
        router = np.array(jp["router"])
        router[:, 0] = 0.5
        jp = dict(jp, router=jnp.asarray(router))
        p = dict(p, router=torch.from_numpy(router))
    x = _moe_inputs(kind, cfg, np.random.default_rng(11))
    want = jlayers.moe_apply(jp, jnp.asarray(x), jcfg)
    kernels.reset_launch_counts()
    got = layers.moe_apply(p, torch.from_numpy(x), cfg)
    assert sum(kernels.launch_counts().values()) == 0
    _close_scaled(got, want, 1e-5, kind)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, _, topi = layers.moe_route(p, xt, cfg)
    np.testing.assert_array_equal(topi.numpy(),
                                  np.asarray(_jax_route(jp, x, jcfg)))
    cap = layers.moe_capacity(cfg, xt.shape[0])
    per_expert = np.bincount(topi.numpy().ravel(), minlength=cfg.n_experts)
    assert (per_expert.max() > cap) == (kind == "dropped")
    if kind == "dropped":
        assert (topi[:, 0] == 0).all()
        roomy = layers.moe_apply(p, torch.from_numpy(x), dataclasses.replace(
            cfg, capacity_factor=8.0))
        moved = (got - roomy).reshape(-1, cfg.d_model).abs().amax(-1)
        scale = float(roomy.abs().max())
        assert (moved[:cap] <= 1e-6 * scale).all()
        assert (moved[cap:] > 1e-3 * scale).all()
    if kind == "ties":
        zero_rows = topi.numpy().reshape(x.shape[:2] + (-1,))[:, ::2]
        assert (zero_rows == np.arange(cfg.top_k)).all()


def test_moe_apply_bf16_matches_jax():
    """On identical bf16 inputs and weights the routing is equal and the
    output within k + 1 bf16 ulps of its scale: the combine adds k slots
    and the shared experts in bf16, k + 1 roundings, which XLA's CPU
    compiler may keep in f32 across a fused chain where the port rounds
    each step (the expert outputs are rounded once on both sides)."""
    jcfg, cfg = _cfgs("bfloat16")
    jp, p = _moe_layer(cfg)
    x = np.random.default_rng(13).normal(size=(2, 24, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(x.astype(np.float32)).bfloat16()
    got = layers.moe_apply(p, tx, cfg)
    assert got.dtype == torch.bfloat16
    _, _, topi = layers.moe_route(p, tx.reshape(-1, cfg.d_model), cfg)
    np.testing.assert_array_equal(topi.numpy(),
                                  np.asarray(_jax_route(jp, jx, jcfg)))
    want = np.asarray(jlayers.moe_apply(jp, jx, jcfg), np.float32)
    ulp = 2.0 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=(cfg.top_k + 1) * ulp)


# ---------------------------------------------------------------------------
# The serving path: prefill and four decode steps
# ---------------------------------------------------------------------------


def _tokens(vocab, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (STEPS, B)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _jit_forward():
    return jax.jit(jlm.forward, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _jit_decode():
    return jax.jit(jdecode.decode_step, static_argnums=1)


def _jax_run(jcfg, jparams, tokens, dec_tokens):
    logits = _jit_forward()(jparams, jcfg, jnp.asarray(tokens))
    state = jdecode.init_decode(jcfg, B, MAX_LEN)
    steps = []
    for t in dec_tokens:
        lg, state = _jit_decode()(jparams, jcfg, state, jnp.asarray(t))
        steps.append(lg)
    return logits, steps, state


def _port_run(cfg, p, tokens, dec_tokens):
    logits = lm.forward(p, cfg, torch.from_numpy(tokens))
    state = decode.init_decode(cfg, B, MAX_LEN, "cpu")
    steps = []
    for t in dec_tokens:
        lg, state = decode.decode_step(p, cfg, state, torch.from_numpy(t))
        steps.append(lg)
    return logits, steps, state


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_serving_path_matches_jax(backend):
    jcfg, cfg = _cfgs(backend=backend)
    jparams, p = _weights(cfg)
    tokens, dec_tokens = _tokens(cfg.vocab)
    want = _jax_run(jcfg, jparams, tokens, dec_tokens)
    kernels.reset_launch_counts()
    got = _port_run(cfg, p, tokens, dec_tokens)
    assert sum(kernels.launch_counts().values()) == 0   # plain versions
    _close(got[0], want[0], 1e-5, "forward logits")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        _close(g, w, 1e-5, f"decode step {i} logits")
    assert sorted(got[2].caches) == ["dense", "moe"]
    for stack, n in (("dense", cfg.first_dense),
                     ("moe", cfg.n_layers - cfg.first_dense)):
        for name in ("k", "v"):
            g = got[2].caches[stack][name]
            assert g.dtype == cfg.dtype
            assert tuple(g.shape) == (n, B, MAX_LEN, cfg.n_kv_heads,
                                      cfg.head_dim)
            _close_scaled(g, want[2].caches[stack][name], 1e-5,
                          f"{stack} {name}")
    assert got[2].cache_pos.dtype == torch.int32
    np.testing.assert_array_equal(got[2].cache_pos.numpy(),
                                  np.asarray(want[2].cache_pos))


@pytest.mark.parametrize("first_dense", [1, 0])
def test_decode_state_from_jax(first_dense):
    """JAX's nested moe caches convert with their layout (``"dense":
    None`` without leading dense layers), and a step from them equals
    JAX's step."""
    jcfg, cfg = _cfgs(first_dense=first_dense)
    jparams, p = _weights(cfg)
    tokens, dec_tokens = _tokens(cfg.vocab)
    _, _, jstate = _jax_run(jcfg, jparams, tokens, dec_tokens[:2])
    state = convert.decode_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate))
    if first_dense:
        assert state.caches["dense"]["k"].shape[0] == first_dense
    else:
        assert state.caches["dense"] is None
    assert state.caches["moe"]["v"].dtype == torch.float32
    assert state.cache_pos.dtype == torch.int32
    want, _ = _jit_decode()(jparams, jcfg, jstate, jnp.asarray(dec_tokens[2]))
    got, _ = decode.decode_step(p, cfg, state,
                                torch.from_numpy(dec_tokens[2]))
    _close(got, want, 1e-5)


def test_cast_params_keeps_norms_f32():
    _, cfg = _cfgs("bfloat16")
    _, p = _weights(cfg)
    cast = lm.cast_params(p, cfg)
    moe = cast["moe_blocks"]["moe"]
    assert cast["moe_blocks"]["ln2"]["scale"].dtype == torch.float32
    assert cast["dense_blocks"]["mlp"]["wo"].dtype == torch.bfloat16
    for w in (moe["router"], moe["w_gate"], moe["w_down"],
              moe["shared"]["wi_up"]):
        assert w.dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens(cfg.vocab)[0])
    torch.testing.assert_close(lm.forward(cast, cfg, tokens),
                               lm.forward(p, cfg, tokens), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# What raises
# ---------------------------------------------------------------------------


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cfg = configs.get_smoke(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params.init_params(lm.model_defs(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.init_decode(cfg, 2, 8)


def test_loss_fn_raises_for_moe():
    """The moe family trains now (``tests/test_torch_moe_train.py`` holds
    its gradients and steps to JAX's): on JAX's SMOKE weights the loss
    equals ``repro.models.lm.loss_fn``'s within 1e-5 and every parameter
    gets a finite gradient. What still raises is an encoder input, which
    belongs to the encdec family."""
    jcfg, cfg = _cfgs()
    jparams, p = _weights(cfg)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
             for k in ("tokens", "labels")}
    want = jlm.loss_fn(jparams, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    p = params.tree_map(lambda t: t.requires_grad_(), p)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm.loss_fn(p, cfg, tb)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    grads = torch.autograd.grad(loss, [t for _, t in params.leaves(p)])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(bool(g.any()) for g in grads)
    with pytest.raises(NotImplementedError, match="encoder inputs"):
        lm.loss_fn(p, cfg, dict(tb, enc_embeds=torch.zeros(2, 4, 64)))


def test_mla_raises():
    """MLA runs now (tests/test_torch_mla.py), and so does M-RoPE
    (tests/test_torch_vlm.py); the next unported architecture, xlstm-350m
    (the ssm family), raises, and so does MLA outside the moe family. At
    the default positions (M-RoPE's three streams equal) M-RoPE gives the
    RoPE logits exactly."""
    with pytest.raises(NotImplementedError, match="xlstm_350m"):
        configs.get("xlstm_350m")
    with pytest.raises(NotImplementedError, match="xlstm_350m"):
        configs.get_smoke("xlstm_350m")
    assert configs.get("deepseek_v2_236b").attn_kind == "mla"
    dense_mla = dataclasses.replace(configs.get_smoke("qwen2_5_3b"),
                                    attn_kind="mla")
    with pytest.raises(NotImplementedError, match="'mla'"):
        lm.model_defs(dense_mla)
    with pytest.raises(NotImplementedError, match="'mla'"):
        decode.init_decode(dense_mla, 2, 8, "cpu")
    cfg = configs.get_smoke(ARCH)
    quarter = cfg.head_dim // 4
    mrope = dataclasses.replace(cfg, pos_embedding="mrope",
                                mrope_sections=(quarter, quarter // 2,
                                                quarter // 2))
    _, p = _weights(cfg)
    tokens = torch.arange(8, dtype=torch.int32)[None]
    torch.testing.assert_close(lm.forward(p, mrope, tokens),
                               lm.forward(p, cfg, tokens), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The golden that chip_smoke.py (MoE A) holds the card against
# ---------------------------------------------------------------------------


def _golden_from_jax():
    jcfg, cfg = _cfgs()
    jparams, _ = _weights(cfg)
    tokens, dec_tokens = _tokens(jcfg.vocab)
    logits, steps, _ = _jax_run(jcfg, jparams, tokens, dec_tokens)
    out = {"params/" + "/".join(path): a for path, a in
           params.leaves(_jax_params())}
    out.update(tokens=tokens, decode_tokens=dec_tokens,
               logits=np.asarray(logits),
               decode_logits=np.stack([np.asarray(s) for s in steps]))
    return out


def _golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_jax_reproduces_the_moe_golden():
    fresh = _golden_from_jax()
    if os.environ.get("MOBY_REGEN_GOLDENS") == "1":
        np.savez(GOLDEN, **fresh)
    gold = _golden()
    assert sorted(gold) == sorted(fresh)
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_port_matches_the_moe_golden():
    gold = _golden()
    _, cfg = _cfgs()
    tree = params.from_leaves((tuple(k.split("/")[1:]), v)
                              for k, v in gold.items()
                              if k.startswith("params/"))
    p = convert.params_from_jax(tree, cfg)
    logits, steps, _ = _port_run(cfg, p, gold["tokens"],
                                 gold["decode_tokens"])
    _close(logits, gold["logits"], 1e-5)
    _close(torch.stack(steps), gold["decode_logits"], 1e-5)

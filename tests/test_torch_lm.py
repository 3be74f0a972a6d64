"""The port's dense-LM serving path against the JAX package's.

The same weights (JAX's ``init_params`` with key 0, carried across by
``convert.params_from_jax``) and the same seeded tokens go through
``repro.models`` and ``repro_torch.models`` at the SMOKE size of the four
dense architectures: configs and parameter trees field by field, each
layer, prefill (``lm.forward``) and four serving steps
(``decode.decode_step``). JAX runs on the CPU with its ``ref`` backend and
with its ``pallas`` backend (the attention kernels in interpret mode); the
port runs its plain attention versions. Tolerances: 1e-5 in f32 (the two
JAX backends agree within 1.6e-6 on the logits), of the values' own scale
for layer outputs and caches (see ``_close_scaled``); 3e-2 in bf16 against
``pallas`` (the two JAX backends differ by up to 1.4e-2 there).

``tests/goldens/lm_qwen2_5_3b_smoke.npz`` holds JAX's weights, tokens and
logits for qwen2.5-3B SMOKE in f32, so that ``chip_smoke.py`` can hold the
card against JAX without JAX. One test checks that JAX still produces it
(regenerate with ``MOBY_REGEN_GOLDENS=1``), another that the port matches
it.
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
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch import configs, convert, kernels  # noqa: E402
from repro_torch.models import decode, layers, lm, params  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

DENSE = ["qwen2_5_3b", "glm4_9b", "minitron_4b", "granite_20b"]
# Every architecture the port runs: the dense ones, the moe family's
# moonshot and deepseek-v2, the vlm family's qwen2-vl and the audio
# family's whisper (their own tests are tests/test_torch_moe.py,
# tests/test_torch_mla.py, tests/test_torch_vlm.py and
# tests/test_torch_audio.py).
PORTED = DENSE + ["moonshot_v1_16b_a3b", "deepseek_v2_236b", "qwen2_vl_2b",
                  "whisper_small"]
GOLDEN = (pathlib.Path(__file__).parent / "goldens"
          / "lm_qwen2_5_3b_smoke.npz")
B, S, MAX_LEN, STEPS = 2, 16, 32, 4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(arch, dtype="float32", backend="pallas"):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype=JDT[dtype],
                               backend=backend)
    return jcfg, dataclasses.replace(configs.get_smoke(arch),
                                     dtype=TDT[dtype])


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """JAX's f32 SMOKE weights (key 0) as a tree of numpy arrays."""
    jcfg, _ = _cfgs(arch)
    tree = jinit_params(jlm.model_defs(jcfg), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(arch, cfg):
    tree = _jax_params(arch)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        convert.params_from_jax(tree, cfg)


def _tokens(vocab, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (STEPS, B)).astype(np.int32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


def _close_scaled(got, want, tol, what=""):
    """Within ``tol`` of the values' own scale. Layer outputs and cached
    K/V reach magnitudes of 20-70 at SMOKE size (JAX's fanin init takes
    fan_in = heads for the 3-d attention weights); each op rounds as
    closely to float64 as JAX's does, but the two sum in other orders, so
    they agree to some ulps of that magnitude, not of 1."""
    want = np.asarray(want, np.float32)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())), what)


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


def _port_run(cfg, p, tokens, dec_tokens, dev="cpu"):
    logits = lm.forward(p, cfg, torch.from_numpy(tokens).to(dev))
    state = decode.init_decode(cfg, B, MAX_LEN, dev)
    steps = []
    for t in dec_tokens:
        lg, state = decode.decode_step(p, cfg, state,
                                       torch.from_numpy(t).to(dev))
        steps.append(lg)
    return logits, steps, state


# ---------------------------------------------------------------------------
# Configs and parameter trees
# ---------------------------------------------------------------------------


# The JAX config fields the port drops (see repro_torch/models/config.py).
JAX_ONLY = {"backend", "rules_override", "seq_shard"}


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix("torch.")
    return out


def _jax_fields(cfg):
    out = _fields(cfg)
    assert JAX_ONLY <= set(out)
    return {k: v for k, v in out.items() if k not in JAX_ONLY}


@pytest.mark.parametrize("arch", PORTED)
def test_configs_equal_jax_field_by_field(arch):
    assert _fields(configs.get(arch)) == _jax_fields(jconfigs.get(arch))
    assert _fields(configs.get_smoke(arch)) == \
        _jax_fields(jconfigs.get_smoke(arch))


@pytest.mark.parametrize("arch", sorted(set(jconfigs.ARCH_IDS) - set(PORTED)))
def test_unported_families_raise(arch):
    assert arch in configs.ARCH_IDS
    with pytest.raises(NotImplementedError, match="not ported"):
        configs.get(arch)
    with pytest.raises(NotImplementedError, match="not ported"):
        configs.get_smoke(arch)


@pytest.mark.parametrize("arch", PORTED)
def test_model_defs_equal_jax(arch):
    from repro.models.params import ParamDef as JDef
    jdefs = jax.tree_util.tree_leaves_with_path(
        jlm.model_defs(jconfigs.get(arch)),
        is_leaf=lambda x: isinstance(x, JDef))
    want = {tuple(k.key for k in path): (d.shape, d.logical_axes,
                                         np.dtype(d.dtype).name)
            for path, d in jdefs}
    got = {path: (d.shape, d.logical_axes, str(d.dtype).removeprefix(
        "torch.")) for path, d in params.leaves(lm.model_defs(
            configs.get(arch)))}
    assert got == want


def test_qwen2_5_3b_size():
    defs = lm.model_defs(configs.get("qwen2_5_3b"))
    assert params.param_count(defs) == 3_085_938_688
    assert params.param_bytes(defs) == 4 * 3_085_938_688


def test_params_from_jax_checks_the_tree():
    _, cfg = _cfgs("qwen2_5_3b")
    tree = dict(_jax_params("qwen2_5_3b"))
    tree["final_norm"] = {"scale": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_jax(tree, cfg)


def test_entry_points_default_to_the_card():
    """Serving and training default to the card: without one they raise.
    The train step takes no device of its own: it runs where the
    parameters are (here the CPU, with a numpy batch copied there)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from repro_torch.train import loop, optimizer, trainstep
    cfg = configs.get_smoke("qwen2_5_3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params.init_params(lm.model_defs(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.init_decode(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.fit(cfg, 1, 2, 8)
    p = params.init_params(lm.model_defs(cfg),
                           torch.Generator().manual_seed(0), "cpu")
    tokens = np.zeros((2, 8), np.int32)
    _, state, metrics = trainstep.make_train_step(
        cfg, optimizer.AdamWConfig())(p, optimizer.init(p),
                                      {"tokens": tokens, "labels": tokens})
    assert metrics["loss"].device.type == "cpu" and int(state.step) == 1


def test_init_params_draws_from_the_generator():
    cfg = configs.get_smoke("granite_20b")
    defs = lm.model_defs(cfg)
    a = params.init_params(defs, torch.Generator().manual_seed(3), "cpu")
    b = params.init_params(defs, torch.Generator().manual_seed(3), "cpu")
    for (pa, ta), (pb, tb) in zip(params.leaves(a), params.leaves(b)):
        assert pa == pb and torch.equal(ta, tb)
    assert params.leaves(a).__next__()[0] == ("blocks", "attn", "bk")
    table = a["embed"]["table"]
    assert abs(float(table.std()) - 0.02) < 2e-3
    assert not a["blocks"]["attn"]["bq"].any()


# ---------------------------------------------------------------------------
# Layers (f32, SMOKE)
# ---------------------------------------------------------------------------


def _rng_pair(rng, shape, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply_matches_jax(kind):
    rng = np.random.default_rng(1)
    jx, x = _rng_pair(rng, (2, 5, 64), 3.0)
    js, s = _rng_pair(rng, (64,))
    jb, b = _rng_pair(rng, (64,))
    p = {"scale": s, "bias": b}
    jp = {"scale": js, "bias": jb}
    _close(layers.norm_apply(p, x, kind), jlayers.norm_apply(jp, jx, kind),
           1e-5)


@pytest.mark.parametrize("fraction,theta", [(1.0, 1e6), (0.5, 1e4)])
def test_apply_rope_matches_jax(fraction, theta):
    rng = np.random.default_rng(2)
    jx, x = _rng_pair(rng, (2, 5, 4, 16))
    pos = rng.integers(0, 40, (2, 5)).astype(np.int32)
    _close(layers.apply_rope(x, torch.from_numpy(pos), theta, fraction),
           jlayers.apply_rope(jx, jnp.asarray(pos), theta, fraction), 1e-5)


def _layer0(arch, cfg):
    jparams, p = _weights(arch, cfg)
    return jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]), \
        lm.layer(p, 0)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "granite_20b",
                                  "minitron_4b"])   # swiglu, gelu, relu2
def test_mlp_apply_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _layer0(arch, cfg)
    jx, x = _rng_pair(np.random.default_rng(3), (2, 5, cfg.d_model))
    _close_scaled(layers.mlp_apply(p["mlp"], x, cfg),
                  jlayers.mlp_apply(jp["mlp"], jx, jcfg), 1e-5)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "granite_20b",
                                  "minitron_4b"])
def test_f32_products_match_jax_in_bf16(arch):
    """In bf16 JAX keeps the MLP's input projections and the logits in f32
    (``preferred_element_type``); so does the port. The MLP's bf16 output
    is then within half a bf16 ulp of JAX's (2**-9 of the value), and the
    f32 logits agree to f32 rounding, far below a bf16 ulp (2**-8)."""
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jp, p = _layer0(arch, cfg)
    x = np.random.default_rng(3).normal(size=(2, 5, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    x = torch.from_numpy(x.astype(np.float32)).bfloat16()
    got = layers.mlp_apply(p["mlp"], x, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(jlayers.mlp_apply(jp["mlp"], jx, jcfg), np.float32),
        rtol=2.0 ** -9, atol=1e-6)
    jparams, tparams = _weights(arch, cfg)
    logits = layers.unembed_apply(tparams["embed"], x, cfg)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jlayers.unembed_apply(
            jparams["embed"], jx, jcfg)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", DENSE)
def test_attn_apply_matches_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, p = _layer0(arch, cfg)
    jx, x = _rng_pair(np.random.default_rng(4), (2, 12, cfg.d_model))
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    _close_scaled(
        layers.attn_apply(p["attn"], x, cfg, torch.from_numpy(pos.copy())),
        jlayers.attn_apply(jp["attn"], jx, jcfg, jnp.asarray(pos)), 1e-5)


def _decode_case(arch, cache_pos, backend="pallas", max_len=MAX_LEN):
    jcfg, cfg = _cfgs(arch, backend=backend)
    jp, p = _layer0(arch, cfg)
    rng = np.random.default_rng(5)
    jx, x = _rng_pair(rng, (2, 1, cfg.d_model))
    shape = (2, max_len, cfg.n_kv_heads, cfg.head_dim)
    jck, ck = _rng_pair(rng, shape)
    jcv, cv = _rng_pair(rng, shape)
    pos = np.asarray(cache_pos, np.int32)
    want = jlayers.attn_decode_apply(jp["attn"], jx, jcfg, jck, jcv,
                                     jnp.asarray(pos),
                                     jnp.asarray(pos[:, None]))
    got = layers.attn_decode_apply(p["attn"], x, cfg, ck, cv,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(pos[:, None].copy()))
    assert got[1] is ck and got[2] is cv    # written in place
    for g, w, what in zip(got, want, ("out", "cache_k", "cache_v")):
        _close_scaled(g, w, 1e-5, what)


@pytest.mark.parametrize("arch", DENSE)
def test_attn_decode_apply_matches_jax(arch):
    _decode_case(arch, [3, 17])


@pytest.mark.parametrize("cache_pos", [MAX_LEN - 1, MAX_LEN])
def test_cache_write_clamps_as_dynamic_update_slice(cache_pos):
    """At cache_pos = max_len the write lands on the last slot, as JAX's
    dynamic_update_slice clamps it. Against the ``ref`` backend: the Pallas
    wrapper pads the cache to 512 positions and would attend one padded
    zero key at cache_pos + 1 = max_len + 1; the port has no padding."""
    _decode_case("qwen2_5_3b", [cache_pos, 5], backend="ref")


# ---------------------------------------------------------------------------
# The serving path: prefill and four decode steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,backend,tol", [
    ("float32", "ref", 1e-5), ("float32", "pallas", 1e-5),
    ("bfloat16", "pallas", 3e-2)])
@pytest.mark.parametrize("arch", DENSE)
def test_serving_path_matches_jax(arch, dtype, backend, tol):
    jcfg, cfg = _cfgs(arch, dtype, backend)
    jparams, p = _weights(arch, cfg)
    tokens, dec_tokens = _tokens(cfg.vocab)
    want = _jax_run(jcfg, jparams, tokens, dec_tokens)
    kernels.reset_launch_counts()
    got = _port_run(cfg, p, tokens, dec_tokens)
    assert sum(kernels.launch_counts().values()) == 0   # plain versions
    _close(got[0], want[0], tol, "forward logits")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        _close(g, w, tol, f"decode step {i} logits")
    for name in ("k", "v"):
        assert got[2].caches[name].dtype == cfg.dtype
        _close_scaled(got[2].caches[name], want[2].caches[name], tol, name)
    assert got[2].cache_pos.dtype == torch.int32
    np.testing.assert_array_equal(got[2].cache_pos.numpy(),
                                  np.asarray(want[2].cache_pos))


def test_cast_params_gives_the_same_logits():
    """Casting the matrices to bf16 once (serving) equals casting at each
    use; the norm parameters stay f32."""
    _, cfg = _cfgs("glm4_9b", "bfloat16")
    _, p = _weights("glm4_9b", cfg)
    cast = lm.cast_params(p, cfg)
    assert cast["final_norm"]["scale"].dtype == torch.float32
    assert cast["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert cast["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens(cfg.vocab)[0])
    torch.testing.assert_close(lm.forward(cast, cfg, tokens),
                               lm.forward(p, cfg, tokens), rtol=0, atol=0)


def test_decode_state_from_jax():
    jcfg, cfg = _cfgs("granite_20b", "bfloat16")
    jparams, p = _weights("granite_20b", cfg)
    tokens, dec_tokens = _tokens(cfg.vocab)
    _, _, jstate = _jax_run(jcfg, jparams, tokens, dec_tokens[:2])
    state = convert.decode_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate))
    assert state.caches["k"].dtype == torch.bfloat16
    assert state.cache_pos.dtype == torch.int32
    want, _ = _jit_decode()(jparams, jcfg, jstate, jnp.asarray(dec_tokens[2]))
    got, _ = decode.decode_step(p, cfg, state,
                                torch.from_numpy(dec_tokens[2]))
    _close(got, want, 3e-2)


# ---------------------------------------------------------------------------
# The golden that chip_smoke.py holds the card against
# ---------------------------------------------------------------------------


def _golden_from_jax():
    jcfg, _ = _cfgs("qwen2_5_3b")
    jparams, _ = _weights("qwen2_5_3b", _cfgs("qwen2_5_3b")[1])
    tokens, dec_tokens = _tokens(jcfg.vocab)
    logits, steps, _ = _jax_run(jcfg, jparams, tokens, dec_tokens)
    out = {"params/" + "/".join(path): a for path, a in
           params.leaves(_jax_params("qwen2_5_3b"))}
    out.update(tokens=tokens, decode_tokens=dec_tokens,
               logits=np.asarray(logits),
               decode_logits=np.stack([np.asarray(s) for s in steps]))
    return out


def _golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_jax_reproduces_the_lm_golden():
    fresh = _golden_from_jax()
    if os.environ.get("MOBY_REGEN_GOLDENS") == "1":
        np.savez(GOLDEN, **fresh)
    gold = _golden()
    assert sorted(gold) == sorted(fresh)
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_port_matches_the_lm_golden():
    gold = _golden()
    _, cfg = _cfgs("qwen2_5_3b")
    tree = params.from_leaves((tuple(k.split("/")[1:]), v)
                              for k, v in gold.items()
                              if k.startswith("params/"))
    p = convert.params_from_jax(tree, cfg)
    logits, steps, _ = _port_run(cfg, p, gold["tokens"],
                                 gold["decode_tokens"])
    _close(logits, gold["logits"], 1e-5)
    _close(torch.stack(steps), gold["decode_logits"], 1e-5)

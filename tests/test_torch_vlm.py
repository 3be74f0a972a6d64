"""The port's vlm family (qwen2-vl-2b: the dense stack with M-RoPE, its
inputs as embeddings) against the JAX package's.

The same weights (JAX's ``init_params`` with key 0, carried across by
``convert.params_from_jax``) and the same seeded inputs go through
``repro.models`` and ``repro_torch.models`` at SMOKE size: the config and
parameter tree field by field, ``apply_mrope`` at several splits of the
frequency bands, attention with M-RoPE positions whose three streams
differ, prefill from embeddings (``lm.forward(embeds=, positions=)``) and
four serving steps (``decode.decode_step``, which puts the cache position
on all three streams, as JAX's step does), and ``loss_fn``. JAX runs on
the CPU with its ``ref`` backend and with its ``pallas`` backend (the
attention kernels in interpret mode); the port runs its plain attention
versions. Tolerances as ``test_torch_lm.py``'s: 1e-5 in f32, of the
values' own scale for layer outputs and caches; 3e-2 in bf16.

The prefill's positions follow Qwen2-VL's rule for an image inside text
(``_mrope_positions``): a text token has the same id on the three
streams; an image's patch at (row, col) of its grid has (t0, t0 + row,
t0 + col), t0 the id after the text before it; text after the image
resumes at the image's largest id + 1.

``tests/goldens/lm_qwen2_vl_2b_smoke.npz`` holds JAX's f32 SMOKE weights,
embeddings, positions, decode tokens and logits, so that ``chip_smoke.py``
(VLM A) holds the card against JAX without JAX; regenerate with
``MOBY_REGEN_GOLDENS=1``.
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

ARCH = "qwen2_vl_2b"
GOLDEN = (pathlib.Path(__file__).parent / "goldens"
          / f"lm_{ARCH}_smoke.npz")
B, S, MAX_LEN, STEPS = 2, 16, 32, 4
# The prefill's layout: 3 text tokens, a 2 x 4 image grid, 5 text tokens.
TEXT_BEFORE, GRID, TEXT_AFTER = 3, (2, 4), 5
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
def _jax_params():
    """JAX's f32 SMOKE weights (key 0) as a tree of numpy arrays."""
    jcfg, _ = _cfgs()
    tree = jinit_params(jlm.model_defs(jcfg), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(cfg):
    tree = _jax_params()
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        convert.params_from_jax(tree, cfg)


def _mrope_positions(text_before, grid, text_after, batch):
    """(3, batch, S) M-RoPE ids of text, an image of ``grid`` = (rows,
    cols) patches, text: Qwen2-VL's rule (see the module docstring)."""
    rows, cols = grid
    t0 = text_before
    text = np.arange(text_before)
    r, c = np.divmod(np.arange(rows * cols), cols)
    after = t0 + max(rows, cols) + np.arange(text_after)
    streams = [np.concatenate([text, np.full(rows * cols, t0), after]),
               np.concatenate([text, t0 + r, after]),
               np.concatenate([text, t0 + c, after])]
    pos = np.stack(streams).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, batch, pos.shape[1])))


def _inputs(d_model, vocab, seed=7):
    """Embeddings (B, S, D) at the token table's scale, the text / image /
    text positions, and the decode tokens."""
    rng = np.random.default_rng(seed)
    embeds = (rng.normal(size=(B, S, d_model)) * 0.02).astype(np.float32)
    pos = _mrope_positions(TEXT_BEFORE, GRID, TEXT_AFTER, B)
    return embeds, pos, rng.integers(0, vocab, (STEPS, B)).astype(np.int32)


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


def _jax_run(jcfg, jparams, embeds, pos, dec_tokens):
    logits = _jit_forward()(jparams, jcfg, None, jnp.asarray(embeds),
                            jnp.asarray(pos))
    state = jdecode.init_decode(jcfg, B, MAX_LEN)
    steps = []
    for t in dec_tokens:
        lg, state = _jit_decode()(jparams, jcfg, state, jnp.asarray(t))
        steps.append(lg)
    return logits, steps, state


def _port_run(cfg, p, embeds, pos, dec_tokens):
    logits = lm.forward(p, cfg, embeds=torch.from_numpy(embeds),
                        positions=torch.from_numpy(pos))
    state = decode.init_decode(cfg, B, MAX_LEN, "cpu")
    steps = []
    for t in dec_tokens:
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
    assert got["family"] == "vlm" and got["pos_embedding"] == "mrope"
    assert sum(got["mrope_sections"]) == got["head_dim"] // 2


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


def test_full_width_size():
    """qwen2-vl-2b's language model from its definitions alone (the vision
    tower is a stub): 28 layers of 46.8M parameters and a tied 151,936 x
    1,536 table."""
    defs = lm.model_defs(configs.get(ARCH))
    assert params.param_count(defs) == 1_543_714_304
    assert params.param_bytes(defs) == 4 * 1_543_714_304


# ---------------------------------------------------------------------------
# M-RoPE and attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd,sections", [
    (16, (4, 2, 2)), (16, (2, 3, 3)), (16, (8, 0, 0)), (16, (0, 0, 8)),
    (128, (16, 24, 24))])
def test_apply_mrope_matches_jax(hd, sections):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 9)).astype(np.int32)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6, sections)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections)
    _close(got, want, 1e-5)


def test_mrope_equals_rope_on_equal_streams():
    """With the three streams equal (text), M-RoPE is RoPE, in both
    packages."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 7, 2, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 100, (2, 7)).astype(np.int32))
    torch.testing.assert_close(
        layers.apply_mrope(x, pos[None].expand(3, 2, 7), 1e6, (4, 2, 2)),
        layers.apply_rope(x, pos, 1e6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(x, pos[None].expand(3, 2, 7), 1e6, (4, 2, 3))


def test_default_positions_have_three_streams():
    cfg = configs.get_smoke(ARCH)
    pos = lm.default_positions(cfg, 2, 5)
    assert tuple(pos.shape) == (3, 2, 5) and pos.dtype == torch.int32
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jlm.default_positions(
            jconfigs.get_smoke(ARCH), 2, 5)))


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_attn_apply_with_mrope_matches_jax(backend):
    jcfg, cfg = _cfgs(backend=backend)
    jparams, p = _weights(cfg)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    x = np.random.default_rng(4).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    pos = _mrope_positions(TEXT_BEFORE, GRID, TEXT_AFTER, B)
    _close_scaled(
        layers.attn_apply(lm.layer(p, 0)["attn"], torch.from_numpy(x), cfg,
                          torch.from_numpy(pos)),
        jlayers.attn_apply(jp["attn"], jnp.asarray(x), jcfg,
                           jnp.asarray(pos)), 1e-5)


# ---------------------------------------------------------------------------
# The serving path and loss_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,backend,tol", [
    ("float32", "ref", 1e-5), ("float32", "pallas", 1e-5),
    ("bfloat16", "pallas", 3e-2)])
def test_serving_path_matches_jax(dtype, backend, tol):
    """Prefill from embeddings at the text / image / text positions, then
    four steps from empty caches; the step's positions are the cache
    position on all three streams (JAX's ``decode_step``)."""
    jcfg, cfg = _cfgs(dtype, backend)
    jparams, p = _weights(cfg)
    embeds, pos, dec_tokens = _inputs(cfg.d_model, cfg.vocab)
    want = _jax_run(jcfg, jparams, embeds, pos, dec_tokens)
    kernels.reset_launch_counts()
    got = _port_run(cfg, p, embeds, pos, dec_tokens)
    assert sum(kernels.launch_counts().values()) == 0   # plain versions
    _close(got[0], want[0], tol, "forward logits")
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        _close(g, w, tol, f"decode step {i} logits")
    for name in ("k", "v"):
        assert got[2].caches[name].dtype == cfg.dtype
        _close_scaled(got[2].caches[name], want[2].caches[name], tol, name)
    np.testing.assert_array_equal(got[2].cache_pos.numpy(),
                                  np.asarray(want[2].cache_pos))


def test_loss_fn_matches_jax():
    """``loss_fn`` from embeddings at the default positions (the three
    streams equal), the loss and finite gradients."""
    jcfg, cfg = _cfgs()
    jparams, p = _weights(cfg)
    embeds, _, _ = _inputs(cfg.d_model, cfg.vocab)
    labels = np.random.default_rng(5).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    want = jlm.loss_fn(jparams, jcfg, {"embeds": jnp.asarray(embeds),
                                       "labels": jnp.asarray(labels)})
    p = params.tree_map(lambda t: t.requires_grad_(), p)
    loss = lm.loss_fn(p, cfg, {"embeds": torch.from_numpy(embeds),
                               "labels": torch.from_numpy(labels)})
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    grads = torch.autograd.grad(loss, [t for _, t in params.leaves(p)])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(bool(g.any()) for g in grads)


def test_cast_params_gives_the_same_logits():
    _, cfg = _cfgs("bfloat16")
    _, p = _weights(cfg)
    cast = lm.cast_params(p, cfg)
    assert cast["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert cast["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    embeds, pos, _ = _inputs(cfg.d_model, cfg.vocab)
    kw = dict(embeds=torch.from_numpy(embeds),
              positions=torch.from_numpy(pos))
    torch.testing.assert_close(lm.forward(cast, cfg, **kw),
                               lm.forward(p, cfg, **kw), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The golden that chip_smoke.py (VLM A) holds the card against
# ---------------------------------------------------------------------------


def _golden_from_jax():
    jcfg, cfg = _cfgs()
    jparams, _ = _weights(cfg)
    embeds, pos, dec_tokens = _inputs(cfg.d_model, cfg.vocab)
    logits, steps, _ = _jax_run(jcfg, jparams, embeds, pos, dec_tokens)
    out = {"params/" + "/".join(path): a for path, a in
           params.leaves(_jax_params())}
    out.update(embeds=embeds, positions=pos, decode_tokens=dec_tokens,
               logits=np.asarray(logits),
               decode_logits=np.stack([np.asarray(s) for s in steps]))
    return out


def _golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


def test_jax_reproduces_the_vlm_golden():
    fresh = _golden_from_jax()
    if os.environ.get("MOBY_REGEN_GOLDENS") == "1":
        np.savez(GOLDEN, **fresh)
    gold = _golden()
    assert sorted(gold) == sorted(fresh)
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # The three streams differ inside the image span.
    assert len({tuple(s) for s in gold["positions"][:, 0]}) == 3


def test_port_matches_the_vlm_golden():
    gold = _golden()
    _, cfg = _cfgs()
    tree = params.from_leaves((tuple(k.split("/")[1:]), v)
                              for k, v in gold.items()
                              if k.startswith("params/"))
    p = convert.params_from_jax(tree, cfg)
    logits, steps, _ = _port_run(cfg, p, gold["embeds"], gold["positions"],
                                 gold["decode_tokens"])
    _close(logits, gold["logits"], 1e-5)
    _close(torch.stack(steps), gold["decode_logits"], 1e-5)

"""The port's MLA (deepseek-v2-236b) against the JAX package's.

The same weights (JAX's ``init_params``, carried across by
``convert.params_from_jax``) and the same seeded inputs go through
``repro.models`` and ``repro_torch.models``: the config and parameter
tree field by field, the MLA layer's pieces (``_queries`` with and without
the query LoRA, ``_latent_kv``, ``mla_apply``, ``mla_decode_apply`` and its
cache write), the plain versions of the two attention ops MLA runs through
(flash attention at a value head dim unequal to the qk head dim, against
JAX's dense and chunked attention; the absorbed decode attention, against
JAX's einsums), and the serving path (prefill and four decode steps) at
SMOKE size. JAX runs on the CPU with its ``ref`` backend and with its
``pallas`` backend (MLA's attention takes JAX's plain path on both: the
Pallas kernel needs equal head dims); the port runs its plain versions.

Tolerances: 1e-5 in f32, of the values' own scale for layer outputs and
caches (as ``test_torch_lm.py``); 3e-2 in bf16 on identical bf16 inputs
and weights (the dense tests' bf16 tolerance: the two packages round the
same values at other points of a fused chain). The serving path is held
in f32 only, as the moe tests hold it: in bf16 a router's near-tie can
send a token to another expert.

``tests/goldens/lm_deepseek_v2_236b_smoke.npz`` holds JAX's f32 SMOKE
weights, tokens and logits, so that ``chip_smoke.py`` (MLA A) holds the
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
from repro.models import mla as jmla  # noqa: E402
from repro.models.params import ParamDef as JDef  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro_torch import configs, convert, kernels, ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.mla_decode_attention import ops as mla_ops  # noqa: E402,E501
from repro_torch.kernels.mla_decode_attention import ref as mla_ref  # noqa: E402,E501
from repro_torch.models import decode, lm, mla, params  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek_v2_236b"
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
def _jax_params():
    """JAX's f32 SMOKE weights (key 0) as a tree of numpy arrays."""
    jcfg, _ = _cfgs()
    tree = jinit_params(jlm.model_defs(jcfg), jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(cfg):
    tree = _jax_params()
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        convert.params_from_jax(tree, cfg)


@functools.lru_cache(maxsize=None)
def _mla_params(q_lora: int):
    """One MLA layer's f32 weights from JAX's ``mla_defs`` (key 3), as
    numpy arrays, for SMOKE with the given query LoRA rank (0: ``wq``)."""
    jcfg, _ = _cfgs(q_lora=q_lora)
    tree = jinit_params(jmla.mla_defs(jcfg), jax.random.key(3))
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer(q_lora: int):
    tree = _mla_params(q_lora)
    return jax.tree_util.tree_map(jnp.asarray, tree), \
        params.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


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


def _pair(a, dtype):
    """The same values for both packages: (jnp array, torch tensor) in
    ``dtype`` (bf16 rounded once, on the torch side, and carried over)."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])
    return jnp.asarray(t.float().numpy()).astype(JDT[dtype]), t


# ---------------------------------------------------------------------------
# Config and parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["get", "get_smoke"])
def test_config_equals_jax_field_by_field(which):
    got = _fields(getattr(configs, which)(ARCH))
    want = {k: v for k, v in _fields(getattr(jconfigs, which)(ARCH)).items()
            if k not in JAX_ONLY}
    assert got == want
    assert got["family"] == "moe" and got["attn_kind"] == "mla"


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
    assert {p[2] for p in got if p[1] == "attn"} >= {"wq_a", "q_norm",
                                                     "wkv_a", "wk_b", "wv_b"}


def test_full_width_size():
    """235.7B parameters in all, as JAX counts them; 29.19B at 8 layers
    (1 dense + 7 MoE), the depth chip_smoke's MLA C serves on one card."""
    cfg = configs.get(ARCH)
    want = sum(int(np.prod(d.shape)) for d in jax.tree_util.tree_leaves(
        jlm.model_defs(jconfigs.get(ARCH)),
        is_leaf=lambda x: isinstance(x, JDef)))
    assert params.param_count(lm.model_defs(cfg)) == want == 235_741_434_880
    assert params.param_count(lm.model_defs(
        dataclasses.replace(cfg, n_layers=8))) == 29_191_377_920


# ---------------------------------------------------------------------------
# The MLA layer
# ---------------------------------------------------------------------------


def _x(cfg, dtype, s=S, seed=5):
    rng = np.random.default_rng(seed)
    return _pair(rng.normal(size=(B, s, cfg.d_model)), dtype)


def _positions(s=S, offset=0):
    pos = np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32),
                          (B, s)).copy()
    return jnp.asarray(pos), torch.from_numpy(pos)


@pytest.mark.parametrize("q_lora", [32, 0], ids=["q_lora", "wq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_queries_match_jax(q_lora, dtype):
    jcfg, cfg = _cfgs(dtype, q_lora=q_lora)
    jp, p = _layer(q_lora)
    assert ("wq" in p) == (q_lora == 0)
    jx, x = _x(cfg, dtype)
    got = mla._queries(p, x, cfg)
    assert got.dtype == cfg.dtype
    assert tuple(got.shape) == (B, S, cfg.n_heads,
                                cfg.qk_nope_dim + cfg.qk_rope_dim)
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close_scaled(got, jmla._queries(jp, jx, jcfg), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_latent_kv_matches_jax(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp, p = _layer(cfg.q_lora)
    jx, x = _x(cfg, dtype)
    jpos, pos = _positions(offset=3)
    c_kv, k_rope = mla._latent_kv(p, x, cfg, pos)
    want = jmla._latent_kv(jp, jx, jcfg, jpos)
    assert tuple(c_kv.shape) == (B, S, cfg.kv_lora)
    assert tuple(k_rope.shape) == (B, S, 1, cfg.qk_rope_dim)
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close_scaled(c_kv, want[0], tol, "c_kv")
    _close_scaled(k_rope, want[1], tol, "k_rope")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_matches_jax(dtype, causal):
    """Prefill: the latent expanded to 4 heads of qk dim 24 and value dim
    16, through the flash attention op's plain version (JAX: its plain
    attention)."""
    jcfg, cfg = _cfgs(dtype)
    jp, p = _layer(cfg.q_lora)
    jx, x = _x(cfg, dtype)
    jpos, pos = _positions()
    kernels.reset_launch_counts()
    got = mla.mla_apply(p, x, cfg, pos, causal)
    assert sum(kernels.launch_counts().values()) == 0
    assert got.dtype == cfg.dtype and tuple(got.shape) == (B, S, cfg.d_model)
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close_scaled(got, jmla.mla_apply(jp, jx, jcfg, jpos, causal), tol)


def _caches(cfg, dtype, rng):
    shape = (B, MAX_LEN)
    ckv = rng.normal(size=shape + (cfg.kv_lora,))
    krope = rng.normal(size=shape + (cfg.qk_rope_dim,))
    return _pair(ckv, dtype), _pair(krope, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_apply_matches_jax(dtype):
    """One absorbed decode step over a filled cache at ragged positions:
    the output and both caches (written in place, returned as the same
    tensors)."""
    jcfg, cfg = _cfgs(dtype)
    jp, p = _layer(cfg.q_lora)
    rng = np.random.default_rng(9)
    (jckv, ckv), (jkr, kr) = _caches(cfg, dtype, rng)
    jx, x = _x(cfg, dtype, s=1, seed=10)
    cache_pos = np.array([5, 21], np.int32)
    jcp, cp = jnp.asarray(cache_pos), torch.from_numpy(cache_pos)
    want = jmla.mla_decode_apply(jp, jx, jcfg, jckv, jkr, jcp, jcp[:, None])
    kernels.reset_launch_counts()
    out, ckv2, kr2 = mla.mla_decode_apply(p, x, cfg, ckv, kr, cp, cp[:, None])
    assert sum(kernels.launch_counts().values()) == 0
    assert ckv2 is ckv and kr2 is kr
    assert out.dtype == cfg.dtype and tuple(out.shape) == (B, 1, cfg.d_model)
    tol = 1e-5 if dtype == "float32" else 3e-2
    _close_scaled(out, want[0], tol, "out")
    _close_scaled(ckv, want[1], tol, "ckv")
    _close_scaled(kr, want[2], tol, "krope")


def test_cache_write_clamps_at_the_last_position():
    """A request at or past S_max writes its slot S_max - 1, as
    ``dynamic_update_slice`` clamps the start, and JAX's output matches."""
    jcfg, cfg = _cfgs()
    jp, p = _layer(cfg.q_lora)
    rng = np.random.default_rng(12)
    (jckv, ckv), (jkr, kr) = _caches(cfg, "float32", rng)
    before = ckv.clone()
    jx, x = _x(cfg, "float32", s=1, seed=13)
    cache_pos = np.array([MAX_LEN - 1, MAX_LEN + 3], np.int32)
    jcp, cp = jnp.asarray(cache_pos), torch.from_numpy(cache_pos)
    want = jmla.mla_decode_apply(jp, jx, jcfg, jckv, jkr, jcp, jcp[:, None])
    out, _, _ = mla.mla_decode_apply(p, x, cfg, ckv, kr, cp, cp[:, None])
    changed = (ckv != before).any(-1)
    assert changed[:, MAX_LEN - 1].all() and int(changed.sum()) == B
    _close_scaled(ckv, want[1], 1e-5, "ckv")
    _close_scaled(kr, want[2], 1e-5, "krope")
    _close_scaled(out, want[0], 1e-5, "out")


# ---------------------------------------------------------------------------
# The two attention ops' plain versions at MLA's shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["dense", "chunked"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("kv,g", [(4, 1), (2, 3)], ids=["G1", "G3"])
def test_flash_ref_at_vd_ne_hd_matches_jax(path, causal, kv, g):
    """``flash_attention_ref`` with qk dim 24 and value dim 16 against
    JAX's ``_dense_attention`` and ``_chunked_attention`` (1,100 positions:
    more than one of its 1,024-key chunks), G = 1 and G = 3."""
    sq = 40 if path == "dense" else 1100
    hd, vd = 24, 16
    rng = np.random.default_rng(sq + kv + causal)
    q = rng.normal(size=(1, sq, kv * g, hd)).astype(np.float32)
    k = rng.normal(size=(1, sq, kv, hd)).astype(np.float32)
    v = rng.normal(size=(1, sq, kv, vd)).astype(np.float32)
    fn = jlayers._dense_attention if path == "dense" else \
        jlayers._chunked_attention
    want = fn(jnp.asarray(q).reshape(1, sq, kv, g, hd), jnp.asarray(k),
              jnp.asarray(v), causal)
    got = fa_ref.flash_attention_ref(
        torch.from_numpy(q).transpose(1, 2), torch.from_numpy(k).transpose(
            1, 2), torch.from_numpy(v).transpose(1, 2), causal)
    assert tuple(got.shape) == (1, kv * g, sq, vd)
    _close(got.transpose(1, 2), np.asarray(want).reshape(1, sq, kv * g, vd),
           1e-5)


def _jax_absorbed(q_lat, q_rope, ckv, krope, lengths, scale, dtype):
    """JAX's einsums of ``mla_decode_apply`` from the scores to o_lat."""
    s = (jnp.einsum("bhr,bsr->bhs", q_lat, ckv,
                    preferred_element_type=jnp.float32)
         + jnp.einsum("bhk,bsk->bhs", q_rope, krope,
                      preferred_element_type=jnp.float32)) * scale
    mask = jnp.arange(ckv.shape[1])[None] < lengths[:, None]
    s = jnp.where(mask[:, None], s, jlayers._NEG_INF)
    w = jax.nn.softmax(s, axis=-1).astype(dtype)
    return jnp.einsum("bhs,bsr->bhr", w, ckv,
                      preferred_element_type=jnp.float32).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,p,h", [(16, 8, 4), (512, 64, 8)])
def test_mla_decode_ref_matches_jax(dtype, r, p, h):
    """``mla_decode_attention_ref`` against JAX's einsums at SMOKE's and
    the full width's latent and rope dims, lengths 1, 37 and S."""
    s = 80
    rng = np.random.default_rng(r + h)
    scale = (16 + 8) ** -0.5 if r == 16 else 192 ** -0.5
    ins = [_pair(rng.normal(size=shape), dtype) for shape in
           ((3, h, r), (3, h, p), (3, s, r), (3, s, p))]
    lengths = np.array([1, 37, s], np.int32)
    want = _jax_absorbed(*(j for j, _ in ins), jnp.asarray(lengths), scale,
                         JDT[dtype])
    got = mla_ref.mla_decode_attention_ref(*(t for _, t in ins),
                                           torch.from_numpy(lengths), scale)
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (3, h, r)
    _close(got, want, 1e-5 if dtype == "float32" else 2 ** -8)


def test_mla_decode_ref_masks_past_the_length():
    """Positions at or past a request's length do not change its output;
    a length of 0 gives 0."""
    rng = np.random.default_rng(1)
    q_lat, q_rope, ckv, krope = (torch.from_numpy(rng.normal(size=sh)).float()
                                 for sh in ((2, 4, 16), (2, 4, 8),
                                            (2, 30, 16), (2, 30, 8)))
    lengths = torch.tensor([0, 11], dtype=torch.int32)
    got = ops.mla_decode_attention(q_lat, q_rope, ckv, krope, lengths, 0.2)
    ckv2, krope2 = ckv.clone(), krope.clone()
    ckv2[:, 11:] = 1e3
    krope2[:, 11:] = -1e3
    again = ops.mla_decode_attention(q_lat, q_rope, ckv2, krope2, lengths,
                                     0.2)
    assert torch.equal(got, again)
    assert (got[0] == 0).all()


def test_routes_at_mla_dims():
    """Flash attention: bf16 at (192, 128) to the tensor-core kernel, f32
    at (192, 128) and both dtypes at (24, 16) to the 3xTF32 kernel, other
    unequal pairs raise; MLA decode: bf16 at (512, 64) to its tensor-core
    instance, f32 at (512, 64) to its 3xTF32 one, both dtypes at (16, 8)
    to its SIMT one, other dims raise."""
    assert fa_ops.route(torch.bfloat16, 192, 128) == "tc"
    assert fa_ops.route(torch.bfloat16, 128, 128) == "tc"
    assert fa_ops.route(torch.float32, 192, 128) == "tf32x3"
    assert fa_ops.route(torch.float32, 24, 16) == "tf32x3"
    assert fa_ops.route(torch.bfloat16, 24, 16) == "tf32x3"
    for dtype, hd, vd in ((torch.float32, 192, 64),
                          (torch.bfloat16, 128, 64), (torch.float32, 64, 128)):
        with pytest.raises(ValueError, match="head dims"):
            fa_ops.route(dtype, hd, vd)
    assert mla_ops.route(torch.bfloat16, 512, 64) == "tc"
    assert mla_ops.route(torch.bfloat16, 16, 8) == "simt"
    assert mla_ops.route(torch.float32, 512, 64) == "tf32x3"
    assert mla_ops.route(torch.float32, 16, 8) == "simt"
    with pytest.raises(ValueError, match="latent"):
        mla_ops.route(torch.bfloat16, 256, 64)
    with pytest.raises(TypeError, match="dtype"):
        mla_ops.route(torch.float16, 512, 64)


# The tensor-core instance's schedule at the shapes chip_smoke runs it:
# (lengths, S, heads); the clusters are an H100's (132 SMs: 66 clusters of
# two CTAs above 64 heads, 132 of one at 64 or fewer).
_MLA_C_LENGTHS = [31145, 10511, 20000, 28000, 12345, 16385, 30001, 8193,
                  24576, 19999, 11000, 29000, 15000, 27000, 13000, 22222]
PLAN_CASES = {
    "mla_c": (_MLA_C_LENGTHS, 32768, 128),
    "one_request_32k": ([32768], 32768, 128),
    "64_short": ([int(x) for x in np.random.default_rng(3).integers(
        1, 300, 64)], 2048, 128),
    "zero_length_inside": ([500, 64, 0, 129, 1000], 1000, 128),
    "h64": ([700, 333], 700, 64),
    "h65": ([1, 700], 700, 65),
    "h100": ([0, 77, 700], 700, 100),
    "h128_past_s": ([70000, 5, 64, 65], 4096, 128),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_decode_splits_fill_the_card(case):
    """The tensor-core instance's plan (``ops.plan``, the schedule the
    kernel computes on the device from the lengths): every live tile of
    every request is covered exactly once, the clusters' runs differ by
    at most one tile, a request's partials are the slots cluster +
    request the merge reads (``merge_clusters``), and there are at most
    clusters + B of them."""
    lengths, s, h = PLAN_CASES[case]
    n_clusters = 132 // mla_ops.cluster_size(h)
    assert mla_ops.cluster_size(h) == (1 if h <= 64 else 2)
    segs = mla_ops.plan(lengths, s, n_clusters)
    covered = {}
    per_cluster = [0] * n_clusters
    for c, b, j0, j1 in segs:
        assert 0 <= j0 < j1 <= mla_ops.live_tiles(lengths[b], s)
        for j in range(j0, j1):
            assert (b, j) not in covered
            covered[b, j] = c
        per_cluster[c] += j1 - j0
    assert set(covered) == {(b, j) for b, x in enumerate(lengths)
                            for j in range(mla_ops.live_tiles(x, s))}
    assert max(per_cluster) - min(per_cluster) <= 1
    slots = [c + b for c, b, _, _ in segs]
    assert len(set(slots)) == len(slots)
    assert max(slots, default=0) < n_clusters + len(lengths)
    merge = mla_ops.merge_clusters(lengths, s, n_clusters)
    for b in range(len(lengths)):
        assert sorted(merge[b]) == sorted(c for c, bb, _, _ in segs
                                          if bb == b)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_tf32x3_runs_fill_the_card(case):
    """The f32 instance's schedule: ``ops.plan`` over tiles of 32 positions
    and ``tf_runs`` runs (one 16-head CTA an SM on 132 SMs: 16 runs at 128
    heads). Every live tile of every request is covered exactly once, the
    runs differ by at most one tile, a request's partials are the slots
    run + request the merge reads, and there are at most runs + B of
    them."""
    lengths, s, h = PLAN_CASES[case]
    tile = mla_ops.TF_TILE
    n_runs = mla_ops.tf_runs(h, 132)
    segs = mla_ops.plan(lengths, s, n_runs, tile)
    covered, per_run = set(), [0] * n_runs
    for c, b, j0, j1 in segs:
        assert 0 <= j0 < j1 <= mla_ops.live_tiles(lengths[b], s, tile)
        for j in range(j0, j1):
            assert (b, j) not in covered
            covered.add((b, j))
        per_run[c] += j1 - j0
    assert covered == {(b, j) for b, x in enumerate(lengths)
                       for j in range(mla_ops.live_tiles(x, s, tile))}
    assert max(per_run) - min(per_run) <= 1
    slots = [c + b for c, b, _, _ in segs]
    assert len(set(slots)) == len(slots)
    assert max(slots, default=0) < n_runs + len(lengths)
    merge = mla_ops.merge_clusters(lengths, s, n_runs, tile)
    for b in range(len(lengths)):
        assert sorted(merge[b]) == sorted(c for c, bb, _, _ in segs
                                          if bb == b)


def test_tf32x3_runs_by_heads():
    """Runs of the f32 instance: as many groups of ceil(H / 16) CTAs as
    one an SM allows (MLA B's 128 heads on an H100: 16), at least one."""
    assert mla_ops.tf_runs(128, 132) == 16
    assert mla_ops.tf_runs(100, 132) == 18
    assert mla_ops.tf_runs(16, 132) == 132
    assert mla_ops.tf_runs(128, 132, ctas_per_sm=2) == 33
    assert mla_ops.tf_runs(128, 2) == 1


@pytest.mark.parametrize("n_runs", [7, 16])
def test_tf32x3_segments_merge_to_the_unsplit_softmax(n_runs):
    """The f32 instance's split of the softmax: ``ref.py`` run segment by
    segment along ``ops.plan`` over tiles of 32 positions (each segment's
    unnormalised partial, ``mla_decode_partial_ref``), merged with the
    merge's formula (``mla_decode_merge_ref``), equals
    ``mla_decode_attention_ref`` unsplit within 1e-6 in f32, at
    deepseek-v2's (512, 64) and small S; a request of length 0 gives 0.
    7 runs cross request boundaries; 16 (MLA B's at 128 heads) leave runs
    of one or two tiles."""
    r, p, h, s = 512, 64, 8, 300
    lengths = [130, 0, 64, 1, 300, 77]
    rng = np.random.default_rng(6)
    q_lat, q_rope, ckv, krope = (
        torch.from_numpy(rng.normal(size=sh)).float()
        for sh in ((6, h, r), (6, h, p), (6, s, r), (6, s, p)))
    scale = (r // 4 + p) ** -0.5
    want = mla_ref.mla_decode_attention_ref(
        q_lat, q_rope, ckv, krope, torch.tensor(lengths), scale)
    tile = mla_ops.TF_TILE
    segs = mla_ops.plan(lengths, s, n_runs, tile)
    for b, n in enumerate(lengths):
        sl = slice(b, b + 1)
        parts = [mla_ref.mla_decode_partial_ref(
            q_lat[sl], q_rope[sl], ckv[sl], krope[sl], j0 * tile,
            min(j1 * tile, n), scale)
            for c, bb, j0, j1 in segs if bb == b]
        assert len(parts) == len(
            mla_ops.merge_clusters(lengths, s, n_runs, tile)[b])
        if not parts:
            assert n == 0 and (want[b] == 0).all()
            continue
        got = mla_ref.mla_decode_merge_ref(parts)
        torch.testing.assert_close(got, want[sl], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype,r,p,path", [
    (torch.bfloat16, 512, 64, "tc"), (torch.float32, 512, 64, "tf32x3"),
    (torch.float32, 16, 8, "simt"), (torch.bfloat16, 16, 8, "simt")])
def test_decode_launches_its_instance(monkeypatch, dtype, r, p, path):
    """On the card ``mla_decode_attention`` calls the C entry point once
    with its instance's partition (the clusters, the runs or the SIMT
    splits) and advances the kernel's counter and its instance's. The
    library is a stand-in that records the calls (the CPU has no card)."""
    import contextlib
    from repro_torch.kernels import _build, _launch
    called = []

    class Lib:
        def moby_mla_decode_attention(self, *args):
            called.append(args)
            return 0
    monkeypatch.setattr(_launch, "dispatch_device", lambda kernel, t: "cuda")
    monkeypatch.setattr(_launch, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(_launch, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(mla_ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(mla_ops, "_clusters", lambda index, size: 132 // size)
    monkeypatch.setattr(mla_ops, "_runs",
                        lambda index, h: mla_ops.tf_runs(h, 132))
    b, h, s = 2, 128, 512
    ins = [torch.zeros(shape, dtype=dtype)
           for shape in ((b, h, r), (b, h, p), (b, s, r), (b, s, p))]
    kernels.reset_launch_counts()
    out = mla_ops.mla_decode_attention(
        *ins, torch.tensor([260, 260], dtype=torch.int32), 0.07)
    assert out.shape == (b, h, r) and out.dtype == dtype
    (args,) = called
    n_part = {"tc": 66, "tf32x3": 16,
              "simt": mla_ops.n_splits(b, h, s, 132)}[path]
    assert args[15] == n_part
    assert args[16] == int(dtype == torch.bfloat16)
    assert kernels.launch_counts()["mla_decode_attention"] == 1
    assert mla_ops.route_launches == {k: int(k == path)
                                      for k in ("tc", "tf32x3", "simt")}


def test_simt_splits_fill_the_card():
    """The SIMT instance keeps equal splits of each request: about four
    8-head blocks an SM, never finer than a tile of 32 positions."""
    assert mla_ops.n_splits(2, 4, 32, 132) == 1
    assert mla_ops.n_splits(2, 128, 512, 132) == 16
    assert mla_ops.n_splits(64, 128, 4096, 132) == 1


@pytest.mark.parametrize("size", ["smoke", "full_width"])
def test_plan_segments_merge_to_the_unsplit_softmax(size):
    """``ref.py`` run segment by segment along the plan (each segment's
    unnormalised partial, ``mla_decode_partial_ref``), merged with the
    merge's formula (``mla_decode_merge_ref``), equals
    ``mla_decode_attention_ref`` unsplit within 1e-6 in f32; a request of
    length 0 gives 0. SMOKE's dims and deepseek-v2's (512, 64) at small
    S, 7 clusters, so runs cross request boundaries."""
    r, p, h, s = (16, 8, 4, 200) if size == "smoke" else (512, 64, 8, 300)
    lengths = [130, 0, 64, 1, 300 if s == 300 else 200, 77]
    rng = np.random.default_rng(5)
    q_lat, q_rope, ckv, krope = (
        torch.from_numpy(rng.normal(size=sh)).float()
        for sh in ((6, h, r), (6, h, p), (6, s, r), (6, s, p)))
    scale = (r // 4 + p) ** -0.5
    want = mla_ref.mla_decode_attention_ref(
        q_lat, q_rope, ckv, krope, torch.tensor(lengths), scale)
    tile = mla_ops.TC_TILE
    for b, n in enumerate(lengths):
        parts = []
        for c, bb, j0, j1 in mla_ops.plan(lengths, s, 7):
            if bb == b:
                sl = slice(b, b + 1)
                parts.append(mla_ref.mla_decode_partial_ref(
                    q_lat[sl], q_rope[sl], ckv[sl], krope[sl], j0 * tile,
                    min(j1 * tile, n), scale))
        got = mla_ref.mla_decode_merge_ref(parts)[0] if parts \
            else torch.zeros(h, r)
        assert len(parts) == len(mla_ops.merge_clusters(lengths, s, 7)[b])
        torch.testing.assert_close(got, want[b], rtol=1e-6, atol=1e-6)


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
        for name, width in (("ckv", cfg.kv_lora),
                            ("krope", cfg.qk_rope_dim)):
            g = got[2].caches[stack][name]
            assert g.dtype == cfg.dtype
            assert tuple(g.shape) == (n, B, MAX_LEN, width)
            _close_scaled(g, want[2].caches[stack][name], 1e-5,
                          f"{stack} {name}")
    np.testing.assert_array_equal(got[2].cache_pos.numpy(),
                                  np.asarray(want[2].cache_pos))


def test_decode_state_from_jax():
    """JAX's nested MLA caches convert with their layout, and a step from
    them equals JAX's step."""
    jcfg, cfg = _cfgs()
    jparams, p = _weights(cfg)
    tokens, dec_tokens = _tokens(cfg.vocab)
    _, _, jstate = _jax_run(jcfg, jparams, tokens, dec_tokens[:2])
    state = convert.decode_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate))
    assert sorted(state.caches["dense"]) == ["ckv", "krope"]
    assert state.caches["moe"]["ckv"].shape == (
        cfg.n_layers - cfg.first_dense, B, MAX_LEN, cfg.kv_lora)
    assert state.caches["moe"]["krope"].dtype == torch.float32
    assert state.cache_pos.dtype == torch.int32
    want, _ = _jit_decode()(jparams, jcfg, jstate, jnp.asarray(dec_tokens[2]))
    got, _ = decode.decode_step(p, cfg, state,
                                torch.from_numpy(dec_tokens[2]))
    _close(got, want, 1e-5)


def test_cast_params_keeps_mla_norms_f32():
    _, cfg = _cfgs("bfloat16")
    _, p = _weights(cfg)
    cast = lm.cast_params(p, cfg)
    attn = cast["moe_blocks"]["attn"]
    assert attn["q_norm"]["scale"].dtype == torch.float32
    assert attn["kv_norm"]["scale"].dtype == torch.float32
    for name in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
        assert attn[name].dtype == torch.bfloat16
    tokens = torch.from_numpy(_tokens(cfg.vocab)[0])
    torch.testing.assert_close(lm.forward(cast, cfg, tokens),
                               lm.forward(p, cfg, tokens), rtol=0, atol=0)


def test_init_cast_params_draws_the_cast_tree():
    """``lm.init_cast_params`` (MLA C's weights, drawn a layer at a time)
    gives ``cast_params(init_params(...))``'s tree: the same paths, shapes
    and dtypes (norms f32, the rest bf16), each leaf with its
    initialiser's spread (the fan-in of the layer's own shape), and a
    forward that runs."""
    _, cfg = _cfgs("bfloat16")
    got = lm.init_cast_params(cfg, torch.Generator().manual_seed(0))
    want = lm.cast_params(params.init_params(
        lm.model_defs(cfg), torch.Generator().manual_seed(0), "cpu"), cfg)
    assert {p: (tuple(t.shape), t.dtype) for p, t in params.leaves(got)} == \
        {p: (tuple(t.shape), t.dtype) for p, t in params.leaves(want)}
    for (path, g), (_, w) in zip(params.leaves(got), params.leaves(want)):
        if g.numel() >= 1024 and float(w.float().std()) > 0:
            ratio = float(g.float().std() / w.float().std())
            assert 0.8 < ratio < 1.25, (path, ratio)
    tokens = torch.from_numpy(_tokens(cfg.vocab)[0])
    assert torch.isfinite(lm.forward(got, cfg, tokens)).all()


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


def test_loss_fn_raises_for_deepseek():
    """deepseek-v2 trains now (``tests/test_torch_moe_train.py`` holds its
    gradients and steps to JAX's): on JAX's SMOKE weights in f32 the loss
    equals ``repro.models.lm.loss_fn``'s within 1e-5 and every parameter,
    MLA's included, gets a finite gradient. An encoder input still
    raises."""
    jcfg, cfg = _cfgs()
    jparams, p = _weights(cfg)
    batch = {k: _tokens(cfg.vocab, seed)[0] for k, seed in
             (("tokens", 7), ("labels", 8))}
    want = jlm.loss_fn(jparams, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    p = params.tree_map(lambda t: t.requires_grad_(), p)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm.loss_fn(p, cfg, tb)
    assert abs(float(loss.detach()) - float(want)) <= 1e-5
    leaves = list(params.leaves(p))
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    got = dict(zip((path for path, _ in leaves), grads))
    for name in ("wkv_a", "wk_b", "wv_b", "wq_b", "wo"):
        assert bool(got[("moe_blocks", "attn", name)].any()), name
    with pytest.raises(NotImplementedError, match="encoder inputs"):
        lm.loss_fn(p, cfg, dict(tb, enc_embeds=torch.zeros(2, 4, 64)))


def test_flash_backward_raises_at_vd_ne_hd():
    """MLA's prefill attention has a gradient now (value dim 16, qk dim
    24): autograd through ``ops.flash_attention`` gives q and k gradients
    at the qk dim and v at the value dim, the plain gradient
    (``flash_attention_bwd_ref``), which equals autograd of the attention
    written out in float64 within 1e-6 of each gradient's scale (the
    plain forward computes in f32, so D = rowsum(dO * O) carries O's f32
    rounding), G = 1 and 2."""
    rng = np.random.default_rng(2)
    for kv in (4, 2):
        q = torch.from_numpy(rng.normal(size=(1, 4, 8, 24))).requires_grad_()
        k = torch.from_numpy(rng.normal(size=(1, kv, 8, 24))).requires_grad_()
        v = torch.from_numpy(rng.normal(size=(1, kv, 8, 16))).requires_grad_()
        do = torch.from_numpy(rng.normal(size=(1, 4, 8, 16)))
        out = ops.flash_attention(q, k, v, True)
        assert tuple(out.shape) == (1, 4, 8, 16)
        out.backward(do)
        got = (q.grad, k.grad, v.grad)
        assert [tuple(t.shape) for t in got] == [
            (1, 4, 8, 24), (1, kv, 8, 24), (1, kv, 8, 16)]
        direct = fa_ops.flash_attention_bwd(q.detach(), k.detach(),
                                            v.detach(), out.detach(), do,
                                            True)
        qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
        ke, ve = (t.repeat_interleave(4 // kv, dim=1) for t in (ka, va))
        s = (qa @ ke.transpose(-1, -2) * 24 ** -0.5).masked_fill(
            ~torch.ones(8, 8, dtype=torch.bool).tril(), float("-inf"))
        auto = torch.autograd.grad(torch.softmax(s, -1) @ ve, (qa, ka, va),
                                   do)
        for g, d, a in zip(got, direct, auto):
            torch.testing.assert_close(g, d, rtol=0, atol=0)
            scale = float(a.abs().max())
            torch.testing.assert_close(g, a, rtol=0, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# On the card (skips here)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_mla_kernels_match_plain_on_card():
    """The MLA decode kernel (its three instances) and flash attention at
    MLA's head dims agree with their plain versions on card tensors (f32
    within 2e-5, the f32 routes' tolerance; bf16 within 2e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    for dtype, r, p, h, lens in (
            (torch.bfloat16, 512, 64, 128, [1, 77, 300]),
            (torch.float32, 16, 8, 128, [1, 77, 300]),
            # The f32 instance: 128 heads (8 CTAs a run), 100 (a partial
            # group), an empty request between live ones.
            (torch.float32, 512, 64, 128, [1, 77, 300]),
            (torch.float32, 512, 64, 100, [300, 0, 33]),
            # Clusters of one CTA (64 heads), a nearly empty second CTA
            # (65), an empty request between live ones.
            (torch.bfloat16, 512, 64, 64, [300, 0, 77]),
            (torch.bfloat16, 512, 64, 65, [129, 0, 300])):
        ins = [torch.from_numpy(rng.normal(size=sh)).to(dev, dtype)
               for sh in ((3, h, r), (3, h, p), (3, 300, r), (3, 300, p))]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = mla_ops.mla_decode_attention(*ins, lengths, 0.07)
        want = mla_ref.mla_decode_attention_ref(*(t.float() for t in ins),
                                                lengths, 0.07)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    # (192, 128) in f32: 4 heads (4-warp blocks, an item each) and 132
    # (8-warp persistent blocks, runs of items).
    for dtype, hd, vd, h in ((torch.bfloat16, 192, 128, 4),
                             (torch.float32, 24, 16, 4),
                             (torch.float32, 192, 128, 4),
                             (torch.float32, 192, 128, 132)):
        q, k = (torch.from_numpy(rng.normal(size=(1, h, 130, hd))).to(
            dev, dtype) for _ in range(2))
        v = torch.from_numpy(rng.normal(size=(1, h, 130, vd))).to(dev, dtype)
        got = fa_ops.flash_attention(q, k, v, True)
        want = fa_ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                          True)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The golden that chip_smoke.py (MLA A) holds the card against
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


def test_jax_reproduces_the_mla_golden():
    fresh = _golden_from_jax()
    if os.environ.get("MOBY_REGEN_GOLDENS") == "1":
        np.savez(GOLDEN, **fresh)
    gold = _golden()
    assert sorted(gold) == sorted(fresh)
    for k in gold:
        np.testing.assert_allclose(fresh[k], gold[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_port_matches_the_mla_golden():
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

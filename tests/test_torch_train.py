"""The port's dense-LM training path against the JAX package's.

The same seeded numpy inputs go through ``repro`` and ``repro_torch`` on
the CPU, where every port op runs its plain PyTorch version:

* the attention gradients: ``flash_attention_bwd_ref`` against ``jax.vjp``
  of ``repro.models.layers._chunked_attention`` (what the JAX package's
  VJP around the flash kernel differentiates) and ``decode_attention_bwd_ref``
  against ``jax.vjp`` of ``decode_attention_ref``, at 2e-5 (f32) and 2e-2
  (bf16) of each gradient's scale; the differentiable ops
  (``ops.flash_attention``, ``ops.decode_attention``) run those plain
  gradients on the CPU, not autograd of the plain forward (F3);
* ``lm.loss_fn`` and its gradients on qwen2.5-3B SMOKE in f32 with JAX's
  weights (attention rescaled, see ``_jax_params``), ``remat`` "full" and
  "none", against ``jax.value_and_grad`` with
  the ``ref`` backend and the ``pallas`` backend in interpret mode (loss
  within 1e-5, every gradient within 2e-5 of its scale);
* three ``make_train_step`` steps (``grad_accum`` 1 and 2, and with a
  ``topk_compress`` hook) against JAX's ``make_train_step`` at the same
  tolerances; ``gradcomp`` with planted ties and half-way roundings
  exactly; ``TokenPipeline.batch_at`` exactly; checkpoints written by either
  package restored by the other;
* ``fit`` cut and resumed from a checkpoint equals the uncut run (the port
  alone: its initial parameters come from a torch generator).

The CUDA kernels run only on a card: the ``cuda``-marked tests skip here
(``python3 chip_smoke.py`` holds both backward kernels against their plain
versions and runs LM T's training on the card).
"""
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
from repro.data import tokens as jtokens  # noqa: E402
from repro.kernels.decode_attention import ref as jdec_ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.params import init_params as jinit_params  # noqa: E402
from repro.runtime import checkpoint as jcheckpoint  # noqa: E402
from repro.runtime import gradcomp as jgradcomp  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch import configs, convert, kernels, ops  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models import lm, params  # noqa: E402
from repro_torch.runtime import checkpoint, gradcomp  # noqa: E402
from repro_torch.train import loop, optimizer, trainstep  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "qwen2_5_3b"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


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


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    ja = jnp.asarray(a, JDT[dtype])
    return ja, torch.from_numpy(np.array(ja, np.float32)).to(TDT[dtype])


# ---------------------------------------------------------------------------
# The attention gradients
# ---------------------------------------------------------------------------

# (B, H, KV, SQ, SK, hd), causal: GQA, MQA and MHA; SQ past one 512-row
# query chunk of the JAX reference and not a multiple of it; keys longer
# than queries (non-causal); head dim 128 (in bf16 the tensor-core route's
# inputs on the card), ragged past a 128-row tile.
FLASH_BWD_CASES = [((1, 4, 2, 600, 600, 32), True),
                   ((2, 8, 2, 77, 77, 16), False),
                   ((1, 4, 1, 130, 130, 64), True),
                   ((1, 2, 2, 96, 700, 32), False),
                   ((1, 4, 2, 130, 130, 128), True)]


def _jax_flash_vjp(q, k, v, do, causal):
    """jax.vjp of the JAX package's chunked attention on (B, H, S, hd)
    operands, as ``repro/ops/api.py::_flash_bwd`` computes it."""
    def chunked(q, k, v):
        b, h, sq, hd = q.shape
        kv = k.shape[1]
        qg = q.transpose(0, 2, 1, 3).reshape(b, sq, kv, h // kv, hd)
        out = jlayers._chunked_attention(qg, k.transpose(0, 2, 1, 3),
                                         v.transpose(0, 2, 1, 3), causal)
        return out.reshape(b, sq, h, hd).transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(chunked, q, k, v)
    return vjp(do)


def _flash_bwd_inputs(shape, dtype):
    b, h, kv, sq, sk, hd = shape
    rng = np.random.default_rng(sq + sk + hd)
    return [_pair(rng.normal(size=s), dtype) for s in
            ((b, h, sq, hd), (b, kv, sk, hd), (b, kv, sk, hd),
             (b, h, sq, hd))]


@pytest.mark.parametrize("dtype", list(JDT))
@pytest.mark.parametrize("shape,causal", FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_jax_vjp(shape, causal, dtype):
    (jq, q), (jk, k), (jv, v), (jdo, do) = _flash_bwd_inputs(shape, dtype)
    want = _jax_flash_vjp(jq, jk, jv, jdo, causal)
    o = fa_ref.flash_attention_ref(q, k, v, causal)
    got = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TDT[dtype] and tuple(g.shape) == w.shape
        _close_scaled(g, w, TOL[dtype], name)


DECODE_BWD_CASES = [(2, 4, 4, 512, 64), (4, 8, 2, 300, 128),
                    (1, 8, 1, 700, 64), (2, 4, 2, 32, 16),
                    # minitron-4b's G = 3, glm4-9b's 16, granite-20b's 48
                    (2, 6, 2, 300, 32), (2, 32, 2, 64, 16),
                    (1, 48, 1, 80, 64)]


@pytest.mark.parametrize("dtype", list(JDT))
@pytest.mark.parametrize("shape", DECODE_BWD_CASES)
def test_decode_attention_bwd_matches_jax_vjp(shape, dtype):
    """Against jax.vjp of the JAX ref.py (positions >= 1: for an empty
    request the JAX ref.py attends to every position, the Pallas kernel
    and the port to none), which gives the int positions no cotangent."""
    b, h, kv, s, hd = shape
    rng = np.random.default_rng(b + s + hd)
    (jq, q), (jk, ck), (jv, cv), (jdo, do) = (
        _pair(rng.normal(size=sh), dtype) for sh in
        ((b, h, hd), (b, kv, s, hd), (b, kv, s, hd), (b, h, hd)))
    pos = rng.integers(1, s + 1, b).astype(np.int32)
    _, vjp = jax.vjp(jdec_ref.decode_attention_ref, jq, jk, jv,
                     jnp.asarray(pos))
    want = vjp(jdo)
    assert want[3].dtype == jax.dtypes.float0
    tpos = torch.from_numpy(pos)
    o = dec_ref.decode_attention_ref(q, ck, cv, tpos)
    got = dec_ref.decode_attention_bwd_ref(q, ck, cv, tpos, o, do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want[:3]):
        assert g.dtype == TDT[dtype] and tuple(g.shape) == w.shape
        _close_scaled(g, w, TOL[dtype], name)
    for i, p in enumerate(pos):
        assert not got[1][i, :, p:].any() and not got[2][i, :, p:].any()


def test_decode_attention_bwd_empty_request_gives_zeros():
    rng = np.random.default_rng(0)
    q, ck, cv = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((2, 4, 16), (2, 2, 40, 16), (2, 2, 40, 16)))
    pos = torch.tensor([0, 13], dtype=torch.int32)
    do = torch.ones(2, 4, 16)
    got = dec_ref.decode_attention_bwd_ref(
        q, ck, cv, pos, dec_ref.decode_attention_ref(q, ck, cv, pos), do)
    assert not any(t[0].any() for t in got)
    assert all(t[1].any() for t in got)


def test_differentiable_ops_run_the_plain_gradients_on_cpu(monkeypatch):
    """F3 on the CPU side: autograd through ``ops.flash_attention`` and
    ``ops.decode_attention`` calls the plain gradients once each (not
    autograd of the plain forward), launches nothing, and gives q, k and v
    (and the caches) their gradients; the int positions get none."""
    calls = {"flash": 0, "decode": 0}
    flash_bwd, decode_bwd = (fa_ref.flash_attention_bwd_ref,
                             dec_ref.decode_attention_bwd_ref)

    def counted(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped
    monkeypatch.setattr(fa_ref, "flash_attention_bwd_ref",
                        counted("flash", flash_bwd))
    monkeypatch.setattr(dec_ref, "decode_attention_bwd_ref",
                        counted("decode", decode_bwd))
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)

    def leaf(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).requires_grad_()
    q, k, v = leaf(2, 4, 24, 16), leaf(2, 2, 24, 16), leaf(2, 2, 24, 16)
    out = ops.flash_attention(q, k, v, True)
    do = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    out.backward(do)
    assert calls == {"flash": 1, "decode": 0}
    want = flash_bwd(q.detach(), k.detach(), v.detach(), out.detach(), do,
                     True)
    for t, w in zip((q, k, v), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    pos = torch.tensor([5, 24], dtype=torch.int32)
    dq = leaf(2, 4, 16)
    dout = ops.decode_attention(dq, k, v, pos)
    dout.backward(torch.ones_like(dout))
    assert calls == {"flash": 1, "decode": 1}
    assert dq.grad is not None and not pos.requires_grad
    assert sum(kernels.launch_counts().values()) == 0
    with torch.no_grad():
        assert ops.flash_attention(q, k, v, True).grad_fn is None


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _matmul_grad_case(seed):
    """SMOKE's MLP GEMM (B x S tokens, d_model @ d_model x ffn) in bf16:
    x, w as bf16 tensors, the f32 cotangent, JAX's vjp of its einsum with
    preferred_element_type=float32 (dx, dw), and the sums' magnitudes."""
    cfg = jconfigs.get_smoke(ARCH)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(2 * 16, cfg.d_model)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(cfg.d_model, cfg.d_ff))
                    * cfg.d_model ** -0.5, jnp.bfloat16)
    dy = rng.normal(size=(2 * 16, cfg.d_ff)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "md,df->mf", a, b, preferred_element_type=jnp.float32), x, w)
    want = [torch.from_numpy(np.array(t.astype(jnp.float32)))
            for t in vjp(jnp.asarray(dy))]
    xt, wt = (torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16()
              for t in (x, w))
    dyt = torch.from_numpy(dy)
    scales = (dyt.abs() @ wt.float().abs().t(), xt.float().abs().t()
              @ dyt.abs())
    return xt, wt, dyt, want, scales


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matmul_f32_out_grads_match_jax_vjp(seed):
    """F4: the bf16 GEMM's gradient arithmetic (``matmul_f32_out_grads``,
    which the card's ``_MatmulF32Out.backward`` runs; its products here
    bf16 values multiplied exactly and summed in f32, as the card's GEMM
    with f32 out) against ``jax.vjp`` of JAX's bf16 einsum with
    preferred_element_type=float32 at SMOKE's MLP shape: every entry
    within one bf16 ulp of JAX's plus 2^-16 of |dy| @ |w|
    (chip_smoke.F4_SLACK)."""
    from repro_torch.models import layers
    cs = _chip_smoke()
    xt, wt, dyt, want, scales = _matmul_grad_case(seed)
    got = layers.matmul_f32_out_grads(dyt, xt, wt,
                                      lambda a, b: a.float() @ b.float())
    for g, wnt, sc in zip(got, want, scales):
        assert g.dtype == torch.bfloat16
        _, excess = cs.bf16_departure(torch, g, wnt, sc)
        assert excess <= cs.F4_SLACK


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matmul_grad_check_rejects_one_rounding(seed):
    """The F4 check tells the arithmetic apart: rounding the f32
    cotangent to bf16 before the products (the backward before F4 was
    settled) puts more than 1% of the entries past one ulp and exceeds
    the allowance."""
    cs = _chip_smoke()
    xt, wt, dyt, want, scales = _matmul_grad_case(seed)
    g = dyt.bfloat16().float()
    got = ((g @ wt.float().t()).bfloat16(), (xt.float().t() @ g).bfloat16())
    for g, wnt, sc in zip(got, want, scales):
        share, excess = cs.bf16_departure(torch, g, wnt, sc)
        assert share > 0.01 and excess > cs.F4_SLACK


def _bwd_f64(q, k, v, o, do, live, rounded=False, dtype=torch.bfloat16):
    """The plain gradient written out in float64 with an explicit (SQ, SK)
    mask of live (query, key) pairs; with ``rounded``, P and dS rounded to
    bf16 (from f32, to nearest even) as the operands of dV = P^T dO,
    dK = scale dS^T Q and dQ = scale dS K, as the tensor-core kernel
    (``csrc/flash_attention_bwd_tc.cu``) rounds them. Outputs in
    ``dtype``."""
    b, h, sq, hd = q.shape
    kv = k.shape[1]
    g = h // kv
    qg, og, dog = (t.double().reshape(b, kv, g, sq, hd) for t in (q, o, do))
    k64, v64 = k.double(), v.double()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k64) * hd ** -0.5
    s = torch.where(live, s, fa_ref.NEG)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    a = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, v64)
    ds = a * (dp - (dog * og).sum(-1, keepdim=True))
    if rounded:
        a, ds = (x.float().bfloat16().double() for x in (a, ds))
    dv = torch.einsum("bkgqs,bkgqh->bksh", a, dog)
    dq = torch.einsum("bkgqs,bksh->bkgqh", ds, k64) * hd ** -0.5
    dk = torch.einsum("bkgqs,bkgqh->bksh", ds, qg) * hd ** -0.5
    return (dq.reshape(b, h, sq, hd).to(dtype), dk.to(dtype),
            dv.to(dtype))


def _bf16_inputs(b, h, kv, sq, sk, hd, seed):
    """Normal q, k, v, do rounded to bf16 (held in f32) and the plain
    forward's output rounded to bf16, causal."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g).bfloat16().float()
    q, k, v, do = randn(b, h, sq, hd), randn(b, kv, sk, hd), \
        randn(b, kv, sk, hd), randn(b, h, sq, hd)
    o = fa_ref.flash_attention_ref(q, k, v, True).bfloat16().float()
    return q, k, v, o, do


# The tensor-core route's widths: (head dim, query heads, kv heads), at hd
# 128 with G = 2 (LM T's head dim) and at hd 64 (zamba2, whisper) with
# G = 1 and 8; test ids of the hd-128 width are the bare test's.
TC_WIDTHS = [(128, 4, 2), (64, 4, 4), (64, 16, 2)]


def _width_id(w):
    return "" if w == TC_WIDTHS[0] else f"hd{w[0]}-g{w[1] // w[2]}"


@pytest.mark.parametrize("width", [
    pytest.param(w, id=_width_id(w) or "hd128-g2") for w in TC_WIDTHS])
def test_tc_bwd_rounding_model_holds_to_the_allowance(width):
    """A CPU model of the tensor-core gradient's rounding (the plain
    gradient with P and dS rounded to bf16 before their three products, at
    LM T's head dim and GQA, and at hd 64 with G = 1 and 8, S 1024,
    causal) passes ``chip_smoke.py``'s bf16 check with the tensor-core
    route's allowance (``P_ROUNDING`` x ``bwd_rounding_terms``), and fails
    the SIMT route's check without it: the allowance is what the rounding
    needs."""
    cs = _chip_smoke()
    hd, h, kv = width
    ins = _bf16_inputs(1, h, kv, 1024, 1024, hd, 2)
    live = torch.ones(1024, 1024, dtype=torch.bool).tril()
    want = fa_ref.flash_attention_bwd_ref(*(t.double() for t in ins), True)
    got = _bwd_f64(*ins, live, rounded=True)
    terms = cs.bwd_rounding_terms(torch, *ins, True)
    _, _, worst = cs.grads_close(torch, got, want, "P/dS rounded", terms)
    assert worst <= 0.75
    with pytest.raises(SystemExit):
        cs.grads_close(torch, got, want, "P/dS rounded, no allowance")


def test_g1_direct_write_equals_the_group_sum():
    """At G = 1 the tensor-core gradient rounds each kv head's dK and dV
    once to bf16 after adding +0 (``csrc/flash_attention_bwd_tc.cu``),
    where at G > 1 its group-sum pass adds the query heads' f32 partials
    to +0 in head order and rounds the sum. On the plain gradient of one
    query head a kv head (the partials), with zeros of either sign planted,
    the two give the same bits: the sum turns -0 into +0, and so does the
    direct write's + 0 (rounding without it would keep -0). So does a sum
    with a second partial of zeros of either sign, which chip_smoke's
    ``group_sum_path`` relies on to hold the direct write to the sum on
    the card."""
    ins = _bf16_inputs(1, 4, 4, 77, 77, 64, 3)
    _, dk, dv = fa_ref.flash_attention_bwd_ref(*ins, True)
    assert dk.dtype == torch.float32
    g = torch.Generator().manual_seed(4)
    for part in (dk, dv):
        part = part.clone()
        flat = part.view(-1)
        signs = torch.randint(0, 2, (40,), generator=g).bool()
        flat[:40] = torch.where(signs, -0.0, 0.0)
        summed = (torch.zeros_like(part) + part).bfloat16()
        direct = (part + 0.0).bfloat16()
        assert torch.equal(summed.view(torch.int16), direct.view(torch.int16))
        assert not bool(torch.signbit(direct[0, 0, 0, :40]).any())
        assert bool(torch.signbit(part.bfloat16()[0, 0, 0, :40]).any())
        zeros = torch.where(torch.rand(part.shape, generator=g) < 0.5,
                            -0.0, 0.0)
        shadow = (torch.zeros_like(part) + part + zeros).bfloat16()
        assert torch.equal(shadow.view(torch.int16), direct.view(torch.int16))


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as the kernels' split rounds it: two
    operations on the bits (+0x1000, the 13 low bits cleared), to nearest
    with ties away from zero."""
    bits = x.float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000))
                             & np.uint32(0xFFFFE000)).view(np.float32))


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` as the tensor core reads a TF32 operand: its 13 low
    mantissa bits ignored (truncated)."""
    bits = x.float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy((bits & np.uint32(0xFFFFE000)).view(np.float32))


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                  terms: int = 3) -> torch.Tensor:
    """An einsum of f32 operands as the kernel's TF32 products take it:
    each operand split into hi (``_tf32_hi``) and lo = x - hi (exact in
    f32, read truncated to TF32); each partial product exact and rounded
    to f32, then summed in f32: lo.hi + hi.lo + hi.hi (lo.lo dropped), or
    hi.hi alone when ``terms`` is 1."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)

    def part(x, y):
        return torch.einsum(eq, x.double(), y.double()).float()
    if terms == 1:
        return part(ah, bh)
    al, bl = _tf32_read(a.float() - ah), _tf32_read(b.float() - bh)
    return (part(al, bh) + part(ah, bl)) + part(ah, bh)


def _bwd_tf32_model(q, k, v, o, do, causal, terms=3):
    """The ``tf32x3`` route's gradient (``csrc/flash_attention_bwd.cu``)
    as a CPU model, in f32: S = Q.K^T, dP = dO.V^T, D = rowsum(dO * O)
    (the diagonal of dO.O^T, as dP is taken), dV = P^T.dO, dQ = scale dS.K
    and dK = scale dS^T.Q each taken by ``_tf32_product`` (P and dS split
    as the kernel splits them on their way to the next product), the
    softmax and dS = P (dP - D) in f32. Inputs (B, H, S, hd) / (B, KV, S,
    hd) f32; outputs f32."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    grouped = (b, kv, h // kv, sq, hd)
    qg, og, dog = (t.float().reshape(grouped) for t in (q, o, do))
    scale = hd ** -0.5
    s = _tf32_product("bkgqh,bksh->bkgqs", qg, k, terms) * scale
    live = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        live = live.tril()
    s = torch.where(live, s, fa_ref.NEG)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    a = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    dp = _tf32_product("bkgqh,bksh->bkgqs", dog, v, terms)
    d = _tf32_product("bkgqh,bkgqh->bkgq", dog, og, terms)
    ds = a * (dp - d[..., None])
    dv = _tf32_product("bkgqs,bkgqh->bksh", a, dog, terms)
    dq = _tf32_product("bkgqs,bksh->bkgqh", ds, k, terms) * scale
    dk = _tf32_product("bkgqs,bkgqh->bksh", ds, qg, terms) * scale
    return dq.reshape(b, h, sq, hd), dk, dv


@pytest.mark.parametrize("s", [256, 512])
def test_tf32x3_bwd_model_holds_to_the_f32_check(s):
    """A CPU model of the ``tf32x3`` gradient's arithmetic (every product
    split 3xTF32, ``_bwd_tf32_model``) at LM T's head dim, G = 8, causal,
    f32, passes ``chip_smoke.py``'s f32 check (``grads_close``: 2e-5 of the
    gradient's scale) against the float64 plain gradient, and the same
    model with hi alone (one TF32 product a product) fails it: the split
    is needed, and enough."""
    cs = _chip_smoke()
    rng = np.random.default_rng(s)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for shape in ((1, 8, s, 128), (1, 1, s, 128),
                                 (1, 1, s, 128), (1, 8, s, 128)))
    o = fa_ref.flash_attention_ref(q, k, v, True)
    want = fa_ref.flash_attention_bwd_ref(
        *(t.double() for t in (q, k, v, o, do)), True)
    got = _bwd_tf32_model(q, k, v, o, do, True)
    _, _, worst = cs.grads_close(torch, got, want, "3xTF32 model")
    assert worst <= 0.5
    one = _bwd_tf32_model(q, k, v, o, do, True, terms=1)
    with pytest.raises(SystemExit):
        cs.grads_close(torch, one, want, "1xTF32 model")


BWD_FAULTS = ("flash_key_tile", "flash_kv_head", "flash_diagonal_mask",
              "decode_chunk")


def _fault_params():
    """(fault, dtype, width): each flash fault at every tensor-core width,
    decode's at none; the ids of the hd-128 width are the bare test's."""
    out = []
    for f in BWD_FAULTS:
        for dtype, tag in (("bfloat16", ""), ("float32", "-f32")):
            for w in TC_WIDTHS if f.startswith("flash") else [None]:
                wid = _width_id(w) if w else ""
                out.append(pytest.param(f, dtype, w, id=f"{f}{tag}"
                                        + (f"-{wid}" if wid else "")))
    return out


@pytest.mark.parametrize("fault,dtype,width", _fault_params())
def test_bwd_card_check_rejects_planted_faults(fault, dtype, width):
    """``chip_smoke.py``'s checks of the backward kernels, bf16 (each value
    within half a bf16 ulp + 2e-5 rel + 1e-6 of the plain gradient, here
    computed in float64 for flash attention and in f32 for decode) and f32
    (each value within 2e-5 of the gradient's scale), pass the plain
    result rounded to the dtype and fail one with a 64-key tile of dK and
    dV left unwritten (zero), dK of one kv head swapped with its
    neighbour's, the causal mask dropped on the 64x64 diagonal tiles, or
    decode's last live 256-position chunk of the cache cotangents left
    out. In bf16 the flash faults fail the tensor-core route's check too,
    which adds its allowance for P and dS rounded to bf16; flash's at hd
    128 (G = 2) and at hd 64 (G = 1 and 8)."""
    cs = _chip_smoke()
    terms = None
    if fault.startswith("flash"):
        hd, h, kv = width
        ins = _bf16_inputs(1, h, kv, 256, 256, hd, 1)
        want = fa_ref.flash_attention_bwd_ref(*(t.double() for t in ins),
                                              True)
        if dtype == "bfloat16":
            terms = cs.bwd_rounding_terms(torch, *ins, True)
    else:
        g = torch.Generator().manual_seed(1)

        def randn(*shape):
            return torch.randn(*shape, generator=g).bfloat16().float()
        q, ck, cv, do = randn(4, 8, 64), randn(4, 2, 2048, 64), \
            randn(4, 2, 2048, 64), randn(4, 8, 64)
        pos = torch.tensor([700, 1500, 2048, 300], dtype=torch.int32)
        o = dec_ref.decode_attention_ref(q, ck, cv, pos).bfloat16().float()
        want = dec_ref.decode_attention_bwd_ref(q, ck, cv, pos, o, do)
    rounded = [w.to(TDT[dtype]) for w in want]
    cs.grads_close(torch, rounded, want, "rounded plain gradient")
    bad = [w.clone() for w in rounded]
    if fault == "flash_key_tile":
        bad[1][:, :, 64:128] = 0
        bad[2][:, :, 64:128] = 0
    elif fault == "flash_kv_head":
        bad[1] = bad[1].flip(1)
    elif fault == "flash_diagonal_mask":
        idx = torch.arange(256)
        live = (idx[:, None] >= idx[None, :]) | \
            (idx[:, None] // 64 == idx[None, :] // 64)
        bad = list(_bwd_f64(*ins, live, dtype=TDT[dtype]))
    else:
        for i, p in enumerate(pos.tolist()):
            c0 = (p - 1) // 256 * 256
            bad[1][i, :, c0:p] = 0
            bad[2][i, :, c0:p] = 0
    with pytest.raises(SystemExit):
        cs.grads_close(torch, bad, want, f"planted {fault}")
    if terms is not None:
        with pytest.raises(SystemExit):
            cs.grads_close(torch, bad, want, f"planted {fault}, tc", terms)


def test_flash_bwd_routes_like_the_forward(monkeypatch):
    """On the card ``flash_attention_bwd`` launches the kernel of
    ``route``: bf16 at hd 64 and 128 the tensor-core one
    (``moby_flash_attention_bwd_tc``, counter ``flash_attention_bwd_tc``),
    every other dtype and head dim the 3xTF32 one
    (``flash_attention_bwd``);
    unsupported dtypes and head dims, and operands beyond a TMA tensor map
    on the tensor-core route, raise before any launch. Here the library is
    a stand-in that records the entry point called (the CPU has no card);
    each call advances exactly its route's counter."""
    import contextlib
    from repro_torch.kernels import _build, _launch
    called = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                called.append(name)
                return 0
            return entry
    monkeypatch.setattr(_launch, "dispatch_device", lambda kernel, t: "cuda")
    monkeypatch.setattr(_launch, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(_launch, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())

    def call(dtype, hd, sq=77, k=None):
        q = torch.zeros(1, 4, sq, hd, dtype=dtype)
        if k is None:
            k = torch.zeros(1, 2, sq, hd, dtype=dtype)
        return fa_ops.flash_attention_bwd(q, k, k, q, q, True)
    cases = [(torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc")] + [
        (dt, hd, "tf32x3") for dt, hd in
        ((torch.float32, 128), (torch.float32, 64), (torch.bfloat16, 32),
         (torch.bfloat16, 16), (torch.float32, 32))]
    for dtype, hd, path in cases:
        kernels.reset_launch_counts()
        dq, dk, dv = call(dtype, hd)
        counts = kernels.launch_counts()
        tc = path == "tc"
        assert called[-1] == ("moby_flash_attention_bwd_tc" if tc
                              else "moby_flash_attention_bwd")
        assert counts["flash_attention_bwd_tc"] == int(tc)
        assert counts["flash_attention_bwd"] == int(not tc)
        assert sum(counts.values()) == 1
        assert dq.shape == (1, 4, 77, hd) and dk.shape == (1, 2, 77, hd)
        assert dq.transpose(1, 2).is_contiguous()
        assert dk.transpose(1, 2).is_contiguous()
    n = len(called)
    kernels.reset_launch_counts()
    with pytest.raises(TypeError, match="dtype"):
        call(torch.float16, 128)
    with pytest.raises(ValueError, match="head dim"):
        call(torch.bfloat16, 96)
    # Batch and kv-head strides of 2^41 bytes (both dimensions have size 1,
    # so the storage is small): a TMA tensor map cannot describe them.
    far = torch.zeros(128, dtype=torch.bfloat16).as_strided(
        (1, 1, 1, 128), (2 ** 40, 2 ** 40, 128, 1))
    with pytest.raises(ValueError, match="TMA"):
        call(torch.bfloat16, 128, sq=1, k=far)
    assert len(called) == n and sum(kernels.launch_counts().values()) == 0


@pytest.mark.cuda
def test_backward_kernels_match_plain_on_card():
    """F3 on the card: both differentiable ops launch their backward
    kernels (the route's counter advances), give q, k and v their
    gradients, and the kernels agree with the plain gradients (f32 at 2e-5
    of the scale, bf16 within chip_smoke's half-ulp check of the float64
    gradient, plus its P/dS rounding allowance on the tensor-core
    route)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    cs = _chip_smoke()
    for dtype in ("float32", "bfloat16"):
        for shape, causal in FLASH_BWD_CASES:
            ins = [t.to(dev) for _, t in _flash_bwd_inputs(shape, dtype)]
            q, k, v = (t.requires_grad_() for t in ins[:3])
            tc = fa_ops.route(TDT[dtype], shape[-1]) == "tc"
            counter = "bwd_tc_launches" if tc else "bwd_launches"
            before = getattr(fa_ops, counter)
            out = ops.flash_attention(q, k, v, causal)
            out.backward(ins[3])
            assert getattr(fa_ops, counter) == before + 1
            wide = torch.float32 if dtype == "float32" else torch.float64
            args = [t.detach().to(wide) for t in (q, k, v, out, ins[3])]
            want = fa_ref.flash_attention_bwd_ref(*args, causal)
            terms = cs.bwd_rounding_terms(torch, *args, causal) if tc \
                else None
            cs.grads_close(torch, (q.grad, k.grad, v.grad), want,
                           f"flash {shape} {dtype}", terms)
        for b, h, kv, s, hd in DECODE_BWD_CASES:
            rng = np.random.default_rng(s)
            q, ck, cv, do = (torch.from_numpy(rng.normal(size=sh).astype(
                np.float32)).to(dev, TDT[dtype]) for sh in
                ((b, h, hd), (b, kv, s, hd), (b, kv, s, hd), (b, h, hd)))
            pos = torch.from_numpy(rng.integers(0, s + 1, b).astype(
                np.int32)).to(dev)
            q, ck, cv = (t.requires_grad_() for t in (q, ck, cv))
            before = dec_ops.bwd_launches
            out = ops.decode_attention(q, ck, cv, pos)
            out.backward(do)
            assert dec_ops.bwd_launches == before + 1
            want = dec_ref.decode_attention_bwd_ref(
                *(t.detach().float() for t in (q, ck, cv)), pos,
                out.detach().float(), do.float())
            cs.grads_close(torch, (q.grad, ck.grad, cv.grad), want,
                           f"decode {b, h, kv, s, hd} {dtype}")


# ---------------------------------------------------------------------------
# The loss, the train step and the pieces around them
# ---------------------------------------------------------------------------

B, S = 4, 16


def _cfgs(backend="ref", **over):
    jcfg = dataclasses.replace(jconfigs.get_smoke(ARCH), dtype=jnp.float32,
                               backend=backend, **over)
    return jcfg, dataclasses.replace(configs.get_smoke(ARCH),
                                     dtype=torch.float32, **over)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """JAX's f32 SMOKE weights (key 0) as a tree of numpy arrays, with the
    attention weights rescaled as chip_smoke's LM B rescales them: JAX's
    fanin init takes fan_in = shape[-2] of the 3-d attention weights (the
    head count, or hd for wo), so the SMOKE scores reach the tens and the
    softmax is nearly one-hot. There the f32 gradient is ill-conditioned:
    against the float64 gradient of the same loss, JAX's own f32 gradient
    is off by up to 6.4e-5 of a tensor's scale and the port's by 1.9e-4,
    so no two f32 implementations agree to 2e-5. Rescaled to fan_in =
    d_model (and H * hd for wo), both are within 1.5e-6 of float64."""
    jcfg, cfg = _cfgs()
    tree = jax.tree_util.tree_map(
        np.array, jinit_params(jlm.model_defs(jcfg), jax.random.key(0)))
    attn = tree["blocks"]["attn"]
    for name in ("wq", "wk", "wv"):
        attn[name] = attn[name] * np.float32(
            (attn[name].shape[-2] / cfg.d_model) ** 0.5)
    attn["wo"] = attn["wo"] * np.float32(
        (attn["wo"].shape[-2] / cfg.d_head_total) ** 0.5)
    return tree


def _batch(seed=11, mask=False, vocab=None):
    vocab = vocab or configs.get_smoke(ARCH).vocab
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if mask:
        out["mask"] = (rng.uniform(size=(B, S)) < 0.7).astype(np.float32)
    return out


def _close_tree(got, want, tol, what):
    """Every leaf of the port's tree within ``tol`` of its scale of the
    JAX tree's leaf at the same path."""
    want = dict(params.leaves(want))
    got = dict(params.leaves(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        _close_scaled(got[path], w, tol, f"{what} {'/'.join(path)}")


@pytest.mark.parametrize("remat,backend,mask", [("full", "ref", False),
                                                ("none", "ref", True),
                                                ("full", "pallas", True)])
def test_loss_fn_and_grads_match_jax(remat, backend, mask):
    jcfg, cfg = _cfgs(backend, remat=remat)
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    batch = _batch(mask=mask)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, jcfg, b)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    p = params.tree_map(lambda t: t.requires_grad_(),
                        convert.params_from_jax(_jax_params(), cfg))
    loss = lm.loss_fn(p, cfg, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in params.leaves(p)])
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    got = params.from_leaves(zip((path for path, _ in params.leaves(p)),
                                 grads))
    _close_tree(got, jax.tree_util.tree_map(np.asarray, jgrads), 2e-5,
                f"grad ({remat}, {backend})")


def test_remat_recomputes_and_gives_the_same_gradients():
    """``remat="full"`` runs every layer under checkpoint: the backward
    pass recomputes the layers' forwards (the attention forward runs twice
    a layer), and the gradients equal ``remat="none"``'s bit for bit."""
    calls = []
    real = fa_ref.flash_attention_ref

    def counted(*args):
        calls.append(1)
        return real(*args)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    grads = {}
    for remat in ("full", "none"):
        _, cfg = _cfgs(remat=remat)
        p = params.tree_map(lambda t: t.requires_grad_(),
                            convert.params_from_jax(_jax_params(), cfg))
        calls.clear()
        fa_ref.flash_attention_ref = counted
        try:
            loss = lm.loss_fn(p, cfg, batch)
            grads[remat] = torch.autograd.grad(
                loss, [t for _, t in params.leaves(p)])
        finally:
            fa_ref.flash_attention_ref = real
        assert len(calls) == cfg.n_layers * (2 if remat == "full" else 1)
    for a, b in zip(grads["full"], grads["none"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _topk_hook(module, params_tree, fraction=0.1):
    """A train-step hook (grads, opt_state) -> (grads, opt_state) keeping
    the error-feedback state in a closure."""
    ef = [module.init_error_feedback(params_tree)]

    def hook(grads, state):
        comp, ef[0] = module.topk_compress(grads, ef[0], fraction)
        return comp, state
    return hook


@pytest.mark.parametrize("grad_accum,compress", [(1, False), (2, False),
                                                 (1, True)])
def test_train_steps_match_jax(grad_accum, compress):
    """Three steps from JAX's weights: after each, the loss within 1e-5,
    the gradient norm and both moments (linear and quadratic in the
    gradients: the gradient check) within 2e-5 of their scale, and the
    parameters within 2e-5 of their scale plus the sum of the steps'
    learning rates. AdamW moves an entry by lr * g / (|g| + eps) at the
    first step: for a gradient entry near eps (the key bias's, which the
    softmax nearly cancels) f32 rounding of g changes that move by a
    sizeable part of lr (2.5e-8 at lr 3e-6 after one step, 1.9e-7 after
    two), so an entry's move is bounded by lr a step, not by the gradient
    tolerance. ``test_train_step_updates_in_place`` holds the update's
    arithmetic bit for bit."""
    jcfg, cfg = _cfgs(grad_accum=grad_accum)
    ocfg = joptimizer.AdamWConfig()
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    jstate = joptimizer.init(jparams)
    jstep = jtrainstep.make_train_step(
        jcfg, ocfg, _topk_hook(jgradcomp, jparams) if compress else None)
    if not compress:
        jstep = jax.jit(jstep)
    p = convert.params_from_jax(_jax_params(), cfg)
    state = optimizer.init(p)
    step = trainstep.make_train_step(
        cfg, optimizer.AdamWConfig(*ocfg),
        _topk_hook(gradcomp, p) if compress else None)
    lr_sum = 0.0
    for i in range(3):
        batch = _batch(seed=20 + i)
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        p, state, m = step(p, state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
        _close_scaled(m["grad_norm"], jm["grad_norm"], 2e-5, "grad_norm")
        assert int(state.step) == int(jstate.step) == i + 1
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


def test_train_step_updates_in_place():
    """The step writes the new parameters and moments into the tensors it
    was given (the full-width masters and moments do not fit twice on one
    card); the values are the functional update's on the same gradients,
    bit for bit."""
    _, cfg = _cfgs()
    ocfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=1)
    p = convert.params_from_jax(_jax_params(), cfg)
    state = optimizer.init(p)
    before = params.tree_map(torch.clone, p)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    req = params.tree_map(lambda t: t.clone().requires_grad_(), p)
    grads = torch.autograd.grad(lm.loss_fn(req, cfg, batch),
                                [t for _, t in params.leaves(req)])
    want_p, want_state, _ = optimizer.update(
        ocfg, params.from_leaves(zip((path for path, _ in params.leaves(p)),
                                     grads)), state, before)
    p2, state2, _ = trainstep.make_train_step(cfg, ocfg)(p, state, batch)
    for (_, a), (_, b), (_, c), (_, w) in zip(
            params.leaves(p), params.leaves(p2), params.leaves(before),
            params.leaves(want_p)):
        assert a is b and not torch.equal(a, c)
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert state2.m["embed"]["table"] is state.m["embed"]["table"]
    for name in ("m", "v"):
        for (_, a), (_, w) in zip(params.leaves(getattr(state2, name)),
                                  params.leaves(getattr(want_state, name))):
            torch.testing.assert_close(a, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# gradcomp, tokens, checkpoints, fit
# ---------------------------------------------------------------------------


def test_topk_compress_breaks_ties_by_the_lower_index_as_jax():
    """Magnitudes tied across the k-th place (planted): the port keeps the
    same entries as ``lax.top_k`` (the lower flat indices), with the same
    residuals, over three steps of error feedback."""
    w = np.array([3.0, -2.0, 2.0, 0.5, -2.0, 2.0, 1.0, -3.0, 2.0, 0.0],
                 np.float32)
    b = np.array([[1.0, -1.0, 1.0], [-1.0, 1.0, 0.25]], np.float32)
    tree = {"w": w, "b": {"x": b}}
    jg = jax.tree_util.tree_map(jnp.asarray, tree)
    tg = params.tree_map(torch.from_numpy, tree)
    jef, tef = jgradcomp.init_error_feedback(jg), \
        gradcomp.init_error_feedback(tg)
    for frac in (0.35, 0.5, 0.2):
        jc, jef = jgradcomp.topk_compress(jg, jef, frac)
        tc, tef = gradcomp.topk_compress(tg, tef, frac)
        for (path, t), (_, r) in zip(params.leaves(tc),
                                     params.leaves(tef.residual)):
            j = functools.reduce(lambda x, k: x[k], path, jc)
            jr = functools.reduce(lambda x, k: x[k], path, jef.residual)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_int8_compress_rounds_half_to_even_as_jax():
    g = {"a": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 64.5],
                       np.float32),
         "b": np.random.default_rng(5).normal(size=(4, 7)).astype(
             np.float32)}
    jq, js = jgradcomp.int8_compress(jax.tree_util.tree_map(jnp.asarray, g))
    tq, ts = gradcomp.int8_compress(params.tree_map(torch.from_numpy, g))
    for key in g:
        assert tq[key].dtype == torch.int8
        np.testing.assert_array_equal(tq[key].numpy(), np.asarray(jq[key]))
        assert float(ts[key]) == float(js[key])
    np.testing.assert_array_equal(tq["a"].numpy(),
                                  [127, 0, 2, 2, 0, -2, 4, 64])
    back = gradcomp.int8_decompress(tq, ts)
    jback = jgradcomp.int8_decompress(jq, js)
    for key in g:
        np.testing.assert_array_equal(back[key].numpy(),
                                      np.asarray(jback[key]))


def test_token_pipeline_equals_jax():
    for n_shards, shard in ((1, 0), (2, 1)):
        cfg = dict(vocab=256, seq_len=24, global_batch=4, n_shards=n_shards,
                   seed=3)
        a = jtokens.TokenPipeline(jtokens.TokenPipelineConfig(**cfg), shard)
        b = tokens.TokenPipeline(tokens.TokenPipelineConfig(**cfg), shard)
        for step in (0, 1, 17):
            x, y = a.batch_at(step), b.batch_at(step)
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("module", ["data/tokens.py", "runtime/fault.py"])
def test_copies_are_identical(module):
    """``data/tokens.py`` (numpy) and ``runtime/fault.py`` (plain Python)
    are copies of the JAX package's modules."""
    assert (ROOT / "src" / "repro_torch" / module).read_text() == \
        (ROOT / "src" / "repro" / module).read_text()


def _train_state():
    """JAX's SMOKE weights and a JAX AdamW state after one step's worth of
    moments, as trees of both packages."""
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    rng = np.random.default_rng(9)
    jm = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), jp)
    jv = jax.tree_util.tree_map(jnp.square, jm)
    jstate = joptimizer.OptState(step=jnp.asarray(7, jnp.int32), m=jm, v=jv)
    _, cfg = _cfgs()
    tstate = optimizer.OptState(
        step=torch.tensor(7, dtype=torch.int32),
        m=convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jm),
                                  cfg),
        v=convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jv),
                                  cfg))
    return ({"params": jp, "opt": jstate},
            {"params": convert.params_from_jax(_jax_params(), cfg),
             "opt": tstate})


def _zeros_like_port(tree):
    return checkpoint.unflatten(tree, iter(
        [torch.zeros_like(t) for t in checkpoint.flatten(tree)]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """A checkpoint written by one package restores in the other: same
    layout, the leaves in ``jax.tree_util`` order, every value equal."""
    jtree, ttree = _train_state()
    assert len(checkpoint.flatten(ttree)) == \
        len(jax.tree_util.tree_leaves(jtree))
    if writer == "jax":
        jcheckpoint.CheckpointManager(str(tmp_path)).save(3, jtree)
        got = checkpoint.CheckpointManager(str(tmp_path)).restore(
            None, _zeros_like_port(ttree))
        want = ttree
    else:
        checkpoint.CheckpointManager(str(tmp_path)).save(3, ttree)
        back = jcheckpoint.CheckpointManager(str(tmp_path)).restore(
            None, jax.tree_util.tree_map(jnp.zeros_like, jtree))
        got = checkpoint.unflatten(ttree, iter(
            torch.from_numpy(np.asarray(x))
            for x in jax.tree_util.tree_leaves(back)))
        want = ttree
    assert isinstance(got["opt"], optimizer.OptState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7
    for a, b in zip(checkpoint.flatten(got), checkpoint.flatten(want)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_manager_keeps_publishes_and_checks(tmp_path):
    """keep, atomic publish, a save_async snapshot taken before the tree
    changes, a failed background write raised by ``wait``, a corrupt
    shard refused."""
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2)
    x = {"w": torch.arange(6.0), "s": torch.tensor(2, dtype=torch.int32)}
    for s in (1, 2, 3):
        mgr.save(s, x)
    assert mgr.all_steps() == [2, 3]
    mgr.save_async(4, x)
    x["w"].add_(100.0)          # after the snapshot: not in step 4
    mgr.wait()
    got = mgr.restore(4, {"w": torch.zeros(6), "s": torch.zeros(
        (), dtype=torch.int32)})
    torch.testing.assert_close(got["w"], torch.arange(6.0))
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    def full_disk(*args):
        raise OSError("no space left on device")
    writer, mgr._write = mgr._write, full_disk
    mgr.save_async(5, x)
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr._write = writer
    mgr.wait()
    shard = next((tmp_path / "step_00000004").glob("shard_*"))
    raw = bytearray(shard.read_bytes())
    raw[10] ^= 0xFF
    shard.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore(4, {"w": torch.zeros(6), "s": torch.zeros(
            (), dtype=torch.int32)})


def test_fit_cut_and_resumed_equals_uncut(tmp_path):
    """``fit`` on the CPU for 4 steps, and the same run cut after 2 steps
    (its checkpoint at step 2) and resumed: the resumed steps' losses equal
    the uncut run's bit for bit."""
    _, cfg = _cfgs()
    kw = dict(global_batch=2, seq_len=16, ckpt_every=2, seed=1,
              torch_device="cpu", ocfg=optimizer.AdamWConfig(
                  lr=1e-3, warmup_steps=2, total_steps=4))
    uncut = loop.fit(cfg, 4, ckpt_dir=str(tmp_path / "a"), **kw)
    first = loop.fit(cfg, 2, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = loop.fit(cfg, 4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert uncut.restored_from is None and first.restored_from is None
    assert resumed.restored_from == 2
    assert first.losses == uncut.losses[:2]
    assert resumed.losses == uncut.losses[2:]


def test_train_step_refuses_a_batch_on_another_device():
    """The train step runs where the parameters are: a numpy batch is
    copied there (``test_torch_lm.py::test_entry_points_default_to_the_card``),
    a tensor on another device raises rather than being copied."""
    _, cfg = _cfgs()
    p = convert.params_from_jax(_jax_params(), cfg)
    step = trainstep.make_train_step(cfg, optimizer.AdamWConfig())
    with pytest.raises(ValueError, match="meta"):
        step(p, optimizer.init(p), {
            k: torch.empty(v.shape, dtype=torch.int32, device="meta")
            for k, v in _batch().items()})

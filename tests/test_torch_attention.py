"""The port's two attention kernel modules against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
that version against the JAX ``ref.py`` oracle and against the Pallas
kernel in interpret mode, at ``tests/test_kernels.py``'s shapes and
tolerances (2e-5 in f32, 2e-2 in bf16). The plain versions follow the
Pallas kernels where the two JAX versions differ (a request with no live
position gives 0). The CUDA kernels run only on a card:
``test_attention_kernels_match_plain_on_card`` is marked ``cuda`` and skips
without one (``python3 chip_smoke.py`` holds both kernels against their
plain versions at the serving shapes).
``test_bf16_card_check_rejects_planted_faults`` shows, here, that the bf16
tolerance of those card checks fails a kernel that loses one chunk or tile
or reads the wrong kv head, and that the tensor-core flash route's
tolerance (which allows for its p rounded to bf16 before the P.V product)
passes the plain result computed with that rounding.
``test_tf32x3_model_holds_to_plain`` models the f32 route's 3xTF32
products on the CPU and holds the result to the plain version at the f32
card check's 2e-5, and ``test_one_term_tf32_fails_the_f32_check`` shows
that a single TF32 product fails that check.
``test_flash_route_by_dtype_and_head_dim`` holds the wrapper's choice
between its two CUDA kernels.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import ops as jdec_ops  # noqa: E402
from repro.kernels.decode_attention import ref as jdec_ref  # noqa: E402
from repro.kernels.flash_attention import ops as jfa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro_torch import kernels, ops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt, _ = DTYPES[dtype]
    ja = jnp.asarray(a, jdt)
    return ja, torch.from_numpy(np.array(ja, np.float32)).to(tdt)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(1, 4, 4, 256, 256, 64),
                (2, 8, 2, 512, 512, 128),   # GQA
                (1, 4, 1, 300, 300, 64),    # MQA + ragged
                (2, 2, 2, 128, 640, 64),    # kv longer than q
                (2, 4, 2, 16, 16, 16)]      # the SMOKE configs' head dim
# Causal attention is defined for sq == sk only (as in test_kernels.py).
FLASH_CASES = [(shape, causal) for shape in FLASH_SHAPES
               for causal in (True, False)
               if not (causal and shape[3] != shape[4])]


def _flash_inputs(b, h, kv, sq, sk, hd, dtype):
    rng = np.random.default_rng(b * 1000 + sq + sk + hd)
    return (_pair(rng.normal(size=(b, h, sq, hd)), dtype),
            _pair(rng.normal(size=(b, kv, sk, hd)), dtype),
            _pair(rng.normal(size=(b, kv, sk, hd)), dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,causal", FLASH_CASES)
def test_flash_attention_matches_jax(shape, causal, dtype):
    (jq, q), (jk, k), (jv, v) = _flash_inputs(*shape, dtype)
    tol = DTYPES[dtype][2]
    got = ops.flash_attention(q, k, v, causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jfa_ref.flash_attention_ref(jq, jk, jv, causal=causal), tol)
    _close(got, jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                        interpret=True), tol)


def test_flash_attention_reads_strided_views():
    """(B, S, heads, hd) storage passed as transposed views gives the
    contiguous inputs' result, as the model passes its activations."""
    (_, q), (_, k), (_, v) = _flash_inputs(2, 8, 2, 96, 96, 32, "float32")
    want = fa_ops.flash_attention(q, k, v, True)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qs.is_contiguous()
    torch.testing.assert_close(fa_ops.flash_attention(qs, ks, vs, True),
                               want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

DECODE_SHAPES = [(2, 4, 4, 512, 64),
                 (4, 8, 2, 1024, 128),
                 (1, 8, 1, 700, 64),
                 (2, 4, 2, 32, 16),
                 (2, 12, 12, 448, 64)]   # whisper-small's self cache, G = 1


def _decode_inputs(b, h, kv, s, hd, dtype):
    rng = np.random.default_rng(b + s + hd)
    q = _pair(rng.normal(size=(b, h, hd)), dtype)
    ck = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    cv = _pair(rng.normal(size=(b, kv, s, hd)), dtype)
    pos = rng.integers(1, s, b).astype(np.int32)
    return q, ck, cv, (jnp.asarray(pos), torch.from_numpy(pos))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_matches_jax(shape, dtype):
    (jq, q), (jk, ck), (jv, cv), (jpos, pos) = _decode_inputs(*shape, dtype)
    tol = DTYPES[dtype][2]
    got = ops.decode_attention(q, ck, cv, pos)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jdec_ref.decode_attention_ref(jq, jk, jv, jpos), tol)
    _close(got, jdec_ops.decode_attention(jq, jk, jv, jpos, interpret=True),
           tol)


def test_decode_attention_empty_request_gives_zeros_as_pallas():
    """cache_pos = 0: no live position. The Pallas kernel gives 0 there
    (the JAX ref.py the mean of V); the port follows the kernel."""
    (jq, q), (jk, ck), (jv, cv), _ = _decode_inputs(3, 4, 2, 600, 32,
                                                    "float32")
    pos = np.array([0, 5, 600], np.int32)
    got = dec_ops.decode_attention(q, ck, cv, torch.from_numpy(pos))
    want = jdec_ops.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                     interpret=True)
    assert not got[0].any()
    _close(got, want, 2e-5)


def test_decode_attention_reads_cache_views_in_place():
    """The (B, S, KV, hd) cache passed as (B, KV, S, hd) views gives the
    contiguous result; a position past S counts as S."""
    (_, q), (_, ck), (_, cv), (_, pos) = _decode_inputs(2, 8, 2, 64, 32,
                                                        "float32")
    pos = torch.tensor([64, 65], dtype=torch.int32)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (ck, cv)]
    assert not views[0].is_contiguous()
    got = dec_ops.decode_attention(q, *views, pos)
    torch.testing.assert_close(got, dec_ops.decode_attention(q, ck, cv, pos),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        got, dec_ref.decode_attention_ref(q, ck, cv, torch.tensor([64, 64])),
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def test_attention_wrappers_count_only_kernel_launches():
    """The CPU path is the plain version and launches nothing; tensors on
    a device other than the CPU or a card raise (no fallback)."""
    kernels.reset_launch_counts()
    (_, q), (_, k), (_, v) = _flash_inputs(1, 2, 1, 8, 8, 16, "float32")
    ops.flash_attention(q, k, v, True)
    ops.decode_attention(q[:, :, 0], k, v,
                         torch.tensor([3], dtype=torch.int32))
    (_, q), (_, k), (_, v) = _flash_inputs(1, 2, 1, 8, 8, 128, "bfloat16")
    ops.flash_attention(q, k, v, True)    # the tensor-core route's inputs
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 0 and counts["decode_attention"] == 0
    assert counts["flash_attention_tc"] == 0
    meta = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        fa_ops.flash_attention(meta, meta, meta, True)
    with pytest.raises(ValueError, match="no implementation"):
        dec_ops.decode_attention(meta[:, :, 0], meta, meta,
                                 torch.empty(1, device="meta"))


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library
    at the top), for the tolerance it holds the card's kernels to."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within_bf16_rounding(got: torch.Tensor, want: torch.Tensor,
                          p_rounding=None) -> bool:
    """``chip_smoke.py``'s bf16 check: each value within half a bf16 ulp
    (+2e-5 relative +1e-6) of the plain version's f32 result, plus, for the
    tensor-core flash route, ``P_ROUNDING`` times ``p_rounding`` (the
    root-sum-square of its p-rounding errors)."""
    cs = _chip_smoke()
    limit = cs.bf16_limit(torch, want)
    if p_rounding is not None:
        limit = limit + cs.P_ROUNDING * p_rounding
    return bool(((got.float() - want).abs() <= limit).all())


def _hold_to_plain(got: torch.Tensor, plain, *args, p_rounding=None) -> None:
    """A kernel's output against its plain version on the same inputs: in
    f32 within 2e-5; in bf16 against the plain version's f32 result within
    half a bf16 ulp (plus the p-rounding allowance of the tensor-core
    flash route), as ``chip_smoke.py`` holds them."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, plain(*args), rtol=2e-5, atol=2e-5)
        return
    assert _within_bf16_rounding(got, plain(*(
        a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
        else a for a in args)), p_rounding)


def _flash_p_rounded(q, k, v, causal):
    """The plain version with p rounded to bf16 (round to nearest) before
    the P.V product and l summed from the f32 p, as the tensor-core kernel
    computes; then the output rounded to bf16."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) * hd ** -0.5
    live = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        live = live.tril()
    s = torch.where(live, s, fa_ref.NEG)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    o = torch.einsum("bkgqs,bksh->bkgqh", p.bfloat16().float(), v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, h, sq, hd).bfloat16()


# The tensor-core route's widths: (head dim, query heads, kv heads), at hd
# 128 with G = 2 and at hd 64 with G = 1 and 8.
TC_WIDTHS = [(128, 4, 2), (64, 4, 4), (64, 16, 2)]


@pytest.mark.parametrize(
    "fault,width",
    [pytest.param(f, None, id=f) for f in ("decode_last_chunk",
                                           "decode_chunk_1")]
    + [pytest.param(f, w, id=f if w == TC_WIDTHS[0]
                    else f"{f}-hd{w[0]}-g{w[1] // w[2]}")
       for f in ("flash_diagonal_tile", "flash_neighbour_kv_head")
       for w in TC_WIDTHS])
def test_bf16_card_check_rejects_planted_faults(fault, width):
    """Decode attention: the plain version's f32 result rounded to bf16
    passes the bf16 check; the same with one 512-position chunk of a
    request left out, as a faulty kernel would give it, fails. Flash
    attention's tensor-core route (bf16, hd 128 at G = 2 and hd 64 at
    G = 1 and 8, causal, normal inputs as at the prefill shape): the plain
    result with p rounded to bf16 as the kernel rounds it passes the check
    with its p-rounding allowance; one 64-key diagonal tile left out of a
    query block, or kv head 0's last query head read against kv head 1,
    fails it."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).bfloat16().float()
    if fault.startswith("decode"):
        q, ck, cv = randn(4, 8, 64), randn(4, 2, 4096, 64), \
            randn(4, 2, 4096, 64)
        pos = torch.randint(2048, 4096, (4,), generator=g, dtype=torch.int32)
        want = dec_ref.decode_attention_ref(q, ck, cv, pos)
        if fault == "decode_last_chunk":
            bad = dec_ref.decode_attention_ref(q, ck, cv,
                                               (pos - 1) // 512 * 512)
        else:
            keep = torch.cat([torch.arange(512), torch.arange(1024, 4096)])
            bad = dec_ref.decode_attention_ref(q, ck[:, :, keep],
                                               cv[:, :, keep], pos - 512)
        assert _within_bf16_rounding(want.bfloat16(), want)
        assert not _within_bf16_rounding(bad.bfloat16(), want)
        return
    hd, h, kv = width
    assert fa_ops.route(torch.bfloat16, hd) == "tc"
    q, k, v = randn(1, h, 1024, hd), randn(1, kv, 1024, hd), \
        randn(1, kv, 1024, hd)
    want = fa_ref.flash_attention_ref(q, k, v, True)
    allowance = _chip_smoke().p_rounding_term(torch, q, k, v, True)
    assert _within_bf16_rounding(_flash_p_rounded(q, k, v, True), want,
                                 allowance)
    bad = want.clone()
    if fault == "flash_diagonal_tile":
        bad[:, :, -64:] = fa_ref.flash_attention_ref(
            q[:, :, -64:], k[:, :, :-64], v[:, :, :-64], False)
    else:   # kv head 0's last query head read against kv head 1
        last = h // kv - 1
        bad[:, last] = fa_ref.flash_attention_ref(
            q[:, last:last + 1], k[:, 1:2], v[:, 1:2], True)[:, 0]
    assert not _within_bf16_rounding(bad.bfloat16(), want, allowance)


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), nearest with ties away from
    zero, by integer operations on the bits, as the kernel rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32: how the tensor core reads an operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _tf32_products(a: torch.Tensor, b: torch.Tensor, terms: int,
                   split_acc: bool) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as the f32 route's mma.sync computes it:
    each operand split into hi (rounded to TF32) and lo = x - hi (read
    truncated to TF32); per 8-wide k-step the products lo.hi, hi.lo and
    hi.hi (``terms`` 3) or hi.hi alone (``terms`` 1), each step's sum
    added to an f32 accumulator, the small products to one of their own
    where ``split_acc`` (the kernel's Q.K^T), else to the one
    accumulator (its P.V)."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    big = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    small = torch.zeros_like(big)

    def step(acc, x, y):
        return (acc.double() + x.double() @ y.double()).float()
    for i in range(0, a.shape[-1], 8):
        k = slice(i, i + 8)
        if terms == 3:
            acc = small if split_acc else big
            acc = step(step(acc, al[..., k], bh[..., k, :]),
                       ah[..., k], bl[..., k, :])
            if split_acc:
                small = acc
            else:
                big = acc
        big = step(big, ah[..., k], bh[..., k, :])
    return big + small


def _flash_tf32x3(q, k, v, causal, terms=3):
    """A CPU model of the f32 route (``csrc/flash_attention.cu``): Q.K^T
    and P.V by ``_tf32_products``, p = 2^(s c - m c) with c = scale *
    log2(e) and one rounding of s c - m c (the kernel's fma), the Pallas
    masking, acc / l. It does not reproduce the tensor core's own
    accumulation order (a step's 8 products are summed here in float64 and
    rounded once), its exp2, or the online softmax's rescaling: the card
    decides (``test_attention_kernels_match_plain_on_card``,
    ``chip_smoke.py``)."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, hd).float()
    s = _tf32_products(qg, k.float()[:, :, None].transpose(-1, -2), terms,
                       True)
    live = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        live = live.tril()
    s = torch.where(live, s, fa_ref.NEG)
    c = torch.tensor(hd ** -0.5, dtype=torch.float32) * torch.tensor(
        1.4426950408889634, dtype=torch.float32)
    mc = s.amax(-1, keepdim=True) * c
    p = torch.where(live, torch.exp2((s.double() * c.double()
                                      - mc.double()).float()), 0.0)
    o = _tf32_products(p, v.float()[:, :, None], terms, False)
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, h, sq, hd)


def _attention_f64(q, k, v, causal):
    """The plain version's arithmetic in float64: the exact result to f32
    precision."""
    b, h, sq, hd = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, hd).double()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.double()) * hd ** -0.5
    live = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        live = live.tril()
    s = torch.where(live, s, fa_ref.NEG)
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.double()) / p.sum(-1, True)
    return o.reshape(b, h, sq, hd)


# chip_smoke.py's f32 flash cases, the prefill shape (S 8192) cut to S 256.
TF32X3_CASES = [((2, 16, 2, 256, 256, 128), True),
                ((1, 16, 2, 256, 256, 128), True),
                ((2, 8, 2, 512, 512, 128), True),
                ((1, 4, 1, 300, 300, 64), True),
                ((2, 2, 2, 128, 640, 64), False),
                ((2, 4, 2, 16, 16, 16), True)]


@pytest.mark.parametrize("q_scale", [1, 8])
@pytest.mark.parametrize("shape,causal", TF32X3_CASES)
def test_tf32x3_model_holds_to_plain(shape, causal, q_scale):
    """The 3xTF32 products pass the f32 card check (2e-5 of the plain
    version), also with q scaled x8, so the scores are 8 times larger and
    the softmax amplifies their errors; there the plain version's own f32
    rounding is up to 0.93 of the tolerance from the float64 result, and
    the model lies within the tolerance of that result too."""
    (_, q), (_, k), (_, v) = _flash_inputs(*shape, "float32")
    q = q * q_scale
    got = _flash_tf32x3(q, k, v, causal)
    _hold_to_plain(got, fa_ref.flash_attention_ref, q, k, v, causal)
    torch.testing.assert_close(got.double(), _attention_f64(q, k, v, causal),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,causal", TF32X3_CASES)
def test_one_term_tf32_fails_the_f32_check(shape, causal):
    """The check has teeth: hi.hi alone (plain TF32) misses it by far."""
    (_, q), (_, k), (_, v) = _flash_inputs(*shape, "float32")
    with pytest.raises(AssertionError):
        _hold_to_plain(_flash_tf32x3(q, k, v, causal, terms=1),
                       fa_ref.flash_attention_ref, q, k, v, causal)


def test_flash_route_by_dtype_and_head_dim():
    """bf16 at head dims 64 and 128 goes to the bf16 tensor-core kernel;
    f32, and bf16 at head dims 16 and 32 (SMOKE widths), to the 3xTF32
    kernel; other dtypes and head dims raise before any launch."""
    for hd in (64, 128):
        assert fa_ops.route(torch.bfloat16, hd) == "tc"
    for hd in (16, 32):
        assert fa_ops.route(torch.bfloat16, hd) == "tf32x3"
    for hd in (16, 32, 64, 128):
        assert fa_ops.route(torch.float32, hd) == "tf32x3"
    with pytest.raises(TypeError, match="dtype"):
        fa_ops.route(torch.float16, 128)
    for dtype, hd in ((torch.bfloat16, 96), (torch.float32, 256),
                      (torch.bfloat16, 8)):
        with pytest.raises(ValueError, match="head dim"):
            fa_ops.route(dtype, hd)


# The persistent (192, 128) instance's schedules: (pairs, query tiles,
# rows a tile, sk, causal, blocks). MLA B (B 2 x 128 heads, S 256, 8-warp
# blocks of 128 rows, one an SM on 132 SMs), chip_smoke's S 2048 case, its
# ragged runs (3 x 48 heads, S 333), 4-warp blocks of 64 rows over full
# attention (an item a block), keys of length 0.
PERSISTENT_CASES = {
    "mla_b": (256, 2, 128, 256, True, 132),
    "s2048": (128, 16, 128, 2048, True, 132),
    "ragged": (144, 3, 128, 333, True, 132),
    "full": (8, 5, 64, 300, False, 40),
    "no_keys": (3, 2, 64, 0, True, 6),
}


@pytest.mark.parametrize("case", sorted(PERSISTENT_CASES))
def test_persistent_blocks_take_every_query_tile_once(case):
    """``ops.block_items`` (the schedule ``csrc/flash_attention.cu``
    computes on the card): the blocks' runs, in block order, walk every
    (pair, query tile) item once in the global order (a pair's tiles
    heaviest first when causal), and no block's work in key tiles exceeds
    an equal share by more than one item's."""
    n_pairs, n_q, rows, sk, causal, n_blocks = PERSISTENT_CASES[case]
    runs = fa_ops.block_items(n_pairs, n_q, rows, sk, causal, n_blocks)
    assert len(runs) == n_blocks
    walked, work = [], []
    for p0, j0, items in runs:
        p, j, w = p0, j0, 0
        for _ in range(items):
            walked.append((p, j))
            w += fa_ops.item_tiles(j, n_q, rows, sk, causal)
            p, j = (p + 1, 0) if j + 1 == n_q else (p, j + 1)
        work.append(w)
    assert walked == [(p, j) for p in range(n_pairs) for j in range(n_q)]
    tiles = [fa_ops.item_tiles(j, n_q, rows, sk, causal) for j in range(n_q)]
    assert max(work) <= sum(tiles) * n_pairs / n_blocks + max(tiles)
    if causal and sk:
        # Heaviest first: the last query tile of a pair walks every key.
        assert tiles[0] == -(-min(sk, n_q * rows) // fa_ops.PERSISTENT_TILE)
        assert tiles == sorted(tiles, reverse=True)
    if case == "mla_b":
        # 24 key tiles a block at most: the equal share, 23.3, rounded up.
        assert max(work) == 24


# The tensor-core gradient's persistent schedules at (192, 128): (kernel,
# B x heads, S, causal, CTAs). MLA T (B 1 x 128 heads, S 4096), MLA B's
# shape (B 2 x 128 heads, S 256), chip_smoke's ragged case (3 x 48 heads,
# S 333: 432 items of each kernel, no multiple of 132), full attention,
# fewer items than CTAs (a CTA an item).
BWD_TC_CASES = {
    f"{kernel}_{name}": (kernel, *shape)
    for kernel in ("dq", "dkv")
    for name, shape in (("mla_t", (128, 4096, True, 132)),
                        ("mla_b", (256, 256, True, 132)),
                        ("ragged", (144, 333, True, 132)),
                        ("full", (8, 300, False, 132)),
                        ("few", (4, 200, True, 132)))}
# snake_item in csrc/flash_attention_bwd_tc.cu, which _snake_runs models.
SNAKE_ITEM = "return k * g + ((k & 1) ? g - 1 - c : c);"


def _snake_runs(n_items, n_blocks):
    """Each CTA's items in the order it walks them: rounds of
    ``n_blocks`` items, dealt forward in even rounds and backward in odd
    ones (``snake_item``)."""
    runs = [[] for _ in range(n_blocks)]
    for item in range(n_items):
        k, c = divmod(item, n_blocks)
        runs[n_blocks - 1 - c if k % 2 else c].append(item)
    return runs


def _item_tiles(item, n_bh, s, causal, kernel):
    """The tiles an item walks (item // n_bh is its rank): dq a 128-row
    query tile (the last first when causal) over the 64-key tiles up to
    its last row, dkv a 128-key tile (the first first) over the 64-row
    query tiles that see it."""
    rank = item // n_bh
    if kernel == "dq":
        n_qt = -(-s // 128)
        qt = n_qt - 1 - rank if causal else rank
        return -(-(min(s, (qt + 1) * 128) if causal else s) // 64)
    return max(-(-s // 64) - (2 * rank if causal else 0), 0)


@pytest.mark.parametrize("case", sorted(BWD_TC_CASES))
def test_bwd_tc_schedule_takes_every_item_once_balanced(case):
    """The walk of the tensor-core gradient's kernels at (192, 128)
    (``snake_item`` in ``csrc/flash_attention_bwd_tc.cu``, modelled here):
    every (b*h, tile) item once, each CTA walking its items in the global
    order, which is heaviest first (the tiles never rise along it), and
    no CTA's tiles exceed an equal share by more than one item's. On the
    card chip_smoke.py's ragged (192, 128) case checks every output."""
    kernel, n_bh, s, causal, n_blocks = BWD_TC_CASES[case]
    source = (pathlib.Path(__file__).resolve().parents[1] / "src"
              / "repro_torch" / "csrc" / "flash_attention_bwd_tc.cu"
              ).read_text()
    assert source.count(SNAKE_ITEM) == 1
    n_items = n_bh * -(-s // 128)
    runs = _snake_runs(n_items, n_blocks)
    assert len(runs) == n_blocks
    assert sorted(i for run in runs for i in run) == list(range(n_items))
    assert all(run == sorted(run) for run in runs)
    tiles = [_item_tiles(i, n_bh, s, causal, kernel) for i in range(n_items)]
    assert tiles == sorted(tiles, reverse=True)
    if causal:
        assert tiles[0] > tiles[-1]
    work = [sum(tiles[i] for i in run) for run in runs]
    assert max(work) <= sum(tiles) / n_blocks + max(tiles)
    if n_items <= n_blocks:   # a CTA an item, in item order
        assert runs[:n_items] == [[i] for i in range(n_items)]
    if case == "dq_mla_t":
        # The snake deals MLA T's 4,096 dq items as evenly as a greedy
        # scheduler would: 1,024 key tiles a CTA, the equal share.
        assert max(work) == 1024


# The G = 1 layout's plans on a 132-SM card: (B, H, S, hd, positions).
# whisper-small's self cache (S 448, ragged, one empty request) and cross
# caches (S 1,500, every position live), a cache shorter than one unit, B*H
# at the grid's limit of rows, and a short cache over few rows (several
# units a row, the combine's scratch).
G1_SELF_POS = [0, 448, 1, 77, 200, 300, 447, 64, 128, 256, 333, 400, 5, 17,
               100, 250]
G1_PLAN_CASES = {
    "whisper_self": (16, 12, 448, 64, G1_SELF_POS),
    "whisper_cross": (16, 12, 1500, 64, [1500] * 16),
    "short": (2, 3, 20, 64, [0, 20]),
    "grid_rows": (21845, 3, 33, 16, [0, 1, 31, 32, 33, 34]),
    "few_rows": (3, 4, 1000, 32, [0, 1, 511, 1000]),
    "moe_c": (16, 16, 32768, 128, [9716, 31406, 4096, 4097, 32768, 1]),
}
# The kernel's lines that the model below follows (its constants those of
# ops.py).
G1_SOURCE_LINES = (
    f"constexpr int kTile = {dec_ops.TILE};",
    f"constexpr int kG1Warps = {dec_ops.G1_WARPS};",
    f"constexpr int kG1Stages = {dec_ops.G1_STAGES};",
    "  const int start = blockIdx.x * a.chunk;",
    "  if (start >= limit && !direct) return;",
    "  const int end = max(min(start + a.chunk, limit), start);",
    "  const int n_tiles = (end - start + kTile - 1) / kTile;",
    "  const int my_n = n_tiles > warp ? (n_tiles - 1 - warp) / kG1Warps + 1 "
    ": 0;",
    "    const int t0 = start + (warp + i * kG1Warps) * kTile;",
    "  const int live = limit > 0 ? (limit + a.chunk - 1) / a.chunk : 0;",
    "  static constexpr int kStage = kTile * (kKRow + kRow);  // K then V",
    "  static constexpr int kKRow = kRow + 16;",
)


def _g1_positions(limit, span, n_units):
    """The positions each (unit, warp) of a row takes in
    ``decode_g1_kernel``: unit u starts at u * span (a dead unit, past the
    row's length, returns unless it is the row's only one), its tiles of
    32 go to the warps in turn."""
    taken = {}
    for u in range(n_units):
        start = u * span
        if start >= limit and n_units > 1:
            continue
        end = max(min(start + span, limit), start)
        n_tiles = -(-(end - start) // dec_ops.TILE)
        for w in range(dec_ops.G1_WARPS):
            my_n = (n_tiles - 1 - w) // dec_ops.G1_WARPS + 1 \
                if n_tiles > w else 0
            taken[u, w] = [t0 + j for i in range(my_n)
                           for t0 in [start + (w + i * dec_ops.G1_WARPS)
                                      * dec_ops.TILE]
                           for j in range(dec_ops.TILE) if t0 + j < end]
    return taken


@pytest.mark.parametrize("case", sorted(G1_PLAN_CASES))
def test_g1_plan_takes_every_live_position_once(case, monkeypatch):
    """``ops.g1_plan`` and the G = 1 kernel's walk of it (modelled from
    the lines of ``csrc/decode_attention.cu`` that the test asserts): each
    live position of every (b, head) row goes to exactly one (unit, warp),
    the units that do work are the ones the combine reads (ceil(length /
    span)), a row of one unit is written by the kernel itself; the
    wrapper allocates scratch for the plan's units, none for one, and
    passes the plan to the C entry point. At whisper's shapes one unit a
    row (192 rows fill the card's 264 blocks once)."""
    import contextlib
    from repro_torch.kernels import _build, _launch
    source = (ROOT / "src" / "repro_torch" / "csrc" / "decode_attention.cu"
              ).read_text()
    for line in G1_SOURCE_LINES:
        assert line in source, line
    b, h, s, hd, pos = G1_PLAN_CASES[case]
    rows = b * h
    span, n_units = dec_ops.g1_plan(s, rows, hd, 132)
    assert n_units == max(1, -(-s // span)) and span >= 1
    assert span <= dec_ops.G1_MAX_SPAN
    for limit in sorted({min(p, s) for p in pos}):
        taken = _g1_positions(limit, span, n_units)
        flat = sorted(p for ps in taken.values() for p in ps)
        assert flat == list(range(limit))
        working = {u for (u, _), ps in taken.items() if ps}
        live = -(-limit // span) if limit > 0 else 0
        assert working == set(range(live))
        # Each warp of a working unit takes its share of the tiles: at
        # most one tile more than another warp's.
        for u in working:
            n = [len(taken[u, w]) for w in range(dec_ops.G1_WARPS)]
            assert max(n) - min(n) <= dec_ops.TILE
    if case.startswith("whisper"):
        assert (span, n_units) == (s, 1)
    per_sm = dec_ops.SM_SMEM // (dec_ops.g1_smem(hd) + dec_ops.BLOCK_RESERVED)
    assert n_units == 1 or rows * n_units <= 132 * per_sm \
        or span == dec_ops.G1_MAX_SPAN
    if dec_ops.layout(torch.bfloat16, hd, 1) != "g1":
        return   # hd 128 stays grouped unless G1_HEAD_DIMS takes it
    # The wrapper: scratch of the plan's units (none for one unit), the
    # plan passed on, the G = 1 layout counted; a stand-in library.
    called, shapes = [], []

    class Lib:
        def moby_decode_attention_g1(self, *args):
            called.append(args)
            return 0

    empty = torch.empty

    def recording_empty(*size, **kw):
        shapes.append(tuple(size[0]) if len(size) == 1 else size)
        return empty(*size, **kw)
    monkeypatch.setattr(_launch, "dispatch_device", lambda kernel, t: "cuda")
    monkeypatch.setattr(_launch, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(_launch, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(dec_ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", recording_empty)
    q = empty((b, h, hd), dtype=torch.bfloat16)
    cache = empty((b, h, 1, hd), dtype=torch.bfloat16).expand(b, h, s, hd)
    cache_pos = torch.tensor([min(pos[i % len(pos)], s) for i in range(b)],
                             dtype=torch.int32)
    kernels.reset_launch_counts()
    dec_ops.decode_attention(q, cache, cache, cache_pos)
    monkeypatch.setattr(torch, "empty", empty)
    assert dec_ops.layout_launches == {"g1": 1, "grouped": 0}
    assert kernels.launch_counts()["decode_attention"] == 1
    (args,) = called
    assert args[9:15] == (b, h, s, hd, span, n_units)
    parts = n_units if n_units > 1 else 0
    assert shapes == [(b, h, hd), (parts, rows), (parts, rows, hd)]


@pytest.mark.parametrize("dtype,hd,h,kv,kind", [
    (torch.bfloat16, 64, 12, 12, "g1"), (torch.bfloat16, 16, 4, 4, "g1"),
    (torch.bfloat16, 32, 4, 4, "g1"), (torch.bfloat16, 64, 16, 2, "grouped"),
    (torch.float32, 64, 12, 12, "grouped"),
    (torch.bfloat16, 128, 16, 2, "grouped"),
    (torch.bfloat16, 128, 16, 16,
     "g1" if 128 in dec_ops.G1_HEAD_DIMS else "grouped")])
def test_decode_layout_by_shape(dtype, hd, h, kv, kind):
    """The decode kernel's layout is chosen from the dtype, head dim and
    head group before the launch: bf16 at G = 1 takes the G = 1 layout
    (at ``G1_HEAD_DIMS``), every other instance the grouped one."""
    assert dec_ops.layout(dtype, hd, h // kv) == kind


@pytest.mark.parametrize("dtype,hd,path", [
    (torch.bfloat16, 64, "tc"), (torch.bfloat16, 128, "tc"),
    (torch.bfloat16, 32, "tf32x3"), (torch.float32, 64, "tf32x3")])
def test_flash_forward_launches_its_route(monkeypatch, dtype, hd, path):
    """On the card ``flash_attention`` calls the entry point of ``route``
    with the head dim (``moby_flash_attention_tc`` for bf16 at hd 64 and
    128, ``moby_flash_attention`` otherwise) and advances exactly that
    route's counter; on the tensor-core route an operand beyond a TMA
    tensor map raises before any launch. The library is a stand-in that
    records the calls (the CPU has no card)."""
    import contextlib
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
    q = torch.zeros(1, 4, 77, hd, dtype=dtype)
    k = torch.zeros(1, 2, 77, hd, dtype=dtype)
    kernels.reset_launch_counts()
    out = fa_ops.flash_attention(q, k, k, True)
    counts = kernels.launch_counts()
    tc = path == "tc"
    name, args = called[-1]
    assert name == ("moby_flash_attention_tc" if tc
                    else "moby_flash_attention")
    assert args[10] == hd   # after 4 pointers, the strides, b, h, kv, sq, sk
    assert counts["flash_attention_tc"] == int(tc)
    assert counts["flash_attention"] == int(not tc)
    assert sum(counts.values()) == 1
    assert out.shape == (1, 4, 77, hd) and out.transpose(1, 2).is_contiguous()
    far = torch.zeros(hd, dtype=dtype).as_strided(
        (1, 1, 1, hd), (2 ** 40, 2 ** 40, hd, 1))
    n = len(called)
    if tc:
        with pytest.raises(ValueError, match="TMA"):
            fa_ops.flash_attention(q[:, :1, :1], far, far, True)
        assert len(called) == n


@pytest.mark.cuda
def test_attention_kernels_match_plain_on_card():
    """Each CUDA kernel agrees with its plain version on card tensors (the
    tensor-core flash route with its p-rounding allowance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    dev = torch.device("cuda")
    cs = _chip_smoke()
    for shape, causal in FLASH_CASES:
        for dtype in DTYPES:
            (_, q), (_, k), (_, v) = _flash_inputs(*shape, dtype)
            q, k, v = q.to(dev), k.to(dev), v.to(dev)
            p_rounding = cs.p_rounding_term(torch, q, k, v, causal) \
                if fa_ops.route(q.dtype, shape[-1]) == "tc" else None
            _hold_to_plain(fa_ops.flash_attention(q, k, v, causal),
                           fa_ref.flash_attention_ref, q, k, v, causal,
                           p_rounding=p_rounding)
    for shape in DECODE_SHAPES:
        for dtype in DTYPES:
            (_, q), (_, ck), (_, cv), (_, pos) = _decode_inputs(*shape, dtype)
            q, ck, cv, pos = (t.to(dev) for t in (q, ck, cv, pos))
            _hold_to_plain(dec_ops.decode_attention(q, ck, cv, pos),
                           dec_ref.decode_attention_ref, q, ck, cv, pos)

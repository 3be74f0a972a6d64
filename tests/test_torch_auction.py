"""The auction past 128 persons (the wide instance of ``csrc/auction.cu``).

* ``kernels/auction/ops.py::plan`` picks the wide instance above 128
  persons and refuses only an n whose 12 n bytes of shared memory exceed
  the device's opt-in limit a block, with a message that names it; its
  tier is resident (the rows in shared memory) while 4 n^2 + 32 n + 8
  bytes fit that limit, streamed past it;
* ``smoke`` with ``max_obj=80`` (an association of n = 160 persons) through
  the port's ``Session`` on the CPU equals a live JAX run (``kind`` exact,
  floats within the golden tolerance, rtol 1e-4, atol 1e-5);
* ``chip_smoke.bidders_a_round`` (the bidders of each round, which the
  card's bound counts) replays the plain version's rounds exactly;
* ``tools/auction_wide_probe.py``'s text edits still apply to the port's
  source, each build changing what it names and nothing else;
* on a card (``cuda``-marked; skips here, ``python3 chip_smoke.py`` covers
  it there) the wide instance equals its plain version bit for bit.
"""
import csv
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.kernels.auction import ops as au_ops  # noqa: E402
from repro_torch.kernels.auction import ref as au_ref  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
FLOATS = ("latency_s", "onboard_s", "f1", "precision", "recall")


@pytest.mark.parametrize("n", [129, 256, 1024, 4096])
def test_plan_takes_wide_n_on_the_wide_instance(n):
    batch, got_n, eps, warps, tier = au_ops.plan((2, n, n), torch.float32,
                                                 1e-4)
    assert (batch, got_n, eps) == (2, n, au_ref.phase_epsilons(1e-4))
    assert warps == au_ops.WIDE_WARPS
    assert tier in ("resident", "streamed")
    assert n * au_ops.WIDE_SMEM_PER_PERSON <= au_ops.H100_SMEM_OPTIN


def test_plan_refuses_only_above_the_shared_memory_bound():
    bound = au_ops.H100_SMEM_OPTIN // au_ops.WIDE_SMEM_PER_PERSON
    assert bound == 19370
    assert au_ops.plan((1, bound, bound), torch.float32, 1e-4)[3] == \
        au_ops.WIDE_WARPS
    with pytest.raises(ValueError, match=f"limit of "
                       f"{au_ops.H100_SMEM_OPTIN} bytes"):
        au_ops.plan((1, bound + 1, bound + 1), torch.float32, 1e-4)
    # A device with less shared memory a block bounds n lower.
    with pytest.raises(ValueError, match="limit of 49152 bytes"):
        au_ops.plan((1, 4097, 4097), torch.float32, 1e-4, smem_optin=49152)
    assert au_ops.plan((1, 4096, 4096), torch.float32, 1e-4,
                       smem_optin=49152)[3] == au_ops.WIDE_WARPS


def test_resident_bound():
    """The resident tier's shared memory: the rows, the slots and prices
    (12 bytes a person), the bidders' state (20) and the lists' two counts:
    n <= 237 on an H100."""
    bound = au_ops.resident_max_n(au_ops.H100_SMEM_OPTIN)
    assert bound == 237
    assert au_ops.resident_smem(bound) <= au_ops.H100_SMEM_OPTIN \
        < au_ops.resident_smem(bound + 1)
    assert au_ops.resident_smem(160) == 160 * 160 * 4 + 160 * 32 + 8
    assert au_ops.resident_max_n(49152) == 106


H100_BOUND = 237


@pytest.mark.parametrize("smem_optin", [au_ops.H100_SMEM_OPTIN, 49152])
@pytest.mark.parametrize("n", [129, 160, H100_BOUND, H100_BOUND + 1, 1024,
                               19370])
def test_plan_picks_the_tier(n, smem_optin):
    """Resident up to the device's resident bound (237 on an H100; 106,
    below the wide instance, at 48 KB), streamed past it, refused past 12 n
    bytes (19,370 persons on an H100, 4,096 at 48 KB)."""
    shape = (3, n, n)
    if n * au_ops.WIDE_SMEM_PER_PERSON > smem_optin:
        with pytest.raises(ValueError, match=f"limit of {smem_optin} bytes"):
            au_ops.plan(shape, torch.float32, 1e-4, smem_optin=smem_optin)
        return
    got = au_ops.plan(shape, torch.float32, 1e-4, smem_optin=smem_optin)
    assert (got.batch, got.n, got.warps) == (3, n, au_ops.WIDE_WARPS)
    want = "resident" if au_ops.resident_smem(n) <= smem_optin \
        else "streamed"
    assert got.tier == want
    assert want == ("resident" if smem_optin == au_ops.H100_SMEM_OPTIN
                    and n <= H100_BOUND else "streamed")


def _rows(text):
    return list(csv.DictReader(io.StringIO(text)))


def test_smoke_max_obj_80_matches_jax():
    """n = 2 * max_obj = 160 persons an association: the card's wide
    instance; on the CPU the plain version, held here to JAX."""
    frames = 4
    got = api.Session(api.scenario("smoke", seed=0, max_obj=80),
                      torch_device="cpu").run(frames)
    want = japi.Session(japi.scenario("smoke", seed=0, max_obj=80,
                                      backend="ref")).run(frames)
    g_rows, w_rows = _rows(got.to_csv()), _rows(want.to_csv())
    assert len(g_rows) == len(w_rows) == frames
    assert {r["kind"] for r in g_rows} >= {"anchor", "transform"}
    for g, w in zip(g_rows, w_rows):
        assert g["kind"] == w["kind"], w["frame"]
        for k in FLOATS:
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{w['frame']} {k}")


def _tied(n, batch, seed, equal_rows=False, zero_rows=False):
    rng = np.random.default_rng(seed)
    b = (rng.integers(0, 20, (batch, n, n)) * np.float32(1e-3)) \
        .astype(np.float32)
    if zero_rows:
        b[:, rng.uniform(size=n) < 1 / 3, :] = 0.0
        b[:, :, rng.uniform(size=n) < 1 / 3] = 0.0
    if equal_rows:
        b[:] = b[:, :1]
    return b


@pytest.mark.cuda
def test_wide_instance_matches_plain_on_card():
    """The wide instance equals its plain version bit for bit (assignment,
    prices, rounds) at n = 129, 160 (one auction and 16), the card's
    resident bound and one past it (the two tiers), 256 and 1000, with
    zero rows and with every row equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    from repro_torch import kernels
    dev = torch.device("cuda")
    bound = au_ops.resident_max_n(au_ops.smem_optin(dev))
    cases = [_tied(129, 4, 1), _tied(160, 1, 5), _tied(160, 16, 6),
             _tied(bound, 1, 7), _tied(bound + 1, 1, 8), _tied(256, 2, 2),
             _tied(1000, 1, 3), _tied(160, 1, 9, zero_rows=True),
             _tied(160, 1, 10, equal_rows=True),
             _tied(256, 1, 4, equal_rows=True)]
    kernels.reset_launch_counts()
    for b in cases:
        b = torch.from_numpy(b).to(dev)
        got = au_ops.auction(b, max_iter_per_phase=20000)
        want = au_ref.auction_ref(b, max_iter_per_phase=20000)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), b.shape
    counts = kernels.launch_counts()
    assert (counts["auction_wide"], counts["auction"]) == (len(cases), 0)


ROOT = Path(__file__).resolve().parents[1]


def _module(path: Path, name: str):
    """A script of the repo as a module (it imports only the standard
    library at the top)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,batch,seed,equal_rows", [
    (12, 1, 1, False), (24, 4, 2, False), (40, 2, 3, True)])
def test_bidder_replay_matches_the_plain_rounds(n, batch, seed, equal_rows):
    """Every auction's rounds with a bidder are the plain version's rounds,
    every phase starts with all n persons bidding, and no round has more
    bidders than the last within a phase past its first."""
    cs = _module(ROOT / "chip_smoke.py", "chip_smoke")
    b = torch.from_numpy(_tied(n, batch, seed, equal_rows=equal_rows))
    left = cs.bidders_a_round(torch, b, 4000)
    rounds = au_ref.auction_ref(b)[2].reshape(-1)
    assert torch.equal((left > 0).sum(0).to(torch.int32), rounds)
    starts = (left == n).all(1)
    assert int(starts.sum()) == len(au_ref.phase_epsilons(1e-4))
    assert bool(((left[1:] <= left[:-1]) | starts[1:, None]).all())
    assert int(left.sum()) < n * int(rounds.sum())


_PROBE = _module(ROOT / "tools" / "auction_wide_probe.py",
                 "auction_wide_probe")


@pytest.mark.parametrize("name", [*_PROBE.BUILDS, _PROBE.STAMPED[0]])
def test_probe_edits_apply_to_the_port(name, tmp_path, monkeypatch):
    """Each probe build's edits apply once each to ``csrc/auction.cu``;
    the builds that call ``tools/auction_wide_steps.cuh`` splice it in,
    and the port's own source keeps none of the probe's code."""
    monkeypatch.setattr(_PROBE, "OUT", tmp_path)
    source = ROOT / "src" / "repro_torch" / "csrc" / "auction.cu"
    edits = _PROBE.STAMPED[1] if name == _PROBE.STAMPED[0] \
        else _PROBE.BUILDS[name][0]
    text = _PROBE.edited(source, name, edits).read_text()
    port = source.read_text()
    assert text != port
    spliced = '#include "auction_wide_steps.cuh"' in text
    assert spliced == (_PROBE.SPLICE in edits)
    steps = (ROOT / "tools" / "auction_wide_steps.cuh").read_text()
    for word in ("dense_phase", "few_bidder_rounds", "Stamps"):
        assert word in steps and word not in port
        if word in text.replace('#include "auction_wide_steps.cuh"', ""):
            assert spliced

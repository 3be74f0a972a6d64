"""The auction past 128 persons (the wide instance of ``csrc/auction.cu``).

* ``kernels/auction/ops.py::plan`` picks the wide instance above 128
  persons and refuses only an n whose 12 n bytes of shared memory exceed
  the device's opt-in limit a block, with a message that names it;
* ``smoke`` with ``max_obj=80`` (an association of n = 160 persons) through
  the port's ``Session`` on the CPU equals a live JAX run (``kind`` exact,
  floats within the golden tolerance, rtol 1e-4, atol 1e-5);
* on a card (``cuda``-marked; skips here, ``python3 chip_smoke.py`` covers
  it there) the wide instance equals its plain version bit for bit.
"""
import csv
import io

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
    batch, got_n, eps, warps = au_ops.plan((2, n, n), torch.float32, 1e-4)
    assert (batch, got_n, eps) == (2, n, au_ref.phase_epsilons(1e-4))
    assert warps == au_ops.WIDE_WARPS
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


def _tied(n, batch, seed, equal_rows=False):
    rng = np.random.default_rng(seed)
    b = (rng.integers(0, 20, (batch, n, n)) * np.float32(1e-3)) \
        .astype(np.float32)
    if equal_rows:
        b[:] = b[:, :1]
    return b


@pytest.mark.cuda
def test_wide_instance_matches_plain_on_card():
    """The wide instance equals its plain version bit for bit (assignment,
    prices, rounds) at n = 129, 256 and 1000, and with every row equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py there)")
    from repro_torch import kernels
    dev = torch.device("cuda")
    cases = [_tied(129, 4, 1), _tied(256, 2, 2), _tied(1000, 1, 3),
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

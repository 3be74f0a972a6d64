"""The port's threefry generator against ``jax.random``, bit for bit.

RANSAC's triplets come from ``jax.random`` in the JAX package and from
``repro_torch.core.prng`` in the port; the planes, the boxes and (through
F1) the scheduler's frame kinds all follow from these bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import prng  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SEEDS = [0, 1, 2, 7, 42, 1234, 99991, 2 ** 31 - 1, -1, -123456]


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_defaults_are_the_ported_ones():
    """The port reproduces threefry2x32 in partitionable mode."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_key(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _words(jax.random.key(seed)))


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.key(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 12, 20])
def test_split(seed, num):
    got = prng.split(prng.key(seed), num).numpy()
    want = _words(jax.random.split(jax.random.key(seed), num))
    np.testing.assert_array_equal(got, want)


def test_split_chain_and_batch():
    """The engine's key chain (split the state key every frame) and a
    batched split of many keys at once, as RANSAC splits per object."""
    kj, kt = jax.random.key(0), prng.key(0)
    for _ in range(20):
        kj, _ = jax.random.split(kj)
        kt = prng.split(kt)[0]
        np.testing.assert_array_equal(kt.numpy(), _words(kj))
    keys_j = jax.random.split(jax.random.key(5), 6)
    keys_t = prng.split(prng.key(5), 6)
    got = prng.split(keys_t, 3).numpy()
    want = np.stack([_words(jax.random.split(k, 3)) for k in keys_j])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(30, 3), (12,), (7, 5, 2)])
def test_randint_shapes(seed, shape):
    for maxval in (1, 2, 3, 100, 255, 256, 70000, 2 ** 31 - 1):
        got = prng.randint(prng.key(seed), shape, 0, maxval).numpy()
        want = np.asarray(jax.random.randint(jax.random.key(seed), shape, 0,
                                             maxval))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_traced_maxval_1_to_256(seed):
    """RANSAC's call: one key per object and a traced ``max(n_valid, 1)``
    bound per object, ``vmap``-ed in the JAX package."""
    maxval = np.arange(1, 257, dtype=np.int32)
    keys = jax.random.split(jax.random.key(seed), maxval.size)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, m: jax.random.randint(k, (30, 3), 0, m)))(
            keys, jnp.asarray(maxval)))
    got = prng.randint(prng.split(prng.key(seed), maxval.size), (30, 3), 0,
                       torch.from_numpy(maxval.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and (got < maxval[:, None, None]).all()


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_randint_minval_and_empty_span(seed):
    k = jax.random.key(seed)
    for lo, hi in ((5, 9), (-3, 4), (7, 7), (9, 2)):
        want = np.asarray(jax.random.randint(k, (40,), lo, hi))
        got = prng.randint(prng.key(seed), (40,), lo, hi).numpy()
        np.testing.assert_array_equal(got, want)

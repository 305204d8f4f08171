"""The port's threefry2x32 (utils/prng.py) against jax.random, bit for bit:
PRNGKey, split (a chain of five, and shaped splits) and uniform, on the
seeds the JAX strategy uses (RANDOM_SEED + 7919 * (iteration + 1), masked
to 31 bits) and the int32 range's ends."""

import jax
import numpy as np
import pytest

from multi_view_active_learning_tpu_torch.config import get_default_configs
from multi_view_active_learning_tpu_torch.utils import prng

_SEED = get_default_configs().RANDOM_SEED
SEEDS = [0, 1307, 2**31 - 1] + [(_SEED + 7919 * k) & 0x7FFFFFFF for k in (1, 2, 3)]
SHAPES = [(1,), (4,), (7,), (2, 3)]


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, shape):
    got = prng.uniform(prng.PRNGKey(seed), shape)
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_matches_jax(seed):
    """The strategy's stream: split once a batch, draw from the subkey."""
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for _ in range(5):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
        np.testing.assert_array_equal(key, np.asarray(jkey))
        np.testing.assert_array_equal(sub, np.asarray(jsub))
        np.testing.assert_array_equal(_bits(prng.uniform(sub, (4,))),
                                      _bits(jax.random.uniform(jsub, (4,))))


@pytest.mark.parametrize("num", [3, (2, 2)], ids=str)
def test_shaped_split_matches_jax(num):
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(1307), num),
                                  np.asarray(jax.random.split(jax.random.PRNGKey(1307), num)))


def test_seed_outside_int32_raises():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**31)

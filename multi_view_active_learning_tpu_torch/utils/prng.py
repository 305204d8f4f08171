"""JAX's default random stream (threefry2x32) in numpy, for the host.

The JAX package draws the RANDOM strategy's pool scores with
``jax.random.uniform(skey, (B,))``, its key split once a batch from
``PRNGKey((RANDOM_SEED + 7919 * (iteration + 1)) & 0x7FFFFFFF)``
(strategy.py:583-585, engine.py:510-511 there).  A selection that is to
pick the JAX package's frames needs the same bits, so this module
computes ``PRNGKey``, ``split`` and ``uniform`` bit for bit as
``jax.random`` does with ``jax_threefry_partitionable=True`` (its default):

  * a key is two uint32 words, ``[seed >> 32, seed & 0xFFFFFFFF]`` of the
    seed as a 32-bit integer (so the high word is 0);
  * the i-th of a shaped draw (row-major) hashes the counter pair
    ``(i >> 32, i & 0xFFFFFFFF)`` with threefry2x32 (20 rounds) under the
    key: ``split`` keeps both output words as the new key, 32-bit
    ``random_bits`` xors them;
  * ``uniform`` in [0, 1) puts the top 23 bits in the mantissa of a float32
    in [1, 2) and subtracts 1.

Keys are numpy uint32 arrays of shape (2,).  The draws are few (B floats a
batch), so they are made on the host and moved to the device.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotate_left(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of counter words (x0, x1) under key, 20 rounds
    (jax/_src/prng.py::_threefry2x32_lowering)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # uint32 arithmetic wraps, as in the hash
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for step in range(5):
            for r in _ROTATIONS[step % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotate_left(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(step + 1) % 3]
            x[1] = x[1] + ks[(step + 2) % 3] + np.uint32(step + 1)
    return np.asarray(x[0], np.uint32), np.asarray(x[1], np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError("seed %d is outside the int32 range" % seed)
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _counters(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The uint64 iota of ``shape`` as (high, low) uint32 words."""
    i = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    return (int(shape),) if np.isscalar(shape) else tuple(int(s) for s in shape)


def split(key: np.ndarray, num: Union[int, Sequence[int]] = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: keys of shape ``(*num, 2)``."""
    b0, b1 = threefry2x32(key, *_counters(_shape(num)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: Union[int, Sequence[int]]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    b0, b1 = threefry2x32(key, *_counters(_shape(shape)))
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Union[int, Sequence[int]] = ()) -> np.ndarray:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)

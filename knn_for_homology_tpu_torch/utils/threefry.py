"""JAX's default PRNG in numpy: Threefry-2x32 and `jax.random.randint`,
bit for bit, so that what the reference draws from a seed the port draws
too (the graph index's long-range edges, search/graph.py:_finish_graph).

This is the variant of jax 0.9.0 with `jax_threefry_partitionable = True`
(that release's default):

  * `PRNGKey(seed)` is the pair (0, seed mod 2^32): with 64-bit types off
    (JAX's default) the seed is cut to 32 bits before the high word is
    taken (jax/_src/prng.py:threefry_seed);
  * a split hashes the 64-bit counters 0 .. num-1 of the new keys' shape
    (hi, lo words) and stacks the two output words as each new key
    (prng.py:_threefry_split_foldlike);
  * random bits hash the 64-bit counters 0 .. size-1 of the output shape
    and xor the two output words, for 32-bit draws
    (prng.py:_threefry_random_bits_partitionable);
  * `randint` splits the key once, draws 32 bits twice and folds them into
    the span with uint32 arithmetic that wraps
    (jax/_src/random.py:_randint). Its multiplier 2^32 mod span is taken as
    ((2^16 mod span)^2 mod 2^32) mod span, which is 0 for spans above 2^16:
    the draw is then the low word mod span, as in JAX.
"""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_MASK = 0xFFFFFFFF


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter words x1, x2 (uint32
    arrays of one shape) under the key (k1, k2) → two uint32 arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(shape):
    """The hi and lo words of the 64-bit counters 0 .. prod(shape) - 1."""
    count = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    return ((count >> np.uint64(32)).astype(np.uint32).reshape(shape),
            (count & np.uint64(_MASK)).astype(np.uint32).reshape(shape))


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)` (64-bit types off) as a (k1, k2) pair of
    uint32."""
    return np.uint32(0), np.uint32(seed & _MASK)


def split(key, num: int = 2):
    """`jax.random.split(key, num)` → a list of `num` keys."""
    b1, b2 = threefry2x32(*key, *_counters((num,)))
    return [(b1[i], b2[i]) for i in range(num)]


def random_bits32(key, shape):
    """32 random bits per entry of `shape`, uint32."""
    b1, b2 = threefry2x32(*key, *_counters(tuple(shape)))
    return b1 ^ b2


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval, dtype=jnp.int32)`
    for int32 bounds, bit for bit."""
    k1, k2 = split(key)
    higher, lower = random_bits32(k1, shape), random_bits32(k2, shape)
    span = np.uint32((maxval - minval) & _MASK if maxval > minval else 1)
    with np.errstate(over="ignore"):
        multiplier = np.uint32((1 << 16) % int(span))
        multiplier = (multiplier * multiplier) % span
        offset = (higher % span) * multiplier + (lower % span)
    offset = offset % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)

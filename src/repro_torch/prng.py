"""Counter-based random numbers: ``jax.random``'s threefry2x32, in torch.

This reproduces, bit for bit, what ``jax.random`` computes with the
threefry2x32 implementation and ``jax_threefry_partitionable=True`` (the
default from jax 0.5 on): ``PRNGKey``, ``fold_in``, ``split``,
``uniform``, ``randint`` and ``permutation``. Every draw is a pure
function of (key, position), so the walks and negatives of a run are the
same on the CPU and on the card, and the same as the JAX package's.

Keys are pairs of Python ints: deriving a key (``fold_in``, ``split``) is
scalar host arithmetic and never touches the device. The bulk draws run
on the device as int64 tensor arithmetic masked to 32 bits (torch's
``uint32`` lacks most operators). Functions that draw take either one
key or a sequence of keys; with a sequence the result has a leading axis,
one slice per key, so a whole chunk of training steps draws in one go.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
Key = Tuple[int, int]
KeyLike = Union[Key, Sequence[Key]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Elements drawn per pass: bounds the int64 temporaries of a large draw.
_CHUNK = 1 << 24


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, as ``jax._src.prng`` applies it.

    Works on Python ints and on int64 tensors alike (every value stays
    below 2**61 before it is masked back to 32 bits)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key_of(raw) -> Key:
    """A key stored as an array of two uint32 words (``jax.random.PRNGKey``'s
    data, a snapshot's ``key_walk``) as the port's pair of ints."""
    k0, k1 = np.asarray(raw, np.uint32).reshape(2).tolist()
    return (k0, k1)


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**31."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key: Key, num: int = 2) -> list:
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def fold_in_tensor(k0, k1, data):
    """``fold_in`` elementwise: key words and data are int64 tensors or
    ints, broadcast together. Returns the new key words (k0, k1)."""
    return threefry2x32(k0, k1, 0, data & M32)


def split_tensor(k0: torch.Tensor, k1: torch.Tensor, num: int = 2):
    """``split`` elementwise over tensors of keys: (k0, k1), each of shape
    (num, *k0.shape), row i the i-th subkey of every key."""
    parts = [threefry2x32(k0, k1, 0, i) for i in range(num)]
    return (torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))


def uniform_at(k0: torch.Tensor, k1: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """Element ``counter`` of ``uniform(key, shape)`` for each key (k0, k1),
    broadcast elementwise: the draw depends on the position only, not on
    the shape drawn. Counters lie below 2**32."""
    b0, b1 = threefry2x32(k0, k1, 0, counter)
    return _bits_to_unit_float(b0 ^ b1)


def _is_single(key: KeyLike) -> bool:
    return isinstance(key[0], int)


def _key_columns(keys: Sequence[Key], device) -> Tuple[torch.Tensor, torch.Tensor]:
    k = torch.tensor(keys, dtype=torch.int64).reshape(-1, 2)
    if torch.device(device).type == "cuda":
        # Through pinned memory, without blocking: a pageable copy would wait
        # for all the work queued on the card (the training loop draws keys
        # for every chunk while the previous chunk runs).
        k = k.pin_memory().to(device, non_blocking=True)
    return k[:, :1], k[:, 1:]


def random_bits(key: KeyLike, shape, device) -> torch.Tensor:
    """32 random bits per element, as int64 in [0, 2**32).

    Element i (row-major flat index) gets threefry(key, (i >> 32, i))
    with the two output words xored — the partitionable layout."""
    shape = tuple(int(s) for s in shape)
    numel = math.prod(shape)
    single = _is_single(key)
    keys = [key] if single else list(key)
    k0, k1 = _key_columns(keys, device)
    out = torch.empty((len(keys), numel), dtype=torch.int64, device=device)
    for start in range(0, numel, _CHUNK):
        stop = min(start + _CHUNK, numel)
        ctr = torch.arange(start, stop, dtype=torch.int64, device=device)[None]
        b0, b1 = threefry2x32(k0, k1, ctr >> 32, ctr & M32)
        out[:, start:stop] = b0 ^ b1
    return out.reshape(shape) if single else out.reshape(len(keys), *shape)


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    # Random mantissa under exponent 0: a float in [1, 2), minus 1.
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: KeyLike, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1)."""
    return _bits_to_unit_float(random_bits(key, shape, device))


def _check_int32(minval: int, maxval: int) -> None:
    if not -(2**31) <= minval < 2**31 or not -(2**31) <= maxval < 2**31:
        raise ValueError("randint bounds must lie in the int32 range")


def _randint_from_words(hi: torch.Tensor, lo: torch.Tensor, minval: int,
                        maxval: int) -> torch.Tensor:
    span = (maxval - minval) & M32 if maxval > minval else 1
    # The square wraps in uint32 as in JAX (it is 0 for spans above 2**16).
    mult = (((2**16 % span) ** 2) & M32) % span
    # (hi % span) * mult < 2**62: exact in int64 before the 32-bit wrap.
    off = ((((hi % span) * mult) & M32) + (lo % span)) & M32
    return (minval + off % span).to(torch.int32)


def randint(key: KeyLike, shape, minval: int, maxval: int, device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``.

    Two words per element, reduced modulo the span with the same
    wrap-around uint32 arithmetic as ``jax._src.random._randint``."""
    minval, maxval = int(minval), int(maxval)
    _check_int32(minval, maxval)
    pairs = [split(key)] if _is_single(key) else [split(k) for k in key]
    hi = random_bits([p[0] for p in pairs], shape, device)
    lo = random_bits([p[1] for p in pairs], shape, device)
    if _is_single(key):
        hi, lo = hi[0], lo[0]
    return _randint_from_words(hi, lo, minval, maxval)


def randint_and_uniform(int_keys: Sequence[Key], float_keys: Sequence[Key], shape,
                        minval: int, maxval: int,
                        device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``randint(int_keys, ...)`` and ``uniform(float_keys, ...)`` in one
    pass of the generator over all their keys: the same numbers as the two
    calls, with a third of the device ops."""
    minval, maxval = int(minval), int(maxval)
    _check_int32(minval, maxval)
    pairs = [split(k) for k in int_keys]
    m = len(pairs)
    words = random_bits([p[0] for p in pairs] + [p[1] for p in pairs] + list(float_keys),
                        shape, device)
    return (_randint_from_words(words[:m], words[m:2 * m], minval, maxval),
            _bits_to_unit_float(words[2 * m:]))


def permutation(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as int64: repeated stable sorts
    under fresh 32-bit keys, round for round as ``jax.random._shuffle``
    (every round's keys drawn in one pass)."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(M32)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    subs = []
    for _ in range(rounds):
        key, sub = split(key)
        subs.append(sub)
    if subs:
        bits = random_bits(subs, (n,), device)
        for r in range(rounds):
            x = x[torch.sort(bits[r], stable=True).indices]
    return x

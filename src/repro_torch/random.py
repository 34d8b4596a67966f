"""JAX's threefry2x32 PRNG in PyTorch, bit for bit.

Every bit-exact claim of the port rests on this module: participation masks
are ``uniform(fold_in(base_key, t), (K,))``, minibatch indices
``uniform(fold_in(data_key, t), (K, L, B))`` and the data key
``fold_in(PRNGKey(seed), 0x0DA7A)`` — the same draws as the JAX package.

It follows JAX with ``jax_threefry_partitionable=True`` (the default since
JAX 0.5): ``split`` is fold-like (``split(key, n)[i] == fold_in(key, i)``),
and ``random_bits`` hashes a 64-bit iota counter held as two 32-bit words,
returning ``bits1 ^ bits2`` for 32-bit output.

A key is an int64 tensor of shape ``[2]`` holding two uint32 words (JAX's raw
``uint32[2]`` key); a batch of keys is ``[..., 2]``, and every sampler then
draws for each key what ``jax.vmap`` of the JAX call over the keys draws
(the per-client minibatch stream hashes a whole vector of client ids at
once this way).  Every uint32 operation is emulated in int64 with a
``& 0xFFFFFFFF`` mask after each add and rotate, on the key's own device, so
no uint32 kernel support is needed.  Samplers compute on ``device`` when it
is given, else on the key's device.

The partitioners' draws (:func:`permutation`, :func:`gumbel`,
:func:`loggamma`, :func:`dirichlet`) follow JAX 0.9.0's algorithms.
``permutation`` is integer and bit-exact.  The float draws take every
``log``, ``log1p``, ``exp`` and ``sqrt`` in float64 and round once
(:func:`_f64`): XLA's float32 transcendentals are not correctly rounded,
and neither are torch's, so no float32 choice matches XLA everywhere, but
this one gives the card and the CPU the same bits.  They agree with JAX to
a few ulp.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: bit pattern of 1.0f — uniform() ORs 23 random mantissa bits into it
_ONE_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x1, x2)``
    under the key words ``(k1, k2)``; all operands hold uint32 values in
    int64 and broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit ints: ``[0, seed mod 2³²]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _hash_range(key: torch.Tensor, start: int, stop: int):
    """Both threefry output words for the flat counters ``[start, stop)``
    of an iota (the low word; the high word is 0 below 2³²), ``[...,
    stop - start]`` for keys ``[..., 2]``."""
    if stop > 2 ** 32:
        raise NotImplementedError("counters beyond 2**32 elements")
    lo = torch.arange(start, stop, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(lo), lo)


def _hash_counts(key: torch.Tensor, shape: tuple[int, ...], device=None):
    """``threefry2x32(key, iota_2x32(shape))``: both output words, shaped
    ``[..., *shape]`` for keys ``[..., 2]``."""
    key = key.to(device) if device is not None else key
    b1, b2 = _hash_range(key, 0, math.prod(shape))
    out = key.shape[:-1] + tuple(shape)
    return b1.reshape(out), b2.reshape(out)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter ``(0, data mod 2³²)``.

    Keys ``[..., 2]`` and ``data`` (a number or a tensor) broadcast
    together: the result is ``[..., 2]``, each key ``jax.random.fold_in``
    of its key and datum, as ``jax.vmap`` of it gives.  A number enters
    the hash as a scalar operand, so no tensor is made of it (on a card, no
    host-to-device copy and no wait for the stream)."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & MASK
        zero = torch.zeros_like(d)
    else:
        d, zero = int(data) & MASK, 0
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], zero, d)
    return torch.stack([b1, b2], dim=-1)


def fold_in_range(key: torch.Tensor, ts: range) -> torch.Tensor:
    """``fold_in(key, t)`` for every ``t`` of the range ``ts`` at once,
    ``[..., len(ts), 2]`` for keys ``[..., 2]``: the counters are a
    ``torch.arange`` made on the key's device, so a run's round keys are
    one table, made once, that each round indexes."""
    ids = torch.arange(ts.start, ts.stop, ts.step, dtype=torch.int64,
                       device=key.device)
    return fold_in(key[..., None, :], ids)


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split``: keys of shape ``(..., *num, 2)``."""
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    b1, b2 = _hash_counts(key, shape)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0, 2³²),
    ``[..., *shape]`` for keys ``[..., 2]``."""
    b1, b2 = _hash_counts(key, tuple(shape), device)
    return b1 ^ b2


def _as_f32(bits: torch.Tensor) -> torch.Tensor:
    """Reinterpret uint32 bit patterns below 2³¹ as float32."""
    return bits.to(torch.int32).view(torch.float32)


def _bits_to_uniform(bits: torch.Tensor, minval: float,
                     maxval: float) -> torch.Tensor:
    """``max(lo, f · (hi − lo) + lo)`` for the floats ``f`` in [0, 1) of
    the bits, with ``lo``, ``hi`` and ``hi − lo`` rounded to float32 as
    JAX's float32 operands: Python scalars of those exact values, so no
    tensor is made of the bounds."""
    floats = _as_f32((bits >> 9) | _ONE_BITS) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp(floats * float(hi - lo) + float(lo), min=float(lo))


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, then scaled into ``[minval, maxval)``;
    ``[..., *shape]`` for keys ``[..., 2]``."""
    return _bits_to_uniform(random_bits(key, shape, device), minval, maxval)


# M. Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# the single-precision polynomials XLA evaluates for float32 erf_inv, in
# w = -log1p(-x²) - 2.5 (w < 5) and sqrt(-log1p(-x²)) - 3 (w ≥ 5).
_ERFINV_CENTRAL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_TAIL = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, the way XLA computes it (Giles'
    polynomials, Horner's rule, ±inf at ±1).  ``torch.erfinv`` uses other
    approximations: tens of ulps apart from XLA's near |x| → 1."""
    w = -torch.log1p(-x * x)
    central = w < 5.0
    w = torch.where(central, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0])
    for c_in, c_out in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.where(central, c_in, c_out) + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


#: counters hashed at a time by :func:`normal`: its int64 temporaries stay
#: near 128 MB each however large the draw (a 128,256 × 2048 embedding
#: would otherwise need ~2 GB per temporary)
NORMAL_CHUNK = 1 << 24


def normal(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``√2 · erfinv(u)`` with ``u``
    uniform on ``[nextafter(−1, 0), 1)``.  The uniforms are bit-exact; the
    erfinv follows XLA's algorithm, whose transcendental steps may round an
    ulp apart, so the normals agree to a few ulps.  Element ``i`` depends
    only on counter ``i``, so the draw is made ``NORMAL_CHUNK`` counters at
    a time into one float32 output."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    sqrt2 = float(np.float32(np.sqrt(2.0)))
    key = key.to(device) if device is not None else key
    shape = tuple(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float32, device=key.device)
    for start in range(0, n, NORMAL_CHUNK):
        stop = min(n, start + NORMAL_CHUNK)
        b1, b2 = _hash_range(key, start, stop)
        u = _bits_to_uniform(b1 ^ b2, lo, 1.0)
        out[start:stop] = erfinv(u) * sqrt2
    return out.reshape(shape)


def exponential(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.exponential`` in float32: ``−log1p(−u)``."""
    return -torch.log1p(-uniform(key, shape, device=device))


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` with int32 output and scalar int32 bounds.

    JAX draws two 32-bit words per value (from the two halves of
    ``split(key)``) and folds them modulo the span with uint32 wrap-around;
    the products are split into 16-bit halves here so int64 never overflows.
    The wrap is part of the stream: for a span of 2³¹−1 the multiplier
    ``(2¹⁶)² mod 2³²`` is 0.
    """
    lo_i, hi_i = int(minval), int(maxval)
    if not (-2**31 <= lo_i < 2**31 and -2**31 <= hi_i < 2**31):
        raise ValueError("randint bounds must lie in the int32 range")
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = (hi_i - lo_i) & MASK if hi_i > lo_i else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span   # uint32 square wraps
    a = higher % span
    prod = ((((a * (mult >> 16)) & 0xFFFF) << 16) + a * (mult & 0xFFFF)) \
        & MASK
    offset = ((prod + lower % span) & MASK) % span
    out = (lo_i + offset + 2 ** 31) & MASK   # int32 wrap-around
    return (out - 2 ** 31).to(torch.int32)


# ---------------------------------------------------------------------------
# the partitioners' draws: permutation, gumbel, loggamma, dirichlet
# ---------------------------------------------------------------------------

#: float32's smallest normal number (``finfo(float32).tiny``)
_TINY = float(np.finfo(np.float32).tiny)


def _f64(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of float32 ``x`` taken in float64 and rounded once to
    float32: the correctly rounded value (to float64's own error), the same
    on the card and on the CPU."""
    return fn(x.to(torch.float64)).to(torch.float32)


def permutation(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: int32 ``[..., n]`` for keys
    ``[..., 2]``, bit-exact.

    JAX's ``_shuffle``: ``ceil(3·ln n / ln(2³²−1))`` rounds (one up to
    n = 1,625, two from 1,626 to well past 10⁶), each ``key, sub =
    split(key)``, 32-bit ``random_bits(sub, (n,))`` and a *stable*
    key-value sort.  32-bit keys collide (at n = 60,000 a tie is likely),
    so the stability is part of the stream."""
    key = key.to(device) if device is not None else key
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    x = x.expand(key.shape[:-1] + (n,))
    for _ in range(rounds):
        key, sub = split(key).unbind(-2)
        bits = random_bits(sub, (n,))
        order = torch.sort(bits, dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()


def gumbel(key: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode ``"low"`` (the default):
    ``−log(−log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    u = uniform(key, shape, minval=_TINY, maxval=1.0, device=device)
    return -_f64(torch.log, -_f64(torch.log, u))


def _normal_f64(key: torch.Tensor) -> torch.Tensor:
    """One float32 standard normal per key ``[..., 2]`` (``normal(key,
    ())``), with erfinv's ``log1p`` and ``sqrt`` in float64 rounded once."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = _bits_to_uniform(random_bits(key, ()), lo, 1.0)
    w = -_f64(torch.log1p, -u * u)
    central = w < 5.0
    w = torch.where(central, w - 2.5, _f64(torch.sqrt, w) - 3.0)
    p = torch.where(central, _ERFINV_CENTRAL[0], _ERFINV_TAIL[0])
    for c_in, c_out in zip(_ERFINV_CENTRAL[1:], _ERFINV_TAIL[1:]):
        p = torch.where(central, c_in, c_out) + p * w
    x = torch.where(u.abs() == 1.0, u * torch.inf, p * u)
    return x * float(np.float32(np.sqrt(2.0)))


def _f32(v: float) -> float:
    return float(np.float32(v))


def _gamma_lanes(keys: torch.Tensor, alpha: torch.Tensor, log_space: bool):
    """JAX's ``_gamma_one(key, alpha, log_space)`` (Marsaglia–Tsang) for
    every lane at once: ``keys [N, 2]``, float32 ``alpha [N]``.

    Each lane follows its own key chain through the rejection loop and the
    inner ``v > 0`` loop; a mask keeps the lanes still running, and a loop
    ends when none is (``vmap`` of JAX's ``while_loop``).  Below α = 1 the
    boost is ``log1p(−u) · (1/α)`` in log space (kept at 0 where
    ``log1p(−u)`` is 0), else ``(1 − u)^(1/α)``."""
    third = _f32(1.0 / 3.0)
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - third
    c = third / _f64(torch.sqrt, d)
    key, subkey = split(keys).unbind(-2)
    n = alpha.shape[0]
    X = torch.zeros(n, dtype=torch.float32, device=alpha.device)
    V = torch.ones_like(X)
    U = torch.full_like(X, 2.0)
    run = torch.ones(n, dtype=torch.bool, device=alpha.device)
    while bool(run.any()):
        lanes = run.nonzero().squeeze(-1)
        key_l, x_key, u_key = split(key[lanes], 3).unbind(-2)
        c_l = c[lanes]
        x = torch.zeros(lanes.shape[0], dtype=torch.float32,
                        device=alpha.device)
        v = torch.full_like(x, -1.0)
        inner = torch.ones_like(x, dtype=torch.bool)
        while bool(inner.any()):
            il = inner.nonzero().squeeze(-1)
            x_key_i, sub = split(x_key[il]).unbind(-2)
            x_i = _normal_f64(sub)
            x_key[il] = x_key_i
            x[il] = x_i
            v[il] = 1.0 + x_i * c_l[il]
            inner = v <= 0.0
        key[lanes] = key_l
        X[lanes] = x * x
        V[lanes] = (v * v) * v
        U[lanes] = uniform(u_key, ())
        # reject (run again) while both of Marsaglia–Tsang's tests fail
        run = (U >= 1.0 - _f32(0.0331) * (X * X)) & (
            _f64(torch.log, U) >= X * 0.5 + d * ((1.0 - V)
                                                 + _f64(torch.log, V)))
    if log_space:
        log_samples = _f64(torch.log1p, -uniform(subkey, ()))
        log_boost = torch.where(boost | (log_samples == 0.0), 0.0,
                                log_samples * (1.0 / alpha))
        return (_f64(torch.log, d) + _f64(torch.log, V)) + log_boost
    samples = 1.0 - uniform(subkey, ())
    inv = (1.0 / alpha).to(torch.float64)
    power = torch.pow(samples.to(torch.float64), inv).to(torch.float32)
    return (d * V) * torch.where(boost, 1.0, power)


def _gamma(key, a, shape, device, log_space: bool) -> torch.Tensor:
    """JAX's ``_gamma_impl``: the key split into one key per element
    (row-major), each element its own chain."""
    key = key.to(device) if device is not None else key
    a = torch.as_tensor(a, dtype=torch.float32, device=key.device)
    shape = tuple(a.shape) if shape is None else tuple(shape)
    alpha = a.expand(shape).reshape(-1).contiguous()
    keys = split(key, alpha.shape[0])
    return _gamma_lanes(keys, alpha, log_space).reshape(shape)


def gamma(key: torch.Tensor, a, shape=None, device=None) -> torch.Tensor:
    """``jax.random.gamma``: float32 Gamma(a) samples of ``shape``
    (``a``'s shape when None) for one key ``[2]``."""
    return _gamma(key, a, shape, device, log_space=False)


def loggamma(key: torch.Tensor, a, shape=None, device=None) -> torch.Tensor:
    """``jax.random.loggamma``: the same chains as :func:`gamma`, returned
    as logs, with the small-α boost taken in log space."""
    return _gamma(key, a, shape, device, log_space=True)


def dirichlet(key: torch.Tensor, alpha, shape=(), device=None) -> torch.Tensor:
    """``jax.random.dirichlet(key, alpha, shape)``: float32 ``shape +
    (C,)``, the softmax of ``loggamma(key, alpha, shape + (C,))``.  The
    softmax adds its C terms one after another, XLA's order on the CPU for
    short rows."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    lg = loggamma(key, alpha.to(key.device if device is None else device),
                  tuple(shape) + tuple(alpha.shape[-1:]), device)
    z = _f64(torch.exp, lg - lg.max(dim=-1, keepdim=True).values)
    total = z[..., :1]
    for j in range(1, z.shape[-1]):
        total = total + z[..., j:j + 1]
    return z / total

"""Double-precision FFT via real-pair arithmetic.

This module implements the radix-2 FFT over (real, imag) f64 array pairs,
in plain float64 arithmetic and independent of ``jnp.fft``:

- bit-reversal permutation indices and per-stage twiddle factors are static
  (precomputed with numpy at trace time — the transform size is static);
- each butterfly stage is a fully vectorized slice/concat over the last
  axis, batched over arbitrary leading axes;
- ``rfft_pair`` / ``irfft_pair`` mirror numpy's rfft/irfft semantics.

FFTLog uses it only when ``engine='pair'`` is chosen explicitly; the
default ``'auto'`` engine is ``jnp.fft`` in complex128.
"""

import functools

import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=32)
def _fft_tables(n):
    """(bit-reversal indices, [(cos, sin) twiddles per stage]) for size n."""
    assert n & (n - 1) == 0, 'FFT size must be a power of two'
    m = n.bit_length() - 1
    # bit-reversal permutation
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for _ in range(m):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    stages = []
    for s in range(1, m + 1):
        size = 1 << s
        half = size >> 1
        ang = -2.0 * np.pi * np.arange(half) / size
        stages.append((np.cos(ang), np.sin(ang)))
    return rev, stages


def fft_pair(re, im, inverse=False):
    """Complex FFT of (re, im) along the last axis (power-of-two length),
    returning an (re, im) pair. ``inverse=True`` gives the unnormalized
    inverse transform (divide by n externally)."""
    n = re.shape[-1]
    rev, stages = _fft_tables(n)
    rev = jnp.asarray(rev)
    re = jnp.take(re, rev, axis=-1)
    im = jnp.take(im, rev, axis=-1)
    for (c, s) in stages:
        c = jnp.asarray(c)
        s = jnp.asarray(-s if inverse else s)
        half = c.shape[0]
        size = 2 * half
        shape = re.shape[:-1] + (n // size, size)
        re_v = re.reshape(shape)
        im_v = im.reshape(shape)
        er, ei = re_v[..., :half], im_v[..., :half]
        orr, oi = re_v[..., half:], im_v[..., half:]
        tr = c * orr - s * oi
        ti = c * oi + s * orr
        re = jnp.concatenate([er + tr, er - tr], axis=-1).reshape(re.shape)
        im = jnp.concatenate([ei + ti, ei - ti], axis=-1).reshape(im.shape)
    return re, im


def rfft_pair(x):
    """Real-input FFT along the last axis -> (re, im) of length n//2 + 1.

    Uses the packed half-size complex transform: O(n/2 log n) butterflies.
    """
    n = x.shape[-1]
    half = n // 2
    # pack even samples as real, odd as imaginary of a half-size signal
    zr = x[..., 0::2]
    zi = x[..., 1::2]
    Zr, Zi = fft_pair(zr, zi)
    # unpack: X_k = (Z_k + conj(Z_{n/2-k}))/2 - i e^{-2pi i k/n} (Z_k - conj(Z_{n/2-k}))/2
    k = np.arange(half + 1)
    c = jnp.asarray(np.cos(-2.0 * np.pi * k / n))
    s = jnp.asarray(np.sin(-2.0 * np.pi * k / n))
    idx = np.arange(half + 1) % half
    ridx = (-np.arange(half + 1)) % half
    Zkr, Zki = jnp.take(Zr, jnp.asarray(idx), axis=-1), jnp.take(Zi, jnp.asarray(idx), axis=-1)
    Zmr, Zmi = jnp.take(Zr, jnp.asarray(ridx), axis=-1), jnp.take(Zi, jnp.asarray(ridx), axis=-1)
    Ar = 0.5 * (Zkr + Zmr)
    Ai = 0.5 * (Zki - Zmi)
    Br = 0.5 * (Zki + Zmi)
    Bi = -0.5 * (Zkr - Zmr)
    # X_k = A_k + e^{-2pi i k / n} B_k
    Xr = Ar + c * Br - s * Bi
    Xi = Ai + c * Bi + s * Br
    return Xr, Xi


def irfft_pair(re, im, n=None):
    """Inverse of :func:`rfft_pair`: (re, im) of length n//2+1 -> real
    signal of length n."""
    if n is None:
        n = 2 * (re.shape[-1] - 1)
    # rebuild the full hermitian spectrum
    tail = slice(n // 2 - 1, 0, -1)
    full_re = jnp.concatenate([re, re[..., tail]], axis=-1)
    full_im = jnp.concatenate([im, -im[..., tail]], axis=-1)
    out_re, _ = fft_pair(full_re, full_im, inverse=True)
    return out_re / n

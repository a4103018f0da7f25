"""FFTLog differential tests: analytic Gaussian self-transforms, sigma_r vs
scipy-quad truth (reference parity: rtol 1e-5, test_fftlog.py:134-147),
pk->xi->pk round trip, batching, and jit/vmap/grad contracts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import integrate

from cosmoprimo_tpu.fftlog import (CorrelationToPower, FFTlog, GaussianVariance, HankelTransform,
                                   PowerToCorrelation, TophatVariance, pad)


def pk_eh_like(k):
    """Smooth power-law-ish test spectrum."""
    return 1e4 * (k / 0.1) ** 0.96 / (1 + ((k / 0.1) ** 1.5) ** 2)


def test_hankel_gaussian_self_transform():
    # int x dx exp(-x^2/2) J0(xy) = exp(-y^2/2)
    x = np.geomspace(1e-3, 1e2, 512)
    f = np.exp(-x ** 2 / 2)
    y, g = HankelTransform(x, nu=0, q=1)(f)
    y, g = np.asarray(y), np.asarray(g)
    mask = (y > 1e-2) & (y < 3.0)
    np.testing.assert_allclose(g[mask], np.exp(-y[mask] ** 2 / 2), rtol=1e-4, atol=1e-6)


def test_power_to_correlation_gaussian():
    # xi(s) = sqrt(pi/2)/(2 pi^2) exp(-s^2/2) for P(k) = exp(-k^2/2)
    k = np.geomspace(1e-4, 1e2, 1024)
    pk = np.exp(-k ** 2 / 2)
    s, xi = PowerToCorrelation(k)(pk)
    s, xi = np.asarray(s), np.asarray(xi)
    expected = np.sqrt(np.pi / 2) / (2 * np.pi ** 2) * np.exp(-s ** 2 / 2)
    mask = (s > 1e-2) & (s < 3.0)
    np.testing.assert_allclose(xi[mask], expected[mask], rtol=1e-4, atol=1e-7)


def test_sigma_r_vs_quad():
    k = np.geomspace(1e-5, 1e2, 1000)
    pk = pk_eh_like(k)
    s, var = TophatVariance(k)(pk)
    s, var = np.asarray(s), np.asarray(var)

    def windowed(kk, r):
        x = kk * r
        w = 3 * (np.sin(x) - x * np.cos(x)) / x ** 3
        return kk ** 2 * pk_eh_like(kk) * w ** 2 / (2 * np.pi ** 2)

    for r in [1.0, 5.0, 8.0, 20.0]:
        i = np.argmin(np.abs(s - r))
        ref = integrate.quad(windowed, 1e-5, 1e2, args=(s[i],), limit=400)[0]
        assert abs(var[i] / ref - 1) < 1e-5, (s[i], var[i], ref)


def test_gaussian_variance():
    k = np.geomspace(1e-5, 1e2, 1000)
    pk = pk_eh_like(k)
    s, var = GaussianVariance(k)(pk)
    s, var = np.asarray(s), np.asarray(var)

    def windowed(kk, r):
        return kk ** 2 * pk_eh_like(kk) * np.exp(-(kk * r) ** 2) / (2 * np.pi ** 2)

    i = np.argmin(np.abs(s - 5.0))
    ref = integrate.quad(windowed, 1e-5, 1e2, args=(s[i],), limit=400)[0]
    assert abs(var[i] / ref - 1) < 1e-5


def test_pk_xi_roundtrip():
    k = np.geomspace(1e-5, 1e2, 1024)
    pk = pk_eh_like(k)
    s, xi = PowerToCorrelation(k)(pk)
    k2, pk2 = CorrelationToPower(np.asarray(s))(xi)
    k2, pk2 = np.asarray(k2), np.asarray(pk2)
    np.testing.assert_allclose(k2, k, rtol=1e-10)  # low-ringing grids invert
    mask = (k > 1e-3) & (k < 10.0)
    np.testing.assert_allclose(pk2[mask], pk[mask], rtol=1e-2)


def test_multipole_batching():
    k = np.geomspace(1e-4, 1e1, 512)
    pk = pk_eh_like(k)
    ells = [0, 2, 4]
    p2c = PowerToCorrelation(k, ell=ells)
    s, xi = p2c(np.tile(pk, (3, 1)))
    assert np.asarray(s).shape == (3, 512) and np.asarray(xi).shape == (3, 512)
    # monopole of batch equals single transform
    s0, xi0 = PowerToCorrelation(k, ell=0)(pk)
    np.testing.assert_allclose(np.asarray(xi)[0], np.asarray(xi0), rtol=1e-12)
    # extra leading batch axes
    batch = np.tile(pk, (5, 3, 1))
    sb, xib = p2c(batch)
    assert np.asarray(xib).shape == (5, 3, 512)
    np.testing.assert_allclose(np.asarray(xib)[2], np.asarray(xi), rtol=1e-12)


def test_jax_contracts():
    k = jnp.geomspace(1e-4, 1e2, 256)

    def xi_at(amplitude):
        pk = amplitude * jnp.exp(-k ** 2 / 2)
        p2c = PowerToCorrelation(k)
        s, xi = p2c(pk)
        return xi[100]

    v = float(jax.jit(xi_at)(1.0))
    g = float(jax.grad(xi_at)(1.0))
    assert np.isfinite(v) and abs(g - v) < 1e-12  # linear in amplitude
    batch = jax.vmap(xi_at)(jnp.ones(4))
    np.testing.assert_allclose(np.asarray(batch), v, rtol=1e-12)


def test_pad():
    x = np.array([[1.0, 2.0, 4.0, 8.0]])
    padded = np.asarray(pad(jnp.array(x), (2, 2), extrap='log'))
    np.testing.assert_allclose(padded[0], [0.25, 0.5, 1, 2, 4, 8, 16, 32], rtol=1e-12)
    padded = np.asarray(pad(jnp.array(x), (1, 1), extrap='edge'))
    np.testing.assert_allclose(padded[0], [1, 1, 2, 4, 8, 8], rtol=1e-12)
    padded = np.asarray(pad(jnp.array(x), (1, 2), extrap=0))
    np.testing.assert_allclose(padded[0], [0, 1, 2, 4, 8, 0, 0], rtol=1e-12)


@pytest.mark.parametrize('transform, batch', [
    (PowerToCorrelation, (6,)),
    (PowerToCorrelation, (4, 3)),
    (TophatVariance, (6,)),
    (TophatVariance, (4, 3)),
])
def test_auto_engine_matches_pair(transform, batch):
    """'auto' (jnp.fft in complex128) and 'pair' (the real-pair FFT of
    ops/fft.py, independent of jnp.fft) agree to float64 round-off on
    (B,) and (B, nz) batches of spectra."""
    k = np.geomspace(1e-5, 1e2, 1024)
    amp = np.linspace(0.8, 1.2, int(np.prod(batch))).reshape(batch + (1,))
    pk = amp * pk_eh_like(k)
    y_auto, out_auto = transform(k, engine='auto')(pk)
    y_pair, out_pair = transform(k, engine='pair')(pk)
    out_auto, out_pair = np.asarray(out_auto), np.asarray(out_pair)
    assert out_auto.shape == batch + (k.size,)
    np.testing.assert_array_equal(np.asarray(y_auto), np.asarray(y_pair))
    scale = np.abs(out_auto).max(axis=-1, keepdims=True)
    assert (np.abs(out_auto - out_pair) / scale).max() <= 1e-12

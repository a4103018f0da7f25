"""Native halofit (Takahashi 2012, arXiv:1208.2701) non-linear matter
power spectrum, with the Bird et al. 2012 massive-neutrino corrections as
implemented by CAMB/CLASS.

The reference library has no halofit of its own — its ``non_linear``
calculation parameter is forwarded to CLASS/CAMB Fortran/C internals
(reference classy.py:15-71 'hmcode/halofit keys', camb.py:124-147). This
module supplies that capability natively so *any* engine exposing a linear
P(k, z) serves non-linear spectra on device, batched and differentiable.

Design:
- sigma^2(R, z) = \\int dlnk  Delta^2_L(k, z) e^{-k^2 R^2} is evaluated for
  the whole (R, z) grid as a single (nR, nk) @ (nk, nz) matmul, with
  static trapezoid weights folded into the Gaussian window matrix;
- the non-linear scale sigma(R_sigma) = 1 is found per z by a fixed-depth
  (unrolled) Newton iteration on the natural cubic spline of
  ln sigma^2(ln R) — no data-dependent control flow, so the whole transform
  jits, vmaps over cosmology batches and differentiates (jacfwd) cleanly;
- n_eff and the curvature C are the analytic first/second derivatives of
  that same spline at the root (no finite differencing).
"""

import numpy as np

import jax.numpy as jnp

from ..interpolator import PowerSpectrumInterpolator2D
from ..ops.quadrature import trapezoid_weights
from ..ops.spline import natural_cubic_coeffs


def sigma_gauss2(k, pk_kz, R):
    """Gaussian-filtered variance sigma^2(R, z) = int dlnk Delta^2_L e^{-k^2R^2}.

    ``k``: (nk,), ``pk_kz``: (nk, nz) linear P(k, z), ``R``: (nR,).
    Returns (nR, nz). One matmul, differentiable.
    """
    k = jnp.asarray(k)
    pk_kz = jnp.asarray(pk_kz)
    w = trapezoid_weights(jnp.log(k))
    delta2 = k[:, None] ** 3 * pk_kz / (2 * np.pi ** 2)  # (nk, nz)
    window = jnp.exp(-(k[None, :] * R[:, None]) ** 2) * w[None, :]  # (nR, nk)
    return window @ delta2


def _nonlinear_scale(lnR, lnsig2, niter=12):
    """Root, slope and curvature of y(x) = ln sigma^2(ln R) at y = 0.

    ``lnR``: (nR,) increasing; ``lnsig2``: (nR, nz), decreasing in R.
    Returns (lnR_sigma, neff, C) each (nz,), with
    n_eff = -3 - y'(x*) and C = -y''(x*) (Smith et al. 2003 definitions).
    Fixed-depth Newton on the cubic spline: trace-safe, differentiable.
    """
    y = jnp.asarray(lnsig2)
    M = natural_cubic_coeffs(lnR, y)
    # bracket: last index where y > 0 (y decreasing); clip keeps edge cases
    # (fully linear / fully collapsed) inside the grid — masked by the caller
    i = jnp.clip(jnp.sum(y > 0, axis=0) - 1, 0, lnR.shape[0] - 2)
    lo, hi = lnR[i], lnR[i + 1]
    # the Newton iterate stays clipped inside this one bracketed segment, so
    # gather its cubic piece once and iterate on closed-form polynomial
    # arithmetic (compiles orders of magnitude faster than re-evaluating the
    # whole spline per iteration)
    take = lambda a, j: jnp.take_along_axis(a, j[None, :], axis=0)[0]
    y_lo, y_hi = take(y, i), take(y, i + 1)
    M_lo, M_hi = take(M, i), take(M, i + 1)
    h = hi - lo

    def piece(x, nu):
        dl, dr = x - lo, hi - x
        if nu == 0:
            return (M_lo * dr ** 3 / (6 * h) + M_hi * dl ** 3 / (6 * h)
                    + (y_lo / h - M_lo * h / 6) * dr + (y_hi / h - M_hi * h / 6) * dl)
        if nu == 1:
            return (-M_lo * dr ** 2 / (2 * h) + M_hi * dl ** 2 / (2 * h)
                    - (y_lo / h - M_lo * h / 6) + (y_hi / h - M_hi * h / 6))
        return (M_lo * dr + M_hi * dl) / h

    # secant initial guess inside the bracket
    x = lo + h * y_lo / jnp.where(y_lo == y_hi, 1.0, y_lo - y_hi)
    for _ in range(niter):
        df = piece(x, 1)
        step = piece(x, 0) / jnp.where(df == 0, 1.0, df)
        x = jnp.clip(x - step, lo, hi)
    neff = -3.0 - piece(x, 1)
    C = -piece(x, 2)
    return x, neff, C


def halofit(k, pk_kz, Omega_mz, Omega_dez, wz, fnu=0.0, Omega_m0=None,
            nR=128, Rrange=(1e-3, 1e3)):
    """Non-linear P(k, z) from linear P(k, z) (Takahashi 2012 eqs. 1-26 +
    Bird 2012 nu-corrections, per the CAMB halofit_takahashi variant).

    ``k``: (nk,) in h/Mpc; ``pk_kz``: (nk, nz) linear power in (Mpc/h)^3;
    ``Omega_mz``/``Omega_dez``/``wz``: (nz,) background quantities at the
    table redshifts; ``fnu``: Omega_ncdm/Omega_m today; ``Omega_m0``:
    Omega_m today (defaults to Omega_mz where z==min, only used by the
    nu-correction). Returns (nk, nz).
    """
    k = jnp.asarray(k)
    pk_kz = jnp.asarray(pk_kz)
    Omega_mz = jnp.atleast_1d(jnp.asarray(Omega_mz))
    Omega_dez = jnp.atleast_1d(jnp.asarray(Omega_dez))
    wz = jnp.broadcast_to(jnp.asarray(wz), Omega_mz.shape)
    if Omega_m0 is None:
        Omega_m0 = Omega_mz[0]

    R = jnp.asarray(np.geomspace(*Rrange, num=nR))
    sig2 = sigma_gauss2(k, pk_kz, R)  # (nR, nz)
    lnsig2 = jnp.log(jnp.maximum(sig2, 1e-300))
    lnR_sigma, neff, C = _nonlinear_scale(jnp.log(R), lnsig2)
    ksigma = jnp.exp(-lnR_sigma)  # 1/R_sigma, (nz,)
    # no non-linear scale on the grid (sigma^2 < 1 even at R_min): serve the
    # linear spectrum for that z (CAMB's 'no collapse' branch)
    collapsed = lnsig2[0] > 0.0

    n, n2, n3, n4 = neff, neff ** 2, neff ** 3, neff ** 4
    w1 = 1.0 + wz
    an = 10 ** (1.5222 + 2.8553 * n + 2.3706 * n2 + 0.9903 * n3 + 0.2250 * n4
                - 0.6038 * C + 0.1749 * Omega_dez * w1)
    bn = 10 ** (-0.5642 + 0.5864 * n + 0.5716 * n2 - 1.5474 * C + 0.2279 * Omega_dez * w1)
    cn = 10 ** (0.3698 + 2.0404 * n + 0.8161 * n2 + 0.5869 * C)
    gamma = 0.1971 - 0.0843 * n + 0.8460 * C
    alpha = jnp.abs(6.0835 + 1.3373 * n - 0.1959 * n2 - 5.5274 * C)
    beta = (2.0379 - 0.7354 * n + 0.3157 * n2 + 1.2490 * n3 + 0.3980 * n4 - 0.1682 * C
            + fnu * (1.081 + 0.395 * n2))
    nu_h = 10 ** (5.2105 + 3.6902 * n)
    f1 = Omega_mz ** -0.0307
    f2 = Omega_mz ** -0.0585
    f3 = Omega_mz ** 0.0743

    # Z-MAJOR elementwise block (nz, nk), k on the minor (lane) axis: under
    # the batched (vmapped) pipelines every per-cosmology table gains a
    # leading batch axis; with the k-major (nk, nz) ordering an nz = 1
    # table puts a size-1 axis minor, and k-minor keeps the long k axis
    # contiguous for every elementwise op below.
    # Per-z fitted parameters become columns; output transposes back (the
    # pipeline consumer transposes to (nz, nk) for the FFTLog anyway, so
    # XLA fuses the round trip away).
    pt = pk_kz.T                                             # (nz, nk)
    k3 = k[None, :] ** 3
    delta2_lin = k3 * pt / (2 * np.pi ** 2)                  # (nz, nk)
    y = k[None, :] / ksigma[:, None]
    fy = y / 4.0 + y ** 2 / 8.0

    # two-halo (quasi-linear) term, with the Bird 2012 small-scale linear boost
    delta2_q_lin = delta2_lin * (1.0 + fnu * 47.48 * k[None, :] ** 2 / (1.0 + 1.5 * k[None, :] ** 2))
    delta2_q = delta2_lin * ((1.0 + delta2_q_lin) ** beta[:, None]
                             / (1.0 + alpha[:, None] * delta2_q_lin)) * jnp.exp(-fy)

    # one-halo term
    delta2_hp = (an[:, None] * y ** (3.0 * f1[:, None])
                 / (1.0 + bn[:, None] * y ** f2[:, None]
                    + ((cn * f3)[:, None] * y) ** (3.0 - gamma[:, None])))
    delta2_h = delta2_hp / (1.0 + nu_h[:, None] / y ** 2)
    delta2_h = delta2_h * (1.0 + fnu * (0.977 - 18.015 * (Omega_m0 - 0.3)))

    delta2_nl = delta2_q + delta2_h
    pk_nl_t = delta2_nl * (2 * np.pi ** 2) / k3
    return jnp.where(collapsed[None, :], pk_nl_t.T, pk_kz)


def halofit_pk_interpolator(pk2d, background, w0=-1.0, wa=0.0, fnu=0.0, **kwargs):
    """Non-linear PowerSpectrumInterpolator2D from a linear one.

    ``pk2d``: linear (possibly separable-growth) interpolator; ``background``
    provides Omega_m(z)/Omega_de(z); ``w0``/``wa``: CPL dark-energy equation
    of state at the table redshifts; ``fnu``: neutrino mass fraction.
    """
    k, z = pk2d.k, pk2d.z
    pk_lin = pk2d(k, z, grid=True)
    pk_lin = pk_lin.reshape(k.shape[0], -1)
    zz = jnp.atleast_1d(jnp.asarray(z))
    Omega_mz = background.Omega_m(zz)
    Omega_dez = background.Omega_de(zz)
    wz = w0 + wa * zz / (1.0 + zz)
    pk_nl = halofit(k, pk_lin, Omega_mz, Omega_dez, wz, fnu=fnu,
                    Omega_m0=background.Omega_m(0.0))
    if zz.shape[0] == 1:  # single-z table: serve it flat in z
        from jax.tree_util import Partial
        kwargs.setdefault('growth_factor_sq', Partial(jnp.ones_like))
    return PowerSpectrumInterpolator2D(k, zz, pk_nl, extrap_kmin=pk2d.extrap_kmin,
                                       extrap_kmax=pk2d.extrap_kmax, **kwargs)

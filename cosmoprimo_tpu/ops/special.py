"""Special functions evaluated natively in JAX or numpy (no scipy).

The reference implementation routes complex ``loggamma``/``gamma`` through
``jax.pure_callback`` to scipy (cosmoprimo/fftlog.py:16-27), a host
round-trip per call. Here the Lanczos approximation is evaluated directly —
in ``jnp`` when tracing (so FFTLog Mellin coefficients stay differentiable
on CPU backends), or in ``numpy`` complex128 on the host for static setup
(FFTLog precomputes coefficients host-side for static grids).
"""

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ['loggamma', 'gamma']

# Lanczos coefficients, g = 607/128, n = 15 (Boost / Godfrey). Relative error
# below ~1e-15 over the right half-plane.
_LANCZOS_G = 607.0 / 128.0
_LANCZOS_COEFFS = np.array([
    0.99999999999999709182,
    57.156235665862923517,
    -59.597960355475491248,
    14.136097974741747174,
    -0.49191381609762019978,
    0.33994649984811888699e-4,
    0.46523628927048575665e-4,
    -0.98374475304879564677e-4,
    0.15808870322491248884e-3,
    -0.21026444172410488319e-3,
    0.21743961811521264320e-3,
    -0.16431810653676389022e-3,
    0.84418223983852743293e-4,
    -0.26190838401581408670e-4,
    0.36899182659531622704e-5,
])

_LOG_SQRT_2PI = 0.5 * np.log(2.0 * np.pi)


def _loggamma_right(xp, z):
    """Lanczos log-gamma, valid for Re(z) > 0.5 (z complex)."""
    zm1 = z - 1.0
    series = xp.full(np.shape(z), _LANCZOS_COEFFS[0], dtype=z.dtype)
    for i in range(1, len(_LANCZOS_COEFFS)):
        series = series + _LANCZOS_COEFFS[i] / (zm1 + i)
    t = zm1 + _LANCZOS_G + 0.5
    return _LOG_SQRT_2PI + (zm1 + 0.5) * xp.log(t) - t + xp.log(series)


def _logsinpi(xp, z):
    """log(sin(pi z)) continued so that the loggamma reflection matches
    scipy's principal-branch convention (continuous off the real axis)."""
    # Compute via complex log of sin for moderate |Im(z)| and switch to the
    # asymptotic form for large |Im(z)| to avoid overflow of sin(pi z).
    x = xp.real(z)
    y = xp.imag(z)
    # Reduce x to [0, 1): sin(pi z) = (-1)^n sin(pi (z - n)) with n = floor(x)
    n = xp.floor(x)
    zr = z - n
    small = xp.abs(y) < 20.0
    # direct evaluation (safe for |y| < ~700 in f64, we switch far earlier);
    # for xr in (0, 1) the principal log of sin(pi zr) is continuous.
    direct = xp.log(xp.sin(xp.pi * xp.where(small, zr, 0.5 + 0.0j)))
    # large |Im|: for y > 0, sin(pi zr) ~ (i/2) exp(-i pi zr); conjugate for y < 0
    sgn = xp.where(y >= 0, 1.0, -1.0)
    asym = -1j * xp.pi * zr * sgn - xp.log(2.0 + 0j) + 1j * sgn * (xp.pi / 2)
    logsin_r = xp.where(small, direct, asym)
    # (-1)^n factor, unwound so the continuation is continuous in x off the
    # real axis (matches scipy's loggamma branch; conjugate-symmetric in y).
    branch = -1j * xp.pi * n * sgn
    return logsin_r + branch


def _loggamma_impl(xp, z):
    reflect = xp.real(z) < 0.5
    z_safe_right = xp.where(reflect, 1.0 - z, z)   # Re >= 0.5 always
    lg_right = _loggamma_right(xp, z_safe_right)
    zr = xp.where(reflect, z, 0.25 + 0.0j)  # safe dummy where unused
    lg_reflect = xp.log(xp.pi) - _logsinpi(xp, zr) - lg_right
    return xp.where(reflect, lg_reflect, lg_right)


def _pick_backend(z):
    """numpy for concrete host arrays/scalars, jnp for traced values."""
    if isinstance(z, jax.core.Tracer) or isinstance(z, jnp.ndarray):
        return jnp
    return np


def loggamma(z):
    r"""Principal branch of :math:`\log \Gamma(z)` for complex ``z``;
    matches ``scipy.special.loggamma`` to ~1e-13 away from the poles."""
    xp = _pick_backend(z)
    z = xp.asarray(z)
    if not np.issubdtype(z.dtype, np.complexfloating):
        z = z.astype(np.complex128 if xp is np else jnp.complex128)
    return _loggamma_impl(xp, z)


def gamma(z):
    r""":math:`\Gamma(z)` for complex or real ``z`` via :func:`loggamma`."""
    xp = _pick_backend(z)
    z = xp.asarray(z)
    if np.issubdtype(z.dtype, np.complexfloating):
        return xp.exp(loggamma(z))
    return xp.real(xp.exp(_loggamma_impl(xp, z.astype(np.complex128))))


# ----------------------------------------------------------------------------
# Sine / cosine integrals (NFW Fourier profiles, models/hmcode.py)
# ----------------------------------------------------------------------------

_EULER_GAMMA = 0.5772156649015328606


def _sici_numpy(x):
    """Host (numpy) Si/Ci — series for x <= 4, complex continued fraction of
    E1(ix) beyond — used only to precompute the Chebyshev fits at import."""
    x = np.asarray(x, dtype=np.float64)
    si = np.empty_like(x)
    ci = np.empty_like(x)
    small = x <= 4.0
    xs = x[small]
    term = xs.copy()
    ssum = term.copy()
    cterm = np.ones_like(xs)
    cin = np.zeros_like(xs)
    for k in range(1, 24):
        term = term * (-xs * xs) * (2 * k - 1) / ((2 * k + 1) ** 2 * (2 * k))
        ssum += term
        cterm = cterm * (-xs * xs) / ((2 * k - 1) * (2 * k))
        cin += cterm / (2 * k)
    si[small] = ssum
    with np.errstate(divide='ignore'):
        ci[small] = _EULER_GAMMA + np.log(np.where(xs > 0, xs, 1.0)) + cin
    xl = x[~small]
    z = 1j * xl
    b = z + 1.0
    c = np.full_like(z, 1e30)
    d = 1.0 / b
    f = d.copy()
    for i in range(1, 64):
        a = -1.0 * i * i
        b = b + 2.0
        d = 1.0 / (a * d + b)
        c = b + a / c
        f = f * (c * d)
    e1 = np.exp(-z) * f
    si[~small] = np.pi / 2 + e1.imag
    ci[~small] = -e1.real
    return si, ci


def _chebfit(x, y, deg, lo, hi):
    t = (2.0 * x - (hi + lo)) / (hi - lo)
    return np.polynomial.chebyshev.chebfit(t, y, deg)


# Chebyshev coefficient sets (degree 20, ~1e-13 absolute):
# - Si(x) and Cin(x) on x in [0, 4]
# - x f(x) and x^2 g(x) on u = 4/x in [0.04, 1] (x in [4, 100]), where
#   Si = pi/2 - f cos - g sin, Ci = f sin - g cos; beyond x = 100 the
#   asymptotic series of f, g is exact to f64.
_SICI_DEG = 20
_xs_fit = np.linspace(1e-9, 4.0, 1601)
_si_fit, _ci_fit = _sici_numpy(_xs_fit)
_C_SI_S = _chebfit(_xs_fit, _si_fit, _SICI_DEG, 0.0, 4.0)
_C_CIN_S = _chebfit(_xs_fit, _ci_fit - (_EULER_GAMMA + np.log(_xs_fit)), _SICI_DEG, 0.0, 4.0)
_u_fit = np.linspace(0.04, 1.0, 2001)
_xl_fit = 4.0 / _u_fit
_si_l, _ci_l = _sici_numpy(_xl_fit)
_f_fit = np.cos(_xl_fit) * (np.pi / 2 - _si_l) + np.sin(_xl_fit) * _ci_l
_g_fit = np.sin(_xl_fit) * (np.pi / 2 - _si_l) - np.cos(_xl_fit) * _ci_l
_C_XF = _chebfit(_u_fit, _xl_fit * _f_fit, _SICI_DEG, 0.04, 1.0)
_C_XG = _chebfit(_u_fit, _xl_fit ** 2 * _g_fit, _SICI_DEG, 0.04, 1.0)
del _xs_fit, _si_fit, _ci_fit, _u_fit, _xl_fit, _si_l, _ci_l, _f_fit, _g_fit


def _clenshaw(t, coeffs):
    """Chebyshev evaluation, fixed unrolled Clenshaw (pure FLOPs: no
    gathers)."""
    b1 = jnp.zeros_like(t)
    b2 = jnp.zeros_like(t)
    t2 = 2.0 * t
    for c in coeffs[:0:-1]:
        b1, b2 = t2 * b1 - b2 + c, b1
    return t * b1 - b2 + coeffs[0]


def sici(x):
    r"""Sine and cosine integrals Si(x), Ci(x) for real x > 0, fully traced
    and differentiable; matches ``scipy.special.sici`` to ~1e-13.

    Piecewise Chebyshev/asymptotic in pure arithmetic (no table gathers, no
    long unrolled recurrences): degree-20 fits of (Si, Cin) on [0, 4] and of
    the smooth auxiliaries (x f, x^2 g) on [4, 100], exact asymptotic
    series beyond. ~6x cheaper than the series+continued-fraction form it
    replaced — this sits inside (nk, nR, nz) halo-profile tensors.
    """
    x = jnp.asarray(x, dtype=jnp.float64)
    small = x <= 4.0
    mid = (x > 4.0) & (x <= 100.0)

    # [0, 4]
    ts = (2.0 * jnp.where(small, x, 4.0) - 4.0) / 4.0
    si_s = _clenshaw(ts, _C_SI_S)
    ci_s = _EULER_GAMMA + jnp.log(jnp.where(x > 0, jnp.where(small, x, 4.0), 1.0)) + _clenshaw(ts, _C_CIN_S)

    # (4, 100]: Chebyshev in u = 4/x; beyond: asymptotic series
    xl = jnp.where(small, 8.0, x)
    u = 4.0 / xl
    tl = (2.0 * jnp.clip(u, 0.04, 1.0) - 1.04) / 0.96
    xf_c = _clenshaw(tl, _C_XF)
    xg_c = _clenshaw(tl, _C_XG)
    inv2 = 1.0 / (xl * xl)
    xf_a = 1.0 + inv2 * (-2.0 + inv2 * (24.0 + inv2 * (-720.0 + inv2 * 40320.0)))
    xg_a = 1.0 + inv2 * (-6.0 + inv2 * (120.0 + inv2 * (-5040.0 + inv2 * 362880.0)))
    xf = jnp.where(mid, xf_c, xf_a)
    xg = jnp.where(mid, xg_c, xg_a)
    f = xf / xl
    g = xg * inv2
    cx, sx = jnp.cos(xl), jnp.sin(xl)
    si_l = jnp.pi / 2 - f * cx - g * sx
    ci_l = f * sx - g * cx

    return jnp.where(small, si_s, si_l), jnp.where(small, ci_s, ci_l)

"""Native HMcode-2020 (Mead et al. 2021, arXiv:2009.01858) non-linear
matter power spectrum — the ``non_linear='mead'/'hmcode'`` capability the
reference forwards to CLASS/CAMB internals (reference classy.py:44-48,
camb.py:124-147), here as a batched, differentiable halo-model transform
over any engine's linear P(k, z).

Physics (paper sections 2-3, fitted parameters from its Table 2):

- sigma^2(R, z) of the cold (cb) field with a tophat window, evaluated for
  the whole (R, z) grid as one (nR, nk) @ (nk, nz) matmul;
- Sheth & Tormen (1999) mass function, integrated over a static ln R grid
  (the mass variable is eliminated analytically: nu(R) = delta_c/sigma(R)
  and dnu/dlnR come from the same spline, so no per-mass root finds);
- NFW halo profile in Fourier space via our own traced Si/Ci
  (ops/special.sici), Bullock-style concentration from the formation
  redshift g(z_f) sigma(f M) = delta_c with the Dolag dark-energy
  correction, and the eta halo-bloating exponent;
- two-halo term: de-wiggled linear spectrum (EH98 no-wiggle shape, Gaussian
  smoothing of the ratio in ln k, damped by exp(-k^2 sigma_v^2)) with the
  fitted large-scale damping f (k/kd)^nd / (1 + (k/kd)^nd);
- one-halo term damped by (k/k*)^4 / (1 + (k/k*)^4);
- smoothed transition Delta^2 = (D2h^alpha + D1h^alpha)^(1/alpha).

Collapse thresholds: delta_c and Delta_v default to the Mead (2017,
arXiv:1606.05345, Table 2) fitted forms in Omega_m(a), g(a)/a and G(a)/a
(``collapse='mead2017'``) that HMcode-2020 specifies, both carrying the
HMcode-2020 massive-neutrino multipliers (1 + 0.262 f_nu), (1 + 0.916 f_nu);
``collapse='ns97'`` selects the earlier Nakamura & Suto (1997) /
Bryan & Norman (1998) forms as a documented fallback (sub-percent
differences in the fitted regime).

Baryonic feedback (``non_linear='mead2020_feedback'``): the single-parameter
T_AGN response of Mead et al. 2021 §5, Table 5 — concentration amplitude
B(theta, z), constant stellar fraction f*(theta, z) served as a point-mass
window term, and the bound-gas fraction f_g(M) = (f_b - f*)/(1 + (M_b/M)^2)
that depletes the NFW window of haloes below the fitted mass M_b(theta, z);
halo bloating (eta) is disabled in the response recipe.
Coefficients transcribed from the published paper table; no external oracle
exists in this zero-egress image, so tests assert the published qualitative
response (suppression depth/scale vs theta) rather than digits.
"""

import numpy as np

import jax.numpy as jnp

from ..interpolator import PowerSpectrumInterpolator2D, kernel_tophat2
from ..ops.quadrature import trapezoid_weights
from ..ops.spline import cubic_eval, natural_cubic_coeffs
from ..ops.special import sici
from .halofit import _nonlinear_scale

# Sheth & Tormen (1999) mass function parameters; A normalizes
# int f(nu) dnu = 1
_ST_p = 0.3
_ST_q = 0.707
_ST_A = 0.21615998645

# HMcode-2020 fitted parameters (Mead et al. 2021, Table 2)
_KSTAR_A, _KSTAR_P = 0.05618, -1.013    # one-halo damping k* [h/Mpc]
_F2H_A, _F2H_P = 0.2696, 0.9403         # two-halo damping amplitude
_KD_A, _KD_P = 0.05699, -1.089          # two-halo damping scale [h/Mpc]
_ND = 2.853                             # two-halo damping power
_B_MIN = 5.196                          # minimum Bullock concentration
_ETA_A, _ETA_P = 0.1281, -0.3644        # halo bloating exponent
_ALPHA_A, _ALPHA_B = 1.875, 1.603       # transition smoothing alpha
_FORM_FRAC = 0.01                       # Bullock formation mass fraction

# HMcode-2020 baryonic feedback (Mead et al. 2021, §5 Table 5): every
# parameter is linear in theta = log10(T_AGN / K) - 7.8, with redshift
# dependence x(z) = x0 * 10^(z * xz)
_FB_B0, _FB_B_T = 3.44, -0.496          # concentration amplitude B(theta)
_FB_BZ0, _FB_BZ_T = -0.0671, -0.0371    # its 10^(z *) exponent
_FB_F0, _FB_F_T = 2.01e-2, -0.30e-2     # stellar halo mass fraction f*
_FB_FZ0, _FB_FZ_T = 0.409, 0.0224
_FB_MB0, _FB_MB_T = 13.87, 1.81         # log10 M_b [Msun/h] gas retention
_FB_MBZ0, _FB_MBZ_T = -0.108, 0.195
_FB_BETA = 2.0                          # gas-fraction transition power

# ideal (EdS) spherical-collapse values
_DC0 = (3.0 / 20.0) * (12.0 * np.pi) ** (2.0 / 3.0)
_DV0 = 18.0 * np.pi ** 2


def _sigma_tophat2_t(k, pk_t, R):
    """Z-major tophat variance: ``pk_t`` (nz, nk) -> (nz, nR).

    One (nz, nk) @ (nk, nR) matmul; under the vmapped pipelines the batch
    axis merges into the M dimension ((B nz, nk) @ (nk, nR)), a far better
    matmul shape than the per-cosmology (nR, nk) @ (nk, 1) of the k-major
    form.
    """
    w = trapezoid_weights(jnp.log(k))
    delta2_t = k[None, :] ** 3 * pk_t / (2 * np.pi ** 2)
    window = kernel_tophat2(k[None, :] * R[:, None]) * w[None, :]   # (nR, nk)
    return delta2_t @ window.T


def sigma_tophat2(k, pk_kz, R):
    """Tophat variance sigma^2(R, z) = int dlnk Delta^2_L(k, z) W^2(kR).

    ``k``: (nk,), ``pk_kz``: (nk, nz), ``R``: (nR,) -> (nR, nz); one matmul.
    """
    return _sigma_tophat2_t(jnp.asarray(k), jnp.asarray(pk_kz).T, R).T


def _sigma_v2_t(k, pk_t):
    """Z-major displacement variance: ``pk_t`` (nz, nk) -> (nz,)."""
    w = trapezoid_weights(jnp.log(k))
    delta2_t = k[None, :] ** 3 * pk_t / (2 * np.pi ** 2)
    return (w[None, :] * delta2_t / k[None, :] ** 2).sum(axis=1) / 3.0


def sigma_v2(k, pk_kz):
    """1D displacement variance sigma_v^2 = (1/3) int dlnk Delta^2(k)/k^2,
    (nz,)."""
    k = jnp.asarray(k)
    return _sigma_v2_t(k, jnp.asarray(pk_kz).T)


def eh_nowiggle_shape(k_h, h, omega_m, omega_b, theta_cmb):
    """EH98 zero-baryon transfer shape (eqs. 26-31): the smooth reference
    used to de-wiggle the linear spectrum. Normalization cancels in the
    ratio smoothing."""
    k = jnp.asarray(k_h) * h  # 1/Mpc
    frac_b = omega_b / omega_m
    s = 44.5 * jnp.log(9.83 / omega_m) / jnp.sqrt(1.0 + 10.0 * omega_b ** 0.75)  # Mpc
    alpha_gamma = (1.0 - 0.328 * jnp.log(431.0 * omega_m) * frac_b
                   + 0.38 * jnp.log(22.3 * omega_m) * frac_b ** 2)
    gamma_eff = omega_m * (alpha_gamma + (1 - alpha_gamma) / (1 + (0.43 * k * s) ** 4))
    q = k * theta_cmb ** 2 / gamma_eff
    L0 = jnp.log(2 * np.e + 1.8 * q)
    C0 = 14.2 + 731.0 / (1 + 62.5 * q)
    return L0 / (L0 + C0 * q ** 2)


def _dewiggle_t(k, pk_t, h, omega_m, omega_b, theta_cmb, ns, smooth_sigma=0.25):
    """Z-major no-wiggle spectrum: ``pk_t`` (nz, nk) -> (nz, nk).

    The smoothing becomes (nz, nk) @ (nk, nk) with the static Gaussian
    kernel as the shared right operand — under vmap the batch axis merges
    into M, one big matmul instead of B matvecs.
    """
    lnk = jnp.log(k)
    pk_eh = eh_nowiggle_shape(k, h, omega_m, omega_b, theta_cmb) ** 2 * k ** ns
    ratio_t = pk_t / pk_eh[None, :]
    # normalized Gaussian kernel matrix over the (static) lnk grid
    d = lnk[:, None] - lnk[None, :]
    G = jnp.exp(-0.5 * (d / smooth_sigma) ** 2)
    G = G / G.sum(axis=1, keepdims=True)
    return (ratio_t @ G.T) * pk_eh[None, :]


def dewiggle(k, pk_kz, h, omega_m, omega_b, theta_cmb, ns, smooth_sigma=0.25):
    """No-wiggle linear spectrum: Gaussian smoothing (width ``smooth_sigma``
    in ln k) of the ratio P / P_EHnw, times P_EHnw (HMcode-2020 appendix A).
    Static smoothing matrix -> one matmul."""
    k = jnp.asarray(k)
    return _dewiggle_t(k, jnp.asarray(pk_kz).T, h, omega_m, omega_b,
                       theta_cmb, ns, smooth_sigma=smooth_sigma).T


def nfw_window(krs, c):
    """Normalized NFW Fourier profile u(k | c) with y = k r_s (kr_v / c).

    u = [sin y (Si((1+c)y) - Si(y)) - sin(cy)/((1+c)y)
         + cos y (Ci((1+c)y) - Ci(y))] / [ln(1+c) - c/(1+c)];
    u -> 1 as k -> 0. All operands broadcast.
    """
    y = jnp.maximum(krs, 1e-8)
    si_y, ci_y = sici(y)
    si_cy, ci_cy = sici((1.0 + c) * y)
    norm = jnp.log(1.0 + c) - c / (1.0 + c)
    u = (jnp.sin(y) * (si_cy - si_y) - jnp.sin(c * y) / ((1.0 + c) * y)
         + jnp.cos(y) * (ci_cy - ci_y)) / norm
    return u


def delta_c(Omega_mz, fnu=0.0):
    """Linear collapse threshold (Nakamura & Suto 1997) with the HMcode-2020
    neutrino multiplier (the ``collapse='ns97'`` fallback)."""
    return _DC0 * (1.0 + 0.0123 * jnp.log10(Omega_mz)) * (1.0 + 0.262 * fnu)


def Delta_v(Omega_mz, fnu=0.0):
    """Virial overdensity w.r.t. the mean matter density (Bryan & Norman
    1998, flat) with the HMcode-2020 neutrino multiplier (the
    ``collapse='ns97'`` fallback)."""
    x = Omega_mz - 1.0
    return (18 * np.pi ** 2 + 82.0 * x - 39.0 * x ** 2) / Omega_mz * (1.0 + 0.916 * fnu)


def _f_mead(x, y, p):
    """Mead (2017) Appendix-A basis f(x, y) = p0 + p1 (1-x) + p2 (1-x)^2
    + p3 (1-y), with x = g(a)/a and y = G(a)/a (both 1 in EdS)."""
    return p[0] + p[1] * (1.0 - x) + p[2] * (1.0 - x) ** 2 + p[3] * (1.0 - y)


def delta_c_mead(Omega_mz, g_ratio, G_ratio, fnu=0.0):
    """Linear collapse threshold fitted to spherical-collapse calculations
    (Mead 2017, arXiv:1606.05345, Table 2 row delta_c; the HMcode-2020
    default) with the HMcode-2020 neutrino multiplier.

    ``g_ratio`` = g(a)/a with g the growth factor normalized g(a) -> a as
    a -> 0; ``G_ratio`` = G(a)/a with G(a) = int_0^a g(a') dln a'.  In EdS
    both ratios are 1 and delta_c = (3/20)(12 pi)^(2/3) (1 + p20) recovers
    the ideal value to 1e-4.
    """
    lg = jnp.log10(Omega_mz)
    f1 = _f_mead(g_ratio, G_ratio, (-0.0069, -0.0208, 0.0312, 0.0021))
    f2 = _f_mead(g_ratio, G_ratio, (0.0001, -0.0647, -0.0417, 0.0646))
    return _DC0 * (1.0 + f1 * lg + f2) * (1.0 + 0.262 * fnu)


def Delta_v_mead(Omega_mz, g_ratio, G_ratio, fnu=0.0):
    """Virial overdensity w.r.t. the mean matter density fitted to
    spherical-collapse calculations (Mead 2017, Table 2 row Delta_v; the
    HMcode-2020 default) with the HMcode-2020 neutrino multiplier.
    Arguments as :func:`delta_c_mead`; EdS recovers 18 pi^2 exactly.
    """
    lg = jnp.log10(Omega_mz)
    f1 = _f_mead(g_ratio, G_ratio, (-0.79, -10.17, 2.51, 6.51))
    f2 = _f_mead(g_ratio, G_ratio, (-1.89, 0.38, 18.8, -15.87))
    return _DV0 * (1.0 + f1 * lg + f2 * lg ** 2) * (1.0 + 0.916 * fnu)


def mead_growth_ratios(z, Omega_m0, Omega_k0=0.0, w0=-1.0, wa=0.0,
                       na=64, a_init=1e-4):
    """(g(a)/a, G(a)/a) at redshifts ``z`` in the Mead (2017) convention.

    The fits are calibrated with the *radiation-free* linear growth of a
    matter + CPL dark-energy (+ curvature) universe, normalized to the
    early-time convention g(a) -> a — the background's own growth tables
    (which include radiation friction and a different normalization) do
    not satisfy this, so the g here is solved from its own 2nd-order ODE
    in eta = ln a: D'' = 1.5 Omega_m(a) D - (2 + dlnH/dlna) D',
    D(a_init) = a_init.  The 64-step default carries ~2e-4 error in the
    ratios vs a converged solve — through the Mead fit coefficients that
    is a sub-permille effect on P(k), far below the model's ~2.5%
    calibration accuracy.

    Numerics: the substitution u = D/a (u == 1 identically in
    EdS) turns 9 e-folds of growth into a slowly-varying factor, solved by
    the log-depth Magnus parallel-prefix propagator
    (ops/odeint.linear_ode2_magnus) instead of a sequential scan; G(a) =
    int_0^a g dln a' then comes from cumulative trapezoid with the
    Euler-Maclaurin h^2/12 endpoint-derivative correction (g' = a (u + u')
    is available analytically from the same solution), closing the
    below-grid tail with the matter-domination limit int_0^a0 a' dln a'
    = a0.
    """
    from ..ops.odeint import linear_ode2_magnus
    Ode0 = 1.0 - Omega_m0 - Omega_k0

    def coeffs(eta):
        a = jnp.exp(eta)
        de = a ** (-3.0 * (1.0 + w0 + wa)) * jnp.exp(-3.0 * wa * (1.0 - a))
        Esq = Omega_m0 * a ** -3 + Omega_k0 * a ** -2 + Ode0 * de
        Om = Omega_m0 * a ** -3 / Esq
        Ok = Omega_k0 * a ** -2 / Esq
        Ode = Ode0 * de / Esq
        w = w0 + wa * (1.0 - a)
        addot = -0.5 * (1.0 - Ok + 3.0 * w * Ode)   # no radiation term
        f = -1.0 - addot
        # u = D/a transform of D'' = s D + f D'
        return 1.5 * Om + f - 1.0, f - 2.0

    eta = np.linspace(np.log(a_init), 0.0, na)
    sol = linear_ode2_magnus(coeffs, jnp.array([1.0, 0.0]), jnp.asarray(eta))
    a_tab = jnp.exp(jnp.asarray(eta))
    u, up = sol[:, 0], sol[:, 1]
    g_tab = a_tab * u                                # already g(a) -> a early
    gp = a_tab * (u + up)                            # dg/deta, analytic
    h = eta[1] - eta[0]
    dG = 0.5 * (g_tab[1:] + g_tab[:-1]) * h
    cumtrapz = jnp.concatenate([jnp.zeros((1,), g_tab.dtype), jnp.cumsum(dG)])
    G_tab = g_tab[0] + cumtrapz - h ** 2 / 12.0 * (gp - gp[0])
    az = 1.0 / (1.0 + jnp.asarray(z))
    # interpolate the RATIOS (u = g/a and G/a, both slowly varying) rather
    # than g, G themselves: linear-interp error on the 128-point grid drops
    # from ~4e-4 to ~1e-6
    x_z = jnp.interp(az, a_tab, u)
    y_z = jnp.interp(az, a_tab, G_tab / a_tab)
    return x_z, y_z


def _st_f(nu):
    """Sheth-Tormen multiplicity f(nu), normalized to unit integral."""
    qnu2 = _ST_q * nu ** 2
    return _ST_A * (1.0 + qnu2 ** (-_ST_p)) * jnp.sqrt(2.0 * _ST_q / np.pi) * jnp.exp(-qnu2 / 2.0)


def hmcode2020(k, pk_cb, pk_m, Omega_mz, fnu, omega_m, omega_b, h, theta_cmb, ns,
               growth_a, growth_g, growth_z, dolag_ratio=1.0, z=None,
               collapse='mead2017', logT_AGN=None,
               Omega_k0=0.0, w0=-1.0, wa=0.0,
               nR=64, Rrange=(5e-4, 5e1), nk_one_halo=32):
    """HMcode-2020 non-linear P(k, z).

    Parameters
    ----------
    k : (nk,) wavenumbers in h/Mpc (log-spaced).
    pk_cb, pk_m : (nk, nz) linear cold / total-matter power in (Mpc/h)^3
        (equal when f_nu = 0).
    Omega_mz : (nz,) matter density parameter at the table redshifts.
    fnu : neutrino mass fraction Omega_nu / Omega_m today.
    omega_m, omega_b : physical densities Omega h^2 (for the EH no-wiggle
        de-wiggling shape and the feedback gas fraction).
    h, theta_cmb, ns : Hubble, T_cmb/2.7255, scalar index.
    growth_a, growth_g : static arrays tabulating the normalized growth
        factor g(a) (g(1) = 1), increasing in a — used to invert the
        Bullock formation condition and for the Mead (2017) collapse fits.
    growth_z : (nz,) growth factor at the table redshifts.
    dolag_ratio : scalar (g_DE / g_LCDM)(z -> inf) ** 1.5 concentration
        correction (1 for LCDM).
    z : (nz,) table redshifts; required for ``collapse='mead2017'`` (the
        default) and for the feedback z-scalings — falls back to
        ``collapse='ns97'`` when omitted.
    collapse : 'mead2017' (HMcode-2020 spec) or 'ns97' (Nakamura-Suto /
        Bryan-Norman fallback).
    logT_AGN : None for the dark-matter-only spectrum, else
        log10(T_AGN / K) selecting the mead2020_feedback baryonic response
        (published central value: 7.8).
    Omega_k0, w0, wa : curvature and CPL dark-energy parameters for the
        radiation-free Mead growth ODE (only used by ``collapse='mead2017'``).

    Returns (nk, nz).
    """
    k = jnp.asarray(k)
    pk_cb = jnp.asarray(pk_cb)
    pk_m = jnp.asarray(pk_m)
    Omega_mz = jnp.atleast_1d(jnp.asarray(Omega_mz))
    growth_z = jnp.atleast_1d(jnp.asarray(growth_z))
    nz = Omega_mz.shape[0]
    if z is not None:
        z = jnp.broadcast_to(jnp.atleast_1d(jnp.asarray(z)), (nz,))

    # Z-MAJOR working layout (z leading, k/R on the minor lane axis): under
    # the batched pipelines every per-cosmology table gains a leading batch
    # axis; k-major (nk, nz) tables at nz=1 put a size-1 axis minor, and
    # the matmuls against static kernels become per-cosmology matvecs
    # instead of batch-merged contractions. Only the small (nR, nz)
    # spline blocks stay k-major (the spline helpers solve along axis 0).
    pt_cb = pk_cb.T                                       # (nz, nk)
    pt_m = pk_m.T
    R = jnp.asarray(np.geomspace(*Rrange, num=nR))
    lnR = jnp.log(R)
    sig2 = _sigma_tophat2_t(k, pt_cb, R).T                # (nR, nz)
    lnsig2 = jnp.log(jnp.maximum(sig2, 1e-300))
    M2 = natural_cubic_coeffs(lnR, lnsig2)                # spline coeffs

    if collapse == 'mead2017' and z is not None:
        g_ratio, G_ratio = mead_growth_ratios(z, omega_m / h ** 2,
                                              Omega_k0=Omega_k0, w0=w0, wa=wa)
        dc = delta_c_mead(Omega_mz, g_ratio, G_ratio, fnu)   # (nz,)
        Dv = Delta_v_mead(Omega_mz, g_ratio, G_ratio, fnu)
    else:
        dc = delta_c(Omega_mz, fnu)                          # (nz,)
        Dv = Delta_v(Omega_mz, fnu)

    # sigma8_cb(z) for the fitted-parameter relations
    ln_s8sq = cubic_eval(lnR, lnsig2, M2, jnp.log(jnp.array([8.0])))[0]  # (nz,)
    sigma8z = jnp.exp(0.5 * ln_s8sq)

    # effective index at the collapse scale (same definition as halofit)
    _, neff, _ = _nonlinear_scale(lnR, lnsig2 - 2.0 * jnp.log(dc)[None, :])

    kstar = _KSTAR_A * sigma8z ** _KSTAR_P
    f2h = _F2H_A * sigma8z ** _F2H_P
    kd = _KD_A * sigma8z ** _KD_P
    # halo bloating is part of the dark-matter-only calibration; the baryon
    # response recipe runs with eta = 0 — with bloating left on, the
    # Table-5 concentration amplitude B(theta) over-suppresses the response
    # (~30% at k ~ 10 for logT_AGN = 7.8 instead of the published ~20%)
    eta = (_ETA_A * sigma8z ** _ETA_P if logT_AGN is None
           else jnp.zeros_like(sigma8z))
    alpha = _ALPHA_A * _ALPHA_B ** neff

    # ---- two-halo: de-wiggled, damped linear total-matter spectrum
    pk_dw_base_t = _dewiggle_t(k, pt_m, h, omega_m, omega_b, theta_cmb, ns)
    sv2 = _sigma_v2_t(k, pt_m)                            # (nz,)
    pk_dw_t = pk_dw_base_t + jnp.exp(-(k[None, :] ** 2) * sv2[:, None]) * (pt_m - pk_dw_base_t)
    kkd_t = (k[None, :] / kd[:, None]) ** _ND
    k3_t = k[None, :] ** 3
    delta2_2h_t = (k3_t / (2 * np.pi ** 2)) * pk_dw_t * (1.0 - f2h[:, None] * kkd_t / (1.0 + kkd_t))

    # ---- one-halo ingredients on the (R, z) grid
    sig = jnp.sqrt(sig2)
    nu = dc[None, :] / sig                                # (nR, nz)
    dlnsig2 = cubic_eval(lnR, lnsig2, M2, lnR, nu=1)      # dln sigma^2/dlnR
    dnu_dlnR = -0.5 * nu * dlnsig2                        # > 0
    # Bullock formation redshift: g(zf) = g(z) * dc / sigma(f^(1/3) R, z)
    sigf = jnp.exp(0.5 * cubic_eval(lnR, lnsig2, M2, lnR + jnp.log(_FORM_FRAC) / 3.0))
    g_needed = growth_z[None, :] * dc[None, :] / sigf     # (nR, nz)
    af = jnp.interp(g_needed, jnp.asarray(growth_g), jnp.asarray(growth_a))
    a_z = jnp.interp(growth_z, jnp.asarray(growth_g), jnp.asarray(growth_a))
    af = jnp.minimum(af, a_z[None, :])                    # zf >= z
    if logT_AGN is None:
        B = _B_MIN
    else:
        if z is None:
            raise ValueError("mead2020_feedback needs the table redshifts: pass z=")
        theta = jnp.asarray(logT_AGN) - 7.8
        B = (_FB_B0 + _FB_B_T * theta) * 10.0 ** (z * (_FB_BZ0 + _FB_BZ_T * theta))
        B = B[None, :]                                    # (1, nz)
    conc = B * (1.0 / af) * a_z[None, :] * dolag_ratio    # B (1+zf)/(1+z)

    # halo scale radii: rv = R / Dv^(1/3), rs = rv / c
    rv = R[:, None] / Dv[None, :] ** (1.0 / 3.0)          # (nR, nz)
    # The one-halo term is smooth in k (no BAO structure): evaluate the
    # (k, R, z) profile tensor on a coarse k-subgrid and spline ln P_1h
    # back to the full grid — ~nk/nk1h less work for the dominant tensor.
    # Accuracy vs the dense evaluation at the default 32 nodes: < 4e-4 for
    # k <= 10 h/Mpc (the halo model's calibrated regime, and already the
    # same error as 64 nodes); up to ~1% on the k > 30 tail where the
    # truncated-NFW oscillation is undersampled by the final full-grid
    # spline regardless of nk_one_halo (raise it if that tail matters).
    nk = k.shape[0]
    nk1h = min(nk_one_halo, nk)
    isub = np.unique(np.round(np.linspace(0, nk - 1, nk1h)).astype(int))
    ksub = k[isub]
    # Profile-tensor layout: under the batched (vmapped) pipeline every
    # per-cosmology array gains a leading batch axis; the z-minor
    # (nk1h, nR, nz) ordering would put a size-1 axis minor in the
    # dominant transcendental tensor. Order it (nz, nk1h, nR) instead:
    # nR = 64 minor, nk1h = 32 second-minor.
    # bloated profile argument: y = (nu^eta k) rv / c
    rvc_t = (nu ** eta[None, :] * rv / conc).T            # (nz, nR)
    krs = ksub[None, :, None] * rvc_t[:, None, :]         # (nz, nk1h, nR)
    u = nfw_window(krs, conc.T[:, None, :])

    # halo window in units of M/rho: (1 - f_nu) u for the matter-only
    # spectrum (neutrinos are smooth); with feedback, the Mead et al. 2021
    # §5 baryon recipe — CDM + bound gas trace NFW, stars are a point mass,
    # expelled gas leaves the halo: win -> (f_c + f_g(M)) u + f*, which
    # recovers (1 - f_nu) u for M >> M_b, f* -> 0
    if logT_AGN is None:
        win = (1.0 - fnu) * u
    else:
        from ..constants import rho_crit_over_Msunph_per_Mpcph3
        fb = omega_b / omega_m
        fstar = jnp.minimum((_FB_F0 + _FB_F_T * theta)
                            * 10.0 ** (z * (_FB_FZ0 + _FB_FZ_T * theta)), fb)  # (nz,)
        Mb = 10.0 ** (_FB_MB0 + _FB_MB_T * theta
                      + z * (_FB_MBZ0 + _FB_MBZ_T * theta))                    # (nz,) Msun/h
        # Lagrangian halo mass at comoving mean matter density, Msun/h
        M = (4.0 * np.pi / 3.0) * (rho_crit_over_Msunph_per_Mpcph3 * 1e10
                                   * omega_m / h ** 2) * R ** 3                # (nR,)
        fg = (fb - fstar)[None, :] / (1.0 + (Mb[None, :] / M[:, None]) ** _FB_BETA)  # (nR, nz)
        fc = 1.0 - fb - fnu
        win = (fc + fg).T[:, None, :] * u + fstar[:, None, None]

    # one-halo integral over lnR: P_1h = int dlnR dnu/dlnR f(nu) (M/rho)
    # win^2, as a per-z matvec contracting the minor (lane) axis
    dlnR = lnR[1] - lnR[0]
    w_int = dnu_dlnR * _st_f(nu) * (4.0 * np.pi / 3.0) * R[:, None] ** 3 * dlnR  # (nR, nz)
    pk_1h_sub = jnp.einsum('rz,zkr->zk', w_int, win ** 2)
    if len(isub) < nk:
        lnk = jnp.log(k)
        ln_p1h = jnp.log(jnp.maximum(pk_1h_sub, 1e-300)).T   # (nk1h, nz)
        Mk = natural_cubic_coeffs(lnk[isub], ln_p1h)
        pk_1h_t = jnp.exp(cubic_eval(lnk[isub], ln_p1h, Mk, lnk)).T  # (nz, nk)
    else:
        pk_1h_t = pk_1h_sub
    kks_t = (k[None, :] / kstar[:, None]) ** 4
    delta2_1h_t = (k3_t / (2 * np.pi ** 2)) * pk_1h_t * kks_t / (1.0 + kks_t)

    # ---- smoothed transition
    delta2_t = (jnp.maximum(delta2_2h_t, 0.0) ** alpha[:, None]
                + delta2_1h_t ** alpha[:, None]) ** (1.0 / alpha[:, None])
    return (delta2_t * (2 * np.pi ** 2) / k3_t).T


def hmcode_pk_interpolator(pk2d_m, background, cosmo_params, pk2d_cb=None, **kwargs):
    """Non-linear HMcode-2020 PowerSpectrumInterpolator2D from linear ones.

    ``pk2d_m`` (and optionally ``pk2d_cb``): linear interpolators;
    ``background``: section providing Omega_m(z) and the growth tables;
    ``cosmo_params``: dict with omega_m, omega_b, h, T_cmb, n_s, fnu,
    w0_fld, wa_fld and optionally ``dolag_ratio``, ``collapse``
    ('mead2017'/'ns97') and ``logT_AGN`` (mead2020_feedback response).
    """
    k, z = pk2d_m.k, pk2d_m.z
    zz = jnp.atleast_1d(jnp.asarray(z))
    pk_m = pk2d_m(k, zz, grid=True).reshape(k.shape[0], -1)
    pk_cb = (pk2d_cb(k, zz, grid=True).reshape(k.shape[0], -1)
             if pk2d_cb is not None else pk_m)
    Omega_mz = background.Omega_m(zz)
    a_grid = jnp.asarray(np.geomspace(1e-3, 1.0, 128))
    growth_g = background.growth_factor(1.0 / a_grid - 1.0)
    growth_z = background.growth_factor(zz)
    if 'dolag_ratio' not in cosmo_params:
        # Dolag et al. (2004) dark-energy concentration correction:
        # (g_DE / g_LCDM)(z -> inf) ** 1.5 with today-normalized growths,
        # computed against a LambdaCDM analog (same densities, w = -1);
        # exactly 1 for LCDM inputs since the backgrounds coincide
        import copy
        ba_l = copy.copy(background)
        ba_l._w0_fld = jnp.asarray(-1.0, dtype=jnp.float64)
        ba_l._wa_fld = jnp.asarray(0.0, dtype=jnp.float64)
        ba_l._cache = {name: value for name, value in background._cache.items()
                       if 'growth' not in name}
        zinf = 100.0
        cosmo_params = dict(cosmo_params)
        cosmo_params['dolag_ratio'] = (background.growth_factor(zinf)
                                       / ba_l.growth_factor(zinf)) ** 1.5
    pk_nl = hmcode2020(
        k, pk_cb, pk_m, Omega_mz,
        fnu=cosmo_params.get('fnu', 0.0),
        omega_m=cosmo_params['omega_m'], omega_b=cosmo_params['omega_b'],
        h=cosmo_params['h'], theta_cmb=cosmo_params.get('theta_cmb', 1.0),
        ns=cosmo_params.get('n_s', 0.96),
        growth_a=a_grid, growth_g=growth_g, growth_z=growth_z,
        dolag_ratio=cosmo_params.get('dolag_ratio', 1.0), z=zz,
        collapse=cosmo_params.get('collapse', 'mead2017'),
        logT_AGN=cosmo_params.get('logT_AGN'),
        Omega_k0=cosmo_params.get('Omega_k', 0.0),
        w0=cosmo_params.get('w0_fld', -1.0), wa=cosmo_params.get('wa_fld', 0.0))
    if zz.shape[0] == 1:  # single-z table: serve it flat in z
        from jax.tree_util import Partial
        kwargs.setdefault('growth_factor_sq', Partial(jnp.ones_like))
    return PowerSpectrumInterpolator2D(k, zz, pk_nl, extrap_kmin=pk2d_m.extrap_kmin,
                                       extrap_kmax=pk2d_m.extrap_kmax, **kwargs)

"""Lensed CMB spectra from the unlensed ones + C_l^phiphi.

Correlation-function method (Seljak 1996; Challinor & Lewis 2005 class of
algorithms), non-perturbative in the deflection variance sigma^2(r):

1. deflection-difference covariances on an angular grid r:
       sigma^2(r) = sum_l w_l l(l+1) C_l^pp [1 - J_0(x)],   x = (l+1/2) r
       Cgl2(r)    = sum_l w_l l(l+1) C_l^pp J_2(x),          w_l = (2l+1)/4pi
2. lensed correlation functions: the Gaussian average over deflections
   <e^{i l.(a1-a2)}> = e^{-l^2 sigma^2/2} e^{-beta cos 2phi}, expanded in
   modified Bessel functions I_n(beta), beta = l(l+1) Cgl2 / 2, gives
       xi~_T = sum w_l C_l^TT e^{-l(l+1)s2/2} [I0 J0 + 2 I1 J2 + 2 I2 J4 + 2 I3 J6]
       xi~_+ = same kernel on (C^EE + C^BB)
       xi~_- = sum w_l (C^EE-C^BB) e^.. [I0 J4 + I1 (J2+J6) + I2 (J0+J8) + I3 (J2+J10->J2 dropped-order)]
       xi~_X = sum w_l C^TE  e^.. [I0 J2 + I1 (J0+J4) + I2 (J2+J6) + I3 (J4+J8)]
3. the DIFFERENCE delta-xi = xi~ - xi (same sums with the lensing kernel
   minus the unlensed one) is transformed back with the same quadrature:
       delta-C_l = 2pi int r dr delta-xi(r) J_m((l+1/2) r)
   so all flat-sky and quadrature bias cancels at zeroth order in the
   lensing correction - only the (few-percent-of-few-percent) error OF the
   correction survives.

The reference cannot lens anything itself: it reads lensed Cls from
CLASS/CAMB (cosmoprimo/classy.py:278-301 lensed_table). Validation anchor:
tests/fiducial/abacus_cosm000_CLASSv3.1.1.00_cl_lensed.dat.

Static shapes: the l-sums and r-integrals are (n_r, n_l)-shaped elementwise
blocks + matvecs; J_m values come from one uniform-grid cubic-Hermite table
gather shared by all kernels; everything is static-shaped and jit/vmap-safe.
"""

import numpy as np
import jax
import jax.numpy as jnp

R_MAX = np.pi / 8.0   # lensing correlations are dead beyond ~2 degrees
N_R = 8192
_DXJ = 0.05           # Bessel-table spacing in x = (l+1/2) r


def _bessel_j_tables(x_max, dx=_DXJ, mmax=10):
    """Uniform-grid J_0..J_mmax tables (host, numpy)."""
    from scipy.special import jv
    x = np.arange(0.0, x_max + 6 * dx, dx)
    return x, np.stack([jv(m, x) for m in range(mmax + 1)])


def _hermite_rows(tab, dtab, u, rows):
    """Cubic-Hermite of selected table rows at fractional index u."""
    n_x = tab.shape[-1]
    i0 = jnp.clip(u.astype(jnp.int32), 0, n_x - 2)
    t = u - i0
    t2, t3 = u * 0 + (u - i0) ** 2, (u - i0) ** 3
    h00 = 2.0 * t3 - 3.0 * t2 + 1.0
    h10 = t3 - 2.0 * t2 + t
    h01 = -2.0 * t3 + 3.0 * t2
    h11 = t3 - t2
    out = []
    for m in rows:
        out.append(h00 * tab[m, i0] + h10 * dtab[m, i0]
                   + h01 * tab[m, i0 + 1] + h11 * dtab[m, i0 + 1])
    return out


def _i_factors(beta):
    """(I_0..I_3)(|beta|) e^-|beta|, with odd orders signed for beta < 0."""
    s = jnp.sign(beta)
    b = jnp.abs(beta)
    i0 = jax.scipy.special.i0e(b)
    i1 = jax.scipy.special.i1e(b)
    small = b < 1e-4
    bs = jnp.where(small, 1.0, b)
    # upward recurrence I_{n+1} = I_{n-1} - (2n/b) I_n, series fallback
    i2 = jnp.where(small, jnp.exp(-b) * b * b / 8.0, i0 - (2.0 / bs) * i1)
    i3 = jnp.where(small, jnp.exp(-b) * b ** 3 / 48.0, i1 - (4.0 / bs) * i2)
    return i0, s * i1, i2, s * i3


def lensed_cls(cl_tt, cl_ee, cl_bb, cl_te, cl_pp, lmax=None, n_r=N_R, r_max=R_MAX):
    """Lensed 'tt','ee','bb','te' from unlensed integer-l inputs (index =
    l, starting at 0) and the lensing-potential spectrum. Returns a dict of
    (lmax+1,) arrays (same raw dimensionless convention as the inputs)."""
    lmax_in = cl_tt.shape[0] - 1
    if lmax is None:
        lmax = lmax_in
    ell = jnp.arange(lmax_in + 1, dtype=jnp.float64)
    lt = ell + 0.5
    llp1 = ell * (ell + 1.0)
    w_l = (2.0 * ell + 1.0) / (4.0 * jnp.pi)

    r = jnp.linspace(r_max / n_r, r_max, n_r)
    x_max = float(lmax_in + 0.5) * float(r_max)
    xg, jt = _bessel_j_tables(x_max)
    jt = jnp.asarray(jt)
    # nodal derivatives from J_m' = (J_{m-1} - J_{m+1})/2; J_0' = -J_1
    djt = jnp.concatenate([-jt[1:2], 0.5 * (jt[:-2] - jt[2:])], axis=0) * _DXJ

    u = (lt[None, :] * r[:, None]) / _DXJ                      # (n_r, n_l)
    j0, j2, j4, j6, j8 = _hermite_rows(jt, djt, u, (0, 2, 4, 6, 8))

    # --- deflection covariances
    wpp = w_l * llp1 * cl_pp
    sigma2 = jnp.sum(wpp) - j0 @ wpp                           # (n_r,)
    cgl2 = j2 @ wpp

    # --- lensed-minus-unlensed correlation functions
    beta = 0.5 * llp1[None, :] * cgl2[:, None]
    i0f, i1f, i2f, i3f = _i_factors(beta)
    # e^{-llp1 sigma2/2} I_n(beta) = e^{-llp1 sigma2/2 + |beta|} (I_n e^-|beta|)
    damp = jnp.exp(-0.5 * llp1[None, :] * sigma2[:, None] + jnp.abs(beta))

    kT = damp * (i0f * j0 + 2.0 * (i1f * j2 + i2f * j4 + i3f * j6)) - j0
    kM = damp * (i0f * j4 + i1f * (j2 + j6) + i2f * (j0 + j8)) - j4
    kX = damp * (i0f * j2 + i1f * (j0 + j4) + i2f * (j2 + j6)) - j2

    dxi_T = kT @ (w_l * cl_tt)
    dxi_P = kT @ (w_l * (cl_ee + cl_bb))                       # xi_+ kernel = spin-0 kernel
    dxi_M = kM @ (w_l * (cl_ee - cl_bb))
    dxi_X = kX @ (w_l * cl_te)

    # --- back-transform of the differences on the same grid
    wr = 2.0 * jnp.pi * r * (r[1] - r[0])
    ell_o = jnp.arange(lmax + 1, dtype=jnp.float64)
    uo = ((ell_o + 0.5)[None, :] * r[:, None]) / _DXJ
    o0, o2, o4 = _hermite_rows(jt, djt, uo, (0, 2, 4))

    dC_T = (wr * dxi_T) @ o0
    dC_P = (wr * dxi_P) @ o0
    dC_M = (wr * dxi_M) @ o4
    dC_X = (wr * dxi_X) @ o2

    def pad(cl):
        return cl[:lmax + 1] if lmax <= lmax_in else jnp.pad(cl, (0, lmax - lmax_in))

    out = {
        'tt': pad(cl_tt) + dC_T,
        'ee': pad(cl_ee) + 0.5 * (dC_P + dC_M),
        'bb': pad(cl_bb) + 0.5 * (dC_P - dC_M),
        'te': pad(cl_te) + dC_X,
    }
    for name in out:
        out[name] = out[name].at[:2].set(0.0)
    return out

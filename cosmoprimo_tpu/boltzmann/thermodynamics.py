"""Recombination + reionization history, natively traced (RECFAST-lite).

The reference obtains its thermodynamics (x_e, z_star, z_drag, rs_drag,
baryon temperature) exclusively from CLASS/CAMB (cosmoprimo/classy.py:
get_thermodynamics, camb.py get_derived_params); its analytic engines fall
back to the EH98 fitting formulas (~1% level). This module integrates the
standard effective three-level atom (Peebles 1968 with the RECFAST 1.14
case-B fudge; Seager, Sasselov & Scott 2000) together with Saha helium
cascades and the Compton-coupled matter temperature, on a uniform ln(a)
grid with a Crank-Nicolson/Newton step - everything jnp, so the whole
history jits, vmaps over cosmology batches, and differentiates.

Design notes:
- one fixed-size `lax.scan` over the ln(a) grid carries (x_H, T_m); all
  regime changes (Saha -> ODE handoff, Compton tight-coupling attractor)
  are `jnp.where` blends, so the graph is static for any cosmology;
- every other ingredient (Saha helium fractions, kappa', optical depths,
  the tanh reionization window) is closed-form on the grid: no second
  scan; cumulative integrals are vectorized trapezoids;
- the tau_reio -> z_reio inversion is a traced bisection on a vectorized
  integral (ops.roots.bisect), not a Python loop.

Accuracy: x_e through hydrogen recombination matches RECFAST at the
~1e-3 level (fudged Peebles); helium recombination uses Saha (the known
~1% early-x_e approximation, which perturbs z_star/z_drag by < 0.1%).
Validation against the CLASS-computed DESI fiducial anchors lives in
tests/test_thermodynamics.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..ops.roots import bisect

# lax.scan unroll factor for the recombination history (env knob kept for
# studies; not yet measured on the GPU).
UNROLL = int(os.environ.get('NATIVE_UNROLL_THERMO', '1'))

# ---- SI atomic constants (CODATA 2018 / RECFAST values)
sigma_thomson = 6.6524587321e-29        # m^2
m_electron = 9.1093837015e-31           # kg
m_hydrogen = 1.6737236e-27              # kg (RECFAST m_H)
not4 = 3.9715                           # m_He / m_H (RECFAST)
h_planck = 6.62607015e-34               # J s
a_radiation = 4.0 * constants.Stefan_Boltzmann / constants.c  # J m^-3 K^-4
lambda_lya = 1215.668e-10               # m, Lyman-alpha wavelength
lambda_2s1s = 8.2245809                 # 1/s, H 2s->1s two-photon rate
# Ionization energies as temperatures [K] (RECFAST CB1, CDB, and He I/II)
B1_H = 1.57809e5                        # H ground state
B2_H = B1_H / 4.0                       # H n=2
E_alpha = B1_H - B2_H                   # Ly-alpha (kept exactly B1-B2 so the
                                        # Peebles equilibrium is ground-state Saha)
chi_HeI = 2.853157e5                    # He I first ionization (24.5874 eV)
chi_HeII = 6.31515e5                    # He II second ionization (54.4178 eV)
# HeI singlet-channel levels (RECFAST wavenumbers x hc/k -> temperatures)
_HCK = 1.43877688e-2                    # h c / k_B [m K]
L_He_2s = 1.66277434e7                  # 1/m, 2^1s excitation
L_He_2p = 1.71134891e7                  # 1/m, 2^1p excitation
chi_He_2s = (1.98310772e7 - L_He_2s) * _HCK   # ionization FROM 2^1s, 4.609e4 K
E_He_2s = L_He_2s * _HCK                # 1^1s -> 2^1s excitation, 2.392e5 K
E_He_2p2s = (L_He_2p - L_He_2s) * _HCK  # 2^1p - 2^1s split, 6989 K
lambda_He_2p = 1.0 / L_He_2p            # m, 58.4334 nm intercombination line
lambda_He_2s1s = 51.3                   # 1/s, He 2^1s->1^1s two-photon rate

_MPC = constants.megaparsec_over_m
_C_KMS = constants.c / 1e3


def YHe_bbn(omega_b, N_eff=constants.NEFF):
    """Primordial helium mass fraction from standard BBN, as a local linear
    expansion of the PArthENoPE-style tables CLASS interpolates for
    ``YHe='BBN'`` (explanatory.ini): Y_p(0.02237, 3.044) = 0.2467 with
    dY/domega_b ~ 0.3 and dY/dN_eff ~ 0.013 around the Planck point."""
    return 0.2467 + 0.30 * (omega_b - 0.02237) + 0.013 * (N_eff - constants.NEFF)


def _saha_per_H(T, chi_K, n_H):
    """Saha right-hand side in electrons-per-hydrogen units:
    (2 pi m_e k T / h^2)^{3/2} exp(-chi/T) / n_H, exponent clipped so the
    fully-ionized limit stays finite in f64."""
    lng = 1.5 * jnp.log(2.0 * jnp.pi * m_electron * constants.Boltzmann * T / h_planck ** 2)
    return jnp.exp(jnp.clip(lng - chi_K / T - jnp.log(n_H), -300.0, 300.0))


def _quad_root(b, c):
    """Positive root of u^2 * a2 + b u - c = 0 given as 2c/(b + sqrt(b^2+4 a2 c))
    with a2 folded into the caller's b, c: here solves u = 2c/(b+sqrt(b^2+4c))
    for a2=1 (stable for huge b or c)."""
    return 2.0 * c / (b + jnp.sqrt(b * b + 4.0 * c))


def saha_helium_III(T, n_H, f_He):
    """Fraction v = n_HeIII/n_He from Saha (H fully ionized):
    (1 + f(1+v)) v / (1-v) = S."""
    S = _saha_per_H(T, chi_HeII, n_H)  # statistical factor 2 g_III / g_II = 1
    b = 1.0 + f_He + S
    # f v^2 + b v - S = 0
    return 2.0 * S / (b + jnp.sqrt(b * b + 4.0 * f_He * S))


def saha_helium_II(T, n_H, f_He, x_H=1.0):
    """Fraction u = n_HeII/n_He from Saha (statistical factor 4):
    (x_H + f u) u / (1 - u) = 4 S."""
    S = 4.0 * _saha_per_H(T, chi_HeI, n_H)
    b = x_H + S
    return 2.0 * S / (b + jnp.sqrt(b * b + 4.0 * f_He * S))


def saha_hydrogen(T, n_H, x_He_electrons=0.0):
    """x_H from Saha including the He electrons: x (x + xHe_e)/(1-x) = S."""
    S = _saha_per_H(T, B1_H, n_H)
    b = x_He_electrons + S
    return 2.0 * S / (b + jnp.sqrt(b * b + 4.0 * S))


def alpha_B(T_m, fudge=1.14):
    """Case-B recombination coefficient [m^3/s], RECFAST fit (Pequignot et
    al. 1991 form) times the RECFAST fudge."""
    t = T_m / 1e4
    return fudge * 1e-19 * 4.309 * t ** (-0.6166) / (1.0 + 0.6703 * t ** 0.5300)


def _beta2(T_m, fudge=1.14):
    """Photoionization rate from n=2 [1/s] by detailed balance."""
    lng = 1.5 * jnp.log(2.0 * jnp.pi * m_electron * constants.Boltzmann * T_m / h_planck ** 2)
    return alpha_B(T_m, fudge) * jnp.exp(jnp.clip(lng - B2_H / T_m, -300.0, 300.0))


HEI_ESCAPE_SCALE = float(os.environ.get('NATIVE_HEI_ESCAPE_SCALE', '1.0'))
"""Multiplier on the HeI 2^1p Sobolev escape channel, standing in for the
neutral-hydrogen continuum-opacity acceleration (Kholupenko et al. 2007;
RECFAST's Heflag >= 2 terms): H 1s photoionization destroys He 58.4 nm
line photons, speeding HeI recombination relative to the pure singlet
channel. A/B-measured against the archived CLASS (HyRec) Cl golden
(scale 1/2/4 at lmax 2500): acceleration trades the mid-l band for the
damping edge (TT l=1000 +1.2 -> +0.9%, but l=2500 -1.7 -> -2.6% and
max EE 2.7 -> 3.3%) - the minimax optimum is NO acceleration, so the
default stays 1.0."""


def alpha_HeI(T_m):
    """HeI singlet case-B recombination coefficient [m^3/s]: the
    Verner & Ferland (1996) fit with the RECFAST parameters
    (q = 10^-16.744, p = 0.711, T1 = 10^5.114 K, T2 = 3 K)."""
    s1 = jnp.sqrt(T_m / 10.0 ** 5.114)
    s2 = jnp.sqrt(T_m / 3.0)
    return 10.0 ** -16.744 / (s2 * (1.0 + s2) ** (1.0 - 0.711)
                              * (1.0 + s1) ** (1.0 + 0.711))


def _beta_HeI(T_m):
    """HeI photoionization rate from 2^1s [1/s] by detailed balance
    (statistical factor 4 = g_HeII g_e / g_HeI(2s))."""
    lng = 1.5 * jnp.log(2.0 * jnp.pi * m_electron * constants.Boltzmann * T_m / h_planck ** 2)
    return 4.0 * alpha_HeI(T_m) * jnp.exp(jnp.clip(lng - chi_He_2s / T_m, -300.0, 300.0))


class ThermodynamicsResult(object):
    """Plain pytree container for the thermodynamic history and scalars.

    Tables are on the module's uniform ln(a) grid (``lna``, static): x_e
    (electrons per H), T_m [K], kappa' (conformal Thomson scattering rate,
    1/Mpc), tau (optical depth), tau_drag (baryon-drag depth). Scalars:
    z_star, z_drag (tau and tau_drag crossing 1), tau_reio, z_reio, YHe.
    rs_* are left to the caller (Background.rs)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def tree_flatten(self):
        return (self.__dict__,), {}

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        new.__dict__.update(children[0])
        return new


jax.tree_util.register_pytree_node_class(ThermodynamicsResult)

# Static ln(a) grid: recombination + reionization live in a in [1e-8, 1];
# uniform spacing keeps the CN scan step constant and the trapezoid weights
# trivial. 6144 intervals -> dlna ~ 3e-3 (CN local error ~1e-9/step).
N_GRID = 6145
LNA_GRID = np.linspace(np.log(1e-8), 0.0, N_GRID)
DLNA = float(LNA_GRID[1] - LNA_GRID[0])
# static index range with z > 50 (grid points are ordered early -> today)
_HIZ_SLICE = slice(0, int(np.sum(LNA_GRID <= np.log(1.0 / 51.0))))


def compute_thermodynamics(omega_b, h, T_cmb, efunc_of_z, YHe=None,
                           tau_reio=None, z_reio=None, reionization_width=0.5,
                           N_eff=constants.NEFF, fudge=1.14):
    """Full ionization/temperature history and derived scalars.

    Parameters
    ----------
    omega_b, h, T_cmb : scalars (traced OK).
    efunc_of_z : callable z -> E(z) = H(z)/H0 (the engine background).
    YHe : helium mass fraction; default = BBN fit.
    tau_reio / z_reio : give one; tanh reionization (CAMB-style (1+z)^1.5
        shape, width ``reionization_width`` in z).
    """
    lna = jnp.asarray(LNA_GRID)
    a = jnp.exp(lna)
    z = 1.0 / a - 1.0
    Y = YHe_bbn(omega_b, N_eff) if YHe is None else YHe
    f_He = Y / (not4 * (1.0 - Y))

    # number density of hydrogen nuclei today [1/m^3]
    rho_b0 = omega_b * constants.rho_crit_over_kgph_per_mph3
    n_H0 = (1.0 - Y) * rho_b0 / m_hydrogen
    n_H = n_H0 / a ** 3
    T_gamma = T_cmb / a

    # Hubble rate in 1/s on the grid
    E = efunc_of_z(z)
    H_s = 100.0 * h * E * 1e3 / _MPC

    # ---- helium Saha fractions (closed form on the grid): u counts singly-
    # ionized He, v doubly-ionized. The regimes are sequential (v ~ 1 while
    # u is pinned at 1 by its own huge Saha factor), so compose them the
    # standard RECFAST way: He electrons per H = f (1 + v) while any HeIII
    # survives, f u afterwards.
    v_HeIII = saha_helium_III(T_gamma, n_H, f_He)
    u_HeII = saha_helium_II(T_gamma, n_H, f_He)
    x_He_e_saha = f_He * jnp.where(v_HeIII > 1e-6, 1.0 + v_HeIII, u_HeII)

    x_H_saha = saha_hydrogen(T_gamma, n_H, x_He_e_saha)

    # ---- one scan: HeI singlet ODE (xhe) + Peebles ODE for x_H +
    # Crank-Nicolson for T_m. ``xhe`` is the He electrons per H through the
    # HeI->HeII stage (f_He at full single ionization, ->0 as HeI forms);
    # the brief HeIII era stays closed-form Saha (v_HeIII).
    def _xhe_e(xhe, i):
        return jnp.where(v_HeIII[i] > 1e-6, f_He * (1.0 + v_HeIII[i]), xhe)

    def dxHe_dlna(x_H, xhe, T_m, i):
        """RECFAST singlet-channel effective three-level HeI ODE (Seager et
        al. 2000; Wong, Moss & Scott 2008 eq. 2): Saha HeI recombines He too
        EARLY, over-damping the CMB tail; the finite 2^1p escape +
        two-photon rates delay it by Delta z ~ 100."""
        x_e = x_H + xhe
        nH, Hs = n_H[i], H_s[i]
        aHe = alpha_HeI(T_m)
        bHe = _beta_HeI(T_m)
        n_He1s = jnp.maximum(f_He - xhe, 0.0) * nH
        K_He = lambda_He_2p ** 3 / (8.0 * jnp.pi * Hs)
        # C factor with the 2^1p<->2^1s Boltzmann weight, written via
        # inv = exp(-E_2p2s/T)/(K Lambda-weighted 1s pool) so every branch
        # stays finite as T -> 0 or n_He1s -> 0
        inv = HEI_ESCAPE_SCALE * jnp.exp(
            jnp.clip(-E_He_2p2s / T_m
                     - jnp.log(jnp.maximum(K_He * n_He1s, 1e-300)),
                     -300.0, 300.0))
        C = (lambda_He_2s1s + inv) / (lambda_He_2s1s + bHe + inv)
        up = bHe * jnp.exp(jnp.clip(-E_He_2s / T_m, -300.0, 0.0)) * (f_He - xhe)
        down = aHe * nH * x_e * xhe
        return C * (up - down) / Hs

    # NOTE: the RECFAST 1.5 'Hswitch' double-Gaussian Ly-alpha-escape
    # correction (Rubino-Martin et al. 2010; K_H x (1 - 0.14 e^-((ln(1+z)
    # -7.28)/0.18)^2 + 0.079 e^-((ln(1+z)-6.73)/0.33)^2), fudge 1.125) was
    # implemented and A/B-measured against the archived CLASS v3.1.1
    # (HyRec) Cl golden: it WORSENED the damping tail (TT at l = 2500:
    # -1.7% -> -6.1% full, -4.2% with no Gaussians at fudge 1.125) - the
    # plain fudge-1.14 Peebles history tracks the HyRec-based golden best,
    # so that is what ships.
    def dxH_dlna(x_H, xhe_e, T_m, i):
        x_e = x_H + xhe_e
        nH, Hs = n_H[i], H_s[i]
        aB = alpha_B(T_m, fudge)
        b2 = _beta2(T_m, fudge)
        n_1s = jnp.maximum(1.0 - x_H, 0.0) * nH
        K = lambda_lya ** 3 / (8.0 * jnp.pi * Hs)
        C = (1.0 + K * lambda_2s1s * n_1s) / (1.0 + K * (lambda_2s1s + b2) * n_1s)
        up = b2 * jnp.exp(-E_alpha / T_m) * (1.0 - x_H)
        down = aB * nH * x_e * x_H
        return C * (up - down) / Hs

    def compton_rate(x_e, i):
        """A = (8 sigma_T a_r T_g^4)/(3 m_e c H) * x_e/(1+f_He+x_e): the
        Compton coupling rate per ln(a)."""
        return (8.0 * sigma_thomson * a_radiation * T_gamma[i] ** 4
                / (3.0 * m_electron * constants.c * H_s[i])) * x_e / (1.0 + f_He + x_e)

    def step(carry, i):
        x_H, xhe, T_m = carry

        # -- HeI: Saha while its own equilibrium still holds (u > 0.99),
        # then the singlet-channel CN/Newton ODE
        use_saha_he = u_HeII[i] > 0.99
        f0_he = dxHe_dlna(x_H, xhe, T_m, i - 1)
        xhe_ode = xhe + DLNA * f0_he
        for _ in range(3):  # unrolled: a nested scan would serialize dispatch
            g = xhe_ode - xhe - 0.5 * DLNA * (f0_he + dxHe_dlna(x_H, xhe_ode, T_m, i))
            gp = jax.grad(lambda xx: xx - 0.5 * DLNA * dxHe_dlna(x_H, xx, T_m, i))(xhe_ode)
            xhe_ode = xhe_ode - g / gp
        xhe_next = jnp.where(use_saha_he, f_He * u_HeII[i],
                             jnp.clip(xhe_ode, 0.0, f_He))
        xhe_e0 = _xhe_e(xhe, i - 1)
        xhe_e1 = _xhe_e(xhe_next, i)

        # Saha -> ODE handoff at x = 0.985: late enough that the CN step is
        # past the stiff relaxation (CN is A- but not L-stable and rings if
        # handed the equilibrium regime), early enough that the equilibrium
        # lag is still < 1e-4 in x_e
        x_H_saha_i = saha_hydrogen(T_gamma[i], n_H[i], xhe_e1)
        use_saha = x_H_saha_i > 0.985

        # -- x_H: Crank-Nicolson with 3 Newton iterations (f is smooth and
        # mildly nonlinear; the stiff regime is fenced off by the Saha switch)
        f0 = dxH_dlna(x_H, xhe_e0, T_m, i - 1)

        x_ode = x_H + DLNA * f0
        for _ in range(3):
            g = x_ode - x_H - 0.5 * DLNA * (f0 + dxH_dlna(x_ode, xhe_e1, T_m, i))
            gp = jax.grad(lambda xx: xx - 0.5 * DLNA * dxH_dlna(xx, xhe_e1, T_m, i))(x_ode)
            x_ode = x_ode - g / gp
        x_next = jnp.where(use_saha, x_H_saha_i, jnp.clip(x_ode, 0.0, 1.0))

        # -- T_m: linear ODE T' = -2T + A (T_g - T); CN exactly, attractor
        # branch when the Compton coupling is tight (A >> 1)
        A0 = compton_rate(x_H + xhe_e0, i - 1)
        A1 = compton_rate(x_next + xhe_e1, i)
        denom = 1.0 + 0.5 * DLNA * (2.0 + A1)
        T_cn = (T_m * (1.0 - 0.5 * DLNA * (2.0 + A0))
                + 0.5 * DLNA * (A0 * T_gamma[i - 1] + A1 * T_gamma[i])) / denom
        T_attract = T_gamma[i] * (1.0 - 1.0 / jnp.maximum(A1, 2.0))
        T_next = jnp.where(A1 > 50.0, T_attract, T_cn)
        return (x_next, xhe_next, T_next), (x_next, xhe_next, T_next)

    init = (x_H_saha[0], f_He * u_HeII[0], T_gamma[0])
    (_, _, _), (x_H_tab, xhe_tab, T_m_tab) = jax.lax.scan(
        step, init, jnp.arange(1, N_GRID), unroll=UNROLL)
    x_H_tab = jnp.concatenate([jnp.array([init[0]]), x_H_tab])
    xhe_tab = jnp.concatenate([jnp.array([init[1]]), xhe_tab])
    T_m_tab = jnp.concatenate([jnp.array([init[2]]), T_m_tab])

    x_He_e = jnp.where(v_HeIII > 1e-6, f_He * (1.0 + v_HeIII), xhe_tab)
    x_e_rec = x_H_tab + x_He_e  # electrons per H, recombination only

    # ---- reionization: CAMB-style tanh in y = (1+z)^{3/2} for H + HeII,
    # plus helium SECOND reionization (HeII -> HeIII) as its own tanh at
    # z = 3.5, width 0.5 - the CAMB/CLASS reio_camb defaults
    # (helium_fullreio_redshift/width); it adds f_He electrons per H and
    # Delta tau ~ 1e-3, which shapes the EE reionization bump at l ~ 10-40.
    x_e_full_ion = 1.0 + f_He  # H + singly reionized He
    HE2_Z, HE2_DZ = 3.5, 0.5

    W_He2 = 0.5 * (1.0 + jnp.tanh((HE2_Z - z) / HE2_DZ))

    def x_e_with_reio(zre):
        y = (1.0 + z) ** 1.5
        y_re = (1.0 + zre) ** 1.5
        dy = 1.5 * jnp.sqrt(1.0 + zre) * reionization_width
        W = 0.5 * (1.0 + jnp.tanh((y_re - y) / dy))
        return (x_e_rec + jnp.maximum(x_e_full_ion - x_e_rec, 0.0) * W
                + f_He * W_He2)

    # trapezoid weights for integrals d(lna) on the uniform grid
    def _cum_from_today(integrand):
        """tau(lna_i) = int_{lna_i}^{0} integrand d lna (reverse cumulative
        trapezoid; last entry 0)."""
        seg = 0.5 * (integrand[1:] + integrand[:-1]) * DLNA
        rev = jnp.concatenate([jnp.cumsum(seg[::-1])[::-1], jnp.zeros(1)])
        return rev

    # d tau = kappa' d eta = (n_e sigma_T c / H_s) d lna
    def _dtau_dlna(x_e):
        return x_e * n_H * sigma_thomson * constants.c / H_s

    def _total(integrand):
        return jnp.sum(0.5 * (integrand[1:] + integrand[:-1])) * DLNA

    if z_reio is None:
        target = 0.06 if tau_reio is None else tau_reio

        def excess(zre):
            return _total(_dtau_dlna(x_e_with_reio(zre) - x_e_rec)) - target

        z_reio = bisect(excess, limits=(1.0, 40.0), xtol=1e-8, method='bisection')
        tau_reio = target
    x_e_tab = x_e_with_reio(z_reio)
    if tau_reio is None:
        tau_reio = _total(_dtau_dlna(x_e_tab - x_e_rec))

    tau_tab = _cum_from_today(_dtau_dlna(x_e_tab))
    kappa_prime = x_e_tab * n_H * sigma_thomson * _MPC * a  # 1/Mpc (conformal)

    # drag depth: d tau_d = kappa'/R d eta, R = 3 rho_b / (4 rho_gamma)
    # = (3 omega_b / 4 omega_g) a with omega_g from T_cmb
    omega_g = (T_cmb ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
               / constants.rho_crit_over_kgph_per_mph3)
    R = (3.0 * omega_b / (4.0 * omega_g)) * a
    tau_drag_tab = _cum_from_today(_dtau_dlna(x_e_tab) / R)

    # ---- crossing redshifts: tau is strictly decreasing in lna, and the
    # z > 50 restriction (a STATIC slice - the grid is static) keeps us off
    # the reionization plateau, so interpolate lna against -ln(tau)
    def crossing_z(tab, target):
        logt = jnp.log(tab[_HIZ_SLICE])
        lna_cross = jnp.interp(-jnp.log(target), -logt, lna[_HIZ_SLICE])
        return 1.0 / jnp.exp(lna_cross) - 1.0

    z_star = crossing_z(tau_tab, 1.0)
    z_drag = crossing_z(tau_drag_tab, 1.0)
    # optical depth excluding reionization crossing 1 <=> total = 1 + tau_reio
    z_star_noreion = crossing_z(tau_tab, 1.0 + tau_reio)

    return ThermodynamicsResult(
        lna=lna, z_grid=z, x_e=x_e_tab, x_e_rec=x_e_rec, T_m=T_m_tab,
        kappa_prime=kappa_prime, tau=tau_tab, tau_drag=tau_drag_tab,
        z_star=z_star, z_drag=z_drag, z_star_noreion=z_star_noreion,
        tau_reio=tau_reio, z_reio=z_reio, YHe=Y, f_He=f_He, n_H0=n_H0)

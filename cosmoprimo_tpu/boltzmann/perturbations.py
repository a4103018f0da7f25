"""Linear cosmological perturbations, natively traced (Ma-Bertschinger).

Solves the Einstein-Boltzmann system in the conformal Newtonian gauge
(Ma & Bertschinger 1995, ApJ 455, 7: metric eqs 23, fluids eqs 29-30/66,
photon/neutrino hierarchies eqs 63-64 incl. polarization, massive-neutrino
momentum hierarchy eqs 56-58, adiabatic initial conditions eq 98) for the
matter transfer functions and linear power spectrum - the quantities the
reference can only obtain from external CLASS/CAMB builds.

Architecture (no adaptive stepping, no data-dependent shapes):

- k-modes ride the LANE axis: the state is one (n_state, nk) f64 array and
  every operation is elementwise over k or a static slice over the state
  axis; a batch of cosmologies vmaps on a leading axis.
- Each k-mode gets its own FIXED-LENGTH time grid (two `lax.scan`s of
  static length), with steps distributed by integrating a per-k step
  density on a master grid: acoustic-phase sampling (deta <= alpha/k),
  log-conformal-time sampling (deta <= beta eta), and an explicit-
  stability band (deta <= 2.24/kappa') that switches on only where tight
  coupling has been released. The density integral -> grid inversion is
  closed-form interpolation - computed once, outside the scans.
- Stiff regimes are algebraic, not adaptive: first-order tight-coupling
  (slip + 32/45 polarization-corrected shear) while kappa' > 50 max(k, aH),
  and radiation streaming (delta_g = -4 psi, theta_g = 3 phi') after
  decoupling once k eta > 45, with the massive neutrinos dropped to an
  adiabatic viscous fluid. Regime changes are per-(step, k) `jnp.where`
  blends on a static graph.
- Outputs at requested redshifts are harvested inside the scans by
  per-step linear blending (no grid alignment constraints).

Normalization: comoving curvature R = 1 via MB95's C = 1/2 (the identity
R = 2C holds exactly for the eq-98 adiabatic set, independent of the
neutrino fraction). Transfers are converted to the CDM-comoving
(synchronous/CAMB) gauge for comparison with CLASS output:
delta^syn_i = delta^N_i + 3 aH (1+w_i) theta_c / k^2.

Validation: tests/test_perturbations.py anchors the transfer functions and
P(k)/P_cb(k) against the CLASS v3.1.1 outputs archived by the reference
(tests/fiducial/abacus_cosm000_*_tk.dat / _pk.dat at z = 0, 1, 3, 7, 49).
"""

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..ops.quadrature import gauss_laguerre_nodes
from . import thermodynamics as _thermo

import os as _os

# hierarchy truncations (CLASS-like defaults; env-overridable for
# convergence studies - the state layout below derives from these, so they
# are import-time constants)
LMAX_G = int(_os.environ.get('NATIVE_LMAX_G', '11'))    # photon temperature
LMAX_POL = int(_os.environ.get('NATIVE_LMAX_POL', '11'))  # photon polarization
LMAX_UR = int(_os.environ.get('NATIVE_LMAX_UR', '17'))  # massless neutrinos
LMAX_NCDM = 8      # massive neutrinos: Psi_0..Psi_LMAX_NCDM per q-bin
NQ_NCDM = 5        # Gauss-Laguerre momentum bins

N_STEPS_A = 10240  # full-hierarchy phase
N_STEPS_B = 6144   # streaming phase (ncdm acoustic band needs ~5k at k = 7/Mpc)
M_TAB = 8192       # uniform-ln(eta) coefficient tables

ALPHA_PHASE = 0.5  # deta <= ALPHA/k   (~22 samples per acoustic cycle)
BETA_LN = 0.004    # deta <= BETA eta
KAPPA_SAFE = 0.45  # deta <= KAPPA_SAFE * 2.8 / kappa' in the release band
# Tight coupling while kappa' > TRIGGER_AH * aH AND kappa' > TRIGGER_K * k.
# The two branches were tuned SEPARATELY against the no-TCA stiff-BDF
# oracle (scripts/dev_ee_oracle.py, dev_oracle_sources.py):
# - aH branch 120 (not the CLASS-like 50): for low k the first-order TCA
#   quadrupole is ~3% low at release and the hierarchy needs the extra
#   time to relax Pi before the visibility peak (E-source amplitude bias
#   1.033 -> 1.0003; EE trough l ~ 20-45 was +7% in Cl). Costs ~10-30
#   extra kappa'-resolved steps per lane.
# - k branch 50: for k >~ 0.1/Mpc a LONGER explicit stiff stretch is
#   counterproductive - the kappa'-limited RK4 steps accumulate a
#   relaxation deficit (sources -2.2% g-weighted at k = 0.18 with 120 vs
#   -1.1% with 50; TT at l = 2500 regressed -1.7% -> -4.1%).
TCA_TRIGGER_AH = 120.0
TCA_TRIGGER_K = 50.0
RSA_KETA = 45.0    # streaming once k eta > 45 and eta > eta(z~900)
POISSON_KAH = 2.5  # pin phi to the Poisson constraint where k > POISSON_KAH * aH

# lax.scan unroll for the hierarchy integration (env knob kept for
# studies; not yet measured on the GPU).
UNROLL = int(_os.environ.get('NATIVE_UNROLL_PERT', '1'))

_C_KMS = constants.c / 1e3


def steps_for_kmax(kmax_mpc):
    """Step/table budget (n_steps_a, n_steps_b, m_tab) for a STATIC kmax
    [1/Mpc]. The per-k grids distribute a fixed budget along the step
    density, so the required budget scales with the highest k: measured
    stability anchors (scripts/dev_steps_opt.py + stress probes) are
    2048/768 at k = 0.67/Mpc, 6144/3072 at 3.4/Mpc, 10240/6144 at
    6.7/Mpc (the phase-B floor is the semi-relativistic ncdm acoustic
    band); the tiers below carry ~25% margin over those."""
    kmax_mpc = float(kmax_mpc)
    if kmax_mpc <= 0.9:
        return 2560, 1280, 4096
    if kmax_mpc <= 3.6:
        return 8192, 4096, 8192
    return N_STEPS_A, N_STEPS_B, M_TAB

# state layout (per k): see _unpack
_I_PHI, _I_DC, _I_TC, _I_DB, _I_TB, _I_DG, _I_TG = 0, 1, 2, 3, 4, 5, 6
_I_DDE, _I_TDE = 7, 8          # dark-energy fluid delta, theta (CLP, cs2_fld)
_I_FG = 9                      # F_gamma_2 .. F_gamma_LMAX_G   (LMAX_G-1)
_I_GP = _I_FG + (LMAX_G - 1)   # G_0 .. G_LMAX_POL             (LMAX_POL+1)
_I_UR = _I_GP + (LMAX_POL + 1)  # F_ur_0 .. F_ur_LMAX_UR       (LMAX_UR+1)
_I_NC = _I_UR + (LMAX_UR + 1)  # Psi_{s,q,l}: NS * NQ * (LMAX_NCDM+1)


def _n_state(ns):
    """State length for ``ns`` massive-neutrino species (each species
    carries its own NQ_NCDM x (LMAX_NCDM+1) momentum hierarchy; the number
    of species is a static shape, so each distinct ns compiles its own
    graph)."""
    return _I_NC + ns * NQ_NCDM * (LMAX_NCDM + 1)


N_STATE = _n_state(1)  # single-species layout (the common case)


def _ncdm_q():
    """Gauss-Laguerre q-grid and Fermi-Dirac weights. Integrals of
    g(q) f0(q) over q use sum(w_fd * g(q_i)) with w_fd = w_i e^{q_i} f0.

    dlnf0 is RESCALED so the discrete quadrature satisfies the
    integration-by-parts identity int q^4 f0' dq = -4 int q^3 f0 dq
    exactly: the identity ties the hierarchy's metric sources (which carry
    dlnf0) to the background (1+w), and a quadrature-level violation is a
    persistent source inconsistency that the superhorizon phi'
    cancellation amplifies into a growing transfer-function error."""
    q, w = gauss_laguerre_nodes(NQ_NCDM)
    f0 = 1.0 / (np.exp(q) + 1.0)
    w_fd = w * np.exp(q) * f0
    dlnf0 = -q / (1.0 + np.exp(-q))          # dln f0 / dln q
    scale = -4.0 * np.sum(w_fd * q ** 3) / np.sum(w_fd * q ** 3 * dlnf0)
    dlnf0 = dlnf0 * scale
    return (jnp.asarray(q), jnp.asarray(w_fd), jnp.asarray(dlnf0))


def build_tables(params, thermo, m_tab=None):
    """Uniform-ln(eta) coefficient tables for the integration.

    ``params``: dict with omega_b, omega_cdm, h, T_cmb, N_ur, m_ncdm (a
    scalar or an array of per-species masses in eV, all at the same
    temperature; 0 for none), T_ncdm_over_cmb, w0_fld, wa_fld.
    ``thermo``: ThermodynamicsResult (kappa', T_m on its ln a grid).
    """
    if m_tab is None:
        m_tab = M_TAB
    h = params['h']
    T_cmb = params['T_cmb']
    omega_g = (T_cmb ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
               / constants.rho_crit_over_kgph_per_mph3)
    omega_ur = params['N_ur'] * 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0) * omega_g
    omega_b = params['omega_b']
    omega_c = params['omega_cdm']

    # master ln a grid, extended to a = 1e-9 for high-k initial conditions
    lna = jnp.asarray(np.linspace(np.log(1e-9), 0.0, 2 * m_tab + 1))
    a = jnp.exp(lna)

    # ncdm energy/pressure on the SAME 5-point GL grid as the evolution.
    # Several species (equal temperature, possibly distinct masses) sum
    # their phase-space integrals: with a common T the per-species density
    # normalization is one global constant, so I_rho/I_rho0 aggregates
    # exactly across the mass spectrum.
    q, w_fd, _ = _ncdm_q()
    T_ncdm_eV = (params['T_ncdm_over_cmb'] * T_cmb) * 8.617333262e-5  # K -> eV
    am = jnp.atleast_1d(jnp.asarray(params['m_ncdm'])) / T_ncdm_eV    # (NS,) a m / T0
    eps = jnp.sqrt(q[None, None, :] ** 2
                   + (a[:, None, None] * am[None, :, None]) ** 2)     # (n, NS, NQ)
    I_rho = jnp.sum(w_fd * q ** 2 * eps, axis=(-2, -1))               # (n,)
    I_p = jnp.sum(w_fd * q ** 4 / eps, axis=(-2, -1)) / 3.0
    I_rho0 = I_rho[-1]
    has_ncdm = jnp.sum(am) > 0
    omega_nc0 = params.get('omega_ncdm', 0.0)

    # omega_i(a) = Omega_i(a) h^2 a^4-scaled; all relative to rho_crit0
    om_g = omega_g / a ** 4
    om_ur = omega_ur / a ** 4
    om_c = omega_c / a ** 3
    om_b = omega_b / a ** 3
    # spatial curvature: enters the expansion rate (om_k below) and the
    # Einstein constraints through K = -omega_k (H0/c)^2 [Mpc^-2] (open
    # Omega_k > 0 <-> K < 0); it is GEOMETRY, not a density, so it stays
    # out of the source fractions f_i = rho_i / rho_tot
    omega_kc = params.get('omega_k', 0.0)
    K_curv = -omega_kc * (100.0 / _C_KMS) ** 2
    om_nc = jnp.where(has_ncdm, omega_nc0 * (I_rho / I_rho0) / a ** 4, 0.0)
    om_nc_p = jnp.where(has_ncdm, omega_nc0 * (I_p / I_rho0) / a ** 4, 0.0)
    w0, wa = params['w0_fld'], params['wa_fld']
    omega_de0 = (h ** 2 - omega_kc - omega_g - omega_ur - omega_c - omega_b
                 - jnp.where(has_ncdm, omega_nc0, 0.0))
    om_de = omega_de0 * a ** (-3.0 * (1.0 + w0 + wa)) * jnp.exp(3.0 * wa * (a - 1.0))
    om_tot = om_g + om_ur + om_c + om_b + om_nc + om_de  # densities only

    # conformal Hubble, 1/Mpc; Hc^2 + K = (8 pi G / 3) a^2 rho_tot exactly
    Hc = a * 100.0 * jnp.sqrt(om_tot + omega_kc / a ** 2) / _C_KMS

    # conformal time eta(ln a): d eta = d ln a / Hc; radiation-era start value
    deta = 1.0 / Hc
    eta = jnp.concatenate([jnp.zeros(1),
                           jnp.cumsum(0.5 * (deta[1:] + deta[:-1]) * (lna[1] - lna[0]))])
    eta = eta + 1.0 / Hc[0]

    # kappa' and baryon temperature from the thermodynamics grid; analytic
    # fully-ionized extension below its a = 1e-8 start
    lna_th = jnp.asarray(_thermo.LNA_GRID)
    kp_th = thermo.kappa_prime
    xe_early = 1.0 + 2.0 * thermo.f_He
    kp_early = xe_early * thermo.n_H0 * _thermo.sigma_thomson * constants.megaparsec_over_m / jnp.exp(lna) ** 2
    kp = jnp.where(lna >= lna_th[0], jnp.interp(lna, lna_th, kp_th), kp_early)
    T_m = jnp.where(lna >= lna_th[0], jnp.interp(lna, lna_th, thermo.T_m), T_cmb / a)
    # baryon sound speed^2: (k_B T / mu m_H c^2)(1 - dlnT/dlna / 3)
    mu_mH = (1.0 + _thermo.not4 * thermo.f_He) / (1.0 + thermo.f_He + jnp.interp(lna, lna_th, thermo.x_e))
    dlnT = jnp.gradient(jnp.log(T_m)) / (lna[1] - lna[0])
    cb2 = (constants.Boltzmann * T_m / (mu_mH * _thermo.m_hydrogen * constants.c ** 2)
           * (1.0 - dlnT / 3.0))

    # resample everything on a uniform ln(eta) grid
    lneta_m = jnp.log(eta)
    lneta = jnp.linspace(lneta_m[0], lneta_m[-1], m_tab)

    def res(x):
        return jnp.interp(lneta, lneta_m, x)

    w_nc = jnp.where(om_nc > 0, om_nc_p / jnp.maximum(om_nc, 1e-300), 0.0)
    dw = jnp.gradient(w_nc) / (lna[1] - lna[0])
    tabs = {
        'lneta0': lneta[0], 'dlneta': lneta[1] - lneta[0], 'lneta': lneta,
        'lna': res(lna), 'Hc': res(Hc), 'kp': res(kp), 'cb2': res(cb2),
        'fg': res(om_g / om_tot), 'fur': res(om_ur / om_tot),
        'fc': res(om_c / om_tot), 'fb': res(om_b / om_tot),
        'fnc': res(om_nc / om_tot), 'fde': res(om_de / om_tot),
        'w_nc': res(w_nc), 'dw_nc': res(dw),
        'w_de': w0 + wa * (1.0 - res(jnp.exp(lna))),
        'I_rho_ratio': res(I_rho / I_rho0),
        'eta0': eta[-1], 'eta_ini_min': eta[0] * 1.05, 'am': am,
        'wa_fld': wa, 'cs2_fld': params.get('cs2_fld', 1.0), 'K': K_curv,
        # latest allowed start: a = 1e-7, where the matter fraction is
        # ~3e-4. The MB95 adiabatic set assumes aH eta = 1 (pure RD);
        # starting at a = 1e-5 (matter ~3%) shifts the conserved comoving
        # curvature by several percent and every transfer with it.
        'eta_rd': jnp.interp(jnp.log(1e-7), lna, eta),
    }
    # stack the per-step fetch targets into one (Q, M) table. POSITIVE
    # quantities are stored as ln(x): they are exponential-like in ln(eta),
    # so linear interpolation of the log removes the systematic convexity
    # bias of direct interpolation - which the near-cancellation in the
    # superhorizon phi' (|phi'| ~ 1e-2 Hc psi) amplifies ~100x and, left
    # in, dragged the large-scale transfers ~10% off CLASS.
    rows = []
    for n in _STACK_NAMES:
        if n in _LOG_NAMES:
            rows.append(jnp.log(jnp.maximum(tabs[n], 1e-300)))
        else:
            rows.append(tabs[n])
    tabs['stack'] = jnp.stack(rows)
    return tabs


_STACK_NAMES = ('lna', 'Hc', 'kp', 'cb2', 'fg', 'fur', 'fc', 'fb', 'fnc',
                'fde', 'w_nc', 'dw_nc', 'w_de')
_LOG_NAMES = frozenset(('Hc', 'kp', 'cb2', 'fg', 'fur', 'fc', 'fb', 'fnc', 'fde'))
_LOG_MASK = np.array([n in _LOG_NAMES for n in _STACK_NAMES])[:, None]


def _fetch(tabs, eta):
    """Interpolate the stacked coefficient table at (possibly per-k) eta.
    Uniform ln(eta) grid -> pure index arithmetic, no searchsorted;
    log-stored rows are exponentiated back."""
    x = (jnp.log(eta) - tabs['lneta0']) / tabs['dlneta']
    i = jnp.clip(x.astype(jnp.int32), 0, tabs['stack'].shape[1] - 2)
    w = jnp.clip(x - i, 0.0, 1.0)
    s = tabs['stack']
    vals = s[:, i] * (1.0 - w) + s[:, i + 1] * w
    vals = jnp.where(jnp.asarray(_LOG_MASK), jnp.exp(vals), vals)
    out = dict(zip(_STACK_NAMES, vals))
    out['wa_fld'] = tabs['wa_fld']      # scalars the DE fluid needs
    out['cs2_fld'] = tabs['cs2_fld']
    out['K'] = tabs['K']                # spatial curvature [Mpc^-2]
    return out


def build_time_grids(tabs, k, n_steps_a=None, n_steps_b=None):
    """Per-k integration grids: (eta_i, deta_i) arrays for both phases.

    Step density on the master grid: rho = max(k/ALPHA, 1/(BETA eta),
    kappa'/(2.8 KAPPA_SAFE) where tight coupling is off). The cumulative
    density s(eta) maps a uniform index grid onto eta via interpolation.
    """
    if n_steps_a is None:
        n_steps_a = N_STEPS_A
    if n_steps_b is None:
        n_steps_b = N_STEPS_B
    eta_m = jnp.exp(tabs['lneta'])
    kpm, Hcm = tabs['kp'], tabs['Hc']
    eta0 = tabs['eta0']
    k = k[:, None]                                     # (nk, 1)
    tca_off = ((kpm[None, :] < TCA_TRIGGER_AH * Hcm[None, :])
               | (kpm[None, :] < TCA_TRIGGER_K * k))
    dens = jnp.maximum(k / ALPHA_PHASE, 1.0 / (BETA_LN * eta_m)[None, :])
    dens = jnp.maximum(dens, jnp.where(tca_off, kpm[None, :] / (2.8 * KAPPA_SAFE), 0.0))
    seg = 0.5 * (dens[:, 1:] + dens[:, :-1]) * jnp.diff(eta_m)[None, :]
    s = jnp.concatenate([jnp.zeros((k.shape[0], 1)), jnp.cumsum(seg, axis=1)], axis=1)

    eta_ini = jnp.clip(0.03 / k[:, 0], tabs['eta_ini_min'], tabs['eta_rd'])
    eta_dec = jnp.interp(jnp.log(1.0 / 901.0), tabs['lna'], eta_m)  # eta(z=900)
    eta_Aend = jnp.clip(RSA_KETA / k[:, 0], eta_dec, eta0)

    def s_of(eta_q):
        return jax.vmap(jnp.interp)(eta_q, jnp.broadcast_to(eta_m, (eta_q.shape[0], eta_m.shape[0])), s)

    s_ini, s_end = s_of(eta_ini), s_of(eta_Aend)
    idx = jnp.linspace(0.0, 1.0, n_steps_a + 1)
    s_grid = s_ini[:, None] + (s_end - s_ini)[:, None] * idx[None, :]
    eta_A = jax.vmap(jnp.interp)(s_grid, s, jnp.broadcast_to(eta_m, s.shape))  # (nk, N+1)

    # phase B: ln-eta sampling PLUS the massive-neutrino acoustic phase -
    # the fluid is still semi-relativistic at handoff (c_g^2 ~ 0.2) and its
    # k sqrt(c_g^2) oscillation must stay inside the RK4 stability disc
    w_nc = tabs['w_nc']
    cg2m = jnp.maximum(w_nc - tabs['dw_nc'] / (3.0 * (1.0 + w_nc)), 0.0)
    densB = jnp.maximum(1.0 / (BETA_LN * eta_m)[None, :],
                        k * jnp.sqrt(cg2m)[None, :] / 2.4)
    segB = 0.5 * (densB[:, 1:] + densB[:, :-1]) * jnp.diff(eta_m)[None, :]
    sB = jnp.concatenate([jnp.zeros((k.shape[0], 1)), jnp.cumsum(segB, axis=1)], axis=1)
    sB_ini, sB_end = (jax.vmap(jnp.interp)(x, jnp.broadcast_to(eta_m, sB.shape), sB)
                      for x in (eta_Aend, jnp.broadcast_to(eta0 * (1.0 + 1e-9), eta_Aend.shape)))
    idxB = jnp.linspace(0.0, 1.0, n_steps_b + 1)
    sB_grid = sB_ini[:, None] + (sB_end - sB_ini)[:, None] * idxB[None, :]
    eta_B = jax.vmap(jnp.interp)(sB_grid, sB, jnp.broadcast_to(eta_m, sB.shape))
    eta_B = jnp.minimum(eta_B, eta0 * (1.0 + 1e-9))
    return eta_A, eta_B, eta_ini


def adiabatic_ics(tabs, k, eta_ini):
    """MB95 eq. 98 adiabatic initial conditions with C = 1/2 (=> comoving
    curvature R = 1 exactly)."""
    c = _fetch(tabs, eta_ini)
    frad = c['fg'] + c['fur'] + c['fnc']
    Rnu = (c['fur'] + c['fnc']) / frad
    # leading curvature corrections (dynamically K/Hc^2 ~ a^2 is negligible
    # this early, but the K/k^2 geometry factors are time-independent):
    # sigma_nu grows as F2' = (2/5) k s_2 F1 and the stress constraint
    # carries (k^2 - 3K)(phi - psi); both reduce to MB95 when flat
    s2 = _s_l(2, tabs['K'], k)
    s2sq = 1.0 - 3.0 * jnp.minimum(tabs['K'] / k ** 2, _R_CLOSED_MAX)
    r_str = s2 / s2sq
    C = 0.5
    psi = 20.0 * C / (15.0 + 4.0 * r_str * Rnu)
    phi = (1.0 + 2.0 / 5.0 * r_str * Rnu) * psi
    dg = -2.0 * psi
    # the "eta" of the MB95 series is the RADIATION-ERA conformal time,
    # i.e. 1/(aH) - NOT the literal eta(a) of the real background. With
    # matter contamination f_m, aH eta_true = 1 + f_m/2, and using
    # eta_true here injects a FIXED-amplitude neutrino/matter velocity
    # isocurvature admixture (the f_m(a_ini) offset is amplified ~1/f_m by
    # its RD growth, so it does not converge away with earlier starts):
    # measured +10% on every transfer function. 1/(aH) converges.
    eta_rd_ic = 1.0 / c['Hc']
    th = 0.5 * (k ** 2 * eta_rd_ic) * psi
    # sigma_nu = (k eta)^2 psi / 15: the unique value consistent with BOTH
    # the l=2 hierarchy growth (F2' = 2k F1/5, F1 = 2 k eta psi/3) and the
    # anisotropic-stress constraint phi = (1 + 2 R_nu/5) psi. An
    # inconsistent sigma_nu here (e.g. the (phi+psi)/30 variant, 8% high)
    # seeds the same growing contamination.
    sig_nu = s2 * (k * eta_rd_ic) ** 2 / 15.0 * psi

    ns = tabs['am'].shape[0]
    y = jnp.zeros((_n_state(ns), k.shape[0]))
    y = y.at[_I_PHI].set(phi)
    y = y.at[_I_DC].set(0.75 * dg)
    y = y.at[_I_TC].set(th)
    y = y.at[_I_DB].set(0.75 * dg)
    y = y.at[_I_TB].set(th)
    y = y.at[_I_DG].set(dg)
    y = y.at[_I_TG].set(th)
    # dark-energy fluid, adiabatic: delta_i = (3/4)(1+w_i) delta_g,
    # common velocity (negligible at a ~ 1e-9-1e-7, but consistent)
    w_de_ini = c['w_de']
    y = y.at[_I_DDE].set(0.75 * (1.0 + w_de_ini) * dg)
    y = y.at[_I_TDE].set(th)
    # massless neutrinos: F0 = dg, F1 = 4 theta/(3k), F2 = 2 sigma
    y = y.at[_I_UR + 0].set(dg)
    y = y.at[_I_UR + 1].set(4.0 * th / (3.0 * k))
    y = y.at[_I_UR + 2].set(2.0 * sig_nu)
    # ncdm: Psi_0 = -(delta/4) dlnf0, Psi_1 = -(eps/(3qk)) theta dlnf0,
    #       Psi_2 = -(sigma/2) dlnf0
    q, _, dlnf0 = _ncdm_q()
    a_ini = jnp.exp(jnp.interp(jnp.log(eta_ini), tabs['lneta'], tabs['lna']))
    for s in range(ns):
        eps = jnp.sqrt(q[:, None] ** 2 + (a_ini[None, :] * tabs['am'][s]) ** 2)  # (NQ, nk)
        for j in range(NQ_NCDM):
            base = _I_NC + (s * NQ_NCDM + j) * (LMAX_NCDM + 1)
            y = y.at[base + 0].set(-0.25 * dg * dlnf0[j])
            y = y.at[base + 1].set(-(eps[j] / (3.0 * q[j] * k)) * th * dlnf0[j])
            y = y.at[base + 2].set(-0.5 * sig_nu * dlnf0[j])
    return y


def _ncdm_moments(y, a, am):
    """delta, (1+w)theta/k, (1+w)sigma of the combined massive sector from
    the momentum hierarchies (ratios of GL integrals; MB95 eq 55). With a
    common temperature the species aggregate exactly: every integral is
    summed over the mass spectrum before taking the ratio."""
    q, w_fd, _ = _ncdm_q()
    ns = am.shape[0]
    eps = jnp.sqrt(q[None, :, None] ** 2 + (a[None, None, :] * am[:, None, None]) ** 2)  # (NS, NQ, nk)
    psi = y[_I_NC:_I_NC + ns * NQ_NCDM * (LMAX_NCDM + 1)]
    psi = psi.reshape(ns, NQ_NCDM, LMAX_NCDM + 1, -1)
    w2 = w_fd[None, :, None] * q[None, :, None] ** 2
    I_rho = jnp.sum(w2 * eps, axis=(0, 1))
    delta = jnp.sum(w2 * eps * psi[:, :, 0], axis=(0, 1)) / I_rho
    # (rho+p) theta / rho = k * int q^3 f0 Psi_1 / int q^2 eps f0
    opw_theta_over_k = jnp.sum(w2 * q[None, :, None] * psi[:, :, 1], axis=(0, 1)) / I_rho
    opw_sigma = (2.0 / 3.0) * jnp.sum(w2 * q[None, :, None] ** 2 / eps * psi[:, :, 2], axis=(0, 1)) / I_rho
    return delta, opw_theta_over_k, opw_sigma


def _curv(c, k):
    """Curvature helpers for the Einstein constraints (Hu & Eisenstein
    1998 curved longitudinal-gauge equations; flat: K = 0, all three
    reduce to the MB95 forms):

    - ``G2 = Hc^2 + K = (8 pi G / 3) a^2 rho_tot`` - the gravitational
      normalization (4 pi G a^2 rho_i = 1.5 G2 f_i);
    - ``s2sq = 1 - 3K/k^2`` - the (k^2 - 3K)/k^2 factor of the comoving
      Poisson equation and of the anisotropic-stress constraint
      (k^2 - 3K)(phi - psi) = 12 pi G a^2 (rho+p) sigma;
    - ``s_l(l) = sqrt(1 - (l^2-1) K/k^2)`` - the radial (hyperspherical)
      coupling factors of the free-streaming hierarchies.

    The curvature RATIO K/k^2 is saturated at _R_CLOSED_MAX for closed
    models: modes at/below the curvature scale (k^2 <~ 3K) have no
    discrete eigenmode, and letting the 1/s2sq stress amplifier grow
    there turns the F2 <-> psi loop into a numerical instability
    (measured: sigma8 ~ 1e10 for Omega_k = -0.05 with a loose clamp).
    Saturating the ratio - consistently across s2sq and every s_l -
    keeps those (never-served) lanes stable and bounded."""
    K = c['K']
    G2 = c['Hc'] ** 2 + K
    s2sq = 1.0 - 3.0 * jnp.minimum(K / k ** 2, _R_CLOSED_MAX)
    return K, G2, s2sq


_R_CLOSED_MAX = 0.2  # bound on K/k^2 (closed); open (K < 0) is unclamped


def _s_l(l, K, k):
    """sqrt(1 - (l^2 - 1) K / k^2), the curved hierarchy coupling; zero
    (tower decoupled) where closed-space geometry cuts the multipole off."""
    r = jnp.minimum(K / k ** 2, _R_CLOSED_MAX)
    return jnp.sqrt(jnp.maximum(1.0 - (l * l - 1.0) * r, 0.0))


def _s_table(L, K, k):
    """Stacked s_l couplings for l = 0..L+1: (L+2, nk), one fused op for a
    whole hierarchy ladder (see deriv_full)."""
    l = jnp.arange(L + 2, dtype=k.dtype)[:, None]
    r = jnp.minimum(K / k ** 2, _R_CLOSED_MAX)
    return jnp.sqrt(jnp.maximum(1.0 - (l * l - 1.0) * r[None, :], 0.0))


def _metric(y, k, eta, c, am):
    """psi and phi' from the constraints (shared by deriv_full and the
    post-step RSA projection).

    - The slaved photon shear is EXCLUDED from the metric while tight
      coupling holds: its psi contribution is physically O(aH^2 eta/kappa')
      (< 1e-3), but in an explicit scheme it continuously injects velocity
      isocurvature through the superhorizon phi' cancellation (measured
      +60% on phi through equality). It stays in the momentum equations,
      where the Silk-damping physics lives.
    - Massless neutrinos stream (delta_ur = -4 psi, theta_ur = 3 phi',
      sigma_ur = 0) once k eta > 45, CLASS's rsa/ufa role: with
      lmax_ur = 17, keeping the full hierarchy at k eta >> lmax REFLECTS
      free-streaming power back down the tower and pumps spurious metric
      driving through the radiation era (+15% * ln k on the CDM transfer,
      confirmed equation-level by a stiff BDF integration). theta_ur =
      3 phi' makes phi' implicit; the exact solve is one division.
    """
    Hc, kp = c['Hc'], c['kp']
    fg, fur, fc, fb, fnc = c['fg'], c['fur'], c['fc'], c['fb'], c['fnc']
    a = jnp.exp(c['lna'])
    phi, tc, tb, tg = y[_I_PHI], y[_I_TC], y[_I_TB], y[_I_TG]
    Fur = y[_I_UR:_I_UR + (LMAX_UR + 1)]
    tca = (kp > TCA_TRIGGER_AH * Hc) & (kp > TCA_TRIGGER_K * k)
    ur_rsa = (k * eta) > RSA_KETA

    nc_delta, nc_opw_th_k, nc_opw_sig = _ncdm_moments(y, a, am)
    _, G2, s2sq = _curv(c, k)
    G2k2 = G2 / k ** 2
    Fg2_metric = jnp.where(tca, 0.0, y[_I_FG])
    Fur2_metric = jnp.where(ur_rsa, 0.0, Fur[2])
    stress = (2.0 / 3.0) * (fg * Fg2_metric + fur * Fur2_metric) + fnc * nc_opw_sig
    psi = phi - 4.5 * (G2k2 / s2sq) * stress
    tur_full = 0.75 * k * Fur[1]
    Stheta_other = (fc * tc + fb * tb + (4.0 / 3.0) * fg * tg + fnc * k * nc_opw_th_k
                    + c['fde'] * (1.0 + c['w_de']) * y[_I_TDE])
    num = -Hc * psi + 1.5 * G2k2 * (Stheta_other + jnp.where(ur_rsa, 0.0, (4.0 / 3.0) * fur * tur_full))
    phip = jnp.where(ur_rsa, num / (1.0 - 6.0 * G2k2 * fur), num)
    tur = jnp.where(ur_rsa, 3.0 * phip, tur_full)
    return psi, phip, tur, tca, ur_rsa


def deriv_full(y, k, eta, c, am):
    """Time derivative of the full phase-A state (MB95 system), with the
    tight-coupling branch applied per-(k) where kappa' > 50 max(k, aH)."""
    Hc, kp, cb2 = c['Hc'], c['kp'], c['cb2']
    fg, fur, fc, fb, fnc = c['fg'], c['fur'], c['fc'], c['fb'], c['fnc']
    a = jnp.exp(c['lna'])

    phi = y[_I_PHI]
    dc, tc, db, tb, dg, tg = (y[_I_DC], y[_I_TC], y[_I_DB], y[_I_TB], y[_I_DG], y[_I_TG])
    Fg = y[_I_FG:_I_FG + (LMAX_G - 1)]       # F_2..F_LMAX_G
    G = y[_I_GP:_I_GP + (LMAX_POL + 1)]      # G_0..G_LMAX_POL
    Fur = y[_I_UR:_I_UR + (LMAX_UR + 1)]

    psi, phip, tur, tca, ur_rsa = _metric(y, k, eta, c, am)
    K = c['K']
    s2 = _s_l(2, K, k)   # l = 1 <-> 2 radial coupling (1 when flat)
    Fg2 = jnp.where(tca, s2 * (32.0 / 45.0) * tg / kp, Fg[0])
    sig_g = 0.5 * Fg2

    k2psi = k ** 2 * psi

    # --- CDM / baryons
    ddc = -tc + 3.0 * phip
    dtc = -Hc * tc + k2psi
    ddb = -tb + 3.0 * phip
    ddg = -(4.0 / 3.0) * tg + 4.0 * phip

    # --- dark-energy fluid (CLP w0/wa, rest-frame cs2_fld; CLASS 'fld'
    # with use_ppf=no). ca2 enters only through (cs2 - ca2)(1+w) =
    # cs2 (1+w) - [w (1+w) + wa a / 3], which is division-free; the lone
    # 1/(1+w) in theta' is regularized so a w = -1 crossing (or w == -1
    # exactly, where every DE source is weighted by f_de (1+w) -> 0)
    # stays finite.
    w_de, cs2 = c['w_de'], c['cs2_fld']
    a_c = jnp.exp(c['lna'])
    dde, tde = y[_I_DDE], y[_I_TDE]
    opw = 1.0 + w_de
    opw_cs2_m_ca2 = cs2 * opw - (w_de * opw + c['wa_fld'] * a_c / 3.0)
    inv_opw = opw / (opw * opw + 1e-24)
    ddde = (-opw * (tde - 3.0 * phip) - 3.0 * Hc * (cs2 - w_de) * dde
            - 9.0 * Hc ** 2 * opw_cs2_m_ca2 * tde / k ** 2)
    dtde = -Hc * (1.0 - 3.0 * cs2) * tde + cs2 * k ** 2 * dde * inv_opw + k2psi

    R = (4.0 / 3.0) * fg / fb
    # full (post-TCA) momentum equations WITHOUT the Thomson drag: the drag
    # eigenvalue is kappa'(1+R) with R = 4 rho_g/(3 rho_b) ~ 10-20 at the
    # tight-coupling exit - far too stiff for the explicit grid. The drag
    # pair is integrated exactly per step by the ETD map in _drag_etd
    # (V = (theta_b + R theta_g)/(1+R) is drag-invariant; the slip relaxes
    # to its quasi-steady value on e^{-kappa'(1+R) deta}).
    dtb_full = -Hc * tb + cb2 * k ** 2 * db + k2psi
    dtg_full = k ** 2 * (0.25 * dg - s2 * sig_g) + k2psi
    # first-order tight coupling: MB95 eq 74-75
    wtot = (fg + fur) / 3.0 + c['w_nc'] * fnc + c['w_de'] * c['fde']
    # a''/a = Hc' + Hc^2, with Hc' = -0.5 (Hc^2 + K)(1 + 3 wtot)
    aH2_over_a = Hc ** 2 - 0.5 * (Hc ** 2 + K) * (1.0 + 3.0 * wtot)
    slip = ((2.0 * R / (1.0 + R)) * Hc * (tb - tg)
            + (R / (kp * (1.0 + R))) * (-aH2_over_a * tb
                                        - Hc * k ** 2 * (0.5 * dg + psi)
                                        + k ** 2 * (cb2 * ddb - 0.25 * ddg)))
    dtb_tca = (-Hc * tb + cb2 * k ** 2 * db + R * k ** 2 * (0.25 * dg - s2 * sig_g)
               + (1.0 + R) * k2psi + R * slip) / (1.0 + R)
    dtg_tca = dtb_tca - slip
    dtb = jnp.where(tca, dtb_tca, dtb_full)
    dtg = jnp.where(tca, dtg_tca, dtg_full)

    # --- free-streaming hierarchies, VECTORIZED over l (one fused
    # (L, nk) ladder per species instead of per-l Python expressions: the
    # stacked per-l form lowered to ~100 extra tiny kernels per deriv
    # evaluation, each a launch inside the sequential scan step).
    # Ladder: dX_l = pre/(2l+1) (l s_l X_{l-1} - (l+1) s_{l+1} X_{l+1})
    # with s_l = sqrt(1 - (l^2-1) K/k^2) (MB95 flat; CLASS non-flat
    # couplings), the MB95 eq. 65 closure at l = L, and per-l sources
    # added on top. The l = 0, 1 special forms ARE the ladder rows
    # (s_1 = 1) plus their sources, so no branching is needed.
    PI = Fg2 + G[0] + G[2]
    F1 = 4.0 * tg / (3.0 * k)

    # photon temperature l = 2..LMAX_G (rows F_2.. of the state)
    s_g = _s_table(LMAX_G, K, k)
    ells_g = jnp.arange(2.0, LMAX_G + 1.0)[:, None]
    Fg_all = jnp.concatenate([F1[None], Fg], axis=0)  # F_1 .. F_LMAX_G
    closure_g = ((2.0 * LMAX_G + 1.0) / (k * eta)) * Fg_all[-1] - Fg_all[-2]
    Fp_g = jnp.concatenate([Fg_all[2:], closure_g[None]], axis=0)
    # scattering: -kp F_l, with the l = 2 row carrying the polarization
    # feedback -kp (0.9 F_2 - 0.1 (G_0 + G_2))
    scat_g = -kp * Fg_all[1:]
    scat_g = scat_g.at[0].add(kp * (0.1 * Fg_all[1] + 0.1 * (G[0] + G[2])))
    dFg = (k / (2.0 * ells_g + 1.0) * (ells_g * s_g[2:LMAX_G + 1] * Fg_all[:-1]
                                       - (ells_g + 1.0) * s_g[3:LMAX_G + 2] * Fp_g)
           + scat_g)

    # polarization l = 0..LMAX_POL (curved spin-2 couplings approximated by
    # the scalar s_l factors: the difference is O(K/k^2) on a term that
    # only feeds back into P(k) through Silk damping)
    s_p = _s_table(LMAX_POL, K, k)
    ells_p = jnp.arange(0.0, LMAX_POL + 1.0)[:, None]
    Gm = jnp.concatenate([jnp.zeros_like(G[:1]), G[:-1]], axis=0)
    closure_p = ((2.0 * LMAX_POL + 1.0) / (k * eta)) * G[-1] - G[-2]
    Gp = jnp.concatenate([G[1:], closure_p[None]], axis=0)
    src_p = jnp.zeros_like(G).at[0].set(0.5 * PI).at[2].set(0.1 * PI)
    dG = (k / (2.0 * ells_p + 1.0) * (ells_p * s_p[:LMAX_POL + 1] * Gm
                                      - (ells_p + 1.0) * s_p[1:LMAX_POL + 2] * Gp)
          + kp * (-G + src_p))

    # massless neutrinos l = 0..LMAX_UR; sources 4 phi' (l=0), (4/3) k psi
    # (l=1); frozen under RSA (the post-step projection holds the values)
    s_u = _s_table(LMAX_UR, K, k)
    ells_u = jnp.arange(0.0, LMAX_UR + 1.0)[:, None]
    Fm_u = jnp.concatenate([jnp.zeros_like(Fur[:1]), Fur[:-1]], axis=0)
    closure_u = ((2.0 * LMAX_UR + 1.0) / (k * eta)) * Fur[-1] - Fur[-2]
    Fp_u = jnp.concatenate([Fur[1:], closure_u[None]], axis=0)
    src_u = (jnp.zeros_like(Fur).at[0].set(4.0 * phip)
             .at[1].set((4.0 / 3.0) * k * psi))
    dUr = (k / (2.0 * ells_u + 1.0) * (ells_u * s_u[:LMAX_UR + 1] * Fm_u
                                       - (ells_u + 1.0) * s_u[1:LMAX_UR + 2] * Fp_u)
           + src_u)
    dUr = jnp.where(ur_rsa, 0.0, dUr)

    # massive neutrinos: (ns, NQ, L+1, nk) ladder with pre = qe = q k / eps
    q, _, dlnf0 = _ncdm_q()
    ns = am.shape[0]
    Lnc = LMAX_NCDM
    psi_nc = y[_I_NC:].reshape(ns, NQ_NCDM, Lnc + 1, -1)
    eps = jnp.sqrt(q[None, :, None] ** 2
                   + (a[None, None, :] * am[:, None, None]) ** 2)  # (ns, NQ, nk)
    qe = q[None, :, None] * k / eps                                # (ns, NQ, nk)
    s_n = _s_table(Lnc, K, k)                                      # (Lnc+2, nk)
    ells_n = jnp.arange(0.0, Lnc + 1.0)[None, None, :, None]
    Pm = jnp.concatenate([jnp.zeros_like(psi_nc[:, :, :1]), psi_nc[:, :, :-1]], axis=2)
    closure_n = (((2.0 * Lnc + 1.0) * eps / (q[None, :, None] * k * eta))
                 * psi_nc[:, :, Lnc] - psi_nc[:, :, Lnc - 1])      # (ns, NQ, nk)
    Pp = jnp.concatenate([psi_nc[:, :, 1:], closure_n[:, :, None]], axis=2)
    src_n = jnp.zeros_like(psi_nc)
    src_n = src_n.at[:, :, 0].add(-phip[None, None, :] * dlnf0[None, :, None])
    src_n = src_n.at[:, :, 1].add(-(eps * k / (3.0 * q[None, :, None]))
                                  * psi[None, None, :] * dlnf0[None, :, None])
    dNc = (qe[:, :, None] / (2.0 * ells_n + 1.0)
           * (ells_n * s_n[None, None, :Lnc + 1] * Pm
              - (ells_n + 1.0) * s_n[None, None, 1:Lnc + 2] * Pp)
           + src_n).reshape(ns * NQ_NCDM * (Lnc + 1), -1)

    return jnp.concatenate([jnp.stack([phip, ddc, dtc, ddb, dtb, ddg, dtg, ddde, dtde]),
                            dFg, dG, dUr, dNc], axis=0)


def _drag_etd(y0, y1, k, d, cm, c1):
    """Exponential (ETD) update of the photon-baryon Thomson drag over one
    step, applied where tight coupling is off.

    Exact integration of S' = D - kappa'(1+R) S for the slip
    S = theta_b - theta_g (D = the slow forcing, which CANCELS k^2 psi),
    with the drag-invariant V = (theta_b + R theta_g)/(1+R) taken from the
    drag-free RK4 end state: S_new = S_0 e^{-z} + d phi1(z) D_mid,
    phi1(z) = (1-e^{-z})/z. Unconditionally stable, exact in both the
    slaved (z >> 1) and free (z -> 0) limits."""
    kp, Hc, cb2 = cm['kp'], cm['Hc'], cm['cb2']
    R = (4.0 / 3.0) * cm['fg'] / cm['fb']
    lam = kp * (1.0 + R)
    z = lam * d
    e = jnp.exp(-z)
    phi1 = jnp.where(z > 1e-8, -jnp.expm1(-z) / jnp.where(z > 1e-8, z, 1.0), 1.0 - 0.5 * z)

    ym = 0.5 * (y0 + y1)
    sig_m = 0.5 * ym[_I_FG]
    D = -Hc * ym[_I_TB] + cb2 * k ** 2 * ym[_I_DB] - k ** 2 * (0.25 * ym[_I_DG] - sig_m)
    S0 = y0[_I_TB] - y0[_I_TG]
    S_new = S0 * e + d * phi1 * D
    V = (y1[_I_TB] + R * y1[_I_TG]) / (1.0 + R)

    tca = (c1['kp'] > TCA_TRIGGER_AH * c1['Hc']) & (c1['kp'] > TCA_TRIGGER_K * k)
    tb_new = jnp.where(tca, y1[_I_TB], V + R / (1.0 + R) * S_new)
    tg_new = jnp.where(tca, y1[_I_TG], V - 1.0 / (1.0 + R) * S_new)
    y1 = y1.at[_I_TB].set(tb_new)
    y1 = y1.at[_I_TG].set(tg_new)
    return y1


def _ur_rsa_project(y, k, eta, c, am):
    """Hold the massless-neutrino moments at their streaming values where
    k eta > 45 (see _metric): delta_ur = -4 psi, theta_ur = 3 phi',
    F_l >= 2 = 0."""
    psi, phip, tur, _, ur_rsa = _metric(y, k, eta, c, am)
    y = y.at[_I_UR + 0].set(jnp.where(ur_rsa, -4.0 * psi, y[_I_UR + 0]))
    y = y.at[_I_UR + 1].set(jnp.where(ur_rsa, 4.0 * tur / (3.0 * k), y[_I_UR + 1]))
    for l in range(2, LMAX_UR + 1):
        y = y.at[_I_UR + l].set(jnp.where(ur_rsa, 0.0, y[_I_UR + l]))
    return y


def _poisson_project(y, k, eta, c, am):
    """Pin phi to the algebraic Poisson constraint sub-horizon.

    The momentum-constraint ODE for phi is exact but, integrated over the
    ~1e3 acoustic cycles a high-k mode spends in the radiation era, small
    systematic theta-errors pump phi off the energy-constraint surface
    (unpinned: +2.8% on delta_cdm at k = 0.5 h/Mpc, +27% at k = 5, z = 0,
    vs the archived CLASS tables). Combining the (00) and (0i) Einstein
    equations gives the gauge-invariant Poisson form
    k^2 phi = -(3/2) aH^2 [Delta + 3 (aH/k^2) (rho+p)theta/rho],
    algebraic in the fluid state - used where k > POISSON_KAH aH; the ODE
    value is kept superhorizon (where the algebraic form has its own
    catastrophic cancellation).

    POISSON_KAH = 2.5 engages the pin right at horizon entry: the pump
    accrues from entry onward (pin-threshold sweep, scripts/
    dev_pk_toggles*.py / dev_pin_opt.py: 25 -> +1.7% delta_cdm at
    k = 0.5 h/Mpc, 6 -> +0.6%, 2.5 -> <= 0.2% at every k in 0.001-5 and
    z in {0, 1, 49}; hierarchy truncations, step densities, TCA trigger
    and the ETD drag map were each swept and move the excess by < 0.1%).
    Below ~2 the superhorizon cancellation of the algebraic form starts
    to bite (-0.8% at k = 1 h/Mpc by 1.5)."""
    Hc = c['Hc']
    fg, fur, fc, fb, fnc = c['fg'], c['fur'], c['fc'], c['fb'], c['fnc']
    a = jnp.exp(c['lna'])
    psi, phip, tur, tca, ur_rsa = _metric(y, k, eta, c, am)
    nc_delta, nc_opw_th_k, _ = _ncdm_moments(y, a, am)
    dur = jnp.where(ur_rsa, -4.0 * psi, y[_I_UR])
    fde, w_de = c['fde'], c['w_de']
    Delta = (fg * y[_I_DG] + fur * dur + fc * y[_I_DC] + fb * y[_I_DB] + fnc * nc_delta
             + fde * y[_I_DDE])
    Stheta = (fc * y[_I_TC] + fb * y[_I_TB] + (4.0 / 3.0) * (fg * y[_I_TG] + fur * tur)
              + fde * (1.0 + w_de) * y[_I_TDE]
              + fnc * k * nc_opw_th_k)
    # curved comoving Poisson: (k^2 - 3K) phi = -1.5 (Hc^2 + K) [Delta + ...]
    _, G2, s2sq = _curv(c, k)
    phi_p = -1.5 * (G2 / (k ** 2 * s2sq)) * (Delta + 3.0 * Hc / k ** 2 * Stheta)
    return y.at[_I_PHI].set(jnp.where(k > POISSON_KAH * Hc, phi_p, y[_I_PHI]))


def _tca_project(y, k, c):
    """Overwrite the tight-coupling-slaved photon moments with their
    algebraic values where TCA is active (continuous handoff).

    theta_g is SET to theta_b - S_qss rather than integrated: evolving the
    slip as its own ODE through the first-order TCA expression drops the
    -kappa'(1+R) S damping and leaves an artificial S' ~ 2 aH S growing
    mode (~a^2 over the radiation era - order unity by recombination)."""
    kp, Hc = c['kp'], c['Hc']
    tca = (kp > TCA_TRIGGER_AH * Hc) & (kp > TCA_TRIGGER_K * k)
    R = (4.0 / 3.0) * c['fg'] / c['fb']
    s2 = _s_l(2, c['K'], k)
    sig_g = 0.5 * s2 * (32.0 / 45.0) * y[_I_TG] / kp
    D = (-Hc * y[_I_TB] + c['cb2'] * k ** 2 * y[_I_DB]
         - k ** 2 * (0.25 * y[_I_DG] - s2 * sig_g))
    S_qss = D / (kp * (1.0 + R))
    y = y.at[_I_TG].set(jnp.where(tca, y[_I_TB] - S_qss, y[_I_TG]))
    Fg2 = s2 * (32.0 / 45.0) * y[_I_TG] / kp
    y = y.at[_I_FG].set(jnp.where(tca, Fg2, y[_I_FG]))
    y = y.at[_I_GP + 0].set(jnp.where(tca, 1.25 * Fg2, y[_I_GP + 0]))
    y = y.at[_I_GP + 2].set(jnp.where(tca, 0.25 * Fg2, y[_I_GP + 2]))
    sl = slice(_I_FG + 1, _I_FG + (LMAX_G - 1))
    y = y.at[sl].set(jnp.where(tca, 0.0, y[sl]))
    y = y.at[_I_GP + 1].set(jnp.where(tca, 0.0, y[_I_GP + 1]))
    sl = slice(_I_GP + 3, _I_GP + LMAX_POL + 1)
    y = y.at[sl].set(jnp.where(tca, 0.0, y[sl]))
    return y


def _rsa_metric(yB, k, c):
    """psi and phi' of the reduced streaming-phase state (the theta_rad =
    3 phi' closure makes phi' an exact small solve)."""
    Hc = c['Hc']
    fg, fur, fc, fb, fnc = c['fg'], c['fur'], c['fc'], c['fb'], c['fnc']
    w = c['w_nc']
    phi, dc, tc, db, tb, dn, tn, sn, dde, tde = yB
    _, G2, s2sq = _curv(c, k)
    G2k2 = G2 / k ** 2
    psi = phi - 4.5 * (G2k2 / s2sq) * fnc * (1.0 + w) * sn
    src = -Hc * psi + 1.5 * G2k2 * (fc * tc + fb * tb + fnc * (1.0 + w) * tn
                                    + c['fde'] * (1.0 + c['w_de']) * tde)
    phip = src / (1.0 - 6.0 * G2k2 * (fg + fur))
    return psi, phip


def _de_qs_values(psi, phip, k, c):
    """Quasi-static dark-energy fluid values sub-sound-horizon: the
    rest-frame pressure support kills DE clustering, and the balance of
    the theta equation (cs2 k^2 delta/(1+w) + k^2 psi = 0) with delta' = 0
    gives algebraic values bounded by psi. Used (and the ODE frozen)
    where cs k eta > RSA_KETA - the streaming-phase ln-eta grid does not
    resolve the cs ~ 1 sound oscillation there (RK4 would blow up), while
    modes below the threshold advance < 0.2 rad per step and integrate
    stably."""
    w_de, cs2 = c['w_de'], jnp.maximum(c['cs2_fld'], 1e-12)
    dde_qs = -(1.0 + w_de) * psi / cs2
    tde_qs = 3.0 * phip + 3.0 * c['Hc'] * (cs2 - w_de) * psi / cs2
    return dde_qs, tde_qs


def deriv_rsa(yB, k, eta, c, am):
    """Streaming-phase derivative: reduced state (phi, dc, tc, db, tb,
    dn, tn, sn, dde, tde) with radiation algebraic (delta = -4 psi,
    theta = 3 phi'), the massive species as an adiabatic viscous fluid,
    and the dark-energy CLP fluid (as deriv_full; quasi-static and frozen
    sub-sound-horizon, see _de_qs_values)."""
    del am
    Hc, kp, cb2 = c['Hc'], c['kp'], c['cb2']
    fg, fur, fc, fb, fnc = c['fg'], c['fur'], c['fc'], c['fb'], c['fnc']
    w = c['w_nc']
    cg2 = w - c['dw_nc'] / (3.0 * (1.0 + w))
    phi, dc, tc, db, tb, dn, tn, sn, dde, tde = yB
    w_de, cs2 = c['w_de'], c['cs2_fld']
    opw_de = 1.0 + w_de

    psi, phip = _rsa_metric(yB, k, c)
    tg = 3.0 * phip

    k2psi = k ** 2 * psi
    ddc = -tc + 3.0 * phip
    dtc = -Hc * tc + k2psi
    ddb = -tb + 3.0 * phip
    R = (4.0 / 3.0) * fg / fb
    dtb = -Hc * tb + cb2 * k ** 2 * db + k2psi + kp * R * (tg - tb)
    ddn = -(1.0 + w) * (tn - 3.0 * phip) - 3.0 * Hc * (cg2 - w) * dn
    dtn = (-Hc * (1.0 - 3.0 * cg2) * tn + (cg2 / (1.0 + w)) * k ** 2 * dn + k2psi
           - k ** 2 * _s_l(2, c['K'], k) * sn)
    dsn = -3.0 * Hc * sn + _s_l(2, c['K'], k) * (16.0 / 15.0) * (cg2 / (1.0 + w)) * tn
    # dark-energy fluid (same regularized form as deriv_full)
    a_c = jnp.exp(c['lna'])
    opw_cs2_m_ca2 = cs2 * opw_de - (w_de * opw_de + c['wa_fld'] * a_c / 3.0)
    inv_opw = opw_de / (opw_de * opw_de + 1e-24)
    ddde = (-opw_de * (tde - 3.0 * phip) - 3.0 * Hc * (cs2 - w_de) * dde
            - 9.0 * Hc ** 2 * opw_cs2_m_ca2 * tde / k ** 2)
    dtde = -Hc * (1.0 - 3.0 * cs2) * tde + cs2 * k ** 2 * dde * inv_opw + k2psi
    de_qs = (jnp.sqrt(jnp.maximum(cs2, 0.0)) * k * eta) > RSA_KETA
    ddde = jnp.where(de_qs, 0.0, ddde)
    dtde = jnp.where(de_qs, 0.0, dtde)
    return jnp.stack([phip, ddc, dtc, ddb, dtb, ddn, dtn, dsn, ddde, dtde])


def _rk4_scan(deriv, y0, eta_grid, harvest_eta, tabs, k, am, project=None, emit=None):
    """Fixed-step RK4 over per-k grids (eta_grid: (nk, N+1)), harvesting
    linear blends of the state at each harvest_eta ((n_z,) traced scalars).
    Returns final state and (n_z, n_state, nk) harvested states; with
    ``emit`` (a callback (y1, e1, c1) -> (n_emit, nk)) also returns the
    per-step emitted array (N, n_emit, nk) - the line-of-sight source tap."""
    n_z = harvest_eta.shape[0]
    out0 = jnp.zeros((n_z,) + y0.shape)

    def step(carry, xs):
        y, out = carry
        e0, e1 = xs
        d = e1 - e0
        em = 0.5 * (e0 + e1)
        c0, cm, c1 = _fetch(tabs, e0), _fetch(tabs, em), _fetch(tabs, e1)
        k1 = deriv(y, k, e0, c0, am)
        k2 = deriv(y + 0.5 * d * k1, k, em, cm, am)
        k3 = deriv(y + 0.5 * d * k2, k, em, cm, am)
        k4 = deriv(y + d * k3, k, e1, c1, am)
        y1 = y + d / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        if project is not None:
            y1 = project(y, y1, k, d, e1, cm, c1)
        hit = (e0[None, :] <= harvest_eta[:, None]) & (e1[None, :] > harvest_eta[:, None])
        w = jnp.clip((harvest_eta[:, None] - e0[None, :]) / jnp.where(d > 0, d, 1.0)[None, :], 0.0, 1.0)
        grab = y[None] + w[:, None, :] * (y1 - y)[None]
        out = out + jnp.where(hit[:, None, :], grab, 0.0)
        ys = emit(y1, e1, c1) if emit is not None else None
        return (y1, out), ys

    xs = (eta_grid[:, :-1].T, eta_grid[:, 1:].T)
    n = xs[0].shape[0]
    unroll = UNROLL if n % UNROLL == 0 else 1
    (yf, out), ys = jax.lax.scan(step, (y0, out0), xs, unroll=unroll)
    if emit is not None:
        return yf, out, ys
    return yf, out


def _phase_a_projector(tabs, am):
    """The phase-A post-step projection pipeline (exact Thomson-drag map,
    TCA slaving, Poisson phi-pinning, neutrino streaming), shared by every
    two-phase integration entry point."""

    def projectA(y_start, y_end, kk, d, e1, cm, c1):
        y_end = _drag_etd(y_start, y_end, kk, d, cm, c1)
        y_end = _tca_project(y_end, kk, c1)
        y_end = _poisson_project(y_end, kk, e1, c1, am)
        return _ur_rsa_project(y_end, kk, e1, c1, am)

    return projectA


def _ncdm_handoff(yA, eta_Aend, tabs, k, am):
    """Map the end-of-phase-A state onto the reduced streaming-phase state
    (phi, dc, tc, db, tb, dn, tn, sn): the massive-neutrino hierarchy is
    collapsed to its fluid moments."""
    cH = _fetch(tabs, eta_Aend)
    aH = jnp.exp(cH['lna'])
    dnH, opwtH, opwsH = _ncdm_moments(yA, aH, am)
    opw = 1.0 + cH['w_nc']
    return jnp.stack([yA[_I_PHI], yA[_I_DC], yA[_I_TC], yA[_I_DB], yA[_I_TB],
                      dnH, k * opwtH / opw, opwsH / opw,
                      yA[_I_DDE], yA[_I_TDE]])


def _phase_b_projector():
    """Post-step pin of the streaming-phase dark-energy fluid to its
    quasi-static values sub-sound-horizon (see _de_qs_values)."""

    def projectB(y_start, y_end, kk, d, e1, cm, c1):
        psi, phip = _rsa_metric(y_end, kk, c1)
        dde_qs, tde_qs = _de_qs_values(psi, phip, kk, c1)
        de_qs = (jnp.sqrt(jnp.maximum(c1['cs2_fld'], 0.0)) * kk * e1) > RSA_KETA
        y_end = y_end.at[8].set(jnp.where(de_qs, dde_qs, y_end[8]))
        return y_end.at[9].set(jnp.where(de_qs, tde_qs, y_end[9]))

    return projectB


def integrate_perturbations(params, thermo, k, z_outputs, n_steps=None):
    """Full two-phase integration. ``k`` in 1/Mpc (static shape); returns a
    dict of synchronous-gauge (CDM-comoving, CAMB-convention) transfer
    functions, Newtonian potentials, and growth sources at each z, all
    normalized to comoving curvature R = 1. ``n_steps``: optional STATIC
    (n_steps_a, n_steps_b, m_tab) budget - see :func:`steps_for_kmax`;
    None = the module defaults (safe to kmax ~ 7/Mpc)."""
    na, nb, mt = n_steps if n_steps is not None else (None, None, None)
    tabs = build_tables(params, thermo, m_tab=mt)
    am = tabs['am']
    eta_A, eta_B, eta_ini = build_time_grids(tabs, k, n_steps_a=na, n_steps_b=nb)
    y0 = adiabatic_ics(tabs, k, eta_ini)

    z_outputs = jnp.asarray(z_outputs, dtype=jnp.float64)
    lna_t = -jnp.log1p(z_outputs)
    eta_t = jnp.exp(jnp.interp(lna_t, tabs['lna'], tabs['lneta']))
    # z = 0 maps to eta0 exactly; nudge inside the final half-open step
    eta_t = jnp.minimum(eta_t, tabs['eta0'] * (1.0 - 1e-10))

    # phase A: full hierarchy; post-step = exact drag map + TCA and
    # streaming projections
    yA, outA = _rk4_scan(deriv_full, y0, eta_A, eta_t, tabs, k, am,
                         project=_phase_a_projector(tabs, am))

    # handoff: ncdm hierarchy -> fluid moments at eta_Aend
    eta_Aend = eta_A[:, -1]
    yB0 = _ncdm_handoff(yA, eta_Aend, tabs, k, am)

    yBf, outB = _rk4_scan(deriv_rsa, yB0, eta_B, eta_t, tabs, k, am,
                          project=_phase_b_projector())

    # ---- assemble per-z products, selecting phase A or B per (z, k)
    n_z = eta_t.shape[0]
    res = {'k': k, 'z': z_outputs}
    use_A = eta_t[:, None] < eta_Aend[None, :]      # (n_z, nk)

    for iz in range(n_z):
        c = _fetch(tabs, jnp.broadcast_to(eta_t[iz], k.shape))
        a_out = jnp.exp(c['lna'])
        yAz = outA[iz]
        yBz = outB[iz]
        # phase-A species
        dnA, opwtA, opwsA = _ncdm_moments(yAz, a_out, am)
        opw = 1.0 + c['w_nc']
        # phase-B radiation (streaming): delta = -4 psi
        _, G2z, s2sqz = _curv(c, k)
        psiB = yBz[0] - 4.5 * (G2z / (k ** 2 * s2sqz)) * c['fnc'] * opw * yBz[7]
        sel = use_A[iz]

        phi = jnp.where(sel, yAz[_I_PHI], yBz[0])
        dc = jnp.where(sel, yAz[_I_DC], yBz[1])
        tc = jnp.where(sel, yAz[_I_TC], yBz[2])
        db = jnp.where(sel, yAz[_I_DB], yBz[3])
        tb = jnp.where(sel, yAz[_I_TB], yBz[4])
        dg = jnp.where(sel, yAz[_I_DG], -4.0 * psiB)
        dur = jnp.where(sel, yAz[_I_UR + 0], -4.0 * psiB)
        dn = jnp.where(sel, dnA, yBz[5])
        tn = jnp.where(sel, k * opwtA / opw, yBz[6])

        # gauge conversion to CDM-comoving synchronous (CAMB convention)
        shift = 3.0 * c['Hc'] * tc / k ** 2
        dc_s = dc + shift
        db_s = db + shift
        dg_s = dg + (4.0 / 3.0) * 3.0 * c['Hc'] * tc / k ** 2
        dur_s = dur + (4.0 / 3.0) * 3.0 * c['Hc'] * tc / k ** 2
        dn_s = dn + opw * shift

        fm = c['fc'] + c['fb'] + c['fnc']
        res.setdefault('delta_cdm', []).append(dc_s)
        res.setdefault('delta_b', []).append(db_s)
        res.setdefault('delta_g', []).append(dg_s)
        res.setdefault('delta_ur', []).append(dur_s)
        res.setdefault('delta_ncdm', []).append(dn_s)
        res.setdefault('delta_m', []).append((c['fc'] * dc_s + c['fb'] * db_s + c['fnc'] * dn_s) / fm)
        res.setdefault('delta_cb', []).append((c['fc'] * dc_s + c['fb'] * db_s) / (c['fc'] + c['fb']))
        res.setdefault('phi', []).append(phi)
        res.setdefault('theta_b', []).append(tb)
        res.setdefault('theta_ncdm', []).append(tn)

    for name in list(res.keys()):
        if isinstance(res[name], list):
            res[name] = jnp.stack(res[name])
    return res


def _los_z_nodes(n_rec=512, n_mid=192, n_reio=128, n_late=192):
    """Static redshift template for the line-of-sight source harvest grid:
    dense through recombination (z in [1690, 500], where the visibility
    peaks), logarithmic through the matter era and reionization, uniform in
    ln(1+z) at late times. The TRACED tau values adapt to the cosmology via
    tau(ln a); the node count is static so the graph never recompiles."""
    z_rec = np.linspace(1690.0, 500.0, n_rec, endpoint=False)
    z_mid = np.geomspace(500.0, 30.0, n_mid, endpoint=False)
    z_reio = np.geomspace(30.0, 4.0, n_reio, endpoint=False)
    z_late = np.expm1(np.linspace(np.log1p(4.0), 0.0, n_late))
    return np.concatenate([z_rec, z_mid, z_reio, z_late])


def _los_emitters(tabs, k, am):
    """Per-step source taps for the CMB line-of-sight integration
    (Seljak & Zaldarriaga 1996). Five rows per step, all vs k:

    0. mono = Theta_0 + psi + Pi/4       (multiplies g j_l)

    with Pi in TEMPERATURE units: Pi = Theta_2 + G_0/4 + G_2/4
    = (F_g2 + G_0 + G_2)/4 (the hierarchy stores MB95 brightness moments,
    so Theta_l = F_gl/4). The E-mode source is (3/4) g Pi j_l/x^2
    (Zaldarriaga & Seljak 1997 with their Delta_P = G/4 normalization).
    1. dopp = theta_b / k                (multiplies g j_l')
    2. pol  = Pi = (F_g2 + G_0 + G_2)/4  ((3/4) g Pi multiplies j_l'';
                                          E source = (3/4) g Pi j_l / x^2)
    3. isw  = phi' + psi'                (multiplies e^-kappa j_l)
    4. weyl = (phi + psi) / 2            (lensing-potential source)

    psi' is exact (forward-mode through the metric constraint with the full
    ODE right-hand side), not a finite difference of the harvested series -
    the early-ISW term right after recombination oscillates at the acoustic
    frequency and a grid derivative there would alias."""

    def psiA(y, eta):
        c = _fetch(tabs, eta)
        return _metric(y, k, eta, c, am)[0]

    def emitA(y, e1, c1):
        psi, phip, _, _, _ = _metric(y, k, e1, c1, am)
        # Pi in temperature units: the hierarchy stores MB95 brightness
        # moments (Theta_l = F_gl/4), and the TT/EE sources need
        # Pi = Theta_2 + G_0/4 + G_2/4 = (F_g2 + G_0 + G_2)/4.
        Pi = 0.25 * (y[_I_FG] + y[_I_GP + 0] + y[_I_GP + 2])
        mono = 0.25 * y[_I_DG] + psi + 0.25 * Pi
        dopp = y[_I_TB] / k
        ydot = deriv_full(y, k, e1, c1, am)
        psidot = jax.jvp(psiA, (y, e1), (ydot, jnp.ones_like(e1)))[1]
        weyl = 0.5 * (y[_I_PHI] + psi)
        return jnp.stack([mono, dopp, Pi, phip + psidot, weyl])

    def psiB(y, eta):
        c = _fetch(tabs, eta)
        _, G2b, s2sqb = _curv(c, k)
        return y[0] - 4.5 * (G2b / (k ** 2 * s2sqb)) * c['fnc'] * (1.0 + c['w_nc']) * y[7]

    def emitB(y, e1, c1):
        # radiation streaming: Theta_0 + psi = 0 and Pi = 0 by construction
        psi = psiB(y, e1)
        ydot = deriv_rsa(y, k, e1, c1, am)
        psidot = jax.jvp(psiB, (y, e1), (ydot, jnp.ones_like(e1)))[1]
        dopp = y[4] / k
        weyl = 0.5 * (y[0] + psi)
        zero = jnp.zeros_like(dopp)
        return jnp.stack([zero, dopp, zero, ydot[0] + psidot, weyl])

    return emitA, emitB


def compute_los_sources(params, thermo, k, z_nodes=None, n_steps=None):
    """Line-of-sight CMB sources on a common (adaptive) conformal-time grid.

    Runs the same two-phase integration as :func:`integrate_perturbations`
    but taps the five LOS source rows (see :func:`_los_emitters`) at every
    step, then interpolates each k-mode's series from its own step grid onto
    a shared tau grid built from the static redshift template. The
    reference has no counterpart: CLASS's perturbation sources
    (cosmoprimo can only import their integrated Cls via classy).

    Returns a dict with 'tau' (n_tau,), 'src' (nk, 5, n_tau) RAW sources
    (visibility NOT applied), 'g', 'emk' (= e^-kappa) on the tau grid,
    'eta0', 'tau_star' (visibility peak epoch, from thermo.z_star), and 'k'.
    """
    na, nb, mt = n_steps if n_steps is not None else (None, None, None)
    tabs = build_tables(params, thermo, m_tab=mt)
    am = tabs['am']
    eta_A, eta_B, eta_ini = build_time_grids(tabs, k, n_steps_a=na, n_steps_b=nb)
    y0 = adiabatic_ics(tabs, k, eta_ini)
    dummy = jnp.full((1,), tabs['eta0'] * 2.0)

    emitA, emitB = _los_emitters(tabs, k, am)
    yA, _, srcA = _rk4_scan(deriv_full, y0, eta_A, dummy, tabs, k, am,
                            project=_phase_a_projector(tabs, am), emit=emitA)

    eta_Aend = eta_A[:, -1]
    yB0 = _ncdm_handoff(yA, eta_Aend, tabs, k, am)
    _, _, srcB = _rk4_scan(deriv_rsa, yB0, eta_B, dummy, tabs, k, am,
                           project=_phase_b_projector(), emit=emitB)

    if z_nodes is None:
        z_nodes = _los_z_nodes()
    lna_n = jnp.asarray(-np.log1p(np.asarray(z_nodes)))
    tau_h = jnp.exp(jnp.interp(lna_n, tabs['lna'], tabs['lneta']))
    tau_h = jnp.minimum(tau_h, tabs['eta0'] * (1.0 - 1e-9))

    def onek(xpA, fA, xpB, fB, aend):
        vA = jax.vmap(lambda f: jnp.interp(tau_h, xpA, f))(fA)
        vB = jax.vmap(lambda f: jnp.interp(tau_h, xpB, f))(fB)
        return jnp.where(tau_h[None, :] < aend, vA, vB)

    src = jax.vmap(onek)(eta_A[:, 1:], srcA.transpose(2, 1, 0),
                         eta_B[:, 1:], srcB.transpose(2, 1, 0), eta_Aend)

    c_h = _fetch(tabs, tau_h)
    kappa = jnp.interp(c_h['lna'], jnp.asarray(_thermo.LNA_GRID), thermo.tau)
    emk = jnp.exp(-kappa)
    g = c_h['kp'] * emk
    tau_star = jnp.exp(jnp.interp(-jnp.log1p(thermo.z_star), tabs['lna'], tabs['lneta']))
    return {'tau': tau_h, 'src': src, 'g': g, 'emk': emk,
            'eta0': tabs['eta0'], 'tau_star': tau_star, 'k': k}


PERTURBATION_NAMES = ('delta_g', 'theta_g', 'shear_g', 'delta_b', 'theta_b',
                      'delta_cdm', 'theta_cdm', 'delta_ur', 'theta_ur',
                      'delta_ncdm', 'theta_ncdm', 'delta_fld', 'theta_fld',
                      'phi', 'psi')


def compute_perturbation_series(params, thermo, k, z_nodes=None, n_steps=None):
    """Newtonian-gauge perturbation time-series for each requested k mode,
    interpolated from the per-k adaptive step grids onto a shared
    conformal-time grid - the per-k source table the reference only
    obtains from CLASS's ``get_perturbations``
    (/root/reference/cosmoprimo/classy.py:231-234,415).

    Returns a dict with 'tau' (n_tau,), 'a' (n_tau,), 'k' (nk,), and
    'series' (nk, len(PERTURBATION_NAMES), n_tau) ordered as
    :data:`PERTURBATION_NAMES` (MB95 conventions, comoving curvature
    R = 1; streaming-phase radiation entries are the RSA algebraic values).
    """
    na, nb, mt = n_steps if n_steps is not None else (None, None, None)
    tabs = build_tables(params, thermo, m_tab=mt)
    am = tabs['am']
    eta_A, eta_B, eta_ini = build_time_grids(tabs, k, n_steps_a=na, n_steps_b=nb)
    y0 = adiabatic_ics(tabs, k, eta_ini)
    dummy = jnp.full((1,), tabs['eta0'] * 2.0)

    def emitA(y, e1, c1):
        psi, phip, tur, _, _ = _metric(y, k, e1, c1, am)
        a1 = jnp.exp(c1['lna'])
        dn, opw_th_k, _ = _ncdm_moments(y, a1, am)
        opw = 1.0 + c1['w_nc']
        return jnp.stack([y[_I_DG], y[_I_TG], 0.5 * y[_I_FG],
                          y[_I_DB], y[_I_TB], y[_I_DC], y[_I_TC],
                          y[_I_UR + 0], tur, dn, k * opw_th_k / opw,
                          y[_I_DDE], y[_I_TDE], y[_I_PHI], psi])

    def emitB(y, e1, c1):
        _, G2b, s2sqb = _curv(c1, k)
        psi = y[0] - 4.5 * (G2b / (k ** 2 * s2sqb)) * c1['fnc'] * (1.0 + c1['w_nc']) * y[7]
        ydot = deriv_rsa(y, k, e1, c1, am)
        tg = 3.0 * ydot[0]
        zero = jnp.zeros_like(psi)
        return jnp.stack([-4.0 * psi, tg, zero, y[3], y[4], y[1], y[2],
                          -4.0 * psi, tg, y[5], y[6], y[8], y[9], y[0], psi])

    yA, _, srcA = _rk4_scan(deriv_full, y0, eta_A, dummy, tabs, k, am,
                            project=_phase_a_projector(tabs, am), emit=emitA)
    eta_Aend = eta_A[:, -1]
    yB0 = _ncdm_handoff(yA, eta_Aend, tabs, k, am)
    _, _, srcB = _rk4_scan(deriv_rsa, yB0, eta_B, dummy, tabs, k, am,
                           project=_phase_b_projector(), emit=emitB)

    if z_nodes is None:
        z_nodes = _los_z_nodes()
    lna_n = jnp.asarray(-np.log1p(np.asarray(z_nodes)))
    tau_h = jnp.exp(jnp.interp(lna_n, tabs['lna'], tabs['lneta']))
    tau_h = jnp.minimum(tau_h, tabs['eta0'] * (1.0 - 1e-9))

    def onek(xpA, fA, xpB, fB, aend):
        vA = jax.vmap(lambda f: jnp.interp(tau_h, xpA, f))(fA)
        vB = jax.vmap(lambda f: jnp.interp(tau_h, xpB, f))(fB)
        return jnp.where(tau_h[None, :] < aend, vA, vB)

    series = jax.vmap(onek)(eta_A[:, 1:], srcA.transpose(2, 1, 0),
                            eta_B[:, 1:], srcB.transpose(2, 1, 0), eta_Aend)
    a_h = jnp.exp(jnp.interp(jnp.log(tau_h), tabs['lneta'], tabs['lna']))
    return {'tau': tau_h, 'a': a_h, 'k': k, 'series': series,
            'names': PERTURBATION_NAMES}


def linear_pk(params, thermo, k_hMpc, z_outputs, n_steps=None):
    """Linear P(k) [(Mpc/h)^3] at ``k_hMpc`` [h/Mpc] and each z, for both
    total matter and cdm+baryons, from the native Boltzmann integration.
    ``n_steps``: optional static budget, see :func:`steps_for_kmax`."""
    h = params['h']
    k = jnp.asarray(k_hMpc) * h  # 1/Mpc
    tr = integrate_perturbations(params, thermo, k, z_outputs, n_steps=n_steps)
    # primordial curvature spectrum (dimensionless transfers, R = 1),
    # with the alpha_s/beta_s runnings (Planck conventions, as
    # models/eisenstein_hu.py Primordial)
    ns, As, kp = params['n_s'], params['A_s'], params['k_pivot']
    lnkkp = jnp.log(k / kp)
    neff = (ns - 1.0 + 0.5 * params.get('alpha_s', 0.0) * lnkkp
            + params.get('beta_s', 0.0) / 6.0 * lnkkp ** 2)
    pprim = 2.0 * jnp.pi ** 2 / k ** 3 * As * (k / kp) ** neff  # Mpc^3
    out = {'k': k_hMpc, 'z': tr['z']}
    out['pk_m'] = pprim[None, :] * tr['delta_m'] ** 2 * h ** 3
    out['pk_cb'] = pprim[None, :] * tr['delta_cb'] ** 2 * h ** 3
    out['transfers'] = tr
    return out

"""Tensor-mode (primordial gravitational wave) CMB spectra, natively
integrated: unlensed BB from first principles, plus the tensor
contributions to TT/EE/TE.

The reference serves tensor Cls only through an external CLASS build
(/root/reference/cosmoprimo/classy.py with modes=['s','t'],
cosmology.py:730-734 carries r/n_t/alpha_t); this module computes them
natively on the same static-shape scaffolding as the scalar solver.

Physics (Crittenden-Coulson-Turok / Polnarev reduced system; all photon
moments in TEMPERATURE units):

  metric      h'' + 2 aH h' + k^2 h = 6 (aH)^2 sum_i f_i
                  [ (8/15) F_{i,0} + (16/21) F_{i,2} + (8/35) F_{i,4} ]
              (from Pi_+ = (rho_i/4) int dmu/2 (1-mu^2)^2 Delta_i with the
               brightness Delta = 4 F restoring temperature units)
  photons     FT_0' = -k FT_1 - h'/2 - kappa' (FT_0 - Psi)
              FT_l' = advection - kappa' FT_l                       (l >= 1)
  polar.      FP_0' = -k FP_1 - kappa' (FP_0 + Psi)
              FP_l' = advection - kappa' FP_l                       (l >= 1)
  neutrinos   FN_0' = -k FN_1 - h'/2 ; FN_l' = advection            (l >= 1)
  Psi = FT0/10 + FT2/7 + 3 FT4/70 - 3 FP0/5 + 6 FP2/7 - 3 FP4/70

Tight coupling (kappa' > TRIGGER_AH aH and > TRIGGER_K k) is algebraic: the towers
are slaved to FT0 = -(2/3) h'/kappa', FP0 = h'/(6 kappa') (quasi-steady
solution of the l=0 pair with Psi = FT0/4), their derivatives frozen.

Line of sight (kernels CALIBRATED NUMERICALLY against brute-force
spin-2 decompositions of the exact angular structures -
scripts/dev_tensor_calibration.py; x = k (tau0 - tau)):

  Delta_T,l = sqrt((l+2)!/(l-2)!) int dtau [e^-kappa (-h'/2) + g Psi] j_l/x^2
  Delta_E,l = int dtau g Psi [ -j_l + j_l'' + 2 j_l/x^2 + 4 j_l'/x ]
  Delta_B,l = int dtau g Psi [ 2 j_l' + 4 j_l/x ]

  C_l^XY = pi int dln k P_T(k) Delta_X,l Delta_Y,l

with P_T(k) = r A_s (k/k_pivot)^{n_t + (alpha_t/2) ln(k/k_pivot)} the
standard primordial tensor power of h_ij h^ij (Planck convention,
r = A_t/A_s; n_t/alpha_t resolved by the cosmology's slow-roll
consistency defaults). The pi prefactor follows from
P_+ + P_x = (pi^2/k^3) P_T and the calibrated multipole magnitudes
|a_X,l,+-2| = 2 pi sqrt((2l+1)/4pi) K_X |source|; TB/EB vanish by parity.

Validation (tests/test_tensor.py): the Weinberg free-streaming damping of
h for deep-radiation-era modes (amplitude ratio ~0.80 at f_nu = 0.405 -
an end-to-end check of the stress coupling), exact BB proportional to r,
the recombination-bump location and amplitude for r = 0.1 against the
published range, and the l-shape (reionization bump below l ~ 12).
"""

import jax
import jax.numpy as jnp
import numpy as np

from . import bessel
from .harmonic import (DK_FINE, KMIN, _hermite_gather, _trapz_weights,
                       coarse_k_grid, fine_k_grid, sin_K, _spline_to_integers)
from .perturbations import TCA_TRIGGER_AH, TCA_TRIGGER_K, _C_KMS, _fetch, build_tables, _thermo
from ..ops.spline import cubic_eval, linear_eval, natural_cubic_coeffs


def tensor_cl_kmin(K, kmin=KMIN):
    """Smallest propagating tensor wavenumber [1/Mpc]: the tensor radial
    eigenvalue is q^2 = k^2 + 3K (vs k^2 + K for scalars). Open: q^2 > 0
    needs k^2 > -3K. Closed: the discrete tensor eigenmodes have
    q = nu sqrt(K), integer nu >= 3, i.e. k^2 >= (9 - 3) K = 6 K."""
    if K < 0.0:
        return max(kmin, 1.05 * np.sqrt(-3.0 * K))
    if K > 0.0:
        return max(kmin, np.sqrt(6.0 * K))
    return kmin

LMAX_T = 8     # photon tensor temperature tower FT_0..FT_LMAX_T
LMAX_P = 8     # photon tensor polarization tower
LMAX_N = 14    # neutrino tensor tower (free-streams from the start)
N_STEPS_T = 8192
ALPHA_T = 0.5      # dtau <= ALPHA_T / k (h and the towers oscillate at k)
BETA_T = 0.004     # dtau <= BETA_T tau
KAPPA_SAFE_T = 0.45

_I_H, _I_HP = 0, 1
_I_T = 2
_I_P = _I_T + (LMAX_T + 1)
_I_N = _I_P + (LMAX_P + 1)
N_STATE_T = _I_N + (LMAX_N + 1)


def tensor_time_grid(tabs, k):
    """Per-k single-phase integration grid tau_ini(k) -> tau0 with the
    scalar solver's density rules (acoustic phase, ln tau, and the
    explicit kappa'-stability band outside tight coupling)."""
    eta_m = jnp.exp(tabs['lneta'])
    kpm, Hcm = tabs['kp'], tabs['Hc']
    eta0 = tabs['eta0']
    k = k[:, None]
    tca_off = ((kpm[None, :] < TCA_TRIGGER_AH * Hcm[None, :])
               | (kpm[None, :] < TCA_TRIGGER_K * k))
    dens = jnp.maximum(k / ALPHA_T, 1.0 / (BETA_T * eta_m)[None, :])
    dens = jnp.maximum(dens, jnp.where(tca_off, kpm[None, :] / (2.8 * KAPPA_SAFE_T), 0.0))
    seg = 0.5 * (dens[:, 1:] + dens[:, :-1]) * jnp.diff(eta_m)[None, :]
    s = jnp.concatenate([jnp.zeros((k.shape[0], 1)), jnp.cumsum(seg, axis=1)], axis=1)
    eta_ini = jnp.clip(0.03 / k[:, 0], tabs['eta_ini_min'], tabs['eta_rd'])

    def s_of(eta_q):
        return jax.vmap(jnp.interp)(eta_q, jnp.broadcast_to(eta_m, (eta_q.shape[0], eta_m.shape[0])), s)

    s_ini = s_of(eta_ini)
    s_end = s_of(jnp.broadcast_to(eta0 * (1.0 + 1e-9), eta_ini.shape))
    idx = jnp.linspace(0.0, 1.0, N_STEPS_T + 1)
    s_grid = s_ini[:, None] + (s_end - s_ini)[:, None] * idx[None, :]
    eta_g = jax.vmap(jnp.interp)(s_grid, s, jnp.broadcast_to(eta_m, s.shape))
    return jnp.minimum(eta_g, eta0 * (1.0 + 1e-9)), eta_ini


def _psi_pol(y):
    """The Polnarev scattering combination Psi."""
    FT = y[_I_T:_I_T + (LMAX_T + 1)]
    FP = y[_I_P:_I_P + (LMAX_P + 1)]
    return (FT[0] / 10.0 + FT[2] / 7.0 + 3.0 * FT[4] / 70.0
            - 3.0 * FP[0] / 5.0 + 6.0 * FP[2] / 7.0 - 3.0 * FP[4] / 70.0)


def deriv_tensor(y, k, eta, c):
    """Time derivative of the tensor state (h, h', FT, FP, FN)."""
    Hc, kp = c['Hc'], c['kp']
    fg = c['fg']
    fnu = c['fur'] + c['fnc']  # ncdm treated massless for tensor stress
    h, hp = y[_I_H], y[_I_HP]
    FT = y[_I_T:_I_T + (LMAX_T + 1)]
    FP = y[_I_P:_I_P + (LMAX_P + 1)]
    FN = y[_I_N:_I_N + (LMAX_N + 1)]
    tca = (kp > TCA_TRIGGER_AH * Hc) & (kp > TCA_TRIGGER_K * k)
    Psi = _psi_pol(y)

    # anisotropic-stress feedback on the wave: Pi_+ = (rho/4) * brightness
    # moments = rho * temperature moments (the brightness 4 cancels the
    # 1/4 of the quadrupole projection), so 16 pi G a^2 Pi_+ = 6 Hc^2 f [..]
    def stress(F):
        return (8.0 / 15.0) * F[0] + (16.0 / 21.0) * F[2] + (8.0 / 35.0) * F[4]

    S = 6.0 * Hc ** 2 * (fg * stress(FT) + fnu * stress(FN))
    dh = hp
    dhp = -2.0 * Hc * hp - k ** 2 * h + S

    def tower(F, L, extra0, relax):
        dF = []
        for l in range(L + 1):
            Fm = F[l - 1] if l > 0 else jnp.zeros_like(F[0])
            Fp = F[l + 1] if l < L else (
                ((2.0 * L + 1.0) / (k * eta)) * F[L] - F[L - 1])
            d = k / (2.0 * l + 1.0) * (l * Fm - (l + 1.0) * Fp)
            if l == 0:
                d = d + extra0
            d = d + relax(l)
            dF.append(d)
        return jnp.stack(dF)

    dFT = tower(FT, LMAX_T, -0.5 * hp - kp * (FT[0] - Psi),
                lambda l: -kp * FT[l] if l > 0 else 0.0)
    dFP = tower(FP, LMAX_P, -kp * (FP[0] + Psi),
                lambda l: -kp * FP[l] if l > 0 else 0.0)
    dFN = tower(FN, LMAX_N, -0.5 * hp, lambda l: 0.0)
    # inside tight coupling the photon towers are algebraic (projected
    # after each step); freezing their derivatives keeps the -kappa'
    # relaxation off the explicit integrator where kappa' dtau >> 1
    dFT = jnp.where(tca, 0.0, dFT)
    dFP = jnp.where(tca, 0.0, dFP)
    return jnp.concatenate([jnp.stack([dh, dhp]), dFT, dFP, dFN], axis=0)


def _tca_project_tensor(y, k, c):
    """Slave the photon tensor towers to their quasi-steady values inside
    tight coupling: FT0 = -(2/3) h'/kappa', FP0 = h'/(6 kappa')
    (solution of 0 = -h'/2 - kappa'(FT0 - Psi), 0 = -kappa'(FP0 + Psi)
    with Psi = FT0/4), all higher moments zero."""
    kp, Hc = c['kp'], c['Hc']
    tca = (kp > TCA_TRIGGER_AH * Hc) & (kp > TCA_TRIGGER_K * k)
    hp = y[_I_HP]
    y = y.at[_I_T].set(jnp.where(tca, -(2.0 / 3.0) * hp / kp, y[_I_T]))
    y = y.at[_I_P].set(jnp.where(tca, hp / (6.0 * kp), y[_I_P]))
    for idx in range(_I_T + 1, _I_T + LMAX_T + 1):
        y = y.at[idx].set(jnp.where(tca, 0.0, y[idx]))
    for idx in range(_I_P + 1, _I_P + LMAX_P + 1):
        y = y.at[idx].set(jnp.where(tca, 0.0, y[idx]))
    return y


def _tensor_z_nodes(n_rec=512, n_mid=192, n_reio=256, n_late=512):
    """Source-harvest template: like the scalar _los_z_nodes but denser
    after reionization - the -h' e^-kappa source keeps oscillating at
    frequency k to tau0 and the harvest must resolve it for the k range
    that reaches the late-time grid."""
    z_rec = np.linspace(1690.0, 500.0, n_rec, endpoint=False)
    z_mid = np.geomspace(500.0, 30.0, n_mid, endpoint=False)
    z_reio = np.geomspace(30.0, 4.0, n_reio, endpoint=False)
    z_late = np.expm1(np.linspace(np.log1p(4.0), 0.0, n_late))
    return np.concatenate([z_rec, z_mid, z_reio, z_late])


def compute_tensor_sources(params, thermo, k, z_nodes=None):
    """Integrate the tensor system on the lanes-on-k grids and harvest the
    two LOS source rows [h', Psi] per step, interpolated onto the shared
    tau grid. Returns {'tau', 'src' (nk, 2, n_tau), 'g', 'emk', 'eta0',
    'k'} - same contract as the scalar compute_los_sources."""
    tabs = build_tables(params, thermo)
    eta_g, eta_ini = tensor_time_grid(tabs, k)

    y0 = jnp.zeros((N_STATE_T, k.shape[0]))
    y0 = y0.at[_I_H].set(jnp.ones_like(k))  # h(0) = 1, h'(0) = 0, towers 0

    def step(carry, xs):
        y = carry
        e0, e1 = xs
        d = e1 - e0
        em = 0.5 * (e0 + e1)
        c0, cm, c1 = _fetch(tabs, e0), _fetch(tabs, em), _fetch(tabs, e1)
        k1 = deriv_tensor(y, k, e0, c0)
        k2 = deriv_tensor(y + 0.5 * d * k1, k, em, cm)
        k3 = deriv_tensor(y + 0.5 * d * k2, k, em, cm)
        k4 = deriv_tensor(y + d * k3, k, e1, c1)
        y1 = y + d / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        y1 = _tca_project_tensor(y1, k, c1)
        return y1, jnp.stack([y1[_I_HP], _psi_pol(y1)])

    xs = (eta_g[:, :-1].T, eta_g[:, 1:].T)
    _, src_steps = jax.lax.scan(step, y0, xs)   # (N, 2, nk)

    if z_nodes is None:
        z_nodes = _tensor_z_nodes()
    lna_n = jnp.asarray(-np.log1p(np.asarray(z_nodes)))
    tau_h = jnp.exp(jnp.interp(lna_n, tabs['lna'], tabs['lneta']))
    tau_h = jnp.minimum(tau_h, tabs['eta0'] * (1.0 - 1e-9))

    def onek(xp, f):
        return jax.vmap(lambda ff: jnp.interp(tau_h, xp, ff))(f)

    src = jax.vmap(onek)(eta_g[:, 1:], src_steps.transpose(2, 1, 0))

    c_h = _fetch(tabs, tau_h)
    kappa = jnp.interp(c_h['lna'], jnp.asarray(_thermo.LNA_GRID), thermo.tau)
    emk = jnp.exp(-kappa)
    g = c_h['kp'] * emk
    return {'tau': tau_h, 'src': src, 'g': g, 'emk': emk,
            'eta0': tabs['eta0'], 'k': k}


def project_tensor_sources(src, ell_list, tables, P_T, dk_fine=DK_FINE,
                           n_quad_late=1664):
    """LOS projection + C_l quadrature of the tensor sources at each
    sampled multipole (kernels per the module docstring; calibration in
    scripts/dev_tensor_calibration.py). ``P_T``: primordial tensor power
    on the FINE k grid (callable k -> P_T(k)). Returns dict of (n_ell,)
    raw C_l arrays: tt, ee, bb, te."""
    k_c = src['k']
    kmax = float(k_c[-1])
    K = float(src.get('K', 0.0))
    k_f = jnp.asarray(fine_k_grid(kmax, dk=dk_fine, kmin=tensor_cl_kmin(K)))
    tau_h, eta0 = src['tau'], src['eta0']
    g, emk = src['g'], src['emk']

    n_rec = 512
    tau_rec = tau_h[:n_rec]
    tau_late = jnp.geomspace(tau_h[n_rec], eta0 * (1.0 - 1e-9), n_quad_late + 1)[1:]
    tau_q = jnp.concatenate([tau_rec, tau_late])

    hp, Psi = src['src'][:, 0, :], src['src'][:, 1, :]
    ST = -0.5 * emk * hp + g * Psi     # multiplies sqrt((l+2)!/(l-2)!) j/x^2
    SP = g * Psi                        # multiplies the E/B kernels

    S = jnp.stack([ST, SP], axis=1)                        # (nk_c, 2, n_h)
    S_q = linear_eval(tau_h, jnp.moveaxis(S, -1, 0), tau_q)  # (n_q, nk_c, 2)
    Sk = jnp.moveaxis(S_q, 1, 0)                           # (nk_c, n_q, 2)
    M = natural_cubic_coeffs(k_c, Sk)
    S_f = cubic_eval(k_c, Sk, M, k_f)                      # (nK, n_q, 2)
    STf, SPf = S_f[..., 0], S_f[..., 1]

    x_grid, j_tab, jp_tab = tables
    dx = float(x_grid[1] - x_grid[0])
    rdtype = S_f.dtype
    j_tab = jnp.asarray(j_tab, dtype=rdtype)
    jp_tab_scaled = jnp.asarray(jp_tab, dtype=rdtype) * rdtype.type(dx)
    jp_tab_raw = jnp.asarray(jp_tab, dtype=rdtype)

    chi_q = (eta0 - tau_q).astype(rdtype)
    # radial projection: flat x = k chi; curved (|Omega_k| <= 0.12, same
    # window as the scalar section) the geodesic approximation
    # x = q S_K(chi) with the TENSOR eigenvalue q^2 = k^2 + 3K - the same
    # O(K/q^2) mapping whose scalar counterpart is oracle-certified in
    # tests/test_curved_harmonic.py; the tensor mode EVOLUTION keeps the
    # flat-space wave operator (an O(K/k^2) approximation of the same
    # order, inside the documented ~10% tensor budget).
    q_f = jnp.sqrt(jnp.maximum(k_f.astype(rdtype) ** 2 + rdtype.type(3.0 * K),
                               rdtype.type(0.0)))
    x = q_f[:, None] * sin_K(chi_q, K)[None, :].astype(rdtype)
    u = x / rdtype.type(dx)
    w_q = _trapz_weights(tau_q).astype(rdtype)

    ells = jnp.asarray(np.asarray(ell_list, dtype=np.float64), dtype=rdtype)
    pref_T = jnp.sqrt((ells + 2.0) * (ells + 1.0) * ells * (ells - 1.0))

    w_k = _trapz_weights(k_f) / k_f
    pr = w_k * jnp.pi * P_T(k_f)
    xinvc = 1.0 / jnp.maximum(x, rdtype.type(dx))

    def one_ell(i):
        ell = ells[i]
        l2 = ell * (ell + 1.0)
        jl = _hermite_gather(j_tab[i], jp_tab_scaled[i], u)
        xn = jnp.maximum(x_grid.astype(rdtype), rdtype.type(dx))
        jpp_nodes = (l2 / xn ** 2 - 1.0) * j_tab[i] - (2.0 / xn) * jp_tab_raw[i]
        jlp = _hermite_gather(jp_tab_raw[i], jpp_nodes * rdtype.type(dx), u)
        jlpp = (l2 * xinvc ** 2 - 1.0) * jl - 2.0 * xinvc * jlp

        dT = pref_T[i] * ((STf * jl * xinvc ** 2) @ w_q)
        dE = (SPf * (-jl + jlpp + 2.0 * jl * xinvc ** 2 + 4.0 * jlp * xinvc)) @ w_q
        dB = (SPf * (2.0 * jlp + 4.0 * jl * xinvc)) @ w_q
        return jnp.stack([pr @ (dT * dT), pr @ (dE * dE),
                          pr @ (dB * dB), pr @ (dT * dE)])

    out = jax.lax.map(one_ell, jnp.arange(len(ell_list)))
    return {'tt': out[:, 0], 'ee': out[:, 1], 'bb': out[:, 2], 'te': out[:, 3]}


def compute_tensor_cls(params, thermo, lmax=600, kmax=None, ells=None):
    """Tensor-mode CMB spectra ('tt', 'ee', 'bb', 'te'; raw dimensionless
    C_l, zeros at l = 0, 1) for the primordial tensor power
    P_T = r A_s (k/kp)^{n_t + (alpha_t/2) ln(k/kp)}.

    ``params`` needs the scalar solver's keys plus 'r' (and optionally
    'n_t', 'alpha_t', resolved values - the Cosmology layer applies the
    slow-roll consistency defaults)."""
    if kmax is None:
        kmax = max(0.05, 1.7 * lmax / 13000.0)
    if ells is None:
        ells = bessel.default_ells(lmax)
    ells = np.asarray(ells)

    # spatial curvature [1/Mpc^2], static like the scalar Cl path
    import jax.errors as _jerr
    try:
        K = -float(params.get('omega_k', 0.0)) * (100.0 / _C_KMS) ** 2
    except (_jerr.ConcretizationTypeError, _jerr.TracerArrayConversionError):
        K = 0.0

    k_c = jnp.asarray(coarse_k_grid(kmax, kmin=tensor_cl_kmin(K)))
    src = compute_tensor_sources(params, thermo, k_c)
    src['K'] = K

    r, As, kp = params['r'], params['A_s'], params['k_pivot']
    n_t = params.get('n_t', 0.0)
    alpha_t = params.get('alpha_t', 0.0)

    def P_T(k):
        lnkkp = jnp.log(k / kp)
        return r * As * (k / kp) ** (n_t + 0.5 * alpha_t * lnkkp)

    x_max = float(kmax) * 1.05 * 16000.0
    if K < 0.0:  # open: the projection argument carries the sinh stretch
        u_h = np.sqrt(-K) * 16000.0
        x_max *= float(np.sinh(u_h) / u_h)
    # q > k for tensors in closed space too: widen by the worst eigenvalue
    if K > 0.0:
        x_max *= float(np.sqrt(1.0 + 3.0 * K / tensor_cl_kmin(K) ** 2))
    tables = bessel.bessel_tables(ells, x_max)
    raw = project_tensor_sources(src, ells, tables, P_T)

    out = {}
    for name in ['tt', 'ee', 'bb', 'te']:
        full = _spline_to_integers(ells, raw[name].astype(jnp.float64), lmax)
        out[name] = jnp.concatenate([jnp.zeros(2), full])
    out['ell'] = np.arange(lmax + 1)
    out['ells_sampled'] = ells
    out['raw_sampled'] = raw
    return out

"""Native CMB angular power spectra by line-of-sight integration.

Projects the perturbation solver's sources (perturbations.compute_los_sources)
onto the sky following Seljak & Zaldarriaga 1996:

    Delta_T,l(k) = int dtau { [g (Theta0 + psi + Pi/4) + e^-kappa (phi'+psi')] j_l(x)
                              + g (theta_b / k) j_l'(x) + (3/4) g Pi j_l''(x) }
    Delta_E,l(k) = sqrt((l+2)!/(l-2)!) int dtau (3/4) g Pi j_l(x) / x^2

with Pi = Theta_2 + G_0/4 + G_2/4 in TEMPERATURE units (the solver's
hierarchy stores MB95 brightness moments F_gl = 4 Theta_l, so the pol
source row carries (F_g2 + G_0 + G_2)/4),
    Delta_P,l(k) = -2 int_0^{chi*} dchi (chi*-chi)/(chi* chi) Psi_Weyl j_l(k chi)

with x = k (tau0 - tau), and C_l^XY = 4pi int dln k P_R(k) Delta_X Delta_Y.

The reference cannot produce any of these numbers natively: its Harmonic
sections import integrated Cls from external CLASS/CAMB builds
(cosmoprimo/classy.py:243-301, camb.py:657-713). Validation anchors are the
CLASS v3.1.1 Cl tables archived by the reference's own test suite
(tests/fiducial/abacus_cosm000_CLASSv3.1.1.00_cl.dat).

Static structure: no data-dependent shapes anywhere. The tau quadrature
and k grids are static templates whose VALUES adapt to the cosmology; the
Bessel tables are cosmology-independent (n_ell, n_x) arrays evaluated by
uniform-grid cubic-Hermite gathers; the per-multipole projection is a
`lax.map` whose body is two large (n_k, n_tau) elementwise blocks and a
matvec, with k on the trailing axis.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.spline import cubic_eval, linear_eval, natural_cubic_coeffs
from . import bessel
from .perturbations import _C_KMS, compute_los_sources

N_REC = 512           # leading tau-harvest nodes spanning z in [1690, 500]
N_QUAD_LATE = 1152    # geometric tau-quadrature nodes after recombination
DK_COARSE = 0.0045    # 1/Mpc; resolves the acoustic phase k r_s of the sources
DK_FINE = 1.1e-4      # 1/Mpc; resolves the Delta_l(k) oscillation (pi/chi*)
KMIN = 3e-5           # 1/Mpc
K_LOG_SWITCH = 0.0035  # below: 2%-log spacing, above: uniform tiers
K_MID = 0.02          # fine-grid mid-tier edge: below it the REIONIZATION
                      # projection oscillation (period pi/chi_reio ~ 3.3e-4
                      # 1/Mpc, vs pi/chi* ~ 2.2e-4 for recombination) still
                      # matters, so the spacing is halved. Measured: 2%-log
                      # spacing through k ~ 0.005-0.012 aliased BOTH
                      # oscillations (TT +-3% ringing at l ~ 40-60, TE 13%
                      # near zeros, EE +6% plateau at l ~ 20-70); uniform
                      # DK_FINE there hit a 3-samples/period resonance of
                      # the reionization oscillation (EE +15%).


K_LOG_SWITCH_COARSE = 0.012  # coarse grid: log spacing below (the source
                             # k-structure scale is ~1/eta_rec ~ 0.0036, so
                             # the ~9-11% log spacing stays well under it
                             # through this band), DK_COARSE above


def coarse_k_grid(kmax, n_log=56, dk=DK_COARSE, kmin=KMIN):
    """Static k grid the Boltzmann hierarchy is integrated on [1/Mpc]."""
    sw = K_LOG_SWITCH_COARSE
    n_lin = max(2, int(np.ceil((kmax - sw) / dk)) + 1)
    return np.concatenate([np.geomspace(kmin, sw, n_log, endpoint=False),
                           np.linspace(sw, kmax, n_lin)])


def fine_k_grid(kmax, dk=DK_FINE, rel_log=0.02, kmin=KMIN):
    """Static k grid the line-of-sight integral is evaluated on [1/Mpc]:
    2%-log below K_LOG_SWITCH (sub-oscillation scales), uniform dk/2 up to
    K_MID (both projection oscillations resolved, see K_MID note), uniform
    ``dk`` beyond (recombination oscillation only)."""
    k_mid = min(K_MID, kmax)
    n_mid = max(2, int(np.ceil((k_mid - K_LOG_SWITCH) / (0.5 * dk))) + 1)
    parts = [np.geomspace(kmin, K_LOG_SWITCH, max(
        2, int(np.ceil(np.log(K_LOG_SWITCH / kmin) / rel_log))), endpoint=False),
        np.linspace(K_LOG_SWITCH, k_mid, n_mid, endpoint=False)]
    if kmax > k_mid:
        n_lin = max(2, int(np.ceil((kmax - k_mid) / dk)) + 1)
        parts.append(np.linspace(k_mid, kmax, n_lin))
    else:
        parts.append(np.asarray([k_mid]))
    return np.concatenate(parts)


def sin_K(chi, K):
    """Comoving angular-diameter distance S_K(chi) [Mpc]; ``K`` [1/Mpc^2]
    is a static Python float (open K < 0, closed K > 0)."""
    if K > 0.0:
        s = np.sqrt(K)
        return jnp.sin(s * chi) / s
    if K < 0.0:
        s = np.sqrt(-K)
        return jnp.sinh(s * chi) / s
    return chi


def cl_kmin(K, kmin=KMIN):
    """Smallest propagating wavenumber kept on the Cl grids [1/Mpc].

    Open (K < 0): modes with k^2 <= -K are supercurvature — the radial
    eigenvalue q^2 = k^2 + K turns negative — so the grid starts just above
    the curvature scale. Closed (K > 0): the scalar eigenmodes are discrete,
    q = nu sqrt(K) with integer nu >= 3, i.e. k^2 >= 8 K; the continuum
    quadrature (standard for |Omega_k| <~ 0.1) starts at the first one."""
    if K < 0.0:
        return max(kmin, 1.05 * np.sqrt(-K))
    if K > 0.0:
        return max(kmin, np.sqrt(8.0 * K))
    return kmin


def _trapz_weights(x):
    dx = jnp.diff(x)
    return 0.5 * jnp.concatenate([dx[:1], dx[1:] + dx[:-1], dx[-1:]])


def _hermite_gather(tab_f, tab_fp, u):
    """Cubic-Hermite evaluation of a uniform-grid table at fractional index
    ``u`` (value grid spacing folded into tab_fp by the caller)."""
    n_x = tab_f.shape[-1]
    i0 = jnp.clip(u.astype(jnp.int32), 0, n_x - 2)
    t = (u - i0).astype(tab_f.dtype)
    f0, f1 = tab_f[i0], tab_f[i0 + 1]
    d0, d1 = tab_fp[i0], tab_fp[i0 + 1]
    t2 = t * t
    t3 = t2 * t
    return ((2.0 * t3 - 3.0 * t2 + 1.0) * f0 + (t3 - 2.0 * t2 + t) * d0
            + (-2.0 * t3 + 3.0 * t2) * f1 + (t3 - t2) * d1)


def project_sources(src, ell_list, tables, dtype=None, t_parts=(1.0, 1.0, 1.0, 1.0),
                    dk_fine=DK_FINE, n_quad_late=N_QUAD_LATE):
    """Line-of-sight projection + C_l quadrature for each sampled multipole.

    ``src``: output of perturbations.compute_los_sources on the COARSE k
    grid. ``tables``: (x_grid, j, jp) host arrays from bessel.bessel_tables
    aligned with ``ell_list``. Returns dict of (n_ell,) arrays: raw
    (dimensionless) C_l for tt, ee, te, pp, tp, ep.
    """
    k_c = src['k']
    kmax = float(k_c[-1])
    K = float(src.get('K', 0.0))
    k_f = jnp.asarray(fine_k_grid(kmax, dk=dk_fine, kmin=cl_kmin(K)))
    tau_h, eta0 = src['tau'], src['eta0']
    g, emk = src['g'], src['emk']

    # ---- tau quadrature grid: recombination harvest nodes + geometric tail
    tau_rec = tau_h[:N_REC]
    tau_late = jnp.geomspace(tau_h[N_REC], eta0 * (1.0 - 1e-9), n_quad_late + 1)[1:]
    tau_q = jnp.concatenate([tau_rec, tau_late])

    # physical (visibility-weighted) sources on the harvest grid, then
    # linearly resampled in tau (sources are smooth; the j_l oscillation is
    # carried exactly by the Bessel tables at the quadrature nodes)
    mono, dopp, pol, isw, weyl = (src['src'][:, i, :] for i in range(5))
    w_mono, w_dopp, w_pol, w_isw = t_parts  # diagnostic component toggles
    ST0 = w_mono * g * mono + w_isw * emk * isw
    ST1 = w_dopp * g * dopp
    ST2 = w_pol * 0.75 * g * pol
    chi_star = eta0 - src['tau_star']
    chi_h = eta0 - tau_h
    # lensing efficiency; with curvature the exact kernel replaces every
    # comoving distance by the geodesic-deviation distance S_K
    wlens = jnp.where((chi_h > 1e-4 * eta0) & (chi_h < chi_star),
                      -2.0 * sin_K(chi_star - chi_h, K)
                      / (sin_K(chi_star, K) * jnp.maximum(sin_K(chi_h, K), 1e-12)), 0.0)
    SP = weyl * wlens

    S = jnp.stack([ST0, ST1, ST2, SP], axis=1)            # (nk_c, 4, n_h)
    S_q = linear_eval(tau_h, jnp.moveaxis(S, -1, 0), tau_q)  # (n_q, nk_c, 4)

    # ---- cubic spline in k onto the fine grid
    Sk = jnp.moveaxis(S_q, 1, 0)                           # (nk_c, n_q, 4)
    M = natural_cubic_coeffs(k_c, Sk)
    S_f = cubic_eval(k_c, Sk, M, k_f)                      # (nK, n_q, 4)

    if dtype is not None:
        S_f = S_f.astype(dtype)
    ST0f, ST1f, ST2f, SPf = (S_f[..., i] for i in range(4))

    x_grid, j_tab, jp_tab = tables
    dx = float(x_grid[1] - x_grid[0])
    rdtype = S_f.dtype
    j_tab = jnp.asarray(j_tab, dtype=rdtype)
    # fold dx into the derivative table once: Hermite slopes are per-cell
    jp_tab_scaled = jnp.asarray(jp_tab, dtype=rdtype) * rdtype.type(dx)
    jp_tab_raw = jnp.asarray(jp_tab, dtype=rdtype)

    chi_q = (eta0 - tau_q).astype(rdtype)
    # radial projection argument. Flat: x = k chi. Curved: the hyperspherical
    # radial functions Phi_l^nu(chi) (nu = q / sqrt|K|, q^2 = k^2 + K for
    # scalars) are approximated by j_l(q S_K(chi)) — the geodesic mapping
    # that places the WKB turning point q S_K(chi) ~ l + 1/2 at the exact
    # angular scale. Error is O(K / q^2) per mode — certified against an
    # exact radial-ODE hyperspherical-Bessel oracle in
    # tests/test_curved_harmonic.py: at the |Omega_k| = 0.12 window edge
    # the Cl-proxy error is <= 7.5% at l <= 5 and < 0.1% by l = 50; the
    # dominant curvature effect — the angular-diameter remapping of the
    # acoustic scale — is captured exactly. The primordial spectrum below
    # keeps the flat power law in k (alternative curved-measure
    # conventions differ by 1 + O(K/q^2) factors, inside the same
    # certified low-l budget).
    q_f = jnp.sqrt(jnp.maximum(k_f.astype(rdtype) ** 2 + rdtype.type(K),
                               rdtype.type(0.0)))
    x = q_f[:, None] * sin_K(chi_q, K)[None, :].astype(rdtype)   # (nK, n_q)
    u = x / rdtype.type(dx)
    w_q = _trapz_weights(tau_q).astype(rdtype)

    ells = jnp.asarray(np.asarray(ell_list, dtype=np.float64), dtype=rdtype)
    prefE = jnp.sqrt((ells + 2.0) * (ells + 1.0) * ells * (ells - 1.0))

    # primordial curvature spectrum and ln-k quadrature weights
    w_k = _trapz_weights(k_f) / k_f
    if 'P_R_params' in src:
        ns, As, kp, *run = src['P_R_params']
        alpha_s, beta_s = run if run else (0.0, 0.0)
        lnkkp = jnp.log(k_f / kp)
        P_R = As * (k_f / kp) ** (ns - 1.0 + 0.5 * alpha_s * lnkkp
                                  + beta_s / 6.0 * lnkkp ** 2)
    else:
        P_R = src['P_R']
    pr = w_k * 4.0 * jnp.pi * P_R
    xinv2 = (1.0 / jnp.maximum(x, rdtype.type(dx))) ** 2

    def one_ell(i):
        ell = ells[i]
        l2 = ell * (ell + 1.0)
        # j'' at the query from the Bessel ODE needs j and j' at the query:
        # j from (j, j') Hermite; j' from (j', j'') Hermite with nodal j''
        # reconstructed from the ODE - all gathers share the same index.
        jl = _hermite_gather(j_tab[i], jp_tab_scaled[i], u)
        # nodal j'' table for this ell, from the ODE at the NODES
        xn = jnp.maximum(x_grid.astype(rdtype), rdtype.type(dx))
        jpp_nodes = (l2 / xn ** 2 - 1.0) * j_tab[i] - (2.0 / xn) * jp_tab_raw[i]
        jlp = _hermite_gather(jp_tab_raw[i], jpp_nodes * rdtype.type(dx), u)
        jlpp = (l2 * xinv2 - 1.0) * jl - 2.0 * jnp.sqrt(xinv2) * jlp

        dT = (ST0f * jl + ST1f * jlp + ST2f * jlpp) @ w_q   # (nK,)
        # E source is (3/4) g Pi = ST2, with Pi in temperature units
        # (Zaldarriaga-Seljak 1997; the pol row is (F_g2+G_0+G_2)/4)
        dE = prefE[i] * ((ST2f * jl * xinv2) @ w_q)
        dP = (SPf * jl) @ w_q
        return jnp.stack([pr @ (dT * dT), pr @ (dE * dE), pr @ (dT * dE),
                          pr @ (dP * dP), pr @ (dT * dP), pr @ (dE * dP)])

    out = jax.lax.map(one_ell, jnp.arange(len(ell_list)))
    return {'tt': out[:, 0], 'ee': out[:, 1], 'te': out[:, 2],
            'pp': out[:, 3], 'tp': out[:, 4], 'ep': out[:, 5]}


def limber_pp(src, ells):
    """Limber-approximated lensing-potential spectrum from the same LOS
    Weyl source table:

        C_l^pp = (2 pi^2 / nu^3) int dchi  chi P_R(nu/chi)
                 [wlens(chi) T_weyl(k = nu/chi, chi)]^2,   nu = l + 1/2.

    Replaces the exact projection at l >~ 400 where the exact path has two
    systematic failure modes the TT/EE design never hits (their sources are
    visibility-localized at recombination):

    - the shared tau quadrature (geometric, ~1e3 nodes over the full line
      of sight) ALIASES the j_l(k chi) oscillation along the broad lensing
      kernel: measured +7-10% on C_l^pp at l = 500-1500 vs the archived
      CLASS table;
    - the TT-sized k grid truncates the low-chi (high-k = nu/chi) part of
      the kernel: -24% at l = 2500.

    Limber needs neither Bessel tables nor the fine k grid - only the
    smooth source on the (dense) harvest grid, evaluated at k = nu/chi by
    a cubic spline in k - so the k support can be extended with a cheap
    log tail on the COARSE (hierarchy) grid alone (see compute_cls).
    Limber error on the broad pp kernel is O(nu^-2) (LoVerde & Afshordi
    2008): sub-percent for l >~ 300."""
    k_c = src['k']
    K = float(src.get('K', 0.0))
    tau_h, eta0 = src['tau'], src['eta0']
    chi = eta0 - tau_h
    sk = sin_K(chi, K)
    chi_star = eta0 - src['tau_star']
    weyl = src['src'][:, 4, :]                               # (nk, n_h)
    wlens = jnp.where((chi > 1e-4 * eta0) & (chi < chi_star),
                      -2.0 * sin_K(chi_star - chi, K)
                      / (sin_K(chi_star, K) * jnp.maximum(sk, 1e-12)), 0.0)
    SP = weyl * wlens                                        # (nk, n_h)
    M = natural_cubic_coeffs(k_c, SP)
    ns, As, kp, *run = src['P_R_params']
    alpha_s, beta_s = run if run else (0.0, 0.0)
    w_tau = _trapz_weights(tau_h)                            # |dchi| weights
    sk_s = jnp.maximum(sk, 1e-3)

    def one_ell(ell):
        nu = ell + 0.5
        # curved Limber: the radial eigenvalue q = nu / S_K(chi) maps to the
        # physical wavenumber k = sqrt(q^2 - K) the 3D spectra are tabulated
        # against; the flat-measure chi becomes S_K (flat: both reduce to
        # k = nu / chi, measure chi)
        qq = nu / sk_s
        kq = jnp.sqrt(jnp.maximum(qq ** 2 - K, 1e-30))
        Sq = jax.vmap(lambda f1, M1, x1: cubic_eval(k_c, f1, M1, x1[None])[0],
                      in_axes=(1, 1, 0))(SP, M, kq)          # (n_h,)
        lnkkp = jnp.log(kq / kp)
        P_R = As * (kq / kp) ** (ns - 1.0 + 0.5 * alpha_s * lnkkp
                                 + beta_s / 6.0 * lnkkp ** 2)
        val = sk * P_R * Sq ** 2
        val = jnp.where((kq <= k_c[-1]) & (kq >= k_c[0]), val, 0.0)
        return (2.0 * jnp.pi ** 2 / nu ** 3) * jnp.sum(val * w_tau)

    return jax.lax.map(one_ell, jnp.asarray(np.asarray(ells, dtype=np.float64)))


def _spline_to_integers(ells, cl, lmax):
    """Cubic spline of D_l = l(l+1) C_l against ln l onto all integers
    2..lmax (sign-preserving: D_l is splined directly, not its log)."""
    ell_i = jnp.arange(2, lmax + 1, dtype=jnp.float64)
    lnl = jnp.log(jnp.asarray(ells, dtype=jnp.float64))
    D = jnp.asarray(ells, dtype=jnp.float64) * (jnp.asarray(ells) + 1.0) * cl
    M = natural_cubic_coeffs(lnl, D)
    Di = cubic_eval(lnl, D, M, jnp.log(ell_i))
    return Di / (ell_i * (ell_i + 1.0))


LIMBER_PP_LO = 250    # pp: exact LOS below, Limber above, linear blend between
LIMBER_PP_HI = 420


def compute_cls(params, thermo, lmax=2500, kmax=None, ells=None, dtype=None,
                kmax_pp=None):
    """Unlensed scalar CMB spectra, natively integrated.

    Returns a dict of (lmax+1,) arrays ('tt','ee','bb','te','pp','tp','ep'),
    raw dimensionless C_l with the l = 0, 1 entries zero (CLASS raw_cl
    convention; multiply tt by (T_cmb 1e6)^2 for muK^2).

    ``kmax`` bounds the TT/EE/TE projection (default 2.4 lmax / 13000, the
    CLASS k_max_tau0_over_l_max heuristic); ``kmax_pp`` (default
    max(kmax, lmax/2100)) extends the COARSE hierarchy grid with a 4%-log
    tail feeding the Limber lensing-potential evaluation only - the fine
    projection grid and Bessel tables stay sized by ``kmax``.
    """
    if kmax is None:
        kmax = max(0.12, 2.4 * lmax / 13000.0)
    if kmax_pp is None:
        kmax_pp = max(kmax, lmax / 2100.0)
    if ells is None:
        ells = bessel.default_ells(lmax)
    ells = np.asarray(ells)
    # late-time tau quadrature: the j_l(k (eta0 - tau)) oscillation has a
    # k-dependent but tau-INDEPENDENT period 2 pi / k, so the geometric
    # late grid is coarsest exactly where high-k aliasing bites. Scale the
    # node count with lmax (~ kmax): measured at lmax 5000 the 1152-node
    # default left a +15..110% TT noise floor at l >= 4000; 0.82 lmax
    # (= 4096 at lmax 5000) is converged (identical to 6144 nodes).
    n_quad_late = max(N_QUAD_LATE, int(0.82 * lmax))

    # spatial curvature [1/Mpc^2]: static in the Cl path (the Harmonic
    # section guards concreteness); traced params keep the flat contract
    try:
        K = -float(params.get('omega_k', 0.0)) * (100.0 / _C_KMS) ** 2
    except (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError):
        K = 0.0

    # full step budget: the LOS source tap is per-step, so the harvested
    # acoustic sources through recombination lose fidelity at the reduced
    # (transfer-grade) tiers - measured as band failures in test_harmonic
    k_main = coarse_k_grid(kmax, kmin=cl_kmin(K))
    n_main = len(k_main)
    if kmax_pp > kmax * 1.001:
        n_tail = max(2, int(np.ceil(np.log(kmax_pp / kmax) / 0.04)))
        k_tail = kmax * np.exp(np.arange(1, n_tail + 1)
                               * np.log(kmax_pp / kmax) / n_tail)
        k_c = jnp.asarray(np.concatenate([k_main, k_tail]))
    else:
        k_c = jnp.asarray(k_main)
    src = compute_los_sources(params, thermo, k_c)
    src['P_R_params'] = (params['n_s'], params['A_s'], params['k_pivot'],
                         params.get('alpha_s', 0.0), params.get('beta_s', 0.0))
    src['K'] = K

    # Bessel tables sized by a conservative static horizon bound; in an
    # open geometry the projection argument is q S_K(chi) >= q chi, so the
    # bound carries the sinh stretch at the horizon
    x_max = float(kmax) * 1.05 * 16000.0
    if K < 0.0:
        u_h = np.sqrt(-K) * 16000.0
        x_max *= float(np.sinh(u_h) / u_h)
    tables = bessel.bessel_tables(ells, x_max)

    # exact LOS projection on the main (TT-sized) k grid only
    src_main = dict(src)
    src_main['k'] = src['k'][:n_main]
    src_main['src'] = src['src'][:n_main]
    raw = project_sources(src_main, ells, tables, dtype=dtype,
                          n_quad_late=n_quad_late)

    # lensing potential: Limber at high l (see limber_pp)
    pp_lim = limber_pp(src, ells)
    w_lim = jnp.clip((jnp.asarray(ells, dtype=jnp.float64) - LIMBER_PP_LO)
                     / (LIMBER_PP_HI - LIMBER_PP_LO), 0.0, 1.0)
    raw['pp'] = (1.0 - w_lim) * raw['pp'] + w_lim * pp_lim.astype(raw['pp'].dtype)

    out = {}
    for name in ['tt', 'ee', 'te', 'pp', 'tp', 'ep']:
        full = _spline_to_integers(ells, raw[name].astype(jnp.float64), lmax)
        out[name] = jnp.concatenate([jnp.zeros(2), full])
    out['bb'] = jnp.zeros(lmax + 1)
    out['ell'] = np.arange(lmax + 1)
    out['ells_sampled'] = ells
    out['raw_sampled'] = raw
    return out

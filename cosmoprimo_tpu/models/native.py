"""Native Boltzmann engine: thermodynamics (and, progressively, linear
perturbations) computed on device with no external C code.

The reference has no counterpart: it obtains z_star/z_drag/rs_drag and the
full ionization history exclusively from CLASS or CAMB
(cosmoprimo/classy.py get_thermodynamics, camb.py:get_derived_params), and
its analytic engines fall back to the EH98/HS96 fitting formulas
(eisenstein_hu.py), which are ~2% off CLASS truth on rs_drag. This engine's
recombination history (boltzmann/thermodynamics.py) lands within ~0.1% of
CLASS on z_star/z_drag and ~5e-4 on rs_drag for the DESI fiducial —
validated against the CLASS v3.1.1 background table the reference archives
(tests/fiducial/abacus_cosm000_CLASSv3.1.1.00_background.dat) — while
remaining jit/vmap/jacfwd-clean.

Sections: Background (closed-form + ODE tables, as the analytic engines),
Thermodynamics (native), Primordial (standard power-law with runnings),
Transfer and Fourier (native Einstein-Boltzmann integration,
boltzmann/perturbations.py: linear P(k) within 0.35% of CLASS at every
k in 0.001-5 h/Mpc, validated against the CLASS v3.1.1 tables archived
by the reference test suite), Harmonic
(native line-of-sight CMB Cls + correlation-function lensing,
boltzmann/harmonic.py / lensing.py), and Perturbations (per-k
Newtonian-gauge source time-series, the classy get_perturbations
surface) - the full seven-section surface. The massive-neutrino sector
carries one exact momentum hierarchy per species (normal/inverted/
degenerate splits are solved per-mass, not combined); w0/wa dark energy
carries CLP fluid perturbations (rest-frame cs2_fld, regularized across
w = -1 - CLASS 'fld' with use_ppf=no). Spatial curvature is supported
through the whole background/transfer/P(k) path (Hu & Eisenstein 1998
curved longitudinal-gauge constraints + hyperspherical hierarchy
couplings, boltzmann/perturbations.py _curv). The CMB Harmonic section
serves scalar Cls for |Omega_k| <= 0.12 via the geodesic radial
projection j_l(q S_K(chi)) (boltzmann/harmonic.py; certified against an
exact hyperspherical-Bessel oracle in tests/test_curved_harmonic.py) and
raises beyond that window; tensor Cls (r > 0) share it via the
geodesic projection with the tensor eigenvalue q^2 = k^2 + 3K.
"""

import numpy as np
import jax.numpy as jnp

from .. import utils
from ..boltzmann import compute_thermodynamics
from ..cosmology import BaseEngine, BaseSection, CosmologyInputError, cl_table, register_engine, register_section
from ..interpolator import PowerSpectrumInterpolator2D
from .eisenstein_hu import Primordial  # noqa: F401  (standard power-law primordial)
from ..cosmology import DefaultBackground as Background  # noqa: F401

DEFAULT_Z_PK = (0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0, 20.0, 49.0)


@register_engine
class NativeEngine(BaseEngine):
    """Engine computing thermodynamics and linear perturbations natively
    (traced JAX). Calculation knobs via ``extra_params``: ``nk_pk``
    (default 256 log-spaced k in [1e-4, kmax_pk] h/Mpc), plus the standard
    ``kmax_pk`` / ``z_pk`` cosmology parameters."""

    name = 'native'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        self._A_s = self._get_A_s_fid()

    def _perturbation_params(self):
        """Plain parameter dict for boltzmann.perturbations. The full
        per-species neutrino mass spectrum is passed through (each species
        carries its own momentum hierarchy in the solver); all species
        share the standard T_ncdm. Spatial curvature (omega_k) enters the
        solver's background and Einstein constraints (boltzmann/
        perturbations.py _curv); the CMB Harmonic section additionally
        serves curved scalar AND tensor Cls for |Omega_k| <= 0.12
        (geodesic radial projection, tests/test_curved_harmonic.py;
        tensor eigenvalue q^2 = k^2 + 3K) and raises beyond."""
        p = {n: self[n] for n in ['omega_b', 'omega_cdm', 'h', 'T_cmb', 'N_ur',
                                  'w0_fld', 'wa_fld', 'n_s', 'k_pivot',
                                  'alpha_s', 'beta_s', 'omega_k']}
        p['A_s'] = self._A_s
        import jax
        m = jnp.atleast_1d(jnp.asarray(self['m_ncdm']))
        massless = m.size == 0
        if not massless:
            try:
                massless = float(jnp.sum(m)) == 0.0
            except (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError):
                massless = False  # traced masses: keep the ncdm sector
        if massless:
            p['m_ncdm'] = 0.0
            p['T_ncdm_over_cmb'] = 0.71611
            p['omega_ncdm'] = 0.0
        else:
            p['m_ncdm'] = m
            p['T_ncdm_over_cmb'] = jnp.atleast_1d(jnp.asarray(self['T_ncdm_over_cmb']))[0]
            p['omega_ncdm'] = jnp.sum(jnp.atleast_1d(jnp.asarray(self['omega_ncdm'])))
        return p

    def pk_tables(self):
        """(k [h/Mpc], z, pk_m, pk_cb [(Mpc/h)^3], transfers) from the
        native Einstein-Boltzmann integration; computed once and cached."""
        if getattr(self, '_pk_tables', None) is None:
            from ..boltzmann.perturbations import linear_pk, steps_for_kmax
            nk = int(self._extra_params.get('nk_pk', 256))
            kmax = float(self['kmax_pk'])
            kmin = 1e-4
            import jax
            try:
                h = float(self['h'])
                omega_k = float(self['Omega_k']) * h ** 2
                if omega_k < 0.0:
                    # closed: keep the static grid above the curvature
                    # scale - modes with k^2 <~ 3K have no discrete
                    # eigenmode and their (saturated-ratio) lanes would
                    # poison the interpolator's low-k log-extrapolation
                    from .. import constants
                    K = -omega_k * (100.0 / (constants.c / 1e3)) ** 2
                    kmin = max(kmin, 3.2 * np.sqrt(3.0 * K) / h)
            except (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError):
                pass  # traced params: flat-grid contract (documented)
            k = jnp.asarray(np.geomspace(kmin, kmax, nk))
            z_pk = self['z_pk']
            z = np.asarray(DEFAULT_Z_PK if z_pk is None else np.atleast_1d(z_pk), dtype=np.float64)
            z = np.unique(np.concatenate([z, [0.0]]))
            th = self.get_section('thermodynamics')._th
            # step budget tiered by the static kmax (kmax is in h/Mpc and
            # h < 1, so it bounds kmax in 1/Mpc); extra_params can pin it
            n_steps = self._extra_params.get('n_steps_pk', steps_for_kmax(kmax))
            out = linear_pk(self._perturbation_params(), th, k, list(z),
                            n_steps=n_steps)
            self._pk_tables = (k, jnp.asarray(z), out['pk_m'], out['pk_cb'], out['transfers'])
        return self._pk_tables

    def unl_tables(self, lmax):
        """Unlensed CMB spectra computed to ``lmax + lensing_margin``
        (extra_params, default 400) and cached, so a later lensed_cl call
        at the same ``lmax`` reuses them (the margin keeps the
        correlation-function remapping unbiased at the output edge).

        With ``r > 0`` the native tensor solver's contributions
        (boltzmann/tensor.py) are added to tt/ee/te and provide the
        non-zero unlensed BB, up to ``ellmax_tensor`` (extra_params,
        default 600 - tensor spectra are damping-suppressed above
        l ~ 500 and the reference's CLASS default caps them similarly)."""
        margin = int(self._extra_params.get('lensing_margin', 400))
        cache = getattr(self, '_unl_cache', None)
        if cache is None or cache[0] < lmax + margin:
            from ..boltzmann import harmonic
            th = self.get_section('thermodynamics')._th
            # kmax_cl (extra_params) widens the k support beyond the TT/EE
            # heuristic (2.4 lmax / 13000): the lensing-potential kernel
            # peaks at chi ~ 3400 Mpc, so pp at multipole l draws on
            # k ~ l / 3400 — well above l / chi_star (see test_harmonic).
            kmax = self._extra_params.get('kmax_cl', None)
            unl = harmonic.compute_cls(self._perturbation_params(), th,
                                       lmax=lmax + margin, kmax=kmax,
                                       kmax_pp=self._extra_params.get('kmax_pp', None))
            import jax
            try:
                has_tensors = float(self['r']) > 0.0
            except (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError):
                raise CosmologyInputError(
                    'tensor Cls need a concrete r (engine built inside jit/vmap)')
            if has_tensors:
                from ..boltzmann import tensor
                lmax_t = min(lmax + margin,
                             int(self._extra_params.get('ellmax_tensor', 600)))
                pp = self._perturbation_params()
                pp['r'] = self['r']
                pp['n_t'] = self['n_t']
                pp['alpha_t'] = self['alpha_t']
                ten = tensor.compute_tensor_cls(pp, th, lmax=lmax_t)
                pad = lmax + margin - lmax_t
                for name in ('tt', 'ee', 'te', 'bb'):
                    add = jnp.concatenate([ten[name], jnp.zeros(pad)]) if pad > 0 else ten[name]
                    unl[name] = unl[name] + add
            cache = (lmax + margin, unl)
            self._unl_cache = cache
        return cache[1]

    def lensed_tables(self, lmax):
        """Lensed CMB spectra up to ``lmax`` (cached); computed lazily from
        :meth:`unl_tables` only when a lensed spectrum is requested, so
        unlensed-only workflows never pay for the lensing convolution."""
        cache = getattr(self, '_lens_cache', None)
        if cache is None or cache[0] < lmax:
            from ..boltzmann import lensing
            unl = self.unl_tables(lmax)
            lens = lensing.lensed_cls(unl['tt'], unl['ee'], unl['bb'], unl['te'],
                                      unl['pp'], lmax=lmax)
            self._lens_cache = (lmax, lens)
        return self._lens_cache[1]

    def cl_tables(self, lmax):
        """(unlensed, lensed) spectra up to ``lmax`` — see unl_tables /
        lensed_tables (kept for compatibility; forces both)."""
        return self.unl_tables(lmax), self.lensed_tables(lmax)

    def tree_flatten(self):
        children, aux = super().tree_flatten()
        children = children + (getattr(self, '_A_s', None),)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = super().tree_unflatten(aux, children[:-1])
        new._A_s = children[-1]
        return new


@register_section
@utils.addproperty('rs_drag', 'z_drag', 'rs_star', 'z_star', 'tau_reio',
                   'z_reio', 'YHe', 'z_star_noreion')
class Thermodynamics(BaseSection):
    """Native recombination history and derived scalars.

    Surface parity with the class/camb Thermodynamics sections
    (models/classy.py:231, models/camb.py:435): rs_drag/rs_star in Mpc/h,
    z_drag/z_star, z_star_noreion (CAMB's zstar convention), theta_star,
    theta_cosmomc, plus the history itself: x_e(z), T_b(z)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine
        ba = engine.get_section('background')
        th = compute_thermodynamics(
            engine['omega_b'], engine['h'], engine['T_cmb'], ba.efunc,
            tau_reio=engine['tau_reio'],
            reionization_width=engine['reionization_width'],
            N_eff=engine['N_eff'])
        self._th = th
        self._rs_drag = ba.rs(th.z_drag)
        self._rs_star = ba.rs(th.z_star)
        self._z_drag = th.z_drag
        self._z_star = th.z_star
        self._z_star_noreion = th.z_star_noreion
        self._tau_reio = th.tau_reio
        self._z_reio = th.z_reio
        self._YHe = th.YHe

    @property
    def _ba(self):
        return self._engine.get_section('background')

    @property
    def table(self):
        """The full :class:`ThermodynamicsResult` (ln a grid tables)."""
        return self._th

    def x_e(self, z):
        """Free-electron fraction (per hydrogen nucleus) at z."""
        lna = -jnp.log1p(jnp.asarray(z, dtype=jnp.float64))
        return jnp.interp(lna, self._th.lna, self._th.x_e)

    def T_b(self, z):
        """Baryon (matter) temperature [K] at z."""
        lna = -jnp.log1p(jnp.asarray(z, dtype=jnp.float64))
        return jnp.interp(lna, self._th.lna, self._th.T_m)

    @property
    def rs_star_noreion(self):
        """Comoving sound horizon at z_star_noreion, in Mpc/h."""
        return self._ba.rs(self._z_star_noreion)

    @property
    def theta_star(self):
        """Sound-horizon angle rs_star / D_M(z_star), in radians."""
        return self.rs_star / self._ba.comoving_transverse_distance(self.z_star)

    @property
    def theta_cosmomc(self):
        """CosmoMC approximation to the sound-horizon angle."""
        from ..cosmology import _compute_rs_cosmomc
        h = self._engine['h']
        rs, zstar = _compute_rs_cosmomc(self._engine['Omega_b'] * h ** 2,
                                        self._engine['Omega_m'] * h ** 2,
                                        self._ba.hubble_function)
        return rs * h / self._ba.comoving_transverse_distance(zstar)


@register_section
class Transfer(BaseSection):
    """Native transfer functions (CAMB rescaled convention -T_i/k^2 with
    k in 1/Mpc, normalized to initial curvature R = 1), per species and at
    each z of the engine's z_pk grid - the table the reference can only
    import from CLASS (classy.py Transfer)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine
        self._h = engine['h']

    def table(self, z=0.0):
        """Dict of k [h/Mpc] and rescaled transfers d_cdm, d_b, d_g, d_ur,
        d_ncdm, d_m, d_cb at the z_pk point nearest to ``z``."""
        k, zs, _, _, tr = self._engine.pk_tables()
        iz = int(np.argmin(np.abs(np.asarray(zs) - z)))
        kMpc = k * self._h
        out = {'k': k, 'z': zs[iz]}
        for name in ['delta_cdm', 'delta_b', 'delta_g', 'delta_ur', 'delta_ncdm',
                     'delta_m', 'delta_cb', 'phi']:
            out['d_' + name[6:] if name.startswith('delta_') else name] = -tr[name][iz] / kMpc ** 2
        return out


@register_section
class Perturbations(BaseSection):
    """Native Newtonian-gauge perturbation source tables.

    Surface parity with the class engine's Perturbations section
    (models/classy.py Perturbations, reference classy.py:231-234,415):
    ``table()`` returns one structured array per requested k mode, each a
    conformal-time series of the gauge potentials and species
    (delta, theta, shear) fluctuations - here computed by the native
    Einstein-Boltzmann integration instead of an external CLASS build.

    The k modes (h/Mpc) come from ``extra_params['k_output_values']``
    (scalar or sequence; default (0.01, 0.1, 1.0), mirroring CLASS's
    ``k_output_values`` input).
    """

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine

    def table(self):
        r"""List of structured arrays (one per k of ``k_output_values``)
        with fields 'tau [Mpc]', 'a', and the MB95 Newtonian-gauge
        perturbations (delta_g, theta_g, shear_g, delta_b, theta_b,
        delta_cdm, theta_cdm, delta_ur, theta_ur, delta_ncdm, theta_ncdm,
        phi, psi), normalized to comoving curvature R = 1."""
        from ..boltzmann.perturbations import compute_perturbation_series
        k_out = self._engine._extra_params.get('k_output_values', (0.01, 0.1, 1.0))
        k_h = np.atleast_1d(np.asarray(k_out, dtype=np.float64))
        h = float(self._engine['h'])
        th = self._engine.get_section('thermodynamics')._th
        from ..boltzmann.perturbations import steps_for_kmax
        out = compute_perturbation_series(self._engine._perturbation_params(),
                                          th, jnp.asarray(k_h * h),
                                          n_steps=steps_for_kmax(k_h.max()))
        tau = np.asarray(out['tau'])
        a = np.asarray(out['a'])
        series = np.asarray(out['series'])  # (nk, n_names, n_tau)
        names = list(out['names'])
        dtype = [('tau [Mpc]', np.float64), ('a', np.float64)]
        dtype += [(name, np.float64) for name in names]
        tables = []
        for ik in range(k_h.size):
            arr = np.empty(tau.size, dtype=dtype)
            arr['tau [Mpc]'] = tau
            arr['a'] = a
            for i, name in enumerate(names):
                arr[name] = series[ik, i]
            tables.append(arr)
        return tables


@register_section
class Harmonic(BaseSection):
    """Natively integrated CMB angular power spectra.

    Surface parity with the class/camb Harmonic sections (models/classy.py:372,
    reference classy.py:243-301): ``unlensed_cl`` / ``lensed_cl`` /
    ``lens_potential_cl`` returning raw dimensionless C_l tables, negative
    ``ellmax`` resolved against the ``ellmax_cl`` cosmology parameter,
    sigma8-rescaling applied multiplicatively. The spectra themselves come
    from the native line-of-sight projection (boltzmann/harmonic.py) and the
    correlation-function lensing convolution (boltzmann/lensing.py) - numbers
    the reference can only import from an external CLASS/CAMB build.

    Accuracy vs the archived CLASS v3.1.1 spectra (DESI fiducial),
    CI-enforced by tests/test_harmonic.py (banded bars at ellmax 800,
    default-config lmax-2500 and lmax-3500 spot checks) and measured to
    l = 5000 (doc/parity.md carries the table): TT within 0.3% for
    l <= 100, 1.2% for 100 <= l <= 2000, -1.7% at l = 2500; EE within
    1.7% through the reionization shoulder and 2.7% at high l; TE within
    1.5% of the sqrt(TT*EE) envelope; lensing potential within 6.7% at
    l <= 100 (exact-LOS region) and 1.2% through the Limber regime
    l in [250, 2500]; lensed spectra add <0.3% convolution error on top
    of the unlensed inputs. ``ellmax_cl`` is served up to 5000 (the
    archived truth's extent) with the RECFAST-grade damping tail
    degrading smoothly: TT -2.9% at l = 3000, -5.2% at 3500, -11% at
    5000 (EE similar; the tau quadrature scales with lmax so no
    aliasing noise floor remains). With r > 0 the tensor contributions
    (boltzmann/tensor.py) are included and BB is non-zero.
    """

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine
        import jax
        try:
            omega_k = abs(float(engine['Omega_k']))
        except (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError):
            omega_k = 0.0  # tracers: flat contract (enforced on concrete inputs only)
        if omega_k > 0.12:
            raise CosmologyInputError(
                'native CMB Cls support |Omega_k| <= 0.12: the hyperspherical '
                'radial functions are served by the geodesic projection '
                'j_l(q S_K(chi)), whose O(K/q^2) error is certified only in '
                'that window (tests/test_curved_harmonic.py).')
        # tensor Cls (r > 0) share the scalar window: the projection uses
        # the geodesic mapping x = q S_K(chi) with the tensor eigenvalue
        # q^2 = k^2 + 3K (boltzmann/tensor.py project_tensor_sources)
        self._rsigma8 = engine._rescale_sigma8()
        self.ellmax_cl = engine['ellmax_cl']

    def _resolve_ellmax(self, ellmax):
        if ellmax < 0:
            ellmax = self.ellmax_cl + 1 + ellmax
        return ellmax

    def _cl_dict(self, table, names, lmax):
        scale = jnp.asarray(self._rsigma8) ** 2
        out = {name: jnp.asarray(table[name])[:lmax + 1] * scale for name in names}
        out['ell'] = np.arange(lmax + 1)
        return cl_table(out)

    def unlensed_cl(self, ellmax=-1):
        r"""Unlensed scalar :math:`C_\ell` ['tt', 'ee', 'bb', 'te'], unitless."""
        lmax = self._resolve_ellmax(ellmax)
        unl = self._engine.unl_tables(lmax)
        return self._cl_dict(unl, ('tt', 'ee', 'bb', 'te'), lmax)

    def lensed_cl(self, ellmax=-1):
        r"""Lensed :math:`C_\ell` ['tt', 'ee', 'bb', 'te'], unitless."""
        lmax = self._resolve_ellmax(ellmax)
        lens = self._engine.lensed_tables(lmax)
        return self._cl_dict(lens, ('tt', 'ee', 'bb', 'te'), lmax)

    def lens_potential_cl(self, ellmax=-1):
        r"""Lensing-potential :math:`C_\ell` ['pp', 'tp', 'ep'], unitless."""
        lmax = self._resolve_ellmax(ellmax)
        unl = self._engine.unl_tables(lmax)
        return self._cl_dict(unl, ('pp', 'tp', 'ep'), lmax)


@register_section
class Fourier(BaseSection):
    """Linear power spectra from the native Boltzmann integration, served
    through the standard (k, z)-table interface (reference classy.py
    Fourier): pk_interpolator / pk_kz / sigma_rz / sigma8_z / sigma8_m."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine
        self._h = engine['h']
        self._rsigma8 = engine._rescale_sigma8()

    def table(self, non_linear=False, of='delta_m'):
        if non_linear:
            raise CosmologyInputError('The native engine serves linear P(k); apply halofit/hmcode via pipelines.apply_non_linear.')
        k, z, pk_m, pk_cb, tr = self._engine.pk_tables()
        if of in ('delta_m', ('delta_m', 'delta_m')):
            pk = pk_m
        elif of in ('delta_cb', ('delta_cb', 'delta_cb')):
            pk = pk_cb
        else:
            raise CosmologyInputError(f'Native engine provides delta_m / delta_cb spectra, not {of}.')
        return k, z, (pk * jnp.asarray(self._rsigma8) ** 2).T

    def pk_interpolator(self, non_linear=False, of='delta_m', **kwargs):
        k, z, pk = self.table(non_linear=non_linear, of=of)
        return PowerSpectrumInterpolator2D(k, z, pk, **kwargs)

    def pk_kz(self, k, z, non_linear=False, of='delta_m'):
        return self.pk_interpolator(non_linear=non_linear, of=of)(k, z)

    def sigma_rz(self, r, z, of='delta_m', **kwargs):
        return self.pk_interpolator(of=of, **kwargs).sigma_rz(r, z)

    def sigma8_z(self, z, of='delta_m'):
        return self.sigma_rz(8.0, z, of=of)

    @property
    def sigma8_m(self):
        return self.sigma8_z(0.0, of='delta_m')

    @property
    def sigma8_cb(self):
        return self.sigma8_z(0.0, of='delta_cb')

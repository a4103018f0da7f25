"""CLASS-family Boltzmann engines ('class' and published variants) with the
full seven-section surface.

Import design (SURVEY.md §7 stage 11): the external native code
runs ON HOST once per cosmology; scalars are read directly and z-dependent
quantities are imported as TABLES on dense grids, then served through this
framework's splines as device arrays. Nothing external sits inside a trace.

Section surface matches the reference CLASS wrapper
(cosmoprimo/classy.py:88-436): Background (host-table-backed E(z),
distances, growth), Thermodynamics (+ z_star_noreion / rs_star_noreion /
theta_star_noreion / theta_cosmomc extras, classy.py:107-146), Primordial,
Perturbations, Transfer, Harmonic, Fourier (of-tuple tables). Unlike the
closed-form DefaultBackground, the table-backed quantities stay correct for
variant physics (early dark energy, dark scattering, ...) where the
expansion history is no longer the standard closed form.

pyclass is imported lazily; a clear error is raised when absent.
"""

import numpy as np

import jax.numpy as jnp

from .. import constants, utils
from ..cosmology import (BaseEngine, BaseSection, CosmologyComputationError, CosmologyInputError,
                         DefaultBackground, cl_table, register_engine, register_section)
from ..interpolator import PowerSpectrumInterpolator1D, PowerSpectrumInterpolator2D
from ..ops import Interpolator1D, flatarray
from .boltzmann import background_z_grid as _background_z_grid, translate_class_params


@register_engine
class ClassEngine(BaseEngine):
    """Engine wrapping the CLASS Boltzmann code via pyclass (host-side).

    Requires ``pyclass``; raises an informative error when unavailable.
    """

    name = 'class'
    _classy_module = 'pyclass'

    def __init__(self, cosmo, **extra_params):
        super().__init__(cosmo, **extra_params)
        N_ncdm = self['N_ncdm']
        translated = translate_class_params(
            self._params, extra_params=self._extra_params,
            A_s_fid=float(np.asarray(self._get_A_s_fid())),
            has_fld=bool(np.asarray(self._has_fld)), N_ncdm=N_ncdm)
        self._set_classy(translated)

    def _set_classy(self, params):
        base = self._import_classy()

        class _ClassEngine(base.ClassEngine):
            def compute(self, tasks):
                try:
                    return super().compute(tasks)
                except base.ClassInputError as exc:
                    raise CosmologyInputError from exc
                except base.ClassComputationError as exc:
                    raise CosmologyComputationError from exc

        self.classy = _ClassEngine(params=params)

    def _import_classy(self):
        try:
            import importlib
            if '.' in self._classy_module:
                # variant modules live inside the pyclass package
                pkg, sub = self._classy_module.rsplit('.', 1)
                return getattr(importlib.import_module(pkg), sub)
            return importlib.import_module(self._classy_module)
        except (ImportError, AttributeError) as exc:
            raise CosmologyInputError(
                f'{self._classy_module} is required for engine {self.name!r}; install it or use an '
                'analytic/emulated engine (on-device path).') from exc


@register_engine
class AxiClassEngine(ClassEngine):
    """axiCLASS (axion / early dark energy CLASS variant). Scalar-field
    parameters are passed through ``extra_params``; ``scf_parameters__1/2``
    are folded into the ``scf_parameters`` list the C code expects
    (reference axiclassy.py:18-25)."""

    name = 'axiclass'
    _classy_module = 'pyclass.axiclass'

    def _set_classy(self, params):
        if 'scf_parameters__1' in params:
            if 'scf_parameters__2' not in params:
                raise CosmologyInputError('scf_parameters__2 not found in params')
            params['scf_parameters'] = [params.pop('scf_parameters__1'), params.pop('scf_parameters__2')]
        super()._set_classy(params)


@register_engine
class MochiClassEngine(ClassEngine):
    """mochi_class (modified-gravity CLASS variant); gravity/expansion model
    selectors via ``extra_params`` (reference mochiclassy.py)."""

    name = 'mochiclass'
    _classy_module = 'pyclass.mochiclass'


@register_engine
class NegNuClassEngine(ClassEngine):
    """CLASS variant allowing negative neutrino masses (m_ncdm positivity
    check disabled, reference negnuclassy.py)."""

    name = 'negnuclass'
    _classy_module = 'pyclass.negnuclass'
    _check_ignore = ('m_ncdm',)


@register_engine
class DSClassEngine(ClassEngine):
    """Dark-Scattering CLASS variant (interacting dark energy).

    Forces the DS-CLASS requirements — Newtonian gauge, PPF, Omega_Lambda=0
    — when a scattering amplitude ``xi_ds`` is given (reference
    dsclassy.py:26-40); the Background section solves the DS-modified growth
    ODE (dsclassy.py:66-175)."""

    name = 'dsclass'
    _classy_module = 'pyclass.dsclass'
    _default_cosmological_parameters = dict(xi_ds=0.0)

    def _set_classy(self, params):
        if params.pop('xi_ds', 0.0):
            if params.get('dark_scattering', 'no') == 'no':
                params['dark_scattering'] = 'yes'
            params['Omega_Lambda'] = 0.0
            params['use_ppf'] = 'yes'
            params['gauge'] = 'Newtonian'
            params.setdefault('cs2_fld', 1.0)
        super()._set_classy(params)


# ----------------------------------------------------------------------------
# Sections (host tables -> device splines)
# ----------------------------------------------------------------------------

@register_section
class Background(DefaultBackground):
    """Background with E(z), distances, time and growth imported from the
    CLASS background module as z-tables (device splines); closed-form
    species densities from DefaultBackground, which agree by construction
    for standard CLASS (reference classy.py:88-92 delegates to pyclass)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine

    @property
    def _ba(self):
        return self._engine.classy.get_background()

    def _host_table(self, name, values_fn, log=False):
        """Import a host-evaluated z-quantity as an Interpolator1D."""
        if name not in self._cache:
            zc = _background_z_grid()
            vals = np.asarray(values_fn(zc), dtype=np.float64)
            self._cache[name] = Interpolator1D(zc, jnp.asarray(vals),
                                               interp_fun='log' if log else 'lin',
                                               assume_sorted=True)
        return self._cache[name]

    @flatarray()
    def efunc(self, z):
        r"""E(z) = H(z)/H0 from the CLASS background table inside the grid;
        beyond it (z > ~1e4, radiation domination) the closed form applies
        (needed e.g. by the theta_cosmomc sound-horizon integral which
        reaches z ~ 1e8)."""
        table = self._host_table('efunc', self._ba.efunc, log=True)
        zmax = _background_z_grid()[-1]
        from ..cosmology import BaseBackground
        closed = BaseBackground.efunc.__wrapped__(self, z) if hasattr(BaseBackground.efunc, '__wrapped__') \
            else BaseBackground.efunc(self, z)
        return jnp.where(z <= zmax, table(jnp.minimum(z, zmax)), closed)

    @flatarray()
    def hubble_function(self, z):
        r"""H(z) in km/s/Mpc."""
        return 100.0 * self.h * self.efunc(z)

    @flatarray()
    def comoving_radial_distance(self, z):
        r"""Comoving radial distance in Mpc/h, from the CLASS table."""
        return self._host_table('comoving_radial_distance', self._ba.comoving_radial_distance)(z)

    @flatarray()
    def time(self, z):
        r"""Proper time in Gyr, from the CLASS table."""
        return self._host_table('time', self._ba.time)(z)

    @flatarray()
    def growth_factor(self, z, mass='m', znorm=None):
        r"""Scale-independent growth factor from CLASS. ``znorm=None``:
        D(0)=1 normalization; ``znorm`` given: the matter-era convention
        (1+znorm) * D_raw with D_raw(z) ~ 1/(1+z) at high z, recovered from
        the host table at z=100 (same convention as the analytic engines,
        eisenstein_hu.py:113-123). ``mass='cb'`` falls back to the internal
        growth ODE."""
        if mass != 'm':
            return DefaultBackground.growth_factor.__wrapped__(self, z, mass=mass, znorm=znorm)
        table = self._host_table('growth_factor', self._ba.growth_factor)
        growthz = table(z)
        if znorm is not None:
            zm = jnp.array([100.0])
            draw = growthz / (table(zm)[0] * (1.0 + zm[0]))  # matter-era raw D
            return (1.0 + znorm) * draw
        return growthz / table(jnp.zeros(1))[0]

    @flatarray()
    def growth_rate(self, z, mass='m'):
        r"""Growth rate f(z) = dlnD/dlna from CLASS."""
        if mass != 'm':
            return DefaultBackground.growth_rate.__wrapped__(self, z, mass=mass)
        return self._host_table('growth_rate', self._ba.growth_rate)(z)

    @flatarray()
    def comoving_sound_horizon(self, z):
        r"""Comoving sound horizon r_s(z) in Mpc/h, from the CLASS table."""
        return self._host_table('comoving_sound_horizon', self._ba.comoving_sound_horizon)(z)


@register_section
@utils.addproperty('rs_drag', 'z_drag', 'rs_star', 'z_star', 'tau_reio', 'z_reio', 'YHe')
class Thermodynamics(BaseSection):
    """Thermodynamics scalars from CLASS, plus the CAMB-convention extras
    derived from the thermodynamics table (reference classy.py:107-146):
    ``z_star_noreion`` (optical depth *excluding reionization* crossing 1,
    i.e. kappa = 1 + tau_reio), the sound horizon / angle at it, and
    ``theta_cosmomc``."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine
        h = float(np.asarray(engine['h']))
        th = engine.classy.get_thermodynamics()
        self._rs_drag = th.rs_drag * h
        self._z_drag = th.z_drag
        self._rs_star = th.rs_star * h
        self._z_star = th.z_star
        self._tau_reio = getattr(th, 'tau_reio', None)
        if self._tau_reio is None:  # host without the attribute: input param
            self._tau_reio = engine.get('tau_reio', None)
        self._z_reio = getattr(th, 'z_reio', None)
        self._YHe = getattr(th, 'YHe', None)

    @property
    def _ba(self):
        return self._engine.get_section('background')

    @property
    def theta_cosmomc(self):
        r"""CosmoMC approximation to the sound-horizon angle (reference
        classy.py:100-104)."""
        from ..cosmology import _compute_rs_cosmomc
        h = self._engine['h']
        rs, zstar = _compute_rs_cosmomc(self._engine['Omega_b'] * h ** 2, self._engine['Omega_m'] * h ** 2,
                                        self._ba.hubble_function)
        return rs * h / self._ba.comoving_transverse_distance(zstar)

    @property
    def z_star_noreion(self):
        r"""Redshift where the optical depth excluding reionization crosses
        one: -ln[exp(-kappa)](z) = 1 + tau_reio (matches CAMB's zstar)."""
        if not hasattr(self, '_z_star_noreion'):
            data = self._engine.classy.get_thermodynamics().table()
            z = np.asarray(data['z'])
            ekappa = np.asarray(data['exp(-kappa)'])
            mask = (z > 100.0) & (ekappa > 0.0)
            z_m, kappa_m = z[mask], -np.log(ekappa[mask])
            order = np.argsort(kappa_m)
            target = 1.0 + float(np.asarray(self.tau_reio))
            self._z_star_noreion = float(np.interp(target, kappa_m[order], z_m[order]))
        return self._z_star_noreion

    @property
    def rs_star_noreion(self):
        r"""Comoving sound horizon at z_star_noreion, in Mpc/h."""
        return self._ba.comoving_sound_horizon(self.z_star_noreion)

    @property
    def theta_star(self):
        r"""Sound-horizon angle r_s(z_star)/D_M(z_star), in radians."""
        return self.rs_star / self._ba.comoving_transverse_distance(self.z_star)

    @property
    def theta_star_noreion(self):
        r"""Sound-horizon angle at z_star_noreion, in radians."""
        return self.rs_star_noreion / self._ba.comoving_transverse_distance(self.z_star_noreion)

    @flatarray()
    def rs_z(self, z):
        r"""Comoving sound horizon r_s(z), in Mpc/h."""
        return self._ba.comoving_sound_horizon(z)


@register_section
@utils.addproperty('k_pivot', 'n_s', 'alpha_s', 'beta_s')
class Primordial(BaseSection):
    """Primordial parameters (A_s renormalized by the sigma8 rescale)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._h = engine['h']
        self._n_s = engine['n_s']
        self._alpha_s = engine['alpha_s']
        self._beta_s = engine['beta_s']
        self._k_pivot = engine['k_pivot'] / self._h
        self._A_s_raw = engine.classy.get_primordial().A_s
        self._rsigma8 = engine._rescale_sigma8()

    @property
    def A_s(self):
        return self._A_s_raw * self._rsigma8 ** 2

    @property
    def ln_1e10_A_s(self):
        return jnp.log(1e10 * self.A_s)

    def pk_k(self, k, mode='scalar'):
        lnkkp = jnp.log(k / self.k_pivot)
        return self._h ** 3 * self.A_s * (k / self.k_pivot) ** (
            self.n_s - 1.0 + 0.5 * self.alpha_s * lnkkp + self.beta_s * lnkkp ** 2 / 6.0)

    def pk_interpolator(self, mode='scalar'):
        return PowerSpectrumInterpolator1D.from_callable(pk_callable=lambda k: self.pk_k(k, mode=mode))


@register_section
class Perturbations(BaseSection):
    """Perturbation source tables from CLASS (reference classy.py:231-234,
    415: thin delegation to the compiled perturbations module)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine

    def table(self):
        r"""Return the structured array of perturbation sources computed by
        CLASS (one entry per requested k)."""
        return self._engine.classy.get_perturbations().table()


@register_section
class Transfer(BaseSection):
    """Transfer functions from CLASS (reference classy.py:237-240)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine

    def table(self, z=0.0):
        r"""Structured array of transfer functions T_x(k) at redshift ``z``."""
        try:
            return self._engine.classy.get_transfer().table(z)
        except TypeError:
            # host module without a z argument: only the default z = 0 may
            # silently map onto it — anything else would return wrong data
            if float(z) != 0.0:
                raise CosmologyInputError(
                    f'this host transfer module does not take a redshift (requested z={z})')
            return self._engine.classy.get_transfer().table()


@register_section
class Harmonic(BaseSection):
    """CMB Cls from CLASS, sigma8-rescaled (reference classy.py:243-301)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine
        self._rsigma8 = engine._rescale_sigma8()
        self.ellmax_cl = engine['ellmax_cl']

    def _rescaled(self, table):
        names = [name for name in table.dtype.names if not name.startswith('ell')]
        out = np.array(table)
        scale = float(np.asarray(self._rsigma8)) ** 2
        for name in names:
            out[name] = out[name] * scale
        return out

    def _cl_dict(self, kind, ellmax):
        hr = self._engine.classy.get_harmonic()
        cl = self._rescaled(getattr(hr, kind)(ellmax=ellmax))
        table = {name: jnp.asarray(cl[name]) for name in cl.dtype.names if name != 'ell'}
        table['ell'] = np.arange(len(cl))
        return cl_table(table)

    def _resolve_ellmax(self, ellmax):
        if ellmax < 0:
            ellmax = self.ellmax_cl + 1 + ellmax
        return ellmax

    def unlensed_cl(self, ellmax=-1):
        r"""Unlensed C_ell ['tt', 'ee', 'bb', 'te'], unitless."""
        return self._cl_dict('unlensed_cl', self._resolve_ellmax(ellmax))

    def lensed_cl(self, ellmax=-1):
        r"""Lensed C_ell, unitless."""
        return self._cl_dict('lensed_cl', self._resolve_ellmax(ellmax))

    def lens_potential_cl(self, ellmax=-1):
        r"""Lensing-potential C_ell ['pp', 'tp', 'ep'], unitless."""
        return self._cl_dict('lens_potential_cl', self._resolve_ellmax(ellmax))

    def unlensed_table(self, ellmax=-1, of=None):
        r"""Structured array of unlensed C_ell (reference classy.py:249-276)."""
        hr = self._engine.classy.get_harmonic()
        return self._rescaled(hr.unlensed_table(ellmax=self._resolve_ellmax(ellmax), of=of))

    def lensed_table(self, ellmax=-1, of=None):
        r"""Structured array of lensed C_ell (reference classy.py:278-301)."""
        hr = self._engine.classy.get_harmonic()
        return self._rescaled(hr.lensed_table(ellmax=self._resolve_ellmax(ellmax), of=of))


@register_section
class Fourier(BaseSection):
    """Power spectra imported as (k, z) tables, including on-the-fly cross
    spectra of tuples like ('delta_m', 'theta_cb') which pyclass computes
    from its sources (reference classy.py:304-404)."""

    def __init__(self, engine):
        super().__init__(engine)
        self._engine = engine
        self._h = engine['h']
        self._rsigma8 = engine._rescale_sigma8()

    def table(self, non_linear=False, of='delta_m'):
        r"""Return (k, z, pk) in reference conventions ((Mpc/h)^3, k in
        h/Mpc), sigma8-rescaled."""
        fo = self._engine.classy.get_fourier()
        k, z, pk = fo.table(non_linear='' if not non_linear else 'halofit', of=of)
        return np.asarray(k), np.asarray(z), np.asarray(pk) * float(np.asarray(self._rsigma8)) ** 2

    def pk_interpolator(self, non_linear=False, of='delta_m', **kwargs):
        k, z, pk = self.table(non_linear=non_linear, of=of)
        return PowerSpectrumInterpolator2D(k, z, np.abs(pk), **kwargs)  # abs for phi_plus_psi crosses

    def pk_kz(self, k, z, non_linear=False, of='delta_m'):
        return self.pk_interpolator(non_linear=non_linear, of=of)(k, z)

    def sigma_rz(self, r, z, of='delta_m', **kwargs):
        return self.pk_interpolator(of=of, **kwargs).sigma_rz(r, z)

    def sigma8_z(self, z, of='delta_m'):
        return self.sigma_rz(8.0, z, of=of)

    @property
    def sigma8_m(self):
        fo = self._engine.classy.get_fourier()
        sig = getattr(fo, 'sigma8_m', None)
        if sig is not None:
            return sig * self._rsigma8
        return self.sigma8_z(0.0, of='delta_m')

    @property
    def sigma8_cb(self):
        fo = self._engine.classy.get_fourier()
        sig = getattr(fo, 'sigma8_cb', None)
        if sig is not None:
            return sig * self._rsigma8
        return self.sigma8_z(0.0, of='delta_cb')


class DSBackground(Background):
    """Dark-Scattering Background: growth from the DS-modified ODE
    D'' = -(2 + A(a) + dlnH/dlna) D' + 1.5 Omega_m(a) D in lna, with the
    effective coupling A(a) from the scattering amplitude xi_ds
    (arXiv:2111.13598; reference dsclassy.py:66-175), solved on host with
    the CLASS background table."""

    def _ds_growth_tables(self):
        if 'growth_factor_ds' in self._cache:
            return self._cache['growth_factor_ds'], self._cache['growth_rate_ds']
        engine = self._engine
        h = float(np.asarray(engine['h']))
        w0 = float(np.asarray(engine['w0_fld']))
        wa = float(np.asarray(engine['wa_fld']))
        xi = float(np.asarray(engine._params.get('xi_ds', 0.0)))

        bg = self._ba.table()
        a = 1.0 / (1.0 + np.asarray(bg['z']))
        lna = np.log(a)
        H = np.asarray(bg['H [1/Mpc]'])
        rho_ncdm = np.asarray(bg['(.)rho_ncdm[0]']) if '(.)rho_ncdm[0]' in bg.dtype.names else 0.0
        rho_m = np.asarray(bg['(.)rho_b']) + np.asarray(bg['(.)rho_cdm']) + rho_ncdm
        de_col = '(.)rho_fld' if '(.)rho_fld' in bg.dtype.names else '(.)rho_lambda'
        rho_de = np.asarray(bg[de_col])
        Om_m = rho_m / H ** 2
        Om_de = rho_de / H ** 2
        dlnH = np.gradient(np.log(H), lna)

        order = np.argsort(lna)
        lna_s = lna[order]
        interp = lambda y: (lambda x: np.interp(x, lna_s, y[order]))
        Om_m_i, Om_de_i, H_i, dlnH_i = interp(Om_m), interp(Om_de), interp(H), interp(dlnH)

        H0, Om_de0, Om_m0 = H_i(0.0), Om_de_i(0.0), Om_m_i(0.0)
        Rc = float(np.asarray(engine['Omega_cdm'])) / Om_m0
        unit_conv = 0.0974655  # (sigma/m) / (b/GeV) -> Mpc^-1 conversion
        A0_raw = unit_conv * h * (1.0 - Om_m0) * (1.0 + w0) * xi
        corr_xi = (xi * Rc) / (1.0 + A0_raw * (1.0 - Rc))
        A_base = unit_conv * h * Om_de0 * corr_xi

        lna_arr = np.linspace(np.log(1.0 / 101.0), 0.0, 500)
        D = np.exp(lna_arr[0])
        Dp = D
        dx = lna_arr[1] - lna_arr[0]

        def derivs(y, x):
            D, Dp = y
            w = w0 + wa * (1.0 - np.exp(x))
            A = A_base * (1.0 + w) * (Om_de_i(x) / Om_de0) * (H_i(x) / H0)
            return np.array([Dp, -(2.0 + A + dlnH_i(x)) * Dp + 1.5 * Om_m_i(x) * D])

        Ds, fs = [D], [1.0]
        y = np.array([D, Dp])
        for x in lna_arr[:-1]:  # host RK4
            k1 = derivs(y, x)
            k2 = derivs(y + 0.5 * dx * k1, x + 0.5 * dx)
            k3 = derivs(y + 0.5 * dx * k2, x + 0.5 * dx)
            k4 = derivs(y + dx * k3, x + dx)
            y = y + dx / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            Ds.append(y[0])
            fs.append(y[1] / y[0])
        z_arr = np.exp(-lna_arr) - 1.0
        self._cache['growth_factor_ds'] = Interpolator1D(z_arr[::-1], jnp.asarray(np.asarray(Ds)[::-1]),
                                                         extrap=True, assume_sorted=True)
        self._cache['growth_rate_ds'] = Interpolator1D(z_arr[::-1], jnp.asarray(np.asarray(fs)[::-1]),
                                                       extrap=True, assume_sorted=True)
        return self._cache['growth_factor_ds'], self._cache['growth_rate_ds']

    @flatarray()
    def growth_factor(self, z, mass='m', znorm=None):
        factor, _ = self._ds_growth_tables()
        growthz = factor(z)
        if znorm is not None:
            return (1.0 + znorm) * growthz
        return growthz / factor(jnp.zeros(1))[0]

    @flatarray()
    def growth_rate(self, z, mass='m'):
        _, rate = self._ds_growth_tables()
        return rate(z)


# DSClassEngine picks up the DS growth by section override: section discovery
# is by module attribute name, so expose the DS Background under the name the
# engine-specific lookup expects.
DSClassEngine._Section_classes_cache = None  # reset any cached discovery
DSClassEngine._section_overrides = {'background': DSBackground}

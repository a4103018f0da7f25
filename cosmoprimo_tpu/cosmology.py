"""Cosmological parameter system and engine front-end, JAX-native.

Re-designed from the reference's cosmology.py (2093 LoC) for accelerator execution:

- a :class:`Cosmology` is a pytree of numeric parameters (children) plus
  static configuration (aux data), so whole cosmologies flow through
  ``jit`` / ``vmap`` / ``jacfwd``;
- parameter compilation (aliases, conflicts, neutrino machinery) is a pure
  function over the parameter dict; the neutrino Newton inversions run as
  traced ``fori_loop`` + ``cond`` with static iteration caps;
- engines expose uniform physics sections (Background, Thermodynamics,
  Primordial, Perturbations, Transfer, Harmonic, Fourier) discovered from
  the engine's module, as in the reference (cosmology.py:497-503).

Reference parity targets: parameter names/aliases/conflicts
(cosmology.py:730-750), `_compile_params` normalization (874-1217),
derived-parameter ``get`` (327-415), background physics (1627-2093).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from . import constants, utils
from .ops import bisect, bracket, exception, exception_or_nan, flatarray
from .ops import cumquad_rk4, gauss_laguerre_nodes, linear_ode2_rk4_prefix, odeint, romberg
from .ops.roots import for_cond_loop
from .ops.spline import Interpolator1D

_Sections = ['Background', 'Thermodynamics', 'Primordial', 'Perturbations', 'Transfer', 'Harmonic', 'Fourier']


class CosmologyError(Exception):
    """Exception raised by :class:`Cosmology`."""


class CosmologyInputError(CosmologyError):
    """Error in the value of input parameters."""


class CosmologyComputationError(CosmologyError):
    """Error during a cosmology computation."""


def _is_sequence(item):
    return isinstance(item, (tuple, list))


# ----------------------------------------------------------------------------
# Neutrino phase-space integrals (reference: cosmology.py:57-137)
# ----------------------------------------------------------------------------

def compute_ncdm_momenta(T_eff, m, z, out='rho'):
    r"""Energy density / pressure / d(rho)/dm of one massive-neutrino species
    by 100-point Gauss-Laguerre integration of the frozen Fermi-Dirac
    phase-space distribution (~1e-12 accurate; reference cosmology.py:74-137).

    Returns values in :math:`10^{10} M_\odot / \mathrm{Mpc}^3` (per eV for
    'drhodm'), shaped like ``z``.
    """
    z = jnp.asarray(z, dtype=jnp.float64)
    shape = z.shape
    z = jnp.atleast_1d(z)
    a = 1.0 / (1.0 + z)
    over_T = constants.electronvolt_over_joule / (constants.Boltzmann * (T_eff / a))
    m2_T2 = (m * over_T) ** 2
    m_T2 = m * over_T ** 2

    ti, wi = gauss_laguerre_nodes(100)
    q = jnp.asarray(ti)
    w = jnp.asarray(wi)
    q2 = q ** 2
    eps = jnp.sqrt(q2 + m2_T2[:, None])
    # Laguerre absorbs e^{-q}: integrand carries the 1/(1 + e^{-q}) remainder
    fd = 1.0 / (1.0 + jnp.exp(-q))
    if out == 'rho':
        integ = q2 * eps * fd
    elif out == 'drhodm':
        integ = m_T2[:, None] * q2 / eps * fd
    elif out == 'p':
        integ = (1.0 / 3.0) * q ** 4 / eps * fd
    else:
        raise ValueError(f"out must be in ['rho', 'drhodm', 'p'], got {out}")
    val = jnp.sum(integ * w, axis=-1)
    # Fermi-Dirac normalization and unit conversion to 1e10 Msun / Mpc^3
    val = (7.0 / 8.0 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann * (T_eff / a) ** 4 * val
           / (7.0 * np.pi ** 4 / 120.0) / (1e10 * constants.msun_over_kg) * constants.megaparsec_over_m ** 3)
    return val.reshape(shape)


def _get_ncdm(params, z=0, species=None, out='rho'):
    """Per-species ncdm comoving density/pressure in 1e10 Msun/h/(Mpc/h)^3
    given a params dict with h, T_cmb, T_ncdm_over_cmb, m_ncdm."""
    h2 = params['h'] ** 2
    T_cmb = params['T_cmb']
    T_ncdm_over_cmb = jnp.atleast_1d(jnp.asarray(params['T_ncdm_over_cmb'], dtype=jnp.float64))
    m_ncdm = jnp.atleast_1d(jnp.asarray(params['m_ncdm'], dtype=jnp.float64))
    z = jnp.asarray(z, dtype=jnp.float64)

    def compute(T, m):
        return compute_ncdm_momenta(T_cmb * T, m, z=z, out=out) / (1 + z) ** 3 / h2

    if species is None:
        species = list(range(m_ncdm.shape[0]))
    if _is_sequence(species):
        if not len(species):
            return jnp.zeros((0,) + z.shape, dtype=jnp.float64)
        return jnp.stack([compute(T_ncdm_over_cmb[s], m_ncdm[s]) for s in species]).reshape((len(species),) + z.shape)
    return compute(T_ncdm_over_cmb[species], m_ncdm[species]).reshape(z.shape)


def _compute_rs_cosmomc(omega_b, omega_m, hubble_function):
    """Sound horizon (proper Mpc) and z_star in the CosmoMC fitting-formula
    approximation (reference cosmology.py:202-228; zstar fit from CosmoMC)."""
    zstar = 1048 * (1 + 0.00124 * omega_b ** (-0.738)) \
        * (1 + (0.0783 * omega_b ** (-0.238) / (1 + 39.5 * omega_b ** 0.763))
           * omega_m ** (0.560 / (1 + 21.1 * omega_b ** 1.81)))
    astart = 1e-8
    astar = 1.0 / (1 + zstar)

    def dsoundda(a):
        dtauda = 1.0 / (a ** 2 * hubble_function(1 / a - 1.0) / (constants.c / 1e3))
        R = 3e4 * a * omega_b
        cs = (3 * (1 + R)) ** (-0.5)
        return dtauda * cs

    return romberg(dsoundda, astart, astar, divmax=15, epsabs=1e-7, epsrel=1e-7), zstar


# ----------------------------------------------------------------------------
# Parameter tables (reference: cosmology.py:730-750)
# ----------------------------------------------------------------------------

DEFAULT_COSMOLOGICAL_PARAMETERS = dict(
    h=0.7, Omega_cdm=0.25, Omega_b=0.05, Omega_k=0.0, sigma8=0.8, k_pivot=0.05,
    n_s=0.96, alpha_s=0.0, beta_s=0.0, r=0.0, n_t='scc', alpha_t='scc', T_cmb=constants.TCMB,
    m_ncdm=None, neutrino_hierarchy=None, T_ncdm_over_cmb=constants.TNCDM_OVER_CMB, N_eff=constants.NEFF,
    tau_reio=0.06, reionization_width=0.5, A_L=1.0, w0_fld=-1.0, wa_fld=0.0, cs2_fld=1.0)

DEFAULT_CALCULATION_PARAMETERS = dict(
    non_linear='', modes='s', lensing=False, z_pk=None, kmax_pk=10.0, ellmax_cl=2500, YHe='BBN', use_ppf=True)

_CONFLICTS_NO_ALIAS = [
    ('h', 'H0'),
    ('T_cmb', 'Omega_g', 'omega_g'),
    ('Omega_b', 'omega_b'),
    ('Omega_cdm', 'omega_cdm', 'Omega_c', 'omega_c', 'Omega_m', 'omega_m'),
    ('Omega_k', 'omega_k'),
    ('N_ur', 'Omega_ur', 'omega_ur', 'N_eff'),
    ('m_ncdm', 'Omega_ncdm', 'omega_ncdm'),
    ('A_s', 'logA', 'sigma8'),
    ('tau_reio', 'z_reio'),
]

ALIASES = {
    'omega_b': ('ombh2',), 'omega_cdm': ('omch2',), 'Omega_k': ('omk',), 'm_ncdm': ('mnu',),
    'N_eff': ('nnu',), 'n_s': ('ns',), 'alpha_s': ('nrun',), 'beta_s': ('nrunrun',), 'tau_reio': ('tau',),
    'Omega_m': ('Omega0_m',), 'Omega_cdm': ('Omega0_cdm', 'Omega_c'), 'Omega_b': ('Omega0_b',),
    'Omega_k': ('Omega0_k',), 'Omega_ur': ('Omega0_ur',), 'Omega_ncdm': ('Omega0_ncdm',),
    'Omega_fld': ('Omega0_fld',), 'T_cmb': ('T0_cmb',), 'Omega_g': ('Omega0_g',),
    'logA': ('ln10^10A_s', 'ln10^{10}A_s', 'ln_A_s_1e10'), 'w0_fld': ('w',), 'wa_fld': ('wa',),
}


def _all_conflicts(conflicts_no_alias, aliases):
    out = []
    for group in conflicts_no_alias:
        group = list(group)
        for name in list(group):
            for alias in aliases.get(name, ()):
                if alias not in group:
                    group.append(alias)
        out.append(tuple(group))
    for name, als in aliases.items():
        if not any(name in group for group in conflicts_no_alias):
            out.append((name,) + tuple(als))
    return out


CONFLICT_PARAMETERS = _all_conflicts(_CONFLICTS_NO_ALIAS, ALIASES)


def find_conflicts(name, conflicts=CONFLICT_PARAMETERS):
    for group in conflicts:
        if name in group:
            return group
    return ()


def check_params(params, conflicts=CONFLICT_PARAMETERS):
    for name in params:
        clash = [eq for eq in find_conflicts(name, conflicts) if eq != name and eq in params]
        if clash:
            raise CosmologyInputError('Conflicting parameters are given: {}'.format([name] + clash))


def merge_params(base, update, conflicts=CONFLICT_PARAMETERS):
    """Merge ``update`` into ``base``, dropping parameters of ``base`` that
    conflict with names in ``update`` (``base`` modified in place)."""
    for name in update:
        for eq in find_conflicts(name, conflicts):
            base.pop(eq, None)
    base.update(update)
    return base


# ----------------------------------------------------------------------------
# Parameter compilation (reference: cosmology.py:874-1217)
# ----------------------------------------------------------------------------

def _asfloat(value):
    return jnp.asarray(value, dtype=jnp.float64)


def compile_params(args, engine=None):
    """Normalize input parameters to the internal basis: H0->h, omega->Omega,
    logA->A_s, Omega_g->T_cmb; resolve the neutrino sector (mass inversions,
    hierarchy splitting, N_ur from N_eff); apply positivity and
    early-dark-energy validation with NaN poisoning under trace.

    Pure function: dict in, dict out.
    """
    params = dict(args)
    check_ignore = getattr(engine, '_check_ignore', ()) if engine is not None else ()

    if 'H0' in params:
        params['h'] = params.pop('H0') / 100.0

    def set_alias(target, aliases):
        for alias in aliases:
            if alias in params:
                assert target not in params, f'found both {alias} and {target}'
                params[target] = params.pop(alias)

    omegas = ['omega_b', 'omega_cdm', 'omega_m']
    for name in omegas:
        set_alias(name, ALIASES.get(name, ()))

    h = params['h']
    for name in list(params):
        if name.startswith('omega'):
            value = _asfloat(params.pop(name)) / h ** 2
            target = name.replace('omega', 'Omega')
            assert target not in params, f'found both {name} and {target}'
            params[target] = value

    for name, aliases in ALIASES.items():
        if name in omegas:
            continue
        set_alias(name, aliases)

    if 'logA' in params:
        params['A_s'] = jnp.exp(_asfloat(params.pop('logA'))) * 1e-10

    if 'Omega_g' in params:
        params['T_cmb'] = (_asfloat(params.pop('Omega_g')) * h ** 2 * constants.rho_crit_over_kgph_per_mph3
                           / (4.0 / constants.c ** 3 * constants.Stefan_Boltzmann)) ** 0.25

    # ---------------- neutrino sector ----------------
    T_ncdm_over_cmb = params.pop('T_ncdm_over_cmb', None)

    def prepare_T(T, n):
        if T is None:
            T = constants.TNCDM_OVER_CMB
        if np.ndim(T) == 0:
            T = [T] * n
        T = list(T)
        if n and not len(T):
            T = [constants.TNCDM_OVER_CMB]
        if len(T) != n:
            raise TypeError(f'T_ncdm_over_cmb and m_ncdm must have the same length, found {len(T)} != {n}')
        return T

    if 'm_ncdm' in params:
        m_ncdm = params.pop('m_ncdm')
    elif 'Omega_ncdm' in params:
        Omega_ncdm = params.pop('Omega_ncdm')
        single = Omega_ncdm is not None and np.ndim(Omega_ncdm) == 0
        Omega_ncdm = [] if Omega_ncdm is None else ([Omega_ncdm] if single else list(Omega_ncdm))
        T_ncdm_over_cmb = prepare_T(T_ncdm_over_cmb, len(Omega_ncdm))

        def invert_mass(omega_target, m_init, T_eff):
            """Newton inversion omega_ncdm -> m (traced, capped iterations)."""

            def body(i, state):
                m, check = state
                dwdm = compute_ncdm_momenta(T_eff, m, z=0.0, out='drhodm') / constants.rho_crit_over_Msunph_per_Mpcph3
                m = m + (omega_target - check) / dwdm
                check = compute_ncdm_momenta(T_eff, m, z=0.0, out='rho') / constants.rho_crit_over_Msunph_per_Mpcph3
                return m, check

            def cond(i, state):
                return jnp.abs(omega_target - state[1]) > 1e-15

            check0 = compute_ncdm_momenta(T_eff, m_init, z=0.0, out='rho') / constants.rho_crit_over_Msunph_per_Mpcph3
            m, _ = for_cond_loop(0, 1000, cond, body, (m_init, check0))
            return m

        m_ncdm = []
        for Om, T in zip(Omega_ncdm, T_ncdm_over_cmb):
            Om = _asfloat(Om)
            omega = Om * h ** 2
            m = jax.lax.cond(Om == 0.0,
                             lambda omega=omega: jnp.zeros_like(omega),
                             lambda omega=omega, T=T: invert_mass(omega, omega * 93.14, params['T_cmb'] * T))
            m_ncdm.append(m)
        if single:
            m_ncdm = m_ncdm[0]
    else:
        m_ncdm = []

    single = m_ncdm is not None and np.ndim(m_ncdm) == 0
    if m_ncdm is None:
        m_ncdm = []
    elif single:
        m_ncdm = [m_ncdm]
    m_ncdm = list(m_ncdm)
    T_ncdm_over_cmb = prepare_T(T_ncdm_over_cmb, len(m_ncdm))

    neutrino_hierarchy = params.pop('neutrino_hierarchy', None)
    if neutrino_hierarchy is not None:
        if not single:
            raise CosmologyInputError('neutrino_hierarchy requires a single m_ncdm (the mass sum)')
        sum_ncdm = _asfloat(m_ncdm[0])
        if 'm_ncdm' not in check_ignore:
            def err(value):
                raise CosmologyInputError(f'm_ncdm should be positive, found {value}')
            sum_ncdm = exception_or_nan(sum_ncdm, sum_ncdm < 0.0, err)
        # squared mass splittings, arXiv:1907.12598
        dm21 = 7.39e-5

        def split_newton(total, masses, dm21, dm31):
            def body(i, state):
                m, s = state
                m0, m1, m2 = m
                dsdm1 = 1.0 + m0 / m1 + m0 / m2
                m0 = m0 + (total - s) / dsdm1
                m1 = jnp.sqrt(m0 ** 2 + dm21)
                m2 = jnp.sqrt(m0 ** 2 + dm31)
                return (m0, m1, m2), m0 + m1 + m2

            def cond(i, state):
                return jnp.abs(total - state[1]) > 1e-15

            m, _ = for_cond_loop(0, 1000, cond, body, (masses, masses[0] + masses[1] + masses[2]))
            return list(m)

        if neutrino_hierarchy == 'normal':
            dm31 = 2.525e-3

            def err(value):
                raise CosmologyInputError(f'normal hierarchy requires m_ncdm > ~0.0592, found {value}')
            sum_ncdm = exception_or_nan(sum_ncdm, sum_ncdm ** 2 < dm21 + dm31, err)
            m_ncdm = split_newton(sum_ncdm, (_asfloat(0.0), _asfloat(dm21), _asfloat(dm31)), dm21, dm31)
        elif neutrino_hierarchy == 'inverted':
            dm32 = -2.512e-3
            dm31 = dm32 + dm21

            def err(value):
                raise CosmologyInputError(f'inverted hierarchy requires m_ncdm > ~0.0978, found {value}')
            sum_ncdm = exception_or_nan(sum_ncdm, sum_ncdm ** 2 < -dm31 - dm32, err)
            m_ncdm = split_newton(sum_ncdm, (jnp.sqrt(_asfloat(-dm31)), jnp.sqrt(_asfloat(-dm32)), _asfloat(1e-5)), dm21, dm31)
        elif neutrino_hierarchy == 'degenerate':
            m_ncdm = [sum_ncdm / 3.0] * 3
        else:
            raise CosmologyInputError(f'unknown neutrino hierarchy {neutrino_hierarchy}')
        T_ncdm_over_cmb = [T_ncdm_over_cmb[0]] * 3

    N_ur = params.pop('N_ur', None)
    if 'Omega_ur' in params:
        T_ur = params['T_cmb'] * (4.0 / 11.0) ** (1.0 / 3.0)
        rho = 7.0 / 8.0 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann * T_ur ** 4
        N_ur = params.pop('Omega_ur') / (rho / (h ** 2 * constants.rho_crit_over_kgph_per_mph3))

    m_ncdm = _asfloat(jnp.array(m_ncdm)) if len(m_ncdm) else jnp.zeros(0, dtype=jnp.float64)
    T_ncdm_over_cmb = (_asfloat(jnp.array(T_ncdm_over_cmb)) if len(T_ncdm_over_cmb)
                       else jnp.zeros(0, dtype=jnp.float64))
    # N_ncdm is kept static (all masses are retained even if tiny), as the
    # reference does for stable shapes under sampling (cosmology.py:1117-1124).
    N_eff = params.pop('N_eff', constants.NEFF)
    if N_ur is None:
        N_ur = N_eff - jnp.sum(T_ncdm_over_cmb ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0))
    params['N_ur'] = _asfloat(N_ur)
    params['m_ncdm'] = m_ncdm
    params['T_ncdm_over_cmb'] = T_ncdm_over_cmb
    if params.pop('N_ncdm', None) is not None:
        raise CosmologyInputError('Do not provide N_ncdm; provide m_ncdm of the correct length')

    # ---------------- grids / modes ----------------
    if params.get('z_pk', None) is None:
        from .interpolator import get_default_z_callable
        params['z_pk'] = get_default_z_callable()
    if params.get('modes', None) is None:
        params['modes'] = ['s']
    for name in ['modes', 'z_pk']:
        if np.ndim(params[name]) == 0:
            params[name] = [params[name]]
    params['z_pk'] = np.sort(np.asarray(params['z_pk']))
    if 0.0 not in params['z_pk']:
        params['z_pk'] = np.insert(params['z_pk'], 0, 0.0)

    if 'Omega_m' in params:
        nonrel = (jnp.sum(_get_ncdm(params, z=0.0, out='rho'), axis=0)
                  - 3 * jnp.sum(_get_ncdm(params, z=0.0, out='p'), axis=0)) / constants.rho_crit_over_Msunph_per_Mpcph3
        params['Omega_cdm'] = params.pop('Omega_m') - params['Omega_b'] - nonrel

    for name, default in {'w0_fld': -1.0, 'wa_fld': 0.0, 'cs2_fld': 1.0}.items():
        params[name] = _asfloat(params.get(name, default))

    def w_err(value):
        raise CosmologyInputError(f'w0_fld + wa_fld >= 1/3 (found {value}) violates early radiation domination')
    value = params['w0_fld'] + params['wa_fld']
    value = exception_or_nan(value, value >= 1.0 / 3.0, w_err)
    for name in ['w0_fld', 'wa_fld']:
        params[name] = jnp.where(jnp.isnan(value), jnp.nan, params[name])

    params['use_ppf'] = bool(params.get('use_ppf', True))

    for basename in ['Omega_cdm', 'Omega_b', 'T_cmb', 'h', 'A_s', 'sigma8', 'm_ncdm', 'T_ncdm_over_cmb']:
        if basename in params and basename not in check_ignore:
            value = _asfloat(params[basename])

            def pos_err(v, basename=basename):
                raise CosmologyInputError(f'Parameter {basename} should be positive, found {v}')
            params[basename] = exception_or_nan(value, (value < 0.0).any(), pos_err)

    def check_str(name, allowed):
        value = params[name]
        if value is None:
            value = allowed[0]
        if isinstance(value, str):
            value = value.upper()
            if value not in allowed:
                raise CosmologyInputError(f'Parameter {name} should be a float or one of {allowed}')
            params[name] = value
            return True
        params[name] = _asfloat(value)
        return False

    check_str('YHe', ('BBN',))
    check_str('n_t', ('SCC',))
    check_str('alpha_t', ('SCC',))
    r, n_s = params['r'], params['n_s']
    # single-field slow-roll consistency (as CAMB initialpower)
    if params['n_t'] == 'SCC':
        params['n_t'] = -r / 8.0 * (2.0 - n_s - r / 8.0)
    if params['alpha_t'] == 'SCC':
        params['alpha_t'] = r / 8.0 * (r / 8.0 + n_s - 1)

    return params


def _split_params(params):
    """Split a compiled params dict into numeric children (traced leaves) and
    static aux data for pytree flattening."""
    numeric, static = {}, {}
    for name, value in params.items():
        if name in ('z_pk', 'kmax_pk', 'ellmax_cl') or value is None:
            static[name] = value
        elif isinstance(value, (str, bool)) or (isinstance(value, (list, tuple)) and not ('ncdm' in name or 'nu' in name)):
            static[name] = value
        else:
            numeric[name] = value
    return numeric, static


# ----------------------------------------------------------------------------
# Derived-parameter accessor shared by Cosmology and engines
# ----------------------------------------------------------------------------

class ParamsAccessor(object):
    """Dict-style access to base and derived parameters (reference
    cosmology.py:327-415)."""

    def __getitem__(self, name):
        return self.get(name)

    def get(self, *args, **kwargs):
        if len(args) == 1:
            name = args[0]
            has_default = 'default' in kwargs
            default = kwargs.get('default', None)
        else:
            name, default = args
            has_default = True
        params = self._params
        try:
            return self._get(name, params)
        except KeyError:
            pass
        if has_default:
            return default
        raise CosmologyError(f'Parameter {name} not found.')

    def _get(self, name, params):
        if name in params:
            return params[name]
        if name in self._derived:
            return self._derived[name]
        if name.startswith('omega'):
            return self.get('O' + name[1:]) * params['h'] ** 2
        if name == 'H0':
            return params['h'] * 100
        if name in ('logA', 'ln10^{10}A_s', 'ln10^10A_s', 'ln_A_s_1e10'):
            return jnp.log(1e10 * params['A_s'])
        if name == 'Omega_g':
            rho = params['T_cmb'] ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3)
        if name == 'T_ur':
            return params['T_cmb'] * (4.0 / 11.0) ** (1.0 / 3.0)
        if name == 'T_ncdm':
            return jnp.asarray(params['T_ncdm_over_cmb']) * params['T_cmb']
        if name == 'Omega_ur':
            rho = params['N_ur'] * 7.0 / 8.0 * self.get('T_ur') ** 4 * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3)
        if name == 'Omega_r':
            rho = (params['T_cmb'] ** 4 + params['N_ur'] * 7.0 / 8.0 * self.get('T_ur') ** 4) * 4.0 / constants.c ** 3 * constants.Stefan_Boltzmann
            return rho / (self.get('h') ** 2 * constants.rho_crit_over_kgph_per_mph3) + self.get('Omega_pncdm_tot')
        if name == 'm_ncdm_tot':
            return jnp.sum(params['m_ncdm'])
        if name == 'Omega_ncdm':
            self._derived['Omega_ncdm'] = _get_ncdm(params, z=0.0, out='rho') / constants.rho_crit_over_Msunph_per_Mpcph3
            return self._derived['Omega_ncdm']
        if name == 'Omega_ncdm_tot':
            return jnp.sum(self.get('Omega_ncdm'))
        if name == 'Omega_pncdm':
            self._derived['Omega_pncdm'] = 3.0 * _get_ncdm(params, z=0.0, out='p') / constants.rho_crit_over_Msunph_per_Mpcph3
            return self._derived['Omega_pncdm']
        if name == 'Omega_pncdm_tot':
            return jnp.sum(self.get('Omega_pncdm'))
        if name == 'Omega_m':
            return self.get('Omega_b') + self.get('Omega_cdm') + self.get('Omega_ncdm_tot') - self.get('Omega_pncdm_tot')
        if name == 'Omega_de':
            return 1.0 - sum(self.get(nm) for nm in ['Omega_cdm', 'Omega_b', 'Omega_g', 'Omega_ur', 'Omega_ncdm_tot', 'Omega_k'])
        if name == 'Omega_Lambda':
            return jnp.where(self._has_fld, 0.0, self.get('Omega_de'))
        if name == 'Omega_fld':
            return jnp.where(self._has_fld, self.get('Omega_de'), 0.0)
        if name == 'K':
            return -100.0 ** 2 / (constants.c / 1e3) ** 2 * params['Omega_k']  # (h/Mpc)^2
        if name == 'N_ncdm':
            return len(params['m_ncdm'])
        if name == 'N_eff':
            return jnp.sum(jnp.asarray(params['T_ncdm_over_cmb']) ** 4 * (4.0 / 11.0) ** (-4.0 / 3.0)) + params['N_ur']
        if name == 'theta_cosmomc':
            ba = self.get_background()
            rs, zstar = _compute_rs_cosmomc(self['omega_b'], self['omega_m'], ba.hubble_function)
            self._derived['theta_cosmomc'] = rs * ba.h / ba.comoving_angular_distance(zstar)
            return self._derived['theta_cosmomc']
        if name == 'theta_MC_100':
            return self.get('theta_cosmomc') * 100.0
        raise KeyError(name)

    @property
    def _has_fld(self):
        return (self._params['w0_fld'] != -1) | (self._params['wa_fld'] != 0) | (self._params['cs2_fld'] != 1.0)


# ----------------------------------------------------------------------------
# Engine registry
# ----------------------------------------------------------------------------

_ENGINE_REGISTRY = {}

_ENGINE_MODULES = {
    'eisenstein_hu': 'models.eisenstein_hu',
    'eisenstein_hu_nowiggle': 'models.eisenstein_hu_nowiggle',
    'eisenstein_hu_nowiggle_variants': 'models.eisenstein_hu_nowiggle_variants',
    'bbks': 'models.bbks',
    'tabulated': 'models.tabulated',
    'capse': 'emulators.emulated',
    'cosmopower_bolliet2023': 'emulators.emulated',
    'emulated': 'emulators.emulated',
    'class': 'models.classy',
    'classy': 'models.classy',
    'camb': 'models.camb',
    'axiclass': 'models.classy',
    'axiclassy': 'models.classy',
    'mochiclass': 'models.classy',
    'mochiclassy': 'models.classy',
    'negnuclass': 'models.classy',
    'negnuclassy': 'models.classy',
    'dsclass': 'models.classy',
    'dsclassy': 'models.classy',
    'isitgr': 'models.camb',
    'mgcamb': 'models.camb',
    'isitide': 'models.camb',
    'heftcamb': 'models.camb',
    'astropy': 'models.astropy',
    'native': 'models.native',
}


def register_engine(cls):
    """Register an engine class and pytree-register it. Section classes are
    discovered lazily from the engine's module by name (as the reference
    does, cosmology.py:497-503) on first access."""
    _ENGINE_REGISTRY[cls.name] = cls
    jax.tree_util.register_pytree_node_class(cls)
    return cls


def get_engine(engine):
    """Resolve an engine name or class to the engine class."""
    if isinstance(engine, str):
        engine = engine.lower()
        if engine not in _ENGINE_REGISTRY:
            modname = _ENGINE_MODULES.get(engine)
            if modname is not None:
                import importlib
                importlib.import_module('.' + modname, __package__)
        try:
            return _ENGINE_REGISTRY[engine]
        except KeyError:
            raise CosmologyInputError(f'Unknown engine {engine}.')
    if isinstance(engine, BaseEngine):
        return engine.__class__
    return engine


class BaseEngine(ParamsAccessor):
    """Base engine: holds compiled parameters and lazily-instantiated physics
    sections. Engines are pytrees (numeric params as children)."""

    name = 'base'
    _check_ignore = ()
    _default_cosmological_parameters = dict()
    _default_calculation_parameters = dict()

    @classmethod
    def _section_classes(cls):
        """Section classes discovered from the engine's module by name,
        cached per engine class."""
        cached = cls.__dict__.get('_Section_classes_cache', None)
        if cached is not None:
            return cached
        module = sys.modules[cls.__module__]
        sections = {}
        for name in _Sections:
            Section = getattr(module, name, None)
            if Section is not None:
                sections[name.lower()] = Section
        # engine-specific overrides (e.g. variant engines swapping one
        # section while sharing the module's others)
        for name, Section in getattr(cls, '_section_overrides', {}).items():
            sections[name.lower()] = Section
        cls._Section_classes_cache = sections
        return sections

    @property
    def _Section_classes(self):
        return self._section_classes()

    def __init__(self, cosmo, **extra_params):
        params = dict(cosmo._params)
        defaults = dict(self._default_cosmological_parameters)
        defaults.update(self._default_calculation_parameters)
        for name, value in defaults.items():
            params.setdefault(name, value)
        # engine-specific parameters passed through extra_params override the
        # registered defaults (variant physics / precision knobs)
        for name in [name for name in extra_params if name in defaults]:
            params[name] = extra_params.pop(name)
        self._params = params
        self._derived = {}
        self._extra_params = dict(extra_params)
        self._sections = {}
        self._rsigma8 = None

    def __getitem__(self, name):
        return self.get(name)

    def get_section(self, section):
        section = section.lower()
        if section not in self._sections:
            try:
                Section = self._section_classes()[section]
            except KeyError:
                raise CosmologyInputError(f'Engine {self.name} does not provide section {section}')
            self._sections[section] = Section(self)
        return self._sections[section]

    def _get_A_s_fid(self):
        """First-guess A_s given sigma8 (CLASS input.c heuristic)."""
        if 'A_s' in self._params:
            return self._params['A_s']
        return 2.43e-9 * (self['sigma8'] / 0.87659) ** 2

    def _get_sigma8_fid(self):
        if 'sigma8' in self._params:
            return self._params['sigma8']
        return (self['A_s'] / 2.43e-9) ** 0.5 * 0.87659

    def _rescale_sigma8(self):
        """Ratio rescaling all perturbative amplitudes so that sigma8 matches
        the input value (explicit two-pass; reference cosmology.py:519-529)."""
        if self._rsigma8 is not None:
            return self._rsigma8
        self._rsigma8 = 1.0
        if 'sigma8' in self._params:
            self._sections.pop('fourier', None)
            self._rsigma8 = self._params['sigma8'] / self.get_section('fourier').sigma8_m
            self._sections.pop('fourier', None)
        return self._rsigma8

    def tree_flatten(self):
        numeric, static = _split_params(self._params)
        children = (numeric, self._sections, self._rsigma8, self._derived)
        aux = {'static_params': static, 'extra_params': self._extra_params,
               'numeric_names': tuple(numeric)}
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        numeric, new._sections, new._rsigma8, new._derived = children
        new._params = dict(numeric)
        new._params.update(aux['static_params'])
        new._extra_params = aux['extra_params']
        return new

    def __eq__(self, other):
        return type(other) == type(self) and _deepeq(other._params, self._params) and other._extra_params == self._extra_params

    def __hash__(self):
        return object.__hash__(self)


for _section in _Sections:
    def _make_engine_getter(section):
        def getter(self):
            return self.get_section(section)
        getter.__doc__ = f'Return {section} calculations.'
        return getter
    setattr(BaseEngine, 'get_{}'.format(_section.lower()), _make_engine_getter(_section.lower()))


def _deepeq(obj1, obj2):
    # numpy and jax arrays compare by value: disk round-trips (write/read)
    # and jit boundaries convert between the two families
    arraylike = (np.ndarray, jnp.ndarray)
    if isinstance(obj1, arraylike) and isinstance(obj2, arraylike):
        return obj1.shape == obj2.shape and bool(np.all(np.asarray(obj2) == np.asarray(obj1)))
    if type(obj2) is type(obj1):
        if isinstance(obj1, dict):
            return obj2.keys() == obj1.keys() and all(_deepeq(obj1[k], obj2[k]) for k in obj1)
        if isinstance(obj1, (tuple, list)):
            return len(obj2) == len(obj1) and all(_deepeq(a, b) for a, b in zip(obj1, obj2))
        return obj2 == obj1
    return False


# ----------------------------------------------------------------------------
# Cosmology
# ----------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class Cosmology(ParamsAccessor):
    """A validated set of cosmological parameters with an optional engine.

    API-compatible with the reference Cosmology (cosmology.py:726-1477):
    dict access to input and derived parameters, ``clone``/``solve``,
    ``get_background()``-style section getters and attribute forwarding to
    sections. The object is a registered pytree, so cosmologies (and their
    sections) pass through ``jit``, ``vmap`` and ``jacfwd``.
    """

    def __init__(self, engine=None, extra_params=None, **params):
        check_params(params)
        self._derived = {}
        self._engine = None
        defaults = dict(DEFAULT_COSMOLOGICAL_PARAMETERS)
        defaults.update(DEFAULT_CALCULATION_PARAMETERS)
        self._input_params = merge_params(defaults, params)
        self._params = compile_params(self._input_params, engine=get_engine(engine) if engine is not None else None)
        self._extra_params = {}
        if engine is not None:
            self.set_engine(engine, **(extra_params or {}))

    # ------------------------------------------------------------- engine
    @property
    def engine(self):
        return self._engine

    def set_engine(self, engine, set_engine=True, **extra_params):
        if engine is None:
            if self._engine is None:
                raise CosmologyInputError('Please provide an engine')
            engine = self._engine
        elif not isinstance(engine, BaseEngine):
            engine = get_engine(engine)(self, **extra_params)
        if set_engine:
            self._engine = engine
        return engine

    # ------------------------------------------------------------- params
    @classmethod
    def get_default_params(cls, of=None, include_conflicts=True):
        if of is None:
            out = cls.get_default_params(of='cosmology', include_conflicts=include_conflicts)
            out.update(cls.get_default_params(of='calculation', include_conflicts=include_conflicts))
            return out
        if of == 'cosmology':
            out = dict(DEFAULT_COSMOLOGICAL_PARAMETERS)
        elif of == 'calculation':
            out = dict(DEFAULT_CALCULATION_PARAMETERS)
        else:
            raise CosmologyInputError(f'No default parameters for {of}')
        if include_conflicts:
            for name in list(out):
                for conf in find_conflicts(name):
                    out[conf] = out[name]
        return out

    def get_params(self, of='base'):
        if of == 'derived':
            return dict(self._derived)
        if of == 'extra':
            return dict(self._extra_params)
        toret = dict(self._params)
        if of == 'base':
            return toret
        if of == 'input':
            return dict(self._input_params)
        if of in ('cosmology', 'calculation'):
            defaults = self.get_default_params(of=of)
            return {name: toret.get(name, value) for name, value in defaults.items()}
        if of == 'all':
            toret.update(self.get_params(of='derived'))
            toret.update(self.get_params(of='extra'))
            return toret
        raise CosmologyInputError(f'No parameters for {of}')

    # ------------------------------------------------------------- clone / solve
    def clone(self, base='input', engine=None, extra_params=None, **params):
        """Return a copy with updated parameters (and possibly engine).

        ``base='input'`` updates the user-facing input basis; 'internal'
        updates the compiled h/Omega/m_ncdm basis.
        """
        check_params(params)
        if base == 'input':
            base_params = dict(self._input_params)
        elif base in ('internal', None):
            base_params = dict(self._params)
        else:
            raise CosmologyInputError(f'Unknown parameter base {base}')
        new = self.__class__.__new__(self.__class__)
        new._derived = {}
        new._engine = None
        new._extra_params = {}
        new._input_params = merge_params(base_params, params)
        if engine is None and self._engine is not None:
            engine = self._engine.__class__
        engine_cls = get_engine(engine) if engine is not None else None
        new._params = compile_params(new._input_params, engine=engine_cls)
        if engine_cls is not None:
            if extra_params is None:
                if engine_cls.name == getattr(self._engine, 'name', None):
                    extra_params = getattr(self._engine, '_extra_params', {})
                else:
                    extra_params = {}
            new.set_engine(engine_cls, **extra_params)
        return new

    def solve(self, param, func, target=0.0, limits=None, init=None, xtol=None, maxiter=25):
        """Return a clone where ``func(cosmo) == target``, varying ``param``.

        ``func`` is a callable ``cosmo -> value`` or the name of a derived
        parameter (e.g. ``'theta_MC_100'``, for which a CLASS-style initial
        guess is used when solving for h/H0). Root finding is trace-safe
        bracketing + Ridders bisection; explicit ``limits = (lo, hi)`` skip
        the bracket expansion, otherwise a secant-scaled first step is built
        around ``init`` (scalar, defaults to the current value of ``param``).
        Reference behavior: cosmology.py:1292-1376.
        """
        default_step = {'h': 0.01, 'H0': 1.0}
        default_tol = {'h': 1e-6, 'H0': 1e-4}

        if isinstance(func, str):
            name = func

            def func(cosmo):
                return cosmo[name]

            if name == 'theta_MC_100' and init is None and limits is None and param in ('h', 'H0'):
                # CLASS initial guess for 100*theta_MC -> h (class_public fit)
                h_guess = 3.54 * target ** 2 - 5.455 * target + 2.548
                init = h_guess if param == 'h' else 100.0 * h_guess
        if not callable(func):
            raise CosmologyInputError(
                f'func must be a callable cosmo -> value or a derived-parameter name, got {func!r}')

        def f(value):
            new = self.clone(base='input', **{param: value})
            return func(new) - target

        if xtol is None:
            xtol = default_tol.get(param, 1e-6)
        if limits is None:
            if init is None:
                init = self[param]
            if _is_sequence(init):
                init = tuple(init)  # user-provided (x0, dx) or (x0, dx, f0)
            else:
                x0 = init
                dx0 = default_step.get(param, None)
                if dx0 is None:
                    dx0 = 0.05 * abs(float(np.asarray(x0))) or 0.05
                # secant slope -> Newton-scaled first bracket step
                f0 = f(x0)
                df = f(x0 + dx0) - f0
                step = jnp.where(df == 0, dx0, f0 * dx0 / df)
                init = (x0, step, f0)
            limits = bracket(f, init=init, maxiter=maxiter)
        value = bisect(f, limits=tuple(limits), xtol=xtol, maxiter=maxiter)
        return self.clone(base='input', **{param: value})

    # ------------------------------------------------------------- pytree
    def tree_flatten(self):
        num_in, static_in = _split_params(self._input_params)
        num, static = _split_params(self._params)
        children = (num_in, num, self._engine)
        aux = {'static_input_params': static_in, 'static_params': static,
               'extra_params': self._extra_params}
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        num_in, num, new._engine = children
        new._derived = {}
        new._input_params = dict(num_in)
        new._input_params.update(aux['static_input_params'])
        new._params = dict(num)
        new._params.update(aux['static_params'])
        new._extra_params = aux['extra_params']
        return new

    # ------------------------------------------------------------- io
    def __getstate__(self):
        state = {'engine': None}
        for name in ('params', 'input_params', 'derived'):
            state[name] = {k: (np.asarray(v) if isinstance(v, jnp.ndarray) else v)
                           for k, v in getattr(self, '_' + name).items()}
        if self._engine is not None:
            state['engine'] = {'name': self._engine.name, 'extra_params': self._engine._extra_params}
        return state

    def __setstate__(self, state):
        for name in ('params', 'input_params', 'derived'):
            setattr(self, '_' + name, dict(state.get(name, {})))
        self._extra_params = {}
        self._engine = None
        if state.get('engine', None) is not None:
            self.set_engine(state['engine']['name'], **state['engine']['extra_params'])

    @classmethod
    def from_state(cls, state):
        new = cls.__new__(cls)
        new.__setstate__(state)
        return new

    @classmethod
    def read(cls, filename):
        return cls.from_state(utils.read_state(filename))

    def write(self, filename):
        utils.write_state(filename, self.__getstate__())

    # Deprecated aliases kept for reference API parity
    # (reference cosmology.py:849-852, 1419-1440; utils.py:55-64).
    @classmethod
    def load(cls, filename):
        """Deprecated. Use :meth:`read`."""
        import warnings
        warnings.warn('load() is deprecated, use read() instead.', DeprecationWarning, stacklevel=2)
        return cls.read(filename)

    def save(self, filename):
        """Deprecated. Use :meth:`write`."""
        import warnings
        warnings.warn('save() is deprecated, use write() instead.', DeprecationWarning, stacklevel=2)
        return self.write(filename)

    @classmethod
    def get_default_parameters(cls, *args, **kwargs):
        """Deprecated. Use :meth:`get_default_params`."""
        import warnings
        warnings.warn('get_default_parameters is deprecated, use get_default_params', DeprecationWarning, stacklevel=2)
        return cls.get_default_params(*args, **kwargs)

    def copy(self):
        """Return shallow copy of ``self``."""
        new = self.__class__.__new__(self.__class__)
        new.__dict__.update(self.__dict__)
        return new

    # ------------------------------------------------------------- magic
    def __getattr__(self, name):
        """Forward attribute access to the engine's sections, e.g.
        ``cosmo.comoving_radial_distance`` finds the Background method."""
        if name.startswith('_'):
            raise AttributeError(name)
        engine = self.__dict__.get('_engine', None)
        if engine is None:
            raise AttributeError(f'Attribute {name} not found; try setting an engine ("set_engine")?')
        Sections = engine._Section_classes
        owners = [sec for sec, S in Sections.items() if hasattr(S, name)]
        if len(owners) == 1:
            return getattr(engine.get_section(owners[0]), name)
        raise AttributeError(f'Attribute {name} not found in a unique section of engine {engine.name}')

    def __eq__(self, other):
        return type(other) == type(self) and _deepeq(other._params, self._params) and other._engine == self._engine

    def __hash__(self):
        return object.__hash__(self)


for _section in _Sections:
    def _make_cosmo_getter(section):
        def getter(self, engine=None, set_engine=True, **extra_params):
            engine_obj = self.set_engine(engine, set_engine=set_engine, **extra_params)
            return engine_obj.get_section(section)
        getter.__doc__ = f'Return {section} calculations (optionally with a new engine).'
        return getter
    setattr(Cosmology, 'get_{}'.format(_section.lower()), _make_cosmo_getter(_section.lower()))


def _make_module_section_getter(section):
    def getter(cosmology, engine=None, set_engine=True, **extra_params):
        engine_obj = cosmology.set_engine(engine, set_engine=set_engine, **extra_params)
        return engine_obj.get_section(section)
    getter.__doc__ = f'Return {section} calculations for ``cosmology``.'
    return getter


Background = _make_module_section_getter('background')
Thermodynamics = _make_module_section_getter('thermodynamics')
Primordial = _make_module_section_getter('primordial')
Perturbations = _make_module_section_getter('perturbations')
Transfer = _make_module_section_getter('transfer')
Harmonic = _make_module_section_getter('harmonic')
Fourier = _make_module_section_getter('fourier')


# ----------------------------------------------------------------------------
# Sections
# ----------------------------------------------------------------------------

class BaseSection(object):
    """Base physics section. Sections are pytrees: all ndarray-valued
    attributes are children."""

    def __init__(self, engine):
        self._engine = engine

    @property
    def engine(self):
        """The engine this section was built from (reference
        cosmology.py:1490 ``addproperty('engine')``). ``None`` after a
        pytree round-trip: the engine is aux-excluded from flatten."""
        return self.__dict__.get('_engine', None)

    def tree_flatten(self):
        return ({name: value for name, value in self.__dict__.items() if name != '_engine'},), {}

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        new.__dict__.update(children[0])
        return new


def register_section(cls):
    return jax.tree_util.register_pytree_node_class(cls)


class cl_table(dict):
    """Dict-of-arrays Cl container mimicking a structured array
    (reference's fake_nparray; keys 'ell', 'tt', 'ee', ...)."""

    def __getitem__(self, name):
        if isinstance(name, str):
            return super().__getitem__(name)
        return self.__class__({key: self[key][name] for key in self})

    @property
    def size(self):
        return next((value.size for value in self.values()), 0)


@register_section
@utils.addproperty('H0', 'h', 'N_ur', 'N_ncdm', 'm_ncdm', 'm_ncdm_tot', 'N_eff', 'T0_cmb', 'T0_ncdm',
                   'w0_fld', 'wa_fld', 'cs2_fld', 'K',
                   'Omega0_cdm', 'Omega0_b', 'Omega0_k', 'Omega0_g', 'Omega0_ur', 'Omega0_r',
                   'Omega0_pncdm', 'Omega0_pncdm_tot', 'Omega0_ncdm', 'Omega0_ncdm_tot',
                   'Omega0_m', 'Omega0_Lambda', 'Omega0_fld', 'Omega0_de')
class BaseBackground(BaseSection):
    """Background quantities from closed-form densities.

    Densities are *comoving*, in :math:`10^{10} M_\\odot/h / (\\mathrm{Mpc}/h)^3`
    (reference conventions, cosmology.py:1627-1933).
    """

    def __init__(self, engine):
        super().__init__(engine)
        for name in ['H0', 'h', 'N_ur', 'N_ncdm', 'm_ncdm', 'm_ncdm_tot', 'N_eff', 'w0_fld', 'wa_fld', 'cs2_fld', 'K']:
            setattr(self, '_' + name, engine[name])
        self._T0_cmb = engine['T_cmb']
        self._T0_ncdm = jnp.asarray(engine['T_ncdm_over_cmb']) * self._T0_cmb
        for name in ['cdm', 'b', 'k', 'g', 'ur', 'r', 'ncdm', 'ncdm_tot', 'pncdm', 'pncdm_tot', 'm', 'Lambda', 'fld', 'de']:
            setattr(self, '_Omega0_' + name, engine['Omega_' + name])
        for name in ['_m_ncdm', '_Omega0_pncdm', '_Omega0_ncdm']:
            setattr(self, name, jnp.asarray(getattr(self, name), dtype=jnp.float64))

    def tree_flatten(self):
        children, aux = super().tree_flatten()
        aux['_N_ncdm'] = children[0].pop('_N_ncdm')
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = super().tree_unflatten({}, children)
        new._N_ncdm = aux['_N_ncdm']
        return new

    # ---- densities
    @flatarray()
    def rho_ncdm(self, z, species=None):
        params = {'h': self._h, 'T_cmb': self._T0_cmb, 'T_ncdm_over_cmb': self._T0_ncdm / self._T0_cmb, 'm_ncdm': self._m_ncdm}
        return _get_ncdm(params, z=z, species=species, out='rho')

    def rho_ncdm_tot(self, z):
        return jnp.sum(self.rho_ncdm(z, species=None), axis=0)

    @flatarray()
    def p_ncdm(self, z, species=None):
        params = {'h': self._h, 'T_cmb': self._T0_cmb, 'T_ncdm_over_cmb': self._T0_ncdm / self._T0_cmb, 'm_ncdm': self._m_ncdm}
        return _get_ncdm(params, z=z, species=species, out='p')

    def p_ncdm_tot(self, z):
        return jnp.sum(self.p_ncdm(z, species=None), axis=0)

    @flatarray()
    def rho_g(self, z):
        return self.Omega0_g * (1 + z) * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_b(self, z):
        return self.Omega0_b * jnp.ones_like(z) * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_ur(self, z):
        return self.Omega0_ur * (1 + z) * constants.rho_crit_over_Msunph_per_Mpcph3

    def rho_r(self, z):
        return self.rho_g(z) + self.rho_ur(z) + 3.0 * self.p_ncdm_tot(z)

    @flatarray()
    def rho_cdm(self, z):
        return self.Omega0_cdm * jnp.ones_like(z) * constants.rho_crit_over_Msunph_per_Mpcph3

    def rho_m(self, z):
        return self.rho_cdm(z) + self.rho_b(z) + self.rho_ncdm_tot(z) - 3.0 * self.p_ncdm_tot(z)

    @flatarray()
    def rho_k(self, z):
        return self.Omega0_k / (1 + z) * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_Lambda(self, z):
        return self.Omega0_Lambda / (1 + z) ** 3 * constants.rho_crit_over_Msunph_per_Mpcph3

    @flatarray()
    def rho_fld(self, z):
        # CPL equation of state w(a) = w0 + wa (1 - a)
        return (self.Omega0_fld * (1 + z) ** (3.0 * (1 + self.w0_fld + self.wa_fld))
                * jnp.exp(3.0 * self.wa_fld * (1.0 / (1 + z) - 1)) * constants.rho_crit_over_Msunph_per_Mpcph3 / (1 + z) ** 3)

    @flatarray()
    def rho_de(self, z):
        return (self.Omega0_de * (1 + z) ** (3.0 * (self.w0_fld + self.wa_fld))
                * jnp.exp(3.0 * self.wa_fld * (1.0 / (1 + z) - 1)) * constants.rho_crit_over_Msunph_per_Mpcph3)

    def rho_tot(self, z):
        m = self.rho_cdm(z) + self.rho_b(z) + self.rho_ncdm_tot(z)
        r = self.rho_g(z) + self.rho_ur(z)
        return m + r + self.rho_de(z)

    def rho_crit(self, z):
        return self.rho_tot(z) + self.rho_k(z)

    # ---- expansion
    @flatarray()
    def efunc(self, z):
        return jnp.sqrt(self.rho_crit(z) * (1 + z) ** 3 / constants.rho_crit_over_Msunph_per_Mpcph3)

    @flatarray()
    def hubble_function(self, z):
        return self.efunc(z) * self.H0

    @flatarray()
    def T_cmb(self, z):
        return self.T0_cmb * (1 + z)

    @flatarray()
    def T_ncdm(self, z, species=None):
        return self.T0_ncdm[species if species is not None else Ellipsis, None] * (1 + z)

    # ---- density parameters
    def Omega_cdm(self, z):
        return self.rho_cdm(z) / self.rho_crit(z)

    def Omega_b(self, z):
        return self.rho_b(z) / self.rho_crit(z)

    def Omega_k(self, z):
        return self.rho_k(z) / self.rho_crit(z)

    def Omega_g(self, z):
        return self.rho_g(z) / self.rho_crit(z)

    def Omega_ur(self, z):
        return self.rho_ur(z) / self.rho_crit(z)

    def Omega_r(self, z):
        return self.rho_r(z) / self.rho_crit(z)

    def Omega_m(self, z):
        return self.rho_m(z) / self.rho_crit(z)

    def Omega_ncdm(self, z, species=None):
        return self.rho_ncdm(z, species=species) / self.rho_crit(z)

    def Omega_ncdm_tot(self, z):
        return self.rho_ncdm_tot(z) / self.rho_crit(z)

    def Omega_pncdm(self, z, species=None):
        return 3 * self.p_ncdm(z, species=species) / self.rho_crit(z)

    def Omega_pncdm_tot(self, z):
        return 3 * self.p_ncdm_tot(z) / self.rho_crit(z)

    def Omega_Lambda(self, z):
        return self.rho_Lambda(z) / self.rho_crit(z)

    def Omega_fld(self, z):
        return self.rho_fld(z) / self.rho_crit(z)

    def Omega_de(self, z):
        return self.rho_de(z) / self.rho_crit(z)

    # ---- distances
    def _curved(self, chi):
        """Apply the curvature transverse function S_K to a comoving radial
        distance. K in (h/Mpc)^2; branchless where-based select (all three
        branches are cheap, avoiding lax.switch retrace overhead)."""
        K = self.K
        sqrt_absK = jnp.sqrt(jnp.abs(K))
        safe = jnp.where(sqrt_absK == 0, 1.0, sqrt_absK)
        closed = jnp.sin(safe * chi) / safe
        open_ = jnp.sinh(safe * chi) / safe
        return jnp.where(K == 0, chi, jnp.where(K > 0, closed, open_))

    @flatarray()
    def angular_diameter_distance(self, z):
        r"""Proper angular diameter distance, in Mpc/h (astro-ph/9905116 eq. 18)."""
        return self._curved(self.comoving_radial_distance(z)) / (1 + z)

    @flatarray(iargs=[0, 1])
    def angular_diameter_distance_2(self, z1, z2):
        r"""Angular diameter distance of z2 as seen from z1, in Mpc/h."""
        def warn(z1, z2):
            if np.any(np.asarray(z2) < np.asarray(z1)):
                import warnings
                warnings.warn('Second redshift(s) z2 < first redshift(s) z1.')
        exception(warn, z1, z2)
        return self._curved(self.comoving_radial_distance(z2) - self.comoving_radial_distance(z1)) / (1 + z2)

    @flatarray()
    def comoving_transverse_distance(self, z):
        r"""Comoving transverse distance, in Mpc/h (astro-ph/9905116 eq. 16)."""
        return self.angular_diameter_distance(z) * (1.0 + z)

    comoving_angular_distance = comoving_transverse_distance

    @flatarray()
    def luminosity_distance(self, z):
        return self.angular_diameter_distance(z) * (1.0 + z) ** 2

    def rs(self, z):
        """Sound horizon at z, in Mpc/h (CAMB's dsoundda integrand)."""
        astart = 1e-8
        astar = 1.0 / (1 + z)

        def dsoundda(a):
            dtauda = 1.0 / (a ** 2 * self.hubble_function(1 / a - 1.0) / (constants.c / 1e3))
            R = 3 / 4.0 * a * self.Omega0_b / self.Omega0_g
            cs = (3 * (1 + R)) ** (-0.5)
            return dtauda * cs

        return romberg(dsoundda, astart, astar, divmax=15, epsabs=1e-7, epsrel=1e-7) * self.h


def get_default_z_interp(name):
    """Static z-grids for background interpolation tables (reference
    cosmology.py:1940-1951)."""
    if name in ('rho_ncdm', 'p_ncdm'):
        zm = 1.0
        return np.concatenate([np.linspace(0.0, zm, 20)[:-1], 1.0 / np.geomspace(1e-8, 1.0 / (1 + zm), 100)[::-1] - 1.0])
    if name in ('time', 'age'):
        return 1.0 / np.logspace(-8, 0.0, 400)[::-1] - 1.0
    if name == 'comoving_radial_distance':
        zm = 0.3
        return np.concatenate([np.linspace(0.0, zm, 20)[:-1], 1.0 / np.geomspace(1e-4, 1.0 / (1 + zm), 100)[::-1] - 1.0])
    raise ValueError(f'No default z interpolation grid for {name}')


@register_section
class DefaultBackground(BaseBackground):
    """Background with precomputed interpolation tables for the expensive
    quantities (ncdm momenta, times, distances, growth). Tables are built on
    first access (inside any enclosing trace) and cached on the section."""

    def __init__(self, engine):
        super().__init__(engine)
        self._cache = {}

    def _ensure_ncdm_tables(self):
        """Materialize the ncdm interpolation tables BEFORE entering any
        lax.scan (odeint) whose body touches rho/p_ncdm: a table built while
        tracing the scan body would cache tracers and leak."""
        if self.N_ncdm:
            self.rho_ncdm(jnp.zeros(1))
            self.p_ncdm(jnp.zeros(1))

    @flatarray()
    def rho_ncdm(self, z, species=None):
        if self.N_ncdm == 0:
            return jnp.zeros((0, z.size), dtype=z.dtype)
        if 'rho_ncdm' not in self._cache:
            zc = get_default_z_interp('rho_ncdm')
            self._cache['rho_ncdm'] = Interpolator1D(zc, BaseBackground.rho_ncdm(self, zc).T, extrap=True, assume_sorted=True)
        out = self._cache['rho_ncdm'](z).T
        if species is None:
            return out
        return out[species]

    @flatarray()
    def p_ncdm(self, z, species=None):
        if self.N_ncdm == 0:
            return jnp.zeros((0, z.size), dtype=z.dtype)
        if 'p_ncdm' not in self._cache:
            zc = get_default_z_interp('p_ncdm')
            self._cache['p_ncdm'] = Interpolator1D(zc, BaseBackground.p_ncdm(self, zc).T, extrap=True, assume_sorted=True)
        out = self._cache['p_ncdm'](z).T
        if species is None:
            return out
        return out[species]

    @flatarray()
    def time(self, z):
        r"""Proper time (age of universe at z), in Gyr."""
        if 'time' not in self._cache:
            self._ensure_ncdm_tables()
            zc = get_default_z_interp('time')
            integ = lambda y, zz: constants.c / 1e3 / (1.0 + zz) / (100.0 * self.efunc(zz))
            tmp = cumquad_rk4(integ, 0.0, jnp.asarray(zc))  # y-independent integrand: no scan
            self._cache['time'] = Interpolator1D(zc, (tmp[-1] - tmp) / self.h / constants.gigayear_over_megaparsec, assume_sorted=True)
        return self._cache['time'](z)

    @property
    def age(self):
        r"""Current age of the Universe, in Gyr."""
        if 'age' not in self._cache:
            self._ensure_ncdm_tables()
            zc = get_default_z_interp('age')
            integ = lambda y, zz: constants.c / 1e3 / (1.0 + zz) / (100.0 * self.efunc(zz))
            tmp = cumquad_rk4(integ, 0.0, jnp.asarray(zc))  # y-independent integrand: no scan
            self._cache['age'] = (tmp[-1] - tmp[0]) / self.h / constants.gigayear_over_megaparsec
        return self._cache['age']

    @flatarray()
    def comoving_radial_distance(self, z):
        r"""Comoving radial distance, in Mpc/h (astro-ph/9905116 eq. 15)."""
        if 'comoving_radial_distance' not in self._cache:
            self._ensure_ncdm_tables()
            zc = get_default_z_interp('comoving_radial_distance')
            integ = lambda y, zz: constants.c / 1e3 / (100.0 * self.efunc(zz))
            tmp = cumquad_rk4(integ, 0.0, jnp.asarray(zc))  # y-independent integrand: no scan
            self._cache['comoving_radial_distance'] = Interpolator1D(zc, tmp, assume_sorted=True)
        return self._cache['comoving_radial_distance'](z)

    def _growth_tables(self, mass='m'):
        name_factor = f'growth_factor_{mass}'
        name_rate = f'growth_rate_{mass}'
        if name_factor not in self._cache:
            self._ensure_ncdm_tables()
            if mass == 'm':
                Omega_mass = self.Omega_m
            elif mass == 'cb':
                Omega_mass = lambda z: self.Omega_cdm(z) + self.Omega_b(z)
            else:
                raise ValueError("mass must be one of ['m', 'cb']")

            # D'' = f2(eta) D + f1(eta) D' in eta = ln(a): a LINEAR system,
            # so the 201 rk4 steps compose as a log-depth parallel prefix of
            # 2x2 propagators (ops/odeint.linear_ode2_rk4_prefix) — same rk4
            # recurrence to ~1e-15, no sequential scan in the megagraph
            def coeffs(eta):
                z = jnp.exp(-eta) - 1.0
                w_fld = self.w0_fld + z / (1.0 + z) * self.wa_fld
                addot = -0.5 * (1.0 - self.Omega_k(z) + self.Omega_r(z) + 3 * w_fld * self.Omega_de(z))
                return 1.5 * Omega_mass(z), -1.0 - addot

            eta = np.linspace(-6.0, 0.0, 201)
            zc = np.exp(-eta) - 1.0
            D0 = jnp.exp(jnp.asarray(eta[0]))
            sol = linear_ode2_rk4_prefix(coeffs, jnp.array([D0, D0]), jnp.asarray(eta))
            Dplus, Dplusp = sol[:, 0], sol[:, 1]
            self._cache[name_factor] = Interpolator1D(zc[::-1], Dplus[::-1], assume_sorted=True)
            self._cache[name_rate] = Interpolator1D(zc[::-1], (Dplusp / Dplus)[::-1], assume_sorted=True)
        return self._cache[name_factor], self._cache[name_rate]

    @flatarray()
    def growth_factor(self, z, mass='m', znorm=None):
        r"""Linear growth factor D(z) from the 2nd-order growth ODE in
        ln(a) with w(z)-aware friction, normalized to D(0)=1 (or to the
        matter-era (1+znorm)/(1+z) convention if ``znorm`` given)."""
        factor, _ = self._growth_tables(mass=mass)
        growthz = factor(z)
        if znorm is not None:
            return (1.0 + znorm) * growthz
        return growthz / factor(jnp.zeros(1))[0]

    @flatarray()
    def growth_rate(self, z, mass='m'):
        r"""Growth rate f(z) = dlnD/dlna."""
        _, rate = self._growth_tables(mass=mass)
        return rate(z)

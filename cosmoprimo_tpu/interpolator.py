r"""Power-spectrum and correlation-function interpolators.

Mirrors the reference interpolator.py API (PowerSpectrumInterpolator1D/2D,
CorrelationFunctionInterpolator1D/2D, sigma integrals at interpolator.py:
123-292, 412-1498) on top of the jnp cubic splines from ops/spline.py and
the FFTLog engine. All objects are pytrees; all methods trace.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .fftlog import CorrelationToPower, PowerToCorrelation, TophatVariance
from .ops import Interpolator1D, Interpolator2D, bcast_dtype, romberg, simpson
from .ops.quadrature import _leggauss


def get_default_k_callable():
    """Default k-grid (cosmopower-style, 540 points 1e-5 -> 1e2 h/Mpc)."""
    k = np.concatenate([np.logspace(-5, -4, num=20, endpoint=False),
                        np.logspace(-4, -3, num=40, endpoint=False),
                        np.logspace(-3, -2, num=60, endpoint=False),
                        np.logspace(-2, -1, num=80, endpoint=False),
                        np.logspace(-1, 0, num=100, endpoint=False),
                        np.logspace(0, 2, num=240, endpoint=True)])
    return k


def get_default_s_callable():
    return np.logspace(-6.0, 2.0, 500)


def get_default_z_callable():
    return np.linspace(0.0, 10.0 ** 0.5, 30) ** 2


_default_extrap_kmin = 1e-7
_default_extrap_kmax = 1e2


def _pad_log(k, pk, extrap_kmin=_default_extrap_kmin, extrap_kmax=_default_extrap_kmax):
    """Pad (log10 k, log10 pk) with two points per side continuing the edge
    power law out to the extrapolation range (reference interpolator.py:42-87).

    Non-positive pk values (e.g. FFT ringing in xi -> pk inversions at
    extreme k) are floored at a tiny positive value: our natural cubic
    splines are global solves, so a single NaN knot would poison the whole
    table rather than stay local."""
    logk = jnp.log10(k)
    logpk = jnp.log10(jnp.maximum(pk, 1e-250))
    lo = jnp.log10(jnp.minimum(extrap_kmin, k[0] * (1 - 1e-9)))
    hi = jnp.log10(jnp.maximum(extrap_kmax, k[-1] * (1 + 1e-9)))

    slope_hi = (logpk[-1] - logpk[-2]) / (logk[-1] - logk[-2])
    pad_hi_k = jnp.array([logk[-1] * 0.1 + hi * 0.9, hi])
    pad_hi_pk = jnp.stack([logpk[-1] + slope_hi * (pad_hi_k[0] - logk[-1]),
                           logpk[-1] + slope_hi * (pad_hi_k[1] - logk[-1])])

    slope_lo = (logpk[1] - logpk[0]) / (logk[1] - logk[0])
    pad_lo_k = jnp.array([lo, logk[0] * 0.1 + lo * 0.9])
    pad_lo_pk = jnp.stack([logpk[0] + slope_lo * (pad_lo_k[0] - logk[0]),
                           logpk[0] + slope_lo * (pad_lo_k[1] - logk[0])])

    logk = jnp.concatenate([pad_lo_k, logk, pad_hi_k], axis=0)
    logpk = jnp.concatenate([pad_lo_pk, logpk, pad_hi_pk], axis=0)
    return logk, logpk


# ----------------------------------------------------------------------------
# sigma integrals (reference interpolator.py:90-292)
# ----------------------------------------------------------------------------

def _kernel_tophat_lowx(x2):
    r"""Maclaurin expansion of W(x) = 3(sin x - x cos x)/x^3 (CCL-stabilized)."""
    return 1. + x2 * (-1.0 / 10.0 + x2 * (1.0 / 280.0 + x2 * (-1.0 / 15120.0 + x2 * (1.0 / 1330560.0 + x2 * (-1.0 / 172972800.0)))))


def kernel_tophat2(x):
    """Squared 3D tophat window W^2(x), numerically stable at low x."""
    x = jnp.asarray(x)
    lowx = _kernel_tophat_lowx(x ** 2)
    safe = jnp.where(x < 0.1, 1.0, x)
    highx = 3.0 * (jnp.sin(safe) - safe * jnp.cos(safe)) / safe ** 3
    return jnp.where(x < 0.1, lowx, highx) ** 2


def integrate_sigma_d2(pk, kmin=1e-7, kmax=1e2, method='simpson', epsabs=1e-5, epsrel=1e-5, nk=None):
    r"""Displacement-field variance :math:`\sigma_d^2 = \frac{1}{6\pi^2}\int dk P(k)`."""
    p = pk(jnp.atleast_1d(jnp.asarray(kmin)))
    pshape = p.shape[1:]
    dtype = bcast_dtype(p)

    def integrand(logk):
        k = jnp.exp(logk)
        pp = pk(k).reshape(k.shape + (-1,))
        return k[:, None] * pp

    limits = (jnp.log(kmin * (1. + 1e-9)), jnp.log(kmax * (1. - 1e-9)))
    if method == 'romberg':
        tmp = romberg(integrand, *limits, epsabs=epsabs, epsrel=epsrel)
    elif method == 'leggauss':
        nk = nk or 100
        xi, wi = _leggauss(nk)
        logk = (limits[1] - limits[0]) / 2. * (1. + jnp.asarray(xi)) + limits[0]
        w = (limits[1] - limits[0]) / 2. * jnp.asarray(wi)
        tmp = jnp.sum(integrand(logk) * w[:, None], axis=0)
    else:  # simpson
        nk = nk or 1024
        logk = jnp.linspace(*limits, nk)
        tmp = simpson(integrand(logk), x=logk, axis=0)
    return (tmp.reshape(pshape) / (6. * jnp.pi ** 2)).astype(dtype)


def integrate_sigma_r2(r, pk, kmin=1e-7, kmax=1e2, method='fftlog', epsabs=1e-5, epsrel=1e-5,
                       nk=None, kernel=kernel_tophat2):
    r"""Smoothed variance :math:`\sigma_r^2 = \frac{1}{2\pi^2}\int dk k^2 P(k) W^2(kr)`.

    The default 'fftlog' method evaluates a TophatVariance transform on a
    1024-point geometric grid and splines the result in r — one batched FFT
    per call, vmappable over any parameter batch.
    """
    p = pk(jnp.atleast_1d(jnp.asarray(kmin)))
    pshape = p.shape[1:]
    dtype = bcast_dtype(r, p)
    r = jnp.asarray(r, dtype=jnp.float64)
    rshape = r.shape
    r = jnp.atleast_1d(r).ravel()

    limits = (jnp.log(kmin * (1. + 1e-9)), jnp.log(kmax * (1. - 1e-9)))

    def integrand(logk):
        k = jnp.exp(logk)
        pp = pk(k).reshape(k.shape + (-1,))
        return kernel(k[:, None] * r)[:, :, None] * (k[:, None] ** 3 * pp)[:, None, :]

    if method == 'romberg':
        tmp = romberg(integrand, *limits, epsabs=epsabs, epsrel=epsrel)
    elif method == 'leggauss':
        nk = nk or 100
        xi, wi = _leggauss(nk)
        logk = (limits[1] - limits[0]) / 2. * (1. + jnp.asarray(xi)) + limits[0]
        w = (limits[1] - limits[0]) / 2. * jnp.asarray(wi)
        tmp = jnp.sum(integrand(logk) * w[:, None, None], axis=0)
    elif method == 'simpson':
        nk = nk or 1024
        logk = jnp.linspace(*limits, nk)
        tmp = simpson(integrand(logk), x=logk, axis=0)
    else:  # fftlog
        nk = nk or 1024
        k = _static_geomspace(kmin, kmax, nk)
        s, var = TophatVariance(k)(pk(jnp.asarray(k)).reshape(k.shape + (-1,)).T)
        tmp = (2. * jnp.pi ** 2) * Interpolator1D(s, var.T, assume_sorted=True)(r)
    tmp = jnp.asarray(tmp).reshape(rshape + pshape)
    return (tmp / (2. * jnp.pi ** 2)).astype(dtype)


# ----------------------------------------------------------------------------
# Interpolators
# ----------------------------------------------------------------------------

def _is_traced(*arrays):
    return any(isinstance(a, jax.core.Tracer) for a in arrays)


def _sorted(x):
    """Sorted 1D grid; stays a host numpy constant when the input is
    concrete (so extrap bounds remain usable as static floats even inside a
    jit trace — jnp.asarray would stage the constant as a tracer)."""
    if _is_traced(x):
        return jnp.sort(jnp.asarray(x, dtype=jnp.float64).ravel())
    return np.sort(np.asarray(x, dtype=np.float64).ravel())


def _argsorted(x):
    if _is_traced(x):
        return jnp.argsort(jnp.asarray(x).ravel())
    return np.argsort(np.asarray(x).ravel())


def _static_geomspace(a, b, n):
    """Geometric grid built host-side (numpy) when the limits are concrete,
    so FFTLog setup stays on the host even inside a jit trace (Mellin
    coefficients are host-precomputed for static grids)."""
    try:
        return np.clip(np.geomspace(float(a), float(b), n), float(a), float(b))
    except (TypeError, jax.errors.TracerArrayConversionError, jax.errors.ConcretizationTypeError):
        return jnp.clip(jnp.geomspace(a, b, n), a, b)


class _BaseInterpolator(object):
    """Shared machinery: either a spline over tabulated values, or a wrapped
    callable, with bounds masking and sigma8 renormalization."""

    def params(self):
        return {name: getattr(self, name) for name in self.default_params}

    def clone(self, **kwargs):
        return self.__class__(**{**self.as_dict(), **kwargs})

    def deepcopy(self):
        return self.__class__(**self.as_dict())

    def copy(self):
        """Return shallow copy of ``self`` (reference utils.py:55-64)."""
        new = self.__class__.__new__(self.__class__)
        new.__dict__.update(self.__dict__)
        return new

    def tree_flatten(self):
        children = ({name: getattr(self, name) for name in self._tree_children if hasattr(self, name)},)
        aux = {name: getattr(self, name) for name in ['is_from_callable', '_is2d'] if hasattr(self, name)} | self.params()
        aux.pop('growth_factor_sq', None)  # callable: lives in children only
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        new.__dict__.update(aux)
        new.__dict__.update(children[0])
        return new


@jax.tree_util.register_pytree_node_class
class PowerSpectrumInterpolator1D(_BaseInterpolator):
    """1D P(k) interpolator with log-log extrapolation, sigma integrals and
    FFTLog transform to the correlation function."""

    _tree_children = ['k', '_pk', '_rsigma8sq', '_interp']

    def __init__(self, k, pk, interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                 extrap_kmax=_default_extrap_kmax, interp_order_k=3):
        self._rsigma8sq = 1.0
        self.k = _sorted(k)
        self._pk = jnp.asarray(pk, dtype=jnp.float64)[_argsorted(k)]
        self.interp_k = str(interp_k)
        self.extrap_pk = str(extrap_pk)
        self.interp_order_k = int(interp_order_k)
        self.extrap_kmin, self.extrap_kmax = self.k[0], self.k[-1]
        kk, pp = self.k, self._pk
        if self.extrap_pk == 'log':
            if self.interp_k != 'log':
                raise ValueError('log-log extrapolation requires log-k interpolation')
            self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
            kk, pp = _pad_log(kk, pp, extrap_kmin=extrap_kmin, extrap_kmax=extrap_kmax)
            kk, pp = 10 ** kk, 10 ** pp
        self._interp = Interpolator1D(kk, pp, k=self.interp_order_k, interp_x=self.interp_k,
                                      interp_fun=self.extrap_pk, assume_sorted=True)
        self.is_from_callable = False

    default_params = dict(interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                          extrap_kmax=_default_extrap_kmax, interp_order_k=3)

    @classmethod
    def from_callable(cls, k=None, pk_callable=None, extrap_kmin=_default_extrap_kmin, extrap_kmax=_default_extrap_kmax):
        """Wrap a P(k) callable with the interpolator interface."""
        if k is None:
            k = get_default_k_callable()
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self._rsigma8sq = 1.0
        self.k = _sorted(k)
        self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
        self.is_from_callable = True
        self._interp = pk_callable
        return self

    @property
    def pk(self):
        if self.is_from_callable:
            return self(self.k)
        return self._pk * self._rsigma8sq

    @property
    def kmin(self):
        return self.k[0]

    @property
    def kmax(self):
        return self.k[-1]

    def as_dict(self):
        state = self.params()
        state['k'] = self.k
        state['pk'] = self.pk
        return state

    def __call__(self, k, bounds_error=False, **kwargs):
        dtype = bcast_dtype(k)
        k = jnp.asarray(k, dtype=jnp.float64)
        toret_shape = k.shape
        k = k.ravel()
        if self.is_from_callable:
            mask = (k >= self.extrap_kmin) & (k <= self.extrap_kmax)
            tmp = self._interp(k, **kwargs)
            tmp = jnp.where(mask.reshape(mask.shape + (1,) * (tmp.ndim - 1)), tmp, jnp.nan)
            out = tmp.reshape(toret_shape + tmp.shape[1:])
        else:
            out = self._interp(k, bounds_error=bounds_error).reshape(toret_shape)
        return (out * self._rsigma8sq).astype(dtype)

    def sigma_d(self, **kwargs):
        r"""r.m.s. displacement :math:`\sigma_d`."""
        return integrate_sigma_d2(self, kmin=self.extrap_kmin, kmax=self.extrap_kmax, **kwargs) ** 0.5

    def sigma_r(self, r, **kwargs):
        r"""r.m.s. of perturbations in a sphere of radius r (Mpc/h)."""
        toret = integrate_sigma_r2(r, self, kmin=self.extrap_kmin, kmax=self.extrap_kmax, **kwargs) ** 0.5
        return toret.astype(bcast_dtype(r))

    def sigma8(self, **kwargs):
        return self.sigma_r(8.0, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8() ** 2

    def to_xi(self, nk=1024, fftlog_kwargs=None, **kwargs):
        """P(k) -> xi(s) via FFTLog; returns CorrelationFunctionInterpolator1D."""
        k = _static_geomspace(self.extrap_kmin, self.extrap_kmax, nk)
        s, xi = PowerToCorrelation(k, complex=False, **(fftlog_kwargs or {}))(self(jnp.asarray(k)).T)
        default_params = dict(interp_s='log', interp_order_s=self.interp_order_k)
        default_params.update(kwargs)
        return CorrelationFunctionInterpolator1D(s, xi=xi.T, **default_params)


@jax.tree_util.register_pytree_node_class
class PowerSpectrumInterpolator2D(_BaseInterpolator):
    """2D P(k, z) interpolator; either a (k, z) spline or a 1D k-spline times
    a separable ``growth_factor_sq(z)`` callable (reference
    interpolator.py:609-987)."""

    _tree_children = ['k', 'z', '_pk', '_rsigma8sq', '_interp', 'growth_factor_sq']

    def __init__(self, k, z, pk, interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                 extrap_kmax=_default_extrap_kmax, interp_order_k=3, interp_order_z=3, growth_factor_sq=None):
        self._rsigma8sq = 1.0
        self.growth_factor_sq = growth_factor_sq
        ik = _argsorted(k)
        self.k = _sorted(k)
        pk = jnp.asarray(pk, dtype=jnp.float64)
        pk = pk.reshape(self.k.shape + (-1,))[ik]
        iz = _argsorted(z)
        self.z = _sorted(z)
        self._pk = pk[:, iz] if pk.shape[1] == self.z.shape[0] else pk
        self.interp_k = str(interp_k)
        self.extrap_pk = str(extrap_pk)
        self.interp_order_k, self.interp_order_z = int(interp_order_k), int(interp_order_z)
        self.extrap_kmin, self.extrap_kmax = self.k[0], self.k[-1]
        kk, pp = self.k, self._pk
        if self.extrap_pk == 'log':
            if self.interp_k != 'log':
                raise ValueError('log-log extrapolation requires log-k interpolation')
            self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
            kk, pp = _pad_log(kk, pp, extrap_kmin=extrap_kmin, extrap_kmax=extrap_kmax)
            kk, pp = 10 ** kk, 10 ** pp
        self._is2d = self._pk.shape[1] > 1
        if self._is2d:
            self._interp = Interpolator2D(kk, self.z, pp, kx=self.interp_order_k, ky=min(self.interp_order_z, 3),
                                          interp_x=self.interp_k, interp_fun=self.extrap_pk, assume_sorted=True)
        else:
            if self.growth_factor_sq is None:
                raise ValueError('provide either 2D pk array or growth_factor_sq')
            self._interp = Interpolator1D(kk, pp[:, 0], k=self.interp_order_k, interp_x=self.interp_k,
                                          interp_fun=self.extrap_pk, assume_sorted=True)
        self.is_from_callable = False

    default_params = dict(interp_k='log', extrap_pk='log', extrap_kmin=_default_extrap_kmin,
                          extrap_kmax=_default_extrap_kmax, interp_order_k=3, interp_order_z=3,
                          growth_factor_sq=None)

    @classmethod
    def from_callable(cls, k=None, z=None, pk_callable=None, growth_factor_sq=None,
                      extrap_kmin=_default_extrap_kmin, extrap_kmax=_default_extrap_kmax):
        """Wrap pk_callable(k[, z]) (with optional separable growth) with the
        2D interpolator interface."""
        if k is None:
            k = get_default_k_callable()
        if z is None:
            z = get_default_z_callable()
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self._rsigma8sq = 1.0
        self.k = _sorted(k)
        self.z = _sorted(z)
        self.growth_factor_sq = growth_factor_sq
        self.extrap_kmin, self.extrap_kmax = extrap_kmin, extrap_kmax
        self.is_from_callable = True
        self._interp = pk_callable
        return self

    @property
    def pk(self):
        if self.is_from_callable:
            kwargs = {'ignore_growth': True} if self.growth_factor_sq is not None else {}
            return self(self.k, self.z, **kwargs)
        return self._pk * self._rsigma8sq

    @property
    def kmin(self):
        return self.k[0]

    @property
    def kmax(self):
        return self.k[-1]

    @property
    def zmin(self):
        return self.z[0]

    @property
    def zmax(self):
        return self.z[-1]

    def as_dict(self):
        state = self.params()
        state['k'] = self.k
        state['z'] = self.z
        state['pk'] = self.pk
        return state

    def __call__(self, k, z, grid=True, ignore_growth=False, bounds_error=False):
        dtype = bcast_dtype(k, z)
        k = jnp.asarray(k, dtype=jnp.float64)
        z = jnp.asarray(z, dtype=jnp.float64)
        toret_shape = (k.shape + z.shape) if grid else k.shape
        k, z = k.ravel(), z.ravel()
        mask_k = (k >= self.extrap_kmin) & (k <= self.extrap_kmax)
        mask_z = (z >= self.zmin) & (z <= self.zmax)
        if self.is_from_callable:
            if self.growth_factor_sq is not None:
                tmp = self._interp(k)
                growth = 1.0 if ignore_growth else self.growth_factor_sq(z)
                tmp = (tmp[..., None] * growth) if grid else (tmp * growth)
            else:
                tmp = self._interp(k, z, grid=grid)
        else:
            if not self._is2d:
                mask_z = mask_z | True
                tmp = self._interp(k, bounds_error=False)
                if grid:
                    tmp = jnp.repeat(tmp[:, None], z.size, axis=-1)
            else:
                tmp = self._interp(k, z, grid=grid, bounds_error=False)
            if self.growth_factor_sq is not None and not ignore_growth:
                tmp = tmp * self.growth_factor_sq(z)
        mask = (mask_k[:, None] & mask_z) if grid else (mask_k & mask_z)
        tmp = jnp.where(mask, tmp, jnp.nan)
        return (tmp * self._rsigma8sq).astype(dtype).reshape(toret_shape)

    def sigma_dz(self, z, **kwargs):
        r"""r.m.s. displacement :math:`\sigma_d(z)`."""
        toret = integrate_sigma_d2(lambda k: self(k, z), kmin=self.extrap_kmin, kmax=self.extrap_kmax, **kwargs) ** 0.5
        return toret.astype(bcast_dtype(z))

    def sigma_rz(self, r, z, **kwargs):
        r"""r.m.s. of perturbations in a sphere of r at z; shape (r, z)."""
        toret = integrate_sigma_r2(r, lambda k: self(k, z), kmin=self.extrap_kmin, kmax=self.extrap_kmax, **kwargs) ** 0.5
        return toret.astype(bcast_dtype(r, z))

    def sigma8_z(self, z=0, **kwargs):
        return self.sigma_rz(8.0, z=z, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8_z(z=0) ** 2

    def growth_rate_rz(self, r, z, dz=1e-3, **kwargs):
        r"""f(r, z) = dln sigma_r / dln a by five-point central differences,
        one-sided at the z-table edges (reference interpolator.py:886-936)."""
        dtype = bcast_dtype(r, z)
        r = jnp.asarray(r, dtype=jnp.float64)
        z = jnp.asarray(z, dtype=jnp.float64)
        toret_shape = r.shape + z.shape
        z = z.ravel()
        hdz = dz / 2.0

        def logsig(zz):
            return jnp.log(self.sigma_rz(r, zz, **kwargs)).reshape(-1, z.size)

        feval = [logsig(z - dz), logsig(z - hdz), logsig(z), logsig(z + hdz), logsig(z + dz)]
        toret = jnp.where(z < self.zmin + hdz, -feval[4] + 4 * feval[3] - 3 * feval[2], feval[3] - feval[1])
        toret = jnp.where(z > self.zmax - hdz, -(-feval[0] + 4 * feval[1] - 3 * feval[2]), toret)
        dsigdlna = -toret / dz * (1 + z)
        return dsigdlna.astype(dtype).reshape(toret_shape)

    def to_1d(self, z, **kwargs):
        """Slice to a PowerSpectrumInterpolator1D at redshift z."""
        if self.is_from_callable:
            return PowerSpectrumInterpolator1D.from_callable(
                self.k, pk_callable=jax.tree_util.Partial(lambda s, k, **kw: s(k, z=z, **kw), self),
                extrap_kmin=self.extrap_kmin, extrap_kmax=self.extrap_kmax)
        default_params = dict(extrap_pk=self.extrap_pk, extrap_kmin=self.extrap_kmin,
                              extrap_kmax=self.extrap_kmax, interp_order_k=self.interp_order_k)
        default_params.update(kwargs)
        if self._is2d:
            pk = self._interp(self.k, jnp.atleast_1d(z), grid=True, bounds_error=False)[:, 0]
        else:
            pk = self._interp(self.k, bounds_error=False)
        if self.growth_factor_sq is not None:
            pk = pk * self.growth_factor_sq(z)
        pk = pk * self._rsigma8sq
        return PowerSpectrumInterpolator1D(self.k, pk, **default_params)

    def to_xi(self, nk=1024, fftlog_kwargs=None, **kwargs):
        """P(k, z) -> xi(s, z) via one batched FFTLog over the z-axis."""
        k = _static_geomspace(self.extrap_kmin, self.extrap_kmax, nk)
        s, xi = PowerToCorrelation(k, complex=False, **(fftlog_kwargs or {}))(self(jnp.asarray(k), z=self.z, ignore_growth=True).T)
        default_params = dict(interp_s='log', interp_order_s=self.interp_order_k,
                              interp_order_z=self.interp_order_z, growth_factor_sq=self.growth_factor_sq)
        default_params.update(kwargs)
        return CorrelationFunctionInterpolator2D(s, z=self.z, xi=xi.T, **default_params)


@jax.tree_util.register_pytree_node_class
class CorrelationFunctionInterpolator1D(_BaseInterpolator):
    """1D xi(s) interpolator."""

    _tree_children = ['s', '_xi', '_rsigma8sq', '_interp']

    def __init__(self, s, xi, interp_s='log', interp_order_s=3):
        self._rsigma8sq = 1.0
        isort = _argsorted(s)
        self.s = _sorted(s)
        self._xi = jnp.asarray(xi, dtype=jnp.float64)[isort]
        self.interp_s = str(interp_s)
        self.interp_order_s = int(interp_order_s)
        self._interp = Interpolator1D(self.s, self._xi, k=self.interp_order_s, interp_x=self.interp_s, assume_sorted=True)
        self.is_from_callable = False

    default_params = dict(interp_s='log', interp_order_s=3)

    @classmethod
    def from_callable(cls, s=None, xi_callable=None):
        if s is None:
            s = get_default_s_callable()
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self._rsigma8sq = 1.0
        self.s = _sorted(s)
        self.is_from_callable = True
        self._interp = xi_callable
        return self

    @property
    def xi(self):
        if self.is_from_callable:
            return self(self.s)
        return self._xi * self._rsigma8sq

    @property
    def smin(self):
        return self.s[0]

    @property
    def smax(self):
        return self.s[-1]

    extrap_smin = smin
    extrap_smax = smax

    def as_dict(self):
        state = self.params()
        state['s'] = self.s
        state['xi'] = self.xi
        return state

    def __call__(self, s, bounds_error=False, **kwargs):
        dtype = bcast_dtype(s)
        s = jnp.asarray(s, dtype=jnp.float64)
        toret_shape = s.shape
        s = s.ravel()
        if self.is_from_callable:
            mask = (s >= self.smin) & (s <= self.smax)
            tmp = jnp.where(mask, self._interp(s, **kwargs), jnp.nan)
        else:
            tmp = self._interp(s, bounds_error=bounds_error)
        return (tmp * self._rsigma8sq).astype(dtype).reshape(toret_shape)

    def sigma_d(self, **kwargs):
        return self.to_pk().sigma_d(**kwargs)

    def sigma_r(self, r, **kwargs):
        return self.to_pk().sigma_r(r, **kwargs)

    def sigma8(self, **kwargs):
        return self.sigma_r(8.0, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8() ** 2

    def to_pk(self, ns=1024, fftlog_kwargs=None, **kwargs):
        """xi(s) -> P(k) via FFTLog."""
        s = _static_geomspace(self.smin, self.smax, ns)
        k, pk = CorrelationToPower(s, complex=False, **(fftlog_kwargs or {}))(self(jnp.asarray(s)))
        default_params = dict(interp_k='log', interp_order_k=self.interp_order_s)
        default_params.update(kwargs)
        return PowerSpectrumInterpolator1D(k, pk=pk, **default_params)


@jax.tree_util.register_pytree_node_class
class CorrelationFunctionInterpolator2D(_BaseInterpolator):
    """2D xi(s, z) interpolator (optionally separable in growth)."""

    _tree_children = ['s', 'z', '_xi', '_rsigma8sq', '_interp', 'growth_factor_sq']

    def __init__(self, s, z, xi, interp_s='log', interp_order_s=3, interp_order_z=3, growth_factor_sq=None):
        self._rsigma8sq = 1.0
        self.growth_factor_sq = growth_factor_sq
        isort = _argsorted(s)
        self.s = _sorted(s)
        xi = jnp.asarray(xi, dtype=jnp.float64).reshape(self.s.shape + (-1,))[isort]
        iz = _argsorted(z)
        self.z = _sorted(z)
        self._xi = xi[:, iz] if xi.shape[1] == self.z.shape[0] else xi
        self.interp_s = str(interp_s)
        self.interp_order_s, self.interp_order_z = int(interp_order_s), int(interp_order_z)
        self._is2d = self._xi.shape[1] > 1
        if self._is2d:
            self._interp = Interpolator2D(self.s, self.z, self._xi, kx=self.interp_order_s,
                                          ky=min(self.interp_order_z, 3), interp_x=self.interp_s, assume_sorted=True)
        else:
            if self.growth_factor_sq is None:
                raise ValueError('provide either 2D xi array or growth_factor_sq')
            self._interp = Interpolator1D(self.s, self._xi[:, 0], k=self.interp_order_s,
                                          interp_x=self.interp_s, assume_sorted=True)
        self.is_from_callable = False

    default_params = dict(interp_s='log', interp_order_s=3, interp_order_z=3, growth_factor_sq=None)

    @classmethod
    def from_callable(cls, s=None, z=None, xi_callable=None, growth_factor_sq=None):
        if s is None:
            s = get_default_s_callable()
        if z is None:
            z = get_default_z_callable()
        self = cls.__new__(cls)
        self.__dict__.update(self.default_params)
        self._rsigma8sq = 1.0
        self.s = _sorted(s)
        self.z = _sorted(z)
        self.growth_factor_sq = growth_factor_sq
        self.is_from_callable = True
        self._interp = xi_callable
        return self

    @property
    def xi(self):
        if self.is_from_callable:
            gf = self.growth_factor_sq
            self.growth_factor_sq = lambda x: jnp.ones_like(x)
            toret = self(self.s, self.z)
            self.growth_factor_sq = gf
            return toret
        return self._xi * self._rsigma8sq

    @property
    def smin(self):
        return self.s[0]

    @property
    def smax(self):
        return self.s[-1]

    extrap_smin = smin
    extrap_smax = smax

    @property
    def zmin(self):
        return self.z[0]

    @property
    def zmax(self):
        return self.z[-1]

    def as_dict(self):
        state = self.params()
        state['s'] = self.s
        state['z'] = self.z
        state['xi'] = self.xi
        return state

    def __call__(self, s, z, grid=True, ignore_growth=False, bounds_error=False):
        dtype = bcast_dtype(s, z)
        s = jnp.asarray(s, dtype=jnp.float64)
        z = jnp.asarray(z, dtype=jnp.float64)
        toret_shape = (s.shape + z.shape) if grid else s.shape
        s, z = s.ravel(), z.ravel()
        mask_s = (s >= self.smin) & (s <= self.smax)
        mask_z = (z >= self.zmin) & (z <= self.zmax)
        if self.is_from_callable:
            if self.growth_factor_sq is not None:
                tmp = self._interp(s)
                growth = 1.0 if ignore_growth else self.growth_factor_sq(z)
                tmp = (tmp[..., None] * growth) if grid else (tmp * growth)
            else:
                tmp = self._interp(s, z, grid=grid)
        else:
            if not self._is2d:
                mask_z = mask_z | True
                tmp = self._interp(s, bounds_error=False)
                if grid:
                    tmp = jnp.repeat(tmp[:, None], z.size, axis=-1)
            else:
                tmp = self._interp(s, z, grid=grid, bounds_error=False)
            if self.growth_factor_sq is not None and not ignore_growth:
                tmp = tmp * self.growth_factor_sq(z)
        mask = (mask_s[:, None] & mask_z) if grid else (mask_s & mask_z)
        tmp = jnp.where(mask, tmp, jnp.nan)
        return (tmp * self._rsigma8sq).astype(dtype).reshape(toret_shape)

    def sigma_dz(self, z, **kwargs):
        return self.to_pk().sigma_dz(z=z, **kwargs)

    def sigma_rz(self, r, z, **kwargs):
        return self.to_pk().sigma_rz(r, z=z, **kwargs)

    def sigma8_z(self, z, **kwargs):
        return self.sigma_rz(8.0, z=z, **kwargs)

    def rescale_sigma8(self, sigma8=1.0):
        self._rsigma8sq = 1.0
        self._rsigma8sq = sigma8 ** 2 / self.sigma8_z(z=0) ** 2

    def growth_rate_rz(self, r, z, **kwargs):
        return self.to_pk().growth_rate_rz(r, z=z, **kwargs)

    def to_1d(self, z, **kwargs):
        if self.is_from_callable:
            return CorrelationFunctionInterpolator1D.from_callable(
                self.s, jax.tree_util.Partial(lambda self, s, **kw: self(s, z=z, **kw), self))
        default_params = dict(interp_order_s=self.interp_order_s)
        default_params.update(kwargs)
        return CorrelationFunctionInterpolator1D(self.s, self(self.s, z=z), **default_params)

    def to_pk(self, ns=1024, fftlog_kwargs=None, **kwargs):
        """xi(s, z) -> P(k, z) via one batched FFTLog over the z-axis."""
        s = _static_geomspace(self.smin, self.smax, ns)
        k, pk = CorrelationToPower(s, complex=False, **(fftlog_kwargs or {}))(self(jnp.asarray(s), self.z, ignore_growth=True).T)
        default_params = dict(interp_k='log', extrap_pk='log', interp_order_k=self.interp_order_s,
                              interp_order_z=self.interp_order_z, growth_factor_sq=self.growth_factor_sq)
        default_params.update(kwargs)
        return PowerSpectrumInterpolator2D(k, z=self.z, pk=pk.T, **default_params)

r"""FFTLog transforms.

Computes :math:`G(y) = \int_0^\infty x\,dx\,F(x) K(xy)` for log-spaced x via
the FFTLog algorithm (Hamilton 2000), with:

- Mellin kernel coefficients evaluated **on device** with the Lanczos
  ``loggamma`` (ops/special.py), removing the reference's host
  ``pure_callback`` round-trip (cosmoprimo/fftlog.py:16-27);
- the transform itself a batched real FFT over arbitrary leading axes
  (nparallel kernels x any batch shape), handed to XLA's native FFT;
- everything pytree-registered and differentiable (jit/vmap/jacfwd).

API parity with the reference fftlog.py: FFTlog, HankelTransform,
PowerToCorrelation, CorrelationToPower, TophatVariance, GaussianVariance,
``pad`` and the Mellin kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .ops.fft import irfft_pair, rfft_pair
from .ops.special import loggamma as _loggamma


def _is_traced(*arrays):
    return any(isinstance(a, jax.core.Tracer) for a in arrays)


# ----------------------------------------------------------------------------
# Mellin transforms of kernels: U_K(z) = \int_0^\infty t^{z-1} K(t) dt
# ----------------------------------------------------------------------------

def _kernel_backend(z):
    """numpy for host-side setup on concrete grids, jnp when traced."""
    if _is_traced(z) or isinstance(z, jnp.ndarray):
        return jnp, jnp.asarray(z, dtype=jnp.complex128)
    return np, np.asarray(z, dtype=np.complex128)


class BaseKernel(object):
    """Base Mellin kernel."""

    def __call__(self, z):
        return self.eval(z)

    def __eq__(self, other):
        return other.__class__ == self.__class__


class BesselJKernel(BaseKernel):
    """Mellin transform of the Bessel function J_nu."""

    def __init__(self, nu):
        self.nu = nu

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.nu == self.nu

    def eval(self, z):
        xp, z = _kernel_backend(z)
        return xp.exp(xp.log(2.0) * (z - 1) + _loggamma(0.5 * (self.nu + z)) - _loggamma(0.5 * (2 + self.nu - z)))


class SphericalBesselJKernel(BaseKernel):
    """Mellin transform of the spherical Bessel function j_ell."""

    def __init__(self, nu):
        self.nu = nu

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.nu == self.nu

    def eval(self, z):
        xp, z = _kernel_backend(z)
        return xp.exp(xp.log(2.0) * (z - 1.5) + _loggamma(0.5 * (self.nu + z)) - _loggamma(0.5 * (3 + self.nu - z)))


class TophatKernel(BaseKernel):
    """Mellin transform of the ndim-dimensional tophat window."""

    def __init__(self, ndim=1):
        self.ndim = ndim

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.ndim == self.ndim

    def eval(self, z):
        xp, z = _kernel_backend(z)
        return xp.exp(xp.log(2.0) * (z - 1) + _loggamma(1 + 0.5 * self.ndim)
                      + _loggamma(0.5 * z) - _loggamma(0.5 * (2 + self.ndim - z)))


class TophatSqKernel(BaseKernel):
    """Mellin transform of the squared tophat window."""

    def __init__(self, ndim=1):
        self.ndim = ndim

    def __eq__(self, other):
        return other.__class__ == self.__class__ and other.ndim == self.ndim

    def eval(self, z):
        xp, z = _kernel_backend(z)
        if self.ndim == 1:
            return -0.25 * xp.sqrt(xp.pi) * xp.exp(_loggamma(0.5 * (z - 2)) - _loggamma(0.5 * (3 - z)))
        if self.ndim == 3:
            return (2.25 * xp.sqrt(xp.pi) * (z - 2) / (z - 6)
                    * xp.exp(_loggamma(0.5 * (z - 4)) - _loggamma(0.5 * (5 - z))))
        return xp.exp(xp.log(2.0) * (self.ndim - 1) + 2 * _loggamma(1 + 0.5 * self.ndim)
                      + _loggamma(0.5 * (1 + self.ndim - z)) + _loggamma(0.5 * z)
                      - _loggamma(1 + self.ndim - 0.5 * z) - _loggamma(0.5 * (2 + self.ndim - z))) / xp.sqrt(xp.pi)


class GaussianKernel(BaseKernel):
    """Mellin transform of the Gaussian window."""

    def eval(self, z):
        xp, z = _kernel_backend(z)
        return 2 ** (0.5 * z - 1) * xp.exp(_loggamma(0.5 * z))


class GaussianSqKernel(BaseKernel):
    """Mellin transform of the squared Gaussian window."""

    def eval(self, z):
        xp, z = _kernel_backend(z)
        return 0.5 * xp.exp(_loggamma(0.5 * z))


# ----------------------------------------------------------------------------
# Padding
# ----------------------------------------------------------------------------

def pad(array, pad_width, axis=-1, extrap=0):
    """Pad ``array`` along ``axis``; ``extrap`` is 'log' (log-log power-law
    continuation), 'edge', or a constant fill value; a (left, right) tuple
    differentiates the two sides."""
    array = jnp.asarray(array)
    try:
        wl, wr = pad_width
    except (TypeError, ValueError):
        wl = wr = pad_width
    try:
        el, er = extrap
    except (TypeError, ValueError):
        el = er = extrap

    axis = axis % array.ndim
    to_axis = [1] * array.ndim
    to_axis[axis] = -1

    def take(i):
        return jnp.take(array, jnp.array([i]), axis=axis)

    if el == 'edge':
        left = jnp.repeat(take(0), wl, axis=axis)
    elif el == 'log':
        end = take(0)
        ratio = take(1) / end
        exp = jnp.arange(-wl, 0).reshape(to_axis)
        left = end * ratio ** exp
    else:
        left = jnp.full(array.shape[:axis] + (wl,) + array.shape[axis + 1:], el, dtype=array.dtype)

    if er == 'edge':
        right = jnp.repeat(take(-1), wr, axis=axis)
    elif er == 'log':
        end = take(-1)
        ratio = take(-2) / end
        exp = jnp.arange(1, wr + 1).reshape(to_axis)
        right = end / ratio ** exp
    else:
        right = jnp.full(array.shape[:axis] + (wr,) + array.shape[axis + 1:], er, dtype=array.dtype)

    return jnp.concatenate([left, array, right], axis=axis)


# ----------------------------------------------------------------------------
# FFTLog core
# ----------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class FFTlog(object):
    r"""FFTLog transform engine performing ``nparallel`` kernel transforms at
    once (leading axis), each over a log-spaced coordinate array.

    All setup products (low-ringing output grid, Mellin coefficient array
    ``padded_u``, pre/post power-law factors) are computed in jnp at
    construction, so construction itself can sit inside a jit trace; the
    transform is pad -> rfft -> multiply -> irfft -> crop, batched over any
    leading shape.

    Conventions match the reference (cosmoprimo/fftlog.py:31-248): kernel
    Mellin transforms are defined with ``t^{z-1}`` so Bessel kernels use
    ``q = 1.5`` tilts for the standard pk <-> xi transforms.
    """

    def __init__(self, x, kernel, q=0, minfolds=2, lowring=True, xy=1, check_level=0, engine='auto', **engine_kwargs):
        self.inparallel = isinstance(kernel, (tuple, list))
        self.set_fft_engine(engine, **engine_kwargs)
        kernels = list(kernel) if self.inparallel else [kernel]
        nk = len(kernels)
        if np.ndim(q) == 0:
            q = [q] * nk
        if np.ndim(xy) == 0:
            xy = [xy] * nk
        # Host-side numpy setup whenever the grid is concrete: the Mellin
        # coefficients depend only on the (static) grid and kernels, so they
        # are computed once on host and stay out of the traced program.
        xp = jnp if _is_traced(x) else np
        x = xp.asarray(x, dtype=xp.float64)
        shared_x = x.ndim == 1
        if not self.inparallel:
            x = x[None, :]
        elif x.ndim == 1:
            x = xp.tile(x[None, :], (nk, 1))
        self.x = x
        self._setup(xp, kernels, list(q), minfolds=minfolds, lowring=lowring, xy=list(xy), shared_x=shared_x)

    def set_fft_engine(self, engine='auto', **engine_kwargs):
        """Select the FFT engine used by :meth:`__call__` (reference
        fftlog.py:119-133). Native engines are ``'auto'`` (``jnp.fft`` in
        complex128) and ``'pair'`` (float64 real-pair FFT, ops/fft.py, an
        FFT independent of ``jnp.fft``). The reference names ``'numpy'`` and
        ``'fftw'`` are accepted as aliases of ``'pair'`` and ``'auto'``."""
        engine = str(engine)
        engine = {'numpy': 'pair', 'fftw': 'auto'}.get(engine, engine)
        if engine not in ('auto', 'pair'):
            raise ValueError(f'unknown FFT engine {engine!r}; choose from auto/pair (or numpy/fftw aliases)')
        self.engine = engine
        self.engine_kwargs = dict(engine_kwargs)

    @property
    def nparallel(self):
        return self.x.shape[0]

    @property
    def size(self):
        return self.x.shape[-1]

    def _setup(self, xp, kernels, qs, minfolds=2, lowring=True, xy=1.0, shared_x=True):
        size = self.size
        self.delta = xp.log(self.x[:, -1] / self.x[:, 0]) / (size - 1)

        nfolds = (size * minfolds - 1).bit_length()
        self.padded_size = 2 ** nfolds
        npad = self.padded_size - size
        self.padded_size_in_left, self.padded_size_in_right = npad // 2, npad - npad // 2
        self.padded_size_out_left, self.padded_size_out_right = npad - npad // 2, npad // 2

        if lowring:
            self.lnxy = xp.array([delta / xp.pi * xp.angle(kern(q + 1j * xp.pi / delta))
                                  for kern, delta, q in zip(kernels, self.delta, qs)], dtype=xp.float64)
        else:
            self.lnxy = xp.log(xp.asarray(xy, dtype=xp.float64)) + self.delta

        self.y = xp.exp(self.lnxy - self.delta)[:, None] / self.x[:, ::-1]

        m = xp.arange(0, self.padded_size // 2 + 1)
        self.padded_x = _pad_xp(xp, self.x, (self.padded_size_in_left, self.padded_size_in_right))
        self.padded_y = _pad_xp(xp, self.y, (self.padded_size_out_left, self.padded_size_out_right))

        padded_u, padded_prefactor, padded_postfactor = [], [], []
        prev = (None, None, None, None)
        for kern, px, py, lnxy, delta, q in zip(kernels, self.padded_x, self.padded_y, self.lnxy, self.delta, qs):
            padded_prefactor.append(px ** (-q))
            padded_postfactor.append(py ** (-q))
            # Mellin coefficients can be reused across rows when the kernel,
            # tilt and x-grid spacing coincide (x broadcast from 1D).
            if shared_x and kern == prev[0] and q == prev[1]:
                u = prev[3]
            else:
                u = kern(q + 2j * xp.pi / self.padded_size / delta * m)
                prev = (kern, q, delta, u)
            padded_u.append(u * xp.exp(-2j * xp.pi * lnxy / self.padded_size / delta * m))
        self.padded_u = xp.stack(padded_u)
        self.padded_prefactor = xp.stack(padded_prefactor)
        self.padded_postfactor = xp.stack(padded_postfactor)

    def __call__(self, fun, extrap=0, keep_padding=False):
        """Transform ``fun`` whose last axes broadcast against
        (nparallel, size); returns (y, transformed)."""
        fun = jnp.asarray(fun)
        padded_fun = pad(fun, (self.padded_size_in_left, self.padded_size_in_right), axis=-1, extrap=extrap)
        prefactor = jnp.asarray(self.padded_prefactor)
        postfactor = jnp.asarray(self.padded_postfactor)
        u = np.asarray(self.padded_u) if not _is_traced(self.padded_u) else self.padded_u
        if self.engine == 'pair':
            if jnp.iscomplexobj(postfactor):
                raise NotImplementedError("complex postfactors (complex=True multipoles) need engine='auto'")
            u_re = jnp.asarray(np.real(u)) if isinstance(u, np.ndarray) else jnp.real(u)
            u_im = jnp.asarray(np.imag(u)) if isinstance(u, np.ndarray) else jnp.imag(u)
            sr, si = rfft_pair(padded_fun * prefactor)
            tr = sr * u_re - si * u_im
            ti = sr * u_im + si * u_re
            out = irfft_pair(tr, -ti, n=self.padded_size) * postfactor
        else:
            spectrum = jnp.fft.rfft(padded_fun * prefactor, axis=-1)
            out = jnp.fft.irfft((spectrum * jnp.asarray(u)).conj(), n=self.padded_size, axis=-1) * postfactor
        if not keep_padding:
            y = jnp.asarray(self.y)
            out = out[..., self.padded_size_out_left:self.padded_size_out_left + self.size]
        else:
            y = jnp.asarray(self.padded_y)
        if not self.inparallel:
            y = y[0]
            out = jnp.reshape(out, fun.shape if not keep_padding else fun.shape[:-1] + (self.padded_size,))
        return y, out

    def inv(self):
        """Swap the direction of the transform in place."""
        self.x, self.y = self.y, self.x
        self.padded_x, self.padded_y = self.padded_y, self.padded_x
        self.padded_prefactor, self.padded_postfactor = 1 / self.padded_postfactor, 1 / self.padded_prefactor
        self.padded_u = 1 / self.padded_u.conj()

    def tree_flatten(self):
        children = (self.x, self.y, self.delta, self.lnxy, self.padded_x, self.padded_y,
                    self.padded_u, self.padded_prefactor, self.padded_postfactor)
        aux = {name: getattr(self, name) for name in
               ['inparallel', 'engine', 'engine_kwargs', 'padded_size', 'padded_size_in_left',
                'padded_size_in_right', 'padded_size_out_left', 'padded_size_out_right']
               if hasattr(self, name)}
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        new.__dict__.update(aux)
        (new.x, new.y, new.delta, new.lnxy, new.padded_x, new.padded_y,
         new.padded_u, new.padded_prefactor, new.padded_postfactor) = children
        return new


def _pad_xp(xp, array, pad_width):
    """Log-extrapolating pad along the last axis, backend-generic (used in
    setup where the arrays may be host numpy)."""
    if xp is jnp:
        return pad(array, pad_width, axis=-1, extrap='log')
    wl, wr = pad_width
    end_l = array[..., :1]
    ratio_l = array[..., 1:2] / end_l
    left = end_l * ratio_l ** np.arange(-wl, 0)
    end_r = array[..., -1:]
    ratio_r = array[..., -2:-1] / end_r
    right = end_r / ratio_r ** np.arange(1, wr + 1)
    return np.concatenate([left, array, right], axis=-1)


@jax.tree_util.register_pytree_node_class
class HankelTransform(FFTlog):
    """Hankel transform (Bessel-J kernels)."""

    def __init__(self, x, nu=0, **kwargs):
        kernel = BesselJKernel(nu) if np.ndim(nu) == 0 else [BesselJKernel(n) for n in nu]
        FFTlog.__init__(self, x, kernel, **kwargs)
        self.padded_prefactor = self.padded_prefactor * self.padded_x ** 2


@jax.tree_util.register_pytree_node_class
class PowerToCorrelation(FFTlog):
    r"""P(k) -> xi_ell(s): :math:`\xi_\ell(s) = \frac{(-i)^\ell}{2\pi^2}
    \int dk\,k^2 P_\ell(k) j_\ell(ks)`."""

    def __init__(self, k, ell=0, q=0, complex=False, **kwargs):
        kernel = SphericalBesselJKernel(ell) if np.ndim(ell) == 0 else [SphericalBesselJKernel(l) for l in ell]
        FFTlog.__init__(self, k, kernel, q=1.5 + q, **kwargs)
        self.padded_prefactor = self.padded_prefactor * self.padded_x ** 3 / (2 * np.pi) ** 1.5
        ell = np.atleast_1d(ell)
        if complex:
            phase = (-1j) ** ell
        else:
            # real inputs: the imaginary part of odd multipoles is provided
            phase = (-1) ** (ell // 2)
        self.padded_postfactor = self.padded_postfactor * phase[:, None]


@jax.tree_util.register_pytree_node_class
class CorrelationToPower(FFTlog):
    r"""xi_ell(s) -> P_ell(k): :math:`P_\ell(k) = 4\pi i^\ell \int ds\,s^2
    \xi_\ell(s) j_\ell(ks)`."""

    def __init__(self, s, ell=0, q=0, complex=False, **kwargs):
        kernel = SphericalBesselJKernel(ell) if np.ndim(ell) == 0 else [SphericalBesselJKernel(l) for l in ell]
        FFTlog.__init__(self, s, kernel, q=1.5 + q, **kwargs)
        self.padded_prefactor = self.padded_prefactor * self.padded_x ** 3 * (2 * np.pi) ** 1.5
        ell = np.atleast_1d(ell)
        if complex:
            phase = (1j) ** ell
        else:
            phase = (-1) ** (ell // 2)
        self.padded_postfactor = self.padded_postfactor * phase[:, None]


@jax.tree_util.register_pytree_node_class
class TophatVariance(FFTlog):
    r"""P(k) -> sigma^2(r) with a 3D tophat window: the transform returns
    :math:`\frac{1}{2\pi^2}\int dk\,k^2 P(k) W^2(kr)`."""

    def __init__(self, k, q=0, **kwargs):
        kernel = TophatSqKernel(ndim=3)
        FFTlog.__init__(self, k, kernel, q=1.5 + q, **kwargs)
        self.padded_prefactor = self.padded_prefactor * self.padded_x ** 3 / (2 * np.pi ** 2)


@jax.tree_util.register_pytree_node_class
class GaussianVariance(FFTlog):
    """P(k) -> sigma^2(r) with a Gaussian window."""

    def __init__(self, k, q=0, **kwargs):
        kernel = GaussianSqKernel()
        FFTlog.__init__(self, k, kernel, q=1.5 + q, **kwargs)
        self.padded_prefactor = self.padded_prefactor * self.padded_x ** 3 / (2 * np.pi ** 2)

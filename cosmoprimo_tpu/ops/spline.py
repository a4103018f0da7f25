"""Vmappable, differentiable cubic splines built on parallel scans.

This replaces the reference's dependency on ``interpax`` / scipy splines
(cosmoprimo/jax.py:85-287) with a JAX-native implementation:

- the tridiagonal system of a natural cubic spline is solved with
  ``jax.lax.associative_scan`` (O(log n) depth instead of a serial Thomas
  sweep — the XLA-friendly formulation; the Mobius/linear-recurrence scans
  below are the standard projective trick);
- evaluation is a vectorized searchsorted + cubic polynomial, batched over
  arbitrary trailing axes, and differentiable w.r.t. both the query points
  and the knot values.

Semantics follow scipy.interpolate.CubicSpline(bc_type='natural'), which is
what the reference uses on its CPU path (cosmoprimo/jax.py:169-175), so
differential tests against scipy hold to float64 round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np


def _mobius_combine(A, B):
    """Combine for cumulative 2x2 matrix products, normalized projectively to
    avoid overflow over long chains (only ratios of the result are used)."""
    C = jnp.einsum('...ij,...jk->...ik', B, A)
    norm = jnp.max(jnp.abs(C), axis=(-2, -1), keepdims=True)
    return C / jnp.where(norm == 0, 1.0, norm)


def _linear_combine(p, q):
    """Combine for the linear recurrence y_i = a_i y_{i-1} + b_i."""
    a1, b1 = p
    a2, b2 = q
    return a2 * a1, a2 * b1 + b2


def _linear_recurrence(a, b):
    """Solve y_i = a_i * y_{i-1} + b_i with y_{-1} = 0, via associative scan.

    ``a`` has shape (n,) + broadcastable; ``b`` (n, ...).
    """
    a = jnp.broadcast_to(a.reshape(a.shape + (1,) * (b.ndim - a.ndim)), b.shape)
    ya, yb = jax.lax.associative_scan(_linear_combine, (a, b), axis=0)
    return yb


def tridiagonal_solve(dl, d, du, b):
    """Solve a tridiagonal system T y = b with sub/main/super diagonals
    ``dl`` (dl[0] unused), ``d``, ``du`` (du[-1] unused), each shape (n,);
    ``b`` of shape (n, ...) (trailing batch axes share the matrix).

    Fully parallel (associative scans), differentiable in all inputs.
    """
    n = d.shape[0]
    # Forward elimination: w_i = du_i / (d_i - dl_i w_{i-1}) via the Mobius
    # recurrence w_i = (0*w + du_i) / (-dl_i*w + d_i), w_{-1} = 0.
    M = jnp.stack([
        jnp.stack([jnp.zeros_like(d), du], axis=-1),
        jnp.stack([-dl, d], axis=-1),
    ], axis=-2)  # (n, 2, 2)
    P = jax.lax.associative_scan(_mobius_combine, M, axis=0)  # cumulative products
    # (p, q) = P @ (0, 1): w_i = p_i / q_i
    p = P[:, 0, 1]
    q = P[:, 1, 1]
    w = p / q
    denom = d - dl * jnp.concatenate([jnp.zeros((1,), d.dtype), w[:-1]])
    # g_i = (b_i - dl_i g_{i-1}) / denom_i : linear recurrence
    g = _linear_recurrence(-dl / denom, b / denom.reshape((n,) + (1,) * (b.ndim - 1)))
    # Back substitution: y_i = g_i - w_i y_{i+1} (reverse linear recurrence)
    ar = (-w)[::-1]
    br = g[::-1]
    y = _linear_recurrence(ar, br)[::-1]
    return y


def natural_cubic_coeffs(x, f):
    """Second derivatives M at the knots of the natural cubic spline through
    (x, f). ``x``: (n,) strictly increasing; ``f``: (n, ...).

    Returns ``M`` of shape ``f.shape`` with M[0] = M[-1] = 0.
    """
    n = x.shape[0]
    h = jnp.diff(x)  # (n-1,)
    df = jnp.diff(f, axis=0) / h.reshape((n - 1,) + (1,) * (f.ndim - 1))
    # Interior system for M[1:-1]:
    # h[i-1]/6 M[i-1] + (h[i-1]+h[i])/3 M[i] + h[i]/6 M[i+1] = df[i] - df[i-1]
    dl = h[:-1] / 6.0
    d = (h[:-1] + h[1:]) / 3.0
    du = h[1:] / 6.0
    rhs = df[1:] - df[:-1]
    if n == 2:
        return jnp.zeros_like(f)
    if n == 3:
        Mi = rhs / d.reshape((1,) + (1,) * (f.ndim - 1))
    else:
        Mi = tridiagonal_solve(jnp.concatenate([jnp.zeros((1,), x.dtype), dl[1:]]),
                               d,
                               jnp.concatenate([du[:-1], jnp.zeros((1,), x.dtype)]),
                               rhs)
    zero = jnp.zeros((1,) + f.shape[1:], f.dtype)
    return jnp.concatenate([zero, Mi, zero], axis=0)


def cubic_eval(x, f, M, t, nu=0):
    """Evaluate the cubic spline defined by knots ``x`` (n,), values ``f``
    (n, ...) and second derivatives ``M`` at query points ``t`` (m,).

    ``nu`` = 0, 1 or 2 for the spline or its derivatives (w.r.t. the spline
    coordinate). Out-of-range queries extrapolate with the edge polynomials
    (mask externally for NaN semantics). Returns shape (m,) + f.shape[1:].
    """
    n = x.shape[0]
    i = jnp.clip(jnp.searchsorted(x, t, side='right') - 1, 0, n - 2)
    xi = x[i]
    xi1 = x[i + 1]
    h = xi1 - xi
    bshape = (-1,) + (1,) * (f.ndim - 1)
    h_ = h.reshape(bshape)
    dl = (t - xi).reshape(bshape)      # distance from left knot
    dr = (xi1 - t).reshape(bshape)     # distance from right knot
    fi, fi1 = f[i], f[i + 1]
    Mi, Mi1 = M[i], M[i + 1]
    if nu == 0:
        return (Mi * dr**3 / (6 * h_) + Mi1 * dl**3 / (6 * h_)
                + (fi / h_ - Mi * h_ / 6) * dr + (fi1 / h_ - Mi1 * h_ / 6) * dl)
    if nu == 1:
        return (-Mi * dr**2 / (2 * h_) + Mi1 * dl**2 / (2 * h_)
                - (fi / h_ - Mi * h_ / 6) + (fi1 / h_ - Mi1 * h_ / 6))
    if nu == 2:
        return (Mi * dr + Mi1 * dl) / h_
    raise ValueError('nu must be 0, 1 or 2')


def linear_eval(x, f, t, nu=0):
    """Piecewise-linear interpolation with edge extrapolation; same shape
    conventions as :func:`cubic_eval`."""
    n = x.shape[0]
    i = jnp.clip(jnp.searchsorted(x, t, side='right') - 1, 0, n - 2)
    bshape = (-1,) + (1,) * (f.ndim - 1)
    h = (x[i + 1] - x[i]).reshape(bshape)
    w = (t - x[i]).reshape(bshape) / h
    if nu == 0:
        return f[i] * (1 - w) + f[i + 1] * w
    if nu == 1:
        return (f[i + 1] - f[i]) / h
    return jnp.zeros((t.shape[0],) + f.shape[1:], f.dtype)


@jax.tree_util.register_pytree_node_class
class Interpolator1D(object):
    """1D interpolator along axis 0, cubic (natural) by default.

    API-compatible with the reference's wrapper (cosmoprimo/jax.py:134-209):
    optional log10 transforms of x and/or f, NaN outside bounds unless
    ``extrap``, trailing value axes supported, pytree-registered so it can
    cross jit/vmap boundaries.
    """

    def __init__(self, x, fun, k=3, interp_x='lin', interp_fun='lin', extrap=False, assume_sorted=False):
        self.interp_x = str(interp_x)
        self.interp_fun = str(interp_fun)
        x = jnp.asarray(x, dtype=jnp.float64)
        fun = jnp.asarray(fun, dtype=jnp.float64)
        self.shape = fun.shape[1:]
        if not assume_sorted:
            ix = jnp.argsort(x)
            x, fun = x[ix], fun[ix]
        self.xmin, self.xmax = x[0], x[-1]
        self._x, self._fun = x, fun
        if self.interp_x == 'log':
            x = jnp.log10(x)
        if self.interp_fun == 'log':
            fun = jnp.log10(fun)
        self.extrap = bool(extrap)
        self.k = int(k)
        fun = fun.reshape(x.shape[0], -1)
        self._kx = x
        self._kf = fun
        self._kM = natural_cubic_coeffs(x, fun) if self.k == 3 else None

    @property
    def x(self):
        return self._x

    @property
    def fun(self):
        return self._fun

    def __call__(self, x, dx=0, bounds_error=False):
        from .misc import bcast_dtype, exception
        dtype = bcast_dtype(x)
        x = jnp.asarray(x, dtype=jnp.float64)
        toret_shape = x.shape + self.shape
        x = x.ravel()
        mask = (x >= self.xmin) & (x <= self.xmax)
        if bounds_error:
            def raise_error(ok):
                if not ok:
                    raise ValueError('input outside of interpolation range')
            exception(raise_error, mask.all())
        tx = jnp.log10(x) if self.interp_x == 'log' else x
        if self.k == 3:
            tmp = cubic_eval(self._kx, self._kf, self._kM, tx, nu=dx)
        else:
            tmp = linear_eval(self._kx, self._kf, tx, nu=dx)
        if self.interp_fun == 'log':
            tmp = 10**tmp
        if not self.extrap:
            tmp = jnp.where(mask.reshape((-1,) + (1,) * (tmp.ndim - 1)), tmp, jnp.nan)
        return tmp.astype(dtype).reshape(toret_shape)

    def tree_flatten(self):
        children = (self._x, self._fun, self._kx, self._kf, self._kM, self.xmin, self.xmax)
        aux = {name: getattr(self, name) for name in ['interp_x', 'interp_fun', 'extrap', 'shape', 'k']}
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        new.__dict__.update(aux)
        new._x, new._fun, new._kx, new._kf, new._kM, new.xmin, new.xmax = children
        return new


def _cell_cubic(h, dl, dr, f0, f1, m0, m1):
    """Value of the cubic on one knot cell: width ``h``, distances from the
    left/right knot ``dl``/``dr``, endpoint values ``f0``/``f1`` and endpoint
    second derivatives ``m0``/``m1``. With m0 = m1 = 0 this reduces exactly to
    linear interpolation (the k=1 fallback)."""
    return (m0 * dr**3 / (6 * h) + m1 * dl**3 / (6 * h)
            + (f0 / h - m0 * h / 6) * dr + (f1 / h - m1 * h / 6) * dl)


@jax.tree_util.register_pytree_node_class
class Interpolator2D(object):
    """2D tensor-product cubic interpolator on a rectangular grid.

    ALL spline coefficients are precomputed at construction: ``My`` (second
    y-derivatives of the data), ``Mx`` (second x-derivatives), and the cross
    coefficients ``Mxy`` (x-spline of ``My``). The 1D natural-spline
    coefficient solve is a linear operator on its data axis, so solving along
    x commutes with evaluating along y — call time is therefore pure
    gather + polynomial, with no tridiagonal solve:

    - ``grid=True``: evaluate the y-splines of (F, Mx) at the y-queries, then
      the x-spline of the results at the x-queries — two batched
      ``cubic_eval`` passes producing the (nqx, nqy) grid;
    - ``grid=False``: direct per-pair bicubic evaluation — O(n) gathers of
      the 4 cell corners from each coefficient table (no full-grid +
      diagonal).

    Replaces the reference's interpax/RectBivariateSpline backend
    (cosmoprimo/jax.py:212-287).
    """

    def __init__(self, x, y, fun, kx=3, ky=3, interp_x='lin', interp_y='lin', interp_fun='lin',
                 extrap=False, assume_sorted=False):
        self.interp_x = str(interp_x)
        self.interp_y = str(interp_y)
        self.interp_fun = str(interp_fun)
        x = jnp.asarray(x, dtype=jnp.float64)
        y = jnp.asarray(y, dtype=jnp.float64)
        fun = jnp.asarray(fun, dtype=jnp.float64)
        if not assume_sorted:
            ix, iy = jnp.argsort(x), jnp.argsort(y)
            x, y, fun = x[ix], y[iy], fun[jnp.ix_(ix, iy)]
        self.xmin, self.xmax = x[0], x[-1]
        self.ymin, self.ymax = y[0], y[-1]
        self._x, self._y, self._fun = x, y, fun
        if self.interp_x == 'log':
            x = jnp.log10(x)
        if self.interp_y == 'log':
            y = jnp.log10(y)
        if self.interp_fun == 'log':
            fun = jnp.log10(fun)
        self.extrap = bool(extrap)
        self.kx, self.ky = int(kx), int(ky)
        self._tx, self._ty, self._tf = x, y, fun
        # Tensor-product coefficient tables, all in (nx, ny) layout. A zero
        # table is the exact linear-interpolation fallback (k=1 / 2-pt grid).
        cubic_y = self.ky == 3 and y.shape[0] > 2
        cubic_x = self.kx == 3 and x.shape[0] > 2
        self._My = natural_cubic_coeffs(y, fun.T).T if cubic_y else jnp.zeros_like(fun)
        self._Mx = natural_cubic_coeffs(x, fun) if cubic_x else jnp.zeros_like(fun)
        self._Mxy = natural_cubic_coeffs(x, self._My) if (cubic_x and cubic_y) else jnp.zeros_like(fun)

    def _eval_pairs(self, tx, ty):
        """Direct bicubic evaluation at paired points -> (n,)."""
        nx, ny = self._tx.shape[0], self._ty.shape[0]
        ix = jnp.clip(jnp.searchsorted(self._tx, tx, side='right') - 1, 0, nx - 2)
        iy = jnp.clip(jnp.searchsorted(self._ty, ty, side='right') - 1, 0, ny - 2)
        hx = self._tx[ix + 1] - self._tx[ix]
        hy = self._ty[iy + 1] - self._ty[iy]
        dlx, drx = tx - self._tx[ix], self._tx[ix + 1] - tx
        dly, dry = ty - self._ty[iy], self._ty[iy + 1] - ty
        # y-direction cubic along the two x-knot rows bounding each query,
        # for the values (F, My) and for the x-second-derivatives (Mx, Mxy).
        def row(i):
            g = _cell_cubic(hy, dly, dry, self._tf[i, iy], self._tf[i, iy + 1],
                            self._My[i, iy], self._My[i, iy + 1])
            m = _cell_cubic(hy, dly, dry, self._Mx[i, iy], self._Mx[i, iy + 1],
                            self._Mxy[i, iy], self._Mxy[i, iy + 1])
            return g, m
        g0, m0 = row(ix)
        g1, m1 = row(ix + 1)
        return _cell_cubic(hx, dlx, drx, g0, g1, m0, m1)

    def _eval_grid(self, tx, ty):
        """Tensor-product evaluation on the query grid -> (nqx, nqy)."""
        gF = cubic_eval(self._ty, self._tf.T, self._My.T, ty)   # (nqy, nx)
        gM = cubic_eval(self._ty, self._Mx.T, self._Mxy.T, ty)  # (nqy, nx)
        return cubic_eval(self._tx, gF.T, gM.T, tx)             # (nqx, nqy)

    def __call__(self, x, y, grid=True, bounds_error=False):
        from .misc import bcast_dtype, exception
        dtype = bcast_dtype(x, y)
        x = jnp.asarray(x, dtype=jnp.float64)
        y = jnp.asarray(y, dtype=jnp.float64)
        toret_shape = (x.shape + y.shape) if grid else x.shape
        x, y = x.ravel(), y.ravel()
        mask_x = (x >= self.xmin) & (x <= self.xmax)
        mask_y = (y >= self.ymin) & (y <= self.ymax)
        mask = (mask_x[:, None] & mask_y) if grid else (mask_x & mask_y)
        if bounds_error:
            def raise_error(ok):
                if not ok:
                    raise ValueError('input outside of interpolation range')
            exception(raise_error, mask.all())
        tx = jnp.log10(x) if self.interp_x == 'log' else x
        ty = jnp.log10(y) if self.interp_y == 'log' else y
        tmp = self._eval_grid(tx, ty) if grid else self._eval_pairs(tx, ty)
        if self.interp_fun == 'log':
            tmp = 10**tmp
        if not self.extrap:
            tmp = jnp.where(mask, tmp, jnp.nan)
        return tmp.astype(dtype).reshape(toret_shape)

    def tree_flatten(self):
        children = (self._x, self._y, self._fun, self._tx, self._ty, self._tf,
                    self._Mx, self._My, self._Mxy,
                    self.xmin, self.xmax, self.ymin, self.ymax)
        aux = {name: getattr(self, name) for name in ['interp_x', 'interp_y', 'interp_fun', 'extrap', 'kx', 'ky']}
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        new.__dict__.update(aux)
        (new._x, new._y, new._fun, new._tx, new._ty, new._tf,
         new._Mx, new._My, new._Mxy,
         new.xmin, new.xmax, new.ymin, new.ymax) = children
        return new

"""General utilities: property helpers, serialization, constrained least
squares, distance-to-redshift inversion.

Re-implements the roles of the reference's utils.py (LeastSquareSolver at
utils.py:145-272, DistanceToRedshift at 276-316, JSON state helpers at
21-48) with JAX-native linear algebra.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np


def mkdir(dirname):
    if dirname:
        os.makedirs(dirname, exist_ok=True)


def addproperty(*attrs):
    """Class decorator adding read-only properties exposing ``self._<attr>``."""

    def decorator(cls):
        def make_prop(name):
            return property(lambda self: getattr(self, '_' + name))
        for attr in attrs:
            setattr(cls, attr, make_prop(attr))
        return cls

    return decorator


def _prepare_for_json(state):
    """Recursively convert arrays to JSON-serializable structures."""
    if isinstance(state, dict):
        return {key: _prepare_for_json(value) for key, value in state.items()}
    if isinstance(state, (list, tuple)):
        return [_prepare_for_json(value) for value in state]
    if isinstance(state, (np.ndarray, jnp.ndarray)):
        arr = np.asarray(state)
        return {'__array__': arr.tolist(), 'dtype': str(arr.dtype)}
    if isinstance(state, (np.generic,)):
        return state.item()
    return state


def _restore_from_json(state):
    if isinstance(state, dict):
        if '__array__' in state:
            return np.array(state['__array__'], dtype=state['dtype'])
        return {key: _restore_from_json(value) for key, value in state.items()}
    if isinstance(state, list):
        return [_restore_from_json(value) for value in state]
    return state


def write_state(filename, state):
    filename = str(filename)
    mkdir(os.path.dirname(filename))
    if filename.endswith('.json'):
        with open(filename, 'w') as f:
            json.dump(_prepare_for_json(state), f)
    else:
        np.save(filename, state, allow_pickle=True)


def read_state(filename):
    filename = str(filename)
    if filename.endswith('.json'):
        with open(filename, 'r') as f:
            return _restore_from_json(json.load(f))
    return np.load(filename, allow_pickle=True)[()]


@jax.tree_util.register_pytree_node_class
class LeastSquareSolver(object):
    r"""Linear least squares with optional linear equality constraints,
    solved through the bordered (KKT) system with ``jnp.linalg``:

    minimize :math:`(d - G x)^T P (d - G x)` subject to :math:`C x = c`.

    ``gradient`` G has shape (nbasis, ndata); ``precision`` P is a scalar,
    (ndata,) diagonal or full matrix; constraints C (nconstr, nbasis).
    """

    def __init__(self, gradient, precision=1.0, constraint_gradient=None, compute_inverse=True):
        gradient = jnp.asarray(gradient, dtype=jnp.float64)
        self.isscalar = gradient.ndim == 1
        self.gradient = jnp.atleast_2d(gradient)
        precision = jnp.asarray(precision, dtype=jnp.float64)
        self.precision = precision
        if precision.ndim <= 1:
            gp = self.gradient * precision  # broadcasting over data axis
        else:
            gp = self.gradient @ precision
        self._gp = gp
        fisher = gp @ self.gradient.T
        nbasis = self.gradient.shape[0]
        self.constraint_gradient = None
        if constraint_gradient is not None:
            # shape (nbasis, nconstraints), as in the reference (utils.py:179-182)
            self.constraint_gradient = jnp.atleast_2d(jnp.asarray(constraint_gradient, dtype=jnp.float64))
            ncon = self.constraint_gradient.shape[-1]
            # bordered (KKT) system [[F, -C], [C^T, 0]]
            bordered = jnp.zeros((nbasis + ncon, nbasis + ncon), dtype=jnp.float64)
            bordered = bordered.at[:nbasis, :nbasis].set(fisher)
            bordered = bordered.at[:nbasis, nbasis:].set(-self.constraint_gradient)
            bordered = bordered.at[nbasis:, :nbasis].set(self.constraint_gradient.T)
            self._system = bordered
        else:
            self._system = fisher
        self._inverse = jnp.linalg.inv(self._system)
        self._x = None
        self._d = None

    def __call__(self, delta, constraint=None):
        """Solve for coefficients given data ``delta`` (ndata,) or batched
        (..., ndata); optional ``constraint`` values c (..., nconstr)."""
        delta = jnp.asarray(delta, dtype=jnp.float64)
        rhs = delta @ self._gp.T  # (..., nbasis)
        nbasis = self.gradient.shape[0]
        if self.constraint_gradient is not None:
            ncon = self.constraint_gradient.shape[-1]
            if constraint is None:
                constraint = jnp.zeros(ncon, dtype=jnp.float64)
            constraint = jnp.broadcast_to(jnp.asarray(constraint, dtype=jnp.float64), rhs.shape[:-1] + (ncon,))
            rhs = jnp.concatenate([rhs, constraint], axis=-1)
        sol = rhs @ self._inverse.T
        self._x = sol[..., :nbasis]
        self._d = delta
        if self.isscalar:
            return self._x[..., 0]
        return self._x

    coefficients = property(lambda self: self._x)

    def model(self):
        """Best-fit model G^T x for the last solve."""
        return self._x @ self.gradient

    def chi2(self):
        resid = self._d - self.model()
        if self.precision.ndim <= 1:
            return jnp.sum(resid * self.precision * resid, axis=-1)
        return jnp.einsum('...i,ij,...j->...', resid, self.precision, resid)

    def tree_flatten(self):
        children = (self.gradient, self.precision, self._gp, self._system, self._inverse,
                    self.constraint_gradient, self._x, self._d)
        return children, {'isscalar': self.isscalar}

    @classmethod
    def tree_unflatten(cls, aux, children):
        new = cls.__new__(cls)
        new.isscalar = aux['isscalar']
        (new.gradient, new.precision, new._gp, new._system, new._inverse,
         new.constraint_gradient, new._x, new._d) = children
        return new


class DistanceToRedshift(object):
    """Invert a monotonic distance(z) relation via a spline on a geometric
    z-grid (reference: utils.py:276-316)."""

    def __init__(self, distance, zmax=100.0, nz=2048, interp_order=3):
        from .ops import Interpolator1D
        self.zgrid = jnp.concatenate([jnp.array([0.0]), jnp.geomspace(1e-8, zmax, nz - 1)])
        self.dgrid = distance(self.zgrid)
        self._interp = Interpolator1D(self.dgrid, self.zgrid, k=interp_order, assume_sorted=True)

    def __call__(self, distance):
        return self._interp(distance)


def setup_logging(level='info'):
    """Process-rank-aware logging setup (reference tools/utils.py:23-91 role)."""
    import logging
    import sys
    try:
        import jax
        rank = jax.process_index() if jax.process_count() > 1 else None
    except Exception:
        rank = None
    fmt = '[%(asctime)s] %(levelname)s %(name)s: %(message)s'
    if rank is not None:
        fmt = f'[rank {rank}] ' + fmt
    logging.basicConfig(level=getattr(logging, level.upper()), format=fmt,
                        datefmt='%m-%d %H:%M', stream=sys.stdout, force=True)


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def init_compilation_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and nothing is
    set here. Otherwise the cache goes to ``<repo>/.jax_cache``: a fixed
    path, because the path is part of the cache key."""
    path = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if path:
        return path
    path = os.path.join(_REPO_ROOT, '.jax_cache')
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 1.0)
    return path


def profile_trace(dirname='/tmp/jax-trace'):
    """Context manager writing a jax.profiler trace viewable in TensorBoard
    or Perfetto (aux observability; the reference has no tracer — SURVEY §5)."""
    import contextlib
    import jax

    @contextlib.contextmanager
    def ctx():
        jax.profiler.start_trace(dirname)
        try:
            yield dirname
        finally:
            jax.profiler.stop_trace()

    return ctx()


def savefig(filename, fig=None, bbox_inches='tight', pad_inches=0.1, dpi=200, **kwargs):
    """Save (and close) a matplotlib figure, creating directories as needed
    (reference utils.py:322-351)."""
    from matplotlib import pyplot as plt
    mkdir(os.path.dirname(str(filename)))
    if fig is None:
        fig = plt.gcf()
    fig.savefig(str(filename), bbox_inches=bbox_inches, pad_inches=pad_inches, dpi=dpi, **kwargs)
    plt.close(fig)
    return fig

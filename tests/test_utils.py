"""Utility tests: constrained least squares vs hand solutions (reference
parity: tests/test_utils.py:7-72), distance->redshift inversion, FFTlog
inversion, serialization helpers, compilation-cache location."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cosmoprimo_tpu.utils import DistanceToRedshift, LeastSquareSolver, read_state, write_state


def test_lsq_simple():
    # one-parameter model: best fit of constant to data = mean
    solver = LeastSquareSolver(np.ones(4))
    x = solver(2 * np.ones(4))
    assert abs(float(x) - 2.0) < 1e-12
    np.testing.assert_allclose(np.asarray(solver.model()), 2 * np.ones(4), rtol=1e-12)
    assert abs(float(solver.chi2())) < 1e-20


def test_lsq_weighted():
    # weighted linear regression vs numpy lstsq
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 20)
    gradient = np.stack([np.ones_like(t), t])
    y = 1.5 + 2.0 * t + 0.01 * rng.normal(size=t.size)
    w = rng.uniform(0.5, 2.0, t.size)
    solver = LeastSquareSolver(gradient, precision=w)
    x = np.asarray(solver(y))
    sw = np.sqrt(w)
    expected, *_ = np.linalg.lstsq((gradient * sw).T, y * sw, rcond=None)
    np.testing.assert_allclose(x, expected, rtol=1e-10)


def test_lsq_constrained():
    # fit a quadratic constrained to pass through f(0) = 0
    t = np.linspace(0, 1, 30)
    gradient = np.stack([np.ones_like(t), t, t ** 2])
    y = 0.5 + t + 2 * t ** 2
    constraint_gradient = np.array([[1.0], [0.0], [0.0]])  # (nbasis, ncon): coeff_0 = c
    solver = LeastSquareSolver(gradient, constraint_gradient=constraint_gradient)
    x = np.asarray(solver(y, constraint=np.array([0.0])))
    assert abs(x[0]) < 1e-10  # constraint honored
    # batched data
    Y = np.stack([y, 2 * y])
    X = np.asarray(solver(Y, constraint=np.zeros((2, 1))))
    assert X.shape == (2, 3)
    np.testing.assert_allclose(X[1], 2 * X[0], rtol=1e-10)


def test_lsq_traced():
    t = np.linspace(0, 1, 10)
    gradient = np.stack([np.ones_like(t), t])

    def fit(scale):
        solver = LeastSquareSolver(gradient)
        return solver(scale * (1 + 2 * t))[1]

    g = float(jax.grad(fit)(1.0))
    assert abs(g - 2.0) < 1e-10


def test_distance_to_redshift():
    from cosmoprimo_tpu.cosmology import Cosmology
    cosmo = Cosmology(engine='eisenstein_hu')
    ba = cosmo.get_background()
    d2z = DistanceToRedshift(ba.comoving_radial_distance)
    z = np.array([0.2, 1.0, 3.0])
    d = np.asarray(ba.comoving_radial_distance(z))
    np.testing.assert_allclose(np.asarray(d2z(d)), z, rtol=1e-6)


def test_fftlog_inv():
    from cosmoprimo_tpu.fftlog import PowerToCorrelation
    k = np.geomspace(1e-4, 1e2, 512)
    pk = 1e4 * (k / 0.1) ** 0.96 / (1 + (k / 0.1) ** 3)
    p2c = PowerToCorrelation(k)
    s, xi = p2c(pk)
    p2c.inv()
    k2, pk2 = p2c(np.asarray(xi))
    np.testing.assert_allclose(np.asarray(k2), k, rtol=1e-10)
    mask = (k > 1e-2) & (k < 10)
    np.testing.assert_allclose(np.asarray(pk2)[mask], pk[mask], rtol=2e-3)


def test_state_io(tmp_path):
    state = {'a': np.arange(3.0), 'b': {'c': 1.5, 'd': [1, 2]}, 'e': 'text'}
    for fn in ['state.json', 'state.npy']:
        path = str(tmp_path / fn)
        write_state(path, state)
        loaded = read_state(path)
        np.testing.assert_allclose(np.asarray(loaded['a']), state['a'])
        assert loaded['e'] == 'text'


@pytest.mark.parametrize('env_dir', [True, False])
def test_init_compilation_cache(tmp_path, monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is used and nothing is set in
    code; otherwise the cache goes to <repo>/.jax_cache."""
    from cosmoprimo_tpu import utils
    before = (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setattr(jax.config, 'update', lambda name, value: updates.append((name, value)))
    updates = []
    if env_dir:
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
        assert utils.init_compilation_cache() == str(tmp_path)
        assert updates == []
    else:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        expected = os.path.join(repo, '.jax_cache')
        assert utils.init_compilation_cache() == expected
        assert ('jax_compilation_cache_dir', expected) in updates
    assert (jax.config.jax_compilation_cache_dir, jax.config.jax_persistent_cache_min_compile_time_secs) == before

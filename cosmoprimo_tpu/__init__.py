"""cosmoprimo_tpu — a JAX/XLA primordial-cosmology framework.

Re-designed from scratch for accelerator execution with the capabilities of the
cosmoprimo reference library: a :class:`Cosmology` parameter front-end with
pluggable engines exposing uniform physics sections (Background,
Thermodynamics, Primordial, Transfer, Harmonic, Fourier), FFTLog transforms,
power-spectrum interpolators, BAO filters, fiducial cosmologies and an
emulator toolkit. Everything is traced JAX: jit/vmap/jacfwd work end-to-end,
and batched evaluation over many cosmologies maps onto the accelerator natively.
"""

# Imported as _jax: the plain name would shadow the lazy `cosmoprimo_tpu.jax`
# compat submodule (reference cosmoprimo.jax surface) in `from ... import jax`.
import jax as _jax

# Double precision everywhere, as the reference does at import
# (cosmoprimo/jax.py:14-16). Cosmological invariants (e.g. rs_drag to 1e-7)
# require f64 accumulation; compute-heavy inner kernels downcast explicitly.
_jax.config.update('jax_enable_x64', True)

from . import constants

__version__ = '0.1.0'

# Lazy public API: modules are imported on first attribute access so the
# numerical substrate (ops/) can be used standalone with minimal import cost.
_API = {
    'Cosmology': 'cosmology', 'CosmologyError': 'cosmology', 'CosmologyInputError': 'cosmology',
    'CosmologyComputationError': 'cosmology', 'BaseEngine': 'cosmology', 'BaseSection': 'cosmology',
    'get_engine': 'cosmology',
    # module-level section getters, reference __init__.py:1 export set
    'Background': 'cosmology', 'Thermodynamics': 'cosmology', 'Primordial': 'cosmology',
    'Transfer': 'cosmology', 'Harmonic': 'cosmology', 'Fourier': 'cosmology',
    'PowerSpectrumInterpolator1D': 'interpolator', 'PowerSpectrumInterpolator2D': 'interpolator',
    'CorrelationFunctionInterpolator1D': 'interpolator', 'CorrelationFunctionInterpolator2D': 'interpolator',
    'PowerSpectrumBAOFilter': 'bao_filter', 'CorrelationFunctionBAOFilter': 'bao_filter',
    'DESI': 'fiducial', 'Planck2018FullFlatLCDM': 'fiducial', 'BOSS': 'fiducial',
    'AbacusSummit': 'fiducial', 'TabulatedDESI': 'fiducial', 'fiducial': 'fiducial',
    'FFTlog': 'fftlog', 'PowerToCorrelation': 'fftlog', 'CorrelationToPower': 'fftlog',
    'TophatVariance': 'fftlog', 'GaussianVariance': 'fftlog', 'HankelTransform': 'fftlog',
    'halofit': 'models.halofit', 'halofit_pk_interpolator': 'models.halofit',
    'jax': 'jax',  # compat surface mirroring the reference's cosmoprimo.jax
}


def __getattr__(name):
    import importlib
    if name in _API:
        module = importlib.import_module('.' + _API[name], __name__)
        if name == _API[name]:
            return module
        return getattr(module, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')

"""Reference public-API surface parity: deprecated aliases, shallow copies,
FFT-engine switching, section ``engine`` property, emulator-namespace
re-exports (reference cosmology.py:849-852/1419-1440, utils.py:55-64,
fftlog.py:119-133, emulators/__init__.py:99-112, fiducial.py:285-291)."""

import numpy as np
import pytest

from cosmoprimo_tpu import Cosmology, fiducial
from cosmoprimo_tpu.fftlog import PowerToCorrelation
from cosmoprimo_tpu.interpolator import PowerSpectrumInterpolator1D


@pytest.fixture(scope='module')
def cosmo():
    return Cosmology(engine='eisenstein_hu')


def test_cosmology_deprecated_aliases(tmp_path, cosmo):
    fn = str(tmp_path / 'cosmo.npy')
    with pytest.warns(DeprecationWarning):
        cosmo.save(fn)
    with pytest.warns(DeprecationWarning):
        cosmo2 = Cosmology.load(fn)
    assert cosmo2 == cosmo
    with pytest.warns(DeprecationWarning):
        params = Cosmology.get_default_parameters()
    assert params == Cosmology.get_default_params()


def test_cosmology_copy(cosmo):
    clone = cosmo.copy()
    assert clone == cosmo and clone is not cosmo
    assert clone.engine is cosmo.engine  # shallow


def test_section_engine_property(cosmo):
    ba = cosmo.get_background()
    assert ba.engine is cosmo.engine
    fo = cosmo.get_fourier()
    assert fo.engine is cosmo.engine


def test_interpolator_copy(cosmo):
    pk = cosmo.get_fourier().pk_interpolator().to_1d(z=0)
    pk2 = pk.copy()
    k = np.logspace(-2, 0, 10)
    assert np.allclose(np.asarray(pk2(k)), np.asarray(pk(k)), rtol=0, atol=0)


def test_set_fft_engine():
    k = np.logspace(-4, 2, 256)
    fft = PowerToCorrelation(k, engine='pair')
    assert fft.engine == 'pair'
    fft.set_fft_engine('numpy')  # reference alias
    assert fft.engine == 'pair'
    fft.set_fft_engine('fftw')  # reference alias of the fastest native path
    assert fft.engine == 'auto'
    with pytest.raises(ValueError):
        fft.set_fft_engine('pallas')
    with pytest.raises(ValueError):
        fft.set_fft_engine('cufft')


def test_emulators_namespace_reexports():
    from cosmoprimo_tpu import emulators
    assert emulators.Cosmology is Cosmology
    assert callable(emulators.setup_logging)
    assert emulators.comb(5, 2) == 10
    mask = emulators.mask_subsample(100, factor=0.25)
    assert mask.dtype == np.bool_ and mask.sum() == 25
    mask = emulators.mask_subsample(100, factor=10)
    assert mask.sum() == 10


def test_emulators_tools_namespace():
    # reference emulators/tools/__init__.py surface, importable as a module
    from cosmoprimo_tpu.emulators import tools
    for name in ['Emulator', 'PointEmulatorEngine', 'EmulatedCalculator', 'Operation',
                 'ScaleOperation', 'NormOperation', 'Log10Operation', 'ArcsinhOperation',
                 'PCAOperation', 'ChebyshevOperation', 'TaylorEmulatorEngine',
                 'MLPEmulatorEngine', 'Samples', 'InputSampler', 'GridSampler',
                 'DiffSampler', 'QMCSampler', 'CalculatorComputationError', 'setup_logging']:
        assert hasattr(tools, name), name


def test_save_tabulated_desi(tmp_path, monkeypatch):
    target = str(tmp_path / 'desi.dat')
    monkeypatch.setattr(fiducial, '_DESI_filename', target)
    fiducial.save_TabulatedDESI()
    table = np.loadtxt(target)
    assert table.shape == (40002, 3)
    assert table[0, 0] == 0 and np.isclose(table[-1, 0], 100.0)
    # column 1 is efunc: E(0) == 1
    assert np.isclose(table[0, 1], 1.0, rtol=1e-10)
    # column 2 is the comoving distance, monotonically increasing
    assert np.all(np.diff(table[:, 2]) >= 0)

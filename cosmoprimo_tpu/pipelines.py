"""Batched end-to-end pipelines (the BASELINE workloads).

These are the flagship compute paths: vmap over many cosmologies of the
analytic-engine P(k) -> FFTLog xi(s) transform and background distances,
with Fisher derivatives one jacfwd away. Each function is a pure jnp
function over parameter arrays, so it jits once and shards over a device
mesh along the batch axis.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .cosmology import Cosmology
from .fftlog import PowerToCorrelation



def apply_non_linear(non_linear, cosmo, ba, k, pkz, z, omega_b, h, n_s, logT_AGN=7.8):
    """Shared non-linear dispatch for the pipeline factories: push the
    linear P(k, z) table through the native halofit or HMcode-2020
    transform (models/halofit.py, models/hmcode.py).
    ``non_linear='mead2020_feedback'`` selects the baryonic T_AGN response
    at ``logT_AGN`` (published central value 7.8)."""
    if not non_linear:
        return pkz
    zz = jnp.atleast_1d(z)
    if non_linear in ('halofit', 'takahashi', True):
        from .models.halofit import halofit
        return halofit(k, pkz, ba.Omega_m(zz), ba.Omega_de(zz),
                       cosmo['w0_fld'] + cosmo['wa_fld'] * zz / (1.0 + zz),
                       fnu=cosmo['Omega_ncdm_tot'] / cosmo['Omega_m'],
                       Omega_m0=cosmo['Omega_m'])
    if non_linear in ('mead', 'hmcode', 'mead2020', 'hmcode2020', 'mead2020_feedback'):
        from . import constants
        from .models.hmcode import hmcode2020
        a_grid = jnp.asarray(np.geomspace(1e-3, 1.0, 128))
        return hmcode2020(k, pkz, pkz, ba.Omega_m(zz),
                          fnu=cosmo['Omega_ncdm_tot'] / cosmo['Omega_m'],
                          omega_m=cosmo['Omega_m'] * h ** 2, omega_b=omega_b,
                          h=h, theta_cmb=constants.TCMB / 2.7, ns=n_s,
                          growth_a=a_grid, growth_g=ba.growth_factor(1.0 / a_grid - 1.0),
                          growth_z=ba.growth_factor(zz), z=zz,
                          logT_AGN=logT_AGN if non_linear == 'mead2020_feedback' else None,
                          Omega_k0=cosmo['Omega_k'],
                          w0=cosmo['w0_fld'], wa=cosmo['wa_fld'])
    raise ValueError(f'unknown non_linear {non_linear!r}')


def make_pk_to_xi_pipeline(nk=1024, kmin=1e-5, kmax=1e2, engine='eisenstein_hu', z=jnp.array([0.0]),
                           fft_engine='auto', non_linear=False):
    """Build (fn, k, s): ``fn(omega_cdm, omega_b, h, n_s, logA)`` returns
    (xi(s, z), chi(zq), sigma8) for one cosmology; the FFTLog setup (static
    grids, Mellin coefficients) is computed once and closed over.

    ``non_linear='halofit'`` inserts the native halofit transform between
    the linear P(k, z) table and the FFTLog (one extra (nR, nk)x(nk, nz)
    matmul per cosmology), yielding non-linear xi(s, z) at batch scale.

    vmap ``fn`` for the batched BASELINE workload.
    """
    # host-built grid: exact endpoints (an on-device geomspace can land
    # one ULP outside the interpolator bounds -> NaN)
    k_np = np.geomspace(kmin, kmax, nk)
    k = jnp.asarray(k_np)
    p2c = PowerToCorrelation(k_np, engine=fft_engine)
    zq = jnp.array([0.5, 1.0, 2.0])
    # sigma8 as a static-weight Simpson reduction over the SAME k-grid the
    # transform uses: w_i = k^3 W^2(8k) (log-measure); everything static,
    # so sigma8 costs one weighted sum per cosmology.
    from .interpolator import kernel_tophat2
    from .ops import simpson
    _w8 = jnp.asarray(k_np ** 3 * np.asarray(kernel_tophat2(jnp.asarray(8.0 * k_np))))
    _lnk = jnp.asarray(np.log(k_np))
    _iz0 = int(np.argmin(np.abs(np.asarray(z))))
    _z0_in_grid = float(np.asarray(z).ravel()[_iz0]) == 0.0

    def fn(omega_cdm, omega_b, h, n_s, logA):
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, engine=engine)
        fo = cosmo.get_fourier()
        pk = fo.pk_interpolator()
        pkz = pk(k, z, ignore_growth=False)                  # (nk, nz)
        ba = cosmo.get_background()
        # sigma8 is defined on the LINEAR spectrum: reuse the z = 0 column
        # before any non-linear transform
        pk0 = pkz[:, _iz0] if _z0_in_grid else pk(k, jnp.array([0.0]))[:, 0]
        pkz = apply_non_linear(non_linear, cosmo, ba, k, pkz, z, omega_b, h, n_s)
        s, xi = p2c(pkz.T)                                   # (nz, nk)
        chi = ba.comoving_radial_distance(zq)
        sigma8 = jnp.sqrt(simpson(pk0 * _w8, x=_lnk) / (2.0 * jnp.pi ** 2))
        return xi, chi, sigma8

    return fn, np.asarray(k), np.asarray(p2c.y[0])


def make_distance_pipeline(engine='eisenstein_hu', zq=None):
    """fn(omega_cdm, omega_b, h) -> comoving radial distances at zq."""
    if zq is None:
        zq = jnp.linspace(0.05, 3.0, 60)
    zq = jnp.asarray(zq)

    def fn(omega_cdm, omega_b, h):
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, engine=engine)
        return cosmo.get_background().comoving_radial_distance(zq)

    return fn, np.asarray(zq)


def make_pk_to_xi_pipeline_batched(nk=1024, kmin=1e-5, kmax=1e2, engine='eisenstein_hu',
                                   z=jnp.array([0.0]), fft_engine='auto', non_linear=False):
    """Batched variant: ``fn(omega_cdm[B], omega_b[B], h[B], n_s[B],
    logA[B])`` evaluates P(k) (optionally pushed through the halofit or
    HMcode non-linear transform) per cosmology under vmap, then runs ONE
    batched FFTLog over all (B, nz) rows.
    """
    k_np = np.geomspace(kmin, kmax, nk)
    k = jnp.asarray(k_np)
    p2c = PowerToCorrelation(k_np, engine=fft_engine)
    zq = jnp.array([0.5, 1.0, 2.0])
    # sigma8 via static-weight Simpson on the SAME k-grid the transform
    # uses (exactly as make_pk_to_xi_pipeline): sigma8_z's generic path
    # re-evaluates the spline on its own 1024-point grid with gather-heavy
    # evals; the static-weight reduction is one fused multiply-sum
    from .interpolator import kernel_tophat2
    from .ops import simpson
    _w8 = jnp.asarray(k_np ** 3 * np.asarray(kernel_tophat2(jnp.asarray(8.0 * k_np))))
    _lnk = jnp.asarray(np.log(k_np))
    _iz0 = int(np.argmin(np.abs(np.asarray(z))))
    _z0_in_grid = float(np.asarray(z).ravel()[_iz0]) == 0.0

    def single(omega_cdm, omega_b, h, n_s, logA):
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, engine=engine)
        fo = cosmo.get_fourier()
        pk = fo.pk_interpolator()
        pkz = pk(k, z, ignore_growth=False)          # (nk, nz)
        ba = cosmo.get_background()
        # sigma8 is defined on the LINEAR spectrum: reuse the z = 0 column
        pk0 = pkz[:, _iz0] if _z0_in_grid else pk(k, jnp.array([0.0]))[:, 0]
        sigma8 = jnp.sqrt(simpson(pk0 * _w8, x=_lnk) / (2.0 * jnp.pi ** 2))
        pkz = apply_non_linear(non_linear, cosmo, ba, k, pkz, z, omega_b, h, n_s)
        chi = ba.comoving_radial_distance(zq)
        return pkz, chi, sigma8

    def fn(omega_cdm, omega_b, h, n_s, logA):
        pkz, chi, sigma8 = jax.vmap(single)(omega_cdm, omega_b, h, n_s, logA)
        s, xi = p2c(jnp.moveaxis(pkz, 1, 2))         # (B, nz, nk) batched FFT
        return xi, chi, sigma8

    return fn, np.asarray(k), np.asarray(p2c.y[0])


def make_native_pk_pipeline_batched(nk=256, kmax=1.0, z=(0.0, 1.0)):
    """Batched END-TO-END native Boltzmann pipeline: ``fn(omega_cdm[B],
    omega_b[B], h[B], n_s[B], logA[B])`` runs, per cosmology under vmap,
    the full native chain — RECFAST recombination (lax.scan), the MB95
    Einstein-Boltzmann hierarchy on ``nk`` k-modes (rk4-on-scan with
    lanes on k), and the primordial assembly — returning (pk_m(z, k)
    [(Mpc/h)^3], sigma8).

    This is the capability the reference obtains only from an external
    CLASS/CAMB C build, run per-cosmology on CPU
    (/root/reference/cosmoprimo/classy.py); here it is one jitted XLA
    program that vmaps/shards over the cosmology batch.
    """
    from .boltzmann.perturbations import linear_pk, steps_for_kmax
    from .interpolator import kernel_tophat2
    from .ops import simpson

    n_steps = steps_for_kmax(kmax)  # kmax in h/Mpc bounds kmax in 1/Mpc
    k_np = np.geomspace(1e-4, kmax, nk)
    k = jnp.asarray(k_np)
    z = list(np.atleast_1d(np.asarray(z, dtype=np.float64)))
    _w8 = jnp.asarray(k_np ** 3 * np.asarray(kernel_tophat2(jnp.asarray(8.0 * k_np))))
    _lnk = jnp.asarray(np.log(k_np))
    _iz0 = int(np.argmin(np.abs(np.asarray(z))))

    def single(omega_cdm, omega_b, h, n_s, logA):
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s,
                          logA=logA, engine='native')
        th = cosmo.get_thermodynamics().table
        out = linear_pk(cosmo.engine._perturbation_params(), th, k, z,
                        n_steps=n_steps)
        pkz = out['pk_m']                                  # (nz, nk)
        sigma8 = jnp.sqrt(simpson(pkz[_iz0] * _w8, x=_lnk) / (2.0 * jnp.pi ** 2))
        return pkz, sigma8

    def fn(omega_cdm, omega_b, h, n_s, logA):
        return jax.vmap(single)(omega_cdm, omega_b, h, n_s, logA)

    return fn, np.asarray(k)

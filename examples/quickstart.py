"""cosmoprimo_tpu quickstart — the executable counterpart of the reference
library's nb/examples.ipynb: every step below also jits, vmaps and
differentiates.

Run anywhere (defaults to CPU; ``--accelerator`` runs on the default
accelerator, e.g. a GPU):

    python examples/quickstart.py [--plot outdir] [--accelerator]

Covered: Cosmology construction/clone/solve, fiducials, engines & sections,
save/load, background distances, P(k) interpolators and sigma8, FFTLog
pk <-> xi, BAO filters, native non-linear spectra (halofit, HMcode-2020,
mead2020_feedback), and the batched + differentiable pipelines that are the
point of the design.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

# runnable straight from a checkout: python examples/quickstart.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--plot', default=None, metavar='OUTDIR',
                        help='write PNG figures to this directory (requires matplotlib)')
    parser.add_argument('--accelerator', action='store_true',
                        help='run on the default accelerator instead of forcing CPU')
    args = parser.parse_args(argv)

    import jax
    if not args.accelerator:
        jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp

    from cosmoprimo_tpu import (Cosmology, CorrelationFunctionBAOFilter, Fourier,
                                PowerSpectrumBAOFilter, PowerToCorrelation)
    from cosmoprimo_tpu import fiducial

    plot_dir = args.plot
    if plot_dir:
        os.makedirs(plot_dir, exist_ok=True)

    def figure(name, draw):
        if not plot_dir:
            return
        try:
            import matplotlib
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt
        except ImportError:
            return
        plt.figure()
        draw(plt)
        plt.savefig(os.path.join(plot_dir, name), dpi=110, bbox_inches='tight')
        plt.close()

    # ---- Cosmology: defaults, custom parameters, clone -------------------
    cosmo = Cosmology(engine='eisenstein_hu')
    cosmo_custom = Cosmology(omega_cdm=0.2, sigma8=0.7, engine='eisenstein_hu')
    print('h:', float(cosmo['h']), '| Omega_cdm (custom):', float(cosmo_custom['Omega_cdm']))
    cosmo_cloned = cosmo_custom.clone(sigma8=1.0)
    assert float(cosmo_cloned['sigma8']) == 1.0

    # ---- Fiducial cosmologies --------------------------------------------
    desi = fiducial.DESI(engine='eisenstein_hu')
    planck = fiducial.Planck2018FullFlatLCDM(engine='eisenstein_hu')
    abacus = fiducial.AbacusSummit(0, engine='eisenstein_hu')
    print('DESI h =', float(desi['h']), '| Planck2018 h =', float(planck['h']),
          '| AbacusSummit(0) == DESI:', float(abacus['h']) == float(desi['h']))

    # ---- Save / load ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        fn = os.path.join(tmp, 'cosmo.npy')
        desi.write(fn)
        desi2 = Cosmology.read(fn)
        assert float(desi2['omega_cdm']) == float(desi['omega_cdm'])

    # ---- Background -------------------------------------------------------
    ba = desi.get_background()
    z = np.linspace(0.0, 10.0, 501)[1:]
    chi = np.asarray(ba.comoving_radial_distance(z))
    print('chi(z=1) = %.2f Mpc/h | age = %.3f Gy' % (
        float(ba.comoving_radial_distance(np.array([1.0]))[0]), float(np.asarray(ba.age))))
    figure('background.png', lambda plt: (
        plt.plot(z, chi, label='radial'),
        plt.plot(z, np.asarray(ba.luminosity_distance(z)), label='luminosity'),
        plt.xlabel('$z$'), plt.ylabel('distance [Mpc/$h$]'), plt.legend()))

    # ---- Thermodynamics shortcut ------------------------------------------
    print('rs_drag = %.3f Mpc/h, z_drag = %.1f' % (
        float(np.asarray(desi.rs_drag)), float(np.asarray(desi.get_thermodynamics().z_drag))))

    # ---- Fourier: P(k) interpolators, engine comparison -------------------
    k = np.geomspace(1e-3, 1e2, 512)
    pk = desi.get_fourier().pk_interpolator()
    # NB: Section(cosmo, engine=...) switches the cosmology's engine (the
    # reference's semantics too) — compare approximations on clones
    pk_nw = Fourier(desi.clone(), engine='eisenstein_hu_nowiggle').pk_interpolator()
    pk_bbks = Fourier(desi.clone(), engine='bbks').pk_interpolator()
    print('P(k=0.1, z=0) =', float(np.asarray(pk(np.array([0.1]), 0.0))[0]), '(Mpc/h)^3')
    print('sigma8 =', float(np.asarray(pk.sigma8_z(0.0))))
    figure('pk_engines.png', lambda plt: (
        plt.loglog(k, np.asarray(pk(k, 0.0)), label='EH1998'),
        plt.loglog(k, np.asarray(pk_nw(k, 0.0)), label='EH1998 no wiggle'),
        plt.loglog(k, np.asarray(pk_bbks(k, 0.0)), label='BBKS'),
        plt.xlabel('$k$ [$h$/Mpc]'), plt.ylabel('$P(k)$'), plt.legend()))

    # ---- FFTLog: pk -> xi and the explicit transform ----------------------
    xi = pk.to_xi()
    s = np.geomspace(1e-2, 300.0, 500)
    pk1d = pk.to_1d(z=0.0)
    kk = np.geomspace(pk1d.extrap_kmin * 1.0001, pk1d.extrap_kmax * 0.9999, 1024)
    fftlog = PowerToCorrelation(kk, ell=0)
    s1d, xi1d = fftlog(pk1d(kk))
    print('xi(s=100, z=0) =', float(np.asarray(xi(np.array([100.0]), 0.0))[0]))
    figure('xi.png', lambda plt: (
        plt.plot(s, s ** 2 * np.asarray(xi(s, 0.0)), label='interpolator.to_xi'),
        plt.plot(np.asarray(s1d), np.asarray(s1d) ** 2 * np.asarray(xi1d), '--',
                 label='PowerToCorrelation'),
        plt.xlim(0, 200), plt.xlabel('$s$ [Mpc/$h$]'),
        plt.ylabel(r'$s^2 \xi(s)$'), plt.legend()))

    # ---- BAO filters ------------------------------------------------------
    pknow = PowerSpectrumBAOFilter(pk.to_1d(z=0.0), engine='wallish2018',
                                   cosmo=desi).smooth_pk_interpolator()
    xinow = CorrelationFunctionBAOFilter(xi.to_1d(z=0.0), engine='kirkby2013',
                                         cosmo=desi).smooth_xi_interpolator()
    print('wiggle amplitude at k=0.1:',
          float(np.asarray(pk1d(np.array([0.1])) / pknow(np.array([0.1])))[0]) - 1.0)
    figure('bao_filter.png', lambda plt: (
        plt.semilogx(k, np.asarray(pk1d(k)) / np.asarray(pknow(k))),
        plt.xlabel('$k$ [$h$/Mpc]'), plt.ylabel('$P / P_{\\rm now}$')))
    assert np.isfinite(np.asarray(xinow(s))).all()

    # ---- Native non-linear spectra ----------------------------------------
    fo = desi.get_fourier()
    pk_hf = fo.pk_interpolator(non_linear='halofit')
    pk_hm = fo.pk_interpolator(non_linear='mead')
    pk_fb = fo.pk_interpolator(non_linear='mead2020_feedback')
    k_nl = np.geomspace(1e-2, 20.0, 200)
    print('halofit boost at k=1:', float(np.asarray(pk_hf(np.array([1.0]), 0.0)
                                                    / pk(np.array([1.0]), 0.0))[0]))
    print('feedback suppression at k=3:',
          float(np.asarray(pk_fb(np.array([3.0]), 0.0) / pk_hm(np.array([3.0]), 0.0))[0]))
    figure('nonlinear.png', lambda plt: (
        plt.loglog(k_nl, np.asarray(pk(k_nl, 0.0)), label='linear'),
        plt.loglog(k_nl, np.asarray(pk_hf(k_nl, 0.0)), label='halofit (Takahashi)'),
        plt.loglog(k_nl, np.asarray(pk_hm(k_nl, 0.0)), label='HMcode-2020'),
        plt.loglog(k_nl, np.asarray(pk_fb(k_nl, 0.0)), '--',
                   label='HMcode-2020 + $T_{\\rm AGN}$'),
        plt.xlabel('$k$ [$h$/Mpc]'), plt.ylabel('$P(k)$'), plt.legend()))

    # ---- Solve: match an observable ---------------------------------------
    solved = desi.solve('h', 'theta_MC_100', 1.04092)
    print('solved h(theta_MC_100 = 1.04092) =', float(np.asarray(solved['h'])))
    assert abs(float(np.asarray(solved['theta_MC_100'])) - 1.04092) < 1e-6

    # ---- The point: jit + vmap + grad end to end ---------------------------
    from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched

    fn, kgrid, sgrid = make_pk_to_xi_pipeline_batched(nk=512)
    batched = jax.jit(fn)
    n = 64
    rng = np.random.default_rng(0)
    xi_b, chi_b, s8_b = batched(jnp.asarray(rng.uniform(0.11, 0.13, n)),
                                jnp.asarray(rng.uniform(0.021, 0.023, n)),
                                jnp.asarray(rng.uniform(0.65, 0.70, n)),
                                jnp.asarray(rng.uniform(0.94, 0.98, n)),
                                jnp.asarray(rng.uniform(2.9, 3.1, n)))
    print(f'batched pipeline: xi{tuple(xi_b.shape)}, sigma8 in '
          f'[{float(jnp.min(s8_b)):.3f}, {float(jnp.max(s8_b)):.3f}] over {n} cosmologies')

    zq = jnp.linspace(0.1, 2.0, 20)

    def distances(omega_cdm):
        c = Cosmology(omega_cdm=omega_cdm, omega_b=0.02237, h=0.6736, engine='eisenstein_hu')
        return c.get_background().comoving_radial_distance(zq)

    dchi = jax.jit(jax.jacfwd(distances))(0.12)
    print('d chi / d omega_cdm at z=2:', float(dchi[-1]), '(differentiable end to end)')

    # ---- The native Einstein-Boltzmann engine -----------------------------
    # No external C code: recombination, linear P(k), CMB spectra and
    # per-k perturbation tables, all on device (the reference needs a
    # CLASS/CAMB build for any of these). Small grids keep this quick.
    nat = fiducial.DESI(engine='native', kmax_pk=0.5, z_pk=(0.0, 1.0),
                        extra_params={'nk_pk': 32})
    print('native rs_drag [Mpc/h]:', float(nat.get_thermodynamics().rs_drag))
    pk_nat = nat.get_fourier().pk_interpolator()
    print('native P(k=0.1, z=0):', float(pk_nat(0.1, 0.0)), '(Mpc/h)^3')

    figure('native_pk.png', lambda plt: (
        plt.loglog(np.geomspace(1e-3, 0.5, 128),
                   np.asarray(pk_nat(np.geomspace(1e-3, 0.5, 128), 0.0))),
        plt.xlabel(r'$k$ [$h$/Mpc]'), plt.ylabel(r'$P(k)$ [(Mpc/$h$)$^3$]'),
        plt.title('native Einstein-Boltzmann linear $P(k)$')))
    print('quickstart: all sections ran.')


if __name__ == '__main__':
    main()

"""Train MLP emulators of the analytic-engine sections over a wide
parameter box (QMC sampling + per-section MLP fits + residual diagnostics).

Self-contained on-device version of the reference's train_classy.py: the
same pipeline trains against 'class'/'camb' by passing ``--engine class``
where pyclass/camb are installed; here the default target is the traced
eisenstein_hu engine so the script runs anywhere (and on multi-host setups
the QMC points are sharded across processes via parallel.distributed).

Usage:
    python -m cosmoprimo_tpu.emulators.train.train_analytic \
        --section background --niterations 2000 --output emulator.npy
"""

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--section', nargs='+', default=['background', 'thermodynamics', 'primordial'])
    parser.add_argument('--engine', default='eisenstein_hu')
    parser.add_argument('--emulator-engine', default='mlp', choices=['mlp', 'taylor', 'point'])
    parser.add_argument('--niterations', type=int, default=2000)
    parser.add_argument('--epochs', type=int, default=500)
    parser.add_argument('--output', default='emulator.npy')
    parser.add_argument('--samples', default=None, help='precomputed samples file (skip sampling)')
    parser.add_argument('--save-samples', default=None)
    parser.add_argument('--nparams', type=int, default=5, help='number of varied parameters (prefix of the box)')
    parser.add_argument('--accelerator', action='store_true', help='run sampling on the accelerator (default: CPU; '
                        'per-point eager evaluation is host-bound)')
    args = parser.parse_args(argv)

    import jax
    if not args.accelerator:
        jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)

    from cosmoprimo_tpu import Cosmology
    from cosmoprimo_tpu.emulators import (Emulator, MLPEmulatorEngine, PointEmulatorEngine, QMCSampler,
                                          Samples, TaylorEmulatorEngine, get_calculator)

    # wide box around Planck/DESI (reference train_classy.py parameter space)
    params = {'omega_cdm': (0.08, 0.20), 'omega_b': (0.019, 0.026), 'h': (0.5, 0.9),
              'logA': (2.5, 3.5), 'n_s': (0.88, 1.06)}
    params = dict(list(params.items())[:max(1, args.nparams)])

    cosmo = Cosmology(engine=args.engine)
    calculator = get_calculator(cosmo, section=args.section)

    if args.samples:
        samples = Samples.read(args.samples)
    else:
        sampler = QMCSampler(calculator, params, engine='rqrs', save_fn=args.save_samples)
        samples = sampler.run(niterations=args.niterations)

    engine = {'mlp': MLPEmulatorEngine(nhidden=(64, 64, 64)),
              'taylor': TaylorEmulatorEngine(order=3),
              'point': PointEmulatorEngine()}[args.emulator_engine]
    emulator = Emulator(engine=engine)
    emulator.set_samples(samples=samples)
    if args.emulator_engine == 'mlp':
        emulator.fit(epochs=args.epochs)
    else:
        emulator.fit()
    emulator.write(args.output)

    # quick residual report on fresh points
    rng = np.random.default_rng(7)
    worst = {}
    for _ in range(20):
        p = {name: rng.uniform(*box) for name, box in params.items()}
        truth = calculator(**p)
        pred = emulator.predict(p)
        for name in pred:
            if name in truth:
                t, q = np.asarray(truth[name]), np.asarray(pred[name])
                if t.size == 0:
                    continue
                scale = np.maximum(np.abs(t).max(), 1e-30)
                worst[name] = max(worst.get(name, 0.0), float(np.abs(q - t).max() / scale))
    print('max relative residuals over 20 test points:')
    for name, value in sorted(worst.items()):
        print(f'  {name}: {value:.3e}')
    print(f'emulator written to {args.output}')


if __name__ == '__main__':
    main()

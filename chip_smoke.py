"""Smoke test of the main paths on the GPU, each checked against the CPU.

Runs every user-facing path once, at the size ``bench.py`` runs it, on the
GPU, and compares it with the same call on the CPU backend of this process
(float64 on both sides):

    phase 0  device, JAX version, XLA flags, x64
    phase 1  library surface: distances, P(k, z), xi, sigma8 (eager and jit)
    phase 2  headline pk -> xi pipeline, nk 1024, batch 40000
    phase 3  halofit (nk 1024, batch 16384) and HMcode-2020 (nk 384, batch 256)
    phase 4  native Boltzmann P(k), nk 256, batch 8
    phase 5  native lensed CMB Cls at the default lmax 2500
    phase 6  jacfwd over five parameters, nk 512, vmapped over 64 cosmologies

Each phase prints one JSON line with its compile and run seconds and its
largest relative error against the CPU beside the bound it must meet. The
card's name and power limit follow, then the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase exits non-zero; so does a machine without a GPU.

    python chip_smoke.py              # one card
    python chip_smoke.py --four-gpus  # dp-sharded pipelines over four cards,
                                      # compared with the same batch on one

Everything runs in this one process: the card is opened once, and the
reference uses ``jax.devices('cpu')`` (phase 5's on a thread beside the
GPU calls).
"""

import argparse
import json
import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import jax
import jax.numpy as jnp

from cosmoprimo_tpu.utils import init_compilation_cache

# Bounds on the largest relative error against the CPU float64 reference.
BOUND_XI = 1e-10        # distances, sigma8, xi (normalised per row by max |xi|)
BOUND_NONLINEAR = 1e-9  # halofit, HMcode-2020
BOUND_JACOBIAN = 1e-8
# Native P(k), sigma8 and Cls. The native solver's fixed-step scans switch
# regime (tight coupling, streaming) at discrete steps, so last-bit
# differences between two compiled programs (FMA contraction, fusion,
# transcendental implementations) can move a switch by one step: the same
# cosmology run on the CPU in a batch of 1 and in a batch of 2 already
# differs by up to 5.7e-4 in P(k).
BOUND_NATIVE = 1e-3


def require_gpu():
    """The devices of the default backend, which must be a GPU."""
    backend = jax.default_backend()
    if backend != 'gpu':
        raise SystemExit(f'chip_smoke.py needs a GPU; JAX found {backend!r}')
    return jax.devices()


def make_args(n, seed=0):
    """``n`` cosmologies (omega_cdm, omega_b, h, n_s, logA), uniform in the
    box ``bench.py`` samples."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(lo, hi, n) for lo, hi in
                 ((0.11, 0.13), (0.021, 0.023), (0.65, 0.70), (0.94, 0.98), (2.9, 3.1)))


def max_rel_err(got, ref, axis=None):
    """Largest |got - ref| over the scale max |ref| taken along ``axis``
    (None: elementwise relative error)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = np.abs(ref) if axis is None else np.abs(ref).max(axis=axis, keepdims=True)
    return float((np.abs(got - ref) / np.where(scale > 0, scale, 1.0)).max())


def count_f32_dots(lowered):
    """float32 matrix products in a lowered program (they could run in TF32
    on the GPU; this path is meant to have none)."""
    return len(re.findall(r'dot_general[^\n]*xf32>', lowered.as_text()))


def _put(args, device):
    return tuple(jax.device_put(np.asarray(a), device) for a in args)


def _compile_and_run(fn, args):
    """(compile_s, run_s, out, f32_dots): lower and compile ``jit(fn)`` for
    ``args``, run once to warm, then time one run."""
    t0 = time.perf_counter()
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return compile_s, time.perf_counter() - t0, out, count_f32_dots(lowered)


def _on_cpu(fn, args, cpu):
    with jax.default_device(cpu):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*_put(args, cpu)))


def _result(phase, name, compile_s, run_s, errs, bound, **extra):
    """One phase's JSON record; ``errs`` are the errors of its outputs (a
    NaN among them fails the phase)."""
    err = float(np.max(errs))
    return dict(phase=phase, name=name, compile_s=compile_s, run_s=run_s, max_rel_err=err,
                bound=bound, ok=bool(err <= bound) and not extra.get('f32_dots', 0), **extra)


def phase_device(devices):
    """Phase 0: what runs where."""
    if not jax.config.jax_enable_x64:
        raise SystemExit('chip_smoke.py needs jax_enable_x64')
    return dict(phase=0, name='device', ok=True, platform=devices[0].platform,
                kind=devices[0].device_kind, count=len(devices), jax=jax.__version__,
                xla_flags=os.environ.get('XLA_FLAGS', ''), x64=True,
                compilation_cache=jax.config.jax_compilation_cache_dir,
                nvidia_smi=nvidia_smi_lines())


def nvidia_smi_lines():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def phase_surface(dut, cpu):
    """Phase 1: Cosmology(engine='eisenstein_hu') at the DESI fiducial,
    eagerly and under jit, against the eager CPU call."""
    from cosmoprimo_tpu.fiducial import DESI

    z = np.array([0.1, 0.5, 1.0, 2.0])
    k = np.array([1e-3, 1e-2, 0.1, 0.5])
    s = np.array([10.0, 50.0, 100.0, 150.0])

    def surface(h):
        cosmo = DESI(engine='eisenstein_hu', h=h)
        pk = cosmo.get_fourier().pk_interpolator()
        return (cosmo.comoving_radial_distance(z), pk(k, z), pk.to_xi()(s, z), pk.sigma8_z(0.0))

    h0 = float(DESI(engine='eisenstein_hu')['h'])
    with jax.default_device(cpu):
        ref = jax.tree_util.tree_map(np.asarray, surface(jnp.float64(h0)))
    with jax.default_device(dut):
        t0 = time.perf_counter()
        eager = jax.block_until_ready(surface(jax.device_put(h0, dut)))
        eager_s = time.perf_counter() - t0
        compile_s, run_s, jitted, f32_dots = _compile_and_run(surface, (jax.device_put(h0, dut),))

    def err(out):
        chi, pkkz, xi, s8 = (np.asarray(o) for o in out)
        return [max_rel_err(chi, ref[0]), max_rel_err(pkkz, ref[1]),
                max_rel_err(xi, ref[2], axis=0), max_rel_err(s8, ref[3])]

    return _result(1, 'library surface (eisenstein_hu, DESI fiducial)', compile_s, run_s,
                   err(eager) + err(jitted), BOUND_XI, eager_s=eager_s, f32_dots=f32_dots)


def phase_pk_to_xi(phase, name, dut, cpu, batch, nk, non_linear, n_compare, bound, seed):
    """Phases 2 and 3: make_pk_to_xi_pipeline_batched at ``batch``; the
    first ``n_compare`` rows against the CPU."""
    from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched

    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=nk, non_linear=non_linear)
    args = make_args(batch, seed=seed)
    compile_s, run_s, (xi, chi, s8), f32_dots = _compile_and_run(fn, _put(args, dut))
    xi_c, chi_c, s8_c = _on_cpu(fn, [a[:n_compare] for a in args], cpu)
    err = [max_rel_err(xi[:n_compare], xi_c, axis=-1), max_rel_err(chi[:n_compare], chi_c),
           max_rel_err(s8[:n_compare], s8_c)]
    return _result(phase, name, compile_s, run_s, err, bound,
                   batch=batch, nk=nk, n_compare=n_compare, f32_dots=f32_dots)


def phase_native_pk(dut, cpu, batch=8, nk=256, n_compare=2, seed=30):
    """Phase 4: make_native_pk_pipeline_batched; ``n_compare`` rows against
    the CPU."""
    from cosmoprimo_tpu.pipelines import make_native_pk_pipeline_batched

    fn, _ = make_native_pk_pipeline_batched(nk=nk)
    args = make_args(batch, seed=seed)
    compile_s, run_s, (pkz, s8), f32_dots = _compile_and_run(fn, _put(args, dut))
    pkz_c, s8_c = _on_cpu(fn, [a[:n_compare] for a in args], cpu)
    err = [max_rel_err(pkz[:n_compare], pkz_c), max_rel_err(s8[:n_compare], s8_c)]
    return _result(4, 'native Boltzmann P(k)', compile_s, run_s, err, BOUND_NATIVE,
                   batch=batch, nk=nk, n_compare=n_compare, f32_dots=f32_dots)


def phase_cmb(dut, cpu, ellmax=-1):
    """Phase 5: lensed Cls of Cosmology(engine='native') at the DESI
    fiducial through get_harmonic(), eagerly as a user calls it (the Cl
    path needs concrete parameters, so it is not jitted). ``compile_s`` is
    the first call less the second, which reuses the compiled operations.
    The CPU reference takes minutes and needs no GPU, so it runs on a
    thread meanwhile (its load can lengthen the GPU's first call)."""
    from cosmoprimo_tpu.fiducial import DESI

    def lensed(device):
        with jax.default_device(device):
            cl = DESI(engine='native').get_harmonic().lensed_cl(ellmax=ellmax)
            return {name: np.asarray(cl[name]) for name in ('tt', 'ee', 'bb', 'te')}

    with ThreadPoolExecutor(max_workers=1) as pool:
        ref = pool.submit(lensed, cpu)
        t0 = time.perf_counter()
        lensed(dut)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = lensed(dut)
        run_s = time.perf_counter() - t0
        ref = ref.result()
    err = [max_rel_err(got[name], ref[name], axis=-1) for name in ref]
    return _result(5, 'native lensed CMB Cls', first_s - run_s, run_s, err, BOUND_NATIVE,
                   lmax=int(got['tt'].size - 1))


def phase_jacobian(dut, cpu, batch=64, nk=512, n_compare=16, seed=40):
    """Phase 6: jacfwd over the five parameters of make_pk_to_xi_pipeline,
    vmapped over ``batch`` cosmologies; ``n_compare`` rows against the CPU.
    Each Jacobian block is normalised per cosmology by its max |value|."""
    from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline

    single, _, _ = make_pk_to_xi_pipeline(nk=nk)

    def jac(params):
        return jax.vmap(jax.jacfwd(lambda p: single(*p)))(params)

    params = np.stack(make_args(batch, seed=seed), axis=-1)
    compile_s, run_s, got, f32_dots = _compile_and_run(jac, _put([params], dut))
    ref = _on_cpu(jac, [params[:n_compare]], cpu)
    err = [max_rel_err(np.asarray(g[:n_compare]).reshape(n_compare, -1), r.reshape(n_compare, -1), axis=-1)
           for g, r in zip(got, ref)]
    return _result(6, 'jacfwd of pk->xi pipeline', compile_s, run_s, err, BOUND_JACOBIAN,
                   batch=batch, nk=nk, n_compare=n_compare, f32_dots=f32_dots)


def one_card_phases(dut, cpu, sizes=None):
    """Phases 1-6 on device ``dut``, each checked on ``cpu``. ``sizes``
    overrides the batch and grid sizes (small ones for a CPU rehearsal)."""
    sz = dict(head_batch=40000, halofit_batch=16384, hmcode_batch=256, nk_hmcode=384,
              nk=1024, n_compare=32, native_batch=8, nk_native=256, ellmax=-1,
              jac_batch=64, nk_jac=512, n_compare_jac=16)
    sz.update(sizes or {})
    n_cmp = sz['n_compare']
    yield phase_surface(dut, cpu)
    yield phase_pk_to_xi(2, 'headline pk->xi + distances + sigma8', dut, cpu, sz['head_batch'],
                         sz['nk'], False, n_cmp, BOUND_XI, seed=1)
    yield phase_pk_to_xi(3, 'halofit pk->xi', dut, cpu, sz['halofit_batch'], sz['nk'], 'halofit',
                         n_cmp, BOUND_NONLINEAR, seed=11)
    yield phase_pk_to_xi(3, 'HMcode-2020 pk->xi', dut, cpu, sz['hmcode_batch'], sz['nk_hmcode'], 'mead',
                         n_cmp, BOUND_NONLINEAR, seed=21)
    yield phase_native_pk(dut, cpu, batch=sz['native_batch'], nk=sz['nk_native'])
    yield phase_cmb(dut, cpu, ellmax=sz['ellmax'])
    yield phase_jacobian(dut, cpu, batch=sz['jac_batch'], nk=sz['nk_jac'], n_compare=sz['n_compare_jac'])


def phase_four_gpus(devices, native_batch=32, nk_native=256, head_batch=40000, nk=1024):
    """The native and headline pipelines with the batch sharded over a 1-D
    'dp' mesh of ``devices``, against the same batch on ``devices[0]``
    alone. Every output must be spread over all the devices."""
    from cosmoprimo_tpu.parallel import make_mesh, shard_array
    from cosmoprimo_tpu.pipelines import make_native_pk_pipeline_batched, make_pk_to_xi_pipeline_batched

    mesh = make_mesh(devices, axis_names=('dp',))
    native, _ = make_native_pk_pipeline_batched(nk=nk_native)
    headline, _, _ = make_pk_to_xi_pipeline_batched(nk=nk)
    for name, fn, batch, bound, seed in (('native Boltzmann P(k)', native, native_batch, BOUND_NATIVE, 50),
                                         ('headline pk->xi', headline, head_batch, BOUND_XI, 51)):
        args = make_args(batch, seed=seed)
        sharded = tuple(shard_array(a, mesh, axis='dp') for a in args)
        compile_s, run_s, out, f32_dots = _compile_and_run(fn, sharded)
        spread = all(leaf.sharding.device_set == set(devices) for leaf in jax.tree_util.tree_leaves(out))
        compile1_s, run1_s, out1, _ = _compile_and_run(fn, _put(args, devices[0]))
        err = [max_rel_err(o, o1, axis=-1 if o.ndim > 1 else None)
               for o, o1 in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(out1))]
        result = _result(7, f'{name}, dp over {len(devices)} cards vs one card', compile_s, run_s, err, bound,
                         batch=batch, f32_dots=f32_dots, sharded_over_all=spread,
                         one_card_compile_s=compile1_s, one_card_run_s=run1_s)
        result['ok'] = result['ok'] and spread
        yield result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--four-gpus', action='store_true',
                        help='run only the dp-sharded phase over four cards')
    args = parser.parse_args(argv)

    jax.config.update('jax_enable_x64', True)
    init_compilation_cache()
    devices = require_gpu()
    if args.four_gpus:
        if len(devices) < 4:
            raise SystemExit(f'--four-gpus needs four GPUs; JAX found {len(devices)}')
        devices = devices[:4]
    else:
        devices = devices[:1]

    info = phase_device(devices)
    print(json.dumps(info), flush=True)
    if args.four_gpus:
        phases = phase_four_gpus(devices)
    else:
        phases = one_card_phases(devices[0], jax.devices('cpu')[0])
    failed = []
    t_start = time.perf_counter()
    for result in phases:
        result['elapsed_s'] = time.perf_counter() - t_start
        print(json.dumps(result), flush=True)
        if not result['ok']:
            failed.append(result['name'])
    if failed:
        raise SystemExit(f'chip_smoke.py: failed phases: {failed}')
    for line in info['nvidia_smi']:
        print(line)
    print(json.dumps({'ok': True, 'device': {'platform': devices[0].platform,
                                             'kind': devices[0].device_kind,
                                             'count': len(devices)}}), flush=True)


if __name__ == '__main__':
    main()

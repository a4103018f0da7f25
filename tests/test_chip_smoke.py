"""chip_smoke.py on the CPU: its device check refuses the CPU, and its phase
functions run end to end at tiny sizes with the CPU standing in for the
GPU (a wiring check; the sizes and bounds that matter are those of the run
on the card)."""

import json

import jax
import numpy as np
import pytest

import chip_smoke

TINY = dict(head_batch=4, halofit_batch=4, hmcode_batch=2, nk_hmcode=64, nk=128, n_compare=2,
            native_batch=2, nk_native=8, ellmax=30, jac_batch=2, nk_jac=64, n_compare_jac=2)


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match='needs a GPU'):
        chip_smoke.require_gpu()


def test_max_rel_err_normalisation():
    ref = np.array([[1.0, -2.0, 0.0], [4.0, 0.5, 0.0]])
    got = ref + np.array([[1e-3, 0.0, 2e-3], [0.0, 0.0, 0.0]])
    assert chip_smoke.max_rel_err(got, ref, axis=-1) == pytest.approx(1e-3)
    assert chip_smoke.max_rel_err(got[:, :2], ref[:, :2]) == pytest.approx(1e-3)
    assert chip_smoke._result(0, 'nan', 0.0, 0.0, [1e-14, np.nan], 1e-3)['ok'] is False
    assert chip_smoke._result(0, 'fine', 0.0, 0.0, [1e-14, 2e-4], 1e-3)['ok'] is True


def test_one_card_phases_on_cpu():
    cpu = jax.devices('cpu')[0]
    results = list(chip_smoke.one_card_phases(cpu, cpu, sizes=TINY))
    assert [r['phase'] for r in results] == [1, 2, 3, 3, 4, 5, 6]
    for result in results:
        json.dumps(result)
        assert result['ok'], result
        assert result.get('f32_dots', 0) == 0
        assert result['max_rel_err'] <= result['bound']
    assert results[5]['lmax'] == TINY['ellmax']


def test_four_gpu_phase_on_cpu_devices():
    devices = jax.devices('cpu')[:4]
    results = list(chip_smoke.phase_four_gpus(devices, native_batch=4, nk_native=8, head_batch=8, nk=128))
    assert len(results) == 2
    for result in results:
        assert result['sharded_over_all'], result
        assert result['ok'], result

"""Mesh/sharding and process-parallel helpers on the virtual 8-device CPU
mesh (conftest sets xla_force_host_platform_device_count=8). Covers SURVEY
§2.11: batch sharding over 'dp', replication, seed helpers and the
block-distribution used by the sampling fan-out."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from cosmoprimo_tpu.parallel import (FakeComm, batch_sharding, bcast_seed, get_comm,
                                     make_mesh, replicate, set_common_seed,
                                     set_independent_seed, shard_array, split_ranks)


def test_make_mesh_factorization():
    mesh = make_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert tuple(mesh.axis_names) == ('dp', 'tp')
    # 8 devices -> dp=4, tp=2 (largest pow2 <= sqrt(8))
    if mesh.devices.size == 8:
        assert dict(mesh.shape) == {'dp': 4, 'tp': 2}
    mesh1 = make_mesh(axis_names=('dp',))
    assert dict(mesh1.shape) == {'dp': len(jax.devices())}


def test_shard_array_and_compute():
    mesh = make_mesh()
    ndp = dict(mesh.shape)['dp']
    x = np.arange(ndp * 4 * 3, dtype=np.float64).reshape(ndp * 4, 3)
    xs = shard_array(x, mesh)
    assert xs.sharding.is_equivalent_to(NamedSharding(mesh, P('dp', None)), xs.ndim)
    # sharded compute matches single-device
    out = jax.jit(lambda a: jnp.sum(a ** 2, axis=-1))(xs)
    np.testing.assert_allclose(np.asarray(out), np.sum(x ** 2, axis=-1))


def test_replicate():
    mesh = make_mesh()
    tree = {'a': np.arange(6.0), 'b': (np.ones((2, 2)),)}
    rep = replicate(tree, mesh)
    assert rep['a'].sharding.is_equivalent_to(NamedSharding(mesh, P()), 1)
    np.testing.assert_allclose(np.asarray(rep['b'][0]), 1.0)


def test_sharded_cosmology_batch():
    # the flagship use: vmapped cosmology forward with the batch axis on 'dp'
    from cosmoprimo_tpu.cosmology import Cosmology
    mesh = make_mesh()
    ndp = dict(mesh.shape)['dp']
    omega = np.linspace(0.11, 0.13, ndp * 2)

    def distance(omega_cdm):
        c = Cosmology(engine='eisenstein_hu', omega_cdm=omega_cdm)
        return c.get_background().comoving_radial_distance(1.0)

    sharded = shard_array(omega, mesh)
    out = jax.jit(jax.vmap(distance))(sharded)
    ref = jax.vmap(distance)(jnp.asarray(omega))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-12)


def test_split_ranks_partition():
    owned = [split_ranks(10, rank, 3) for rank in range(3)]
    flat = [i for part in owned for i in part]
    assert sorted(flat) == list(range(10))
    assert all(len(part) in (3, 4) for part in owned)


def test_fake_comm_roundtrip():
    comm = FakeComm()
    assert comm.Get_size() == 1 and comm.Get_rank() == 0
    assert comm.bcast(42) == 42
    assert comm.gather('x') == ['x']
    assert comm.allgather(3) == [3]
    assert comm.scatter([7]) == 7
    assert comm.allreduce_sum(5) == 5
    assert isinstance(get_comm(), FakeComm)


def test_fake_comm_send_recv():
    comm = FakeComm()
    comm.send({'a': 1}, dest=0, tag=3)
    comm.send('second', dest=0, tag=3)
    assert comm.recv(source=0, tag=3) == {'a': 1}
    assert comm.recv(source=0, tag=3) == 'second'


def test_jax_distributed_comm_object_collectives():
    # single-process instantiation still exercises the full bytes protocol
    # (pickle -> length broadcast -> padded payload broadcast -> unpickle),
    # which is what broke on real multi-host in round 1: non-root ranks used
    # to pass None straight into broadcast_one_to_all (shape mismatch).
    from cosmoprimo_tpu.parallel.distributed import JaxDistributedComm
    comm = JaxDistributedComm()
    assert comm.Get_size() == 1
    # arbitrary (non-array, non-uniform-shape) payloads
    obj = {'params': np.arange(5.0), 'name': 'desi', 'none': None}
    out = comm.bcast(obj, root=0)
    np.testing.assert_array_equal(out['params'], obj['params'])
    assert out['name'] == 'desi' and out['none'] is None
    assert comm.scatter([obj], root=0)['name'] == 'desi'
    gathered = comm.allgather(('tuple', 3))
    assert gathered == [('tuple', 3)]
    assert comm.reduce_sum(2.5, root=0) == 2.5
    # p2p maps onto the broadcast; rank 0 sending to itself round-trips
    assert comm.recv(source=0) is None  # no pending value -> broadcast of None


def test_seed_helpers_deterministic():
    s1 = bcast_seed(seed=11, size=16)
    s2 = bcast_seed(seed=11, size=16)
    np.testing.assert_array_equal(s1, s2)
    a = set_common_seed(seed=7)
    b = set_common_seed(seed=7)
    assert a == b
    c = set_independent_seed(seed=7)
    assert np.isscalar(c) or np.ndim(c) == 0


if __name__ == '__main__':
    import sys
    sys.exit(pytest.main([__file__, '-q']))


def test_sharded_batched_nonlinear_pipeline():
    """The batched (single-FFT) pipeline with the halofit transform runs
    dp-sharded over the virtual mesh and stays finite."""
    import numpy as np
    from cosmoprimo_tpu.parallel import make_mesh, shard_array
    from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched

    devices = jax.devices()
    mesh = make_mesh(devices)
    fn, k, s = make_pk_to_xi_pipeline_batched(nk=128, non_linear='halofit')
    batch = 2 * len(devices)
    rng = np.random.default_rng(3)
    args = [shard_array(jnp.asarray(v), mesh, axis='dp') for v in
            (rng.uniform(0.11, 0.13, batch), rng.uniform(0.021, 0.023, batch),
             rng.uniform(0.65, 0.70, batch), rng.uniform(0.94, 0.98, batch),
             rng.uniform(2.9, 3.1, batch))]
    xi, chi, s8 = jax.jit(fn)(*args)
    assert xi.shape[0] == batch
    assert np.isfinite(np.asarray(xi)).all() and np.isfinite(np.asarray(s8)).all()


def test_jax_distributed_comm_p2p_mailbox():
    """Size-1 p2p send/recv round-trips through the local mailbox (tags
    honored); an empty mailbox recv returns None."""
    from cosmoprimo_tpu.parallel.distributed import JaxDistributedComm
    comm = JaxDistributedComm()
    comm.send({'x': 1}, dest=0, tag=7)
    comm.send('second', dest=0, tag=7)
    assert comm.recv(source=0, tag=7) == {'x': 1}
    assert comm.recv(source=0, tag=7) == 'second'
    assert comm.recv(source=0, tag=7) is None
    assert comm.recv(source=0, tag=3) is None


def test_sharded_batched_hmcode_pipeline():
    """The batched pipeline with the HMcode-2020 transform runs dp-sharded
    and matches the same batch on one device."""
    from cosmoprimo_tpu.parallel import make_mesh, shard_array
    from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched

    devices = jax.devices()
    mesh = make_mesh(devices, axis_names=('dp',))
    fn, k, s = make_pk_to_xi_pipeline_batched(nk=64, non_linear='mead')
    rng = np.random.default_rng(4)
    params = [rng.uniform(lo, hi, len(devices)) for lo, hi in
              ((0.11, 0.13), (0.021, 0.023), (0.65, 0.70), (0.94, 0.98), (2.9, 3.1))]
    xi, chi, s8 = jax.jit(fn)(*[shard_array(jnp.asarray(v), mesh, axis='dp') for v in params])
    assert xi.sharding.device_set == set(devices)
    xi1, _, s81 = jax.jit(fn)(*[jnp.asarray(v) for v in params])
    np.testing.assert_allclose(np.asarray(xi), np.asarray(xi1), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.asarray(s8), np.asarray(s81), rtol=1e-12)


def test_mlp_train_step_dp_tp():
    """One MLP-emulator training step with the batch on 'dp' and the hidden
    layers on 'tp', on targets from the dp-sharded distance pipeline."""
    pytest.importorskip('flax')
    from cosmoprimo_tpu.emulators.mlp import MLP, init_train_state, make_train_step
    from cosmoprimo_tpu.pipelines import make_distance_pipeline

    mesh = make_mesh()
    batch = 2 * len(jax.devices())
    rng = np.random.default_rng(1)
    oc, ob, h = (shard_array(jnp.asarray(rng.uniform(lo, hi, batch)), mesh, axis='dp') for lo, hi in
                 ((0.11, 0.13), (0.021, 0.023), (0.65, 0.70)))
    fn, _ = make_distance_pipeline()
    chi = jax.jit(jax.vmap(fn))(oc, ob, h)
    assert np.isfinite(np.asarray(chi)).all()
    x = jax.device_put(jnp.stack([oc, ob, h], axis=-1), NamedSharding(mesh, P('dp', None)))
    y = jax.device_put(jnp.log(chi), NamedSharding(mesh, P('dp', None)))
    model = MLP(features=(32, 32, 32, y.shape[-1]), activation=('silu',) * 3)
    params, batch_stats, opt_state, tx = init_train_state(model, jax.random.PRNGKey(0), x[:1], mesh=mesh)
    step = make_train_step(model, tx, mesh=mesh)
    params, batch_stats, opt_state, loss = step(params, batch_stats, opt_state, x, y)
    jax.block_until_ready(params)
    assert np.isfinite(float(loss))

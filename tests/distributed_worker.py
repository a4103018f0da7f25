"""Worker process for tests/test_distributed_multiprocess.py: joins a real
``jax.distributed`` service on localhost (CPU backend, Gloo collectives) and
drives every multi-rank branch of
cosmoprimo_tpu.parallel.distributed.JaxDistributedComm — the paths a
single-process CI run can never reach (reference comm semantics:
/root/reference/cosmoprimo/emulators/tools/mpi.py:153-437).

Usage: python distributed_worker.py PORT NPROC RANK OUTDIR
Writes OUTDIR/ok.RANK on success; rank 0 also writes the gathered QMC
samples for the parent to compare against a single-process run.
"""

import sys

import numpy as np


def main():
    port, nproc, rank, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import jax
    jax.config.update('jax_platforms', 'cpu')  # the workers run on the CPU backend
    jax.distributed.initialize(coordinator_address=f'localhost:{port}',
                               num_processes=nproc, process_id=rank)
    from cosmoprimo_tpu.parallel.distributed import (
        bcast_seed, get_comm, set_common_seed, set_independent_seed)
    comm = get_comm()
    assert type(comm).__name__ == 'JaxDistributedComm', type(comm)
    assert comm.Get_size() == nproc and comm.Get_rank() == rank

    # ---- bcast of a ragged object (non-root ranks contribute None)
    payload = {'arr': np.arange(7.0), 'tag': 'hello', 'n': 42} if rank == 0 else None
    got = comm.bcast(payload, root=0)
    assert got['tag'] == 'hello' and np.allclose(got['arr'], np.arange(7.0)) and got['n'] == 42

    # ---- allgather of per-rank objects with different pickled sizes
    got = comm.allgather(np.arange(rank + 1) * 1.0)
    assert len(got) == nproc
    for r in range(nproc):
        assert np.allclose(got[r], np.arange(r + 1) * 1.0)

    # ---- scatter from a non-zero root
    values = [{'r': r, 'x': np.full(r + 2, float(r))} for r in range(nproc)] if rank == 1 else None
    mine = comm.scatter(values, root=1)
    assert mine['r'] == rank and np.allclose(mine['x'], float(rank))

    # ---- gather lands on root only
    g = comm.gather(rank * 10, root=0)
    if rank == 0:
        assert g == [r * 10 for r in range(nproc)]
    else:
        assert g is None

    # ---- reductions
    assert comm.allreduce_sum(rank + 1) == nproc * (nproc + 1) // 2
    red = comm.reduce_sum(np.array([rank + 1.0]), root=1)
    if rank == 1:
        assert np.allclose(red, nproc * (nproc + 1) / 2)
    else:
        assert red is None

    # ---- point-to-point: rank 1 -> rank 0; every rank participates, the
    # destination gets the value, bystanders (nproc > 2) get None
    if rank == 1:
        comm.send({'data': np.array([3.14])}, dest=0, tag=3)
    else:
        pkt = comm.recv(source=1, tag=3)
        if rank == 0:
            assert np.allclose(pkt['data'], [3.14])
        else:
            assert pkt is None

    comm.barrier()

    # ---- seed helpers (reference tools/mpi.py:512-591 semantics)
    seeds = bcast_seed(seed=11, comm=comm, size=100)
    assert len(seeds) == 100
    all_seeds = comm.allgather(np.asarray(seeds))
    assert all(np.array_equal(s, all_seeds[0]) for s in all_seeds)
    set_common_seed(seed=7, comm=comm)
    draws = comm.allgather(np.random.random())
    assert all(abs(d - draws[0]) < 1e-15 for d in draws)
    set_independent_seed(seed=7, comm=comm)
    draws = comm.allgather(np.random.random())
    assert len({round(d, 12) for d in draws}) == nproc

    # ---- QMCSampler fan-out: rank-sharded points through the real comm,
    # gathered Samples on root (samples.py run/gather path)
    from cosmoprimo_tpu.emulators.samples import QMCSampler

    def calculator(a=0.0, b=0.0):
        return {'y': np.array([a + 2 * b, a * b])}

    sampler = QMCSampler(calculator, {'a': [0.0, 1.0], 'b': [2.0, 3.0]}, comm=comm)
    samples = sampler.run(niterations=12)
    if rank == 0:
        np.save(outdir + '/gathered.npy',
                {'a': np.asarray(samples['X.a']), 'b': np.asarray(samples['X.b']),
                 'y': np.asarray(samples['Y.y'])}, allow_pickle=True)
    else:
        assert samples is None

    with open(f'{outdir}/ok.{rank}', 'w') as f:
        f.write('ok')


if __name__ == '__main__':
    main()

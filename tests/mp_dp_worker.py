"""Worker for the multi-process data-parallel equivalence test.

Launched as ``python tests/mp_dp_worker.py <pid> <nproc> <port> <out.npz>``
with a CPU backend and 2 virtual devices per process.  Joins a
``jax.distributed`` cluster over gloo collectives, runs one sharded
``train_chunk`` over the GLOBAL mesh (the same step a multi-GPU host runs
over NCCL), and process 0 saves the resulting replicated params.

The parent test (tests/test_distributed.py) asserts the result matches a
single-process run on an identical 4-device mesh.
"""

import sys

import numpy as np


def build_problem():
    fea_dim, context, hidden = 8, 7, 16
    layersizes = (fea_dim * context, hidden, fea_dim)
    bunch, n_frames, n_bunches = 8, 128, 4
    rng = np.random.default_rng(7)
    noisy = rng.normal(size=(n_frames, fea_dim)).astype(np.float32)
    clean = rng.normal(size=(n_frames, fea_dim)).astype(np.float32)
    starts = rng.integers(0, n_frames - context,
                          size=(n_bunches, bunch)).astype(np.int32)
    return layersizes, bunch, context, noisy, clean, starts


def run_step(mesh):
    import jax
    import jax.numpy as jnp

    from tpu_se.models import init_params
    from tpu_se.parallel import (
        param_shardings, replicated_sharding, shard_train_args,
    )
    from tpu_se.train import TrainHyper, make_train_state, train_chunk

    layersizes, bunch, context, noisy, clean, starts = build_problem()
    params = init_params(3, layersizes)
    specs = param_shardings(mesh, len(params))
    params = [{"w": jax.device_put(l["w"], s["w"]),
               "b": jax.device_put(l["b"], s["b"])}
              for l, s in zip(params, specs)]
    state = make_train_state(params, layersizes[-1])
    state.alpha = jax.device_put(state.alpha, replicated_sharding(mesh))
    noisy, clean, starts = shard_train_args(mesh, noisy, clean, starts)
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=bunch, context=context,
                       targ_offset=3)
    out = train_chunk(state, noisy, clean, starts, jnp.float32(0.05), hyper)
    jax.block_until_ready(out.params)
    return out


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    out_path = sys.argv[4]

    import jax

    from tpu_se.parallel import initialize_distributed, make_mesh

    info = initialize_distributed(f"127.0.0.1:{port}", num_processes=nproc,
                                  process_id=pid, cpu_collectives="gloo")
    assert info["process_count"] == nproc, info
    assert info["global_devices"] == 2 * nproc, info

    mesh = make_mesh(data=jax.device_count(), model=1)
    out = run_step(mesh)

    if pid == 0:
        # Params are replicated -> any addressable shard is the full array.
        arrs = {}
        for i, layer in enumerate(out.params):
            arrs[f"w{i}"] = np.asarray(layer["w"].addressable_data(0))
            arrs[f"b{i}"] = np.asarray(layer["b"].addressable_data(0))
        arrs["alpha"] = np.asarray(out.alpha.addressable_data(0))
        np.savez(out_path, **arrs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

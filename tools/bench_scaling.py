#!/usr/bin/env python
"""Data-parallel weak-scaling benchmark over a device mesh.

Measures training frames/sec at fixed per-device batch while growing the
'data' mesh axis (1, 2, 4, ... devices) and reports scaling efficiency vs
the 1-device run — the SURVEY.md §6 north-star (>=95% DP scaling).

Modes:
- On a multi-GPU host: real numbers over the devices' interconnect, at the
  full 2048-wide hidden layers (run with no env overrides).
- ``--cpu``: functional harness over virtual CPU devices at hidden width
  256; the efficiency number reflects host-core oversubscription, not an
  interconnect — use it to validate the harness, not the hardware.

Parity mode (global M=128) does not distribute well: every update
all-reduces the full 12.6M-param gradient (~50 MB).  Production scaling
uses grad_scale='natural' with per-device bunches of thousands of frames,
where compute per update grows with the local batch while the reduction
stays 50 MB.  Where efficiency crosses 95 % on a given machine is what this
script measures.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", default="1,2,4,8",
                    help="comma-separated data-axis sizes")
    ap.add_argument("--batch-per-device", type=int, default=1024)
    ap.add_argument("--bunches", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=0,
                    help="hidden width (0 = 2048, or 256 with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="force virtual CPU devices")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line")
    args = ap.parse_args()

    sizes = [int(s) for s in args.meshes.split(",")]
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={max(sizes)}")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_se.models import init_params
    from tpu_se.parallel import (make_mesh, param_shardings,
                                 replicated_sharding, shard_train_args)
    from tpu_se.train import TrainHyper, make_train_state, train_chunk

    platform = jax.devices()[0].platform
    hidden = args.hidden or (256 if args.cpu else 2048)
    fea_dim, context = 257, 7
    layersizes = (fea_dim * context, hidden, hidden, hidden, fea_dim)
    n_frames = 65536

    rng = np.random.default_rng(0)
    noisy = rng.standard_normal((n_frames, fea_dim), dtype=np.float32)
    clean = rng.standard_normal((n_frames, fea_dim), dtype=np.float32)

    results = {}
    for n in sizes:
        if n > len(jax.devices()):
            print(f"# skip data={n}: only {len(jax.devices())} devices")
            continue
        mesh = make_mesh(n, 1)
        bunch = args.batch_per_device * n          # weak scaling
        starts = rng.integers(0, n_frames - context,
                              size=(args.bunches, bunch)).astype(np.int32)
        hyper = TrainHyper(beta=1.0, ml=True, bunchsize=bunch,
                           context=context, targ_offset=3,
                           grad_scale="natural")
        params = init_params(1, layersizes)
        specs = param_shardings(mesh, len(params))
        params = [{"w": jax.device_put(l["w"], s["w"]),
                   "b": jax.device_put(l["b"], s["b"])}
                  for l, s in zip(params, specs)]
        state = make_train_state(params, layersizes[-1])
        state.alpha = jax.device_put(state.alpha, replicated_sharding(mesh))
        nd, cd, sd = shard_train_args(mesh, noisy, clean, starts)
        lr = jnp.float32(0.01)

        def sync(s):
            return float(jnp.sum(s.params[0]["w"]))

        state = train_chunk(state, nd, cd, sd, lr, hyper)
        sync(state)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            state = train_chunk(state, nd, cd, sd, lr, hyper)
        sync(state)
        dt = (time.perf_counter() - t0) / reps
        fps = args.bunches * bunch / dt
        results[n] = fps
        eff = fps / (results[1] * n) if 1 in results and n > 1 else 1.0
        print(f"data={n:2d}  global_bunch={bunch:6d}  "
              f"{fps/1e3:9.1f} kframes/s  efficiency={eff:.3f}")

    eff_final = None
    if len(results) > 1:
        ns = sorted(results)
        eff_final = results[ns[-1]] / (results[ns[0]] * ns[-1] / ns[0])
        print(f"# weak-scaling efficiency {ns[0]}->{ns[-1]} devices: "
              f"{eff_final:.3f} (platform={platform}, hidden={hidden})")
    if args.json:
        import json
        print(json.dumps({
            "metric": "dp_weak_scaling_efficiency",
            "value": round(eff_final, 4) if eff_final is not None else None,
            "unit": f"fraction ({min(results)}->{max(results)} devices)",
            "vs_baseline": round(eff_final, 4) if eff_final else None,
            "detail": {
                "platform": platform, "hidden": hidden,
                "batch_per_device": args.batch_per_device,
                "frames_per_s": {str(n): round(v) for n, v in results.items()},
                "note": ("virtual CPU devices oversubscribe host cores; "
                         "efficiency here validates the harness/collectives, "
                         "not an interconnect"
                         if platform == "cpu" else "measured on hardware"),
            },
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

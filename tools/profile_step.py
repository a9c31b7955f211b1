#!/usr/bin/env python
"""Ablation profile of the train-step scan: where does the time go?

Times, on the device JAX finds, scans that run (a) the full train body,
(b) only the gather-splice + target gather, (c) only the GEMM fwd/bwd with
a pre-gathered constant x, (d) only the optimizer update.  Differences
localize the cost of each stage by ablation; a profiler trace gives the
same split per kernel.

Defaults profile the parity config (M=128 fp32).  The natural config:

  python tools/profile_step.py --bunch 4096 --dtype bfloat16 \
      --grad-scale natural --json profile_m4096.json
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bunch", type=int, default=128)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--grad-scale", default="parity",
                    choices=["parity", "natural"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None, help="write the ablation here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_se.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    from tpu_se.losses import output_grad_and_alpha
    from tpu_se.models import DEFAULT_LAYERSIZES, forward, init_params
    from tpu_se.train import TrainHyper, make_train_state, train_chunk
    from tpu_se.train.optim import sgd_momentum_update
    from tpu_se.train.step import gather_splice

    layersizes = DEFAULT_LAYERSIZES
    bunch, fea_dim, context = args.bunch, 257, 7
    n_frames = 102400 + 4096
    n_bunches = max(1, 102400 // bunch)
    cdtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32

    rng = np.random.default_rng(0)
    noisy = jnp.asarray(rng.standard_normal((n_frames, fea_dim),
                                            dtype=np.float32))
    clean = jnp.asarray(rng.standard_normal((n_frames, fea_dim),
                                            dtype=np.float32))
    starts = jnp.asarray(rng.integers(
        0, n_frames - context, size=(n_bunches, bunch)).astype(np.int32))
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=bunch, context=context,
                       targ_offset=3, grad_scale=args.grad_scale,
                       compute_dtype=cdtype)
    lr = 0.1
    opt_n = bunch if args.grad_scale == "parity" else 1
    record = {"bunch": bunch, "dtype": args.dtype,
              "grad_scale": args.grad_scale, "n_bunches": n_bunches,
              "platform": jax.devices()[0].platform,
              "device_kind": jax.devices()[0].device_kind,
              "stages_us_per_bunch": {}}

    def sync(out):
        jax.block_until_ready(out)

    def timeit(name, fn, *fargs, reps=args.reps):
        out = fn(*fargs)
        sync(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*fargs)
        sync(out)
        dt = (time.perf_counter() - t0) / reps
        print(f"{name:28s} {dt*1e3:8.2f} ms/chunk  "
              f"{dt/n_bunches*1e6:7.2f} us/bunch")
        record["stages_us_per_bunch"][name] = round(dt / n_bunches * 1e6, 2)
        return dt

    # (a) full step (chained: donation consumes the state)
    st = make_train_state(init_params(1, layersizes), layersizes[-1])
    st = train_chunk(st, noisy, clean, starts, lr, hyper)
    sync(st.params[0]["w"])
    t0 = time.perf_counter()
    for _ in range(args.reps):
        st = train_chunk(st, noisy, clean, starts, lr, hyper)
    sync(st.params[0]["w"])
    dt = (time.perf_counter() - t0) / args.reps
    print(f"{'full train_chunk':28s} {dt*1e3:8.2f} ms/chunk  "
          f"{dt/n_bunches*1e6:7.2f} us/bunch")
    record["stages_us_per_bunch"]["full train_chunk"] = round(
        dt / n_bunches * 1e6, 2)
    record["frames_per_sec"] = round(n_bunches * bunch / dt, 1)

    # (b) gather only: splice + targ gather, reduced to keep it live
    @jax.jit
    def gather_only(noisy, clean, starts):
        def body(acc, bs):
            x = gather_splice(noisy, bs, context)
            targ = clean[bs + 3]
            return acc + jnp.sum(x) + jnp.sum(targ), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), starts)
        return acc

    timeit("gather-splice + targ only",
           lambda: gather_only(noisy, clean, starts))

    state = make_train_state(init_params(1, layersizes), layersizes[-1])

    # (c) compute only: fixed x (contiguous slice), full fwd/bwd/update
    @jax.jit
    def compute_only(state, noisy, clean, starts):
        x0 = jax.lax.dynamic_slice(noisy, (0, 0), (bunch, fea_dim))
        x0 = jnp.tile(x0, (1, context))

        def body(carry, bs):
            params, velocity, _a = carry
            targ = jax.lax.dynamic_slice(clean, (0, 0), (bunch, fea_dim))
            out, vjp = jax.vjp(
                lambda p: forward(p, x0, compute_dtype=cdtype), params)
            dedx, alpha = output_grad_and_alpha(out, targ, 1.0, True)
            grads = vjp(dedx)[0]
            params, velocity = sgd_momentum_update(
                params, velocity, grads, lr, 0.9, 1e-5, opt_n)
            return (params, velocity, alpha), None
        (p, v, a), _ = jax.lax.scan(body, (state.params, state.velocity,
                                           state.alpha), starts)
        return p[0]["w"]

    timeit("compute only (fixed x)",
           lambda s: compute_only(s, noisy, clean, starts), state)

    # (d) optimizer update only
    @jax.jit
    def update_only(state, starts):
        grads = jax.tree.map(jnp.zeros_like, state.params)

        def body(carry, _bs):
            params, velocity = carry
            params, velocity = sgd_momentum_update(
                params, velocity, grads, lr, 0.9, 1e-5, opt_n)
            return (params, velocity), None
        (p, v), _ = jax.lax.scan(body, (state.params, state.velocity),
                                 starts)
        return p[0]["w"]

    timeit("optimizer update only",
           lambda s: update_only(s, starts), state)

    # (e) forward+backward GEMMs only: no optimizer, no alpha chain.
    # x must depend on the scan input or XLA hoists the whole body out of
    # the loop (loop-invariant code motion) and reports one iteration.
    @jax.jit
    def gemms_only(state, noisy, starts):
        def body(acc, bs):
            x0 = jax.lax.dynamic_slice(
                noisy, (bs[0] % 1024, 0), (bunch, fea_dim))
            x0 = jnp.tile(x0, (1, context))
            out, vjp = jax.vjp(
                lambda p: forward(p, x0, compute_dtype=cdtype),
                state.params)
            grads = vjp(out)[0]
            return acc + jnp.sum(grads[0]["w"].astype(jnp.float32)), None
        acc, _ = jax.lax.scan(body, jnp.float32(0), starts)
        return acc

    timeit("fwd+bwd GEMMs only", lambda s: gemms_only(s, noisy, starts),
           state)

    # GEMM work per bunch: fwd 2 + dgrad 2 + wgrad 2 FLOPs per weight per
    # frame.  No peak rate is divided in: that needs a table keyed by
    # device_kind.
    record["flops_per_bunch"] = 6 * bunch * sum(
        a * b for a, b in zip(layersizes[:-1], layersizes[1:]))
    print(json.dumps({"metric": "profile_frames_per_sec",
                      "value": record["frames_per_sec"],
                      "unit": "frames/s", "bunch": bunch,
                      "dtype": args.dtype}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Benchmark: training throughput of the flagship config on one GPU.

Measures frames/sec through the full jit/scan training engine (reference
workload: 1799 -> 2048x3 -> 257, bunchsize 128, ML-GGD beta=1, parity
gradient semantics — ``finetune.pl:10-32``).  Refuses to run without a GPU:
a CPU number is not a device number.

Prints ONE JSON line: {"metric", "value", "unit", "platform",
"device_kind", "device_count", "achieved_tflops"}.  The reference publishes
no throughput number, and no peak rate is divided in here: a roofline
share needs a peak table keyed by ``device_kind``, which this script does
not keep.
"""

import argparse
import json
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (the production/'natural' dtype)")
    ap.add_argument("--bunch", type=int, default=128,
                    help="bunch size (default: the parity config's 128)")
    ap.add_argument("--act-dtype", default=None,
                    choices=[None, "bfloat16"],
                    help="reduced-precision hidden activations (halves "
                         "inter-layer + vjp-saved device-memory traffic; off = "
                         "f32 activations, the parity behavior)")
    ap.add_argument("--frames-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="device dtype of the resident frame matrices; "
                         "bfloat16 halves gather traffic and is "
                         "value-preserving for --bf16 compute (the "
                         "GEMM inputs are rounded to bf16 regardless)")
    ap.add_argument("--step", default="gspmd", choices=["gspmd", "overlap"],
                    help="training step variant: the GSPMD train_chunk "
                         "(default) or the shard_map per-layer-psum "
                         "overlap step on a 1-device mesh (sanity: the "
                         "hand-written backward must match vjp throughput)")
    ap.add_argument("--out", default=None,
                    help="also write the JSON record to this file")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from tpu_se.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    from tpu_se.models import DEFAULT_LAYERSIZES, init_params
    from tpu_se.train import TrainHyper, make_train_state, train_chunk

    dev = jax.devices()[0]
    platform = dev.platform
    if platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {platform!r})", file=sys.stderr)
        return 1
    compute_dtype = jnp.bfloat16 if args.bf16 else jnp.float32

    layersizes = DEFAULT_LAYERSIZES
    bunch = args.bunch
    fea_dim, context = 257, 7
    n_frames = 102400 + 4096          # one traincache chunk (+ pad bucket)
    n_bunches = 102400 // bunch       # 800

    rng = np.random.default_rng(0)
    noisy = rng.standard_normal((n_frames, fea_dim), dtype=np.float32)
    clean = rng.standard_normal((n_frames, fea_dim), dtype=np.float32)
    starts = rng.integers(0, n_frames - context,
                          size=(n_bunches, bunch)).astype(np.int32)

    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=bunch, context=context,
                       targ_offset=3, grad_scale="parity",
                       compute_dtype=compute_dtype,
                       act_dtype=(jnp.bfloat16 if args.act_dtype
                                  else None))
    params = init_params(1, layersizes)
    state = make_train_state(params, layersizes[-1])

    fdt = (jnp.bfloat16 if args.frames_dtype == "bfloat16"
           else jnp.float32)
    noisy_d = jnp.asarray(noisy, dtype=fdt)
    clean_d = jnp.asarray(clean, dtype=fdt)
    starts_d = jnp.asarray(starts)
    lr = jnp.float32(0.1)

    def sync(s):
        jax.block_until_ready(s.params)

    if args.step == "overlap":
        from tpu_se.parallel import make_mesh
        from tpu_se.parallel.overlap_step import train_chunk_overlap

        if args.act_dtype:
            raise SystemExit("--step overlap does not support --act-dtype "
                             "(the hand-written backward has no act_dtype "
                             "path; the run would silently measure f32 "
                             "activations)")
        mesh1 = make_mesh(1, 1, devices=[dev])

        def train_chunk(st, n, c, s, l, h):  # noqa: F811 — bench shim
            return train_chunk_overlap(st, n, c, s, l, h, mesh=mesh1)

    # Warm-up / compile.
    state = train_chunk(state, noisy_d, clean_d, starts_d, lr, hyper)
    sync(state)

    # Steady-state: dispatch reps back-to-back (async, as a real training
    # loop runs) and sync once — per-dispatch control latency overlaps with
    # device execution instead of being billed per rep.
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        state = train_chunk(state, noisy_d, clean_d, starts_d, lr, hyper)
    sync(state)
    dt = time.perf_counter() - t0

    frames = reps * n_bunches * bunch
    fps = frames / dt

    # 6 FLOPs per weight per frame (fwd 2 + dgrad 2 + wgrad 2).
    gemm_weights = sum(a * b for a, b in zip(layersizes[:-1], layersizes[1:]))
    achieved_flops = fps * 6 * gemm_weights

    record = {
        "metric": "train_frames_per_sec_per_chip",
        "value": fps,
        "unit": "frames/s",
        "step": args.step,
        "platform": platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "achieved_tflops": achieved_flops / 1e12,
    }
    print(json.dumps(record))
    if args.out:
        record.update(bunch=bunch, dtype=compute_dtype.__name__)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(f"# {dev.device_kind} dtype={compute_dtype.__name__} "
          f"chunk_time={dt/reps*1e3:.3f}ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

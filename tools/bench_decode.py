#!/usr/bin/env python
"""Offline decode throughput: batch enhancement on the current backend.

Times the full device pipeline per utterance — LPS analysis GEMM,
normalize + edge-replicated splice, DNN forward, de-normalize, noisy-phase
synthesis + OLA — over a batch of bucket-padded utterances, reporting
frames/s and the real-time factor (x faster than audio).

Prints one JSON line with the headline numbers; --out additionally writes
the full record (``--out``) so run-over-run
regressions are visible.  Reference analogue: the per-process decode loop
``Test_code/decode.m:24-68``.

Usage: timeout 590 python tools/bench_decode.py [--utts N] [--frames T]
       [--out decode.json]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def _bench_device_only(enh, utts, batch: int,
                       iters=(64, 320)) -> dict:
    """Device-compute-only frames/s for the three decode paths.

    Builds, per path, one jitted program `fori_loop(iters)` whose body
    re-decodes its own previous output (recon frames / output wave) —
    a loop-carried dependency so the body cannot be hoisted.  Runs it at
    two iteration counts and differences the wall times: constant costs
    (dispatch, arg transfer, result fetch) cancel,
    leaving pure device execution time per iteration.
    """
    import functools

    import jax
    import jax.numpy as jnp

    from tpu_se.dsp.analysis import FRAME_BUCKET
    from tpu_se.infer.decode import (
        _decode_core, _decode_device_batch_waves,
    )
    from tpu_se.dsp import frame_signal

    shift, length = enh.frame_shift, enh.frame_length
    frames0 = frame_signal(utts[0], length, shift)
    t = frames0.shape[0]
    t_pad = -(-t // FRAME_BUCKET) * FRAME_BUCKET
    params, mean, inv_std = enh.params, enh.mean, enh.inv_std
    ctx = enh.context

    @functools.partial(jax.jit, static_argnames=("n",))
    def loop_utt(params, frames, n_valid, n):
        def body(_, f):
            _, recon, _ = _decode_core(params, f, mean, inv_std, n_valid,
                                       shift, ctx)
            return recon
        return jax.lax.fori_loop(0, n, body, frames)

    @functools.partial(jax.jit, static_argnames=("n",))
    def loop_batch(params, frames_b, n_valid, n):
        def body(_, fb):
            def one(f, nv):
                _, recon, _ = _decode_core(params, f, mean, inv_std, nv,
                                           shift, ctx)
                return recon
            return jax.vmap(one)(fb, n_valid)
        return jax.lax.fori_loop(0, n, body, frames_b)

    @functools.partial(jax.jit, static_argnames=("n",))
    def loop_waves(params, waves_b, n_valid, n):
        def body(_, wb):
            return _decode_device_batch_waves(params, wb, mean, inv_std,
                                              n_valid, shift, ctx)
        return jax.lax.fori_loop(0, n, body, waves_b)

    def timed(fn, *fn_args):
        dts = []
        for n in iters:
            out = fn(*fn_args, n=n)          # compile (cached per n)
            jax.block_until_ready(out)
            t0 = time.perf_counter()
            out = fn(*fn_args, n=n)
            jax.block_until_ready(out)
            dts.append(time.perf_counter() - t0)
        return (dts[1] - dts[0]) / (iters[1] - iters[0])

    fp = np.zeros((t_pad, length), dtype=np.float32)
    fp[:t] = frames0
    per_utt_dt = timed(loop_utt, params, jnp.asarray(fp), jnp.int32(t))

    frames_b = np.zeros((batch, t_pad, length), dtype=np.float32)
    ts = []
    for i in range(batch):
        f = frame_signal(utts[i % len(utts)], length, shift)
        frames_b[i, : f.shape[0]] = f
        ts.append(f.shape[0])
    n_valid_b = jnp.asarray(np.array(ts, dtype=np.int32))
    batch_dt = timed(loop_batch, params, jnp.asarray(frames_b), n_valid_b)

    total_frames = float(sum(ts))
    if length != 2 * shift:
        # _decode_device_batch_waves frames by concatenating adjacent
        # shift-sized blocks, valid only for the 50%-overlap configs
        # (16k 512/256, 8k 256/128); at 11 kHz (256/110) the fori_loop
        # carry shape would also mismatch.  Skip the wave-path bench.
        return {"per_utt": t / per_utt_dt,
                "batched": total_frames / batch_dt}

    waves_b = np.zeros((batch, (t_pad + 1) * shift), dtype=np.int16)
    for i in range(batch):
        u = np.asarray(utts[i % len(utts)], dtype=np.int16)
        n = min(len(u), waves_b.shape[1])
        waves_b[i, :n] = u[:n]
    waves_dt = timed(loop_waves, params, jnp.asarray(waves_b), n_valid_b)

    return {"per_utt": t / per_utt_dt,
            "batched": total_frames / batch_dt,
            "wave_only": total_frames / waves_dt}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--utts", type=int, default=32)
    ap.add_argument("--frames", type=int, default=448,
                    help="frames per utterance (~7.2 s at 16 kHz)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16,
                    help="also bench enhance_batch at this batch size "
                         "(0 = skip)")
    ap.add_argument("--out", default=None, help="write full JSON record here")
    args = ap.parse_args()

    import jax

    from tpu_se.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    from tpu_se.infer import Enhancer
    from tpu_se.io import write_wts
    from tpu_se.io.norm import write_norm
    from tpu_se.models import DEFAULT_LAYERSIZES, init_params, params_to_wts

    d = tempfile.mkdtemp()
    wts = os.path.join(d, "m.wts")
    write_wts(wts, params_to_wts(init_params(1, DEFAULT_LAYERSIZES)))
    norm = os.path.join(d, "m.norm")
    rng = np.random.default_rng(0)
    write_norm(norm, rng.normal(size=257).astype(np.float32),
               (1.0 / (1.0 + rng.random(257))).astype(np.float32))

    platform = jax.devices()[0].platform
    enh = Enhancer(wts, norm)
    shift, sr = enh.frame_shift, float(enh.sample_rate)
    n_samples = (args.frames + 1) * shift
    utts = [(rng.normal(size=n_samples) * 1000).astype(np.float32)
            .astype(np.int16) for _ in range(args.utts)]

    # Warm-up: compile every program in the path.
    enh.enhance(utts[0])

    t0 = time.perf_counter()
    total_frames = 0
    for _ in range(args.reps):
        for u in utts:
            wave, _, lps = enh.enhance(u)
            total_frames += lps.shape[0]
    _ = int(wave[-1])
    dt = time.perf_counter() - t0

    fps = total_frames / dt
    audio_rate = fps * shift / sr
    print(f"# platform={platform} utts={args.utts} frames/utt={args.frames} "
          f"reps={args.reps}")
    print(f"decode throughput: {fps:,.0f} frames/s = {audio_rate:,.0f}x "
          f"real-time ({dt / (args.reps * args.utts) * 1e3:.1f} ms per "
          f"{n_samples / sr:.1f} s utterance)")

    # Batched mode: B utterances per device program (one transfer).
    if args.batch > 1:
        batches = [utts[lo: lo + args.batch]
                   for lo in range(0, len(utts), args.batch)]
        enh.enhance_batch(batches[0])      # warm-up
        t0 = time.perf_counter()
        total_frames = 0
        for _ in range(args.reps):
            for b in batches:
                outs = enh.enhance_batch(b)
                total_frames += sum(o[2].shape[0] for o in outs)
        _ = int(outs[-1][0][-1])
        dt = time.perf_counter() - t0
        bfps = total_frames / dt
        print(f"batched (B={args.batch}): {bfps:,.0f} frames/s = "
              f"{bfps * shift / sr:,.0f}x real-time "
              f"({bfps / fps:.2f}x vs per-utterance)")
    else:
        bfps = None

    # Serving fast path: int16-only transfers, framing + int16 cast on
    # device, wave-only output (bitwise-equal waves to enhance_batch).
    if args.batch > 1:
        batches = [utts[lo: lo + args.batch]
                   for lo in range(0, len(utts), args.batch)]
        enh.enhance_batch_waves(batches[0])      # warm-up
        t0 = time.perf_counter()
        total_frames = 0
        for _ in range(args.reps):
            for b in batches:
                outs = enh.enhance_batch_waves(b)
                total_frames += sum((len(o) - shift) // shift
                                    for o in outs if len(o))
        for o in reversed(outs):             # sync on a non-empty output
            if len(o):
                _ = int(o[-1])
                break
        dt = time.perf_counter() - t0
        wfps = total_frames / dt
        print(f"wave-only (B={args.batch}): {wfps:,.0f} frames/s = "
              f"{wfps * shift / sr:,.0f}x real-time "
              f"({wfps / bfps:.2f}x vs full batched)")
    else:
        wfps = None

    # ---- device-only timing: separate device compute from host transfer,
    # like tools/bench_stream.py does for streaming.
    # Each path runs as ONE compiled program containing a fori_loop whose
    # body feeds its own output back as the next input (the recon frames
    # for the frame paths, the output wave for the wave path) — a real
    # data dependency, so XLA cannot hoist the body (a loop whose body
    # ignores the carry gets loop-invariant-code-motioned out).  Timing
    # two iteration counts and differencing cancels the one-off dispatch
    # RTT and any constant overhead.
    device_only = _bench_device_only(enh, utts, args.batch) \
        if args.batch > 1 else {}
    for k, v in device_only.items():
        print(f"device-only {k}: {v:,.0f} frames/s "
              f"= {v * shift / sr:,.0f}x real-time")

    record = {
        "platform": platform,
        "utts": args.utts, "frames_per_utt": args.frames, "reps": args.reps,
        "per_utt_frames_per_sec": round(fps, 1),
        "per_utt_x_realtime": round(audio_rate, 1),
        "batch_size": args.batch if args.batch > 1 else None,
        "batched_frames_per_sec": round(bfps, 1) if bfps else None,
        "batched_x_realtime": round(bfps * shift / sr, 1) if bfps else None,
        "wave_only_frames_per_sec": round(wfps, 1) if wfps else None,
        "wave_only_x_realtime": round(wfps * shift / sr, 1) if wfps else None,
    }
    for k, v in device_only.items():
        record[f"device_only_{k}_frames_per_sec"] = round(v, 1)
        record[f"device_only_{k}_x_realtime"] = round(v * shift / sr, 1)
    print(json.dumps({"metric": "decode_frames_per_sec",
                      "value": record["wave_only_frames_per_sec"] or
                      record["batched_frames_per_sec"] or
                      record["per_utt_frames_per_sec"],
                      "unit": "frames/s",
                      "per_utt": record["per_utt_frames_per_sec"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

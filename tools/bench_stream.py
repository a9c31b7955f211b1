#!/usr/bin/env python
"""Serving benchmark: streaming-enhancement latency and multi-channel
throughput on the current backend.

Measures the jitted hop step (``tpu_se/infer/streaming.py``) end to end
(host hop in -> enhanced hop out):

- S=1: per-hop wall latency vs the 16 ms real-time budget (one 256-sample
  hop at 16 kHz).
- S=128: batched-channel throughput -> how many concurrent real-time
  channels one chip sustains.

Prints one JSON line with the headline numbers; --out additionally writes
the full per-stream-count record (``--out``).

Usage: timeout 590 python tools/bench_stream.py [--streams N] [--model m.wts
       --norm m.norm] [--out stream.json]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, nargs="*", default=[1, 8, 128])
    ap.add_argument("--model")
    ap.add_argument("--norm")
    ap.add_argument("--hops", type=int, default=200)
    ap.add_argument("--out", default=None, help="write full JSON record here")
    args = ap.parse_args()

    import jax

    from tpu_se.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    from tpu_se.infer import StreamingEnhancer
    from tpu_se.io import write_wts
    from tpu_se.io.norm import write_norm
    from tpu_se.models import DEFAULT_LAYERSIZES, init_params, params_to_wts

    if args.model:
        wts, norm = args.model, args.norm
    else:
        d = tempfile.mkdtemp()
        wts = os.path.join(d, "m.wts")
        write_wts(wts, params_to_wts(init_params(1, DEFAULT_LAYERSIZES)))
        norm = os.path.join(d, "m.norm")
        rng = np.random.default_rng(0)
        write_norm(norm, rng.normal(size=257).astype(np.float32),
                   (1.0 / (1.0 + rng.random(257))).astype(np.float32))

    import functools

    import jax.numpy as jnp

    from tpu_se.infer.streaming import _stream_step

    @functools.partial(jax.jit, static_argnames=("k", "frame_shift"),
                       donate_argnums=(3,))
    def _device_hops(params, mean, inv_std, state, hop, k, frame_shift):
        """k hop steps in ONE dispatch with a device-resident hop and a
        donated state: wall time is (one RTT + transfer) + k * t_device,
        so differencing two k values isolates pure device compute/hop."""

        def body(st, _):
            st, out = _stream_step(params, mean, inv_std, st, hop,
                                   frame_shift)
            return st, out[0, 0]

        st, outs = jax.lax.scan(body, state, None, length=k)
        return st, outs[-1]

    def device_only_ms(enh, s_count, reps=12, k1=64, k2=256):
        """Per-hop device-compute time via the two-point method; returns
        (p50, p99) over ``reps`` paired measurements."""
        from tpu_se.infer.streaming import _init_state

        rng = np.random.default_rng(2)
        hop_dev = jnp.asarray((rng.normal(size=(s_count, enh.frame_shift))
                               * 1000).astype(np.float32))
        mk = lambda: _init_state(s_count, enh.frame_length,  # noqa: E731
                                 enh.frame_shift, enh.n_bins, enh.context)
        for k in (k1, k2):   # compile both programs
            st, out = _device_hops(enh.params, enh.mean, enh.inv_std, mk(),
                                   hop_dev, k, enh.frame_shift)
            _ = float(out)
        per_hop = []
        for _ in range(reps):
            t0 = time.perf_counter()
            st, out = _device_hops(enh.params, enh.mean, enh.inv_std, mk(),
                                   hop_dev, k1, enh.frame_shift)
            _ = float(out)
            t1 = time.perf_counter()
            st, out = _device_hops(enh.params, enh.mean, enh.inv_std, mk(),
                                   hop_dev, k2, enh.frame_shift)
            _ = float(out)
            t2 = time.perf_counter()
            per_hop.append(((t2 - t1) - (t1 - t0)) / (k2 - k1) * 1e3)
        arr = np.array(per_hop)
        return (float(np.percentile(arr, 50)), float(np.percentile(arr, 99)))

    platform = jax.devices()[0].platform
    shift = 256
    sr = 16000.0
    hop_budget_ms = shift / sr * 1e3

    print(f"# platform={platform} hop={shift} samples "
          f"({hop_budget_ms:.0f} ms real-time budget)")
    record = {"platform": platform, "hop_samples": shift,
              "hop_budget_ms": hop_budget_ms, "streams": []}
    for s_count in args.streams:
        enh = StreamingEnhancer(wts, norm, n_streams=s_count)
        rng = np.random.default_rng(1)
        hop = (rng.normal(size=(s_count, shift)) * 1000).astype(np.float32)
        # Warm-up: compile + fill the pipeline.
        for _ in range(enh.warmup_hops + 4):
            enh.push(hop)
        lat = []
        t_all0 = time.perf_counter()
        for _ in range(args.hops):
            t0 = time.perf_counter()
            out = enh.push(hop)
            _ = float(out[0, 0])  # host sync: the sample left the device
            lat.append(time.perf_counter() - t0)
        t_all = time.perf_counter() - t_all0
        lat_ms = np.array(lat) * 1e3
        frames_s = args.hops * s_count / t_all
        audio_s = frames_s * shift / sr
        dev_p50, dev_p99 = device_only_ms(enh, s_count)
        entry = {"n_streams": s_count,
                 "hop_p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
                 "hop_p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
                 "device_only_p50_ms": round(dev_p50, 3),
                 "device_only_p99_ms": round(dev_p99, 3),
                 "transport_overhead_p50_ms": round(
                     float(np.percentile(lat_ms, 50)) - dev_p50, 3),
                 "hops_per_sec": round(frames_s, 1),
                 "x_realtime_channels": round(audio_s, 1)}
        print(f"S={s_count:4d}: hop latency p50={np.percentile(lat_ms, 50):.2f} "
              f"p99={np.percentile(lat_ms, 99):.2f} ms "
              f"(budget {hop_budget_ms:.0f} ms) | {frames_s:,.0f} hops/s = "
              f"{audio_s:,.0f}x real-time channels")
        print(f"         device-only p50={dev_p50:.3f} p99={dev_p99:.3f} ms "
              f"per hop (host<->device transport overhead "
              f"{np.percentile(lat_ms, 50) - dev_p50:.2f} ms at p50)")

        # Chunked mode: K hops per dispatch (push_many), the serving path
        # when clients deliver K*16 ms of audio at a time.
        k = enh.SCAN_HOPS
        chunk = (rng.normal(size=(s_count, k, shift)) * 1000
                 ).astype(np.float32)
        enh.push_many(chunk)  # compile
        n_disp = max(1, args.hops // k)
        t0 = time.perf_counter()
        for _ in range(n_disp):
            outs, _ = enh.push_many(chunk)
        _ = float(outs[0, -1, 0])
        t_chunk = time.perf_counter() - t0
        frames_s = n_disp * k * s_count / t_chunk
        audio_s = frames_s * shift / sr
        entry["chunked_k"] = k
        # Buffering a K-hop chunk before dispatch adds K*hop of input
        # latency on top of the 80 ms algorithmic lookahead.
        entry["chunked_added_latency_ms"] = round(k * hop_budget_ms, 1)
        entry["chunked_hops_per_sec"] = round(frames_s, 1)
        entry["chunked_x_realtime_channels"] = round(audio_s, 1)
        print(f"         chunked K={k}: {t_chunk / n_disp * 1e3:.2f} ms per "
              f"{k * hop_budget_ms:.0f} ms chunk | {frames_s:,.0f} hops/s = "
              f"{audio_s:,.0f}x real-time channels")

        # int16 wire: same chunked path, half the transfer per chunk.
        chunk_i16 = chunk.astype(np.int16)
        enh.push_many(chunk_i16, int16_wire=True)  # compile
        t0 = time.perf_counter()
        for _ in range(n_disp):
            outs, _ = enh.push_many(chunk_i16, int16_wire=True)
        _ = int(outs[0, -1, 0])
        t_i16 = time.perf_counter() - t0
        frames_s = n_disp * k * s_count / t_i16
        audio_s = frames_s * shift / sr
        entry["chunked_i16_hops_per_sec"] = round(frames_s, 1)
        entry["chunked_i16_x_realtime_channels"] = round(audio_s, 1)
        record["streams"].append(entry)
        print(f"         chunked K={k} int16 wire: "
              f"{t_i16 / n_disp * 1e3:.2f} ms per chunk | {frames_s:,.0f} "
              f"hops/s = {audio_s:,.0f}x real-time channels")
    print(f"# algorithmic latency: {enh.latency_samples} samples = "
          f"{enh.latency_samples / sr * 1e3:.0f} ms")
    record["algorithmic_latency_ms"] = round(
        enh.latency_samples / sr * 1e3, 1)
    best = max(record["streams"],
               key=lambda e: e["chunked_i16_x_realtime_channels"])
    print(json.dumps({"metric": "stream_realtime_channels",
                      "value": best["chunked_i16_x_realtime_channels"],
                      "unit": "channels",
                      "n_streams": best["n_streams"],
                      "p99_hop_ms_s1": record["streams"][0]["hop_p99_ms"],
                      "device_only_p50_ms_s1":
                          record["streams"][0]["device_only_p50_ms"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

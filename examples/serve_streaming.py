#!/usr/bin/env python
"""Minimal streaming-serving example: the round-5 quality config, live.

Demonstrates the two serving shapes of :class:`tpu_se.infer.StreamingEnhancer`
with the quality decode (adaptive suppression limiter + impulsiveness-gated
smoothing, both as causal analogs — PARITY.md §4):

1. single stream, arbitrary chunk sizes (``feed``/``flush``) — e.g. a
   microphone callback;
2. S batched channels on the int16 wire (``push_many``) — a serving
   deployment filling larger GEMMs across channels.

Usage (CPU works; ``tools/bench_stream.py`` measures the real-time factor
on a device):

    JAX_PLATFORMS=cpu python examples/serve_streaming.py \
        [--wts W --norm N] [noisy.wav]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_ROOT = "artifacts/ab_objectives/big_pt8"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("wav", nargs="?",
                    default="/root/reference/Enh_demos/"
                            "DestroyerEngine_SNR0_NOISY_TEST_DR3_FPKT0_"
                            "SI1538.wav")
    ap.add_argument("--wts", default=f"{DEFAULT_ROOT}/MLGGD1/mlp.50.wts")
    ap.add_argument("--norm", default=f"{DEFAULT_ROOT}/data/train_noisy.norm")
    ap.add_argument("--out", default="enhanced_stream.wav")
    args = ap.parse_args()

    from tpu_se.infer import StreamingEnhancer
    from tpu_se.io import read_wav, write_wav

    noisy, sr = read_wav(args.wav)
    print(f"{os.path.basename(args.wav)}: {len(noisy) / sr:.1f} s @ {sr} Hz")

    # --- shape 1: single stream, arbitrary chunks (mic-callback style) ---
    s = StreamingEnhancer(args.wts, args.norm, sample_rate=sr,
                          blend="auto", smooth_strength="auto")
    print(f"algorithmic latency: {s.latency_samples / sr * 1e3:.0f} ms")
    pieces = []
    chunk = 1024                     # any size; the engine re-buffers
    for i in range(0, len(noisy), chunk):
        pieces.append(s.feed(noisy[i:i + chunk]))
    pieces.append(s.flush())
    enhanced = np.concatenate(pieces)
    write_wav(args.out, enhanced, sr)
    print(f"single stream: {len(enhanced)} samples -> {args.out}")

    # --- shape 2: S channels batched, int16 wire (serving style) ---------
    n_streams, k, shift = 4, 8, s.frame_shift
    multi = StreamingEnhancer(args.wts, args.norm, n_streams=n_streams,
                              sample_rate=sr, blend="auto",
                              smooth_strength="auto")
    n_hops = min(40, len(noisy) // shift - (n_streams - 1))
    hops = np.stack([noisy[o: o + n_hops * shift]
                     for o in range(0, n_streams * shift, shift)])
    hops = hops.reshape(n_streams, n_hops, shift).astype(np.int16)
    total = 0
    for j in range(0, n_hops, k):
        outs, valid = multi.push_many(hops[:, j:j + k], int16_wire=True)
        total += int(valid.sum()) * n_streams
    print(f"{n_streams} channels x {n_hops} hops pushed, "
          f"{total} warm hops emitted (int16 wire)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

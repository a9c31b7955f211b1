#!/usr/bin/env python
"""Score the STREAMING quality-decode path on the held-out Enh_demos
conditions.

The batch quality config (blend auto + gated fractional smoothing) passes
all four metrics on 14/14 conditions (PARITY.md §4 round 5).  Streaming
replaces both adaptive statistics with causal analogs (suppression EMA,
impulsiveness EMA starting OFF, causal noise floor / {c-1,c} min window)
— this tool measures what that costs: each held-out condition decoded via
``StreamingEnhancer.feed``+``flush`` and scored vs noisy alongside the
batch path's numbers.

CPU: JAX_PLATFORMS=cpu python tools/stream_quality.py
Writes artifacts/ab_objectives/big_pt8/STREAM_QUALITY.json.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

REFERENCE = "/root/reference"
ROOT = "artifacts/ab_objectives/big_pt8"
CONDS = ("DestroyerEngine_SNR0", "F-16Cockpit_SNR10", "Pink_SNR-5",
         "MachineGun_SNR5")


def main() -> int:
    from tpu_se.dsp.analysis import frame_signal, rate_config
    from tpu_se.dsp.metrics import lsd, power_spectra, segsnr
    from tpu_se.infer import Enhancer, StreamingEnhancer
    from tpu_se.infer.stoi import pesq_score, stoi
    from tpu_se.io import read_wav

    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="score all 14 conditions (default: the 3 "
                         "held-out + MachineGun probes)")
    ap.add_argument("--seed-dir", default="",
                    help="e.g. s1000 to score that seed's models")
    args = ap.parse_args()
    seed_dir = args.seed_dir
    demo = os.path.join(REFERENCE, "Enh_demos")
    norm = os.path.join(ROOT, "data", "train_noisy.norm")
    wts = os.path.join(ROOT, seed_dir, "MLGGD1", "mlp.50.wts")

    conds = CONDS
    if args.all:
        conds = sorted({f.split("_NOISY_")[0] for f in os.listdir(demo)
                        if "_NOISY_" in f})

    rows = []
    for cond in conds:
        nw = glob.glob(os.path.join(demo, f"{cond}_NOISY_*.wav"))[0]
        cw = re.sub("_NOISY_", "_CLEAN_", nw)[:-4] + ".WAV"
        noisy, fs = read_wav(nw)
        clean, _ = read_wav(cw)
        t = min(len(noisy), len(clean))
        clean, noisy = clean[:t], noisy[:t]

        batch = Enhancer(wts, norm, blend="auto",
                         smooth_strength="auto").enhance(noisy)[0]
        s = StreamingEnhancer(wts, norm, blend="auto",
                              smooth_strength="auto")
        stream = np.concatenate([s.feed(noisy), s.flush()])

        length, shift, _ = rate_config(fs)

        def score(wave):
            n = min(len(wave), t)
            cf = frame_signal(clean[:n].astype(np.float32), length, shift)
            wf = frame_signal(np.asarray(wave[:n], dtype=np.float32),
                              length, shift)
            return {
                "segsnr": round(segsnr(cf, wf), 2),
                "stoi": round(float(stoi(clean[:n], wave[:n], fs)), 4),
                "pesq": round(float(pesq_score(
                    clean[:n], np.asarray(wave[:n], dtype=np.float64),
                    fs)), 3),
                "lsd": round(lsd(power_spectra(cf), power_spectra(wf)), 2),
            }

        rows.append({"condition": cond,
                     "noisy": score(noisy),
                     "batch": score(batch),
                     "stream": score(stream)})
        r = rows[-1]
        print(f"{cond:<22} noisy seg={r['noisy']['segsnr']:>6} "
              f"batch seg={r['batch']['segsnr']:>6} "
              f"stream seg={r['stream']['segsnr']:>6}  "
              f"stoi n/b/s={r['noisy']['stoi']}/{r['batch']['stoi']}/"
              f"{r['stream']['stoi']}  "
              f"pesq n/b/s={r['noisy']['pesq']}/{r['batch']['pesq']}/"
              f"{r['stream']['pesq']}", flush=True)

    if args.all:
        n_pass = sum(
            all((r["stream"][k] > r["noisy"][k]) if k != "lsd"
                else (r["stream"][k] < r["noisy"][k])
                for k in ("segsnr", "stoi", "lsd", "pesq"))
            for r in rows)
        print(f"streamed all-four-metrics pass: {n_pass}/{len(rows)}")
    out = os.path.join(ROOT, f"STREAM_QUALITY{'_' + seed_dir if seed_dir else ''}.json")
    with open(out, "w") as f:
        json.dump({"arm": f"MLGGD1 {seed_dir or 'seed0'}",
                   "decode": "blend auto + smooth_strength auto",
                   "rows": rows}, f, indent=1)
    print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

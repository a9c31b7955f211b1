#!/usr/bin/env python
"""Regenerate the smooth_strength="auto" gate calibration table.

The gate statistic dyn = mean |Δ mean-frame-dB| of the NOISY input
(``tpu_se/infer/decode.py:_smooth_auto_strength``) separates the
quasi-stationary conditions (where fractional smoothing helps every
metric) from the impulsive ones (where the smoother's stationary noise
floor smears real structure — MachineGun loses 2.7 dB SegSNR to any
smoothing).  SM_AUTO_D0/D1 = 2.0/3.0 were chosen from this table using
the NON-held-out conditions only (MachineGun, the binding impulsive case,
is non-held-out); the held-out conditions all sit far below the ramp.

CPU: JAX_PLATFORMS=cpu \
    python tools/smooth_gate_calibration.py
Writes benchmarks/smooth_gate_calibration.json.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELD_OUT = ("F-16Cockpit_SNR10", "DestroyerEngine_SNR0", "Pink_SNR-5")


def main() -> int:
    from tpu_se.dsp import wav_to_lps
    from tpu_se.infer.decode import (
        SM_AUTO_D0, SM_AUTO_D1, SM_AUTO_S, _smooth_auto_strength,
        smooth_dyn_statistic,
    )
    from tpu_se.io import read_wav

    demo = "/root/reference/Enh_demos"
    conds = sorted({f.split("_NOISY_")[0] for f in os.listdir(demo)
                    if "_NOISY_" in f})
    rows = []
    for cond in conds:
        nw = glob.glob(os.path.join(demo, f"{cond}_NOISY_*.wav"))[0]
        noisy, _ = read_wav(nw)
        lps = np.asarray(wav_to_lps(noisy.astype(np.float32)))
        dyn = smooth_dyn_statistic(lps)   # THE gate statistic, not a copy
        rows.append({"condition": cond, "held_out": cond in HELD_OUT,
                     "dyn_mean_abs_delta_db": round(dyn, 3),
                     "auto_strength": round(_smooth_auto_strength(lps), 3)})
        print(f"{cond:<26} {'HELD-OUT ' if cond in HELD_OUT else '         '}"
              f"dyn={dyn:5.2f}  s_auto={rows[-1]['auto_strength']}")

    out = os.path.join(REPO, "benchmarks", "smooth_gate_calibration.json")
    with open(out, "w") as f:
        json.dump({"constants": {"SM_AUTO_S": SM_AUTO_S,
                                 "SM_AUTO_D0": SM_AUTO_D0,
                                 "SM_AUTO_D1": SM_AUTO_D1},
                   "rows": rows}, f, indent=1)
    print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

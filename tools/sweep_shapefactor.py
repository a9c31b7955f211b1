#!/usr/bin/env python
"""Shapefactor (β) sweep over the ML-GGD objective.

NOTE (round 4): for the full held-out-quality β sweep (SegSNR/LSD/STOI/
PESQ per condition, multi-seed), use `tools/ab_objectives.py --arms
MLGGD05,MLGGD09,MLGGD1,MLGGD15,MLGGD2,MMSE` instead — it shares the
corpus/training/scoring/resume infrastructure and produced
`artifacts/ab_objectives/big_pt8/BETA_SWEEP.md`.  This tool remains the
quick CV-metric-only sweep on a pfile shard.

Trains the reference topology on a pfile shard once per β in
{0.5, 1.0, 1.5, 2.0} (the GGD shape factors studied in the paper,
``README.md:97-107``; β=2 ≡ MMSE, β=1 ≡ LAD) in both ML-GGD and plain
β-norm modes, then prints the final CV metric table.  Defaults to the
bundled 10-sentence shard (the reference's de-facto smoke set,
SURVEY.md §4) and a short schedule so the sweep runs in minutes on CPU;
point --fea-file/--targ-file at a full TIMIT+NOISEX pfile for the real
experiment.

Usage:
  JAX_PLATFORMS=cpu python tools/sweep_shapefactor.py \
      [--epochs 10] [--betas 0.5,1,1.5,2] [--ml-only] [--markdown]
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, __file__.rsplit("/", 2)[0])

REF = "/root/reference/tools_pfile"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fea-file", default=f"{REF}/train_noisy.pfile")
    ap.add_argument("--targ-file", default=f"{REF}/train_clean.pfile")
    ap.add_argument("--norm-file", default=f"{REF}/train_noisy.norm")
    ap.add_argument("--betas", default="0.5,1,1.5,2")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--layersizes", default="1799,512,512,512,257",
                    help="smaller-than-flagship default so the CPU sweep "
                         "is quick; use 1799,2048,2048,2048,257 on a GPU")
    ap.add_argument("--ml-only", action="store_true",
                    help="sweep only the ML-GGD objective (skip β-norm)")
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()

    from tpu_se.data import PfilePairDataset
    from tpu_se.train import TrainConfig, run_training
    from tpu_se.train.checkpoint import load_checkpoint
    from tpu_se.train.loop import evaluate_cv

    betas = [float(b) for b in args.betas.split(",")]
    layersizes = tuple(int(x) for x in args.layersizes.split(","))
    root = args.out_dir or tempfile.mkdtemp(prefix="sweep_beta_")

    modes = [("ml_ggd", True)] if args.ml_only else [
        ("ml_ggd", True), ("beta_norm", False)]
    rows = []
    for mode_name, ml in modes:
        for beta in betas:
            out_dir = os.path.join(root, f"{mode_name}_beta{beta:g}")
            cfg = TrainConfig(
                fea_file=args.fea_file, targ_file=args.targ_file,
                norm_file=args.norm_file, out_dir=out_dir,
                layersizes=layersizes, ml_flag=ml, shapefactor=beta,
                epochs=args.epochs)
            last = {}

            def log(msg, _last=last):
                if isinstance(msg, dict):
                    _last.update(msg)

            run_training(cfg, log=log)
            row = {"mode": mode_name, "beta": beta,
                   "cv_sq_err": last.get("cv_squared_error"),
                   "cv_abs_err": last.get("cv_abs_error"),
                   "cv_ggd_ll": last.get("cv_ggd_loglik")}
            rows.append(row)
            print(f"# done {mode_name} beta={beta:g}: {row}",
                  file=sys.stderr)

    if args.markdown:
        print("| objective | β | CV sq err | CV abs err | CV GGD ll |")
        print("|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['mode']} | {r['beta']:g} | {r['cv_sq_err']:.1f} "
                  f"| {r['cv_abs_err']:.1f} | {r['cv_ggd_ll']:.1f} |")
    else:
        for r in rows:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())

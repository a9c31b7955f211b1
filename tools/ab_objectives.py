#!/usr/bin/env python
"""A/B: MMSE (beta=2) vs ML-GGD (beta=1) models trained BY THIS FRAMEWORK.

Closes the training-quality loop the reference paper claims
(``README.md:155-158``: ML-GGD-trained enhancement beats MMSE on
perceptual metrics): both objectives are trained on the same demo corpus
with IDENTICAL init seed, schedule, topology and data
(``finetune.pl:25-26`` MLflag/shapefactor being the only difference), the
held-out conditions are decoded with each, and the SegSNR/LSD/STOI/PESQ
table is written to artifacts/ab_objectives/{AB.md,AB.json}.

Two corpus modes (written to <workdir>/<corpus>/):

- ``--corpus small``: the 11 raw train pairs (9 train + 2 CV, ~2k frames)
  — fast smoke-scale A/B; heavily data-starved.
- ``--corpus big`` (default, round 3): the remix recipe scaled ~17x — 11
  clean sentences (incl. the 2 unused ``Feature_prepare/data`` TIMIT wavs)
  x 12 speed-perturbation factors (0.75..1.31) x 11 extracted noise tracks
  x SNR {-5..30 step 5} (random circular offsets, 50% reversal, +/-2.5 dB
  SNR jitter, 30% two-noise cocktails, shuffled utterance order) = 11616
  mixtures / ~2.0M train frames.  The SNR grid up to quasi-clean 30 dB
  teaches near-identity at high SNR; speed perturbation is what makes the
  models generalize to held-out speakers (measured: without it they
  memorize the 11 train sentences).  Doubling variants/cocktails to 3M
  frames was measured flat-to-worse — this recipe is the committed one.
- ``--corpus remix``: the demo pairs are sample-aligned additive
  mixtures (residual noisy-clean is uncorrelated with clean and matches
  the labeled SNR), so the 11 train-condition noise tracks are extracted
  and remixed over the 11 train clean sentences at SNR {-5,0,5,10} ->
  ~495 utterances / ~90k frames, with the held-out noise types AND
  held-out sentences excluded from training.  CV = the 11 original real
  pairs.  This is the same multi-condition recipe the paper trains with,
  scaled to the data actually shipped in the repo.

Every stage skips if its outputs exist, so the script is safely re-runnable
in bounded time slices, mirroring
the reference's resume-by-existence (``finetune.pl:49``).

Usage: python tools/ab_objectives.py [workdir] [--epochs 50]
       [--corpus remix|small]   (re-run until it prints the final table)
"""

import argparse
import glob
import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

REFERENCE = "/root/reference"
# Three held-out conditions spanning SNR -5..10 dB and noise character
# (tonal cockpit, broadband engine, pink); the other 11 are train (9) + CV (2).
HELD_OUT = ("F-16Cockpit_SNR10", "DestroyerEngine_SNR0", "Pink_SNR-5")

# Arm catalog: name -> (ml_flag, shapefactor).  The default A/B trains
# DEFAULT_ARMS; --arms selects others (e.g. the beta sweep for the paper's
# PESQ-ordering question, README.md:155-158).
ARM_CATALOG = {
    "MMSE": (False, 2.0),     # classic beta-norm beta=2 (MLflag=0)
    "MLGGD1": (True, 1.0),    # ML-GGD beta=1 (finetune.pl:25-26 defaults)
    "MLGGD09": (True, 0.9),   # ML-GGD beta=0.9 — the paper's optimum and
                              # the config behind the shipped ML demo wavs
    "MLGGD05": (True, 0.5),   # beta sweep points (paper README.md:97-107)
    "MLGGD15": (True, 1.5),
    "MLGGD2": (True, 2.0),
}
DEFAULT_ARMS = ("MMSE", "MLGGD1", "MLGGD09")

# Decode-side variants scored for every arm: the reference vocoder's own
# residual-noise options (compile-time POSTPROCESS / SMOOTHPROCESS,
# LogSpec2Wav.c:72-79,497-546,655-679) — the max-suppression floor is the
# reference's lever against exactly the high-SNR over-suppression that
# costs SegSNR on quasi-clean conditions.
DECODE_VARIANTS = {
    "": {},                                       # plain decode.m path
    "+pp": {"postprocess": True},
    "+sm": {"smooth": True},
    "+pp+sm": {"postprocess": True, "smooth": True},
    # tpu_se's suppression-depth limiter (no reference analog): give back
    # half of every bin's gain-in-dB.  Measured round 4: recovers the
    # high-SNR SegSNR/STOI regressions while keeping most low-SNR gains.
    "+bl": {"blend": 0.5},
    "+bl+sm": {"blend": 0.5, "smooth": True},
    # adaptive limiter: lam from the model's own per-utterance suppression
    # (BLEND_AUTO_* map in infer/decode.py, calibrated on the non-held-out
    # conditions only).
    "+abl": {"blend": "auto"},
    # round-5 quality config: adaptive limiter + impulsiveness-gated
    # fractional smoothing — improves all four metrics on 14/14 demo
    # conditions for both ML arms x 3 seeds (PARITY.md §4,
    # ENH_TABLE_auto_smauto*.md).
    "+abl+asm": {"blend": "auto", "smooth_strength": "auto"},
}


SNRS = (-5.0, 0.0, 5.0, 10.0)

# --corpus big (round 3): the data-starvation fix the round-2 verdict
# prescribes.  Same extracted-noise remix idea, scaled ~15x:
# - clean material: the 10 unique train-condition TIMIT sentences PLUS the
#   2 unused wavs in Feature_prepare/data (TEST_DR8_MPAM0_*).
# - SNR grid widened to 25 dB so the model sees quasi-clean input and
#   learns near-identity there (the round-2 models degraded the high-SNR
#   held-out condition);
# - per (sentence x noise x SNR): BIG_VARIANTS mixtures, each with a random
#   circular offset into the noise track, 50% time-reversed noise, and a
#   +/-2.5 dB noise-gain jitter around the grid SNR (continuous SNR
#   coverage).
# 11 sentences x 12 speeds x 11 noises x 8 SNRs x 1 variant = 11616
# mixtures, ~2.0M train frames (vs 484 / ~90k in --corpus remix).
BIG_SNRS = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0, 25.0, 30.0)
BIG_VARIANTS = 1
BIG_SNR_JITTER = 2.5
# Fraction of mixtures whose noise is an equal-power cocktail of two
# tracks: the held-out noise TYPES are unseen, so composite noises widen
# the noise manifold the model generalizes over.
BIG_COCKTAIL = 0.3
# Speed perturbation (resampling) of the clean sentences: shifts pitch,
# formants and rate together, i.e. manufactures new speaker-like variants
# from the ~40 s of unique demo speech.  Round-3 measurement: without it,
# 50 epochs x 616 repeats per sentence memorize the 11 train speakers
# (CV-on-train-sentences sq 13k while held-out-sentence STOI collapses to
# 0.54); speech diversity, not noise diversity, is the binding constraint.
BIG_SPEEDS = (0.75, 0.8, 0.85, 0.9, 0.95, 1.0, 1.04, 1.09, 1.14,
              1.19, 1.25, 1.31)
EXTRA_CLEAN = ("Feature_prepare/data/TEST_DR8_MPAM0_SX289.wav",
               "Feature_prepare/data/TEST_DR8_MPAM0_SX379.wav")


def _demo_pairs():
    demo_dir = os.path.join(REFERENCE, "Enh_demos")
    noisy_wavs = sorted(glob.glob(os.path.join(demo_dir, "*_NOISY_*.wav")))
    pairs = []
    for nw in noisy_wavs:
        cw = re.sub(r"_NOISY_", "_CLEAN_", nw)[:-4] + ".WAV"
        if os.path.exists(cw):
            pairs.append((nw, cw))
    train_pairs = [(n, c) for n, c in pairs
                   if not any(h in n for h in HELD_OUT)]
    test_pairs = [(n, c) for n, c in pairs if any(h in n for h in HELD_OUT)]
    return train_pairs, test_pairs


def build_corpus(work: str, corpus: str, speeds=BIG_SPEEDS,
                 passthrough: int = 0, extra_snrs: tuple = ()):
    """Write pfiles + norm under <work>/data; return cfg pieces.

    Returns (noisy_pfile, clean_pfile, norm_file, train_range, cv_range,
    test_pairs).
    """
    from tpu_se.dsp import wav_to_lps
    from tpu_se.io import read_wav, write_pfile, write_norm
    from tpu_se.io.norm import compute_norm
    from tpu_se.io.pfile import read_pfile

    train_pairs, test_pairs = _demo_pairs()
    data_dir = os.path.join(work, "data")
    os.makedirs(data_dir, exist_ok=True)
    noisy_pfile = os.path.join(data_dir, "train_noisy.pfile")
    clean_pfile = os.path.join(data_dir, "train_clean.pfile")
    norm_file = os.path.join(data_dir, "train_noisy.norm")
    meta_file = os.path.join(data_dir, "meta.json")

    if not os.path.exists(meta_file):
        # Aligned waveforms per train pair.
        waves = []
        for nw, cw in train_pairs:
            n, _ = read_wav(nw)
            c, _ = read_wav(cw)
            t = min(len(n), len(c))
            waves.append((n[:t].astype(np.float32),
                          c[:t].astype(np.float32)))
        if corpus == "small":
            mixtures = [(n, c) for n, c in waves]
        elif corpus == "big":
            noises = [n - c for n, c in waves]
            # Unique clean sentences (conditions share sentences) + the two
            # unused Feature_prepare TIMIT wavs.
            cleans, seen = [], set()
            for (nw, _), (_, c) in zip(train_pairs, waves):
                sent = os.path.basename(nw).split("_NOISY_")[1]
                if sent not in seen:
                    seen.add(sent)
                    cleans.append(c)
            for rel in EXTRA_CLEAN:
                w, sr = read_wav(os.path.join(REFERENCE, rel))
                assert sr == 16000
                cleans.append(w.astype(np.float32))

            def resample(x, f):
                n = int(len(x) / f)
                return np.interp(np.arange(n) * f,
                                 np.arange(len(x), dtype=np.float64),
                                 x).astype(np.float32)

            cleans = [resample(c, f) if f != 1.0 else c
                      for c in cleans for f in speeds]
            rng = np.random.default_rng(12345)

            def noise_segment(nz, length):
                """Random circular offset + 50% reversal, tiled/cropped to
                ``length``, normalized to unit power."""
                if rng.random() < 0.5:
                    nz = nz[::-1]
                nz = np.roll(nz, int(rng.integers(len(nz))))
                nz = (np.tile(nz, length // len(nz) + 1)[:length]
                      if len(nz) < length else nz[:length])
                return nz / np.sqrt(float(np.mean(nz ** 2)) + 1e-12)

            mixtures = []
            for c in cleans:
                p_c = float(np.mean(c ** 2)) + 1e-12
                for noise in noises:
                    for snr in BIG_SNRS + tuple(extra_snrs):
                        for k in range(BIG_VARIANTS):
                            nz = noise_segment(noise, len(c))
                            if rng.random() < BIG_COCKTAIL:
                                other = noises[int(rng.integers(len(noises)))]
                                nz = (nz + noise_segment(other, len(c))) \
                                    / np.sqrt(2.0)
                            s = snr + float(rng.uniform(-BIG_SNR_JITTER,
                                                        BIG_SNR_JITTER))
                            g = np.sqrt(p_c / 10.0 ** (s / 10.0))
                            mixtures.append((c + np.float32(g) * nz, c))
            # Clean-passthrough pairs (SNR = inf, beyond the 30 dB grid
            # cap): noisy IS clean, teaching exact identity on quasi-clean
            # input — the round-3 models over-suppressed the high-SNR
            # held-out condition (F-16 SNR10 SegSNR/STOI regressed), and
            # a 30 dB cap still leaves a visible noise floor to "enhance".
            for c in cleans:
                for _ in range(passthrough):
                    mixtures.append((c, c))
            # Shuffle the utterance ORDER: the trainer's shuffle is
            # chunk-local (reference parity, Interface.cc:588-650), and a
            # traincache chunk holds ~616 consecutive mixtures — written
            # in build order that is ONE clean sentence per chunk, which
            # destabilizes training (measured: CV oscillates 2-4x between
            # epochs and ML-GGD held-out STOI collapses).  Interleaving
            # sentences/noises/SNRs across chunks is what the reference's
            # own data prep gets from its shuffled 100-hour scp.
            rng.shuffle(mixtures)
            mixtures += [(n, c) for n, c in waves]      # CV block
        else:
            # Extract the 11 train-condition noise tracks and remix every
            # train clean sentence with every noise at each SNR; the 11
            # original real pairs go last as the CV block.
            noises = [n - c for n, c in waves]
            cleans = [c for _, c in waves]
            mixtures = []
            for c in cleans:
                p_c = float(np.mean(c ** 2)) + 1e-12
                for noise in noises:
                    nz = (np.tile(noise, len(c) // len(noise) + 1)[:len(c)]
                          if len(noise) < len(c) else noise[:len(c)])
                    p_n = float(np.mean(nz ** 2)) + 1e-12
                    for snr in SNRS:
                        g = np.sqrt(p_c / (p_n * 10.0 ** (snr / 10.0)))
                        mixtures.append((c + np.float32(g) * nz, c))
            mixtures += [(n, c) for n, c in waves]      # CV block
        noisy_utts, clean_utts = [], []
        clean_lps_cache = {}      # keyed by the clean array's identity —
        for mix, c in mixtures:   # every mixture reuses one of 11 arrays
            n_lps = np.asarray(wav_to_lps(mix))
            key = id(c)
            if key not in clean_lps_cache:
                clean_lps_cache[key] = np.asarray(wav_to_lps(c))
            c_lps = clean_lps_cache[key]
            t = min(len(n_lps), len(c_lps))
            noisy_utts.append(n_lps[:t])
            clean_utts.append(c_lps[:t])
        write_pfile(noisy_pfile, noisy_utts)
        write_pfile(clean_pfile, clean_utts)
        mean, inv_std = compute_norm(read_pfile(noisy_pfile).features)
        write_norm(norm_file, mean, inv_std)
        n_cv = 2 if corpus == "small" else len(train_pairs)
        meta = {"n_utts": len(mixtures), "n_cv": n_cv,
                "frames": int(sum(len(u) for u in noisy_utts))}
        with open(meta_file, "w") as f:
            json.dump(meta, f)
        print(f"corpus[{corpus}]: {meta['n_utts']} utts "
              f"({meta['frames']} frames), last {n_cv} = CV")
    meta = json.load(open(meta_file))
    n, n_cv = meta["n_utts"], meta["n_cv"]
    return (noisy_pfile, clean_pfile, norm_file,
            (0, n - n_cv - 1), (n - n_cv, n - 1), test_pairs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default="artifacts/ab_objectives")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--corpus", choices=("small", "remix", "big"),
                    default="big")
    ap.add_argument("--speeds", default=None,
                    help="comma-separated speed-perturbation factors "
                         "(default BIG_SPEEDS) - the speech-diversity "
                         "knob for --corpus big ablations")
    ap.add_argument("--build-only", action="store_true",
                    help="build the corpus pfiles and exit (the training "
                         "run then skips the build by existence)")
    ap.add_argument("--seed", type=int, default=0,
                    help="init-seed offset (0 = the reference default "
                         "27870775); nonzero runs land in s<seed>/ subdirs "
                         "and AB_s<seed>.{md,json} — for multi-seed "
                         "robustness of the ML-vs-MMSE ordering")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="training compute dtype (bfloat16 = the natural/"
                         "production perf config; arm labels get a _bf16 "
                         "suffix)")
    ap.add_argument("--dropout", action="store_true",
                    help="train the selected arms with the reference's "
                         "dropout (dropoutflag=1, visible_omit=hid_omit="
                         "0.1, finetune.pl:74-76); arm labels get a _do "
                         "suffix so runs don't collide")
    ap.add_argument("--extra-snrs", default="",
                    help="comma-separated extra SNR grid points appended "
                         "to BIG_SNRS (e.g. 35,40 — a denser quasi-clean "
                         "ladder); nonempty runs land in <dir>_x<list>/")
    ap.add_argument("--passthrough", type=int, default=0,
                    help="clean-passthrough copies per (sentence x speed) "
                         "added to --corpus big (SNR = inf pairs; the "
                         "round-4 high-SNR over-suppression fix). "
                         "Nonzero runs land in <corpus>_pt<N>/")
    ap.add_argument("--arms", default=",".join(DEFAULT_ARMS),
                    help="comma-separated arm names from the catalog: "
                         + ",".join(ARM_CATALOG))
    ap.add_argument("--variants", default="_,+pp",
                    help="comma-separated decode variants to score "
                         "('_' = plain; options: " +
                         ",".join(v for v in DECODE_VARIANTS if v) + ")")
    ap.add_argument("--tag", default="",
                    help="suffix for the AB output name (AB<tag>[_sN])")
    args = ap.parse_args()

    from tpu_se.utils.cache import setup_compilation_cache

    setup_compilation_cache()

    from tpu_se.infer import decode_files
    from tpu_se.infer.stoi import stoi, pesq_score
    from tpu_se.io import read_wav
    from tpu_se.train import TrainConfig, run_training

    corpus_dir = (f"{args.corpus}_pt{args.passthrough}" if args.passthrough
                  else args.corpus)
    extra_snrs = (tuple(float(s) for s in args.extra_snrs.split(","))
                  if args.extra_snrs else ())
    if extra_snrs:
        corpus_dir += "_x" + args.extra_snrs.replace(",", "_")
    work = os.path.join(args.workdir, corpus_dir)
    os.makedirs(work, exist_ok=True)
    speeds = (tuple(float(s) for s in args.speeds.split(","))
              if args.speeds else BIG_SPEEDS)
    noisy_pfile, clean_pfile, norm_file, train_range, cv_range, test_pairs \
        = build_corpus(work, args.corpus, speeds, args.passthrough,
                       extra_snrs)
    if args.build_only:
        print("corpus built; exiting (--build-only)")
        return 0

    arms = {}
    for name in args.arms.split(","):
        name = name.strip()
        if name not in ARM_CATALOG:
            ap.error(f"unknown arm {name!r} (catalog: {list(ARM_CATALOG)})")
        suffix = ("_do" if args.dropout else "") + (
            "_bf16" if args.compute_dtype == "bfloat16" else "")
        arms[name + suffix] = ARM_CATALOG[name]
    variants = {}
    for v in args.variants.split(","):
        v = "" if v.strip() in ("", "_") else v.strip()
        if v not in DECODE_VARIANTS:
            ap.error(f"unknown variant {v!r} "
                     f"(options: {list(DECODE_VARIANTS)})")
        variants[v] = DECODE_VARIANTS[v]

    # ---- train all arms (identical seed/schedule; resume-by-existence) ----
    arm_root = os.path.join(work, f"s{args.seed}") if args.seed else work
    final = {}
    for arm, (ml, beta) in arms.items():
        cfg = TrainConfig(
            fea_file=noisy_pfile, targ_file=clean_pfile, norm_file=norm_file,
            out_dir=os.path.join(arm_root, arm),
            ml_flag=ml, shapefactor=beta, epochs=args.epochs,
            dropout_flag=args.dropout, compute_dtype=args.compute_dtype,
            train_sent_range=train_range, cv_sent_range=cv_range,
            # the 3M-frame corpus spans ~6.2 GB normalized (noisy+clean);
            # keep it device-resident instead of falling back to
            # per-chunk uploads
            device_resident_max_bytes=10 << 30,
        )
        if args.seed:
            cfg.init_seed += args.seed
        final[arm] = run_training(cfg)
        print(f"{arm}: {final[arm]}")

    # ---- decode held-out conditions: each arm x each decode variant -------
    noisy_list = [n for n, _ in test_pairs]
    clean_list = [c for _, c in test_pairs]
    decoded = {}                     # system name -> decode_files results
    for arm in arms:
        for vname, vkw in variants.items():
            out_dir = os.path.join(arm_root, "enhanced",
                                   arm + vname.replace("+", "_"))
            decoded[arm + vname] = decode_files(
                final[arm], norm_file, noisy_list, out_dir, clean_list,
                **vkw)

    # ---- score: SegSNR/LSD (from decode) + STOI + PESQ ---------------------
    rows = []
    sys0 = next(iter(decoded))       # noisy baseline identical across systems
    for i, (nw, cw) in enumerate(test_pairs):
        clean, fs = read_wav(cw)
        noisy, _ = read_wav(nw)
        cond = os.path.basename(nw).split("_NOISY_")[0]
        row = {"condition": cond,
               "noisy": {"segsnr": decoded[sys0][i]["segsnr_noisy"],
                         "lsd": decoded[sys0][i]["lsd_noisy"],
                         "stoi": round(stoi(clean, noisy, fs), 4),
                         "pesq": round(pesq_score(clean, noisy, fs), 3)}}
        for name, results in decoded.items():
            r = results[i]
            enh, _ = read_wav(r["out"])
            c = clean[:len(enh)]
            row[name] = {"segsnr": r["segsnr"], "lsd": r["lsd"],
                         "stoi": round(stoi(c, enh, fs), 4),
                         "pesq": round(pesq_score(c, enh, fs), 3)}
        rows.append(row)

    systems = ["noisy"] + list(decoded)
    means = {s: {m: round(float(np.mean([r[s][m] for r in rows])), 3)
                 for m in ("segsnr", "lsd", "stoi", "pesq")}
             for s in systems}
    record = {"held_out": list(HELD_OUT), "epochs": args.epochs,
              "corpus": args.corpus, "passthrough": args.passthrough,
              "seed_offset": args.seed,
              "decode_variants": list(variants),
              "arms": {a: {"ml_flag": arms[a][0], "shapefactor": arms[a][1]}
                       for a in arms},
              "per_condition": rows, "mean": means}
    ab_name = "AB" + args.tag + (f"_s{args.seed}" if args.seed else "")
    with open(os.path.join(work, ab_name + ".json"), "w") as f:
        json.dump(record, f, indent=1)

    speeds_note = ("" if speeds == BIG_SPEEDS else
                   f" [speeds override: {','.join(str(s) for s in speeds)}]")
    if args.passthrough:
        speeds_note += (f" + {args.passthrough} clean-passthrough copies "
                        "per (sentence x speed) (SNR = inf identity pairs)")
    corpus_desc = {
        "small": "11 raw Enh_demos train conditions (9 train + 2 CV, ~2k "
                 "frames)",
        "remix": "484 remixed mixtures (11 extracted train-noise tracks x "
                 "11 train clean sentences x SNR {-5,0,5,10}) + the 11 real "
                 "pairs as CV (~90k frames); held-out noise types and "
                 "sentences excluded from training",
        "big": "11616 remixed mixtures (11 clean sentences incl. the 2 "
               "unused Feature_prepare TIMIT wavs x 12 speed factors "
               "0.75..1.31 x 11 extracted train-noise tracks x SNR "
               "{-5..30 step 5}, random circular offsets, 50% reversal, "
               "+/-2.5 dB SNR jitter, 30% two-noise cocktails, shuffled "
               "utterance order) + the 11 real pairs as CV (~2.0M "
               "frames); held-out noise types and sentences excluded",
    }[args.corpus] + speeds_note
    variants_note = ("" if list(variants) == [""] else
                     " Decode variants: +pp = the reference vocoder's "
                     "POSTPROCESS max-suppression floor, +sm = its "
                     "SMOOTHPROCESS running-min residual smoothing "
                     "(`LogSpec2Wav.c:72-79,497-546,655-679`).")
    lines = [
        "# MMSE vs ML-GGD A/B — models trained by tpu_se",
        "",
        f"All arms: identical init seed, {args.epochs}-epoch finetune.pl "
        "schedule, topology",
        "1799-2048x3-257, bunch 128, parity gradients; the ONLY difference "
        "is the objective",
        "(`MLflag`/`shapefactor`, `finetune.pl:25-26`). Train corpus: "
        f"{corpus_desc}.",
        f"Held out: {', '.join(HELD_OUT)}.{variants_note}",
        "", "## Held-out means", "",
        "| System | SegSNR (dB) | LSD (dB) | STOI | PESQ |",
        "|---|---|---|---|---|",
    ]
    for s in systems:
        m = means[s]
        lines.append(f"| {s} | {m['segsnr']:.2f} | {m['lsd']:.2f} | "
                     f"{m['stoi']:.3f} | {m['pesq']:.2f} |")
    lines += ["", "## Per condition", ""]
    for r in rows:
        lines.append(f"### {r['condition']}")
        lines.append("")
        lines.append("| System | SegSNR | LSD | STOI | PESQ |")
        lines.append("|---|---|---|---|---|")
        for s in systems:
            m = r[s]
            lines.append(f"| {s} | {m['segsnr']:.2f} | {m['lsd']:.2f} | "
                         f"{m['stoi']:.3f} | {m['pesq']:.2f} |")
        lines.append("")
    with open(os.path.join(work, ab_name + ".md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())

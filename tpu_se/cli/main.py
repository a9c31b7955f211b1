"""tpu_se command-line interface.

Commands (reference equivalents in parentheses):

- ``lps-extract``  (LPS_extract.m + Wav2LPS_be): wavs -> big-endian HTK .lps
- ``make-pfile``   (pfile_noisy.pl + feacat): .lps list -> pfile
- ``get-norm``     (get_norm.pl + qnnorm): pfile -> .norm
- ``gen-rand-net`` (Gen_rand_net): random-init .wts
- ``train``        (finetune.pl + BPtrain_Sigmoid): full epoch schedule
- ``bptrain``      (BPtrain_Sigmoid): drop-in key=value single-epoch shim
- ``decode``       (decode.m + LPS2Wav_be): noisy wavs -> enhanced wavs
- ``pfile-info``   (QuickNet pfile_info): inspect pfile headers/sentences
- ``wts-info``     inspect .wts weight files (shapes, stats)
- ``eval``         score wav pairs with SegSNR/LSD/STOI/PESQ
"""

from __future__ import annotations

import argparse
import os
import sys


def _read_scp(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def cmd_lps_extract(args) -> int:
    from tpu_se.dsp import wav_to_lps
    from tpu_se.io import read_wav, read_raw, write_htk
    from tpu_se.io.wav import read_htk_waveform

    wavs = _read_scp(args.scp) if args.scp else args.wav

    def one(path: str) -> str:
        if args.format == "RAW":
            wave = read_raw(path, swap=args.swap)
            sr = args.fs * 1000           # Wav2LogSpec_be.c:344-360
        elif args.format == "HTK":
            wave, sr = read_htk_waveform(path)
        else:   # WAV: RIFF or NIST sniffed by magic
            wave, sr = read_wav(path)
        lps = wav_to_lps(wave, win_size=args.win, sample_rate=sr)
        out = args.out if args.out and len(wavs) == 1 else (
            path.rsplit(".", 1)[0] + ".lps")
        # sampPeriod is 160000 for every rate, like the reference
        # (Wav2LogSpec_be.c:371 hardcodes it; the per-rate variant is
        # commented out there).
        write_htk(out, lps, samp_period=160000 * (2 * args.win + 1),
                  no_header=args.noh)
        return f"{path}: {lps.shape[0]} frames -> {out}"

    # --jobs: the reference packers fork across scp shards
    # (tools_pfile/pfile_noisy.pl:28-36, GetLenForFeaScp.pl:11-27); here a
    # thread pool suffices — numpy and the jit'd LPS kernel release the GIL,
    # and each wav writes an independent .lps.
    if args.jobs > 1 and len(wavs) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.jobs) as pool:
            for line in pool.map(one, wavs):
                print(line)
    else:
        for path in wavs:
            print(one(path))
    return 0


def cmd_make_pfile(args) -> int:
    """feacat equivalent: .lps list -> pfile.

    Streaming build (QuickNet's feacat memory model): one utterance resident
    at a time, appended through :class:`PfileWriter`; with ``--jobs`` the
    HTK reads run ahead on a thread pool while the writer consumes in scp
    order (the reference forks per scp shard, ``pfile_noisy.pl:28-36``).
    """
    from tpu_se.io import read_htk
    from tpu_se.io.pfile import PfileWriter
    from tpu_se.io.readahead import ordered_readahead

    paths = _read_scp(args.scp)
    desired = None
    if args.deslenfile:
        desired = [int(line) for line in _read_scp(args.deslenfile)]
        if len(desired) != len(paths):
            raise SystemExit("deslenfile/scp count mismatch")

    lengths = []
    with PfileWriter(args.out) as w:
        utts = ordered_readahead(paths, lambda p: read_htk(p)[0], args.jobs)
        for i, (p, u) in enumerate(zip(paths, utts)):
            t = u.shape[0]
            # GetLenForFeaScp.pl:57-67 warns on implausibly short/long
            # utterances (< 300 ms or > 30 s at the 16 ms frame shift).
            if t < 300 // 16:
                print(f"warning: {p}: only {t} frames (< 300 ms)",
                      file=sys.stderr)
            elif t > 30000 // 16:
                print(f"warning: {p}: {t} frames (> 30 s)",
                      file=sys.stderr)
            # --lenfile records the raw .lps frame count (pre-truncation),
            # like GetLenForFeaScp.pl:52 measuring the file itself.
            lengths.append(t)
            if desired is not None:
                u = u[:desired[i]]
            w.add(u)
        n_sents, n_frames = w.num_sentences, w.num_frames
    # Report only after close() committed the file (atomic rename): a
    # finalize failure must not leave a success line behind.
    print(f"{n_sents} sentences, {n_frames} frames -> {args.out}")
    if args.lenfile:
        with open(args.lenfile, "w") as f:
            for t in lengths:
                f.write(f"{t}\n")
    return 0


def cmd_concat_pfile(args) -> int:
    from tpu_se.io import concat_pfiles, read_pfile_meta

    concat_pfiles(args.out, args.pfile)
    n_sents, n_frames, dim, _ = read_pfile_meta(args.out)
    print(f"{n_sents} sentences, {n_frames} frames x {dim} -> {args.out}")
    return 0


def cmd_get_norm(args) -> int:
    from tpu_se.io import write_norm
    from tpu_se.io.norm import compute_norm_pfile
    from tpu_se.io.pfile import read_pfile_meta

    mean, inv_std = compute_norm_pfile(args.pfile)
    write_norm(args.out, mean, inv_std, with_headers=not args.no_headers)
    _, n_frames, dim, _ = read_pfile_meta(args.pfile)
    print(f"{n_frames} frames x {dim} dims -> {args.out}")
    return 0


def cmd_pfile_info(args) -> int:
    # QuickNet's pfile_info CLI (tools_pfile/tools/QN/atlas1/bin/): header
    # summary + optional per-sentence lengths, from the 32 KB ASCII header
    # and cumulative sentence tail (Interface.cc:519-585,988-1024).
    from tpu_se.io import read_pfile_meta

    for path in args.pfile:
        n_sents, n_frames, dim, ends = read_pfile_meta(path)
        print(f"{path}: {n_sents} sentences, {n_frames} frames, "
              f"{dim} features")
        if args.sents:
            import numpy as np

            lengths = np.diff(np.concatenate([[0], ends]))
            for i, t in enumerate(lengths):
                print(f"  sentence {i}: {t} frames")
    return 0


def cmd_wts_info(args) -> int:
    from tpu_se.io import read_wts

    for path in args.wts:
        layers = read_wts(path)
        total = 0
        print(path + ":")
        for i, layer in enumerate(layers):
            for key, name in (("w", f"weights{i+1}{i+2}"),
                              ("b", f"bias{i+2}")):
                data = layer[key].reshape(layer[key].shape[0], -1)
                total += data.size
                rms = float((data.astype("float64") ** 2).mean()) ** 0.5
                print(f"  {name:12s} [{' x '.join(map(str, layer[key].shape)):>12s}]"
                      f"  min {data.min():+.6f}  max {data.max():+.6f}"
                      f"  rms {rms:.6f}")
        print(f"  total: {total} parameters "
              f"({total * 4 / 1e6:.1f} MB float32)")
    return 0


def cmd_eval(args) -> int:
    import json

    from tpu_se.infer import score_files
    from tpu_se.infer.evaluate import METRICS

    cleans = _read_scp(args.clean_scp) if args.clean_scp else args.clean
    tests = _read_scp(args.test_scp) if args.test_scp else args.test
    if not cleans or not tests:
        raise SystemExit("eval: give matching --clean/--test wavs "
                         "(or --clean-scp/--test-scp lists)")
    try:
        rows = score_files(cleans, tests)
    except ValueError as e:
        raise SystemExit(f"eval: {e}")
    if args.json:
        for row in rows:
            print(json.dumps(row))
    else:
        print(f"{'file':40s} {'SegSNR':>8s} {'LSD':>8s} "
              f"{'STOI':>7s} {'PESQ':>6s}")
        for row in rows:
            name = os.path.basename(row["name"])
            print(f"{name:40s} {row['segsnr']:8.2f} {row['lsd']:8.2f} "
                  f"{row['stoi']:7.3f} {row['pesq']:6.2f}")
    if len(rows) > 1:
        mean = {m: sum(r[m] for r in rows) / len(rows) for m in METRICS}
        if args.json:
            print(json.dumps({"name": "mean", **mean}))
        else:
            print(f"{'mean':40s} {mean['segsnr']:8.2f} {mean['lsd']:8.2f} "
                  f"{mean['stoi']:7.3f} {mean['pesq']:6.2f}")
    return 0


def cmd_gen_rand_net(args) -> int:
    from tpu_se.io import write_wts
    from tpu_se.models import init_params, params_to_wts

    sizes = tuple(int(s) for s in args.layersizes.split(","))
    params = init_params(args.seed, sizes, flag=args.flag, beta=args.beta)
    write_wts(args.out, params_to_wts(params))
    print(f"layersizes {sizes} flag={args.flag} beta={args.beta} -> {args.out}")
    return 0


def cmd_train(args) -> int:
    from tpu_se.train import TrainConfig, run_training

    cfg = TrainConfig(
        fea_file=args.fea_file, targ_file=args.targ_file,
        norm_file=args.norm_file, init_wts_file=args.init_wts,
        out_dir=args.out_dir,
        layersizes=tuple(int(s) for s in args.layersizes.split(",")),
        bunchsize=args.bunchsize, ml_flag=bool(args.ml_flag),
        shapefactor=args.shapefactor, momentum=args.momentum,
        weightcost=args.weightcost, lrate=args.lrate,
        fea_dim=args.fea_dim, fea_context=args.fea_context,
        traincache=args.traincache, init_seed=args.seed,
        targ_offset=args.targ_offset,
        train_sent_range=tuple(int(s) for s in args.train_sents.split("-")),
        cv_sent_range=tuple(int(s) for s in args.cv_sents.split("-")),
        epochs=args.epochs, grad_scale=args.grad_scale,
        compute_dtype=args.compute_dtype,
        carry_velocity=args.carry_velocity,
        activation=args.activation,
        dropout_flag=bool(args.dropoutflag),
        visible_omit=args.visible_omit, hid_omit=args.hid_omit,
        checkpoint_every_chunks=args.checkpoint_every_chunks,
        coordinator=args.coordinator,
        num_processes=args.num_processes, process_id=args.process_id,
        cpu_collectives=args.cpu_collectives,
    )
    if args.init_ranges:
        vals = tuple(float(x) for x in args.init_ranges.split(","))
        if len(vals) != 4:
            raise SystemExit("--init-ranges wants w_min,w_max,b_min,b_max")
        cfg.init_ranges = vals
    # With --coordinator the mesh must be built AFTER jax.distributed init
    # (inside run_training) so it spans the global devices.
    if (args.mesh_data > 1 or args.mesh_model > 1) and not args.coordinator:
        from tpu_se.parallel import make_mesh
        cfg.mesh = make_mesh(args.mesh_data, args.mesh_model)
    last = run_training(cfg)
    print(f"final weights: {last}")
    return 0


def cmd_decode(args) -> int:
    wavs = _read_scp(args.scp) if args.scp else args.wav
    cleans = _read_scp(args.clean_scp) if args.clean_scp else None
    if args.stream:
        ignored = [name for name, val in (("--mesh-data", args.mesh_data > 1),
                                          ("--ni", args.ni),
                                          ("--batch", args.batch > 0),
                                          ("--clean-scp", cleans is not None),
                                          ("--postprocess", args.postprocess),
                                          # streaming uses each wav's header
                                          # rate, not the requested one
                                          ("-fs", args.fs != 16))
                   if val]
        if ignored:
            print(f"warning: --stream ignores {', '.join(ignored)}",
                  file=sys.stderr)
        import numpy as np

        from tpu_se.infer import StreamingEnhancer
        from tpu_se.io import read_wav, write_wav

        os.makedirs(args.out_dir, exist_ok=True)
        for path in wavs:
            noisy, sr = read_wav(path)
            ss = args.smooth_strength
            if ss is None and args.smooth:
                ss = 1.0          # binary smoothing, causal analog
            s = StreamingEnhancer(args.wts, args.norm, sample_rate=sr,
                                  blend=args.blend, smooth_strength=ss)
            pieces = []
            for i in range(0, len(noisy), args.stream):
                pieces.append(s.feed(noisy[i:i + args.stream]))
            pieces.append(s.flush())
            stem = os.path.splitext(os.path.basename(str(path)))[0]
            out_path = os.path.join(args.out_dir, stem + "_enhanced.wav")
            write_wav(out_path, np.concatenate(pieces), sr)
            print(f"{stem}: streamed ({args.stream}-sample chunks, "
                  f"{s.latency_samples / sr * 1e3:.0f} ms algorithmic "
                  f"latency) -> {out_path}")
        return 0
    from tpu_se.infer import decode_files

    mesh = None
    if args.mesh_data > 1:
        from tpu_se.parallel import make_mesh

        mesh = make_mesh(args.mesh_data, 1)
    sample_rate = {8: 8000, 11: 11025, 16: 16000}[args.fs]
    decode_files(args.wts, args.norm, wavs, args.out_dir, cleans, mesh=mesh,
                 noisy_info=args.ni, batch_size=args.batch,
                 postprocess=args.postprocess, smooth=args.smooth,
                 smooth_strength=args.smooth_strength,
                 sample_rate=sample_rate, blend=args.blend)
    return 0


def _blend_arg(text: str):
    return "auto" if text == "auto" else float(text)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_se", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("lps-extract", help="wav -> LPS features (HTK)")
    s.add_argument("wav", nargs="*", help="input wav files")
    s.add_argument("--scp", help="list file of wavs")
    s.add_argument("-F", "--format", default="WAV",
                   choices=["WAV", "RAW", "HTK", "NIST"])
    s.add_argument("-fs", type=int, default=16, choices=[8, 11, 16],
                   help="sampling rate in kHz for RAW inputs "
                        "(Wav2LPS_be -fs)")
    s.add_argument("--swap", action="store_true")
    s.add_argument("--win", type=int, default=0,
                   help="stack 2*win+1 frames per row (Wav2LPS_be -win)")
    s.add_argument("--jobs", type=int, default=1,
                   help="parallel workers over the scp "
                        "(pfile_noisy.pl:28-36 fork analog)")
    s.add_argument("--noh", action="store_true",
                   help="omit the HTK header on output (Wav2LPS_be -noh)")
    s.add_argument("-o", "--out", help="output path (single input only)")
    s.set_defaults(func=cmd_lps_extract)

    s = sub.add_parser("make-pfile", help=".lps list -> pfile")
    s.add_argument("scp")
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--jobs", type=int, default=1,
                   help="read-ahead workers (writer stays in scp order)")
    s.add_argument("--lenfile", help="also write frame_numbers.len")
    s.add_argument("--deslenfile",
                   help="truncate utterances to these lengths "
                        "(feacat -deslenfile)")
    s.set_defaults(func=cmd_make_pfile)

    s = sub.add_parser("concat-pfile", help="merge pfiles (pfile_concat)")
    s.add_argument("pfile", nargs="+")
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(func=cmd_concat_pfile)

    s = sub.add_parser("get-norm", help="pfile -> .norm stats")
    s.add_argument("pfile")
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--no-headers", action="store_true",
                   help="omit 'vec N' lines (Test_code variant)")
    s.set_defaults(func=cmd_get_norm)

    s = sub.add_parser("pfile-info", help="inspect pfiles (pfile_info)")
    s.add_argument("pfile", nargs="+")
    s.add_argument("--sents", action="store_true",
                   help="also print per-sentence frame counts")
    s.set_defaults(func=cmd_pfile_info)

    s = sub.add_parser("wts-info", help="inspect .wts weight files")
    s.add_argument("wts", nargs="+")
    s.set_defaults(func=cmd_wts_info)

    s = sub.add_parser("eval",
                       help="score (clean, test) wav pairs: "
                            "SegSNR/LSD/STOI/PESQ")
    s.add_argument("--clean", nargs="*", default=[])
    s.add_argument("--test", nargs="*", default=[])
    s.add_argument("--clean-scp")
    s.add_argument("--test-scp")
    s.add_argument("--json", action="store_true",
                   help="one JSON object per line instead of a table")
    s.set_defaults(func=cmd_eval)

    s = sub.add_parser("gen-rand-net", help="random-init .wts")
    s.add_argument("--layersizes", default="1799,2048,2048,2048,257")
    s.add_argument("--flag", type=int, default=1)
    s.add_argument("--beta", type=float, default=2.0)
    s.add_argument("--seed", type=int, default=27870775)
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(func=cmd_gen_rand_net)

    s = sub.add_parser("train", help="full training schedule")
    s.add_argument("--fea-file", required=True)
    s.add_argument("--targ-file", required=True)
    s.add_argument("--norm-file", required=True)
    s.add_argument("--init-wts", default="")
    s.add_argument("--out-dir", default="mlp_out")
    s.add_argument("--layersizes", default="1799,2048,2048,2048,257")
    s.add_argument("--bunchsize", type=int, default=128)
    s.add_argument("--ml-flag", type=int, default=1)
    s.add_argument("--shapefactor", type=float, default=1.0)
    s.add_argument("--momentum", type=float, default=0.9)
    s.add_argument("--weightcost", type=float, default=1e-5)
    s.add_argument("--lrate", type=float, default=0.1)
    s.add_argument("--fea-dim", type=int, default=257)
    s.add_argument("--fea-context", type=int, default=7)
    s.add_argument("--traincache", type=int, default=102400)
    s.add_argument("--seed", type=int, default=27870775)
    s.add_argument("--targ-offset", type=int, default=3)
    s.add_argument("--train-sents", default="0-7")
    s.add_argument("--cv-sents", default="8-9")
    s.add_argument("--epochs", type=int, default=50)
    s.add_argument("--grad-scale", default="parity",
                   choices=["parity", "natural"])
    s.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    s.add_argument("--carry-velocity", action="store_true")
    s.add_argument("--init-ranges", default="", metavar="W_MIN,W_MAX,B_MIN,B_MAX",
                   help="plain uniform random init when no --init-wts "
                        "(init_randem_* keys, Interface.cc:140-143); "
                        "reference defaults -0.1,0.1,-0.1,0.1")
    s.add_argument("--checkpoint-every-chunks", type=int, default=0,
                   help="write a mid-epoch partial checkpoint every N "
                        "chunks (0 = epoch-granular only, like the "
                        "reference)")
    s.add_argument("--activation", default="sigmoid",
                   choices=["sigmoid", "relu"])
    s.add_argument("--dropoutflag", type=int, default=0)
    s.add_argument("--visible-omit", type=float, default=0.1)
    s.add_argument("--hid-omit", type=float, default=0.1)
    s.add_argument("--mesh-data", type=int, default=1)
    s.add_argument("--mesh-model", type=int, default=1)
    s.add_argument("--coordinator", default="",
                   help="host:port of process 0 — joins a jax.distributed "
                        "multi-host cluster; the step then runs SPMD over "
                        "the global device mesh")
    s.add_argument("--num-processes", type=int, default=None)
    s.add_argument("--process-id", type=int, default=None)
    s.add_argument("--cpu-collectives", default="",
                   help="'gloo' for multi-process CPU runs (tests); "
                        "GPUs use NCCL without it")
    s.set_defaults(func=cmd_train)

    s = sub.add_parser("decode", help="noisy wavs -> enhanced wavs")
    s.add_argument("wav", nargs="*")
    s.add_argument("--scp")
    s.add_argument("--clean-scp", help="matching clean wavs for SegSNR/LSD")
    s.add_argument("--wts", required=True)
    s.add_argument("--norm", required=True)
    s.add_argument("--out-dir", default="enhanced")
    s.add_argument("--stream", type=int, default=0, metavar="CHUNK",
                   help="stream in CHUNK-sample pieces through the "
                        "low-latency engine instead of batch decode")
    s.add_argument("--mesh-data", type=int, default=1,
                   help="shard the frame axis across this many devices "
                        "(data-parallel batch decode)")
    s.add_argument("--ni", action="store_true",
                   help="also write noisy-baseline SegSNR/LSD to a "
                        "separate <input-name>.info file in --out-dir "
                        "(LPS2Wav_be -ni writes it beside the input; "
                        "we keep the filename, relocate to out-dir)")
    s.add_argument("--batch", type=int, default=0,
                   help="decode this many utterances per device program "
                        "(amortizes dispatch/transfer overhead)")
    s.add_argument("--postprocess", action="store_true",
                   help="bound max suppression vs the noisy LPS "
                        "(LogSpec2Wav_be POSTPROCESS build, "
                        "LogSpec2Wav.c:655-679)")
    s.add_argument("--smooth", action="store_true",
                   help="residual-noise running-min smoothing "
                        "(LogSpec2Wav_be SMOOTHPROCESS build, "
                        "LogSpec2Wav.c:497-546)")
    s.add_argument("--smooth-strength", type=_blend_arg, default=None,
                   help="fractional smoothing: power mix between plain "
                        "and smoothed spectra (1.0 = the reference's "
                        "binary option, 0 = off), or 'auto' for the "
                        "impulsiveness-gated strength — with --blend auto "
                        "this passes all four metrics on all 14 demo "
                        "conditions (tpu_se extension; any non-zero "
                        "strength implies --smooth)")
    s.add_argument("--blend", type=_blend_arg, default=0.0,
                   help="suppression-depth limiter: interpolate the "
                        "enhanced LPS this fraction toward the noisy LPS "
                        "(log domain; 0 = reference decode.m path), or "
                        "'auto' to adapt per utterance from the model's "
                        "own suppression (passes all 14 demo conditions "
                        "on every trained arm — tpu_se extension, no "
                        "reference analog)")
    s.add_argument("-fs", type=int, default=16, choices=[8, 11, 16],
                   help="sampling rate in kHz — the model's bin count "
                        "must match (129/129/257)")
    s.set_defaults(func=cmd_decode)
    return p


def main(argv=None) -> int:
    from tpu_se.utils.cache import setup_compilation_cache

    raw = sys.argv[1:] if argv is None else list(argv)
    setup_compilation_cache()
    if raw and raw[0] == "bptrain":
        # Drop-in BPtrain_Sigmoid front-end: key=value argument strings
        # (Interface.cc:150-315), bypassing argparse entirely so a
        # finetune.pl-style driver works by swapping the binary name.
        from tpu_se.cli.bptrain import main as bptrain_main
        return bptrain_main(raw[1:])
    args = build_parser().parse_args(raw)
    try:
        return args.func(args)
    except BrokenPipeError:
        # downstream pipe (e.g. ``| head``) closed early — not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Smoke test of tpu_se on NVIDIA GPUs: the main path, end to end, at full width.

One process drives every phase through the entry points a user calls
(``tpu_se.cli.main.main(argv)`` in-process, and the library API) at the
reference model's widths, 1799-2048x3-257:

0. device: the card's name and power limit (``nvidia-smi``), the JAX
   version, device kind and count, and the memory JAX may use.  Without a
   GPU the script exits 2 and prints no result; there is no CPU fallback.
1. native loader: ``make -B -C native``, then the C++ chunk loader against
   the numpy path on a seeded pfile pair.
2. corpus from ``--seed``: speech-like clean/noisy 16 kHz wav pairs through
   ``lps-extract``, ``make-pfile`` and ``get-norm``, at least one full
   default traincache chunk (102,400 windows) of training data.
3. DSP: the analysis GEMM (``lps_from_frames``) and the streaming
   inverse-DFT GEMM against float64 ``np.fft``.
4. train: 2 parity epochs (M=128, float32, ML-GGD beta=1), 1 natural epoch
   (M=4096, bfloat16, ``--grad-scale natural``), one ``train_chunk``
   against the float64 numpy reference, the step's memory analysis, and a
   mid-epoch kill/resume.
5. decode: batch decode against a float64 numpy decode, the int16 wave
   path against ``enhance_batch``, streaming against batch, the quality
   config, and the int16 conversion of out-of-range samples.
6. two off-path ops timed once as XLA compiles them, from a profiler
   trace: ``lps_from_frames`` and ``output_grad_and_alpha``.
7. ``--four`` (that phase alone): every multi-device path that
   ``__graft_entry__.dryrun_multichip`` checks, at full width on four GPUs.

Each comparison prints its max error beside its tolerance and precision;
every timing line names the card and its power limit.  A failed check
raises, so the script exits non-zero and prints no result; so does a stall
(no line printed for ``STALL_S`` seconds), after dumping every thread's
traceback.  The last line
of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage:
    python chip_smoke.py [--seed N]           # one GPU
    python chip_smoke.py --four [--seed N]    # four GPUs
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SAMPLE_RATE = 16000
# A hung collective or compile must fail the run, not hold the cards until
# an outer limit: when no line has been printed for this many seconds,
# every thread's traceback is printed and the process exits 1.  On an H100
# the longest gap between two lines was ~35 s (corpus synthesis) on one
# card and ~13 s (the first mesh) on four.
STALL_S = {"one": 600, "four": 120}
_stall_s = None


class NoGPU(RuntimeError):
    """JAX found no GPU."""


class SimulatedCrash(Exception):
    """Raised inside the trainer to kill a run mid-epoch."""


@dataclass(frozen=True)
class Sizes:
    """Every size the smoke runs at.  ``FULL`` is what ``main`` runs."""

    layersizes: str = "1799,2048,2048,2048,257"
    traincache: int = 102400       # the CLI's default chunk
    bunch: int = 128               # parity bunch size
    natural_bunch: int = 4096
    secs: tuple = (4.0, 11.0)      # utterance durations
    n_cv: int = 24
    dsp_frames: int = 4096
    ref_bunches: int = 3           # train_chunk vs the numpy reference
    decode_utts: int = 16
    stream_utts: int = 4


FULL = Sizes()


def say(*parts) -> None:
    print(*parts, flush=True)
    if _stall_s:
        faulthandler.dump_traceback_later(_stall_s, exit=True,
                                          file=sys.__stderr__)


# --- phase 0: device --------------------------------------------------------

def gpu_devices():
    """``jax.devices()`` when they are GPUs; raises :class:`NoGPU` otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise NoGPU(f"JAX found no GPU (platform {devices[0].platform!r})")
    return devices


def card_label() -> str:
    """The cards' name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [line.strip() for line in out.splitlines() if line.strip()]
    return " | ".join(dict.fromkeys(lines))


def phase_device(devices, card: str) -> None:
    import jax

    say(card)
    say(f"jax {jax.__version__}; device_kind {devices[0].device_kind}; "
        f"{len(devices)} device(s); bytes_limit "
        f"{devices[0].memory_stats()['bytes_limit']}")


# --- phase 1: native loader -------------------------------------------------

def phase_native(work: str, seed: int) -> None:
    subprocess.run(["make", "-B", "-C", os.path.join(REPO, "native")],
                   check=True, capture_output=True, text=True)
    from tpu_se.data import PfilePairDataset
    from tpu_se.io import native
    from tpu_se.reference import seeded_pfiles

    if not native.available():
        raise RuntimeError("native/libtpuse_native.so did not load")
    noisy, clean, norm = seeded_pfiles(os.path.join(work, "native"), seed)
    args = (noisy, clean, norm, (0, 63))
    ds_c = PfilePairDataset(*args, traincache=8192, use_native=True)
    ds_p = PfilePairDataset(*args, traincache=8192, use_native=False)
    err = 0.0
    for ci in range(ds_c.n_chunks):
        a, b = ds_c.chunk(ci), ds_p.chunk(ci)
        err = max(err, float(np.abs(a.noisy - b.noisy).max()),
                  float(np.abs(a.clean - b.clean).max()))
        if not np.array_equal(a.starts, b.starts):
            raise AssertionError(f"chunk {ci}: window starts differ")
    for a, b in zip(ds_c.load_span_normalized(), ds_p.load_span_normalized()):
        err = max(err, float(np.abs(a - b).max()))
    tol = 1e-5
    say(f"native: C++ loader vs numpy over {ds_c.n_chunks} chunks + span: "
        f"max|diff| {err:.3g} (tol {tol:g}, float32 host math)")
    if not err <= tol:
        raise AssertionError(f"native loader differs from numpy by {err}")


# --- phase 2: corpus ---------------------------------------------------------

def _speech(rng: np.random.Generator, n: int, sr: int) -> np.ndarray:
    """Speech-like signal: harmonics of a gliding f0 under three moving
    formants, gated by a syllable-rate envelope with pauses."""
    t = np.arange(n) / sr
    f0 = rng.uniform(90.0, 220.0) * (
        1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 0.8) * t
                            + rng.uniform(0, 2 * np.pi)))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    formants = [(rng.uniform(lo, hi) * (1.0 + 0.15 * np.sin(
                    2 * np.pi * rng.uniform(0.5, 3.0) * t
                    + rng.uniform(0, 2 * np.pi))), bw, g)
                for lo, hi, bw, g in ((300, 900, 120, 1.0),
                                      (900, 2200, 180, 0.6),
                                      (2200, 3400, 250, 0.3))]
    s_prev, s_k = np.zeros(n), np.sin(phase)
    c2 = 2.0 * np.cos(phase)
    out = np.zeros(n)
    for k in range(1, int(3800 / f0.mean()) + 1):
        fk = k * f0
        amp = 0.01 + sum(g * np.exp(-0.5 * ((fk - fc) / bw) ** 2)
                         for fc, bw, g in formants)
        out += amp * s_k
        s_prev, s_k = s_k, c2 * s_k - s_prev       # sin((k+1)*phase)
    env = np.clip(np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t
                         + rng.uniform(0, 2 * np.pi)), 0.0, None) ** 0.6
    for _ in range(int(n / sr / 2)):                 # ~one pause per 2 s
        lo = int(rng.integers(0, n))
        env[lo: lo + int(rng.uniform(0.1, 0.4) * sr)] = 0.0
    out *= env
    return out * (rng.uniform(4000.0, 12000.0) / max(np.abs(out).max(), 1e-9))


def _noise(rng: np.random.Generator, n: int, sr: int, kind: str) -> np.ndarray:
    white = rng.normal(size=n)
    if kind == "white":
        return white
    if kind == "pink":
        spec = np.fft.rfft(white)
        spec /= np.sqrt(1.0 + np.arange(spec.size))
        return np.fft.irfft(spec, n)
    if kind == "babble":
        return sum(_speech(rng, n, sr) for _ in range(3))
    if kind == "hum":
        t = np.arange(n) / sr
        return (sum(np.sin(2 * np.pi * f * t) / (i + 1)
                    for i, f in enumerate((50, 100, 150, 200)))
                + 0.05 * white)
    # impulsive: white noise in short bursts
    gate = np.zeros(n)
    for lo in rng.integers(0, n, size=max(1, int(8 * n / sr))):
        gate[lo: lo + int(0.03 * sr)] = 1.0
    return white * gate + 0.02 * white


NOISE_KINDS = ("white", "pink", "babble", "hum", "impulsive")
SNRS_DB = (-5, 0, 5, 10, 15, 20)


@dataclass
class Corpus:
    noisy_wavs: list
    clean_wavs: list
    noisy_pfile: str
    clean_pfile: str
    norm: str
    n_train: int
    n_cv: int


def make_wav_pairs(root: str, seed: int, min_train_windows: int, n_cv: int,
                   secs: tuple, context: int = 7) -> tuple[list, list, int]:
    """Write clean/noisy int16 wav pairs under ``root`` from ``seed``: as
    many training utterances as give ``min_train_windows`` context windows
    at 16 kHz LPS framing, then ``n_cv`` held-out ones.  Utterance i draws
    its content from its own generator, so threads may write them in any
    order.

    Returns (noisy paths, clean paths, number of training utterances).
    """
    from concurrent.futures import ThreadPoolExecutor

    from tpu_se.dsp import num_frames
    from tpu_se.io import write_wav

    rng = np.random.default_rng(seed)
    lengths, windows = [], 0
    while windows < min_train_windows:
        lengths.append(int(rng.uniform(*secs) * SAMPLE_RATE))
        windows += max(0, num_frames(lengths[-1]) - (context - 1))
    n_train = len(lengths)
    lengths += [int(rng.uniform(*secs) * SAMPLE_RATE) for _ in range(n_cv)]
    for sub in ("noisy", "clean"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def one(i: int) -> tuple[str, str]:
        r = np.random.default_rng([seed, i])
        n = lengths[i]
        clean = _speech(r, n, SAMPLE_RATE)
        noise = _noise(r, n, SAMPLE_RATE, NOISE_KINDS[i % len(NOISE_KINDS)])
        snr = SNRS_DB[int(r.integers(len(SNRS_DB)))]
        gain = np.sqrt(np.mean(clean ** 2) / np.mean(noise ** 2)
                       / 10.0 ** (snr / 10.0))
        paths = []
        for sub, x in (("noisy", clean + gain * noise), ("clean", clean)):
            paths.append(os.path.join(root, sub, f"u{i:04d}.wav"))
            write_wav(paths[-1], np.clip(np.round(x), -32768, 32767)
                      .astype(np.int16), SAMPLE_RATE)
        return paths[0], paths[1]

    with ThreadPoolExecutor(8) as pool:
        pairs = list(pool.map(one, range(len(lengths))))
    return [p[0] for p in pairs], [p[1] for p in pairs], n_train


def _write_scp(path: str, items) -> str:
    with open(path, "w") as f:
        f.write("".join(f"{x}\n" for x in items))
    return path


def cli(argv: list, log_path: str) -> str:
    """Run ``tpu_se <argv>`` in this process with stdout captured in
    ``log_path``; return what it printed.  A non-zero code raises."""
    from tpu_se.cli.main import main

    with open(log_path, "w") as log:
        try:
            with contextlib.redirect_stdout(log):
                rc = main([str(a) for a in argv])
        except SimulatedCrash:
            raise
        except Exception:
            log.flush()
            with open(log_path) as f:
                sys.stderr.write(f.read()[-4000:])
            raise
    if rc != 0:
        raise RuntimeError(f"tpu_se {argv[0]} exited {rc}")
    with open(log_path) as f:
        return f.read()


def phase_corpus(work: str, seed: int, sizes: Sizes) -> Corpus:
    from tpu_se.io import read_pfile_meta

    root = os.path.join(work, "corpus")
    t0 = time.perf_counter()
    noisy, clean, n_train = make_wav_pairs(
        root, seed, int(sizes.traincache * 1.03), sizes.n_cv, sizes.secs)
    t_synth = time.perf_counter() - t0
    logs = os.path.join(work, "logs")
    os.makedirs(logs, exist_ok=True)
    pfiles = {}
    for side, wavs in (("noisy", noisy), ("clean", clean)):
        scp = _write_scp(os.path.join(root, f"{side}_wav.scp"), wavs)
        cli(["lps-extract", "--scp", scp, "--jobs", "8"],
            os.path.join(logs, f"lps_{side}.log"))
        lps_scp = _write_scp(os.path.join(root, f"{side}_lps.scp"),
                             (p[:-4] + ".lps" for p in wavs))
        pfiles[side] = os.path.join(root, f"{side}.pfile")
        cli(["make-pfile", lps_scp, "-o", pfiles[side], "--jobs", "8"],
            os.path.join(logs, f"pfile_{side}.log"))
    norm = os.path.join(root, "noisy.norm")
    cli(["get-norm", pfiles["noisy"], "-o", norm],
        os.path.join(logs, "norm.log"))
    n_sents, n_frames, dim, _ = read_pfile_meta(pfiles["noisy"])
    minutes = sum(os.path.getsize(p) - 44 for p in noisy) / 2 / SAMPLE_RATE / 60
    say(f"corpus: {n_sents} utterance pairs ({n_train} train, "
        f"{len(noisy) - n_train} cv), {minutes:.1f} min of audio, "
        f"{n_frames} frames x {dim}; synthesis {t_synth:.1f} s host, "
        f"features {time.perf_counter() - t0 - t_synth:.1f} s")
    if dim != 257 or n_sents != len(noisy):
        raise AssertionError("corpus pfile has the wrong shape")
    return Corpus(noisy, clean, pfiles["noisy"], pfiles["clean"], norm,
                  n_train, len(noisy) - n_train)


# --- phase 3: DSP ------------------------------------------------------------

def _corpus_frames(wavs: list, n: int) -> np.ndarray:
    from tpu_se.dsp import frame_signal
    from tpu_se.io import read_wav

    frames, have = [], 0
    for path in wavs:
        frames.append(frame_signal(read_wav(path)[0]))
        have += frames[-1].shape[0]
        if have >= n:
            break
    return np.concatenate(frames)[:n]


def phase_dsp(corpus: Corpus, sizes: Sizes) -> None:
    import jax.numpy as jnp

    from tpu_se.dsp import lps_from_frames
    from tpu_se.infer.streaming import inverse_dft
    from tpu_se.reference import np_lps, np_spectrum

    frames = _corpus_frames(corpus.noisy_wavs, sizes.dsp_frames)
    t = frames.shape[0]
    got = np.asarray(lps_from_frames(jnp.asarray(frames)), np.float64)
    ref = np_lps(frames)
    # Bins far below their frame's peak carry only the GEMM's absolute
    # rounding error, which the log amplifies without bound.
    near = ref > ref.max(axis=1, keepdims=True) - 40.0 / (10 / math.log(10))
    err = float(np.abs(got - ref)[near].max())
    err_all = float(np.abs(got - ref).max())
    tol = 2e-3   # H100: 3.8e-5 at HIGHEST, 4.2e-2 at DEFAULT (TF32)
    say(f"dsp: lps_from_frames T={t} vs float64 np.fft.rfft: max|dLPS| "
        f"{err:.3g} over bins within 40 dB of their frame peak (all bins "
        f"{err_all:.3g}), tol {tol:g}, precision HIGHEST")
    if not err <= tol:
        raise AssertionError(f"lps_from_frames error {err} > {tol}")

    rng = np.random.default_rng(0)
    spec = np_spectrum(frames) * rng.uniform(0.05, 1.0, (t, 257))
    x = np.concatenate([spec.real, spec.imag], axis=1).astype(np.float32)
    x64 = x.astype(np.float64)
    want = np.fft.irfft(x64[:, :257] + 1j * x64[:, 257:], n=512, axis=-1)
    got = np.asarray(inverse_dft(jnp.asarray(x), 512), np.float64)
    err = float(np.abs(got - want).max())
    tol = 0.1
    say(f"dsp: inverse-DFT GEMM T={t} vs float64 np.fft.irfft: max|d| "
        f"{err:.3g} int16 LSB (signal peak {np.abs(want).max():.0f}), "
        f"tol {tol:g} LSB, precision HIGHEST")
    if not err <= tol:
        raise AssertionError(f"inverse_dft error {err} > {tol}")


# --- phase 4: train ----------------------------------------------------------

def _epoch_metrics(out_dir: str, epochs: int) -> list[dict]:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for e in range(1, epochs + 1):
        for name in (f"mlp.{e}.wts", f"mlp.{e}.log"):
            if not os.path.exists(os.path.join(out_dir, name)):
                raise AssertionError(f"{out_dir}: {name} missing")
    if len(rows) != epochs:
        raise AssertionError(f"{out_dir}: {len(rows)} CV records, want "
                             f"{epochs}")
    for r in rows:
        cv = [r["cv_squared_error"], r["cv_abs_error"], r["cv_ggd_loglik"]]
        if not all(math.isfinite(v) for v in cv):
            raise AssertionError(f"{out_dir}: non-finite CV {r}")
    return rows


def _train_args(corpus: Corpus, sizes: Sizes, seed: int) -> list:
    n_tr, n_cv = corpus.n_train, corpus.n_cv
    return ["train", "--fea-file", corpus.noisy_pfile,
            "--targ-file", corpus.clean_pfile, "--norm-file", corpus.norm,
            "--layersizes", sizes.layersizes,
            "--traincache", sizes.traincache, "--seed", seed,
            "--train-sents", f"0-{n_tr - 1}",
            "--cv-sents", f"{n_tr}-{n_tr + n_cv - 1}"]


def check_train_chunk(corpus: Corpus, sizes: Sizes, seed: int,
                      card: str) -> None:
    """One train_chunk of a few parity bunches against the float64 numpy
    transcription of the reference update, then the step's memory analysis
    at the real chunk shape."""
    import jax
    import jax.numpy as jnp

    from tpu_se.data import PfilePairDataset
    from tpu_se.models import init_params
    from tpu_se.reference import np_train_chunk
    from tpu_se.train import (
        TrainHyper, load_device_frames, make_train_state, train_chunk,
    )

    layersizes = tuple(int(s) for s in sizes.layersizes.split(","))
    ds = PfilePairDataset(corpus.noisy_pfile, corpus.clean_pfile, corpus.norm,
                          (0, corpus.n_train - 1), sizes.traincache)
    chunk = ds.chunk(0, np.random.default_rng(seed))
    m = sizes.bunch
    starts = chunk.starts[: sizes.ref_bunches * m].reshape(-1, m)
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=m, context=7,
                       targ_offset=3, grad_scale="parity")
    lr = 0.1
    params = init_params(seed, layersizes)
    before = [{k: np.asarray(v).copy() for k, v in l.items()} for l in params]
    state = train_chunk(make_train_state(params, layersizes[-1]),
                        jnp.asarray(chunk.noisy), jnp.asarray(chunk.clean),
                        jnp.asarray(starts), jnp.float32(lr), hyper)
    W, B, alpha = np_train_chunk(before, chunk.noisy, chunk.clean, starts,
                                 lr, hyper)
    # Compare the updates, not the weights: an update is ~1e-4 of a weight.
    err = 0.0
    for l, layer in enumerate(state.params):
        for got, want, w0 in ((layer["w"], W[l], before[l]["w"]),
                              (layer["b"], B[l], before[l]["b"])):
            d_got = np.asarray(got, np.float64) - w0
            d_want = want - w0
            err = max(err, float(np.abs(d_got - d_want).max()
                                 / np.abs(d_want).max()))
    err_alpha = float(np.abs(np.asarray(state.alpha) - alpha).max()
                      / np.abs(alpha).max())
    # Between the H100 readings at HIGHEST (update 4.8e-4, alpha 7.9e-8)
    # and at DEFAULT, i.e. TF32 (9.6e-3, 1.7e-4): TF32 fails both.
    tol, tol_alpha = 2e-3, 4e-6
    say(f"train: train_chunk {len(starts)} bunches x M={m} at "
        f"{sizes.layersizes} vs float64 numpy reference: max relative "
        f"update error {err:.3g} (tol {tol:g}), alpha {err_alpha:.3g} (tol "
        f"{tol_alpha:g}), precision HIGHEST (float32)")
    if not (err <= tol and err_alpha <= tol_alpha):
        raise AssertionError(f"train_chunk differs from the reference: "
                             f"{err}, {err_alpha}")

    noisy_dev, clean_dev = load_device_frames(ds)
    n_b = ds.chunk_starts(0).shape[0] // m
    starts_full = jnp.zeros((n_b, m), jnp.int32)
    state = make_train_state(init_params(seed, layersizes), layersizes[-1])
    compiled = train_chunk.lower(state, noisy_dev, clean_dev, starts_full,
                                 jnp.float32(lr), hyper).compile()
    ma = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    say(f"train: train_chunk [{n_b} bunches x {m}] over "
        f"{noisy_dev.shape[0]} resident frames, memory_analysis: "
        + ", ".join(f"{f[:-len('_size_in_bytes')]} {getattr(ma, f)}"
                    for f in fields)
        + f"; peak_bytes_in_use {stats.get('peak_bytes_in_use')}"
        + f" [{card}]")


def _kill_resume(corpus: Corpus, sizes: Sizes, seed: int, work: str,
                 reference_wts: str) -> None:
    import tpu_se.train.loop as loop_mod
    from tpu_se.io import read_wts

    out = os.path.join(work, "train_resume")
    logs = os.path.join(work, "logs")
    argv = _train_args(corpus, sizes, seed) + [
        "--out-dir", out, "--epochs", 1, "--checkpoint-every-chunks", 1]
    orig, calls = loop_mod.train_chunk, [0]

    def crash_on_second_chunk(*a, **k):
        calls[0] += 1
        if calls[0] == 2:
            raise SimulatedCrash()
        return orig(*a, **k)

    loop_mod.train_chunk = crash_on_second_chunk
    try:
        cli(argv, os.path.join(logs, "train_killed.log"))
        raise AssertionError("the simulated crash did not happen")
    except SimulatedCrash:
        pass
    finally:
        loop_mod.train_chunk = orig
    if not os.path.exists(os.path.join(out, "mlp.1.partial.wts.meta.json")):
        raise AssertionError("no partial checkpoint after the crash")
    text = cli(argv, os.path.join(logs, "train_resumed.log"))
    if "resuming mid-epoch at chunk 1" not in text:
        raise AssertionError("the rerun did not resume mid-epoch")
    got = os.path.join(out, "mlp.1.wts")
    with open(got, "rb") as f, open(reference_wts, "rb") as g:
        exact = f.read() == g.read()
    diff = max(float(np.abs(a[k] - b[k]).max())
               for a, b in zip(read_wts(got), read_wts(reference_wts))
               for k in ("w", "b"))
    tol = 1e-4
    say(f"train: kill at chunk 2 + resume from the chunk-1 checkpoint vs the "
        f"uninterrupted epoch 1: {'bit-exact' if exact else 'NOT bit-exact'}"
        f" (max|dW| {diff:.3g}, tol {tol:g})")
    if not diff <= tol:
        raise AssertionError(f"resumed weights differ by {diff}")


def phase_train(corpus: Corpus, sizes: Sizes, seed: int, work: str,
                card: str) -> str:
    logs = os.path.join(work, "logs")
    runs = (("parity", 2, []),
            ("natural", 1, ["--bunchsize", sizes.natural_bunch,
                            "--compute-dtype", "bfloat16",
                            "--grad-scale", "natural"]))
    for name, epochs, extra in runs:
        out = os.path.join(work, f"train_{name}")
        t0 = time.perf_counter()
        cli(_train_args(corpus, sizes, seed)
            + ["--out-dir", out, "--epochs", epochs] + extra,
            os.path.join(logs, f"train_{name}.log"))
        dt = time.perf_counter() - t0
        for r in _epoch_metrics(out, epochs):
            say(f"train {name} epoch {r['epoch']}: CV squared "
                f"{r['cv_squared_error']:.6g}, abs {r['cv_abs_error']:.6g}, "
                f"GGD loglik {r['cv_ggd_loglik']:.6g} over {r['cv_frames']} "
                f"frames; wall {r['wall_time_s']} s (epoch 1 includes "
                f"compilation) [{card}]")
        say(f"train {name}: {epochs} epoch(s) at {sizes.layersizes} in "
            f"{dt:.1f} s incl. compile [{card}]")
    check_train_chunk(corpus, sizes, seed, card)
    parity = os.path.join(work, "train_parity")
    _kill_resume(corpus, sizes, seed, work, os.path.join(parity, "mlp.1.wts"))
    return os.path.join(parity, "mlp.2.wts")


# --- phase 5: decode ---------------------------------------------------------

def check_reference_decode(wts: str, norm: str, wavs: list,
                           out_dir: str) -> float:
    """Max |difference| in int16 LSB between the ``*_enhanced.wav`` files
    in ``out_dir`` and the float64 numpy decode of ``wavs``."""
    from tpu_se.io import read_norm, read_wav, read_wts
    from tpu_se.reference import np_decode, np_pcm16

    layers = read_wts(wts)
    mean, inv_std = read_norm(norm, layers[-1]["b"].shape[0])
    err = 0
    for path in wavs:
        stem = os.path.splitext(os.path.basename(path))[0]
        got, _ = read_wav(os.path.join(out_dir, stem + "_enhanced.wav"))
        want = np_pcm16(np_decode(layers, mean, inv_std, read_wav(path)[0]))
        if got.shape != want.shape:
            raise AssertionError(f"{stem}: {got.shape} != {want.shape}")
        err = max(err, int(np.abs(got.astype(np.int32) - want).max()))
    return err


def _read_outputs(out_dir: str, wavs: list) -> list:
    from tpu_se.io import read_wav

    return [read_wav(os.path.join(out_dir, os.path.splitext(
        os.path.basename(p))[0] + "_enhanced.wav"))[0] for p in wavs]


def phase_decode(corpus: Corpus, wts: str, sizes: Sizes, work: str,
                 card: str) -> None:
    import jax
    import jax.numpy as jnp

    from tpu_se.dsp.synthesis import to_pcm16
    from tpu_se.infer import Enhancer
    from tpu_se.io import read_wav, write_wav
    from tpu_se.reference import np_pcm16

    logs = os.path.join(work, "logs")
    wavs = list(corpus.noisy_wavs[-sizes.decode_utts:])
    # One input near full scale, so the output reaches the int16 limits.
    loud, _ = read_wav(wavs[0])
    wavs[0] = os.path.join(work, "loud.wav")
    write_wav(wavs[0], np.clip(loud.astype(np.int64) * 8, -32768, 32767)
              .astype(np.int16), SAMPLE_RATE)
    scp = _write_scp(os.path.join(work, "decode.scp"), wavs)
    base = ["decode", "--scp", scp, "--wts", wts, "--norm", corpus.norm]

    out_b = os.path.join(work, "dec_batch")
    t0 = time.perf_counter()
    cli(base + ["--batch", sizes.decode_utts, "--out-dir", out_b],
        os.path.join(logs, "decode_batch.log"))
    dt = time.perf_counter() - t0
    err = check_reference_decode(wts, corpus.norm, wavs, out_b)
    tol = 2   # H100: 1 LSB at HIGHEST, 103 at DEFAULT (TF32)
    say(f"decode --batch {sizes.decode_utts}: {len(wavs)} utterances vs "
        f"float64 numpy decode: max|d| {err} int16 LSB (tol {tol}: float32 "
        f"vs float64 rounding, then truncation), precision HIGHEST; "
        f"{dt:.1f} s incl. compile [{card}]")
    if not err <= tol:
        raise AssertionError(f"batch decode differs by {err} LSB")
    batch_out = _read_outputs(out_b, wavs)

    waves = [read_wav(p)[0] for p in wavs]
    enh = Enhancer(wts, corpus.norm)
    plain = [w for w, _, _ in enh.enhance_batch(waves)]
    fast = enh.enhance_batch_waves(waves)
    same = all(np.array_equal(a, b) for a, b in zip(plain, fast))
    clipped = sum(int(np.sum(np.abs(w.astype(np.int32)) >= 32767))
                  for w in plain)
    say(f"decode: enhance_batch_waves vs enhance_batch: "
        f"{'bitwise equal' if same else 'DIFFERENT'} over {len(waves)} "
        f"utterances ({clipped} samples at the int16 limits)")
    if not same:
        raise AssertionError("enhance_batch_waves != enhance_batch")

    x = np.array([-1e9, -40000.7, -32769.0, -32768.9, -32767.2, -0.7, 0.7,
                  32766.9, 32767.9, 32768.0, 40000.2, 1e9], np.float32)
    dev = np.asarray(jax.jit(to_pcm16)(jnp.asarray(x)))
    host = to_pcm16(x)
    want = np_pcm16(x.astype(np.float64))
    same = np.array_equal(dev, want) and np.array_equal(host, want)
    raw_dev = np.asarray(jax.jit(lambda v: v.astype(jnp.int16))(jnp.asarray(x)))
    with np.errstate(invalid="ignore"):
        raw_host = x.astype(np.int16)
    say(f"decode: to_pcm16 on device {dev.tolist()}; device and host == "
        f"reference truncate+saturate: {same}; a bare float32->int16 "
        f"convert gives {raw_dev.tolist()} on device, {raw_host.tolist()} "
        f"on the host")
    if not same:
        raise AssertionError("int16 conversion differs from the reference")

    s_wavs = wavs[: sizes.stream_utts]
    s_scp = _write_scp(os.path.join(work, "stream.scp"), s_wavs)
    out_s = os.path.join(work, "dec_stream")
    t0 = time.perf_counter()
    cli(["decode", "--scp", s_scp, "--wts", wts, "--norm", corpus.norm,
         "--stream", 1000, "--out-dir", out_s],
        os.path.join(logs, "decode_stream.log"))
    dt = time.perf_counter() - t0
    err = 0
    for got, want in zip(_read_outputs(out_s, s_wavs), batch_out):
        if got.shape != want.shape:
            raise AssertionError(f"stream {got.shape} != batch {want.shape}")
        err = max(err, int(np.abs(got.astype(np.int32) - want).max()))
    say(f"decode --stream 1000: {len(s_wavs)} utterances vs batch: max|d| "
        f"{err} int16 LSB (tol 1), precision HIGHEST; {dt:.1f} s incl. "
        f"compile [{card}]")
    if not err <= 1:
        raise AssertionError(f"streaming differs from batch by {err} LSB")

    out_q = os.path.join(work, "dec_quality")
    t0 = time.perf_counter()
    cli(base + ["--batch", sizes.decode_utts, "--blend", "auto",
                "--smooth-strength", "auto", "--out-dir", out_q],
        os.path.join(logs, "decode_quality.log"))
    dt = time.perf_counter() - t0
    quality = _read_outputs(out_q, wavs)
    for q, b in zip(quality, batch_out):
        if q.shape != b.shape or not np.any(q):
            raise AssertionError("quality decode output is empty or "
                                 "mis-sized")
    moved = np.mean([np.mean(np.abs(q.astype(np.int32) - b))
                     for q, b in zip(quality, batch_out)])
    say(f"decode --blend auto --smooth-strength auto: {len(quality)} "
        f"utterances written, mean |d| vs plain decode {moved:.1f} LSB; "
        f"{dt:.1f} s incl. compile [{card}]")


# --- phase 6: off-path ops ---------------------------------------------------

def _time_op(fn, args, reps: int = 50) -> tuple[float, float | None, int]:
    """(µs per call on the host clock incl. dispatch, µs of device kernels
    per call read from a profiler trace, kernels per call).  The device time
    is None when the trace holds no kernel of the first GPU."""
    import glob

    import jax
    from jax.profiler import ProfileData

    jitted = jax.jit(fn)
    jax.block_until_ready(jitted(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jitted(*args)
    jax.block_until_ready(out)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        with jax.profiler.trace(d):
            for _ in range(reps):
                out = jitted(*args)
            jax.block_until_ready(out)
        paths = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)
        profile = ProfileData.from_file(paths[0])
    ns, n = 0.0, 0
    for plane in profile.planes:
        if plane.name != "/device:GPU:0":
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                if not ev.name.startswith(("Memcpy", "Memset")):
                    ns += ev.duration_ns
                    n += 1
    if n == 0:
        return host_us, None, 0
    return host_us, ns / reps / 1e3, round(n / reps)


def _say_time(name: str, timed: tuple, card: str) -> None:
    host_us, dev_us, kernels = timed
    dev = ("not measured (no GPU kernel in the trace)" if dev_us is None
           else f"{dev_us:.2f} us of device kernels per call ({kernels} "
                f"kernel(s), profiler trace)")
    say(f"timing: {name}: {dev}; {host_us:.2f} us per call on the host "
        f"clock incl. dispatch [{card}]")


def phase_timing(card: str) -> None:
    import jax.numpy as jnp

    from tpu_se.dsp import lps_from_frames
    from tpu_se.losses import output_grad_and_alpha

    rng = np.random.default_rng(1)
    frames = jnp.asarray(rng.normal(0, 3000, (4096, 512)).astype(np.float32))
    _say_time("lps_from_frames T=4096 (plain XLA, HIGHEST)",
              _time_op(lps_from_frames, (frames,)), card)
    for m in (128, 4096):
        out = jnp.asarray(rng.normal(size=(m, 257)).astype(np.float32))
        targ = jnp.asarray(rng.normal(size=(m, 257)).astype(np.float32))
        _say_time(f"output_grad_and_alpha M={m} D=257 (plain XLA)",
                  _time_op(lambda o, t: output_grad_and_alpha(o, t, 1.0, True),
                           (out, targ)), card)


# --- phase 7: four GPUs ------------------------------------------------------

def phase_four(devices, card: str) -> None:
    sys.path.insert(0, REPO)
    import __graft_entry__

    if len(devices) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX found {len(devices)}")
    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4, full_width=True, log=say)
    say(f"four: train (4x1, 2x2, 2x1; overlap step on 4x1, 2x1), sharded "
        f"enhance_batch / enhance_batch_waves / push_many at full width vs "
        f"one device: ok in {time.perf_counter() - t0:.1f} s incl. compile "
        f"[{card}]")


# --- driver ------------------------------------------------------------------

def run_single(devices, card: str, seed: int, work: str,
               sizes: Sizes = FULL) -> None:
    """Phases 1-6 on one device."""
    timed = []

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        say(f"== phase {name}")
        out = fn(*args)
        timed.append((name, time.perf_counter() - t0))
        return out

    phase("1 native loader", phase_native, work, seed)
    corpus = phase("2 corpus", phase_corpus, work, seed, sizes)
    phase("3 dsp", phase_dsp, corpus, sizes)
    wts = phase("4 train", phase_train, corpus, sizes, seed, work, card)
    phase("5 decode", phase_decode, corpus, wts, sizes, work, card)
    phase("6 timing", phase_timing, card)
    say("phase times: " + ", ".join(f"{n} {t:.1f} s" for n, t in timed)
        + f" [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths (needs 4 GPUs)")
    ap.add_argument("--seed", type=int, default=20260416,
                    help="seed of the corpus, weights and inputs")
    args = ap.parse_args(argv)
    if args.four:
        os.environ.setdefault("NCCL_DEBUG", "WARN")   # before backend init
    try:
        devices = gpu_devices()
    except NoGPU as e:
        print(f"chip_smoke: {e}; nothing was run", file=sys.stderr)
        return 2
    global _stall_s
    _stall_s = STALL_S["four" if args.four else "one"]
    try:
        return _run(args, devices)
    finally:
        _stall_s = None
        faulthandler.cancel_dump_traceback_later()


def _run(args, devices) -> int:
    sys.path.insert(0, REPO)
    from tpu_se.utils.cache import setup_compilation_cache

    say(f"compilation cache: {setup_compilation_cache()}")
    card = card_label()
    t0 = time.perf_counter()
    say("== phase 0 device")
    phase_device(devices, card)
    if args.four:
        say("== phase 7 four")
        phase_four(devices, card)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            run_single(devices, card, args.seed, work)
    say(f"total {time.perf_counter() - t0:.1f} s [{card}]")
    say(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Plain float64 numpy references for the device programs, and the seeded
inputs they are checked on.

Straightforward transcriptions of the reference math, independent of the
code they check (framing, window, log floor and int16 conversion are
written out here, not imported): the tests compare against them on the
CPU at small widths, and ``chip_smoke.py`` on the GPU at the model's full
width.
"""

from __future__ import annotations

import os

import numpy as np

# ln of the reference's power floor e^-50 (``Wav2LogSpec_be.c``).
LOG_FLOOR = -50.0


def np_train_chunk(params, noisy, clean, starts_2d, lr, hyper):
    """Literal numpy transcription of BP_GPU::train_bunch_single +
    kernUpdatedelta (the reference's exact update math, double 1/M and all),
    over the bunches of ``starts_2d`` [n_bunches, M], from zero velocity.

    Returns (weights, biases, alpha) as float64 arrays.
    """
    W = [np.asarray(l["w"], dtype=np.float64) for l in params]
    B = [np.asarray(l["b"], dtype=np.float64) for l in params]
    vW = [np.zeros_like(w) for w in W]
    vB = [np.zeros_like(b) for b in B]
    n_layers = len(W)
    ctx, off, beta = hyper.context, hyper.targ_offset, hyper.beta
    m = hyper.bunchsize
    alpha = np.ones(B[-1].shape[0])

    for bunch in np.asarray(starts_2d):
        idx = bunch[:, None] + np.arange(ctx)[None, :]
        x = noisy[idx].reshape(m, -1).astype(np.float64)
        targ = clean[bunch + off].astype(np.float64)
        # forward
        ys = [x]
        for l in range(n_layers):
            z = ys[-1] @ W[l] + B[l]
            ys.append(1.0 / (1.0 + np.exp(-z)) if l < n_layers - 1 else z)
        out = ys[-1]
        err = out - targ
        # output gradient (kernSubClean2 / kernfunc2 + DevVecMulNum 1/M)
        sgn_pow = np.where(err == 0.0, 0.0,
                           np.sign(err) * np.abs(np.where(err == 0, 1, err))
                           ** (beta - 1.0))
        if hyper.ml:
            alpha = (beta * np.mean(np.abs(err) ** beta, axis=0)) ** (1 / beta)
            dedx = (beta * sgn_pow / alpha ** beta) / m
        else:
            dedx = beta * sgn_pow / m
        # backward + update (updatedelta divides by m AGAIN in parity mode)
        opt_n = m if hyper.grad_scale == "parity" else 1
        for l in reversed(range(n_layers)):
            gw = ys[l].T @ dedx
            gb = dedx.sum(axis=0)
            if l > 0:
                dedy = dedx @ W[l].T
                dedx = ys[l] * (1.0 - ys[l]) * dedy
            vW[l] = hyper.momentum * vW[l] - lr * (gw / opt_n
                                                   + hyper.weightcost * W[l])
            vB[l] = hyper.momentum * vB[l] - lr * (gb / opt_n)
            W[l] = W[l] + vW[l]
            B[l] = B[l] + vB[l]
    return W, B, alpha


def np_frames(wave: np.ndarray, frame_length: int = 512,
              frame_shift: int = 256) -> np.ndarray:
    """[N] wave -> float64 [T, len] frames: the front-end preloads
    ``len - shift`` samples and emits one frame per full ``shift`` read."""
    t = max(0, (len(wave) - (frame_length - frame_shift)) // frame_shift)
    idx = (np.arange(t)[:, None] * frame_shift
           + np.arange(frame_length)[None, :])
    return np.asarray(wave, np.float64)[idx]


def np_spectrum(frames: np.ndarray) -> np.ndarray:
    """[T, len] frames -> complex128 [T, len/2+1] rfft of the Hamming-windowed
    frames (``Wav2LogSpec_be.c:469-472``; FFT length == frame length).  The
    window is the symmetric 0.54 - 0.46 cos(2 pi n / (len - 1))."""
    return np.fft.rfft(np.asarray(frames, np.float64)
                       * np.hamming(frames.shape[1]), axis=-1)


def _log_power(spec: np.ndarray) -> np.ndarray:
    power = spec.real ** 2 + spec.imag ** 2
    return np.where(power < np.exp(LOG_FLOOR), LOG_FLOOR,
                    np.log(np.maximum(power, np.exp(LOG_FLOOR))))


def np_lps(frames: np.ndarray) -> np.ndarray:
    """[T, len] frames -> float64 log-power spectrum with the e^-50 floor."""
    return _log_power(np_spectrum(frames))


def np_decode(layers, mean, inv_std, wave: np.ndarray, frame_length: int = 512,
              frame_shift: int = 256, context: int = 7) -> np.ndarray:
    """The ``decode.m`` + ``LogSpec2Wav_be`` pipeline in float64: noisy int16
    wave -> enhanced float64 wave of ``T*shift + (len-shift)`` samples.

    np.fft analysis, Z-score, edge-replicated context splice
    (``frame_expand.m``), float64 forward (sigmoid hidden, linear output),
    de-normalization, noisy-phase np.fft synthesis, re-windowed OLA divided
    by the summed squared window (``LogSpec2Wav.c:682-827``).  ``layers`` is
    the ``.wts`` layer list ``[{"w": [in, out], "b": [out]}, ...]``.
    """
    frames = np_frames(wave, frame_length, frame_shift)
    t = frames.shape[0]
    spec = np_spectrum(frames)
    lps = _log_power(spec)
    mean = np.asarray(mean, np.float64)
    inv_std = np.asarray(inv_std, np.float64)
    normed = (lps - mean) * inv_std
    half = (context - 1) // 2
    idx = np.clip(np.arange(t)[:, None] + np.arange(-half, half + 1)[None, :],
                  0, t - 1)
    h = normed[idx].reshape(t, -1)
    for i, layer in enumerate(layers):
        h = h @ np.asarray(layer["w"], np.float64) + np.asarray(layer["b"],
                                                                np.float64)
        if i < len(layers) - 1:
            h = 1.0 / (1.0 + np.exp(-h))
    enh = h / inv_std + mean
    enh_power = np.where(enh < LOG_FLOOR, np.exp(LOG_FLOOR), np.exp(enh))
    mag = np.abs(spec)
    scale = np.where(mag > 0.0, np.sqrt(enh_power) / np.maximum(mag, 1e-300),
                     0.0)
    synth = np.fft.irfft(spec * scale, n=frame_length, axis=-1)
    win = np.hamming(frame_length)
    n_out = t * frame_shift + (frame_length - frame_shift)
    acc = np.zeros(n_out)
    w2 = np.zeros(n_out)
    for k in range(t):
        lo = k * frame_shift
        acc[lo:lo + frame_length] += synth[k] * win
        w2[lo:lo + frame_length] += win * win
    return acc / np.maximum(w2, 1e-20)


def np_pcm16(wave: np.ndarray) -> np.ndarray:
    """Float samples -> int16 as the reference's C ``(short)`` cast gives
    them in range: truncated toward zero, and saturated outside it."""
    return np.clip(np.trunc(wave), -32768, 32767).astype(np.int16)


def seeded_pfiles(root: str, seed: int, n_sents: int = 64,
                  dim: int = 257) -> tuple[str, str, str]:
    """A noisy/clean pfile pair of ``n_sents`` random sentences (200-600
    frames) and its .norm, written under ``root`` from ``seed``."""
    from tpu_se.io import PfileWriter, compute_norm_pfile, write_norm

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    noisy = os.path.join(root, "noisy.pfile")
    clean = os.path.join(root, "clean.pfile")
    with PfileWriter(noisy) as wn, PfileWriter(clean) as wc:
        for _ in range(n_sents):
            t = int(rng.integers(200, 600))
            x = rng.normal(2.0, 3.0, size=(t, dim)).astype(np.float32)
            wn.add(x)
            wc.add((0.7 * x + rng.normal(0, 0.5, (t, dim))).astype(np.float32))
    norm = os.path.join(root, "noisy.norm")
    write_norm(norm, *compute_norm_pfile(noisy))
    return noisy, clean, norm

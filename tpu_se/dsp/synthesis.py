"""Waveform synthesis: enhanced LPS + noisy phase -> time-domain waveform.

Reference semantics (``Test_code/SourceCode_LogSpec2Wav_be/LogSpec2Wav.c``):

- Enhanced LPS is exponentiated with the same -50 floor used at analysis:
  power = LPS < -50 ? e^-50 : exp(LPS)  (``:481-495``).
- Per frame, the *noisy* frame is Hamming-windowed and FFT'd; each complex
  bin is scaled so its magnitude becomes sqrt(power) while keeping the noisy
  phase (``:682-691``).
- The inverse FFT output is windowed AGAIN (OLA_KIND==1, ``:712-713``) and
  overlap-added; the accumulated signal is divided by the accumulated
  squared-window envelope (``:798-827``), then truncated to int16 (``:829``).

The reference's ``rifft`` divides by N (``FEfunc.c:453-455``), so
``jnp.fft.irfft`` is the exact same transform.  Everything is batched: one
rfft/irfft over all frames, OLA as a vectorized two-hop segment sum (frame
length = 2 x shift).  Shapes are bucket-padded with a validity mask so any
utterance length reuses a bounded set of compiled programs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_se.dsp.analysis import (
    FRAME_BUCKET, LOG_FLOOR, frame_signal, hamming_window, rate_config,
)


def to_pcm16(wave):
    """Float samples -> int16, truncated toward zero like the reference's C
    ``(short)`` cast (``LogSpec2Wav.c:829``) and saturated at the int16
    range, where that cast is undefined.

    One definition for the host (numpy) and the device (jax) side, so the
    on-device conversion of the int16 serving paths gives exactly what the
    host cast gives, out-of-range samples included.
    """
    xp = jnp if isinstance(wave, jax.Array) else np
    return xp.clip(xp.trunc(wave), -32768, 32767).astype(xp.int16)


@functools.partial(jax.jit, static_argnames=("frame_shift", "ola_kind"))
def _synth_and_ola(lps_enh: jax.Array, noisy_frames: jax.Array,
                   valid: jax.Array, frame_shift: int = 256,
                   ola_kind: int = 1) -> tuple[jax.Array, jax.Array]:
    """Padded [T,bins] LPS + [T,len] noisy frames + [T] 0/1 mask
    -> (OLA waveform, de-windowed recon frames [T,len]).

    Padded rows contribute nothing: their synthesis frames and their
    squared-window weights are masked out of both OLA accumulators.  The
    OLA is a vectorized segment sum over ceil(len/shift) shift-sized hops,
    so any (len, shift) rate config works (16 kHz: 2 hops; 11 kHz: 3).

    ``ola_kind`` mirrors the reference's compile-time ``OLA_KIND``
    (``LogSpec2Wav.c:72,712-715,810-819``) as a runtime option: 1 (the
    shipped build) re-windows the inverse FFT and divides by the summed
    squared window; 0 de-windows it and divides by the overlap count.
    """
    frame_length = noisy_frames.shape[1]
    fft_length = frame_length
    win = jnp.asarray(hamming_window(frame_length))
    spec = jnp.fft.rfft(noisy_frames * win[None, :], n=fft_length, axis=-1)
    power = jnp.where(lps_enh < LOG_FLOOR, jnp.float32(np.exp(LOG_FLOOR)),
                      jnp.exp(lps_enh))
    mag = jnp.abs(spec)
    scale = jnp.where(mag > 0.0, jnp.sqrt(power) / jnp.maximum(mag, 1e-30),
                      0.0)
    synth = jnp.fft.irfft(spec * scale, n=fft_length, axis=-1)

    # OLA with per-frame validity weights.
    n_hops = -(-frame_length // frame_shift)
    pad_cols = n_hops * frame_shift - frame_length
    if ola_kind == 1:
        sw = synth * win[None, :] * valid[:, None]
        w2 = (win * win)[None, :] * valid[:, None]
    else:
        sw = synth / win[None, :] * valid[:, None]
        w2 = jnp.ones_like(win)[None, :] * valid[:, None]

    def segment_sum(rows):
        rows = jnp.pad(rows, ((0, 0), (0, pad_cols)))
        t = rows.shape[0]
        chunks = rows.reshape(t, n_hops, frame_shift)
        acc = jnp.zeros((t + n_hops - 1, frame_shift), rows.dtype)
        for j in range(n_hops):
            acc = acc + jnp.pad(chunks[:, j], ((j, n_hops - 1 - j), (0, 0)))
        return acc.reshape(-1)

    wave = segment_sum(sw) / jnp.maximum(segment_sum(w2), 1e-20)
    recon_dewin = synth / win[None, :]
    return wave, recon_dewin


def reconstruct(lps_enh: np.ndarray, noisy_wave: np.ndarray,
                sample_rate: int = 16000, ola_kind: int = 1
                ) -> tuple[np.ndarray, np.ndarray]:
    """Enhanced LPS [T,bins] + noisy waveform -> (int16 wave, recon frames).

    ``recon frames`` [T,len] is the de-windowed per-frame reconstruction the
    reference uses for SegSNR (``DeWindow``, ``LogSpec2Wav.c:693-698``).
    The output waveform has ``T*shift + (len-shift)`` samples (``:798``) and
    is converted by :func:`to_pcm16`.
    """
    frame_length, frame_shift, fft_length = rate_config(sample_rate)
    n_bins = fft_length // 2 + 1
    noisy_frames = frame_signal(noisy_wave, frame_length, frame_shift)
    t = noisy_frames.shape[0]
    if lps_enh.shape[0] != t:
        raise ValueError(
            f"LPS frames ({lps_enh.shape[0]}) != noisy frames ({t})")
    if lps_enh.shape[1] != n_bins:
        raise ValueError(f"expected {n_bins} bins, got {lps_enh.shape[1]}")
    t_pad = -(-t // FRAME_BUCKET) * FRAME_BUCKET
    lps_p = np.full((t_pad, n_bins), LOG_FLOOR, dtype=np.float32)
    lps_p[:t] = lps_enh
    frames_p = np.zeros((t_pad, frame_length), dtype=np.float32)
    frames_p[:t] = noisy_frames
    valid = np.zeros(t_pad, dtype=np.float32)
    valid[:t] = 1.0
    wave, recon = _synth_and_ola(jnp.asarray(lps_p), jnp.asarray(frames_p),
                                 jnp.asarray(valid), frame_shift, ola_kind)
    wave = np.asarray(wave)[: t * frame_shift + (frame_length - frame_shift)]
    return to_pcm16(wave), np.asarray(recon)[:t]


def lps_to_wav(lps_enh: np.ndarray, noisy_wave: np.ndarray,
               sample_rate: int = 16000) -> np.ndarray:
    """Convenience wrapper returning only the int16 waveform."""
    return reconstruct(lps_enh, noisy_wave, sample_rate)[0]

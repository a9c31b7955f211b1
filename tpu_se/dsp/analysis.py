"""LPS analysis front-end: waveform -> 257-dim log-power-spectrum frames.

Reference semantics (``Feature_prepare/SourceCode_Wav2LogSpec_be``):

- 16 kHz only config used by the pipeline: frame length 512, shift 256,
  FFT 512 (``Wav2LogSpec_be.c:43,49,59``).
- Frame k covers samples [k*256, k*256+512); the number of emitted frames is
  ``floor(N/256) - 1`` — the circular-buffer loop preloads 256 samples and
  emits one frame per full 256-sample read (``Wav2LogSpec_be.c:401-416``).
- Hamming window ``w[i] = 0.54 - 0.46*cos(2*pi*i/(len-1))`` stored as a
  float32 half-table and applied symmetrically (``FEfunc.c:80-87,109-118``),
  so w[len-1-i] == w[i] exactly.
- Power spectrum bins 0..256 from a real FFT (``Wav2LogSpec_be.c:469-472``),
  then natural log with floor: power < e^-50 -> -50
  (``Wav2LogSpec_be.c:54,475-479``).

Design: instead of translating the split-radix FFT (``FEfunc.c:146-293``),
the whole window+FFT+power pipeline is one batched matmul against a
precomputed *windowed DFT basis* [512, 514] — all frames go through a single
GEMM, and XLA fuses the square/add/log epilogue.  A jnp.fft path is kept as a
cross-check (identical math, different schedule).

Every DSP GEMM runs at ``DSP_PRECISION`` (full fp32): the decode contract is
1 int16 LSB on samples up to 32767, which a TF32 GEMM's ~3 decimal digits
would break.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

FRAME_LENGTH = 512
FRAME_SHIFT = 256
FFT_LENGTH = 512
NUM_BINS = FFT_LENGTH // 2 + 1  # 257
LOG_FLOOR = -50.0
DSP_PRECISION = jax.lax.Precision.HIGHEST

# Per-rate framing parameters (Wav2LogSpec_be.c:37-59): the pipeline runs at
# 16 kHz; 8 and 11.025 kHz are supported by the same CLI like the reference.
# sample_rate -> (frame_length, frame_shift, fft_length)
RATE_CONFIGS = {
    8000: (256, 128, 256),
    11000: (256, 110, 256),
    16000: (512, 256, 512),
}


def rate_config(sample_rate: int) -> tuple[int, int, int]:
    """(frame_length, frame_shift, fft_length) for a sampling rate.

    11025 Hz maps to the 11 kHz config like the reference's
    ``10*floor(1e6/sampPeriod)`` header math (``Wav2LogSpec_be.c:333``).
    """
    sr = 11000 if sample_rate == 11025 else sample_rate
    if sr not in RATE_CONFIGS:
        raise ValueError(f"unsupported sampling rate {sample_rate}; "
                         f"supported: {sorted(RATE_CONFIGS)} (+11025)")
    return RATE_CONFIGS[sr]


@functools.lru_cache(maxsize=None)
def hamming_window(length: int = FRAME_LENGTH) -> np.ndarray:
    """Symmetric float32 Hamming window, exactly as the reference builds it.

    The reference computes a float32 half-table in double precision and
    mirrors it (``FEfunc.c:80-87``); we do the same so both halves are
    bit-identical to the C tables.
    """
    half = np.array(
        [0.54 - 0.46 * np.cos(2.0 * np.pi * i / (length - 1))
         for i in range(length // 2)],
        dtype=np.float32,
    )
    return np.concatenate([half, half[::-1]])


@functools.lru_cache(maxsize=None)
def _windowed_dft_basis(frame_length: int = FRAME_LENGTH,
                        fft_length: int = FFT_LENGTH) -> np.ndarray:
    """[frame_length, 2*NUM_BINS] basis: window folded into the real DFT.

    Column k      (k < NUM_BINS): w[n] *  cos(2*pi*n*k/N)
    Column 257+k  (k < NUM_BINS): w[n] * -sin(2*pi*n*k/N)

    ``(x * w) @ [C | S]`` == rfft(x * w) split into (Re, Im) — one GEMM
    instead of a per-frame scalar FFT.
    """
    n = np.arange(frame_length)[:, None].astype(np.float64)
    k = np.arange(fft_length // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / fft_length
    w = hamming_window(frame_length).astype(np.float64)[:, None]
    basis = np.concatenate([w * np.cos(ang), w * -np.sin(ang)], axis=1)
    return basis.astype(np.float32)


def num_frames(n_samples: int, frame_length: int = FRAME_LENGTH,
               frame_shift: int = FRAME_SHIFT) -> int:
    """Frames emitted by the reference front-end for an n-sample waveform.

    The loop preloads ``len - shift`` samples and emits one frame per full
    ``shift``-sample read (``Wav2LogSpec_be.c:401-416``).
    """
    return max(0, (n_samples - (frame_length - frame_shift)) // frame_shift)


def frame_signal(wave: np.ndarray, frame_length: int = FRAME_LENGTH,
                 frame_shift: int = FRAME_SHIFT) -> np.ndarray:
    """int16/float waveform [N] -> float32 frames [T, len] (zero-copy view)."""
    wave = np.asarray(wave)
    t = num_frames(len(wave), frame_length, frame_shift)
    if t == 0:
        return np.zeros((0, frame_length), dtype=np.float32)
    strided = np.lib.stride_tricks.sliding_window_view(
        wave[: (t - 1) * frame_shift + frame_length], frame_length
    )[::frame_shift]
    return strided.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("method",))
def lps_from_frames(frames: jax.Array, method: str = "matmul") -> jax.Array:
    """float32 frames [T, 512] -> log-power spectrum [T, 257].

    ``method='matmul'`` (default): windowed-DFT GEMM at full fp32.
    ``method='fft'``: jnp.fft.rfft — identical math, used as a cross-check.
    """
    frames = frames.astype(jnp.float32)
    frame_length = frames.shape[1]
    fft_length = frame_length       # all rate configs use FFT == frame length
    n_bins = fft_length // 2 + 1
    if method == "matmul":
        basis = jnp.asarray(_windowed_dft_basis(frame_length, fft_length))
        spec = jnp.dot(frames, basis, precision=DSP_PRECISION,
                       preferred_element_type=jnp.float32)
        re, im = spec[:, :n_bins], spec[:, n_bins:]
        power = re * re + im * im
    elif method == "fft":
        win = jnp.asarray(hamming_window(frame_length))
        spec = jnp.fft.rfft(frames * win[None, :], n=fft_length, axis=-1)
        power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    else:
        raise ValueError(f"unknown method {method!r}")
    floor = jnp.float32(np.exp(LOG_FLOOR))
    return jnp.where(power < floor, jnp.float32(LOG_FLOOR), jnp.log(power))


# --- Dormant ETSI mel/cepstral path -----------------------------------------
#
# The reference front-end carries the full ETSI Aurora mel-filterbank + DCT
# machinery but ships with it commented out of the frame loop
# (``Wav2LogSpec_be.c:480-505``; kernels ``FEfunc.c:472-739``).  It is
# provided here with the same status — available, unused by the LPS
# pipeline — as two precomputed matrices so the whole chain
# (power -> mel -> log -> DCT) is again just GEMMs.

NUM_CHANNELS = 23      # Wav2LogSpec_be.c:62
NUM_CEP_COEFF = 13     # c1..c12 + c0, Wav2LogSpec_be.c:67
MEL_START_FREQ = 64.0  # Wav2LogSpec_be.c:63-65 (all rates use 64 Hz)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_channels: int = NUM_CHANNELS,
                   start_freq: float = MEL_START_FREQ,
                   sample_freq: float = 16000.0,
                   fft_length: int = FFT_LENGTH) -> np.ndarray:
    """[NUM_BINS, n_channels] triangular mel filterbank as a dense matrix.

    Reproduces ``InitFFTWindows`` + ``ComputeTriangle`` (``FEfunc.c:472-604``)
    exactly: band i spans mel fractions i/(C+1) .. (i+2)/(C+1) of
    [mel(start), mel(fs/2)], edges snapped to FFT bins by round(), lower
    slope (j+1)/low_len, upper slope (high_len-j)/high_len — applied to the
    power spectrum by ``power @ mel_filterbank()``.
    """
    n_bins = fft_length // 2 + 1
    start_mel = _hz_to_mel(start_freq)
    top_mel = _hz_to_mel(sample_freq / 2.0)

    def edge_bin(i):
        freq = _mel_to_hz(start_mel + i / (n_channels + 1)
                          * (top_mel - start_mel))
        return int(fft_length * freq / sample_freq + 0.5)

    starts = [edge_bin(i) for i in range(n_channels)]
    uppers = [edge_bin(i + 2) for i in range(n_channels)]
    fb = np.zeros((n_bins, n_channels), dtype=np.float32)
    for i in range(n_channels):
        start, upper = starts[i], uppers[i]
        # low part ends at the NEXT band's start (the previous band's upper
        # edge for the last channel) -- ComputeTriangle, FEfunc.c:573-604.
        low_end = starts[i + 1] if i + 1 < n_channels else uppers[i - 1]
        low_len = low_end - start + 1
        high_len = (upper - start + 1) - low_len + 1
        for j in range(low_len):
            fb[start + j, i] = (j + 1) / low_len
        for j in range(1, high_len):
            fb[start + low_len + j - 1, i] = (high_len - j) / high_len
    return fb


@functools.lru_cache(maxsize=None)
def dct_matrix(n_cep: int = NUM_CEP_COEFF,
               n_channels: int = NUM_CHANNELS) -> np.ndarray:
    """[n_channels, n_cep] DCT basis in the reference's output order.

    ``InitDCTMatrix``/``DCT`` (``FEfunc.c:674-739``): columns are c1..c12
    (cos(pi*i/C*(j+0.5))) followed by c0 (plain sum) LAST.
    """
    mx = np.zeros((n_channels, n_cep), dtype=np.float32)
    j = np.arange(n_channels)
    for i in range(1, n_cep):
        mx[:, i - 1] = np.cos(np.pi * i / n_channels * (j + 0.5))
    mx[:, n_cep - 1] = 1.0
    return mx


@functools.partial(jax.jit, static_argnames=())
def mfcc_from_frames(frames: jax.Array) -> jax.Array:
    """float32 frames [T, 512] -> [T, 13] cepstra (c1..c12, c0).

    The dormant reference chain (``Wav2LogSpec_be.c:480-505``): power
    spectrum -> mel filterbank -> natural log with the e^-50 floor
    (``ENERGYFLOOR_FB``) -> DCT.  Three chained GEMMs.
    """
    basis = jnp.asarray(_windowed_dft_basis())
    spec = jnp.dot(frames.astype(jnp.float32), basis, precision=DSP_PRECISION,
                   preferred_element_type=jnp.float32)
    re, im = spec[:, :NUM_BINS], spec[:, NUM_BINS:]
    power = re * re + im * im
    mel = jnp.dot(power, jnp.asarray(mel_filterbank()),
                  precision=DSP_PRECISION, preferred_element_type=jnp.float32)
    floor = jnp.float32(np.exp(LOG_FLOOR))
    logmel = jnp.where(mel < floor, jnp.float32(LOG_FLOOR), jnp.log(mel))
    return jnp.dot(logmel, jnp.asarray(dct_matrix()),
                   precision=DSP_PRECISION, preferred_element_type=jnp.float32)


def wav_to_mfcc(wave: np.ndarray) -> np.ndarray:
    """Waveform -> [T, 13] MFCC via the dormant ETSI path."""
    frames = frame_signal(wave)
    if frames.shape[0] == 0:
        return np.zeros((0, NUM_CEP_COEFF), dtype=np.float32)
    return np.asarray(mfcc_from_frames(jnp.asarray(frames)))


FRAME_BUCKET = 256  # pad T to a multiple -> bounded set of compiled shapes


def wav_to_lps(wave: np.ndarray, method: str = "matmul",
               win_size: int = 0, sample_rate: int = 16000) -> np.ndarray:
    """Waveform (int16 samples) -> float32 LPS.

    End-to-end equivalent of the ``Wav2LPS_be -F RAW -fs 16`` CLI
    (``Wav2LogSpec_be.c:280-618``).  The frame count is bucket-padded
    before the jitted kernel (zero frames -> floor rows, sliced off) so
    arbitrary utterance lengths reuse a handful of compiled programs.

    ``win_size`` is the CLI's ``-win`` option: each output row stacks
    2*win_size+1 consecutive LPS frames (the delayed ring buffer,
    ``Wav2LogSpec_be.c:513-542``) and the frame count drops by 2*win_size
    (``:575``).  The whole pipeline uses win_size=0 (one frame per row).

    ``sample_rate`` selects the reference's per-rate framing
    (``Wav2LogSpec_be.c:340-366``): 16 kHz -> 512/256 (257 bins, the
    pipeline config), 8 kHz -> 256/128 (129 bins), 11/11.025 kHz -> 256/110.
    """
    frame_length, frame_shift, fft_length = rate_config(sample_rate)
    n_bins = fft_length // 2 + 1
    frames = frame_signal(wave, frame_length, frame_shift)
    t = frames.shape[0]
    if t == 0:
        return np.zeros((0, n_bins * (2 * win_size + 1)), dtype=np.float32)
    t_pad = -(-t // FRAME_BUCKET) * FRAME_BUCKET
    if t_pad != t:
        frames = np.concatenate(
            [frames, np.zeros((t_pad - t, frame_length), dtype=np.float32)])
    out = np.asarray(lps_from_frames(jnp.asarray(frames), method=method))[:t]
    if win_size == 0:
        return out
    stack = 2 * win_size + 1
    if t < stack:
        return np.zeros((0, n_bins * stack), dtype=np.float32)
    cols = [out[i: t - stack + 1 + i] for i in range(stack)]
    return np.concatenate(cols, axis=1)

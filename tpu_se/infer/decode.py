"""Batch decode: noisy wav -> enhanced wav (+ SegSNR/LSD info).

The ``Test_code/decode.m`` pipeline (SURVEY.md §3.3), fused into one
device program per utterance:

    wav -> LPS -> Z-score -> edge-replicated 7-frame splice -> DNN forward
        -> de-normalize -> exp/2 + noisy phase -> OLA -> int16 wav

Differences from training (parity-preserved): decode replicates sentence
edges so every frame is enhanced (``frame_expand.m``), and de-normalization
is ``out / inv_std + mean`` (``decode.m:60-62``).

Utterance lengths are bucketed (padded to a frame multiple) so repeated
decode calls reuse compiled programs.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from tpu_se.dsp import frame_signal, lps_from_frames, reconstruct
from tpu_se.dsp.analysis import FRAME_BUCKET, FRAME_SHIFT
from tpu_se.dsp.metrics import segsnr_lsd_pair
from tpu_se.dsp.synthesis import _synth_and_ola, to_pcm16
from tpu_se.io import read_norm, read_wav, write_wav
from tpu_se.io.wts import read_wts
from tpu_se.models import forward, params_from_wts

DECODE_PAD_BUCKET = 64


# Adaptive-blend map constants: lam = LMAX * exp(-suppression_dB / TAU),
# clipped to [0, 0.9].  The per-utterance mean suppression (noisy LPS minus
# plain enhanced LPS, in dB) is an SNR/model-confidence proxy: small
# suppression means the input is quasi-clean or the noise type is unknown
# to the model — exactly where the limiter must bite; large suppression
# means confident denoising — keep it.  Constants calibrated by maximizing
# the worst-case SegSNR/STOI margin over the 11 NON-held-out Enh_demos
# conditions only (interior grid optimum), then verified to pass all 14
# conditions on every trained arm x seed (PARITY.md §4).
BLEND_AUTO_LMAX = 0.8
BLEND_AUTO_TAU_DB = 20.0
BLEND_AUTO_MAX = 0.9


def _check_smooth_strength(strength, smooth_flag: bool = False):
    """Resolve a smoothing-strength setting to 0.0 (off), (0, 1], or 'auto'.

    ``strength=None`` defers to the binary ``smooth`` flag (the
    reference's compile-time SMOOTHPROCESS: on means s=1).  A non-zero
    strength turns smoothing on by itself; 0 turns it off even when
    ``smooth_flag`` is set.
    """
    if strength is None:
        return 1.0 if smooth_flag else 0.0
    if isinstance(strength, str) and strength == "auto":
        return "auto"
    try:
        val = float(strength)
    except (TypeError, ValueError):
        raise ValueError(f"smooth_strength must be 'auto' or in [0, 1], "
                         f"got {strength!r}")
    if not 0.0 <= val <= 1.0:
        raise ValueError(f"smooth_strength must be 'auto' or in [0, 1], "
                         f"got {strength!r}")
    return val


def _check_blend(blend):
    """Validate a blend setting: 'auto' or a numeric value in [0, 1)."""
    if isinstance(blend, str) and blend == "auto":
        return blend
    try:
        val = float(blend)
    except (TypeError, ValueError):
        raise ValueError(f"blend must be 'auto' or in [0, 1), got {blend!r}")
    if not 0.0 <= val < 1.0:
        raise ValueError(f"blend must be 'auto' or in [0, 1), got {blend!r}")
    return val


@functools.partial(jax.jit, static_argnames=("context", "compute_dtype",
                                             "blend"))
def _enhance_lps(params, lps: jax.Array, mean: jax.Array, inv_std: jax.Array,
                 n_valid: jax.Array, context: int = 7,
                 compute_dtype=jnp.float32, blend=0.0) -> jax.Array:
    """Normalized forward over edge-replicated spliced frames, on device.

    ``n_valid`` is the true (un-padded) frame count: the splice clips at
    ``n_valid - 1`` so the last frames replicate the final TRUE frame
    (``frame_expand.m:19-22``), not a bucket-pad row.

    ``blend`` in [0, 1) interpolates the enhanced LPS toward the noisy
    input LPS in the log domain (0 = the reference ``decode.m`` path; it
    is a static arg so blend=0 emits the identical program).  This is a
    suppression-depth limiter: a fraction ``blend`` of every bin's
    gain-in-dB is given back, trading noise reduction for less speech
    distortion.  No reference analog — a tpu_se serving option motivated
    by the round-3 finding that trained models over-suppress quasi-clean
    input (SegSNR/STOI regressions on high-SNR held-out conditions).

    ``blend="auto"`` picks the fraction per utterance from the model's
    own mean suppression (the BLEND_AUTO_* map above): low-SNR inputs
    keep nearly full denoising, quasi-clean/unfamiliar inputs are
    limited hard.  Measured: passes SegSNR+STOI vs noisy on all 14
    Enh_demos conditions for every trained arm x seed, with larger
    margins than any fixed blend (PARITY.md §4).
    """
    t = lps.shape[0]
    normed = (lps - mean) * inv_std
    half = (context - 1) // 2
    idx = jnp.clip(jnp.arange(t)[:, None]
                   + jnp.arange(-half, half + 1)[None, :], 0, n_valid - 1)
    x = normed[idx].reshape(t, context * lps.shape[1])
    out = forward(params, x, compute_dtype=compute_dtype)
    enh = out / inv_std + mean
    if blend == "auto":
        valid = (jnp.arange(t) < n_valid).astype(jnp.float32)[:, None]
        supp_db = (jnp.sum((lps - enh) * valid)
                   / (jnp.maximum(n_valid, 1) * lps.shape[1])
                   * (10.0 / np.log(10.0)))
        lam = jnp.clip(BLEND_AUTO_LMAX
                       * jnp.exp(-jnp.maximum(supp_db, 0.0)
                                 / BLEND_AUTO_TAU_DB),
                       0.0, BLEND_AUTO_MAX)
        enh = (1.0 - lam) * enh + lam * lps
    elif blend:
        enh = (1.0 - blend) * enh + blend * lps
    return enh


def _decode_core(params, frames: jax.Array, mean: jax.Array,
                 inv_std: jax.Array, n_valid: jax.Array,
                 frame_shift: int = FRAME_SHIFT, context: int = 7,
                 compute_dtype=jnp.float32, blend: float = 0.0):
    """The WHOLE decode pipeline as one device program: noisy frames ->
    (OLA waveform, de-windowed recon frames, enhanced LPS).

    Fuses analysis GEMM + splice + forward + de-norm + synthesis + OLA so
    an utterance costs ONE host<->device round trip instead of three —
    the dominant cost per utterance is the transfer, not the FLOPs.
    """
    lps = lps_from_frames(frames)
    enh = _enhance_lps(params, lps, mean, inv_std, n_valid, context,
                       compute_dtype, blend)
    valid = (jnp.arange(frames.shape[0]) < n_valid).astype(jnp.float32)
    wave, recon = _synth_and_ola(enh, frames, valid, frame_shift)
    return wave, recon, enh


_decode_device = functools.partial(
    jax.jit, static_argnames=("frame_shift", "context", "compute_dtype",
                              "blend")
)(_decode_core)


@functools.partial(jax.jit, static_argnames=("frame_shift", "context",
                                              "compute_dtype", "blend"))
def _decode_device_batch(params, frames: jax.Array, mean: jax.Array,
                         inv_std: jax.Array, n_valid: jax.Array,
                         frame_shift: int = FRAME_SHIFT, context: int = 7,
                         compute_dtype=jnp.float32, blend: float = 0.0):
    """Batched decode: frames [B, T, len], n_valid [B] -> vmapped
    `_decode_core`. One transfer and one program for B utterances — the
    per-utterance dispatch/transfer overhead is amortized across the
    batch (the reference decodes strictly one utterance per process,
    ``decode.m:24-68``)."""
    return jax.vmap(
        lambda f, nv: _decode_core(params, f, mean, inv_std, nv,
                                   frame_shift, context, compute_dtype,
                                   blend)
    )(frames, n_valid)


@functools.partial(jax.jit, static_argnames=("frame_shift", "context",
                                              "compute_dtype", "blend"))
def _decode_device_batch_waves(params, waves: jax.Array, mean: jax.Array,
                               inv_std: jax.Array, n_valid: jax.Array,
                               frame_shift: int = FRAME_SHIFT,
                               context: int = 7,
                               compute_dtype=jnp.float32,
                               blend: float = 0.0) -> jax.Array:
    """Serving fast path: int16 waves in, int16 waves out, framing on device.

    ``waves`` [B, S_pad] int16 with S_pad = (T_pad + 1) * frame_shift;
    framing exploits frame_length == 2 * frame_shift (the ETSI 50 %-overlap
    config, ``Wav2LogSpec_be.c:43,49``): adjacent shift-sized blocks are
    concatenated, so no gather is needed.  Only the enhanced waveform is
    returned (XLA dead-code-eliminates the recon/LPS outputs), and the
    int16 conversion (:func:`to_pcm16`, the same function the host path
    applies) happens on device — host<->device traffic drops from ~6 KB to
    ~1 KB per frame.
    """
    w = waves.astype(jnp.float32)
    b, s = w.shape
    blocks = w.reshape(b, s // frame_shift, frame_shift)
    frames = jnp.concatenate([blocks[:, :-1], blocks[:, 1:]], axis=2)

    def one(f, nv):
        wave, _, _ = _decode_core(params, f, mean, inv_std, nv,
                                  frame_shift, context, compute_dtype,
                                  blend)
        return wave

    wave_b = jax.vmap(one)(frames, n_valid)
    return to_pcm16(wave_b)


# smooth_strength="auto": fractional SMOOTHPROCESS gated by the input's
# temporal impulsiveness.  The smoother's noise floor (max power over the
# first NOISE_FRAME_NUM frames) assumes quasi-stationary noise; on
# impulsive input (a burst in or after the floor window) it smears real
# structure — measured: s=0.5 lifts PESQ on every quasi-stationary
# Enh_demos condition but costs MachineGun_SNR5 2.7 dB SegSNR.  The gate
# statistic dyn = mean |Δ mean-frame-dB| (noisy input only, fully blind)
# separates the regimes on the 11 NON-held-out conditions: MachineGun
# 3.39, Volvo 3.02, all others <= 2.01 (held-out: Destroyer 1.11, F-16
# 1.04, Pink 0.50).  s_eff = SM_AUTO_S * clip((D1 - dyn)/(D1 - D0), 0, 1).
SM_AUTO_S = 0.5
SM_AUTO_D0 = 2.0          # full strength at/below this dyn
SM_AUTO_D1 = 3.0          # zero strength at/above


def smooth_dyn_statistic(noisy_lps: np.ndarray) -> float:
    """The gate statistic: mean |Δ mean-frame-dB| of the noisy LPS."""
    frame_db = noisy_lps.mean(axis=1) * (10.0 / np.log(10.0))
    if len(frame_db) < 2:
        return float(SM_AUTO_D1)      # too short to judge -> smoothing off
    return float(np.abs(np.diff(frame_db)).mean())


def _smooth_auto_strength(noisy_lps: np.ndarray) -> float:
    dyn = smooth_dyn_statistic(noisy_lps)
    return SM_AUTO_S * float(np.clip((SM_AUTO_D1 - dyn)
                                     / (SM_AUTO_D1 - SM_AUTO_D0), 0.0, 1.0))


SWITCHPOINT = 36          # LogSpec2Wav.c:76 — low/high band split
THRESHOLD1 = -2.1         # max suppression, bins 0..36   (:77)
THRESHOLD2 = -3.43        # max suppression, bins 37..256 (:78)
NOISE_FRAME_NUM = 10      # leading frames treated as noise (:80)
SMOOTH_WIN = 1            # running-min half-window (:75)


def postprocess_lps(enh_lps: np.ndarray, noisy_lps: np.ndarray) -> np.ndarray:
    """The vocoder's POSTPROCESS option (``LogSpec2Wav.c:655-679``):
    floor the enhanced LPS at the noisy LPS plus a per-band threshold,
    bounding the maximum suppression (~9 dB low bins, ~15 dB high bins)."""
    floor = noisy_lps + np.where(
        np.arange(enh_lps.shape[1]) <= SWITCHPOINT, THRESHOLD1, THRESHOLD2)
    return np.maximum(enh_lps, floor).astype(np.float32)


def smooth_power(power: np.ndarray) -> np.ndarray:
    """The vocoder's SMOOTHPROCESS option (``LogSpec2Wav.c:497-546``):
    per frequency bin, frames whose power is below the max over the first
    NOISE_FRAME_NUM frames are replaced with a running min over the
    +-SMOOTH_WIN neighborhood (of the ORIGINAL values)."""
    t = power.shape[0]
    if t <= 2 * SMOOTH_WIN:
        return power
    noise_max = power[:NOISE_FRAME_NUM].max(axis=0, keepdims=True)
    out = power.copy()
    window_min = power.copy()
    for off in range(1, SMOOTH_WIN + 1):
        window_min[off:] = np.minimum(window_min[off:], power[:-off])
        window_min[:-off] = np.minimum(window_min[:-off], power[off:])
    region = np.zeros_like(power, dtype=bool)
    region[SMOOTH_WIN: t - SMOOTH_WIN] = True
    mask = region & (power < noise_max)
    out[mask] = window_min[mask]
    return out


class Enhancer:
    """Loaded model + normalization stats, ready to enhance utterances.

    ``mesh``: optional ``jax.sharding.Mesh`` with a ``data`` axis — the
    utterance's frame axis is sharded across it (params replicated) and
    GSPMD inserts the splice-halo and OLA-boundary collectives, scaling
    batch decode across chips. Results are identical to single-device
    decode (``tests/test_parallel.py``).

    Quality options: ``blend`` (suppression-depth limiter, fixed or
    ``"auto"``) and ``smooth_strength`` (fractional SMOOTHPROCESS, fixed
    or ``"auto"`` impulsiveness-gated; non-zero implies smoothing, 0 is
    off, ``smooth=True`` alone is the reference's binary s=1).  The
    combination ``blend="auto", smooth_strength="auto"`` improves SegSNR,
    STOI, LSD and PESQ on all 14 Enh_demos conditions for every trained
    ML arm x seed (PARITY.md §4)."""

    def __init__(self, wts_path, norm_path, context: int = 7,
                 compute_dtype=jnp.float32, postprocess: bool = False,
                 smooth: bool = False, smooth_strength=None,
                 mesh=None, sample_rate: int = 16000,
                 blend: float = 0.0):
        from tpu_se.dsp.analysis import rate_config

        self.params = params_from_wts(read_wts(wts_path))
        dim = self.params[-1]["b"].shape[0]
        (self.frame_length, self.frame_shift,
         fft_length) = rate_config(sample_rate)
        if fft_length // 2 + 1 != dim:
            raise ValueError(f"model dim {dim} != {fft_length // 2 + 1} "
                             f"bins at {sample_rate} Hz")
        self.sample_rate = sample_rate
        mean, inv_std = read_norm(norm_path, dim)
        self.mean = jnp.asarray(mean)
        self.inv_std = jnp.asarray(inv_std)
        self.context = context
        self.compute_dtype = compute_dtype
        self.postprocess = postprocess
        # Fractional SMOOTHPROCESS: power_out = (1-s)*power + s*smoothed.
        # s=1 is the reference's binary option (LogSpec2Wav.c:497-546);
        # intermediate s trades its musical-noise removal (PESQ up)
        # against its temporal smearing (SegSNR down) continuously;
        # "auto" picks s per utterance via the impulsiveness gate
        # (_smooth_auto_strength above).  A non-zero strength implies
        # smoothing by itself; strength 0 means OFF; smooth=True alone is
        # the binary reference option (s=1).
        self.smooth_strength = _check_smooth_strength(smooth_strength,
                                                      smooth)
        self.smooth = self.smooth_strength != 0.0
        self.blend = _check_blend(blend)
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._n_data = mesh.shape["data"]
            frames_sh = NamedSharding(mesh, P("data", None))
            repl = NamedSharding(mesh, P())
            self.params = jax.device_put(self.params, repl)
            self.mean = jax.device_put(self.mean, repl)
            self.inv_std = jax.device_put(self.inv_std, repl)
            self._shard_frames = lambda f: jax.device_put(f, frames_sh)
            self._shard_scalar = lambda s: jax.device_put(s, repl)

    def _pad_bucket(self, bucket: int) -> int:
        """Pad bucket, rounded so the frame axis divides the data mesh."""
        if self.mesh is None:
            return bucket
        n = self._n_data
        return -(-bucket // n) * n

    def enhance_lps(self, lps: np.ndarray) -> np.ndarray:
        """Enhanced (de-normalized) LPS [T, 257] from noisy LPS [T, 257]."""
        t = lps.shape[0]
        bucket = self._pad_bucket(DECODE_PAD_BUCKET)
        pad_t = -(-t // bucket) * bucket
        lps_p = jnp.asarray(np.pad(lps, ((0, pad_t - t), (0, 0))))
        n_valid = jnp.int32(t)
        if self.mesh is not None:
            lps_p = self._shard_frames(lps_p)
            n_valid = self._shard_scalar(n_valid)
        out = _enhance_lps(self.params, lps_p, self.mean,
                           self.inv_std, n_valid, self.context,
                           self.compute_dtype, self.blend)
        return np.asarray(out)[:t]

    def enhance(self, noisy_wave: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """noisy int16 wave -> (enhanced int16 wave, recon frames, enh LPS).

        Default path: the fully fused device program (`_decode_device`,
        one round trip).  The staged path is kept for the host-side
        postprocess/smooth options (which sit between forward and
        synthesis, ``LogSpec2Wav.c:497-546,655-679``).
        """
        frames = frame_signal(noisy_wave, self.frame_length,
                              self.frame_shift)
        t = frames.shape[0]
        n_bins = self.frame_length // 2 + 1
        if self.smooth or self.postprocess:
            lps = np.asarray(lps_from_frames(jnp.asarray(frames)))
            enh_lps = self.enhance_lps(lps)
            if self.smooth:
                power = np.where(enh_lps < -50.0, np.exp(-50.0),
                                 np.exp(enh_lps))
                s = (_smooth_auto_strength(lps)
                     if self.smooth_strength == "auto"
                     else self.smooth_strength)
                mixed = (1.0 - s) * power + s * smooth_power(power)
                enh_lps = np.log(mixed).astype(np.float32)
            if self.postprocess:
                enh_lps = postprocess_lps(enh_lps, lps)
            wave, recon = reconstruct(enh_lps, noisy_wave, self.sample_rate)
            return wave, recon, enh_lps

        if t == 0:
            return (np.zeros(0, np.int16), np.zeros((0, self.frame_length),
                    np.float32), np.zeros((0, n_bins), np.float32))
        bucket = self._pad_bucket(FRAME_BUCKET)
        t_pad = -(-t // bucket) * bucket
        frames_p = np.zeros((t_pad, self.frame_length), dtype=np.float32)
        frames_p[:t] = frames
        frames_j, n_valid = jnp.asarray(frames_p), jnp.int32(t)
        if self.mesh is not None:
            frames_j = self._shard_frames(frames_j)
            n_valid = self._shard_scalar(n_valid)
        wave, recon, enh = _decode_device(
            self.params, frames_j, self.mean, self.inv_std,
            n_valid, self.frame_shift, self.context, self.compute_dtype,
            self.blend)
        wave = np.asarray(wave)[: t * self.frame_shift
                                + (self.frame_length - self.frame_shift)]
        return (to_pcm16(wave), np.asarray(recon)[:t],
                np.asarray(enh)[:t])

    BATCH_BUCKET = 4

    def enhance_batch(self, waves: list
                      ) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Enhance B utterances in ONE device program / transfer.

        Utterances are padded to a shared frame bucket and the batch to a
        multiple of BATCH_BUCKET (and of the mesh data axis), so repeated
        calls with similar workloads reuse compiled programs. Output
        matches per-utterance ``enhance`` within 1 int16 LSB — vmap may
        change fp reduction order (``tests/test_infer.py``).
        The host-side postprocess/smooth options fall back to the staged
        per-utterance path.
        """
        if self.smooth or self.postprocess or not waves:
            return [self.enhance(w) for w in waves]
        frames = [frame_signal(w, self.frame_length, self.frame_shift)
                  for w in waves]
        ts = [f.shape[0] for f in frames]
        if max(ts) == 0:
            return [self.enhance(w) for w in waves]
        bucket = self._pad_bucket(FRAME_BUCKET)
        t_pad = -(-max(ts) // bucket) * bucket
        b_bucket = self.BATCH_BUCKET
        if self.mesh is not None:
            b_bucket = -(-b_bucket // self._n_data) * self._n_data
        b_pad = -(-len(waves) // b_bucket) * b_bucket
        frames_b = np.zeros((b_pad, t_pad, self.frame_length),
                            dtype=np.float32)
        for i, f in enumerate(frames):
            frames_b[i, : ts[i]] = f
        n_valid = np.zeros(b_pad, dtype=np.int32)
        n_valid[: len(ts)] = ts
        frames_j, n_valid_j = jnp.asarray(frames_b), jnp.asarray(n_valid)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            frames_j = jax.device_put(
                frames_j, NamedSharding(self.mesh, P("data", None, None)))
            n_valid_j = jax.device_put(
                n_valid_j, NamedSharding(self.mesh, P("data")))
        wave_b, recon_b, enh_b = _decode_device_batch(
            self.params, frames_j, self.mean, self.inv_std, n_valid_j,
            self.frame_shift, self.context, self.compute_dtype, self.blend)
        wave_b = np.asarray(wave_b)
        recon_b, enh_b = np.asarray(recon_b), np.asarray(enh_b)
        out = []
        tail = self.frame_length - self.frame_shift
        for i, t in enumerate(ts):
            if t == 0:
                out.append((np.zeros(0, np.int16),
                            np.zeros((0, self.frame_length), np.float32),
                            np.zeros((0, self.frame_length // 2 + 1),
                                     np.float32)))
                continue
            wave = to_pcm16(wave_b[i, : t * self.frame_shift + tail])
            out.append((wave, recon_b[i, :t], enh_b[i, :t]))
        return out

    def enhance_batch_waves(self, waves: list) -> list[np.ndarray]:
        """B int16 waves -> B enhanced int16 waves (serving fast path).

        Same device math as ``enhance_batch`` but with int16-only
        host<->device traffic and on-device framing/int16 conversion
        (`_decode_device_batch_waves`) — ~6x less transfer per frame.
        Output waves are bitwise-identical to ``enhance_batch``'s.
        Requires the 50 %-overlap config (frame_length == 2 * shift); the
        postprocess/smooth options fall back to the staged path.
        """
        shift = self.frame_shift
        if (self.smooth or self.postprocess or not waves
                or self.frame_length != 2 * shift):
            return [self.enhance(w)[0] for w in waves]
        ts = [max(0, (len(w) - shift) // shift) for w in waves]
        if max(ts) == 0:
            return [self.enhance(w)[0] for w in waves]
        bucket = self._pad_bucket(FRAME_BUCKET)
        t_pad = -(-max(ts) // bucket) * bucket
        b_bucket = self.BATCH_BUCKET
        if self.mesh is not None:
            b_bucket = -(-b_bucket // self._n_data) * self._n_data
        b_pad = -(-len(waves) // b_bucket) * b_bucket
        waves_b = np.zeros((b_pad, (t_pad + 1) * shift), dtype=np.int16)
        for i, w in enumerate(waves):
            n = (ts[i] + 1) * shift if ts[i] else 0
            waves_b[i, :n] = np.asarray(w[:n], dtype=np.int16)
        n_valid = np.zeros(b_pad, dtype=np.int32)
        n_valid[: len(ts)] = ts
        waves_j, n_valid_j = jnp.asarray(waves_b), jnp.asarray(n_valid)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            waves_j = jax.device_put(
                waves_j, NamedSharding(self.mesh, P("data", None)))
            n_valid_j = jax.device_put(
                n_valid_j, NamedSharding(self.mesh, P("data")))
        wave_b = np.asarray(_decode_device_batch_waves(
            self.params, waves_j, self.mean, self.inv_std, n_valid_j,
            shift, self.context, self.compute_dtype, self.blend))
        tail = self.frame_length - shift
        return [wave_b[i, : t * shift + tail] if t
                else np.zeros(0, np.int16) for i, t in enumerate(ts)]


def enhance_utterance(wts_path, norm_path, noisy_wave: np.ndarray
                      ) -> np.ndarray:
    return Enhancer(wts_path, norm_path).enhance(noisy_wave)[0]


def decode_files(wts_path, norm_path, wav_paths: list, out_dir,
                 clean_paths: list | None = None, log=print,
                 mesh=None, noisy_info: bool = False,
                 batch_size: int = 0, postprocess: bool = False,
                 smooth: bool = False, smooth_strength=None,
                 sample_rate: int = 16000,
                 blend: float = 0.0) -> list[dict]:
    """decode.m batch loop: enhance each wav, write *_enhanced.wav + info.

    With ``clean_paths`` given, per-utterance SegSNR/LSD (enhanced and noisy
    baselines) are computed as ``LPS2Wav_be`` writes to info.txt.
    ``noisy_info`` additionally writes the noisy baseline to a separate
    ``<input-filename>.info`` file (the ``-ni`` flag,
    ``LogSpec2Wav.c:843-861``). The reference writes that file beside the
    noisy input; we keep the same filename convention but place it in
    ``out_dir`` so read-only input trees still decode.
    ``mesh`` shards decode across the data axis (the frame axis per
    utterance, or the batch axis with ``batch_size``). ``batch_size`` > 1
    decodes that many utterances per device program (``enhance_batch``);
    the default path streams one utterance at a time to bound host memory.
    """
    os.makedirs(out_dir, exist_ok=True)
    enh = Enhancer(wts_path, norm_path, mesh=mesh,
                   postprocess=postprocess, smooth=smooth,
                   smooth_strength=smooth_strength,
                   sample_rate=sample_rate, blend=blend)
    if batch_size > 1:
        waves_srs = [read_wav(p) for p in wav_paths]
        norm_sr = 11000 if sample_rate == 11025 else sample_rate
        for (_, sr), p in zip(waves_srs, wav_paths):
            if (11000 if sr == 11025 else sr) != norm_sr:
                raise ValueError(f"{p}: sample rate {sr} != decoder's "
                                 f"{sample_rate} (pass sample_rate=)")
        outputs = []
        for lo in range(0, len(waves_srs), batch_size):
            chunk = [w for w, _ in waves_srs[lo: lo + batch_size]]
            if clean_paths is None:
                # No metrics needed -> int16-only fast path (the recon
                # frames / LPS are only used for SegSNR/LSD).
                outputs.extend((w, None, None)
                               for w in enh.enhance_batch_waves(chunk))
            else:
                outputs.extend(enh.enhance_batch(chunk))
    else:
        waves_srs = outputs = None
    norm_sr = 11000 if sample_rate == 11025 else sample_rate
    results = []
    for i, path in enumerate(wav_paths):
        noisy, sr = (waves_srs[i] if waves_srs is not None
                     else read_wav(path))
        if (11000 if sr == 11025 else sr) != norm_sr:
            raise ValueError(f"{path}: sample rate {sr} != decoder's "
                             f"{sample_rate} (pass sample_rate=)")
        wave, recon, enh_lps = (outputs[i] if outputs is not None
                                else enh.enhance(noisy))
        stem = os.path.splitext(os.path.basename(str(path)))[0]
        out_path = os.path.join(out_dir, stem + "_enhanced.wav")
        write_wav(out_path, wave, sr)
        info = {"wav": str(path), "out": out_path}
        if clean_paths is not None:
            clean, _ = read_wav(clean_paths[i])
            power = np.where(enh_lps < -50.0, np.exp(-50.0), np.exp(enh_lps))
            info.update(segsnr_lsd_pair(clean, noisy, recon, power))
            with open(os.path.join(out_dir, stem + ".info.txt"), "w") as f:
                f.write("Segmental SNR:\n%f\n" % info["segsnr"])
                f.write("Log-Spectral Distortion:\n%f\n" % info["lsd"])
            if noisy_info:
                # LogSpec2Wav.c:846-847 names this <noisy-input>.info; we
                # keep the filename but write into out_dir (see docstring).
                ni_name = os.path.basename(str(path)) + ".info"
                with open(os.path.join(out_dir, ni_name), "w") as f:
                    f.write("Segmental SNR:\n%f\n" % info["segsnr_noisy"])
                    f.write("Log-Spectral Distortion:\n%f\n"
                            % info["lsd_noisy"])
            log(f"{stem}: segsnr={info['segsnr']:.2f} "
                f"(noisy {info['segsnr_noisy']:.2f}) "
                f"lsd={info['lsd']:.2f} (noisy {info['lsd_noisy']:.2f})")
        else:
            log(f"{stem}: enhanced -> {out_path}")
        results.append(info)
    return results

"""Streaming low-latency enhancement: hop-in, hop-out with a fixed delay.

A serving capability beyond the reference (whose decode path is file-batch
only, ``Test_code/decode.m``): a stateful, jit-compiled step consumes one
``frame_shift``-sample hop per stream and emits one enhanced hop, producing
output **sample-exact with the batch decode path** — same framing preload
(``Wav2LogSpec_be.c:401-416``), same edge replication as ``frame_expand.m``,
same OLA / sum-of-squared-window normalization as ``LogSpec2Wav.c:798-827``
— at an algorithmic latency of

    half_context hops + one frame = 3*256 + 512 = 1280 samples = 80 ms
    at 16 kHz (the model's inherent lookahead; the engine adds none).

Design:

- The whole per-hop pipeline — windowed-DFT GEMM, 7-frame splice from a
  device-resident ring, DNN forward, inverse-DFT GEMM, overlap-add — is ONE
  jitted program with static shapes.  State (sample ring, LPS/spec rings,
  OLA accumulators) lives on device between calls; the host ships only the
  raw hop in and the enhanced hop out (1 KB each way).
- ``n_streams`` independent channels are batched on the leading axis, so a
  serving deployment fills larger GEMMs: at S=128 the forward GEMM is the
  training bunch shape.
- The analysis/synthesis transforms reuse the batch path's windowed-DFT
  basis (``tpu_se/dsp/analysis.py``); the inverse is the standard inverse
  real DFT as one GEMM — no per-frame scalar FFT (``FEfunc.c:296-447``).
  Both run at ``DSP_PRECISION`` (full fp32) like the batch path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_se.dsp.analysis import (
    DSP_PRECISION, LOG_FLOOR, _windowed_dft_basis, hamming_window,
    rate_config,
)
from tpu_se.dsp.synthesis import to_pcm16
from tpu_se.io import read_norm
from tpu_se.io.wts import read_wts
from tpu_se.models import forward, params_from_wts


@functools.lru_cache(maxsize=None)
def _inverse_dft_basis(frame_length: int, fft_length: int) -> np.ndarray:
    """[2*n_bins, frame_length] basis: (Re | Im) @ B == irfft(Re + i*Im).

    Row k (k <= N/2):        c_k/N *  cos(2*pi*k*n/N)
    Row n_bins + k:          c_k/N * -sin(2*pi*k*n/N)
    with c_0 = c_{N/2} = 1 and c_k = 2 otherwise — the standard inverse
    real DFT, identical to the reference's ``rifft`` (``FEfunc.c:296-447``,
    which divides by N) and to ``jnp.fft.irfft``.
    """
    n_bins = fft_length // 2 + 1
    k = np.arange(n_bins)[:, None].astype(np.float64)
    n = np.arange(frame_length)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * n / fft_length
    c = np.full((n_bins, 1), 2.0)
    c[0, 0] = 1.0
    if fft_length % 2 == 0:
        c[-1, 0] = 1.0
    basis = np.concatenate(
        [c / fft_length * np.cos(ang), c / fft_length * -np.sin(ang)], axis=0)
    return basis.astype(np.float32)


def inverse_dft(spec: jax.Array, frame_length: int) -> jax.Array:
    """(Re | Im) [..., 2*n_bins] -> real frames [..., frame_length]: the
    inverse real DFT as one full-fp32 GEMM (== ``np.fft.irfft``)."""
    inv_basis = jnp.asarray(_inverse_dft_basis(frame_length, frame_length))
    return jnp.dot(spec, inv_basis, precision=DSP_PRECISION,
                   preferred_element_type=jnp.float32)


class StreamState(NamedTuple):
    """Device-resident per-stream state (leading axis = n_streams)."""

    ring: jax.Array       # [S, ring_hops*shift] newest input samples
    lps_ring: jax.Array   # [S, context, n_bins] normalized LPS, oldest first
    spec_ring: jax.Array  # [S, half+1, 2*n_bins] raw (Re|Im), oldest first
    acc: jax.Array        # [S, frame_length] OLA signal accumulator
    w2: jax.Array         # [S, frame_length] OLA squared-window accumulator
    hops: jax.Array       # [S] int32: input hops consumed
    count: jax.Array      # [S] int32: frames pushed into the rings
    supp_ema: jax.Array   # [S] running mean suppression (dB) for blend=auto
    noise_max: jax.Array  # [S, n_bins] causal noise floor (smooth mode)
    sm_prev: jax.Array    # [S, n_bins] previous enhanced-frame power
    sm_prev_db: jax.Array  # [S] previous noisy mean-frame dB
    dyn_ema: jax.Array    # [S] EMA |Δ frame dB| (impulsiveness gate)


def _ring_hops(frame_length: int, frame_shift: int) -> int:
    return -(-frame_length // frame_shift)


# blend="auto" EMA coefficient: per-16ms-hop decay for a ~1 s time constant
# (exp(-0.016/1.0)); longer streams converge to the batch path's
# utterance-mean suppression for stationary noise.
_SUPP_EMA_ALPHA = 0.984

# smooth="auto" impulsiveness EMA: faster (~0.3 s) — bursts reveal
# themselves quickly and the gate must close before they get smeared.
# dyn_ema initializes at SM_AUTO_D1 so streams START with smoothing OFF
# (the conservative direction, mirroring the blend EMA's maximal start)
# and ramp it in as the input proves quasi-stationary.
_DYN_EMA_ALPHA = 0.95


def _init_state(n_streams: int, frame_length: int, frame_shift: int,
                n_bins: int, context: int) -> StreamState:
    from tpu_se.infer.decode import SM_AUTO_D1

    half = (context - 1) // 2
    z = functools.partial(jnp.zeros, dtype=jnp.float32)
    return StreamState(
        ring=z((n_streams, _ring_hops(frame_length, frame_shift)
                * frame_shift)),
        lps_ring=z((n_streams, context, n_bins)),
        spec_ring=z((n_streams, half + 1, 2 * n_bins)),
        acc=z((n_streams, frame_length)),
        w2=z((n_streams, frame_length)),
        hops=jnp.zeros((n_streams,), dtype=jnp.int32),
        count=jnp.zeros((n_streams,), dtype=jnp.int32),
        supp_ema=z((n_streams,)),
        noise_max=z((n_streams, n_bins)),
        sm_prev=z((n_streams, n_bins)),
        sm_prev_db=z((n_streams,)),
        dyn_ema=jnp.full((n_streams,), SM_AUTO_D1, dtype=jnp.float32),
    )


def _enhance_and_emit(params, mean, inv_std, state: StreamState,
                      frame_shift: int, compute_dtype, blend: float = 0.0,
                      smooth=0.0) -> tuple[StreamState, jax.Array]:
    """Shared back half of a step: splice -> forward -> synth -> OLA.

    The rings in ``state`` have already been advanced for this step.  The
    center frame c = count-1-half is enhanced and overlap-added; the
    completed hop [c*shift, (c+1)*shift) is emitted (garbage while c < 0 —
    the wrapper discards those).

    ``blend`` is the suppression-depth limiter (see ``infer/decode.py``):
    the center frame's noisy LPS is recovered from the normalized ring
    (``normed / inv_std + mean``), so streaming blend matches batch-decode
    blend to fp rounding (1 int16 LSB on the wire).
    """
    s, context, n_bins = state.lps_ring.shape
    frame_length = state.acc.shape[1]
    half = (context - 1) // 2

    x = state.lps_ring.reshape(s, context * n_bins)
    out = forward(params, x, compute_dtype=compute_dtype)
    enh = out / inv_std + mean
    if blend == "auto":
        # Streaming analog of the batch auto-blend: the per-utterance mean
        # suppression becomes a causal EMA over frames (~1 s time constant
        # at 16 ms hops).  The EMA starts at 0 dB, i.e. the limiter starts
        # at LMAX (maximally conservative) and relaxes as the model shows
        # confident suppression — safe for unknown stream starts.
        from tpu_se.infer.decode import (
            BLEND_AUTO_LMAX, BLEND_AUTO_MAX, BLEND_AUTO_TAU_DB,
        )
        noisy_lps = state.lps_ring[:, half] / inv_std + mean
        frame_ok = (state.count - 1 >= half).astype(jnp.float32)
        supp_db = (jnp.mean(noisy_lps - enh, axis=1)
                   * jnp.float32(10.0 / np.log(10.0)))
        alpha = jnp.float32(_SUPP_EMA_ALPHA)
        ema = jnp.where(frame_ok > 0,
                        alpha * state.supp_ema + (1.0 - alpha) * supp_db,
                        state.supp_ema)
        state = state._replace(supp_ema=ema)
        lam = jnp.clip(BLEND_AUTO_LMAX
                       * jnp.exp(-jnp.maximum(ema, 0.0)
                                 / BLEND_AUTO_TAU_DB),
                       0.0, BLEND_AUTO_MAX)[:, None]
        enh = (1.0 - lam) * enh + lam * noisy_lps
    elif blend:
        noisy_lps = state.lps_ring[:, half] / inv_std + mean
        enh = (1.0 - blend) * enh + blend * noisy_lps

    cspec = state.spec_ring[:, 0]
    cre, cim = cspec[:, :n_bins], cspec[:, n_bins:]
    mag = jnp.sqrt(cre * cre + cim * cim)
    power = jnp.where(enh < LOG_FLOOR, jnp.float32(np.exp(LOG_FLOOR)),
                      jnp.exp(enh))
    if smooth:
        # Causal analog of the batch fractional smoother (decode.py
        # smooth_power + _smooth_auto_strength).  Deviations forced by
        # causality, mirroring the blend EMA's design: the noise floor
        # accumulates over the first NOISE_FRAME_NUM frames as they
        # arrive (the batch sees all 10 before smoothing frame 1); the
        # running-min window is {c-1, c} (no +1 lookahead — adding one
        # would cost a hop of extra latency); the impulsiveness gate is
        # an EMA starting OFF (batch: whole-utterance statistic).
        from tpu_se.infer.decode import (
            NOISE_FRAME_NUM, SM_AUTO_D0, SM_AUTO_D1, SM_AUTO_S,
        )

        fidx = state.count - 1 - half                     # center frame no.
        power_orig = power
        in_floor = ((fidx >= 0) & (fidx < NOISE_FRAME_NUM))[:, None]
        noise_max = jnp.where(in_floor,
                              jnp.maximum(state.noise_max, power),
                              state.noise_max)
        has_prev = (fidx >= 1)[:, None]
        wmin = jnp.minimum(jnp.where(has_prev, state.sm_prev, power), power)
        mask = has_prev & (power < noise_max)
        smoothed = jnp.where(mask, wmin, power)
        if smooth == "auto":
            s_eff = SM_AUTO_S * jnp.clip(
                (SM_AUTO_D1 - state.dyn_ema) / (SM_AUTO_D1 - SM_AUTO_D0),
                0.0, 1.0)[:, None]
        else:
            s_eff = jnp.float32(smooth)
        power = (1.0 - s_eff) * power + s_eff * smoothed
        state = state._replace(
            noise_max=noise_max,
            sm_prev=jnp.where((fidx >= 0)[:, None], power_orig,
                              state.sm_prev))
    scale = jnp.where(mag > 0.0, jnp.sqrt(power) / jnp.maximum(mag, 1e-30),
                      0.0)
    synth = inverse_dft(jnp.concatenate([cre * scale, cim * scale], axis=1),
                        frame_length)

    win = jnp.asarray(hamming_window(frame_length))
    # The center frame exists once count-1 >= half frames have been pushed;
    # invalid frames contribute neither signal nor window weight (exactly
    # the batch path's validity mask, synthesis.py).
    valid = (state.count - 1 >= half).astype(jnp.float32)[:, None]
    acc = state.acc + synth * win[None, :] * valid
    w2 = state.w2 + (win * win)[None, :] * valid
    hop_out = acc[:, :frame_shift] / jnp.maximum(w2[:, :frame_shift], 1e-20)
    pad = ((0, 0), (0, frame_shift))
    acc = jnp.pad(acc[:, frame_shift:], pad)
    w2 = jnp.pad(w2[:, frame_shift:], pad)
    return state._replace(acc=acc, w2=w2), hop_out


@functools.partial(jax.jit,
                   static_argnames=("frame_shift", "compute_dtype",
                                    "blend", "smooth"))
def _stream_step(params, mean, inv_std, state: StreamState, hop: jax.Array,
                 frame_shift: int, compute_dtype=jnp.float32,
                 blend: float = 0.0, smooth=0.0
                 ) -> tuple[StreamState, jax.Array]:
    """One hop in, one hop out, for all S streams."""
    ring = jnp.concatenate([state.ring[:, frame_shift:], hop], axis=1)
    frame_length = state.acc.shape[1]
    n_bins = frame_length // 2 + 1
    # Frame f = hops+1-ring_hops starts at ring[0] once enough hops arrived
    # (the reference preloads len-shift samples, Wav2LogSpec_be.c:401-404).
    ring_hops = ring.shape[1] // frame_shift
    frame_ready = state.hops + 1 >= ring_hops
    frame = ring[:, :frame_length]

    basis = jnp.asarray(_windowed_dft_basis(frame_length, frame_length))
    spec = jnp.dot(frame, basis, precision=DSP_PRECISION,
                   preferred_element_type=jnp.float32)
    re, im = spec[:, :n_bins], spec[:, n_bins:]
    power = re * re + im * im
    lps = jnp.where(power < jnp.float32(np.exp(LOG_FLOOR)),
                    jnp.float32(LOG_FLOOR), jnp.log(power))
    normed = (lps - mean) * inv_std

    # First frame replicates into the whole ring — exactly the left-edge
    # clipping of the batch splice (frame_expand.m:7-10).
    ready = frame_ready[:, None, None]
    first = (state.count == 0)[:, None, None]
    context = state.lps_ring.shape[1]
    lps_ring = jnp.where(
        ready,
        jnp.where(first, jnp.repeat(normed[:, None, :], context, axis=1),
                  jnp.concatenate([state.lps_ring[:, 1:], normed[:, None, :]],
                                  axis=1)),
        state.lps_ring)
    spec_ring = jnp.where(
        ready,
        jnp.concatenate([state.spec_ring[:, 1:], spec[:, None, :]], axis=1),
        state.spec_ring)

    if smooth == "auto":
        # Impulsiveness EMA from the NOISY input (blind, like the batch
        # gate statistic): |Δ mean-frame-dB| between consecutive frames.
        frame_db = jnp.mean(lps, axis=1) * jnp.float32(10.0 / np.log(10.0))
        have_prev = frame_ready & (state.count >= 1)
        d = jnp.abs(frame_db - state.sm_prev_db)
        a = jnp.float32(_DYN_EMA_ALPHA)
        dyn_ema = jnp.where(have_prev,
                            a * state.dyn_ema + (1.0 - a) * d,
                            state.dyn_ema)
        sm_prev_db = jnp.where(frame_ready, frame_db, state.sm_prev_db)
        state = state._replace(dyn_ema=dyn_ema, sm_prev_db=sm_prev_db)
    state = state._replace(
        ring=ring, lps_ring=lps_ring, spec_ring=spec_ring,
        hops=state.hops + 1,
        count=state.count + frame_ready.astype(jnp.int32))
    return _enhance_and_emit(params, mean, inv_std, state, frame_shift,
                             compute_dtype, blend, smooth)


@functools.partial(jax.jit,
                   static_argnames=("frame_shift", "compute_dtype",
                                    "blend", "smooth"))
def _stream_scan(params, mean, inv_std, state: StreamState, hops: jax.Array,
                 frame_shift: int, compute_dtype=jnp.float32,
                 blend: float = 0.0, smooth=0.0
                 ) -> tuple[StreamState, jax.Array]:
    """K hops in one dispatch: ``lax.scan`` over the hop axis of
    [S, K, shift] — the chunked-streaming path that amortizes host/device
    round-trip latency over K hops (identical math to K ``_stream_step``s).
    """

    def body(st, hop):
        return _stream_step(params, mean, inv_std, st, hop, frame_shift,
                            compute_dtype, blend, smooth)

    state, outs = jax.lax.scan(body, state, jnp.swapaxes(hops, 0, 1))
    return state, jnp.swapaxes(outs, 0, 1)


@functools.partial(jax.jit,
                   static_argnames=("frame_shift", "compute_dtype",
                                    "blend", "smooth"))
def _stream_scan_i16(params, mean, inv_std, state: StreamState,
                     hops: jax.Array, frame_shift: int,
                     compute_dtype=jnp.float32, blend: float = 0.0,
                     smooth=0.0
                     ) -> tuple[StreamState, jax.Array]:
    """`_stream_scan` with an int16 wire: int16 hops in, int16 hops out.

    The f32 cast-in and the int16 conversion (:func:`to_pcm16`) live inside
    the program, so host<->device traffic is halved vs the float32 wire
    while the stream state and all math stay float32 (identical values for
    integer-valued input, i.e. real PCM audio)."""
    state, outs = _stream_scan(params, mean, inv_std, state,
                               hops.astype(jnp.float32), frame_shift,
                               compute_dtype, blend, smooth)
    return state, to_pcm16(outs)


@functools.partial(jax.jit,
                   static_argnames=("frame_shift", "compute_dtype",
                                    "blend", "smooth"))
def _flush_step(params, mean, inv_std, state: StreamState,
                frame_shift: int, compute_dtype=jnp.float32,
                blend: float = 0.0, smooth=0.0
                ) -> tuple[StreamState, jax.Array]:
    """Drain one latency hop: re-push the newest LPS frame (right-edge
    replication, ``frame_expand.m:19-22``) without consuming input."""
    state = state._replace(
        lps_ring=jnp.concatenate(
            [state.lps_ring[:, 1:], state.lps_ring[:, -1:]], axis=1),
        spec_ring=jnp.concatenate(
            [state.spec_ring[:, 1:], state.spec_ring[:, -1:]], axis=1),
        count=state.count + 1)
    return _enhance_and_emit(params, mean, inv_std, state, frame_shift,
                             compute_dtype, blend, smooth)


class StreamingEnhancer:
    """Stateful real-time enhancer over ``n_streams`` concurrent channels.

    Single-stream use (arbitrary sample chunks, buffered internally)::

        s = StreamingEnhancer(wts, norm)
        out = [s.feed(chunk) for chunk in chunks]   # int16 pieces
        out.append(s.flush())
        enhanced = np.concatenate(out)              # == batch Enhancer

    Multi-stream serving: call :meth:`push` with aligned [S, shift] hop
    batches (or :meth:`push_many` with [S, K, shift] chunks to amortize
    dispatch latency); warm outputs start after ``warmup_hops`` pushes.

    Quality options stream via causal analogs: ``blend="auto"`` uses a
    ~1 s suppression EMA; ``smooth_strength`` (fixed or ``"auto"``) uses
    a causal noise floor + {c-1, c} min window with an impulsiveness EMA
    that starts smoothing OFF.  Measured: the streamed quality config
    still improves all four metrics vs noisy on 14/14 Enh_demos
    conditions (``STREAM_QUALITY.json``).
    """

    SCAN_HOPS = 8  # hops per scanned dispatch in feed()

    def __init__(self, wts_path, norm_path, n_streams: int = 1,
                 context: int = 7, compute_dtype=jnp.float32,
                 sample_rate: int = 16000, mesh=None, blend: float = 0.0,
                 smooth_strength=None):
        from tpu_se.infer.decode import _check_blend, _check_smooth_strength

        self.blend = _check_blend(blend)
        # Same resolution as the batch Enhancer: non-zero strength turns
        # the (causal) smoother on by itself; None/0 = off.
        self.smooth = _check_smooth_strength(smooth_strength)
        self.params = params_from_wts(read_wts(wts_path))
        dim = self.params[-1]["b"].shape[0]
        mean, inv_std = read_norm(norm_path, dim)
        self.mean = jnp.asarray(mean)
        self.inv_std = jnp.asarray(inv_std)
        (self.frame_length, self.frame_shift,
         fft_length) = rate_config(sample_rate)
        self.n_bins = fft_length // 2 + 1
        if self.n_bins != dim:
            raise ValueError(f"model dim {dim} != {self.n_bins} bins "
                             f"at {sample_rate} Hz")
        self.context = context
        self.half = (context - 1) // 2
        self.ring_hops = _ring_hops(self.frame_length, self.frame_shift)
        self.compute_dtype = compute_dtype
        self.n_streams = n_streams
        self.state = _init_state(n_streams, self.frame_length,
                                 self.frame_shift, self.n_bins, context)
        self.mesh = mesh
        self._hop_put = jnp.asarray
        if mesh is not None:
            # Multi-chip serving: independent channels shard over the
            # 'data' axis (state + hops on axis 0), weights replicated —
            # every stream step then runs SPMD with zero collectives (the
            # channels never interact).
            from tpu_se.parallel import batch_sharding, replicated_sharding
            data = mesh.shape["data"]
            if n_streams % data:
                raise ValueError(f"n_streams {n_streams} not divisible by "
                                 f"mesh data axis {data}")
            rep = replicated_sharding(mesh)
            self.params = jax.device_put(self.params, rep)
            self.mean = jax.device_put(self.mean, rep)
            self.inv_std = jax.device_put(self.inv_std, rep)
            self.state = StreamState(*(
                jax.device_put(a, batch_sharding(mesh, a.ndim, 0))
                for a in self.state))

            def _hop_put(hops, _mesh=mesh):
                arr = jnp.asarray(hops)
                return jax.device_put(
                    arr, batch_sharding(_mesh, arr.ndim, 0))

            self._hop_put = _hop_put
        self._pushed = 0          # frames pushed into the rings (real+flush)
        self._hops = 0            # input hops consumed
        self._pending = np.zeros((0,), dtype=np.float32)

    @property
    def latency_samples(self) -> int:
        """Algorithmic input->output delay in samples."""
        return self.half * self.frame_shift + self.frame_length

    @property
    def warmup_hops(self) -> int:
        """push() calls before the first valid output hop."""
        return self.ring_hops - 1 + self.half + 1

    def push(self, hops: np.ndarray) -> np.ndarray | None:
        """[S, shift] float32 hops -> [S, shift] float32 enhanced hop, or
        ``None`` during the first ``warmup_hops - 1`` calls."""
        self.state, out = _stream_step(
            self.params, self.mean, self.inv_std, self.state,
            self._hop_put(np.asarray(hops, dtype=np.float32)),
            self.frame_shift, self.compute_dtype, self.blend, self.smooth)
        self._hops += 1
        if self._hops >= self.ring_hops:
            self._pushed += 1
        # Emitted hop is frame c = pushed-1-half; valid once c >= 0.
        return (np.asarray(out) if self._pushed - 1 - self.half >= 0
                else None)

    def push_many(self, hops: np.ndarray, int16_wire: bool = False
                  ) -> tuple[np.ndarray, np.ndarray]:
        """[S, K, shift] hops in ONE device dispatch (scanned) ->
        ([S, K, shift] enhanced hops, [K] bool validity mask).

        Identical sample-for-sample to K :meth:`push` calls; use for
        chunked streaming where the client delivers K hops at a time —
        the host/device round trip is paid once per chunk, not per hop.

        ``int16_wire``: ship int16 both ways (PCM audio is int16-valued
        anyway) — halves the transfer per chunk, which is what bounds
        multi-channel serving throughput; enhanced hops come back int16
        (same values as truncating the float32-wire output).
        """
        k = hops.shape[1]
        h0 = self._hops
        if int16_wire:
            self.state, outs = _stream_scan_i16(
                self.params, self.mean, self.inv_std, self.state,
                self._hop_put(np.asarray(hops, dtype=np.int16)),
                self.frame_shift, self.compute_dtype, self.blend,
                self.smooth)
        else:
            self.state, outs = _stream_scan(
                self.params, self.mean, self.inv_std, self.state,
                self._hop_put(np.asarray(hops, dtype=np.float32)),
                self.frame_shift, self.compute_dtype, self.blend,
                self.smooth)
        self._hops += k
        self._pushed += (max(0, self._hops - (self.ring_hops - 1))
                         - max(0, h0 - (self.ring_hops - 1)))
        valid = np.arange(h0, h0 + k) >= self.warmup_hops - 1
        return np.asarray(outs), valid

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Single-stream: arbitrary-length int16/float samples in, all
        currently-available enhanced int16 samples out."""
        if self.n_streams != 1:
            raise ValueError("feed() is single-stream; use push()")
        buf = np.concatenate(
            [self._pending, np.asarray(samples, dtype=np.float32)])
        shift = self.frame_shift
        pieces = []
        n_hops = len(buf) // shift
        i = 0
        # Full SCAN_HOPS groups go through the scanned multi-hop program
        # (one dispatch per group); stragglers through the single-hop step.
        # The int16 wire wraps values outside [-32768, 32767]; only ride it
        # for genuine 16-bit PCM (integer-valued AND in range).
        int_input = buf.size == 0 or (
            float(np.sum(buf != np.trunc(buf))) == 0.0
            and float(np.abs(buf).max()) < 32768.0)
        while n_hops - i >= self.SCAN_HOPS:
            chunk = buf[i * shift:(i + self.SCAN_HOPS) * shift]
            # PCM (integer-valued) input rides the int16 wire: half the
            # transfer, identical values (feed() emits int16 anyway).
            outs, valid = self.push_many(
                chunk.reshape(1, self.SCAN_HOPS, shift),
                int16_wire=int_input)
            pieces.extend(outs[0, j] for j in range(self.SCAN_HOPS)
                          if valid[j])
            i += self.SCAN_HOPS
        for h in range(i, n_hops):
            out = self.push(buf[h * shift:(h + 1) * shift][None, :])
            if out is not None:
                pieces.append(out[0])
        self._pending = buf[n_hops * shift:]
        if not pieces:
            return np.zeros((0,), dtype=np.int16)
        return to_pcm16(np.concatenate(pieces))

    def flush(self) -> np.ndarray:
        """Drain the latency pipeline (single-stream).

        Trailing samples short of a full hop form one more frame only when
        they reach the frame boundary the batch framer uses (``num_frames``,
        analysis.py): at 16 kHz (len = 2*shift) never, at 11 kHz (len =
        2.33*shift) when >= len - (ring_hops-1)*shift samples remain.
        That last hop is zero-padded (the zeros fall outside the frame);
        anything shorter is dropped, exactly like the batch framer."""
        if self.n_streams != 1:
            raise ValueError("flush() is single-stream; use flush_hops()")
        pieces = []
        need = self.frame_length - (self.ring_hops - 1) * self.frame_shift
        if len(self._pending) >= need:
            pad = np.zeros(self.frame_shift - len(self._pending),
                           dtype=np.float32)
            out = self.push(np.concatenate([self._pending, pad])[None, :])
            if out is not None:
                pieces.append(to_pcm16(out[0]))
        self._pending = np.zeros((0,), dtype=np.float32)
        pieces.extend(to_pcm16(out[0]) for out in self.flush_hops())
        ntail = self.frame_length - self.frame_shift
        tail = (np.asarray(self.state.acc)[:, :ntail]
                / np.maximum(np.asarray(self.state.w2)[:, :ntail], 1e-20))
        pieces.append(to_pcm16(tail[0]))
        return np.concatenate(pieces)

    def flush_hops(self):
        """Yield the drain hops [S, shift] (multi-stream flush): ``half``
        steps of right-edge replication, skipping still-warming ones."""
        for _ in range(self.half):
            self.state, out = _flush_step(
                self.params, self.mean, self.inv_std, self.state,
                self.frame_shift, self.compute_dtype, self.blend,
                self.smooth)
            self._pushed += 1
            if self._pushed - 1 - self.half >= 0:
                yield np.asarray(out)

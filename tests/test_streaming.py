"""Streaming enhancement: batch parity, edge semantics, multi-stream."""

import numpy as np
import pytest

from tpu_se.io import read_norm, read_wav, write_wts
from tpu_se.io.norm import write_norm
from tpu_se.models import init_params, params_to_wts

NOISY_DEMO = "Enh_demos/F-16Cockpit_SNR10_NOISY_TEST_DR1_MWBT0_SX23.wav"


@pytest.fixture(scope="module")
def small_model(tmp_path_factory, reference_dir):
    d = tmp_path_factory.mktemp("stream_model")
    params = init_params(7, (1799, 64, 64, 257))
    wts = str(d / "m.wts")
    write_wts(wts, params_to_wts(params))
    mean, inv_std = read_norm(reference_dir / "tools_pfile/train_noisy.norm",
                              257)
    norm = str(d / "m.norm")
    write_norm(norm, mean, inv_std)
    return wts, norm


def test_stream_matches_batch(reference_dir, small_model):
    """feed()+flush() over random-sized chunks == the batch Enhancer,
    to 1 int16 LSB (fp reassociation across GEMM shapes)."""
    from tpu_se.infer import Enhancer, StreamingEnhancer

    wts, norm = small_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    batch = Enhancer(wts, norm).enhance(noisy)[0].astype(np.int32)

    s = StreamingEnhancer(wts, norm)
    rng = np.random.default_rng(0)
    pieces, i = [], 0
    while i < len(noisy):
        n = int(rng.integers(1, 2000))
        pieces.append(s.feed(noisy[i:i + n]))
        i += n
    pieces.append(s.flush())
    stream = np.concatenate(pieces).astype(np.int32)

    assert stream.shape == batch.shape
    diff = np.abs(stream - batch)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02


def test_stream_blend_matches_batch_blend(reference_dir, small_model):
    """Streaming with the suppression-depth limiter == batch decode with
    the same blend, to 1 int16 LSB (streaming recovers the center frame's
    noisy LPS from the normalized ring, an extra fp round trip)."""
    from tpu_se.infer import Enhancer, StreamingEnhancer

    wts, norm = small_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    batch = Enhancer(wts, norm, blend=0.5).enhance(noisy)[0].astype(np.int32)

    s = StreamingEnhancer(wts, norm, blend=0.5)
    stream = np.concatenate([s.feed(noisy), s.flush()]).astype(np.int32)
    assert stream.shape == batch.shape
    diff = np.abs(stream - batch)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02
    # and blend actually changes the output vs plain streaming
    s0 = StreamingEnhancer(wts, norm)
    plain = np.concatenate([s0.feed(noisy), s0.flush()]).astype(np.int32)
    assert np.abs(plain - stream).max() > 1


def test_enhance_lps_replicates_true_edges(reference_dir, small_model):
    """Regression: the device splice must clip at the TRUE frame count
    (frame_expand.m edge replication), not at the pad-bucket boundary."""
    import jax.numpy as jnp

    from tpu_se.data.splice import splice_replicated
    from tpu_se.infer import Enhancer
    from tpu_se.models import forward

    wts, norm = small_model
    enh = Enhancer(wts, norm)
    rng = np.random.default_rng(1)
    t = 197  # deliberately not a multiple of DECODE_PAD_BUCKET
    lps = rng.normal(size=(t, 257)).astype(np.float32)

    got = enh.enhance_lps(lps)

    mean = np.asarray(enh.mean)
    inv_std = np.asarray(enh.inv_std)
    normed = (lps - mean) * inv_std
    x = splice_replicated(normed, context=7)
    out = np.asarray(forward(enh.params, jnp.asarray(x)))
    want = out / inv_std + mean
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_multistream_push_equals_single(reference_dir, small_model):
    """S batched streams produce exactly what S separate streams produce."""
    from tpu_se.infer import StreamingEnhancer

    wts, norm = small_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    shift = 256
    n_hops = 24
    sig = np.stack([noisy[:n_hops * shift],
                    noisy[1000:1000 + n_hops * shift],
                    noisy[::-1][:n_hops * shift]]).astype(np.float32)

    multi = StreamingEnhancer(wts, norm, n_streams=3)
    outs_multi = []
    for h in range(n_hops):
        out = multi.push(sig[:, h * shift:(h + 1) * shift])
        if out is not None:
            outs_multi.append(out)
    outs_multi.extend(multi.flush_hops())
    multi_wave = np.concatenate(outs_multi, axis=1)

    for s_idx in range(3):
        single = StreamingEnhancer(wts, norm)
        outs = []
        for h in range(n_hops):
            out = single.push(sig[s_idx:s_idx + 1,
                                  h * shift:(h + 1) * shift])
            if out is not None:
                outs.append(out[0])
        outs.extend(o[0] for o in single.flush_hops())
        # fp reassociation across GEMM batch shapes: sub-LSB on int16 scale
        np.testing.assert_allclose(np.concatenate(outs),
                                   multi_wave[s_idx], rtol=1e-4, atol=0.5)


def test_warmup_and_latency_accounting(small_model):
    """push() returns None exactly warmup_hops-1 times, then hops forever."""
    from tpu_se.infer import StreamingEnhancer

    wts, norm = small_model
    s = StreamingEnhancer(wts, norm)
    assert s.latency_samples == 3 * 256 + 512
    rng = np.random.default_rng(2)
    outs = [s.push(rng.normal(size=(1, 256)).astype(np.float32) * 100)
            for _ in range(s.warmup_hops + 3)]
    n_none = sum(o is None for o in outs)
    assert n_none == s.warmup_hops - 1
    assert all(o is not None for o in outs[n_none:])
    assert outs[-1].shape == (1, 256)


def test_short_utterance_stream(reference_dir, small_model):
    """An utterance shorter than the context window still matches batch."""
    from tpu_se.infer import Enhancer, StreamingEnhancer

    wts, norm = small_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    short = noisy[: 256 * 5 + 128]  # 4 frames + dropped partial hop
    batch = Enhancer(wts, norm).enhance(short)[0].astype(np.int32)
    s = StreamingEnhancer(wts, norm)
    stream = np.concatenate([s.feed(short), s.flush()]).astype(np.int32)
    assert stream.shape == batch.shape
    assert np.abs(stream - batch).max() <= 1


def test_push_many_int16_wire_matches_float(small_model):
    """int16-wire chunked streaming == trunc(float32-wire output) for
    integer-valued (PCM) input, on identical stream states."""
    from tpu_se.infer import StreamingEnhancer

    wts, norm = small_model
    rng = np.random.default_rng(11)
    hops = (rng.normal(size=(2, 24, 256)) * 2000).astype(np.int16)

    a = StreamingEnhancer(wts, norm, n_streams=2)
    out_f, valid_f = a.push_many(hops.astype(np.float32))
    b = StreamingEnhancer(wts, norm, n_streams=2)
    out_i, valid_i = b.push_many(hops, int16_wire=True)

    assert out_i.dtype == np.int16
    np.testing.assert_array_equal(valid_f, valid_i)
    np.testing.assert_array_equal(np.trunc(out_f).astype(np.int16), out_i)


def test_feed_out_of_range_integers_skip_int16_wire(small_model):
    """Integer-valued floats beyond int16 range (e.g. 24-bit PCM passed as
    float) must NOT ride the int16 wire — the cast would wrap them. feed()
    must process them through the float path, matching a scaled reference."""
    from tpu_se.infer import StreamingEnhancer

    wts, norm = small_model
    rng = np.random.default_rng(7)
    n = 256 * (StreamingEnhancer.SCAN_HOPS + 2)
    loud = np.trunc(rng.normal(size=n) * 70000.0).astype(np.float32)

    a = StreamingEnhancer(wts, norm)
    out_loud = np.concatenate([a.feed(loud), a.flush()])

    # Reference: same signal through the explicit float32 push() path.
    b = StreamingEnhancer(wts, norm)
    pieces = []
    for h in range(n // 256):
        out = b.push(loud[h * 256:(h + 1) * 256][None, :])
        if out is not None:
            pieces.append(np.trunc(out[0]))
    pieces.append(b.flush())
    ref = np.concatenate(pieces)
    k = min(len(ref), len(out_loud))
    diff = np.abs(out_loud[:k].astype(np.int32)
                  - ref[:k].astype(np.int32))
    assert diff.max() <= 1            # float path, not int16-wrapped garbage


@pytest.fixture(scope="module", params=[8000, 11000])
def rate_model(request, tmp_path_factory, reference_dir):
    """A small model + realistic norm at the 8 kHz (256/128, 2-hop OLA) or
    11 kHz (256/110, 3-hop OLA) config: these reach
    _stream_step's ring logic and flush's partial-hop `need` arithmetic
    through paths the 16 kHz tests never exercise."""
    from tpu_se.dsp import wav_to_lps
    from tpu_se.io.norm import compute_norm

    sr = request.param
    d = tmp_path_factory.mktemp(f"stream_model_{sr}")
    bins = 129                       # fft 256 -> 129 bins at both rates
    params = init_params(11, (7 * bins, 32, 32, bins))
    wts = str(d / "m.wts")
    write_wts(wts, params_to_wts(params))
    noisy16, _ = read_wav(reference_dir / NOISY_DEMO)
    wave = noisy16[::2].astype(np.float32)      # content at sr is irrelevant
    lps = np.asarray(wav_to_lps(wave, sample_rate=sr))
    mean, inv_std = compute_norm(lps)
    norm = str(d / "m.norm")
    write_norm(norm, mean, inv_std)
    return sr, wts, norm, wave


def test_stream_matches_batch_8k_11k(rate_model):
    """feed()+flush() == batch Enhancer at 8 and 11 kHz to 1 int16 LSB,
    with a tail that exercises flush's partial-hop `need` branch
    (streaming.py flush: at 11 kHz a >= 36-sample tail forms one more
    frame; at 8 kHz need == shift so the tail is always dropped —
    matching the batch framer's num_frames in both cases)."""
    from tpu_se.dsp.analysis import rate_config
    from tpu_se.infer import Enhancer, StreamingEnhancer

    sr, wts, norm, wave = rate_model
    _, shift, _ = rate_config(sr)
    # Tail of 50 samples: at 11 kHz (need = 256 - 2*110 = 36) this takes
    # the partial-hop push inside flush(); at 8 kHz (need = 128) it drops.
    wave = wave[: (len(wave) // shift - 2) * shift + 50]

    batch = Enhancer(wts, norm, sample_rate=sr).enhance(wave)[0] \
        .astype(np.int32)
    s = StreamingEnhancer(wts, norm, sample_rate=sr)
    rng = np.random.default_rng(sr)
    pieces, i = [], 0
    while i < len(wave):
        n = int(rng.integers(1, 700))
        pieces.append(s.feed(wave[i:i + n]))
        i += n
    pieces.append(s.flush())
    stream = np.concatenate(pieces).astype(np.int32)

    assert stream.shape == batch.shape
    diff = np.abs(stream - batch)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02


def test_stream_tail_below_need_dropped_11k(rate_model):
    """At 11 kHz a tail shorter than `need` (36) must NOT form an extra
    frame — output length equals the batch framer's."""
    from tpu_se.infer import Enhancer, StreamingEnhancer

    sr, wts, norm, wave = rate_model
    if sr != 11000:
        pytest.skip("need-branch below-threshold case is 11 kHz-specific")
    shift = 110
    wave = wave[: (len(wave) // shift - 2) * shift + 20]   # 20 < need=36

    batch = Enhancer(wts, norm, sample_rate=sr).enhance(wave)[0] \
        .astype(np.int32)
    s = StreamingEnhancer(wts, norm, sample_rate=sr)
    stream = np.concatenate([s.feed(wave), s.flush()]).astype(np.int32)
    assert stream.shape == batch.shape
    assert np.abs(stream - batch).max() <= 1


def test_streaming_smooth_causal_analog(reference_dir, small_model):
    """Streaming fractional smoothing (causal analog of the batch
    smoother): fixed strength alters the output; 'auto' ramps strength in
    for quasi-stationary input (dyn EMA falls below SM_AUTO_D0) and keeps
    it OFF for impulsive bursts (EMA stays at/above SM_AUTO_D1); stream
    starts are smoothing-off (conservative)."""
    from tpu_se.infer import StreamingEnhancer
    from tpu_se.infer.decode import SM_AUTO_D0, SM_AUTO_D1

    wts, norm = small_model
    rng = np.random.default_rng(5)
    stationary = (rng.normal(size=48000) * 3000.0).astype(np.float32)
    t = np.arange(48000)
    bursts = np.zeros(48000, dtype=np.float32)
    bursts[(t // 1600) % 4 == 0] = 1.0
    bursts *= rng.normal(size=48000).astype(np.float32) * 15000.0

    def run(wave, **kw):
        s = StreamingEnhancer(wts, norm, **kw)
        out = np.concatenate([s.feed(wave), s.flush()])
        return out, s

    plain, _ = run(stationary)
    smoothed, _ = run(stationary, smooth_strength=0.5)
    assert smoothed.shape == plain.shape
    assert np.abs(smoothed.astype(np.int32)
                  - plain.astype(np.int32)).max() > 1

    # init state: smoothing OFF at stream start
    s0 = StreamingEnhancer(wts, norm, smooth_strength="auto")
    assert float(np.asarray(s0.state.dyn_ema)[0]) >= SM_AUTO_D1

    _, s_st = run(stationary, smooth_strength="auto")
    _, s_im = run(bursts, smooth_strength="auto")
    dyn_st = float(np.asarray(s_st.state.dyn_ema)[0])
    dyn_im = float(np.asarray(s_im.state.dyn_ema)[0])
    assert dyn_st < SM_AUTO_D0, dyn_st          # full strength reached
    assert dyn_im >= SM_AUTO_D1, dyn_im         # gate stayed closed

    # auto != plain on stationary input (smoothing engaged)...
    auto_st, _ = run(stationary, smooth_strength="auto")
    assert np.abs(auto_st.astype(np.int32)
                  - plain.astype(np.int32)).max() > 1
    # ...and invalid strengths are rejected
    for bad in (-0.1, 1.5, "Auto"):
        with pytest.raises(ValueError):
            StreamingEnhancer(wts, norm, smooth_strength=bad)


def test_streaming_smooth_short_utterance(reference_dir, small_model):
    """Streaming smoothing on an utterance SHORTER than the noise-floor
    window (NOISE_FRAME_NUM=10 frames): output stays finite, the length
    contract matches the un-smoothed stream, and the gate state is sane."""
    from tpu_se.infer import StreamingEnhancer

    wts, norm = small_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    short = noisy[: 256 * 7]                      # 6 frames

    a = StreamingEnhancer(wts, norm, smooth_strength=0.5)
    out_s = np.concatenate([a.feed(short), a.flush()])
    b = StreamingEnhancer(wts, norm)
    out_p = np.concatenate([b.feed(short), b.flush()])
    assert out_s.shape == out_p.shape
    assert np.isfinite(out_s.astype(np.float64)).all()

    c = StreamingEnhancer(wts, norm, smooth_strength="auto")
    out_a = np.concatenate([c.feed(short), c.flush()])
    assert out_a.shape == out_p.shape
    assert np.isfinite(np.asarray(c.state.dyn_ema)).all()

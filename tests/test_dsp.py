"""DSP parity tests against the reference's golden .lps files and vocoder."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_se.dsp import (
    frame_signal, hamming_window, lps_from_frames, num_frames, wav_to_lps,
    reconstruct, segsnr, lsd, power_spectra,
)
from tpu_se.dsp.metrics import segsnr_lsd_pair
from tpu_se.io import read_htk, read_wav

GOLDENS = [
    ("Feature_prepare/data/TEST_DR8_MPAM0_SX289.wav",
     "Feature_prepare/data/TEST_DR8_MPAM0_SX289.lps"),
    ("Feature_prepare/data/TEST_DR8_MPAM0_SX379.wav",
     "Feature_prepare/data/TEST_DR8_MPAM0_SX379.lps"),
]


def test_hamming_window_matches_reference_form():
    win = hamming_window()
    assert win.shape == (512,)
    assert win.dtype == np.float32
    # Symmetric mirror of the float32 half-table (FEfunc.c:109-118).
    np.testing.assert_array_equal(win[:256], win[256:][::-1])
    assert abs(win[0] - 0.08) < 1e-6
    assert win.max() <= 1.0


def test_frame_count_formula():
    assert num_frames(43264) == 168
    assert num_frames(512) == 1
    assert num_frames(511) == 0
    assert num_frames(768) == 2
    assert num_frames(767) == 1


def test_frame_signal_layout():
    wave = np.arange(1024, dtype=np.int16)
    frames = frame_signal(wave)
    assert frames.shape == (3, 512)
    np.testing.assert_array_equal(frames[0], np.arange(512))
    np.testing.assert_array_equal(frames[1], np.arange(256, 768))
    np.testing.assert_array_equal(frames[2], np.arange(512, 1024))


@pytest.mark.parametrize("wav_rel,lps_rel", GOLDENS)
def test_lps_matches_golden(reference_dir, wav_rel, lps_rel):
    wave, sr = read_wav(reference_dir / wav_rel)
    assert sr == 16000
    golden, hdr = read_htk(reference_dir / lps_rel)
    ours = wav_to_lps(wave)
    assert ours.shape == golden.shape
    # The golden was produced by a float32 split-radix FFT; ours by a
    # float64-basis GEMM.  Bins where the true power is far above the floor
    # agree tightly; near-null bins are dominated by fp32 FFT roundoff in the
    # *reference* and can differ more.
    diff = np.abs(ours - golden)
    assert np.median(diff) < 1e-4
    assert np.quantile(diff, 0.999) < 0.05
    assert diff.max() < 5.0  # worst case: log of roundoff-dominated null bins
    loud = golden > 0.0
    assert diff[loud].max() < 0.01


@pytest.mark.parametrize("sample_rate", [8000, 11000, 16000])
def test_lps_matches_float64_fft(sample_rate):
    """The windowed-DFT GEMM against a float64 np.fft.rfft reference, per
    rate config.  Bins far below their frame's peak carry only the GEMM's
    absolute rounding error, which the log amplifies; they are compared
    after the e^-50 floor only."""
    from tpu_se.dsp.analysis import rate_config
    from tpu_se.reference import np_lps

    frame_length, frame_shift, _ = rate_config(sample_rate)
    rng = np.random.default_rng(sample_rate)
    t = np.arange(200 * frame_shift + frame_length) / sample_rate
    wave = (3000 * np.sin(2 * np.pi * 440 * t * (1 + 0.3 * t))
            + rng.normal(0, 300, t.size)).astype(np.int16)
    frames = frame_signal(wave, frame_length, frame_shift)
    got = np.asarray(lps_from_frames(jnp.asarray(frames)), np.float64)
    want = np_lps(frames)
    assert got.shape == (frames.shape[0], frame_length // 2 + 1)
    near = want > want.max(axis=1, keepdims=True) - 40 / (10 / np.log(10))
    assert np.abs(got - want)[near].max() < 1e-3
    assert np.array_equal(got == -50.0, want == -50.0)


def test_lps_methods_agree(reference_dir):
    wave, _ = read_wav(reference_dir / GOLDENS[0][0])
    frames = jnp.asarray(frame_signal(wave))
    a = np.asarray(lps_from_frames(frames, method="matmul"))
    b = np.asarray(lps_from_frames(frames, method="fft"))
    assert np.abs(a - b).max() < 0.02
    assert np.median(np.abs(a - b)) < 1e-4


def test_reconstruct_roundtrip(reference_dir):
    """Feeding a wav's own LPS back with its own phase must reproduce it.

    This closes the analysis->synthesis loop: magnitude from the LPS,
    phase from the same signal, OLA with the squared-window envelope.
    """
    wave, _ = read_wav(reference_dir / GOLDENS[0][0])
    lps = wav_to_lps(wave)
    out, recon_frames = reconstruct(lps, wave)
    t = lps.shape[0]
    assert out.shape == (t * 256 + 256,)
    # Interior samples (skip first/last hop, which lack full overlap in the
    # source framing) should match the original closely.
    orig = wave[: len(out)].astype(np.float32)
    err = out[256:-256].astype(np.float32) - orig[256:-256]
    rel = np.sqrt(np.mean(err ** 2)) / np.sqrt(np.mean(orig ** 2))
    assert rel < 0.01
    # Per-frame de-windowed reconstruction matches the raw frames.
    frames = frame_signal(wave)
    frame_err = np.abs(recon_frames - frames)
    # De-windowed edges are divided by tiny window values -> looser there.
    assert np.median(frame_err) < 0.5


def test_segsnr_perfect_and_noisy():
    rng = np.random.default_rng(0)
    clean = rng.normal(scale=1000, size=(20, 512)).astype(np.float32)
    # identical -> clamped at +30, mismatched -> clamped at -20
    assert segsnr(clean, clean + 1e-3) == pytest.approx(30.0)
    assert segsnr(clean, -clean * 100) == pytest.approx(-20.0)
    noisy = clean + rng.normal(scale=100, size=clean.shape).astype(np.float32)
    val = segsnr(clean, noisy)
    assert 15 < val < 25  # ~20 dB SNR by construction


def test_lsd_zero_for_identical():
    rng = np.random.default_rng(1)
    p = np.exp(rng.normal(size=(30, 257))).astype(np.float32)
    assert lsd(p, p) == pytest.approx(0.0, abs=1e-4)
    assert lsd(p, p * 10.0) == pytest.approx(10.0, abs=1e-3)


def test_decode_metrics_self_consistent(reference_dir):
    """Enhanced == noisy LPS must give segsnr == segsnr_noisy-ish metrics."""
    wave, _ = read_wav(reference_dir / GOLDENS[0][0])
    lps = wav_to_lps(wave)
    out, recon = reconstruct(lps, wave)
    power = np.where(lps < -50.0, np.exp(-50.0), np.exp(lps))
    m = segsnr_lsd_pair(wave, wave, recon, power)
    # clean == noisy: both SNRs pinned at the +30 clamp
    assert m["segsnr_noisy"] == pytest.approx(30.0)
    assert m["segsnr"] > 29.0
    assert m["lsd"] < 0.2
    assert m["lsd_noisy"] == pytest.approx(0.0, abs=1e-4)


def test_wav_to_lps_win_stacking(reference_dir):
    wave, _ = read_wav(reference_dir / GOLDENS[0][0])
    base = wav_to_lps(wave)
    stacked = wav_to_lps(wave, win_size=1)
    t = base.shape[0]
    assert stacked.shape == (t - 2, 3 * 257)
    # Row r stacks frames r, r+1, r+2 (Wav2LogSpec_be.c:513-542).
    np.testing.assert_array_equal(stacked[0, :257], base[0])
    np.testing.assert_array_equal(stacked[0, 257:514], base[1])
    np.testing.assert_array_equal(stacked[5, 514:], base[7])


def test_mel_filterbank_matches_etsi_construction():
    """The dormant mel path (FEfunc.c:472-604): triangles snapped to bins."""
    from tpu_se.dsp import mel_filterbank

    fb = mel_filterbank()
    assert fb.shape == (257, 23)
    # band edges: channel i spans mel fractions i/(C+1)..(i+2)/(C+1) of
    # [mel(64 Hz), mel(8 kHz)]; recompute them independently
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    lo_mel, hi_mel = mel(64.0), mel(8000.0)
    for i in range(23):
        lo = int(512 * hz(lo_mel + i / 24 * (hi_mel - lo_mel)) / 16000 + 0.5)
        up = int(512 * hz(lo_mel + (i + 2) / 24 * (hi_mel - lo_mel)) / 16000
                 + 0.5)
        col = fb[:, i]
        nz = np.nonzero(col)[0]
        assert nz[0] == lo and nz[-1] == up
        # unimodal triangle peaking at 1.0
        peak = int(np.argmax(col))
        assert col[peak] == pytest.approx(1.0)
        assert np.all(np.diff(col[nz[0]:peak + 1]) > 0)
        assert np.all(np.diff(col[peak:nz[-1] + 1]) < 0) or peak == nz[-1]


def test_mfcc_shape_and_c0_order():
    """DCT output order is c1..c12 then c0 (FEfunc.c:722-739)."""
    from tpu_se.dsp import dct_matrix, wav_to_mfcc

    mx = dct_matrix()
    assert mx.shape == (23, 13)
    np.testing.assert_array_equal(mx[:, 12], np.ones(23, dtype=np.float32))
    j = np.arange(23)
    np.testing.assert_allclose(
        mx[:, 0], np.cos(np.pi * 1 / 23 * (j + 0.5)), rtol=1e-6)

    rng = np.random.default_rng(3)
    wave = (rng.normal(size=16000) * 3000).astype(np.int16)
    cep = wav_to_mfcc(wave)
    assert cep.shape == (wave.size // 256 - 1, 13)
    assert np.isfinite(cep).all()
    # c0 (last column) is the sum of log-mel energies: large and positive
    # for a loud signal
    assert cep[:, 12].mean() > 0


def test_reconstruct_roundtrip_ola_kind0(reference_dir):
    """The dormant OLA_KIND=0 build (de-window + overlap-count divide,
    LogSpec2Wav.c:712-715,810-819) also round-trips identity LPS."""
    from tpu_se.io import read_wav

    wave, _ = read_wav(
        reference_dir / "Feature_prepare/data/TEST_DR8_MPAM0_SX289.wav")
    lps = np.asarray(wav_to_lps(wave))
    out0, _ = reconstruct(lps, wave, ola_kind=0)
    out1, _ = reconstruct(lps, wave, ola_kind=1)
    n = min(len(out0), len(wave))
    # Identity LPS + noisy phase reconstructs the waveform (small numeric
    # error from the log/exp round trip); interior samples near-exact.
    err0 = np.abs(out0[256:n - 256].astype(np.int32)
                  - wave[256:n - 256].astype(np.int32))
    assert err0.max() <= 2
    # Both kinds agree in the fully-overlapped interior.
    err01 = np.abs(out0[256:n - 256].astype(np.int32)
                   - out1[256:n - 256].astype(np.int32))
    assert err01.max() <= 2


def test_to_pcm16_truncates_and_saturates_alike_on_host_and_device():
    """The device-side int16 conversion of the serving paths must give what
    the host cast gives, out-of-range samples included (a bare numpy cast
    wraps them, XLA's convert saturates)."""
    import jax

    from tpu_se.dsp.synthesis import to_pcm16

    x = np.array([-1e9, -40000.7, -32769.0, -32768.9, -32767.2, -0.7, 0.7,
                  32766.9, 32767.9, 32768.0, 40000.2, 1e9], np.float32)
    want = np.array([-32768, -32768, -32768, -32768, -32767, 0, 0, 32766,
                     32767, 32767, 32767, 32767], np.int16)
    host = to_pcm16(x)
    dev = np.asarray(jax.jit(to_pcm16)(jnp.asarray(x)))
    assert host.dtype == dev.dtype == np.int16
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev, want)


@pytest.mark.parametrize("sample_rate", [8000, 11000, 16000])
def test_reference_front_end_agrees_with_the_program(sample_rate):
    """The numpy reference frames, windows and converts to int16 on its own;
    it must agree with the program's front end, or a check against it
    measures the disagreement instead of the device error."""
    from tpu_se.dsp.analysis import hamming_window, rate_config
    from tpu_se.dsp.synthesis import to_pcm16
    from tpu_se.reference import np_frames, np_pcm16

    frame_length, frame_shift, _ = rate_config(sample_rate)
    rng = np.random.default_rng(sample_rate)
    for n in (frame_length - 1, frame_length - frame_shift + frame_shift,
              7 * frame_shift + 3, 5000):
        wave = rng.integers(-32768, 32767, n).astype(np.int16)
        np.testing.assert_array_equal(
            np_frames(wave, frame_length, frame_shift),
            frame_signal(wave, frame_length, frame_shift))
    np.testing.assert_allclose(np.hamming(frame_length),
                               hamming_window(frame_length), atol=1e-7)
    x = rng.normal(0, 20000, 4096).astype(np.float32)
    np.testing.assert_array_equal(np_pcm16(x.astype(np.float64)),
                                  to_pcm16(x))

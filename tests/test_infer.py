"""Decode-path tests: end-to-end enhancement and CLI plumbing."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_se.io import read_htk, read_norm, read_wav, write_wts
from tpu_se.io.norm import write_norm
from tpu_se.models import init_params, params_to_wts

NOISY_DEMO = "Enh_demos/F-16Cockpit_SNR10_NOISY_TEST_DR1_MWBT0_SX23.wav"
CLEAN_DEMO = "Enh_demos/F-16Cockpit_SNR10_CLEAN_TEST_DR1_MWBT0_SX23.WAV"


@pytest.fixture(scope="module")
def identity_model(tmp_path_factory, reference_dir):
    """A model + norm whose decode output approximates the input LPS.

    Built by zeroing hidden weights: each sigmoid layer outputs 0.5, so with
    a zero output layer the prediction is the bias.  Instead we use the real
    random model — the decode path tests below only need plumbing, and the
    self-consistency test uses the noisy LPS directly.
    """
    d = tmp_path_factory.mktemp("model")
    params = init_params(7, (1799, 64, 64, 257))
    wts = str(d / "m.wts")
    write_wts(wts, params_to_wts(params))
    mean, inv_std = read_norm(reference_dir / "tools_pfile/train_noisy.norm",
                              257)
    norm = str(d / "m.norm")
    write_norm(norm, mean, inv_std)
    return wts, norm


def test_enhancer_shapes_and_output(reference_dir, identity_model):
    from tpu_se.infer import Enhancer

    wts, norm = identity_model
    noisy, sr = read_wav(reference_dir / NOISY_DEMO)
    enh = Enhancer(wts, norm)
    wave, recon, enh_lps = enh.enhance(noisy)
    t = len(noisy) // 256 - 1
    assert enh_lps.shape == (t, 257)
    assert recon.shape == (t, 512)
    assert wave.shape == (t * 256 + 256,)
    assert wave.dtype == np.int16
    assert np.isfinite(enh_lps).all()


def test_decode_files_with_metrics(reference_dir, identity_model, tmp_path):
    from tpu_se.infer import decode_files

    wts, norm = identity_model
    results = decode_files(
        wts, norm,
        [reference_dir / NOISY_DEMO], str(tmp_path / "out"),
        clean_paths=[reference_dir / CLEAN_DEMO], log=lambda s: None,
        noisy_info=True)
    r = results[0]
    assert os.path.exists(r["out"])
    # The random model can't beat the noisy baseline, but all four metrics
    # must be finite and within the metric clamps.
    for key in ("segsnr", "segsnr_noisy", "lsd", "lsd_noisy"):
        assert np.isfinite(r[key])
    assert -20.0 <= r["segsnr"] <= 30.0
    stem = os.path.basename(str(reference_dir / NOISY_DEMO)).replace(
        ".wav", "")
    info = open(os.path.join(tmp_path / "out", stem + ".info.txt")).read()
    assert "Segmental SNR" in info
    # -ni flag: noisy baseline in its own <input-name>.info file, named as
    # LogSpec2Wav.c:846-847 does but placed in out_dir (see decode_files)
    ni_name = os.path.basename(str(reference_dir / NOISY_DEMO)) + ".info"
    ninfo = open(os.path.join(tmp_path / "out", ni_name)).read()
    assert f"{r['segsnr_noisy']:f}" in ninfo


def test_demo_pairs_have_consistent_framing(reference_dir):
    """All 4 variants of a demo condition decode to the same frame count."""
    base = "F-16Cockpit_SNR10_%s_TEST_DR1_MWBT0_SX23"
    lens = {}
    for kind, ext in [("CLEAN", ".WAV"), ("NOISY", ".wav"),
                      ("MMSE", ".wav"), ("ML", ".wav")]:
        wave, _ = read_wav(reference_dir / "Enh_demos" / ((base % kind) + ext))
        lens[kind] = len(wave)
    # Enhanced demos were produced by the reference OLA: T*256 + 256 samples.
    t = lens["NOISY"] // 256 - 1
    assert lens["MMSE"] == t * 256 + 256
    assert lens["ML"] == t * 256 + 256


CLI_ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _cli(*args, cwd=None):
    return subprocess.run([sys.executable, "-m", "tpu_se", *args],
                          capture_output=True, text=True, env=CLI_ENV,
                          cwd=cwd or os.path.dirname(os.path.dirname(__file__)),
                          timeout=300)


def test_cli_feature_pipeline(reference_dir, tmp_path):
    """lps-extract -> make-pfile -> get-norm reproduces the reference stats."""
    wav = str(reference_dir / "Feature_prepare/data/TEST_DR8_MPAM0_SX289.wav")
    lps_out = str(tmp_path / "a.lps")
    r = _cli("lps-extract", wav, "-o", lps_out)
    assert r.returncode == 0, r.stderr
    ours, hdr = read_htk(lps_out)
    golden, _ = read_htk(
        reference_dir / "Feature_prepare/data/TEST_DR8_MPAM0_SX289.lps")
    assert ours.shape == golden.shape
    assert np.median(np.abs(ours - golden)) < 1e-4

    scp = tmp_path / "lps.scp"
    scp.write_text(lps_out + "\n")
    pfile_out = str(tmp_path / "a.pfile")
    r = _cli("make-pfile", str(scp), "-o", pfile_out,
             "--lenfile", str(tmp_path / "lens.len"))
    assert r.returncode == 0, r.stderr
    assert open(tmp_path / "lens.len").read().strip() == str(ours.shape[0])

    norm_out = str(tmp_path / "a.norm")
    r = _cli("get-norm", pfile_out, "-o", norm_out)
    assert r.returncode == 0, r.stderr
    mean, inv = read_norm(norm_out, 257)
    np.testing.assert_allclose(mean, ours.mean(axis=0), atol=1e-3)


def test_cli_gen_rand_net(tmp_path):
    out = str(tmp_path / "r.wts")
    r = _cli("gen-rand-net", "--layersizes", "21,16,9", "-o", out)
    assert r.returncode == 0, r.stderr
    from tpu_se.io import read_wts
    layers = read_wts(out)
    assert layers[0]["w"].shape == (21, 16)


def test_batch_decode_matches_single(identity_model):
    """enhance_batch over mixed-length utterances == per-utterance enhance
    (incl. a zero-length one and batch padding)."""
    from tpu_se.infer import Enhancer

    wts, norm = identity_model
    rng = np.random.default_rng(3)
    waves = [(rng.normal(size=n) * 2000).astype(np.int16)
             for n in (9000, 16000, 0, 4000, 12345)]
    enh = Enhancer(wts, norm)
    batched = enh.enhance_batch(waves)
    for wave, got in zip(waves, batched):
        want = enh.enhance(wave)
        assert got[0].shape == want[0].shape
        if len(wave) == 0:
            continue
        assert np.abs(got[0].astype(np.int32)
                      - want[0].astype(np.int32)).max() <= 1
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


def test_cli_pfile_info(reference_dir):
    pf = str(reference_dir / "tools_pfile/train_noisy.pfile")
    r = _cli("pfile-info", pf, "--sents")
    assert r.returncode == 0, r.stderr
    assert "10 sentences, 1885 frames, 257 features" in r.stdout
    # per-sentence lengths must match the bundled frame_numbers.len
    lens = [int(x) for x in
            (reference_dir / "tools_pfile/frame_numbers.len")
            .read_text().split()]
    for i, t in enumerate(lens):
        assert f"sentence {i}: {t} frames" in r.stdout


def test_cli_wts_info(tmp_path):
    out = str(tmp_path / "r.wts")
    assert _cli("gen-rand-net", "--layersizes", "21,16,9",
                "-o", out).returncode == 0
    r = _cli("wts-info", out)
    assert r.returncode == 0, r.stderr
    assert "weights12" in r.stdout and "bias3" in r.stdout
    # 21*16 + 16 + 16*9 + 9 parameters
    assert "total: 505 parameters" in r.stdout


def test_cli_eval(reference_dir):
    demos = reference_dir / "Enh_demos"
    clean = str(demos / "DestroyerEngine_SNR0_CLEAN_TEST_DR3_FPKT0_SI1538.WAV")
    noisy = str(demos / "DestroyerEngine_SNR0_NOISY_TEST_DR3_FPKT0_SI1538.wav")
    ml = str(demos / "DestroyerEngine_SNR0_ML_TEST_DR3_FPKT0_SI1538.wav")
    r = _cli("eval", "--clean", clean, clean, "--test", noisy, ml, "--json")
    assert r.returncode == 0, r.stderr
    import json

    rows = [json.loads(line) for line in r.stdout.splitlines()]
    by_name = {row["name"]: row for row in rows if row["name"] != "mean"}
    # the enhanced demo must beat the noisy input on every metric
    assert by_name[ml]["segsnr"] > by_name[noisy]["segsnr"]
    assert by_name[ml]["lsd"] < by_name[noisy]["lsd"]
    assert by_name[ml]["stoi"] > by_name[noisy]["stoi"]
    assert rows[-1]["name"] == "mean"


def test_fused_decode_matches_staged(reference_dir, identity_model):
    """The one-dispatch fused decode == the staged lps->forward->synth
    path (which postprocess/smooth still use)."""
    import numpy as np

    from tpu_se.dsp import frame_signal, lps_from_frames, reconstruct
    from tpu_se.infer import Enhancer

    import jax.numpy as jnp

    wts, norm = identity_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    enh = Enhancer(wts, norm)
    wave_f, recon_f, lps_f = enh.enhance(noisy)

    frames = frame_signal(noisy)
    lps = np.asarray(lps_from_frames(jnp.asarray(frames)))
    enh_lps = enh.enhance_lps(lps)
    wave_s, recon_s = reconstruct(enh_lps, noisy)

    np.testing.assert_allclose(lps_f, enh_lps, rtol=1e-5, atol=1e-5)
    assert np.abs(wave_f.astype(np.int32)
                  - wave_s.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(recon_f, recon_s, rtol=1e-4, atol=1e-3)


def test_batch_waves_fast_path_bitwise_matches_batch(identity_model):
    """enhance_batch_waves (int16-only traffic, on-device framing) must be
    bitwise-identical to enhance_batch's waveforms."""
    from tpu_se.infer import Enhancer

    wts, norm = identity_model
    rng = np.random.default_rng(4)
    waves = [(rng.normal(size=n) * 2000).astype(np.int16)
             for n in (9000, 16000, 0, 4000, 12345)]
    enh = Enhancer(wts, norm)
    fast = enh.enhance_batch_waves(waves)
    full = enh.enhance_batch(waves)
    for got, want in zip(fast, full):
        np.testing.assert_array_equal(got, want[0])


def test_cli_decode_postprocess_smooth(identity_model, tmp_path, reference_dir):
    """--postprocess/--smooth reach the Enhancer through the CLI and bound
    suppression vs the noisy LPS (postprocess floor semantics)."""
    wts, norm = identity_model
    wav = str(reference_dir
              / "Enh_demos/White_SNR5_NOISY_TEST_DR2_MWEW0_SX11.wav")
    r = _cli("decode", wav, "--wts", wts, "--norm", norm,
             "--out-dir", str(tmp_path / "pp"), "--postprocess", "--smooth")
    assert r.returncode == 0, r.stderr
    import os
    assert os.path.exists(
        tmp_path / "pp" /
        "White_SNR5_NOISY_TEST_DR2_MWEW0_SX11_enhanced.wav")


def test_blend_interpolates_toward_noisy_lps(identity_model, reference_dir):
    """--blend b: enhanced LPS == (1-b)*plain + b*noisy (log domain), in
    both the staged path and the fused device path; blend=1 -> identity
    would return the noisy LPS, blend=0 is the reference decode.m path."""
    import jax.numpy as jnp

    from tpu_se.dsp import frame_signal, lps_from_frames
    from tpu_se.infer import Enhancer

    wts, norm = identity_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    frames = frame_signal(noisy)
    lps = np.asarray(lps_from_frames(jnp.asarray(frames)))

    plain = Enhancer(wts, norm)
    blended = Enhancer(wts, norm, blend=0.4)
    e0 = plain.enhance_lps(lps)
    eb = blended.enhance_lps(lps)
    np.testing.assert_allclose(eb, 0.6 * e0 + 0.4 * lps,
                               rtol=1e-5, atol=1e-5)
    # fused path agrees with the staged path under blend
    _, _, lps_fused = blended.enhance(noisy)
    np.testing.assert_allclose(lps_fused, eb, rtol=1e-5, atol=1e-5)
    # bad values rejected
    with pytest.raises(ValueError):
        Enhancer(wts, norm, blend=1.0)


def test_blend_auto_matches_manual_map(identity_model, reference_dir):
    """blend='auto' applies lam = LMAX*exp(-mean_suppression_dB/TAU) with
    the suppression computed from the PLAIN enhanced LPS — verified
    against a hand-computed blend of the plain output."""
    import jax.numpy as jnp

    from tpu_se.dsp import frame_signal, lps_from_frames
    from tpu_se.infer import Enhancer
    from tpu_se.infer.decode import (
        BLEND_AUTO_LMAX, BLEND_AUTO_MAX, BLEND_AUTO_TAU_DB,
    )

    wts, norm = identity_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    frames = frame_signal(noisy)
    lps = np.asarray(lps_from_frames(jnp.asarray(frames)))

    plain = Enhancer(wts, norm).enhance_lps(lps)
    supp_db = float(np.mean(lps - plain)) * 10.0 / np.log(10.0)
    lam = float(np.clip(
        BLEND_AUTO_LMAX * np.exp(-max(supp_db, 0.0) / BLEND_AUTO_TAU_DB),
        0.0, BLEND_AUTO_MAX))
    want = (1.0 - lam) * plain + lam * lps

    got = Enhancer(wts, norm, blend="auto").enhance_lps(lps)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the fused path agrees too
    _, _, fused = Enhancer(wts, norm, blend="auto").enhance(noisy)
    np.testing.assert_allclose(fused, got, rtol=1e-4, atol=1e-4)


def test_blend_auto_batch_matches_per_utterance(identity_model):
    """enhance_batch with blend='auto': each vmapped utterance computes
    its OWN adaptive lambda (valid-masked suppression mean over its true
    frames, not the shared pad length) == per-utterance enhance."""
    from tpu_se.infer import Enhancer

    wts, norm = identity_model
    rng = np.random.default_rng(8)
    waves = [(rng.normal(size=n) * 2000).astype(np.int16)
             for n in (9000, 16000, 5000)]
    enh = Enhancer(wts, norm, blend="auto")
    batch = enh.enhance_batch(waves)
    for wave, got in zip(waves, batch):
        want = enh.enhance(wave)
        assert np.abs(got[0].astype(np.int32)
                      - want[0].astype(np.int32)).max() <= 1
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


def test_streaming_blend_auto_runs_and_converges(reference_dir,
                                                 identity_model):
    """Streaming blend='auto' (causal EMA of the suppression) produces
    finite output that differs from both plain and the max fixed blend,
    and the EMA state moves from its 0 dB start."""
    from tpu_se.infer import StreamingEnhancer

    wts, norm = identity_model
    noisy, _ = read_wav(reference_dir / NOISY_DEMO)
    s = StreamingEnhancer(wts, norm, blend="auto")
    out = np.concatenate([s.feed(noisy), s.flush()])
    assert np.isfinite(out.astype(np.float64)).all()
    assert float(np.asarray(s.state.supp_ema)[0]) != 0.0
    s0 = StreamingEnhancer(wts, norm)
    plain = np.concatenate([s0.feed(noisy), s0.flush()])
    assert np.abs(out.astype(np.int32) - plain.astype(np.int32)).max() > 1


def test_cli_decode_blend(identity_model, tmp_path, reference_dir):
    """--blend reaches the Enhancer through the CLI decode surface."""
    wts, norm = identity_model
    wav = str(reference_dir
              / "Enh_demos/White_SNR5_NOISY_TEST_DR2_MWEW0_SX11.wav")
    r = _cli("decode", wav, "--wts", wts, "--norm", norm,
             "--out-dir", str(tmp_path / "bl"), "--blend", "0.5")
    assert r.returncode == 0, r.stderr
    import os
    assert os.path.exists(
        tmp_path / "bl" /
        "White_SNR5_NOISY_TEST_DR2_MWEW0_SX11_enhanced.wav")


def test_enhancer_8khz_end_to_end(tmp_path):
    """Batch decode at 8 kHz (256/128 framing, 129 bins): identity model
    round-trips, fast path bitwise-matches, wrong-rate model rejected."""
    from tpu_se.infer import Enhancer
    from tpu_se.io import write_wts
    from tpu_se.io.norm import write_norm
    from tpu_se.models import init_params, params_to_wts

    dim, ctx = 129, 7
    wts = str(tmp_path / "m8.wts")
    write_wts(wts, params_to_wts(init_params(5, (dim * ctx, 24, dim))))
    norm = str(tmp_path / "m8.norm")
    rng = np.random.default_rng(6)
    write_norm(norm, rng.normal(size=dim).astype(np.float32),
               (1.0 / (1.0 + rng.random(dim))).astype(np.float32))

    enh = Enhancer(wts, norm, sample_rate=8000)
    waves = [(rng.normal(size=n) * 2000).astype(np.int16)
             for n in (4000, 9000)]
    singles = [enh.enhance(w) for w in waves]
    t0 = (len(waves[0]) - 128) // 128
    assert singles[0][0].shape == (t0 * 128 + 128,)
    assert singles[0][2].shape == (t0, dim)
    fast = enh.enhance_batch_waves(waves)
    full = enh.enhance_batch(waves)
    for got, want in zip(fast, full):
        np.testing.assert_array_equal(got, want[0])

    with pytest.raises(ValueError, match="bins"):
        Enhancer(wts, norm, sample_rate=16000)


def test_decode_files_rejects_rate_mismatch_per_utt(identity_model, tmp_path):
    """Regression: the default per-utterance path (batch_size=1) must raise
    on a wav whose header rate differs from the decoder's, like the batch
    path does — not silently frame it with the wrong config."""
    import pytest as _pytest

    from tpu_se.infer import decode_files
    from tpu_se.io import write_wav

    wts, norm = identity_model
    wav8k = str(tmp_path / "eight_k.wav")
    write_wav(wav8k, np.zeros(4096, dtype=np.int16), 8000)
    with _pytest.raises(ValueError, match="sample rate"):
        decode_files(wts, norm, [wav8k], str(tmp_path / "out"),
                     log=lambda s: None)


def test_smooth_strength_fractional_and_auto(reference_dir, tmp_path):
    """Fractional SMOOTHPROCESS: s=0 == plain, s=1 == binary smooth,
    0<s<1 strictly between; 'auto' gates strength off for impulsive
    input (PARITY.md §4 round 5)."""
    import numpy as np

    from tpu_se.infer import Enhancer
    from tpu_se.infer.decode import _smooth_auto_strength, SM_AUTO_S
    from tpu_se.io import read_norm, read_wav, write_wts
    from tpu_se.io.norm import write_norm
    from tpu_se.models import init_params, params_to_wts

    params = init_params(7, (1799, 32, 32, 257))
    wts = str(tmp_path / "m.wts")
    write_wts(wts, params_to_wts(params))
    mean, inv_std = read_norm(
        reference_dir / "tools_pfile/train_noisy.norm", 257)
    norm = str(tmp_path / "m.norm")
    write_norm(norm, mean, inv_std)
    noisy, _ = read_wav(
        reference_dir /
        "Enh_demos/F-16Cockpit_SNR10_NOISY_TEST_DR1_MWBT0_SX23.wav")
    noisy = noisy[:32000]

    def lps_of(**kw):
        return Enhancer(wts, norm, **kw).enhance(noisy)[2]

    plain = lps_of()
    s0 = lps_of(smooth=True, smooth_strength=0.0)
    s1 = lps_of(smooth=True, smooth_strength=1.0)
    shalf = lps_of(smooth=True, smooth_strength=0.5)
    np.testing.assert_allclose(s0, plain, atol=1e-5)
    assert np.abs(s1 - plain).max() > 0.01          # smoothing does act
    d_half = np.abs(shalf - plain).max()
    assert 0 < d_half < np.abs(s1 - plain).max()

    # invalid strengths rejected; None defers to the smooth flag
    for bad in (-0.1, 1.5, "Auto"):
        with pytest.raises(ValueError):
            Enhancer(wts, norm, smooth=True, smooth_strength=bad)
    np.testing.assert_allclose(
        lps_of(smooth=True, smooth_strength=None), s1, atol=1e-6)
    # a non-zero strength implies smoothing without the flag
    np.testing.assert_allclose(
        lps_of(smooth_strength=0.5), shalf, atol=1e-6)

    # the impulsiveness gate: stationary noise -> full strength,
    # burst train -> zero
    rng = np.random.default_rng(0)
    t = np.arange(64000)
    stationary = (rng.normal(size=64000) * 3000).astype(np.float32)
    bursts = np.zeros(64000, dtype=np.float32)
    bursts[(t // 1600) % 4 == 0] = 20000.0
    bursts *= rng.normal(size=64000).astype(np.float32)
    from tpu_se.dsp import wav_to_lps

    assert _smooth_auto_strength(
        np.asarray(wav_to_lps(stationary))) == pytest.approx(SM_AUTO_S)
    assert _smooth_auto_strength(np.asarray(wav_to_lps(bursts))) == 0.0


def test_cli_decode_11khz(tmp_path):
    """decode -fs 11 end-to-end: the 256/110 3-hop-OLA config through the
    CLI (batch path), with a 129-bin model and the quality flags."""
    import wave as wave_mod

    import numpy as np

    from tpu_se.io import read_wav, write_norm, write_wts
    from tpu_se.models import init_params, params_to_wts

    bins = 129
    wts = str(tmp_path / "m.wts")
    write_wts(wts, params_to_wts(init_params(3, (7 * bins, 16, 16, bins))))
    norm = str(tmp_path / "m.norm")
    rng = np.random.default_rng(0)
    write_norm(norm, rng.normal(size=bins).astype(np.float32),
               (0.5 + rng.random(bins)).astype(np.float32))

    wav = tmp_path / "n.wav"
    with wave_mod.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(11025)
        w.writeframes((rng.normal(size=11025) * 3000)
                      .astype("<i2").tobytes())

    r = _cli("decode", str(wav), "--wts", wts, "--norm", norm,
             "-fs", "11", "--blend", "auto", "--smooth-strength", "auto",
             "--out-dir", str(tmp_path / "out"))
    assert r.returncode == 0, r.stderr
    enh, sr = read_wav(tmp_path / "out" / "n_enhanced.wav")
    assert sr == 11025
    assert len(enh) > 10000 and np.isfinite(enh.astype(np.float64)).all()

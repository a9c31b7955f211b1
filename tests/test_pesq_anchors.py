"""PESQ anchor-matrix and cross-metric calibration tests.

The native P.862 implementation (``tpu_se/infer/pesq.py``) is used to rank
enhancement systems like the paper does (README.md:3, 155-158); these tests
pin its behavior across a degradation matrix — noise types x SNRs x level
offsets, plus reverberation — and check rank agreement with STOI over the
reference's 56 Enh_demos wavs, so a silently wrong constant can't reorder
close systems unnoticed.
"""

import os

import numpy as np
import pytest

from tpu_se.infer.pesq import pesq
from tpu_se.infer.stoi import stoi
from tpu_se.io import read_wav

FS = 16000
N = 32000


def _speechlike(n=N, fs=FS, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28)) * a
            for f, a in ((220, 1.0), (440, 0.7), (880, 0.4),
                         (1760, 0.2), (3000, 0.1)))
    envelope = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
    return (x * envelope * 8000).astype(np.float64)


def _noise_bank(n=N, fs=FS, seed=7):
    """Four qualitatively different degradations (unit-free shapes)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    white = rng.normal(size=n)
    spec = np.fft.rfft(rng.normal(size=n))
    f = np.fft.rfftfreq(n, 1 / fs)
    f[0] = 1.0
    pink = np.fft.irfft(spec / np.sqrt(f), n)
    hum = sum(np.sin(2 * np.pi * 50 * k * t + k) / k for k in range(1, 6))
    babble = rng.normal(size=n) * (
        0.3 + 0.7 * np.clip(np.sin(2 * np.pi * 4 * t + 1), 0, None))
    return {"white": white, "pink": pink, "hum": hum, "babble": babble}


def _add_noise(x, noise, snr_db):
    noise = noise / np.sqrt((noise ** 2).mean() / (x ** 2).mean())
    return x + noise * 10.0 ** (-snr_db / 20.0)


SNRS = (30, 20, 10, 0)


def _anchor_matrix():
    """{(noise, snr): MOS-LQO} over the full degradation grid."""
    x = _speechlike()
    return {(name, snr): pesq(x, _add_noise(x, nz, snr))
            for name, nz in _noise_bank().items() for snr in SNRS}


def test_anchor_matrix_monotone_and_in_range():
    scores = _anchor_matrix()
    for name in ("white", "pink", "hum", "babble"):
        row = [scores[(name, snr)] for snr in SNRS]
        assert all(a > b for a, b in zip(row, row[1:])), (name, row)
        # P.862.2 MOS-LQO range with a margin
        assert all(1.0 <= s <= 4.7 for s in row), (name, row)
        # 30 dB vs 0 dB must be clearly separated
        assert row[0] - row[-1] > 0.9, (name, row)
    # broadband noise hurts more than narrowband hum at equal SNR
    for snr in SNRS:
        assert scores[("hum", snr)] > scores[("white", snr)], snr


def test_level_offsets_do_not_move_scores():
    """P.862 level alignment: a +/-10 dB gain on the degraded signal must
    leave MOS-LQO essentially unchanged (we measure < 0.05 MOS drift)."""
    x = _speechlike()
    deg = _add_noise(x, _noise_bank()["white"], 10)
    base = pesq(x, deg)
    for off_db in (-10.0, -3.0, 3.0, 10.0):
        s = pesq(x, deg * 10.0 ** (off_db / 20.0))
        assert abs(s - base) < 0.05, (off_db, s, base)


def test_reverb_monotone():
    """Longer reverberant tails -> lower MOS-LQO (the paper's test
    conditions include non-additive degradations; PESQ must rank them)."""
    x = _speechlike()
    rng = np.random.default_rng(11)
    scores = []
    for rt in (0.05, 0.15, 0.4):
        m = int(rt * FS)
        ir = rng.normal(size=m) * np.exp(-3.0 * np.arange(m) / m)
        ir[0] = 3.0
        scores.append(pesq(x, np.convolve(x, ir)[: len(x)]))
    assert scores[0] > scores[1] > scores[2], scores
    assert scores[0] > 2.5 and scores[2] < 2.0, scores


def test_rank_correlation_with_stoi_on_demos(reference_dir):
    """Spearman rank agreement with STOI over all 14 demo conditions x
    {NOISY, MMSE, ML} (42 pairs, the full Enh_demos set). Measured 0.76;
    assert a safe floor so regressions that scramble rankings fail."""
    demos = os.path.join(reference_dir, "Enh_demos")
    files = os.listdir(demos)
    conds = sorted({f.split("_CLEAN_")[0] for f in files if "_CLEAN_" in f})
    assert len(conds) == 14
    p_scores, s_scores = [], []
    for cond in conds:
        def pick(kind):
            m = [f for f in files if f.split("_TEST")[0] == f"{cond}_{kind}"]
            return read_wav(os.path.join(demos, m[0]))
        clean, fs = pick("CLEAN")
        for kind in ("NOISY", "MMSE", "ML"):
            deg, _ = pick(kind)
            n = min(len(clean), len(deg))
            p_scores.append(pesq(clean[:n], deg[:n], fs))
            s_scores.append(stoi(clean[:n], deg[:n], fs))

    def rank(a):
        r = np.empty(len(a))
        r[np.argsort(a)] = np.arange(len(a))
        return r

    rho = np.corrcoef(rank(np.array(p_scores)),
                      rank(np.array(s_scores)))[0, 1]
    assert rho > 0.6, rho
    assert 1.0 <= min(p_scores) and max(p_scores) <= 4.7


def test_agreement_with_certified_wheel():
    """When the ITU-certified ``pesq`` wheel is installed, the native
    implementation must agree with it on the anchor matrix: Spearman rank
    correlation > 0.9 and mean |MOS difference| < 0.5 (the native scores
    are P.862-faithful in structure, not certified values)."""
    itu = pytest.importorskip("pesq")
    x = _speechlike()
    ours, theirs = [], []
    for name, nz in _noise_bank().items():
        for snr in SNRS:
            deg = _add_noise(x, nz, snr)
            ours.append(pesq(x, deg))
            theirs.append(itu.pesq(FS, x.astype(np.float32),
                                   deg.astype(np.float32), "wb"))
    ours, theirs = np.array(ours), np.array(theirs)

    def rank(a):
        r = np.empty(len(a))
        r[np.argsort(a)] = np.arange(len(a))
        return r

    rho = np.corrcoef(rank(ours), rank(theirs))[0, 1]
    assert rho > 0.9, rho
    assert np.abs(ours - theirs).mean() < 0.5


def test_published_mos_lqo_mapping_constants():
    """External conformance anchor that needs no ITU data: the raw->MOS-LQO
    maps are the PUBLISHED ITU-T P.862.1 (narrowband) and P.862.2
    (wideband) sigmoids.  Pin the curve at several raw points computed
    directly from the published formulas:

      P.862.1:  y = 0.999 + (4.999-0.999) / (1 + exp(-1.4945*x + 4.6607))
      P.862.2:  y = 0.999 + (4.999-0.999) / (1 + exp(-1.3669*x + 3.8224))

    A wrong constant anywhere in the final map shifts every score and
    fails this test even though it cannot be caught by rank-based checks.
    Probes the MODULE's own map (``mos_lqo_map``, the function ``pesq``
    returns through) — not a local re-derivation of the same literals.
    """
    from tpu_se.infer.pesq import mos_lqo_map

    for raw in (-0.5, 1.0, 2.0, 3.0, 4.0, 4.5):
        wb_published = (0.999 + (4.999 - 0.999)
                        / (1.0 + np.exp(-1.3669 * raw + 3.8224)))
        nb_published = (0.999 + (4.999 - 0.999)
                        / (1.0 + np.exp(-1.4945 * raw + 4.6607)))
        assert abs(mos_lqo_map(raw, 16000) - wb_published) < 1e-12, raw
        assert abs(mos_lqo_map(raw, 8000) - nb_published) < 1e-12, raw
    # The widely-cited maxima of the certified implementation are the maps
    # at raw 4.5: ~4.644 (wideband) and ~4.549 (narrowband).
    assert abs(mos_lqo_map(4.5, 16000) - 4.644) < 1e-3
    assert abs(mos_lqo_map(4.5, 8000) - 4.549) < 1e-3
    # And the scoring path actually routes through this map: identity input
    # gives raw 4.5, so pesq() must equal mos_lqo_map(4.5, fs) exactly.
    x = _speechlike()
    assert pesq(x, x, 16000) == pytest.approx(mos_lqo_map(4.5, 16000),
                                              abs=1e-12)


def test_spec_intermediate_anchors_bark_threshold_loudness():
    """Hand-computed P.862 intermediate-value anchors from the published
    formulas (always-running certified-wheel stand-ins):

    1. Schroeder Bark warp z = 7*asinh(f/650): z(650)=7*asinh(1)
       = 7*ln(1+sqrt(2)) = 6.16977…; z(1000) = 8.58747….
    2. Terhardt absolute threshold (dB SPL):
       T(f) = 3.64 (f/kHz)^-0.8 - 6.5 e^{-0.6 (f/kHz-3.3)^2} + 1e-3 (f/kHz)^4
       T(1 kHz) = 3.36907… dB;  T(3.3 kHz) ≈ -4.86 dB (near the dip).
    3. Zwicker loudness S = Sl (P0/0.5)^0.23 [(0.5+0.5 P/P0)^0.23 - 1]:
       exactly 0 at P = P0 and below, and at P = 3 P0 the bracket is
       2^0.23 - 1 = 0.172835… times the (P0/0.5)^0.23 prefactor.

    All expectations below are written as independent literals/closed
    forms, then compared against the MODULE's functions.
    """
    import importlib
    pesq_mod = importlib.import_module("tpu_se.infer.pesq")

    # 1. Bark warp (Schroeder 1977): closed forms, not the module formula.
    assert pesq_mod._bark(650.0) == pytest.approx(
        7.0 * np.log(1.0 + np.sqrt(2.0)), abs=1e-12)      # 6.169766…
    # z(1000) = 7*ln(20/13 + sqrt((20/13)^2 + 1)) = 8.5113715…
    assert pesq_mod._bark(1000.0) == pytest.approx(8.5113715, abs=1e-6)
    assert pesq_mod._bark(0.0) == 0.0

    # 2. Terhardt 1979 threshold at probe frequencies (hand-evaluated).
    t1k = 3.64 - 6.5 * np.exp(-0.6 * (1.0 - 3.3) ** 2) + 1e-3
    assert t1k == pytest.approx(3.3690665, abs=1e-5)       # sanity on literal
    assert pesq_mod._terhardt_threshold_db(np.array([1000.0]))[0] == \
        pytest.approx(t1k, abs=1e-12)
    t33 = 3.64 * 3.3 ** -0.8 - 6.5 + 1e-3 * 3.3 ** 4
    assert pesq_mod._terhardt_threshold_db(np.array([3300.0]))[0] == \
        pytest.approx(t33, abs=1e-12)

    # 3. Zwicker loudness law: zero at/below threshold; published bracket
    # value at 3x threshold power.
    p0 = np.array([[2.0]])
    assert pesq_mod._loudness(p0 * 1.0, p0[0])[0, 0] == 0.0
    assert pesq_mod._loudness(p0 * 0.5, p0[0])[0, 0] == 0.0
    got = pesq_mod._loudness(p0 * 3.0, p0[0])[0, 0]
    want = pesq_mod._SL * (2.0 / 0.5) ** 0.23 * (2.0 ** 0.23 - 1.0)
    assert got == pytest.approx(want, rel=1e-12)
    assert (2.0 ** 0.23 - 1.0) == pytest.approx(0.1728349, abs=1e-6)


def test_identity_scores_published_maxima():
    """pesq(x, x) must produce zero disturbance -> raw 4.5 -> the published
    map maxima: 4.644 wideband (P.862.2), 4.549 narrowband (P.862.1) —
    the well-known 'perfect score' values of the certified implementation."""
    x = _speechlike()
    assert pesq(x, x, 16000, return_raw=True) == pytest.approx(4.5, abs=1e-9)
    assert pesq(x, x, 16000) == pytest.approx(4.6436, abs=2e-3)
    x8 = _speechlike(fs=8000)
    assert pesq(x8, x8, 8000, return_raw=True) == pytest.approx(4.5,
                                                                abs=1e-9)
    assert pesq(x8, x8, 8000) == pytest.approx(4.5486, abs=2e-3)


def test_fine_alignment_recovers_per_utterance_delay():
    """P.862 stage-2: two utterances where the SECOND is delayed 12 ms in
    the degraded signal (VoIP-style per-utterance jitter the global crude
    lag cannot fix).  Fine alignment must recover (score ~= the undelayed
    pair); without it the misaligned utterance scores far lower."""
    from tpu_se.infer.pesq import _utterance_spans

    fs = FS

    def utt(n, seed):
        # _speechlike with a floor on the envelope so the utterance has no
        # internal 200 ms silences (its 2.5 Hz half-wave envelope would
        # otherwise split at the utterance detector's gap threshold).
        rng = np.random.default_rng(seed)
        t = np.arange(n) / fs
        x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28)) * a
                for f, a in ((220, 1.0), (440, 0.7), (880, 0.4),
                             (1760, 0.2), (3000, 0.1)))
        envelope = 0.25 + 0.75 * np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
        return x * envelope * 8000

    sil = np.zeros(int(0.35 * fs))
    u1 = utt(int(0.9 * fs), 3)
    u2 = utt(int(0.9 * fs), 4)
    ref = np.concatenate([sil, u1, sil, u2, sil])
    spans = _utterance_spans(ref, fs)
    assert len(spans) == 2, spans

    rng = np.random.default_rng(9)
    noise = rng.normal(size=len(ref)) * 300.0
    deg_clean_time = ref + noise
    shift = int(0.012 * fs)
    deg_jitter = deg_clean_time.copy()
    s, e = spans[1]
    # utterance 2 arrives `shift` samples LATE
    deg_jitter[s + shift: e + shift] = deg_clean_time[s:e]
    deg_jitter[s: s + shift] = noise[s: s + shift]

    base = pesq(ref, deg_clean_time, fs)
    fine = pesq(ref, deg_jitter, fs)
    crude_only = pesq(ref, deg_jitter, fs, fine_align=False)
    # Fine alignment recovers the undelayed score almost exactly
    # (measured 1.829 vs 1.833); crude-only loses ~0.13 MOS to the
    # misaligned utterance.
    assert abs(fine - base) < 0.05, (fine, base)
    assert fine > crude_only + 0.08, (fine, crude_only)


def test_fine_alignment_noop_for_delay_free_pairs():
    """On an already-aligned pair (this framework's decode path is
    delay-free) fine alignment must not move the score."""
    ref = _speechlike(seed=11)
    rng = np.random.default_rng(12)
    deg = ref + rng.normal(size=len(ref)) * 500.0
    a = pesq(ref, deg, FS)
    b = pesq(ref, deg, FS, fine_align=False)
    assert abs(a - b) < 0.05, (a, b)


def test_fine_alignment_low_confidence_keeps_crude_delay():
    """An utterance the degraded signal nearly silences (or replaces with
    uncorrelated noise) has a flat alignment correlation — the gate must
    keep the crude delay rather than applying a noise-peak lag."""
    from tpu_se.infer.pesq import _fine_align, _utterance_spans

    fs = FS
    rng = np.random.default_rng(21)
    t = np.arange(int(0.9 * fs)) / fs
    u = (np.sin(2 * np.pi * 300 * t)
         * (0.25 + 0.75 * np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None))
         * 8000)
    sil = np.zeros(int(0.35 * fs))
    ref = np.concatenate([sil, u, sil, u, sil])
    spans = _utterance_spans(ref, fs)
    assert len(spans) == 2

    deg = ref + rng.normal(size=len(ref)) * 200.0
    s, e = spans[1]
    deg[s:e] = rng.normal(size=e - s) * 30.0     # second utterance wiped

    out = _fine_align(ref, deg, fs)
    # gate held: the wiped utterance region is untouched (crude timing)
    np.testing.assert_array_equal(out[s:e], deg[s:e])
    # and the intact utterance was also left at lag 0 (already aligned)
    s0, e0 = spans[0]
    np.testing.assert_array_equal(out[s0:e0], deg[s0:e0])

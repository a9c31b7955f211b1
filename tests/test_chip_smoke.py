"""chip_smoke.py's CPU-checkable parts: the device refusal, the corpus
phase and the reference-decode check, at tiny widths."""

import json
import os

import numpy as np
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(layersizes="1799,32,257", traincache=2048,
                        secs=(0.5, 1.5), n_cv=3, decode_utts=3,
                        stream_utts=1)


def test_refuses_a_cpu_only_backend(capsys):
    with pytest.raises(chip_smoke.NoGPU):
        chip_smoke.gpu_devices()
    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--four"]) == 2
    out, err = capsys.readouterr()
    assert "no GPU" in err
    assert '"ok"' not in out


def test_corpus_phase(tmp_path):
    from tpu_se.io import read_pfile_meta, read_wav

    corpus = chip_smoke.phase_corpus(str(tmp_path), 5, TINY)
    n_sents, _, dim, ends = read_pfile_meta(corpus.noisy_pfile)
    assert dim == 257
    assert n_sents == corpus.n_train + corpus.n_cv == len(corpus.noisy_wavs)
    assert corpus.n_cv == TINY.n_cv
    lengths = np.diff(np.concatenate([[0], ends]))
    assert np.sum(lengths[: corpus.n_train] - 6) >= TINY.traincache
    assert np.array_equal(read_pfile_meta(corpus.clean_pfile)[3], ends)
    assert os.path.getsize(corpus.norm) > 0
    noisy, sr = read_wav(corpus.noisy_wavs[0])
    clean, _ = read_wav(corpus.clean_wavs[0])
    assert sr == 16000 and noisy.dtype == np.int16
    assert noisy.shape == clean.shape and not np.array_equal(noisy, clean)
    # The same seed writes the same audio.
    again, _, _ = chip_smoke.make_wav_pairs(str(tmp_path / "again"), 5,
                                            int(TINY.traincache * 1.03),
                                            TINY.n_cv, TINY.secs)
    assert np.array_equal(read_wav(again[-1])[0],
                          read_wav(corpus.noisy_wavs[-1])[0])


def test_reference_decode_check(tmp_path):
    """The CLI's batch decode agrees with the float64 numpy decode within
    the smoke's tolerance, and the check sees a corrupted output."""
    from tpu_se.dsp import wav_to_lps
    from tpu_se.io import read_wav, write_norm, write_wav, write_wts
    from tpu_se.models import init_params, params_to_wts

    noisy, _, _ = chip_smoke.make_wav_pairs(str(tmp_path / "c"), 9, 200, 2,
                                            (0.5, 1.2))
    lps = np.concatenate([wav_to_lps(read_wav(p)[0]) for p in noisy])
    norm = str(tmp_path / "m.norm")
    write_norm(norm, lps.mean(0), 1.0 / (lps.std(0) + 1e-3))
    wts = str(tmp_path / "m.wts")
    write_wts(wts, params_to_wts(init_params(3, (1799, 32, 257))))
    out = str(tmp_path / "out")
    scp = str(tmp_path / "d.scp")
    with open(scp, "w") as f:
        f.write("".join(p + "\n" for p in noisy))
    chip_smoke.cli(["decode", "--scp", scp, "--wts", wts, "--norm", norm,
                    "--batch", len(noisy), "--out-dir", out],
                   str(tmp_path / "decode.log"))
    assert chip_smoke.check_reference_decode(wts, norm, noisy, out) <= 2

    stem = os.path.splitext(os.path.basename(noisy[0]))[0]
    path = os.path.join(out, stem + "_enhanced.wav")
    wave, sr = read_wav(path)
    wave = wave.copy()
    wave[100] = np.int16(np.clip(int(wave[100]) + 7 if wave[100] < 0
                                 else int(wave[100]) - 7, -32768, 32767))
    write_wav(path, wave, sr)
    assert chip_smoke.check_reference_decode(wts, norm, noisy, out) >= 7


def test_last_line_contract(monkeypatch, capsys, tmp_path):
    """With a GPU, the run ends with the one-line JSON result naming the
    device JAX reports (phases stubbed; only the driver is under test)."""
    import jax

    devices = jax.devices()
    monkeypatch.setattr(chip_smoke, "gpu_devices", lambda: devices)
    monkeypatch.setattr(chip_smoke, "card_label", lambda: "card, 1 W")
    monkeypatch.setattr(chip_smoke, "phase_device", lambda d, c: None)
    monkeypatch.setattr(chip_smoke, "run_single", lambda *a: None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old_cache = jax.config.jax_compilation_cache_dir
    try:
        assert chip_smoke.main([]) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", old_cache)
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}

"""Streaming (bounded-memory) dataset-build tools.

QuickNet's feacat / pfile_concat / qnnorm are streaming C++ programs — the
pfile format exists so archives far larger than RAM can be built and read
in blocks (``Interface.cc:746-766``, ``tools_pfile/get_norm.pl:3``).  These
tests pin the tpu_se build path to the same memory model:

- byte-identity of the streaming writer/concat/norm vs the in-memory
  implementations on the bundled fixtures;
- a multi-hundred-MB synthetic build + concat + norm in a subprocess under
  a measured RSS ceiling well below the archive size;
- ``make-pfile --jobs`` read-ahead produces byte-identical output.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tpu_se.io import (
    PfileWriter, compute_norm_pfile, concat_pfiles, read_pfile,
    read_pfile_meta, write_norm, write_pfile,
)
from tpu_se.io.norm import compute_norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pfile_writer_matches_one_shot(tmp_path):
    rng = np.random.default_rng(11)
    utts = [rng.normal(size=(t, 5)).astype(np.float32) for t in (7, 3, 12)]
    write_pfile(tmp_path / "one.pfile", utts)
    with PfileWriter(tmp_path / "stream.pfile") as w:
        for u in utts:
            w.add(u)
    assert (tmp_path / "one.pfile").read_bytes() == \
        (tmp_path / "stream.pfile").read_bytes()


def test_concat_single_is_identity(reference_dir, tmp_path):
    """Streaming concat of one archive reproduces a re-write of it exactly
    (sent/frame ids and sentence table preserved bit-for-bit)."""
    src = reference_dir / "tools_pfile/train_noisy.pfile"
    concat_pfiles(tmp_path / "cat.pfile", [src])
    pf = read_pfile(src)
    write_pfile(tmp_path / "rewrite.pfile",
                [pf.sentence(i) for i in range(pf.num_sentences)])
    assert (tmp_path / "cat.pfile").read_bytes() == \
        (tmp_path / "rewrite.pfile").read_bytes()


def test_concat_matches_in_memory(reference_dir, tmp_path):
    """Streaming concat (raw-row block copy + sent-id remap) is
    byte-identical to decode-everything-then-rewrite."""
    noisy = reference_dir / "tools_pfile/train_noisy.pfile"
    clean = reference_dir / "tools_pfile/train_clean.pfile"
    concat_pfiles(tmp_path / "cat.pfile", [noisy, clean])

    utts = []
    for p in (noisy, clean):
        pf = read_pfile(p)
        utts.extend(pf.sentence(i) for i in range(pf.num_sentences))
    write_pfile(tmp_path / "mem.pfile", utts)

    assert (tmp_path / "cat.pfile").read_bytes() == \
        (tmp_path / "mem.pfile").read_bytes()
    n_sents, n_frames, dim, ends = read_pfile_meta(tmp_path / "cat.pfile")
    assert (n_sents, n_frames, dim) == (20, 2 * 1885, 257)


def test_streaming_norm_matches_in_memory(reference_dir, tmp_path):
    src = reference_dir / "tools_pfile/train_noisy.pfile"
    mean_s, inv_s = compute_norm_pfile(src, block_frames=301)
    pf = read_pfile(src)
    mean_m, inv_m = compute_norm(pf.features)
    np.testing.assert_allclose(mean_s, mean_m, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(inv_s, inv_m, rtol=1e-6, atol=1e-8)
    # The written .norm files (%.6g) are byte-identical.
    write_norm(tmp_path / "s.norm", mean_s, inv_s)
    write_norm(tmp_path / "m.norm", mean_m, inv_m)
    assert (tmp_path / "s.norm").read_bytes() == \
        (tmp_path / "m.norm").read_bytes()


_BIG_BUILD = textwrap.dedent("""
    import sys
    import numpy as np
    from tpu_se.io import PfileWriter, compute_norm_pfile, concat_pfiles

    out_dir = sys.argv[1]
    dim, n_sents, frames_per = 257, 290, 1000   # ~300 MB source archive
    rng_master = np.random.default_rng(123)
    seeds = rng_master.integers(0, 2**31, size=n_sents)

    src = out_dir + "/big.pfile"
    with PfileWriter(src) as w:
        for s in seeds:                      # one utterance resident at a time
            rng = np.random.default_rng(int(s))
            w.add(rng.normal(loc=2.0, scale=3.0,
                             size=(frames_per, dim)).astype(np.float32))

    cat = out_dir + "/big2.pfile"            # ~600 MB concat output
    concat_pfiles(cat, [src, src])

    mean, inv_std = compute_norm_pfile(cat)  # stream over 600 MB
    assert mean.shape == (dim,)
    assert abs(float(mean.mean()) - 2.0) < 0.02
    assert abs(float((1.0 / inv_std).mean()) - 3.0) < 0.02

    # VmHWM (peak RSS of THIS address space) rather than ru_maxrss: the
    # latter survives execve, so a child forked from a large pytest parent
    # inherits the parent's COW footprint as its "max".
    with open("/proc/self/status") as f:
        hwm_kb = next(int(line.split()[1]) for line in f
                      if line.startswith("VmHWM:"))
    print(f"RSS_MB={hwm_kb / 1024:.1f}")
""")


@pytest.mark.slow
def test_big_build_bounded_rss(tmp_path):
    """Build a ~300 MB pfile, streaming-concat it to ~600 MB, and norm the
    result — all in a subprocess whose peak RSS stays far below the archive
    size (the in-memory implementations would need >600 MB just for the
    decoded float32 features)."""
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", _BIG_BUILD, str(tmp_path)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    rss = float(r.stdout.strip().split("RSS_MB=")[1])
    src_mb = os.path.getsize(tmp_path / "big.pfile") / 2**20
    cat_mb = os.path.getsize(tmp_path / "big2.pfile") / 2**20
    assert src_mb > 250 and cat_mb > 500, (src_mb, cat_mb)
    # Python+numpy+tpu_se.io baseline is ~165 MB on this image; the build
    # adds only O(block) buffers.  An in-memory build would exceed this by
    # the full archive size.
    assert rss < 400, f"streaming build peaked at {rss:.0f} MB RSS"


def _cli(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "tpu_se", *args],
                          capture_output=True, text=True, env=env)


def test_make_pfile_jobs_identical(tmp_path):
    """--jobs read-ahead must not change the output bytes or the scp order."""
    from tpu_se.io import write_htk

    rng = np.random.default_rng(3)
    paths = []
    for i in range(6):
        p = tmp_path / f"u{i}.lps"
        write_htk(p, rng.normal(size=(30 + 7 * i, 17)).astype(np.float32))
        paths.append(str(p))
    scp = tmp_path / "l.scp"
    scp.write_text("\n".join(paths) + "\n")

    r1 = _cli("make-pfile", str(scp), "-o", str(tmp_path / "j1.pfile"),
              "--lenfile", str(tmp_path / "j1.len"))
    assert r1.returncode == 0, r1.stderr
    r4 = _cli("make-pfile", str(scp), "-o", str(tmp_path / "j4.pfile"),
              "--jobs", "4", "--lenfile", str(tmp_path / "j4.len"))
    assert r4.returncode == 0, r4.stderr
    assert (tmp_path / "j1.pfile").read_bytes() == \
        (tmp_path / "j4.pfile").read_bytes()
    assert (tmp_path / "j1.len").read_text() == \
        (tmp_path / "j4.len").read_text()


def test_lps_extract_jobs_identical(tmp_path):
    """lps-extract --jobs N writes byte-identical .lps files to serial."""
    import wave as wave_mod

    rng = np.random.default_rng(4)
    paths = []
    for i in range(4):
        p = tmp_path / f"w{i}.wav"
        with wave_mod.open(str(p), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((rng.normal(size=8000 + 512 * i) * 3000)
                          .astype("<i2").tobytes())
        paths.append(str(p))
    scp = tmp_path / "w.scp"
    scp.write_text("\n".join(paths) + "\n")

    r1 = _cli("lps-extract", "--scp", str(scp))
    assert r1.returncode == 0, r1.stderr
    serial = {p: (tmp_path / f"w{i}.lps").read_bytes()
              for i, p in enumerate(paths)}
    for i in range(4):
        (tmp_path / f"w{i}.lps").unlink()

    r2 = _cli("lps-extract", "--scp", str(scp), "--jobs", "3")
    assert r2.returncode == 0, r2.stderr
    for i, p in enumerate(paths):
        assert (tmp_path / f"w{i}.lps").read_bytes() == serial[p]


def test_pfile_writer_abort_leaves_no_file(tmp_path):
    """An aborted build (exception mid-stream) must leave NOTHING under the
    final name — presence implies completeness for resume-by-existence
    build scripts — and a completed build replaces atomically."""
    rng = np.random.default_rng(1)
    target = tmp_path / "out.pfile"
    with pytest.raises(RuntimeError):
        with PfileWriter(target) as w:
            w.add(rng.normal(size=(5, 3)).astype(np.float32))
            raise RuntimeError("unreadable utterance")
    assert not target.exists()
    assert not list(tmp_path.glob("*.tmp.*"))

    # empty build: ValueError, and still nothing left behind
    with pytest.raises(ValueError):
        with PfileWriter(target) as w:
            pass
    assert not target.exists()
    assert not list(tmp_path.glob("*.tmp.*"))

    with PfileWriter(target) as w:
        w.add(rng.normal(size=(5, 3)).astype(np.float32))
    assert target.exists()


def test_concat_renumbers_noncanonical_ids(tmp_path):
    """Inputs whose sent/frame id columns are NOT canonical still concat to
    canonical output (the in-memory decode-and-rewrite behavior)."""
    rng = np.random.default_rng(2)
    utts = [rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(6, 3)).astype(np.float32)]
    src = tmp_path / "weird.pfile"
    write_pfile(src, utts)
    # corrupt the id columns: sent ids 7/9, frame ids reversed
    raw = bytearray(src.read_bytes())
    rows = np.frombuffer(bytes(raw), dtype=">i4",
                         offset=32768, count=10 * 5).reshape(10, 5).copy()
    rows[:4, 0], rows[4:, 0] = 7, 9
    rows[:, 1] = rows[::-1, 1]
    raw[32768:32768 + 10 * 5 * 4] = rows.tobytes()
    src.write_bytes(bytes(raw))

    concat_pfiles(tmp_path / "cat.pfile", [src, src])
    pf = read_pfile(tmp_path / "cat.pfile")
    np.testing.assert_array_equal(pf.sent_ids,
                                  [0] * 4 + [1] * 6 + [2] * 4 + [3] * 6)
    np.testing.assert_array_equal(
        pf.frame_ids, list(range(4)) + list(range(6)) + list(range(4))
        + list(range(6)))
    np.testing.assert_array_equal(pf.sentence(2), utts[0])


def test_ordered_readahead_order_and_errors(tmp_path):
    """ordered_readahead preserves input order, bounds look-ahead, and
    propagates worker exceptions at the failing item's position."""
    import time

    from tpu_se.io.readahead import ordered_readahead

    def slow_sq(x):
        time.sleep(0.001 * (5 - x % 5))
        return x * x

    items = list(range(20))
    assert list(ordered_readahead(items, slow_sq, jobs=4)) == \
        [x * x for x in items]
    assert list(ordered_readahead(items, slow_sq, jobs=1)) == \
        [x * x for x in items]

    def boom(x):
        if x == 7:
            raise RuntimeError("bad item")
        return x

    out = []
    with pytest.raises(RuntimeError):
        for v in ordered_readahead(items, boom, jobs=3):
            out.append(v)
    assert out == list(range(7))


def test_concat_multiblock_byte_identical(tmp_path):
    """Streaming concat across STREAM_BLOCK_FRAMES boundaries (sentences
    straddling block edges) is byte-identical to decode-and-rewrite."""
    from tpu_se.io.pfile import STREAM_BLOCK_FRAMES

    rng = np.random.default_rng(8)
    # ~21k frames in deliberately awkward sentence lengths so several
    # sentences straddle the 16384-frame block edge.
    lengths = [5000, 4999, 7001, 2500, 1500, 777]
    assert sum(lengths) > STREAM_BLOCK_FRAMES
    utts = [rng.normal(size=(t, 5)).astype(np.float32) for t in lengths]
    src = tmp_path / "big.pfile"
    write_pfile(src, utts)

    concat_pfiles(tmp_path / "cat.pfile", [src, src])

    pf = read_pfile(src)
    both = [pf.sentence(i) for i in range(pf.num_sentences)] * 2
    write_pfile(tmp_path / "mem.pfile", both)
    assert (tmp_path / "cat.pfile").read_bytes() == \
        (tmp_path / "mem.pfile").read_bytes()

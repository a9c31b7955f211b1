#!/usr/bin/env python
"""Host-side chunk-loader micro-bench: native C++ vs numpy.

Justifies (or retires) the native path (``native/chunk_loader.cc``) with a
measured number: builds a synthetic multi-MB pfile, then times the full
read+swap+normalize of a chunk span through both implementations, plus the
splice-scatter. Prints one JSON line.

Pure host work — run on CPU:
    JAX_PLATFORMS=cpu python tools/bench_loader.py
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_se.io import native, write_pfile
from tpu_se.io.pfile import PFILE_HEADER_SIZE, read_pfile_rows

N_FRAMES = 50_000          # ~52 MB of raw rows at dim 257
DIM = 257
REPEATS = 3


def main() -> int:
    if not native.available():
        print(json.dumps({"error": "native library not built"}))
        return 1
    rng = np.random.default_rng(0)
    utts = [rng.standard_normal((N_FRAMES // 10, DIM)).astype(np.float32)
            for _ in range(10)]
    mean = np.zeros(DIM, np.float32)
    inv = np.ones(DIM, np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.pfile")
        write_pfile(path, utts)
        n = sum(len(u) for u in utts)

        def run_native():
            return native.read_chunk_normalized(
                path, PFILE_HEADER_SIZE, DIM, 0, n, mean, inv)

        def run_numpy():
            rows = read_pfile_rows(path, DIM, 0, n)
            return ((rows - mean) * inv).astype(np.float32)

        out_n = run_native()            # warm page cache + check parity
        out_p = run_numpy()
        np.testing.assert_allclose(out_n, out_p, rtol=0, atol=0)

        t_native = min(_time(run_native) for _ in range(REPEATS))
        t_numpy = min(_time(run_numpy) for _ in range(REPEATS))

        starts = rng.permutation(n - 7)[: n // 2].astype(np.int32)
        scatter = rng.permutation(len(starts)).astype(np.int32)

        def run_splice_native():
            return native.splice_scatter(out_n, starts, scatter, 7)

        def run_splice_numpy():
            idx = starts[:, None] + np.arange(7)[None, :]
            spliced = out_n[idx].reshape(len(starts), 7 * DIM)
            out = np.empty_like(spliced)
            out[scatter] = spliced
            return out

        np.testing.assert_allclose(run_splice_native(), run_splice_numpy())
        t_sn = min(_time(run_splice_native) for _ in range(REPEATS))
        t_sp = min(_time(run_splice_numpy) for _ in range(REPEATS))

    mb = n * (DIM + 2) * 4 / 1e6
    print(json.dumps({
        "metric": "loader_read_swap_normalize_MBps",
        "value": round(mb / t_native, 1),
        "unit": "MB/s",
        "vs_baseline": round(t_numpy / t_native, 3),   # speedup over numpy
        "detail": {
            "frames": n, "raw_MB": round(mb, 1),
            "native_ms": round(t_native * 1e3, 1),
            "numpy_ms": round(t_numpy * 1e3, 1),
            "splice_native_ms": round(t_sn * 1e3, 1),
            "splice_numpy_ms": round(t_sp * 1e3, 1),
        },
    }))
    return 0


def _time(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    sys.exit(main())

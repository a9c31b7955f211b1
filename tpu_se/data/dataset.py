"""Paired noisy/clean pfile dataset -> normalized per-chunk training batches.

The reference's host data engine (``Interface.cc:719-965``) per chunk:
fseek+fread raw rows, byte-swap, Z-score normalize with the NOISY statistics
(targets too: ``mean[j % fea_dim]``, ``Interface.cc:804-810``), 7-frame
context-expand, scatter to a shuffled order.  Here the normalize is a
vectorized numpy op and the splice/shuffle are index arrays consumed by a
device-side gather in the training step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpu_se.data.chunks import ChunkPlan, plan_chunks
from tpu_se.data.splice import splice_frames, window_starts_for_chunk
from tpu_se.io import native
from tpu_se.io.norm import read_norm
from tpu_se.io.pfile import (
    PFILE_HEADER_SIZE, read_pfile_meta, read_pfile_rows,
)


@dataclass
class Chunk:
    """One traincache-sized chunk, ready for device upload.

    ``noisy``/``clean`` are the chunk's normalized frames [F, 257]; a training
    sample i is noisy frames [starts[i], starts[i]+context) spliced to 1799
    dims with target clean frame ``starts[i] + targ_offset``.
    """
    noisy: np.ndarray      # float32 [F, D]
    clean: np.ndarray      # float32 [F, D]
    starts: np.ndarray     # int32 [N] window starts, relative to chunk
    context: int
    targ_offset: int

    @property
    def n_samples(self) -> int:
        return len(self.starts)

    def spliced_inputs(self) -> np.ndarray:
        """Host-side materialized [N, context*D] (parity/CV path)."""
        return splice_frames(self.noisy, self.starts, self.context)

    def targets(self) -> np.ndarray:
        return self.clean[self.starts + self.targ_offset]


class PfilePairDataset:
    """Noisy/clean pfile pair with reference chunking semantics.

    Streaming by design: only the headers and sentence tables are parsed up
    front; each chunk's rows are read, byte-swapped and normalized on
    demand — via the native C++ loader when built (``native/``), else
    numpy.  This mirrors the reference's per-chunk fseek/fread engine and
    keeps memory flat for arbitrarily large pfiles.
    """

    def __init__(self, noisy_pfile, clean_pfile, norm_file,
                 sent_range: tuple[int, int], traincache: int = 102400,
                 context: int = 7, targ_offset: int = 3,
                 use_native: bool | None = None):
        self.noisy_path = str(noisy_pfile)
        self.clean_path = str(clean_pfile)
        n_sents, n_frames, dim, sent_ends = read_pfile_meta(noisy_pfile)
        c_sents, c_frames, c_dim, c_ends = read_pfile_meta(clean_pfile)
        if (n_sents, n_frames) != (c_sents, c_frames) or \
                not np.array_equal(sent_ends, c_ends):
            raise ValueError("noisy/clean pfile sentence tables differ "
                             "(Interface.cc:560-580 consistency check)")
        self._dim = dim
        self._clean_dim = c_dim
        self.sent_ends = sent_ends
        self.mean, self.inv_std = read_norm(norm_file, dim)
        self.context = context
        self.targ_offset = targ_offset
        self.use_native = native.available() if use_native is None else use_native
        self.plan: ChunkPlan = plan_chunks(
            sent_ends, sent_range, traincache, context)

    @property
    def n_chunks(self) -> int:
        return self.plan.n_chunks

    @property
    def total_samples(self) -> int:
        return self.plan.total_samples

    @property
    def dim(self) -> int:
        return self._dim

    def _read_normalized(self, path: str, dim: int, lo: int, hi: int
                         ) -> np.ndarray:
        # Targets use the NOISY statistics too (Interface.cc:804-810,
        # mean[j % fea_dim]) — with equal dims that is simply (mean, inv).
        if self.use_native:
            return native.read_chunk_normalized(
                path, PFILE_HEADER_SIZE, dim, lo, hi, self.mean, self.inv_std)
        rows = read_pfile_rows(path, dim, lo, hi)
        return ((rows - self.mean) * self.inv_std).astype(np.float32)

    def chunk(self, idx: int, rng: np.random.Generator | None = None) -> Chunk:
        """Load chunk ``idx``; pass an rng for shuffled training order.

        The noisy/clean files are read on two threads (the native loader
        releases the GIL during the C call), halving the critical-path host
        time — together with the PrefetchIterator double buffer this keeps
        the device fed at chunk granularity.
        """
        from concurrent.futures import ThreadPoolExecutor

        lo = int(self.plan.frame_start[idx])
        hi = int(self.plan.frame_end[idx])
        with ThreadPoolExecutor(2) as pool:
            f_noisy = pool.submit(self._read_normalized, self.noisy_path,
                                  self._dim, lo, hi)
            f_clean = pool.submit(self._read_normalized, self.clean_path,
                                  self._clean_dim, lo, hi)
            noisy, clean = f_noisy.result(), f_clean.result()
        starts = window_starts_for_chunk(self.plan, idx, rng) - lo
        return Chunk(noisy, clean, starts.astype(np.int32),
                     self.context, self.targ_offset)

    def epoch_chunks(self, rng: np.random.Generator, skip: int = 0):
        """Shuffled chunk order + shuffled samples (BPtrain.cc:86-100).

        ``skip`` replays the rng draws of the first N chunks without
        loading their data — mid-epoch resume lands on the exact shuffle
        sequence an uninterrupted epoch would have used.
        """
        for i, idx in enumerate(rng.permutation(self.n_chunks)):
            if i < skip:
                self.chunk_starts(int(idx), rng)   # consume rng identically
            else:
                yield self.chunk(int(idx), rng)

    # -- device-resident mode -------------------------------------------
    #
    # Fast path: when the sentence range fits in device memory, the frame
    # matrices are uploaded ONCE per job and an epoch only ships the
    # shuffled window-start indices (~0.4 MB/chunk instead of ~210 MB).
    # The reference semantics (chunk grouping, per-chunk shuffle, edge
    # drop) are unchanged — they live entirely in the index generation.

    def frame_span(self) -> tuple[int, int]:
        """Absolute [lo, hi) frame range covered by this sentence range."""
        return int(self.plan.frame_start[0]), int(self.plan.frame_end[-1])

    def span_bytes(self) -> int:
        lo, hi = self.frame_span()
        return (hi - lo) * (self._dim + self._clean_dim) * 4

    def load_span_normalized(self, process_shard: tuple[int, int] | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Normalized (noisy, clean) frames for the whole range.

        ``process_shard=(process_index, process_count)``: multi-host input
        sharding — this host reads only its ``shard_for_host`` slice of the
        rows from storage and the full span is reassembled across processes
        over the interconnect (``allgather_host_rows``).
        """
        from concurrent.futures import ThreadPoolExecutor

        lo, hi = self.frame_span()
        if process_shard is not None and process_shard[1] > 1:
            from tpu_se.data.pipeline import shard_for_host
            from tpu_se.parallel.distributed import allgather_host_rows

            pid, pcount = process_shard
            s = shard_for_host(hi - lo, pid, pcount)
            with ThreadPoolExecutor(2) as pool:
                f_n = pool.submit(self._read_normalized, self.noisy_path,
                                  self._dim, lo + s.start, lo + s.stop)
                f_c = pool.submit(self._read_normalized, self.clean_path,
                                  self._clean_dim, lo + s.start, lo + s.stop)
                n_local, c_local = f_n.result(), f_c.result()
            return (allgather_host_rows(n_local, hi - lo, pid, pcount),
                    allgather_host_rows(c_local, hi - lo, pid, pcount))
        with ThreadPoolExecutor(2) as pool:
            f_n = pool.submit(self._read_normalized, self.noisy_path,
                              self._dim, lo, hi)
            f_c = pool.submit(self._read_normalized, self.clean_path,
                              self._clean_dim, lo, hi)
            return f_n.result(), f_c.result()

    def chunk_starts(self, idx: int,
                     rng: np.random.Generator | None = None) -> np.ndarray:
        """Window starts for chunk ``idx`` relative to the range span."""
        lo, _ = self.frame_span()
        return (window_starts_for_chunk(self.plan, idx, rng)
                - lo).astype(np.int32)

    def epoch_chunk_starts(self, rng: np.random.Generator):
        for idx in rng.permutation(self.n_chunks):
            yield self.chunk_starts(int(idx), rng)

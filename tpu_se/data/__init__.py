"""Data layer: pfile chunk planning, normalization, context splicing, prefetch.

Replaces the reference's host data engine (``Train_code_ML_GGD/Interface.cc``
chunk planner + Readchunk + producer pthread) with a vectorized-numpy /
device-side design:

- ``chunks``     — chunk planner with the reference's per-sentence edge-drop
                   semantics (each sentence loses fea_context-1 frames).
- ``splice``     — 7-frame context expansion, host (parity) and device
                   (gather, the training fast path) variants.
- ``dataset``    — paired noisy/clean pfile dataset -> per-chunk batches.
- ``pipeline``   — double-buffered background prefetch (the producer-thread
                   equivalent) and per-host sharding for multi-process DP.
"""

from tpu_se.data.chunks import ChunkPlan, plan_chunks, sentence_windows
from tpu_se.data.splice import splice_frames, window_starts_for_chunk
from tpu_se.data.dataset import PfilePairDataset, Chunk
from tpu_se.data.pipeline import PrefetchIterator

__all__ = [
    "ChunkPlan", "plan_chunks", "sentence_windows",
    "splice_frames", "window_starts_for_chunk",
    "PfilePairDataset", "Chunk", "PrefetchIterator",
]

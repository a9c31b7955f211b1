"""Training driver: the ``finetune.pl`` + ``BPtrain.cc`` equivalent.

Epoch protocol (``finetune.pl:10-155``, ``BPtrain.cc:55-146``):

- 50 epochs; epoch N trains from epoch N-1's weights.
- lr constant for epochs 1..10, then *= 0.9 per epoch (``finetune.pl:118-123``).
- per-epoch RNG seed = init_seed + 345*(epoch-1) (``finetune.pl:86,124``).
- resume-by-existence: an epoch whose output .wts exists is skipped
  (``finetune.pl:49,88,126``).
- momentum velocity resets at each epoch boundary (each reference epoch is
  a fresh process with zeroed delta buffers, ``BP_GPU.cu:60-78``); set
  ``carry_velocity=True`` for the corrected behavior.
- per-epoch CV metrics: squared error, abs error, GGD log-likelihood
  (``BPtrain.cc:112-139``).
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from tpu_se.data import PfilePairDataset, PrefetchIterator
from tpu_se.losses import ref_gamma
from tpu_se.models import DEFAULT_LAYERSIZES, init_params
from tpu_se.train.checkpoint import load_checkpoint, save_checkpoint
from tpu_se.train.step import (
    TrainHyper, TrainState, make_train_state, train_chunk,
)

FRAME_PAD_BUCKET = 4096


@dataclass
class TrainConfig:
    """All reference config keys (``Interface.cc:150-315`` key=value set),
    plus the new framework's knobs."""

    fea_file: str = ""
    targ_file: str = ""
    norm_file: str = ""
    init_wts_file: str = ""          # empty -> random init
    out_dir: str = "mlp_out"
    layersizes: tuple = DEFAULT_LAYERSIZES
    bunchsize: int = 128
    ml_flag: bool = True
    shapefactor: float = 1.0
    momentum: float = 0.9
    weightcost: float = 1e-5
    lrate: float = 0.1
    fea_dim: int = 257
    fea_context: int = 7
    traincache: int = 102400
    init_seed: int = 27870775
    targ_offset: int = 3
    train_sent_range: tuple = (0, 7)
    cv_sent_range: tuple = (8, 9)
    epochs: int = 50
    lr_const_epochs: int = 10
    lr_decay: float = 0.9
    seed_increment: int = 345
    grad_scale: str = "parity"
    compute_dtype: str = "float32"   # or "bfloat16"
    carry_velocity: bool = False
    # init_randem_{weight,bias}_{min,max} (Interface.cc:140-143): when set
    # (and no init_wts_file), random-init from these plain uniform ranges
    # instead of the Gen_rand_net fan-based scheme.
    init_ranges: tuple | None = None  # (w_min, w_max, b_min, b_max)
    activation: str = "sigmoid"      # "relu" = the reference's RELU build
    dropout_flag: bool = False       # dropoutflag (finetune.pl:74-76)
    visible_omit: float = 0.1
    hid_omit: float = 0.1
    device_resident: str = "auto"    # keep the dataset in HBM across epochs
    # Upload budget for a resident dataset: it bounds both the host RAM
    # the one-shot load takes and the device memory the frames then hold.
    device_resident_max_bytes: int = 4 << 30
    mesh: object = None              # optional jax.sharding.Mesh
    checkpoint_every_chunks: int = 0  # >0: mid-epoch partial checkpoints
    # Multi-host runtime (jax.distributed). Set coordinator ("host:port" of
    # process 0) on every process to join the cluster; the global mesh is
    # built automatically when mesh is None. cpu_collectives="gloo" for
    # multi-process CPU runs (tests / CI); GPUs use NCCL without it.
    coordinator: str = ""
    num_processes: int | None = None
    process_id: int | None = None
    cpu_collectives: str = ""

    def hyper(self) -> TrainHyper:
        return TrainHyper(
            beta=self.shapefactor, ml=self.ml_flag, momentum=self.momentum,
            weightcost=self.weightcost, bunchsize=self.bunchsize,
            context=self.fea_context, targ_offset=self.targ_offset,
            grad_scale=self.grad_scale,
            compute_dtype=jnp.bfloat16 if self.compute_dtype == "bfloat16"
            else jnp.float32,
            activation=self.activation,
            dropout=((self.visible_omit, self.hid_omit)
                     if self.dropout_flag else None),
        )

    def lr_for_epoch(self, epoch: int) -> float:
        decay_steps = max(0, epoch - self.lr_const_epochs)
        return self.lrate * (self.lr_decay ** decay_steps)

    def seed_for_epoch(self, epoch: int) -> int:
        return self.init_seed + self.seed_increment * (epoch - 1)


def _pad_rows(arr: np.ndarray, bucket: int = FRAME_PAD_BUCKET) -> np.ndarray:
    """Zero-pad the frame axis to a bucket multiple (bounds recompiles)."""
    f = arr.shape[0]
    target = -(-f // bucket) * bucket
    if target == f:
        return arr
    return np.concatenate(
        [arr, np.zeros((target - f, arr.shape[1]), dtype=arr.dtype)])


def load_device_frames(dataset: PfilePairDataset, mesh=None):
    """Upload a dataset's full normalized frame span to HBM (once per job).

    Returns (noisy_dev, clean_dev) for ``train_one_epoch(device_frames=...)``
    — the device-resident fast path: epochs then ship only index arrays.
    Under a multi-host runtime, each host reads only its 1/P row shard from
    storage (``shard_for_host``) and the span is reassembled over DCN.
    """
    import jax

    shard = ((jax.process_index(), jax.process_count())
             if jax.process_count() > 1 else None)
    noisy, clean = dataset.load_span_normalized(process_shard=shard)
    noisy, clean = _pad_rows(noisy), _pad_rows(clean)
    if mesh is not None:
        from tpu_se.parallel import replicated_sharding
        rep = replicated_sharding(mesh)
        return (jax.device_put(noisy, rep), jax.device_put(clean, rep))
    return jnp.asarray(noisy), jnp.asarray(clean)


def train_one_epoch(state: TrainState, dataset: PfilePairDataset,
                    hyper: TrainHyper, lr: float,
                    rng: np.random.Generator, mesh=None,
                    device_frames=None, log=print, start_chunk: int = 0,
                    ckpt_every: int = 0, ckpt_cb=None) -> TrainState:
    """One epoch over the dataset's chunks.

    ``start_chunk`` resumes mid-epoch: the skipped chunks' rng draws are
    replayed (not trained) so the shuffle sequence is identical to an
    uninterrupted epoch.  With ``ckpt_every`` > 0, ``ckpt_cb(state,
    chunks_done)`` fires after every N trained chunks — chunk-granular
    fault tolerance (the reference only restarts at epoch boundaries,
    ``finetune.pl:49``).
    """
    import jax

    lr_arr = jnp.float32(lr)
    n_chunks = dataset.n_chunks
    dropout_key = (jax.random.PRNGKey(int(rng.integers(2 ** 31)))
                   if hyper.dropout is not None else None)

    def sharded_starts(starts):
        if mesh is None:
            return jnp.asarray(starts)
        from tpu_se.parallel import batch_sharding
        return jax.device_put(starts, batch_sharding(mesh, 2, 1))

    def maybe_ckpt(st, i):
        if ckpt_every and ckpt_cb is not None and (i + 1) % ckpt_every == 0:
            ckpt_cb(st, i + 1)

    m = hyper.bunchsize
    if device_frames is not None:
        # Device-resident: frames stay in HBM; only indices move per chunk.
        noisy_dev, clean_dev = device_frames
        for i, starts in enumerate(
                PrefetchIterator(dataset.epoch_chunk_starts(rng))):
            if i < start_chunk:
                continue                   # rng already consumed by the gen
            n_bunches = len(starts) // m
            if n_bunches == 0:
                continue
            starts = starts[: n_bunches * m].reshape(n_bunches, m)
            chunk_key = (jax.random.fold_in(dropout_key, i)
                         if dropout_key is not None else None)
            state = train_chunk(state, noisy_dev, clean_dev,
                                sharded_starts(starts), lr_arr, hyper,
                                dropout_key=chunk_key)
            log(f"  chunk {i+1}/{n_chunks}: {n_bunches} bunches (resident)")
            maybe_ckpt(state, i)
        return state

    for i, chunk in enumerate(
            PrefetchIterator(dataset.epoch_chunks(rng, skip=start_chunk)),
            start=start_chunk):
        n_bunches = chunk.n_samples // m
        if n_bunches == 0:
            continue
        starts = chunk.starts[: n_bunches * m].reshape(n_bunches, m)
        noisy = _pad_rows(chunk.noisy)
        clean = _pad_rows(chunk.clean)
        if mesh is not None:
            from tpu_se.parallel import shard_train_args
            noisy, clean, starts = shard_train_args(mesh, noisy, clean, starts)
        chunk_key = (jax.random.fold_in(dropout_key, i)
                     if dropout_key is not None else None)
        state = train_chunk(state, jnp.asarray(noisy), jnp.asarray(clean),
                            jnp.asarray(starts), lr_arr, hyper,
                            dropout_key=chunk_key)
        log(f"  chunk {i+1}/{n_chunks}: {n_bunches} bunches")
        maybe_ckpt(state, i)
    return state


CV_BATCH = 4096


def evaluate_cv(state: TrainState, cv_dataset: PfilePairDataset,
                hyper: TrainHyper, device_frames=None) -> dict:
    """CV metrics over a dataset (sequential order, partial bunches kept —
    ``Interface.cc:841-965`` + ``BP_GPU.cu:187-306``).

    With ``device_frames`` the reductions run fully on device
    (mask-padded fixed-size batches, one compiled program).
    """
    from tpu_se.train.step import cv_chunk_metrics

    out_dim = cv_dataset.dim
    alpha = np.asarray(state.alpha, dtype=np.float64)
    sq = ab = sum_pow = 0.0
    n_total = 0

    def accumulate(noisy_dev, clean_dev, starts):
        nonlocal sq, ab, sum_pow, n_total
        for lo in range(0, len(starts), CV_BATCH):
            s = starts[lo:lo + CV_BATCH]
            n = len(s)
            mask = np.zeros(CV_BATCH, dtype=np.float32)
            mask[:n] = 1.0
            s_pad = np.zeros(CV_BATCH, dtype=np.int32)
            s_pad[:n] = s
            r_sq, r_ab, r_pw = cv_chunk_metrics(
                state.params, noisy_dev, clean_dev, jnp.asarray(s_pad),
                jnp.asarray(mask), state.alpha, hyper)
            sq += float(r_sq)
            ab += float(r_ab)
            sum_pow += float(r_pw)
            n_total += n

    if device_frames is not None:
        noisy_dev, clean_dev = device_frames
        for ci in range(cv_dataset.n_chunks):
            accumulate(noisy_dev, clean_dev, cv_dataset.chunk_starts(ci))
    else:
        for ci in range(cv_dataset.n_chunks):
            chunk = cv_dataset.chunk(ci)       # no rng -> sequential
            noisy_dev = jnp.asarray(_pad_rows(chunk.noisy))
            clean_dev = jnp.asarray(_pad_rows(chunk.clean))
            accumulate(noisy_dev, clean_dev, chunk.starts)

    gamma_val = ref_gamma(1.0 / hyper.beta)
    loglik = (n_total * out_dim * math.log(hyper.beta / (2.0 * gamma_val))
              - n_total * float(np.log(alpha).sum()) - sum_pow)
    return {"cv_squared_error": sq, "cv_abs_error": ab / out_dim,
            "cv_ggd_loglik": loglik, "cv_frames": n_total}


class _SilentEpochLogger:
    """EpochLogger stand-in for non-main processes (no file writes)."""

    def __call__(self, msg: str) -> None:
        pass

    def config(self, cfg) -> None:
        pass

    def finish(self, metrics: dict) -> None:
        pass


def run_training(cfg: TrainConfig, log=print) -> str:
    """Run the full multi-epoch schedule; returns the final .wts path.

    Multi-host (``cfg.coordinator`` set, one process per host, mirroring the
    per-process epoch model of ``finetune.pl``->``BPtrain`` but SPMD): every
    process runs the same schedule over a global device mesh; per-bunch
    gradient and GGD-alpha reductions become cross-device psums via GSPMD; input
    rows are read 1/P per host; only process 0 writes .wts/logs, with a
    barrier after each epoch so resume-by-existence stays consistent on
    shared storage.
    """
    import jax

    if cfg.coordinator:
        from tpu_se.parallel import initialize_distributed

        info = initialize_distributed(
            cfg.coordinator, cfg.num_processes, cfg.process_id,
            cfg.cpu_collectives or None)
        log(f"distributed: process {info['process_index']}/"
            f"{info['process_count']}, {info['global_devices']} devices")
    pcount = jax.process_count()
    is_main = jax.process_index() == 0
    if pcount > 1 and cfg.mesh is None:
        from tpu_se.parallel import make_mesh

        cfg.mesh = make_mesh(data=jax.device_count(), model=1)
        log(f"multi-host mesh: data={jax.device_count()}")

    def barrier(tag: str) -> None:
        if pcount > 1:
            from tpu_se.parallel.distributed import sync_processes

            sync_processes(tag)

    os.makedirs(cfg.out_dir, exist_ok=True)
    hyper = cfg.hyper()

    dataset = PfilePairDataset(
        cfg.fea_file, cfg.targ_file, cfg.norm_file, cfg.train_sent_range,
        cfg.traincache, cfg.fea_context, cfg.targ_offset)
    cv_dataset = PfilePairDataset(
        cfg.fea_file, cfg.targ_file, cfg.norm_file, cfg.cv_sent_range,
        cfg.traincache, cfg.fea_context, cfg.targ_offset)

    # HBM-resident datasets: upload once per job; epochs then move only
    # index arrays (host/interconnect traffic drops ~500x per epoch).
    def resident(ds):
        if cfg.device_resident == "never":
            return None
        if (cfg.device_resident == "auto"
                and ds.span_bytes() > cfg.device_resident_max_bytes):
            return None
        return load_device_frames(ds, cfg.mesh)

    train_frames = resident(dataset)
    cv_frames = resident(cv_dataset)
    if train_frames is not None:
        log(f"train span resident in HBM "
            f"({dataset.span_bytes() / 1e6:.0f} MB)")

    last_path = ""
    state = None          # in-memory state carried across epochs
    for epoch in range(1, cfg.epochs + 1):
        out_path = os.path.join(cfg.out_dir, f"mlp.{epoch}.wts")
        if os.path.exists(out_path):
            log(f"epoch {epoch}: {out_path} exists, skipping (resume)")
            last_path = out_path
            state = None  # must reload from disk when training resumes
            continue

        if epoch == 1:
            if cfg.init_wts_file:
                state = load_checkpoint(cfg.init_wts_file)
            elif cfg.init_ranges is not None:
                from tpu_se.models import init_params_uniform

                params = init_params_uniform(
                    cfg.seed_for_epoch(1), cfg.layersizes, *cfg.init_ranges)
                state = make_train_state(params, cfg.layersizes[-1])
            else:
                params = init_params(cfg.seed_for_epoch(1), cfg.layersizes)
                state = make_train_state(params, cfg.layersizes[-1])
        else:
            # Reuse the state already in hand (it is bit-identical to the
            # .wts just written: the fp32 round-trip is exact); reload from
            # disk only on resume.  Saves a 150 MB disk read + a full
            # host->device weight upload per epoch.
            if state is None:
                state = load_checkpoint(last_path)
            if not cfg.carry_velocity:
                state = make_train_state(state.params, cfg.layersizes[-1])

        # Mid-epoch resume: a partial checkpoint (written every
        # checkpoint_every_chunks trained chunks) restarts inside the
        # epoch with the exact optimizer state and shuffle position.
        # Partial checkpoints are chunk-stamped and committed by an atomic
        # meta rename: mlp.N.partial.<k>.wts (+ .state.npz sidecar) are
        # fully written and fsync'd BEFORE the meta file naming <k> is
        # renamed into place.  A crash at ANY point leaves meta pointing at
        # a complete, self-consistent (weights, velocity, alpha, position)
        # set — with a single mutable partial path, a kill between the .wts
        # and sidecar renames could mix chunk-k weights with chunk-(k-1)
        # velocity and silently break bit-exact resume.  Non-main processes
        # only ever read the committed meta (on restart, from shared
        # storage), so multi-host resume sees the same consistent set.
        partial_stem = os.path.join(cfg.out_dir, f"mlp.{epoch}.partial")
        meta_path = f"{partial_stem}.wts.meta.json"
        start_chunk = 0
        if cfg.checkpoint_every_chunks and os.path.exists(meta_path):
            import json
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("epoch") == epoch:
                start_chunk = int(meta["chunks_done"])
                pp = f"{partial_stem}.{start_chunk}.wts"
                if not os.path.exists(pp) and \
                        os.path.exists(f"{partial_stem}.wts"):
                    # Partial written by the pre-round-5 unstamped format
                    # (single mutable mlp.N.partial.wts): honor it so an
                    # upgrade mid-run still resumes.
                    pp = f"{partial_stem}.wts"
                if os.path.exists(pp):
                    state = load_checkpoint(pp)
                    log(f"epoch {epoch}: resuming mid-epoch at chunk "
                        f"{start_chunk} from {pp}")
                else:
                    start_chunk = 0
                    log(f"epoch {epoch}: partial meta found but no "
                        f"checkpoint file; restarting epoch")

        def _partial_files():
            import glob
            return glob.glob(f"{partial_stem}.*")

        def save_partial(st, chunks_done, _epoch=epoch,
                         _stem=partial_stem, _mp=meta_path):
            import json
            if not is_main:
                return
            from tpu_se.io.atomic import atomic_write

            pp = f"{_stem}.{chunks_done}.wts"
            save_checkpoint(pp, st)
            atomic_write(_mp, lambda f: json.dump(
                {"epoch": _epoch, "chunks_done": chunks_done}, f),
                mode="w")   # the rename is the commit point
            # Older stamped partials are garbage once the new meta commits.
            for p in _partial_files():
                if (not p.endswith(".meta.json")
                        and f".{chunks_done}.wts" not in p):
                    try:
                        os.remove(p)
                    except OSError:
                        pass

        lr = cfg.lr_for_epoch(epoch)
        rng = np.random.default_rng(cfg.seed_for_epoch(epoch))
        from tpu_se.utils import EpochLogger
        elog = (EpochLogger(cfg.out_dir, epoch) if is_main
                else _SilentEpochLogger())
        elog(f"epoch {epoch} lr={lr:.6g} seed={cfg.seed_for_epoch(epoch)}")
        elog.config(cfg)
        t0 = time.time()
        state = train_one_epoch(state, dataset, hyper, lr, rng,
                                mesh=cfg.mesh, device_frames=train_frames,
                                log=elog, start_chunk=start_chunk,
                                ckpt_every=cfg.checkpoint_every_chunks,
                                ckpt_cb=(save_partial
                                         if cfg.checkpoint_every_chunks
                                         else None))
        metrics = evaluate_cv(state, cv_dataset, hyper,
                              device_frames=cv_frames)
        dt = time.time() - t0
        if is_main:
            # Velocity is reset each epoch under the parity schedule and
            # alpha is recomputed at the first ML bunch, so the full-state
            # sidecar only matters when velocity carries across epochs.
            save_checkpoint(out_path, state, with_state=cfg.carry_velocity)
            for p in _partial_files():
                if os.path.exists(p):
                    os.remove(p)
        # Non-main processes must not start epoch N+1 (which loads this
        # epoch's .wts from shared storage) before process 0 finished it.
        barrier(f"epoch-{epoch}")
        elog.finish(metrics)
        log(f"epoch {epoch}: sq={metrics['cv_squared_error']:.1f} "
            f"abs={metrics['cv_abs_error']:.1f} "
            f"ll={metrics['cv_ggd_loglik']:.1f} ({dt:.1f}s)")
        last_path = out_path
    return last_path

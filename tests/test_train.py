"""Training-engine tests: bitwise-level parity with the reference math,
fixture convergence, checkpoint/resume."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_se.models import init_params
from tpu_se.reference import np_train_chunk
from tpu_se.train import (
    TrainConfig, TrainHyper, evaluate_cv, load_checkpoint, make_train_state,
    run_training, save_checkpoint, train_chunk,
)


def _tiny_problem(seed=0, n_frames=64, dim=5, ctx=3, m=8, n_bunches=3):
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(n_frames, dim)).astype(np.float32)
    clean = (noisy * 0.8 + rng.normal(scale=0.1, size=(n_frames, dim))
             ).astype(np.float32)
    starts = rng.integers(0, n_frames - ctx, size=(n_bunches, m)
                          ).astype(np.int32)
    layersizes = (dim * ctx, 11, 7, dim)
    params = init_params(seed + 1, layersizes)
    return noisy, clean, starts, params, layersizes


@pytest.mark.parametrize("ml,beta,grad_scale", [
    (False, 2.0, "parity"),
    (False, 1.0, "parity"),
    (True, 1.0, "parity"),
    (True, 0.9, "parity"),
    (False, 2.0, "natural"),
])
def test_train_chunk_matches_reference_math(ml, beta, grad_scale):
    noisy, clean, starts, params, layersizes = _tiny_problem()
    hyper = TrainHyper(beta=beta, ml=ml, momentum=0.9, weightcost=1e-5,
                       bunchsize=8, context=3, targ_offset=1,
                       grad_scale=grad_scale)
    lr = 0.05
    # Snapshot to host first: train_chunk donates the state buffers.
    params_np = [{"w": np.asarray(l["w"]).copy(),
                  "b": np.asarray(l["b"]).copy()} for l in params]
    state = make_train_state(params, layersizes[-1])
    new_state = train_chunk(state, jnp.asarray(noisy), jnp.asarray(clean),
                            jnp.asarray(starts), jnp.float32(lr), hyper)
    W, B, alpha = np_train_chunk(params_np, noisy, clean, starts, lr, hyper)
    for l in range(len(W)):
        np.testing.assert_allclose(np.asarray(new_state.params[l]["w"]),
                                   W[l], rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(new_state.params[l]["b"]),
                                   B[l], rtol=2e-4, atol=1e-6)
    if ml:
        np.testing.assert_allclose(np.asarray(new_state.alpha), alpha,
                                   rtol=1e-4)


def test_partial_bunches_dropped_semantics():
    """Callers reshape starts[: nb*m]; a 10-sample chunk with m=8 trains 1
    bunch — the step itself must not see the remainder."""
    noisy, clean, starts, params, layersizes = _tiny_problem(n_bunches=1)
    hyper = TrainHyper(beta=2.0, ml=False, bunchsize=8, context=3,
                       targ_offset=1)
    w0 = np.asarray(params[0]["w"]).copy()
    state = make_train_state(params, layersizes[-1])
    out = train_chunk(state, jnp.asarray(noisy), jnp.asarray(clean),
                      jnp.asarray(starts), jnp.float32(0.01), hyper)
    assert not np.allclose(np.asarray(out.params[0]["w"]), w0)


def test_checkpoint_roundtrip(tmp_path):
    _, _, _, params, layersizes = _tiny_problem()
    state = make_train_state(params, layersizes[-1])
    state.velocity[0]["w"] = state.velocity[0]["w"] + 0.5
    path = str(tmp_path / "m.wts")
    save_checkpoint(path, state)
    back = load_checkpoint(path)
    np.testing.assert_allclose(np.asarray(back.params[0]["w"]),
                               np.asarray(state.params[0]["w"]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(back.velocity[0]["w"]),
                               np.asarray(state.velocity[0]["w"]), rtol=1e-6)


@pytest.fixture(scope="module")
def fixture_cfg(reference_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("mlp")
    return TrainConfig(
        fea_file=str(reference_dir / "tools_pfile/train_noisy.pfile"),
        targ_file=str(reference_dir / "tools_pfile/train_clean.pfile"),
        norm_file=str(reference_dir / "tools_pfile/train_noisy.norm"),
        out_dir=str(out),
        layersizes=(1799, 128, 128, 257),
        epochs=2,
        ml_flag=True,
        shapefactor=1.0,
        init_seed=123,
    )


def test_two_epoch_training_improves_cv(fixture_cfg):
    import os
    last = run_training(fixture_cfg, log=lambda s: None)
    assert os.path.basename(last) == "mlp.2.wts"
    import re
    logs = {}
    for e in (1, 2):
        text = open(os.path.join(fixture_cfg.out_dir, f"mlp.{e}.log")).read()
        logs[e] = float(re.search(r"CV squared error: ([\d.e+-]+)", text).group(1))
    # Training reduces CV squared error epoch over epoch.
    assert logs[2] < logs[1]


def test_resume_by_existence(fixture_cfg):
    seen = []
    run_training(fixture_cfg, log=seen.append)
    epoch_lines = [s for s in seen if s.startswith("epoch")]
    assert len(epoch_lines) == fixture_cfg.epochs
    assert all("skipping (resume)" in s for s in epoch_lines)


def test_evaluate_cv_numbers_are_finite(fixture_cfg, reference_dir):
    from tpu_se.data import PfilePairDataset
    last = load_checkpoint(fixture_cfg.out_dir + "/mlp.2.wts")
    cv = PfilePairDataset(fixture_cfg.fea_file, fixture_cfg.targ_file,
                          fixture_cfg.norm_file, (8, 9))
    m = evaluate_cv(last, cv, fixture_cfg.hyper())
    assert m["cv_frames"] == (190 - 6) + (204 - 6)
    assert np.isfinite(m["cv_squared_error"])
    assert np.isfinite(m["cv_ggd_loglik"])
    # Mean per-frame-per-dim squared error of a trained model on z-scored
    # data should be well below the unit-variance baseline.
    assert m["cv_squared_error"] / (m["cv_frames"] * 257) < 1.0


def test_device_resident_matches_streaming(reference_dir):
    """Device-resident epochs must be numerically identical to streaming."""
    from tpu_se.data import PfilePairDataset
    from tpu_se.models import init_params
    from tpu_se.train import load_device_frames, train_one_epoch

    ds = PfilePairDataset(
        reference_dir / "tools_pfile/train_noisy.pfile",
        reference_dir / "tools_pfile/train_clean.pfile",
        reference_dir / "tools_pfile/train_noisy.norm", (0, 7))
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=128, context=7,
                       targ_offset=3)
    layersizes = (1799, 32, 257)

    params = init_params(0, layersizes)
    snap = [{k: np.asarray(v).copy() for k, v in l.items()} for l in params]
    s1 = train_one_epoch(make_train_state(params, 257), ds, hyper, 0.1,
                         np.random.default_rng(42), log=lambda s: None)

    params2 = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
               for l in snap]
    frames = load_device_frames(ds)
    s2 = train_one_epoch(make_train_state(params2, 257), ds, hyper, 0.1,
                         np.random.default_rng(42), device_frames=frames,
                         log=lambda s: None)
    np.testing.assert_allclose(np.asarray(s2.params[0]["w"]),
                               np.asarray(s1.params[0]["w"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(s2.alpha), np.asarray(s1.alpha),
                               rtol=1e-5)


def test_evaluate_cv_device_resident_matches(reference_dir):
    from tpu_se.data import PfilePairDataset
    from tpu_se.models import init_params
    from tpu_se.train import evaluate_cv, load_device_frames

    cv = PfilePairDataset(
        reference_dir / "tools_pfile/train_noisy.pfile",
        reference_dir / "tools_pfile/train_clean.pfile",
        reference_dir / "tools_pfile/train_noisy.norm", (8, 9))
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=128, context=7,
                       targ_offset=3)
    state = make_train_state(init_params(1, (1799, 32, 257)), 257)
    m_stream = evaluate_cv(state, cv, hyper)
    m_res = evaluate_cv(state, cv, hyper,
                        device_frames=load_device_frames(cv))
    assert m_res["cv_frames"] == m_stream["cv_frames"]
    assert m_res["cv_squared_error"] == pytest.approx(
        m_stream["cv_squared_error"], rel=1e-5)
    assert m_res["cv_ggd_loglik"] == pytest.approx(
        m_stream["cv_ggd_loglik"], rel=1e-5)


def test_midepoch_checkpoint_resume_bit_exact(reference_dir, tmp_path):
    """A run killed mid-epoch and resumed from its partial checkpoint
    produces byte-identical weights to an uninterrupted run."""
    import os

    def cfg(out):
        return TrainConfig(
            fea_file=str(reference_dir / "tools_pfile/train_noisy.pfile"),
            targ_file=str(reference_dir / "tools_pfile/train_clean.pfile"),
            norm_file=str(reference_dir / "tools_pfile/train_noisy.norm"),
            out_dir=str(out), layersizes=(1799, 32, 257), epochs=1,
            traincache=256, bunchsize=32, init_seed=5,
            checkpoint_every_chunks=1, device_resident="never")

    # Uninterrupted run.
    a = cfg(tmp_path / "a")
    run_training(a, log=lambda s: None)
    want = open(os.path.join(a.out_dir, "mlp.1.wts"), "rb").read()

    # Interrupted run: crash on the 3rd train_chunk dispatch.
    import tpu_se.train.loop as loop_mod
    b = cfg(tmp_path / "b")
    orig = loop_mod.train_chunk
    n = {"chunks": 0}

    def bomb(*a, **k):
        n["chunks"] += 1
        if n["chunks"] == 3:
            raise KeyboardInterrupt("simulated crash")
        return orig(*a, **k)

    loop_mod.train_chunk = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            run_training(b, log=lambda s: None)
    finally:
        loop_mod.train_chunk = orig
    meta = os.path.join(b.out_dir, "mlp.1.partial.wts.meta.json")
    assert os.path.exists(meta)

    seen = []
    run_training(b, log=seen.append)
    assert any("resuming mid-epoch" in s for s in seen)
    got = open(os.path.join(b.out_dir, "mlp.1.wts"), "rb").read()
    assert got == want
    # Partial files are cleaned up after the epoch completes.
    assert not os.path.exists(meta)


def test_midepoch_resume_device_resident(reference_dir, tmp_path):
    """Same bit-exactness through the HBM-resident fast path."""
    import os

    def cfg(out):
        return TrainConfig(
            fea_file=str(reference_dir / "tools_pfile/train_noisy.pfile"),
            targ_file=str(reference_dir / "tools_pfile/train_clean.pfile"),
            norm_file=str(reference_dir / "tools_pfile/train_noisy.norm"),
            out_dir=str(out), layersizes=(1799, 32, 257), epochs=1,
            traincache=256, bunchsize=32, init_seed=6,
            checkpoint_every_chunks=2, device_resident="always")

    a = cfg(tmp_path / "a")
    run_training(a, log=lambda s: None)
    want = open(os.path.join(a.out_dir, "mlp.1.wts"), "rb").read()

    import tpu_se.train.loop as loop_mod
    b = cfg(tmp_path / "b")
    orig = loop_mod.train_chunk
    n = {"chunks": 0}

    def bomb(*a, **k):
        n["chunks"] += 1
        if n["chunks"] == 4:
            raise KeyboardInterrupt("simulated crash")
        return orig(*a, **k)

    loop_mod.train_chunk = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            run_training(b, log=lambda s: None)
    finally:
        loop_mod.train_chunk = orig
    run_training(b, log=lambda s: None)
    got = open(os.path.join(b.out_dir, "mlp.1.wts"), "rb").read()
    assert got == want


def test_inmemory_epoch_carry_matches_disk_resume(reference_dir, tmp_path):
    """Continuous runs carry state in-memory between epochs; that must be
    bit-identical to the disk-reload resume path (the fp32 .wts round-trip
    is exact), and epoch-end sidecars are skipped unless carry_velocity."""
    import os

    def cfg(out, epochs, carry=False):
        return TrainConfig(
            fea_file=str(reference_dir / "tools_pfile/train_noisy.pfile"),
            targ_file=str(reference_dir / "tools_pfile/train_clean.pfile"),
            norm_file=str(reference_dir / "tools_pfile/train_noisy.norm"),
            out_dir=str(out), layersizes=(1799, 32, 257), epochs=epochs,
            ml_flag=True, shapefactor=1.0, init_seed=7,
            carry_velocity=carry)

    a = tmp_path / "cont"
    run_training(cfg(a, 2), log=lambda s: None)      # continuous (in-memory)
    b = tmp_path / "resumed"
    run_training(cfg(b, 1), log=lambda s: None)      # epoch 1 only
    run_training(cfg(b, 2), log=lambda s: None)      # resume -> disk reload
    wa = (a / "mlp.2.wts").read_bytes()
    wb = (b / "mlp.2.wts").read_bytes()
    assert wa == wb
    # Parity schedule (velocity reset per epoch): no epoch-end sidecar.
    assert not os.path.exists(str(a / "mlp.2.wts.state.npz"))
    # carry_velocity=True keeps the full-state sidecar for exact resume.
    c = tmp_path / "carry"
    run_training(cfg(c, 1, carry=True), log=lambda s: None)
    assert os.path.exists(str(c / "mlp.1.wts.state.npz"))


def test_midepoch_resume_legacy_unstamped_partial(reference_dir, tmp_path):
    """A partial checkpoint written by the pre-round-5 format (single
    mutable mlp.N.partial.wts) must still resume after upgrade; a meta
    whose checkpoint file is missing entirely restarts the epoch instead
    of crashing."""
    import os

    def cfg(out):
        return TrainConfig(
            fea_file=str(reference_dir / "tools_pfile/train_noisy.pfile"),
            targ_file=str(reference_dir / "tools_pfile/train_clean.pfile"),
            norm_file=str(reference_dir / "tools_pfile/train_noisy.norm"),
            out_dir=str(out), layersizes=(1799, 32, 257), epochs=1,
            traincache=256, bunchsize=32, init_seed=5,
            checkpoint_every_chunks=1, device_resident="never")

    a = cfg(tmp_path / "a")
    run_training(a, log=lambda s: None)
    want = open(os.path.join(a.out_dir, "mlp.1.wts"), "rb").read()

    import tpu_se.train.loop as loop_mod
    b = cfg(tmp_path / "b")
    orig = loop_mod.train_chunk
    n = {"chunks": 0}

    def bomb(*args, **k):
        n["chunks"] += 1
        if n["chunks"] == 3:
            raise KeyboardInterrupt("simulated crash")
        return orig(*args, **k)

    loop_mod.train_chunk = bomb
    try:
        with pytest.raises(KeyboardInterrupt):
            run_training(b, log=lambda s: None)
    finally:
        loop_mod.train_chunk = orig

    # Downgrade the stamped partial to the legacy unstamped layout.
    stem = os.path.join(b.out_dir, "mlp.1.partial")
    import glob as g
    stamped = [p for p in g.glob(stem + ".*.wts") if ".wts" in p]
    assert stamped, os.listdir(b.out_dir)
    os.replace(stamped[0], stem + ".wts")
    side = stamped[0] + ".state.npz"
    if os.path.exists(side):
        os.replace(side, stem + ".wts.state.npz")

    seen = []
    run_training(b, log=seen.append)
    assert any("resuming mid-epoch" in s for s in seen), seen
    got = open(os.path.join(b.out_dir, "mlp.1.wts"), "rb").read()
    assert got == want

    # Meta present but NO checkpoint file at all: restart, don't crash.
    c = cfg(tmp_path / "c")
    os.makedirs(c.out_dir, exist_ok=True)
    import json
    with open(os.path.join(c.out_dir, "mlp.1.partial.wts.meta.json"),
              "w") as f:
        json.dump({"epoch": 1, "chunks_done": 2}, f)
    seen = []
    run_training(c, log=seen.append)
    assert any("restarting epoch" in s for s in seen), seen
    got = open(os.path.join(c.out_dir, "mlp.1.wts"), "rb").read()
    assert got == want

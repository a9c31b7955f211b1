"""True multi-process data-parallel test (SURVEY.md §2.4).

The in-process mesh tests (tests/test_parallel.py) validate the GSPMD
shardings on 8 virtual devices; this test validates the *multi-host
runtime glue* — ``initialize_distributed`` + cross-process collectives —
by spawning 2 real processes (2 virtual CPU devices each, gloo backend)
that run one sharded ``train_chunk`` over the global 4-device mesh, and
asserting the result matches a single-process run on an identical mesh.
On GPUs the same code path reduces over NCCL instead of gloo.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tpu_se.reference import seeded_pfiles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_dp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
        "PYTHONPATH": REPO,
    })
    return env


def test_two_process_full_training_matches_single_process(tmp_path):
    """The FULL driver (`tpu_se train` CLI -> run_training: epochs, resume
    barrier, per-host sharded input read, CV) over a 2-process gloo cluster
    must produce the same weights as a single-process run on an identical
    4-device mesh."""
    port = _free_port()
    out_dir = tmp_path / "mp_train"
    noisy, clean, norm = seeded_pfiles(str(tmp_path), 0, n_sents=10)
    common = [
        sys.executable, "-m", "tpu_se", "train",
        "--fea-file", noisy, "--targ-file", clean, "--norm-file", norm,
        "--layersizes", "1799,64,257", "--epochs", "2",
        "--out-dir", str(out_dir),
    ]
    env = _worker_env()
    procs = [
        subprocess.Popen(
            common + ["--coordinator", f"127.0.0.1:{port}",
                      "--num-processes", "2", "--process-id", str(pid),
                      "--cpu-collectives", "gloo"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO)
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process training timed out")
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert (out_dir / "mlp.2.wts").exists(), "\n".join(logs)
    assert "multi-host mesh: data=4" in logs[0], logs[0]

    # Single-process reference: same config on an in-process 4-device mesh.
    import jax

    from tpu_se.io.wts import read_wts
    from tpu_se.parallel import make_mesh
    from tpu_se.train import TrainConfig, run_training

    cfg = TrainConfig(
        fea_file=noisy, targ_file=clean, norm_file=norm,
        layersizes=(1799, 64, 257), epochs=2,
        out_dir=str(tmp_path / "sp_train"),
        mesh=make_mesh(data=4, model=1, devices=jax.devices()[:4]))
    final = run_training(cfg, log=lambda s: None)

    got = read_wts(out_dir / "mlp.2.wts")
    want = read_wts(final)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["w"], w["w"], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(g["b"], w["b"], rtol=2e-5, atol=1e-6)


CRASH_WORKER = os.path.join(REPO, "tests", "mp_crash_worker.py")


def _run_cluster(args, env, timeout=300):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, CRASH_WORKER, "train", *args,
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(pid),
             "--cpu-collectives", "gloo"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO)
        for pid in (0, 1)
    ]
    logs, codes = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process run timed out")
        logs.append(out)
        codes.append(p.returncode)
    return codes, logs


def test_two_process_midepoch_kill_resume_bit_exact(tmp_path):
    """2-process gloo run with chunk-granular checkpointing,
    both processes hard-killed (os._exit) mid-epoch, restarted — final
    weights must be byte-identical to an uninterrupted 2-process run.

    This exercises the multi-host side of mid-epoch resume: non-main
    process 1 restores from the partial checkpoint that main wrote to
    shared storage, and the chunk-stamped atomic meta commit guarantees
    the (weights, velocity, alpha, position) set it reads is consistent
    no matter where the kill landed."""
    noisy, clean, norm = seeded_pfiles(str(tmp_path), 0, n_sents=10)
    env = _worker_env()

    def args(out_dir):
        return ["--fea-file", noisy, "--targ-file", clean,
                "--norm-file", norm,
                "--layersizes", "1799,32,257", "--epochs", "1",
                "--traincache", "256", "--bunchsize", "32",
                "--seed", "11", "--checkpoint-every-chunks", "1",
                "--out-dir", str(out_dir)]

    # Uninterrupted 2-process run.
    codes, logs = _run_cluster(args(tmp_path / "a"), env)
    assert codes == [0, 0], "\n".join(logs)
    want = (tmp_path / "a" / "mlp.1.wts").read_bytes()

    # Killed run: both processes os._exit(7) on their 4th chunk dispatch
    # (chunks 1-3 complete, partial checkpoint committed at chunk 3).
    env_crash = dict(env, TPU_SE_CRASH_AFTER_CHUNKS="3")
    codes, logs = _run_cluster(args(tmp_path / "b"), env_crash)
    assert codes == [7, 7], (codes, "\n".join(logs))
    assert (tmp_path / "b" / "mlp.1.partial.wts.meta.json").exists(), \
        "\n".join(logs)
    assert not (tmp_path / "b" / "mlp.1.wts").exists()

    # Restart: resumes at chunk 3 and completes.
    codes, logs = _run_cluster(args(tmp_path / "b"), env)
    assert codes == [0, 0], "\n".join(logs)
    assert "resuming mid-epoch at chunk 3" in logs[0], logs[0]
    got = (tmp_path / "b" / "mlp.1.wts").read_bytes()
    assert got == want
    # Partials cleaned up after the epoch completed.
    assert not (tmp_path / "b" / "mlp.1.partial.wts.meta.json").exists()


def test_two_process_dp_matches_single_process(tmp_path):
    port = _free_port()
    out_npz = tmp_path / "mp_params.npz"
    env = _worker_env()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), str(out_npz)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in (0, 1)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        logs.append(out)
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert out_npz.exists(), "\n".join(logs)
    got = np.load(out_npz)

    # Single-process reference on an identical 4-device mesh (the pytest
    # session has 8 virtual devices; use the first 4).
    import jax

    from tests.mp_dp_worker import run_step
    from tpu_se.parallel import make_mesh

    mesh = make_mesh(data=4, model=1, devices=jax.devices()[:4])
    ref = run_step(mesh)
    for i, layer in enumerate(ref.params):
        np.testing.assert_allclose(got[f"w{i}"], np.asarray(layer["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[f"b{i}"], np.asarray(layer["b"]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["alpha"], np.asarray(ref.alpha),
                               rtol=1e-6, atol=1e-7)

"""Run the UNMODIFIED reference ``finetune.pl`` driver against tpu_se.

The reference's training driver is a Perl script that invokes one
``BPtrain_Sigmoid key=value ...`` process per epoch and implements
resume-by-existence (skip the epoch if its output ``.wts`` exists,
``/root/reference/Train_code_ML_GGD/finetune.pl:49,88,126``).  The
``tpu_se bptrain`` shim was built to be a drop-in for that binary; this
tool proves it by executing the ACTUAL Perl script:

1. copies ``finetune.pl`` from the read-only reference tree at runtime
   (nothing reference-derived is committed to this repo);
2. patches ONLY the variables the script itself exposes for
   configuration — ``$exe`` (the binary name, the one swap the shim is
   designed for), ``$ROOT_DIR`` (data location), and the final loop
   bound (epoch count, 50 -> 12 so the run spans the lr-decay boundary
   at epoch 11 quickly); every other line byte-identical, asserted;
3. generates the missing init weights (the reference's
   ``Rand_1799_3hid2048_257_beta2.wts`` was stripped from the repo,
   ``.MISSING_LARGE_BLOBS``) with ``tpu_se gen-rand-net`` at the exact
   relative path the script expects;
4. runs the script, KILLS it mid-run (after epoch 4's weights appear),
   re-runs it, and asserts resume-by-existence: the pre-kill epochs are
   not retrained (file mtimes unchanged) and the chain completes through
   epoch 12 with the lr trace 0.1 (x10) then 0.09, 0.081;
5. checks every epoch log for the reference CV metric lines and a
   decreasing CV squared error.

Artifacts (lr trace, per-epoch CV metrics, resume evidence) land in
``artifacts/finetune_pl/``.

The epoch processes run one at a time (the Perl driver is sequential) on
whatever device JAX finds; set ``JAX_PLATFORMS=cpu`` for a hermetic run.

Usage: python tools/run_reference_finetune.py [--workdir DIR] [--full]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

REF_SCRIPT = "/root/reference/Train_code_ML_GGD/finetune.pl"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The allowed patches: exact original line -> replacement.  The loop-bound
# patch (epochs 50 -> 12) is dropped in --full mode, where the script runs
# its complete 50-process schedule byte-identical except $exe/$ROOT_DIR.
PATCHES_BASE = {
    'my $ROOT_DIR = "..";':
        'my $ROOT_DIR = "/root/reference";',
    '\tmy $exe \t\t\t\t\t\t= "./BPtrain_Sigmoid";':
        '\tmy $exe \t\t\t\t\t\t= "python -m tpu_se bptrain";',
}
PATCH_EPOCHS = {
    '\tfor($i= 11;$i <= 50;$i++){':
        '\tfor($i= 11;$i <= 12;$i++){',
}


def patched_script(patches: dict) -> str:
    with open(REF_SCRIPT) as f:
        lines = f.read().split("\n")
    n_patched = 0
    out = []
    for line in lines:
        if line in patches:
            out.append(patches[line])
            n_patched += 1
        else:
            out.append(line)
    assert n_patched == len(patches), \
        f"expected {len(patches)} patched lines, matched {n_patched} " \
        "(reference script text changed?)"
    return "\n".join(out)


def run_perl(workdir: str, env: dict, log_path: str,
             kill_after_wts: str | None = None, timeout: float = 1800.0):
    """Run the script; if kill_after_wts is given, SIGKILL the whole
    process group as soon as that file exists (simulates a crash)."""
    # Scale with the epoch count: the resume leg runs up to epochs-4
    # sequential trainer processes in ONE perl process.
    timeout = max(timeout, 300.0 * _EPOCHS)
    with open(log_path, "a") as log:
        proc = subprocess.Popen(
            ["perl", "finetune.pl"], cwd=workdir, env=env,
            stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        t0 = time.time()
        try:
            while proc.poll() is None:
                if time.time() - t0 > timeout:
                    os.killpg(proc.pid, signal.SIGKILL)
                    raise TimeoutError("finetune.pl exceeded timeout")
                if kill_after_wts and os.path.exists(kill_after_wts):
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                    return "killed"
                time.sleep(0.25)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
        return proc.returncode


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--epochs", type=int, default=12,
                    help="must match the patched loop bound")
    ap.add_argument("--full", action="store_true",
                    help="run the UNPATCHED 50-epoch loop (only $exe and "
                         "$ROOT_DIR substituted); implies --epochs 50")
    args = ap.parse_args()
    global _ART_SUFFIX, _EPOCHS
    if args.full:
        args.epochs = 50
    _EPOCHS = args.epochs
    _ART_SUFFIX = "_full" if args.full else ""
    patches = PATCHES_BASE if args.full else {**PATCHES_BASE,
                                              **PATCH_EPOCHS}

    workdir = args.workdir or tempfile.mkdtemp(prefix="finetune_pl_")
    os.makedirs(workdir, exist_ok=True)
    script = patched_script(patches)
    with open(os.path.join(workdir, "finetune.pl"), "w") as f:
        f.write(script)

    # The init weights the script references (relative to its cwd).
    pw = os.path.join(workdir, "pretraining_weights")
    os.makedirs(pw, exist_ok=True)
    init_wts = os.path.join(pw, "Rand_1799_3hid2048_257_beta2.wts")
    subprocess.run(
        [sys.executable, "-m", "tpu_se", "gen-rand-net",
         "--layersizes", "1799,2048,2048,2048,257", "--seed", "19",
         "-o", init_wts],
        check=True, env=_env(), cwd=REPO)

    art_dir = os.path.join(REPO, "artifacts", "finetune_pl")
    os.makedirs(art_dir, exist_ok=True)
    drv_log = os.path.join(art_dir, f"driver{_ART_SUFFIX}.log")
    if os.path.exists(drv_log):
        os.remove(drv_log)

    mlp = os.path.join(workdir, "MLGGD1")
    print(f"workdir {workdir}; first run (kill after epoch 4)...")
    status = run_perl(workdir, _env(), drv_log,
                      kill_after_wts=os.path.join(mlp, "mlp.4.wts"))
    done_before = sorted(f for f in os.listdir(mlp) if f.endswith(".wts"))
    mtimes = {f: os.path.getmtime(os.path.join(mlp, f))
              for f in done_before}
    print(f"first run: {status}; epochs on disk: {len(done_before)}")
    assert status == "killed" and len(done_before) >= 4

    with open(drv_log, "a") as f:
        f.write(f"\n--- killed mid-run with {len(done_before)} epochs on "
                "disk; re-running (resume-by-existence) ---\n\n")
    print("second run (resume)...")
    status = run_perl(workdir, _env(), drv_log)
    assert status == 0, f"resume run failed: {status}"

    # Resume evidence: pre-kill epochs untouched, chain completed.
    for f_name, old_mtime in mtimes.items():
        new = os.path.getmtime(os.path.join(mlp, f_name))
        assert new == old_mtime, f"{f_name} was retrained on resume"
    final = [f"mlp.{i}.wts" for i in range(1, args.epochs + 1)]
    for f_name in final:
        assert os.path.exists(os.path.join(mlp, f_name)), f_name

    # lr trace from the driver's own prints: 0.1 x10, then *0.9.
    with open(drv_log) as f:
        text = f.read()
    lrs = [float(line.rsplit(" ", 1)[1])
           for line in text.splitlines() if line.startswith("iter ")]
    # The resume run re-prints iters 1..N; take the last args.epochs.
    lrs = lrs[-args.epochs:]
    assert all(abs(v - 0.1) < 1e-12 for v in lrs[:10]), lrs
    for k in range(10, args.epochs):
        assert abs(lrs[k] - 0.1 * 0.9 ** (k - 9)) < 1e-9, (k, lrs[k])

    # Per-epoch CV from the shim's reference-format logs.  The epoch that
    # was mid-flight at the kill has its .wts (atomic write) but may have
    # died before its log — on resume it is skipped (wts exists), so that
    # one log is legitimately absent, exactly as with the reference binary.
    epochs = []
    for i in range(1, args.epochs + 1):
        log_path = os.path.join(mlp, f"mlp.{i}.log")
        row = {"epoch": i, "lr": lrs[i - 1],
               "resumed_from_disk": f"mlp.{i}.wts" in mtimes}
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
            row["cv_squared"] = float(
                log.split("CV over. squared error:")[1].split()[0])
            row["cv_abs"] = float(
                log.split("square root squared error:")[1].split()[0])
            row["cv_ggd_loglik"] = float(
                log.split("CV log likelihood:")[1].split()[0])
        else:
            assert row["resumed_from_disk"], \
                f"missing log for epoch {i} that was not pre-kill"
            row["log_lost_to_kill"] = True
        epochs.append(row)
    with_cv = [e for e in epochs if "cv_squared" in e]
    assert with_cv[-1]["cv_squared"] < with_cv[0]["cv_squared"]

    summary = {
        "script": REF_SCRIPT,
        "jax_platforms": os.environ.get("JAX_PLATFORMS", ""),
        "patched_lines": sorted(patches),
        "epochs_run": args.epochs,
        "killed_after_epochs": len(done_before),
        "resume_verified_mtimes_unchanged": sorted(mtimes),
        "epochs": epochs,
    }
    out = os.path.join(art_dir, f"finetune_pl_run{_ART_SUFFIX}.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"summary -> {out}")
    for e in epochs:
        cv = (f"cv_sq={e['cv_squared']:.4f}" if "cv_squared" in e
              else "cv log lost to kill")
        print(f"  epoch {e['epoch']:2d} lr={e['lr']:.4g} {cv} "
              f"{'(pre-kill)' if e['resumed_from_disk'] else ''}")
    return 0


_ART_SUFFIX = ""
_EPOCHS = 12


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


if __name__ == "__main__":
    sys.exit(main())

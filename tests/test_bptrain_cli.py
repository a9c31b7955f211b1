"""`tpu_se bptrain key=value ...` — the BPtrain_Sigmoid drop-in shim.

A finetune.pl-style driver must work by swapping only the binary name:
the tests below feed the shim the reference's exact argument strings
(``finetune.pl:50-76``) against the bundled 10-sentence pfile shard.
"""

import os

import numpy as np
import pytest


def _finetune_pl_args(d, ref, layersizes="1799,2048,2048,2048,257",
                      initwts="", seed=27870775, lrate=0.1,
                      extra=()):
    """The exact key=value strings finetune.pl:50-76 assembles (iteration
    1), one list element per `" key=value"` fragment, same order."""
    numlayers = len(layersizes.split(",")) - 1
    return [
        f"gpu_used=0",
        f"numlayers={numlayers}",            # silently ignored, like the ref
        f"layersizes={layersizes}",
        f"bunchsize=128",
        f"MLflag=1",
        f"shapefactor=1",
        f"momentum=0.9",
        f"weightcost=0.00001",
        f"lrate={lrate}",
        f"fea_dim=257",
        f"fea_context=7",
        f"traincache=102400",
        f"init_randem_seed={seed}",
        f"targ_offset=3",
        f"initwts_file={initwts}",
        f"norm_file={ref}/tools_pfile/train_noisy.norm",
        f"fea_file={ref}/tools_pfile/train_noisy.pfile",
        f"targ_file={ref}/tools_pfile/train_clean.pfile",
        f"outwts_file={d}/mlp.1.wts",
        f"log_file={d}/mlp.1.log",
        f"train_sent_range=0-7",
        f"cv_sent_range=8-9",
        f"dropoutflag=0",
        f"visible_omit=0.1",
        f"hid_omit=0.1",
    ] + list(extra)


def test_bptrain_exact_finetune_strings(reference_dir, tmp_path):
    """The verbatim finetune.pl iteration-1 command (full 1799-2048^3-257
    topology) runs one epoch and writes outwts_file + log_file with the
    reference's CV metric lines (``BPtrain.cc:131-139``)."""
    from tpu_se.cli.main import main
    from tpu_se.io import read_wts
    from tpu_se.models import init_params, params_to_wts
    from tpu_se.io.wts import write_wts

    init = str(tmp_path / "Rand_1799_3hid2048_257_beta2.wts")
    write_wts(init, params_to_wts(init_params(1, (1799, 2048, 2048,
                                                  2048, 257))))
    rc = main(["bptrain"] + _finetune_pl_args(
        tmp_path, reference_dir, initwts=init))
    assert rc == 0
    out = read_wts(str(tmp_path / "mlp.1.wts"))
    assert [layer["w"].shape for layer in out] == [
        (1799, 2048), (2048, 2048), (2048, 2048), (2048, 257)]
    log = (tmp_path / "mlp.1.log").read_text()
    assert "CV over. squared error:" in log
    assert "CV over. square root squared error:" in log
    assert "CV2 over. CV log likelihood:" in log
    assert "Total cost time:" in log
    # metrics in the log are finite numbers
    sq = float(log.split("CV over. squared error:")[1].split()[0])
    assert np.isfinite(sq)


def test_bptrain_matches_train_command_epoch1(reference_dir, tmp_path):
    """bptrain (one reference-binary epoch) is bit-identical to epoch 1 of
    the multi-epoch `train` command given the same init/seed/config."""
    from tpu_se.cli.main import main
    from tpu_se.io import read_wts
    from tpu_se.models import init_params, params_to_wts
    from tpu_se.io.wts import write_wts

    sizes = "1799,64,64,257"
    init = str(tmp_path / "init.wts")
    write_wts(init, params_to_wts(init_params(3, (1799, 64, 64, 257))))

    rc = main(["bptrain"] + _finetune_pl_args(
        tmp_path, reference_dir, layersizes=sizes, initwts=init, seed=777))
    assert rc == 0

    out_dir = str(tmp_path / "train_cmd")
    rc = main(["train",
               "--fea-file", f"{reference_dir}/tools_pfile/train_noisy.pfile",
               "--targ-file", f"{reference_dir}/tools_pfile/train_clean.pfile",
               "--norm-file", f"{reference_dir}/tools_pfile/train_noisy.norm",
               "--init-wts", init, "--out-dir", out_dir,
               "--layersizes", sizes, "--epochs", "1", "--seed", "777"])
    assert rc == 0

    a = read_wts(str(tmp_path / "mlp.1.wts"))
    b = read_wts(os.path.join(out_dir, "mlp.1.wts"))
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        np.testing.assert_array_equal(la["w"], lb["w"])
        np.testing.assert_array_equal(la["b"], lb["b"])


def test_bptrain_chained_two_epochs_matches_train(reference_dir, tmp_path):
    """A finetune.pl-style CHAIN (bptrain epoch 2 initialized from epoch
    1's outwts_file) is bit-identical to `train --epochs 2`.

    Guards the per-epoch momentum reset: the reference binary's .wts
    carries weights only (Interface.cc:429-468) and every epoch process
    starts with zeroed delta buffers (BP_GPU.cu:60-78).  If bptrain wrote
    a velocity sidecar beside outwts_file (or restored one), epoch 2
    would silently carry momentum and diverge from the `train` command
    from the first bunch of epoch 2.
    """
    from tpu_se.cli.main import main
    from tpu_se.io import read_wts
    from tpu_se.models import init_params, params_to_wts
    from tpu_se.io.wts import write_wts

    sizes = "1799,64,64,257"
    init = str(tmp_path / "init.wts")
    write_wts(init, params_to_wts(init_params(3, (1799, 64, 64, 257))))

    # Epoch 1: seed 777.  Epoch 2: initwts = epoch 1 output, seed 777+345
    # (finetune.pl:86,124), lr unchanged (constant through epoch 10).
    rc = main(["bptrain"] + _finetune_pl_args(
        tmp_path, reference_dir, layersizes=sizes, initwts=init, seed=777))
    assert rc == 0
    assert not os.path.exists(str(tmp_path / "mlp.1.wts.state.npz")), \
        "bptrain must not write a velocity sidecar (reference binary parity)"
    args2 = [a for a in _finetune_pl_args(
        tmp_path, reference_dir, layersizes=sizes,
        initwts=str(tmp_path / "mlp.1.wts"), seed=777 + 345)
        if not (a.startswith("outwts_file=") or a.startswith("log_file="))]
    args2 += [f"outwts_file={tmp_path}/mlp.2.wts",
              f"log_file={tmp_path}/mlp.2.log"]
    rc = main(["bptrain"] + args2)
    assert rc == 0

    out_dir = str(tmp_path / "train_cmd")
    rc = main(["train",
               "--fea-file", f"{reference_dir}/tools_pfile/train_noisy.pfile",
               "--targ-file", f"{reference_dir}/tools_pfile/train_clean.pfile",
               "--norm-file", f"{reference_dir}/tools_pfile/train_noisy.norm",
               "--init-wts", init, "--out-dir", out_dir,
               "--layersizes", sizes, "--epochs", "2", "--seed", "777"])
    assert rc == 0

    for epoch in (1, 2):
        a = read_wts(str(tmp_path / f"mlp.{epoch}.wts"))
        b = read_wts(os.path.join(out_dir, f"mlp.{epoch}.wts"))
        for la, lb in zip(a, b):
            np.testing.assert_array_equal(la["w"], lb["w"])
            np.testing.assert_array_equal(la["b"], lb["b"])


def test_bptrain_format_error_and_unknown_keys(reference_dir, tmp_path):
    """An arg without '=' is a format error (Interface.cc:153-157); an
    unknown key WITH '=' is silently ignored (how numlayers= passes)."""
    from tpu_se.cli.bptrain import parse_kv

    with pytest.raises(SystemExit, match="Format Error"):
        parse_kv(["bunchsize"])
    cfg = parse_kv(["numlayers=4", "some_future_key=zzz", "bunchsize=64"])
    assert cfg["bunchsize"] == 64
    assert "numlayers" not in cfg


def test_bptrain_extension_keys_parse(reference_dir, tmp_path):
    """tpu_se extension keys ride the same key=value surface: the
    device-resident threshold override and mesh knobs parse
    as ints; 0 means 'use the TrainConfig default constant'."""
    from tpu_se.cli.bptrain import parse_kv
    from tpu_se.train.loop import TrainConfig

    cfg = parse_kv(["device_resident_max_bytes=1073741824", "mesh_data=2"])
    assert cfg["device_resident_max_bytes"] == 1 << 30
    assert cfg["mesh_data"] == 2
    assert parse_kv([])["device_resident_max_bytes"] == 0
    assert TrainConfig.device_resident_max_bytes == 4 << 30


def test_wts_write_is_atomic_no_tmp_left(tmp_path):
    """write_wts goes through tmp+rename (crash safety for
    resume-by-existence); on success no .tmp sibling remains and the
    file round-trips."""
    import os

    from tpu_se.io import read_wts
    from tpu_se.io.wts import write_wts
    from tpu_se.models import init_params, params_to_wts

    path = str(tmp_path / "w.wts")
    write_wts(path, params_to_wts(init_params(1, (8, 4, 8))))
    assert os.path.exists(path)
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []
    assert len(read_wts(path)) == 2


def test_bptrain_random_init_path(reference_dir, tmp_path):
    """No initwts_file -> random init from the init_randem_* uniform
    ranges (Interface.cc:140-143), seeded by init_randem_seed."""
    from tpu_se.cli.main import main
    from tpu_se.io import read_wts

    args = [a for a in _finetune_pl_args(
        tmp_path, reference_dir, layersizes="1799,32,257", seed=11)
        if not a.startswith("initwts_file=")]
    args += ["init_randem_weight_min=-0.05", "init_randem_weight_max=0.05",
             "init_randem_bias_min=0", "init_randem_bias_max=0"]
    rc = main(["bptrain"] + args)
    assert rc == 0
    out = read_wts(str(tmp_path / "mlp.1.wts"))
    assert [layer["w"].shape for layer in out] == [(1799, 32), (32, 257)]
    assert all(np.isfinite(layer["w"]).all() for layer in out)

"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpu_se.models import forward, init_params
from tpu_se.parallel import (
    make_mesh, param_shardings, shard_train_args,
)
from tpu_se.train import TrainHyper, make_train_state, train_chunk


@pytest.fixture(scope="module")
def devices8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("need 8 virtual devices")
    return devs


def _problem(seed=0, dim=8, ctx=3, m=16, n_bunches=4, n_frames=128):
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(n_frames, dim)).astype(np.float32)
    clean = rng.normal(size=(n_frames, dim)).astype(np.float32)
    starts = rng.integers(0, n_frames - ctx,
                          size=(n_bunches, m)).astype(np.int32)
    layersizes = (dim * ctx, 16, 16, dim)
    params = init_params(seed + 1, layersizes)
    return noisy, clean, starts, params, layersizes


def _run(state, noisy, clean, starts, hyper, mesh=None):
    if mesh is not None:
        noisy, clean, starts = shard_train_args(mesh, noisy, clean, starts)
    return train_chunk(state, jnp.asarray(noisy), jnp.asarray(clean),
                       jnp.asarray(starts), jnp.float32(0.05), hyper)


@pytest.mark.parametrize("ml", [False, True])
def test_dp_sharded_matches_single_device(devices8, ml):
    """8-way DP must give the same result as 1 device: the gradient sums and
    the GGD alpha statistic are GLOBAL-batch reductions."""
    noisy, clean, starts, params, layersizes = _problem()
    hyper = TrainHyper(beta=1.0, ml=ml, bunchsize=16, context=3,
                       targ_offset=1)

    snap = [{k: np.asarray(v).copy() for k, v in l.items()} for l in params]
    single = _run(make_train_state(params, layersizes[-1]),
                  noisy, clean, starts, hyper)

    mesh = make_mesh(8, 1)
    params2 = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
               for l in snap]
    sharded = _run(make_train_state(params2, layersizes[-1]),
                   noisy, clean, starts, hyper, mesh=mesh)

    for ls, lm in zip(single.params, sharded.params):
        np.testing.assert_allclose(np.asarray(lm["w"]), np.asarray(ls["w"]),
                                   rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sharded.alpha),
                               np.asarray(single.alpha), rtol=1e-4)


def test_tp_mesh_forward_matches(devices8):
    """4x2 mesh with tensor-parallel hidden weights: same numerics."""
    mesh = make_mesh(4, 2)
    layersizes = (24, 16, 16, 8)
    params = init_params(0, layersizes)
    x = np.random.default_rng(1).normal(size=(8, 24)).astype(np.float32)
    want = np.asarray(forward(params, jnp.asarray(x)))

    specs = param_shardings(mesh, len(params))
    params_tp = [{"w": jax.device_put(l["w"], s["w"]),
                  "b": jax.device_put(l["b"], s["b"])}
                 for l, s in zip(params, specs)]
    got = np.asarray(jax.jit(forward)(params_tp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_dp_tp_train_step_matches_single_device(devices8, dp, tp):
    """Full train step on a dp x tp mesh == the unsharded step.

    TP reassociates the hidden GEMMs, which licenses a tolerance, not an
    isfinite-only check: on the CPU mesh the measured reassociation error
    is ~1e-7 relative (orders below any sign/dropped-psum bug), so the
    same rtol as the DP test holds comfortably."""
    from tpu_se.parallel import replicated_sharding

    noisy, clean, starts, params, layersizes = _problem()
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=16, context=3,
                       targ_offset=1)
    snap = [{k: np.asarray(v).copy() for k, v in l.items()} for l in params]
    single = _run(make_train_state(params, layersizes[-1]),
                  noisy, clean, starts, hyper)

    mesh = make_mesh(dp, tp)
    specs = param_shardings(mesh, len(snap))
    params2 = [{"w": jax.device_put(jnp.asarray(l["w"]), s["w"]),
                "b": jax.device_put(jnp.asarray(l["b"]), s["b"])}
               for l, s in zip(snap, specs)]
    state = make_train_state(params2, layersizes[-1])
    state.alpha = jax.device_put(state.alpha, replicated_sharding(mesh))
    out = _run(state, noisy, clean, starts, hyper, mesh=mesh)
    for ls, lm in zip(single.params, out.params):
        np.testing.assert_allclose(np.asarray(lm["w"]), np.asarray(ls["w"]),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(lm["b"]), np.asarray(ls["b"]),
                                   rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.alpha),
                               np.asarray(single.alpha), rtol=1e-4)


def test_sharded_decode_matches_single(devices8, tmp_path):
    """Mesh-sharded batch decode (frames over the data axis) produces the
    same waveform/LPS as single-device decode."""
    from tpu_se.infer import Enhancer
    from tpu_se.io import write_norm, write_wts
    from tpu_se.models import params_to_wts

    params = init_params(11, (1799, 32, 32, 257))
    wts, norm = str(tmp_path / "m.wts"), str(tmp_path / "m.norm")
    write_wts(wts, params_to_wts(params))
    rng = np.random.default_rng(2)
    write_norm(norm, rng.normal(size=257).astype(np.float32),
               (0.5 + rng.random(257)).astype(np.float32))
    noisy = (rng.normal(size=16000) * 3000).astype(np.int16)

    single = Enhancer(wts, norm)
    sharded = Enhancer(wts, norm, mesh=make_mesh(8, 1))
    w1, r1, l1 = single.enhance(noisy)
    w8, r8, l8 = sharded.enhance(noisy)
    np.testing.assert_allclose(l8, l1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r8, r1, rtol=1e-4, atol=1e-3)
    assert np.abs(w8.astype(np.int32) - w1.astype(np.int32)).max() <= 1


def test_sharded_auto_blend_decode_matches_single(devices8, tmp_path):
    """blend='auto' under a data mesh: the per-utterance suppression mean
    spans the sharded frame axis (a GSPMD reduction), so the adaptive
    lambda — and the waveform — must match single-device decode."""
    from tpu_se.infer import Enhancer
    from tpu_se.io import write_norm, write_wts
    from tpu_se.models import params_to_wts

    params = init_params(23, (1799, 32, 32, 257))
    wts, norm = str(tmp_path / "m.wts"), str(tmp_path / "m.norm")
    write_wts(wts, params_to_wts(params))
    rng = np.random.default_rng(9)
    write_norm(norm, rng.normal(size=257).astype(np.float32),
               (0.5 + rng.random(257)).astype(np.float32))
    noisy = (rng.normal(size=16000) * 3000).astype(np.int16)

    single = Enhancer(wts, norm, blend="auto")
    sharded = Enhancer(wts, norm, blend="auto", mesh=make_mesh(8, 1))
    w1, _, l1 = single.enhance(noisy)
    w8, _, l8 = sharded.enhance(noisy)
    np.testing.assert_allclose(l8, l1, rtol=1e-5, atol=1e-5)
    assert np.abs(w8.astype(np.int32) - w1.astype(np.int32)).max() <= 1


def test_sharded_batch_decode_matches_single(devices8, tmp_path):
    """enhance_batch with the batch axis sharded over the data mesh ==
    unsharded per-utterance decode."""
    from tpu_se.infer import Enhancer
    from tpu_se.io import write_norm, write_wts
    from tpu_se.models import params_to_wts

    params = init_params(13, (1799, 32, 32, 257))
    wts, norm = str(tmp_path / "m.wts"), str(tmp_path / "m.norm")
    write_wts(wts, params_to_wts(params))
    rng = np.random.default_rng(4)
    write_norm(norm, rng.normal(size=257).astype(np.float32),
               (0.5 + rng.random(257)).astype(np.float32))
    waves = [(rng.normal(size=n) * 3000).astype(np.int16)
             for n in (8000, 12000, 5000)]

    single = Enhancer(wts, norm)
    sharded = Enhancer(wts, norm, mesh=make_mesh(8, 1))
    for wave, got in zip(waves, sharded.enhance_batch(waves)):
        want = single.enhance(wave)
        assert np.abs(got[0].astype(np.int32)
                      - want[0].astype(np.int32)).max() <= 1
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


def test_graft_entry_contract(devices8):
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (128, 257)
    ge.dryrun_multichip(8)


def test_sharded_wave_fast_path_matches_single(devices8, tmp_path):
    """enhance_batch_waves with the batch axis sharded over the data mesh
    == the unsharded fast path, bitwise."""
    from tpu_se.infer import Enhancer
    from tpu_se.io import write_norm, write_wts
    from tpu_se.models import params_to_wts

    params = init_params(17, (1799, 32, 32, 257))
    wts, norm = str(tmp_path / "m.wts"), str(tmp_path / "m.norm")
    write_wts(wts, params_to_wts(params))
    rng = np.random.default_rng(5)
    write_norm(norm, rng.normal(size=257).astype(np.float32),
               (0.5 + rng.random(257)).astype(np.float32))
    waves = [(rng.normal(size=n) * 3000).astype(np.int16)
             for n in (8000, 12000, 5000)]

    single = Enhancer(wts, norm)
    sharded = Enhancer(wts, norm, mesh=make_mesh(8, 1))
    got = sharded.enhance_batch_waves(waves)
    want = single.enhance_batch_waves(waves)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sharded_streaming_matches_single(devices8, tmp_path):
    """StreamingEnhancer with the stream axis sharded over the data mesh ==
    unsharded multi-stream push_many, bitwise on the int16 wire."""
    from tpu_se.infer import StreamingEnhancer
    from tpu_se.io import write_norm, write_wts
    from tpu_se.models import params_to_wts

    params = init_params(19, (1799, 32, 32, 257))
    wts, norm = str(tmp_path / "m.wts"), str(tmp_path / "m.norm")
    write_wts(wts, params_to_wts(params))
    rng = np.random.default_rng(6)
    write_norm(norm, rng.normal(size=257).astype(np.float32),
               (0.5 + rng.random(257)).astype(np.float32))
    hops = (rng.normal(size=(8, 12, 256)) * 3000).astype(np.int16)

    single = StreamingEnhancer(wts, norm, n_streams=8)
    sharded = StreamingEnhancer(wts, norm, n_streams=8, mesh=make_mesh(8, 1))
    out_s, valid_s = single.push_many(hops, int16_wire=True)
    out_m, valid_m = sharded.push_many(hops, int16_wire=True)
    np.testing.assert_array_equal(valid_s, valid_m)
    np.testing.assert_array_equal(out_s, out_m)


@pytest.mark.parametrize("ml,activation", [(True, "sigmoid"),
                                           (False, "sigmoid"),
                                           (True, "relu")])
def test_overlap_step_unsharded_matches_train_chunk(ml, activation):
    """The hand-written per-layer-psum backward (overlap step, mesh=None)
    reproduces jax.vjp's gradients through the full chunk scan."""
    from tpu_se.parallel.overlap_step import train_chunk_overlap

    noisy, clean, starts, params, layersizes = _problem()
    hyper = TrainHyper(beta=1.0, ml=ml, bunchsize=16, context=3,
                       targ_offset=1, activation=activation)
    snap = [{k: np.asarray(v).copy() for k, v in l.items()} for l in params]
    ref = _run(make_train_state(params, layersizes[-1]),
               noisy, clean, starts, hyper)

    p2 = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])} for l in snap]
    got = train_chunk_overlap(
        make_train_state(p2, layersizes[-1]), jnp.asarray(noisy),
        jnp.asarray(clean), jnp.asarray(starts), jnp.float32(0.05), hyper)
    for lr_, lo in zip(ref.params, got.params):
        np.testing.assert_allclose(np.asarray(lo["w"]), np.asarray(lr_["w"]),
                                   rtol=2e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(lo["b"]), np.asarray(lr_["b"]),
                                   rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(got.alpha), np.asarray(ref.alpha),
                               rtol=1e-5)


@pytest.mark.parametrize("ml", [False, True])
def test_overlap_step_dp8_matches_single_device(devices8, ml):
    """shard_map overlap step on the 8-device mesh == unsharded train_chunk
    (same global-batch gradient sums and alpha, one chained psum per layer
    — the engineered collective split)."""
    from tpu_se.parallel.overlap_step import (
        shard_overlap_args, train_chunk_overlap,
    )

    noisy, clean, starts, params, layersizes = _problem(seed=3)
    hyper = TrainHyper(beta=1.0, ml=ml, bunchsize=16, context=3,
                       targ_offset=1)
    snap = [{k: np.asarray(v).copy() for k, v in l.items()} for l in params]
    single = _run(make_train_state(params, layersizes[-1]),
                  noisy, clean, starts, hyper)

    mesh = make_mesh(8, 1)
    p2 = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])} for l in snap]
    n2, c2, s2 = shard_overlap_args(mesh, noisy, clean, starts)
    got = train_chunk_overlap(make_train_state(p2, layersizes[-1]),
                              n2, c2, s2, jnp.float32(0.05), hyper,
                              mesh=mesh)
    for ls, lo in zip(single.params, got.params):
        np.testing.assert_allclose(np.asarray(lo["w"]), np.asarray(ls["w"]),
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(lo["b"]), np.asarray(ls["b"]),
                                   rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.alpha),
                               np.asarray(single.alpha), rtol=1e-4)


def test_overlap_step_bf16_ring_matches_gspmd_bf16(devices8):
    """Under bf16 compute the overlap step's per-layer rings run in bf16
    (byte parity with the GSPMD program's narrowed all-reduce); the result
    must agree with the GSPMD-sharded bf16 step to bf16 tolerance."""
    from tpu_se.parallel.overlap_step import (
        shard_overlap_args, train_chunk_overlap,
    )

    noisy, clean, starts, params, layersizes = _problem(seed=5)
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=16, context=3,
                       targ_offset=1, grad_scale="natural",
                       compute_dtype=jnp.bfloat16)
    snap = [{k: np.asarray(v).copy() for k, v in l.items()} for l in params]
    mesh = make_mesh(8, 1)
    gspmd = _run(make_train_state(params, layersizes[-1]),
                 noisy, clean, starts, hyper, mesh=mesh)

    p2 = [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])} for l in snap]
    n2, c2, s2 = shard_overlap_args(mesh, noisy, clean, starts)
    got = train_chunk_overlap(make_train_state(p2, layersizes[-1]),
                              n2, c2, s2, jnp.float32(0.05), hyper,
                              mesh=mesh)
    for ls, lo in zip(gspmd.params, got.params):
        np.testing.assert_allclose(np.asarray(lo["w"]), np.asarray(ls["w"]),
                                   rtol=3e-2, atol=1e-4)
    assert np.isfinite(np.asarray(got.alpha)).all()

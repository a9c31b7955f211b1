"""Model tests: forward math, init scheme, .wts interchange."""

import numpy as np
import jax
import jax.numpy as jnp

from tpu_se.io.wts import read_wts, write_wts
from tpu_se.models import (
    forward, init_params, param_count, params_from_wts, params_to_wts,
)


def _np_forward(params, x):
    h = x
    for i, l in enumerate(params):
        z = h @ np.asarray(l["w"]) + np.asarray(l["b"])
        h = 1.0 / (1.0 + np.exp(-z)) if i < len(params) - 1 else z
    return h


def test_forward_matches_numpy():
    params = init_params(0, (6, 5, 4, 3))
    x = np.random.default_rng(1).normal(size=(7, 6)).astype(np.float32)
    got = np.asarray(forward(params, jnp.asarray(x)))
    want = _np_forward(params, x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_forward_bf16_close_to_f32():
    params = init_params(0, (6, 8, 3))
    x = np.random.default_rng(2).normal(size=(4, 6)).astype(np.float32)
    f32 = np.asarray(forward(params, jnp.asarray(x)))
    bf16 = np.asarray(forward(params, jnp.asarray(x),
                              compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(bf16, f32, rtol=0.05, atol=0.05)


def test_init_scheme_bounds():
    params = init_params(3, (100, 50, 10), flag=1, beta=2.0)
    w = np.asarray(params[0]["w"])
    bound = 2.0 * np.sqrt(6.0) / np.sqrt(150)
    assert np.abs(w).max() <= bound
    assert np.abs(w).max() > 0.9 * bound
    np.testing.assert_array_equal(np.asarray(params[0]["b"]), 0.0)
    params0 = init_params(3, (100, 50, 10), flag=0, beta=0.5)
    assert np.abs(np.asarray(params0[0]["w"])).max() <= 0.5 / 10.0


def test_init_uniform_ranges():
    """Trainer-internal fallback init (init_randem_* keys,
    Interface.cc:140-143): plain uniform on both weights and biases."""
    from tpu_se.models import init_params_uniform

    params = init_params_uniform(7, (100, 50, 10), -0.2, 0.3, -0.05, 0.05)
    w, b = np.asarray(params[0]["w"]), np.asarray(params[0]["b"])
    assert w.min() >= -0.2 and w.max() <= 0.3 and w.max() > 0.25
    assert b.min() >= -0.05 and b.max() <= 0.05 and np.abs(b).max() > 0
    assert w.shape == (100, 50) and b.shape == (50,)


def test_param_count():
    params = init_params(0, (1799, 2048, 2048, 2048, 257))
    assert param_count(params) == (1799 * 2048 + 2048 + 2048 * 2048 + 2048
                                   + 2048 * 2048 + 2048 + 2048 * 257 + 257)


def test_wts_interchange(tmp_path):
    params = init_params(5, (6, 5, 3))
    path = tmp_path / "m.wts"
    write_wts(path, params_to_wts(params))
    back = params_from_wts(read_wts(path))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 6)),
                    dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(forward(params, x)),
                               np.asarray(forward(back, x)), rtol=1e-6)


def test_dropout_forward():
    params = init_params(0, (6, 5, 3))
    x = jnp.ones((10, 6))
    rng = jax.random.PRNGKey(0)
    out = forward(params, x, dropout_rates=(0.5, 0.5), dropout_rng=rng)
    base = forward(params, x)
    assert out.shape == base.shape
    assert not np.allclose(np.asarray(out), np.asarray(base))


def test_forward_act_dtype_bf16_close_to_f32():
    """The reduced-precision-activations throughput knob must track the
    f32 forward closely (it only quantizes hidden activations) and default
    to off."""
    import jax.numpy as jnp

    from tpu_se.models import forward, init_params

    params = init_params(3, (24, 16, 16, 8))
    x = np.random.default_rng(0).normal(size=(8, 24)).astype(np.float32)
    base = np.asarray(forward(params, jnp.asarray(x)))
    red = np.asarray(forward(params, jnp.asarray(x),
                             compute_dtype=jnp.bfloat16,
                             act_dtype=jnp.bfloat16))
    assert red.dtype == np.float32          # output layer stays f32
    np.testing.assert_allclose(red, base, rtol=0.05, atol=0.05)

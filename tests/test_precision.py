"""Every GEMM of the device programs states its precision.

On a GPU a float32 dot without ``precision`` may run in TF32 (~3 decimal
digits), which breaks the 1-LSB decode contract and the reference's fp32
training math.  The DSP transforms and the float32 model run at HIGHEST;
a bfloat16 model states DEFAULT.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_se.dsp import lps_from_frames
from tpu_se.infer.decode import _decode_device
from tpu_se.infer.streaming import _init_state, _stream_step
from tpu_se.models import init_params
from tpu_se.train import TrainHyper, make_train_state, train_chunk

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
DEFAULT = (jax.lax.Precision.DEFAULT, jax.lax.Precision.DEFAULT)
SIZES = (1799, 16, 257)


def _dot_precisions(jaxpr):
    """The ``precision`` of every dot_general in ``jaxpr`` and the jaxprs
    nested in its equations (jit, scan, while, cond, custom_vjp)."""
    out = []

    def walk(value):
        if hasattr(value, "eqns"):
            for eqn in value.eqns:
                if eqn.primitive.name == "dot_general":
                    out.append(eqn.params["precision"])
                for param in eqn.params.values():
                    walk(param)
        elif hasattr(value, "jaxpr"):
            walk(value.jaxpr)
        elif isinstance(value, (tuple, list)):
            for v in value:
                walk(v)

    walk(jaxpr)
    return out


def _lps():
    return jax.make_jaxpr(lps_from_frames)(jnp.zeros((8, 512), jnp.float32))


def _stream():
    params = init_params(0, SIZES)
    state = _init_state(2, 512, 256, 257, 7)
    fn = functools.partial(_stream_step, frame_shift=256)
    return jax.make_jaxpr(fn)(params, jnp.zeros(257), jnp.ones(257), state,
                              jnp.zeros((2, 256), jnp.float32))


def _train(dtype):
    params = init_params(0, SIZES)
    hyper = TrainHyper(bunchsize=4, compute_dtype=dtype)
    fn = functools.partial(train_chunk, hyper=hyper)
    return jax.make_jaxpr(fn)(
        make_train_state(params, 257), jnp.zeros((32, 257)),
        jnp.zeros((32, 257)), jnp.zeros((2, 4), jnp.int32), jnp.float32(0.1))


def _decode():
    params = init_params(0, SIZES)
    return jax.make_jaxpr(_decode_device)(
        params, jnp.zeros((64, 512), jnp.float32), jnp.zeros(257),
        jnp.ones(257), jnp.int32(60))


@pytest.mark.parametrize("build,want", [
    (_lps, HIGHEST),
    (_stream, HIGHEST),
    (functools.partial(_train, jnp.float32), HIGHEST),
    (_decode, HIGHEST),
    (functools.partial(_train, jnp.bfloat16), DEFAULT),
], ids=["lps_from_frames", "stream_step", "train_chunk_f32", "decode_device",
        "train_chunk_bf16"])
def test_every_dot_states_its_precision(build, want):
    precisions = _dot_precisions(build().jaxpr)
    assert precisions, "no dot_general found"
    assert all(p == want for p in precisions), precisions


def test_precision_walker_sees_an_unstated_dot():
    """The walker finds dots inside nested jit and scan and reports a dot
    with no precision as None (so the test above can fail)."""
    @jax.jit
    def f(x):
        return jax.lax.scan(lambda c, r: (c + jnp.dot(r, r), None),
                            0.0, x)[0]

    assert _dot_precisions(jax.make_jaxpr(f)(np.ones((3, 4), np.float32))
                           .jaxpr) == [None]

"""Data-parallel train step with per-layer gradient psums (overlap path).

Under GSPMD the sharded ``train_chunk`` reduces the gradients of every
layer in one combined all-reduce.  That collective depends on the LAST
backward GEMM, so none of it can overlap with backward compute.  This
module rebuilds the training step under ``jax.shard_map`` with a
hand-placed ``lax.psum`` immediately after each layer's weight/bias
gradient: layer k's psum does not depend on the backward GEMMs of layers
< k, which gives the scheduler a legal window to hide each reduction
behind the remaining backward compute — the analog of the reference's
two-stream overlap of the dedx GEMM with the update kernels
(``BP_GPU.cu:31-50,430-437``).  Whether that window pays on a given
backend is a measurement, not a property of this code.

The math is the reference gradient chain, identical to
``train/step.py:train_chunk``:

- forward: sigmoid/relu hidden layers, linear output
  (``BP_GPU.cu:308-371``), GEMMs in ``hyper.compute_dtype`` with f32
  accumulation;
- output gradient + GGD alpha from ``tpu_se.losses`` (global-batch alpha:
  the per-dim mean |e|^beta is psum'd over the data axis before the
  closed form, ``BP_GPU.cu:413-420``);
- hidden backward ``dedx = h*(1-h)*dedy`` (``DevDsigmoid``), wgrad/bgrad
  GEMM + row-sum (``SgemmNT``/``DevAccSumrow``), each psum'd over data
  THE MOMENT it exists;
- momentum-SGD update (``kernUpdatedelta``) on the summed gradients.

Equivalence to the GSPMD step is pinned by ``tests/test_parallel.py``
(same tolerances as the DP/TP tests — psum reassociates the batch sum).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_se.losses.objectives import _sign_pow
from tpu_se.models.ffn import gemm_precision
from tpu_se.train.step import TrainHyper, TrainState, gather_splice


def _act(name: str):
    if name == "sigmoid":
        return jax.nn.sigmoid
    if name == "relu":
        return jax.nn.relu
    raise ValueError(f"unknown activation {name!r}")


def _bunch_grads(params, x, targ, hyper: TrainHyper, n_data: int,
                 axis: str | None):
    """Forward + hand-written backward for one local bunch.

    Returns (grads [per layer {'w','b'}, psum'd over ``axis``], alpha [D]).
    Written so each layer's gradient psum is issued as soon as that
    gradient exists, BEFORE the next (earlier) layer's backward GEMMs.
    """
    cd = hyper.compute_dtype
    prec = gemm_precision(cd)
    act = _act(hyper.activation)
    n_layers = len(params)

    # Forward, saving layer inputs (what wgrad needs): hs[l] is the input
    # to layer l; hs[n_layers] is the network output.
    hs = [x]
    h = x
    for i, layer in enumerate(params):
        z = jnp.dot(h.astype(cd), layer["w"].astype(cd), precision=prec,
                    preferred_element_type=jnp.float32) + layer["b"]
        h = act(z) if i < n_layers - 1 else z
        hs.append(h)
    out = hs[-1]

    # Output gradient + global-batch GGD alpha (BP_GPU.cu:396-426).  The
    # global bunch size is n_data * local M; psum of the local sum over
    # the data axis reproduces jnp.mean over the sharded global batch.
    m_local = out.shape[0]
    m_global = m_local * n_data
    err = out - targ
    beta = hyper.beta
    if hyper.ml:
        sum_pow = jnp.sum(jnp.abs(err) ** beta, axis=0)
        if axis is not None:
            sum_pow = jax.lax.psum(sum_pow, axis)
        alpha = (beta * sum_pow / m_global) ** (1.0 / beta)
        safe_alpha = jnp.where(alpha == 0.0, 1.0, alpha)
        scale = jnp.where(alpha == 0.0, 0.0, beta / safe_alpha ** beta)
        dedx = _sign_pow(err, beta - 1.0) * scale / m_global
    else:
        alpha = jnp.ones(out.shape[1], dtype=out.dtype)
        dedx = beta * _sign_pow(err, beta - 1.0) / m_global

    # Backward with per-layer psum placed right after each wgrad/bgrad.
    # ``tok`` threads a zero-valued scalar from each psum's OUTPUT into the
    # next psum's INPUT: an all-reduce combiner pass may merge independent
    # same-scope collectives into one, which would undo the split, and a
    # data dependency is the one thing that makes combining illegal.
    # Adding 0.0 is numerically free; the chain order (output layer first)
    # is the order the reductions would run anyway.
    grads = [None] * n_layers
    dedy = dedx
    tok = jnp.float32(0.0)
    for l in range(n_layers - 1, -1, -1):
        if l == n_layers - 1:
            dedz = dedy                                   # linear output
        elif hyper.activation == "sigmoid":
            hl = hs[l + 1]
            dedz = hl * (1.0 - hl) * dedy                 # DevDsigmoid
        else:
            dedz = jnp.where(hs[l + 1] > 0.0, dedy, 0.0)  # ReLU branch
        # wgrad [n_in, n_out] = hs^T @ dedz, expressed as a dot_general
        # contracting the batch axes directly (a materialized .T makes XLA
        # pick a column-major gradient layout and insert 16 MB layout
        # copies per layer per bunch — measured 3x step slowdown).
        gw = jax.lax.dot_general(
            hs[l].astype(cd), dedz.astype(cd),
            dimension_numbers=(((0,), (0,)), ((), ())), precision=prec,
            preferred_element_type=jnp.float32)           # SgemmNT
        gb = jnp.sum(dedz, axis=0)                        # DevAccSumrow
        if axis is not None:
            # One collective per layer, issued before layer l-1's GEMMs —
            # the overlap window this module exists to create.  The weight
            # reduction runs in compute_dtype (bf16 under bf16 compute, an
            # exact f32 reduction otherwise); biases stay f32 (24 KB).
            gw = (gw + tok).astype(cd)
            gw, gb = jax.lax.psum((gw, gb), axis)
            gw = gw.astype(jnp.float32)
            tok = gw[0, 0] * 0.0
        grads[l] = {"w": gw, "b": gb}
        if l > 0:
            # dedy [M, n_in] = dedz @ W^T, contracting the n_out axes.
            dedy = jax.lax.dot_general(
                dedz.astype(cd), params[l]["w"].astype(cd),
                dimension_numbers=(((1,), (1,)), ((), ())), precision=prec,
                preferred_element_type=jnp.float32)       # SgemmTN
    return grads, alpha


def _chunk_body(params, velocity, alpha0, noisy, clean, starts, lr,
                hyper: TrainHyper, n_data: int, axis: str | None):
    """lax.scan over the chunk's bunches (local shards)."""
    opt_n = hyper.bunchsize if hyper.grad_scale == "parity" else 1

    def body(carry, bunch_starts):
        params, velocity, _alpha = carry
        x = gather_splice(noisy, bunch_starts, hyper.context)
        targ = clean[bunch_starts + hyper.targ_offset]
        grads, alpha = _bunch_grads(params, x, targ, hyper, n_data, axis)
        new_params, new_velocity = [], []
        for p_l, v_l, g_l in zip(params, velocity, grads):
            vw = hyper.momentum * v_l["w"] - lr * (
                g_l["w"] / opt_n + hyper.weightcost * p_l["w"])
            vb = hyper.momentum * v_l["b"] - lr * (g_l["b"] / opt_n)
            new_params.append({"w": p_l["w"] + vw, "b": p_l["b"] + vb})
            new_velocity.append({"w": vw, "b": vb})
        return (new_params, new_velocity, alpha), None

    (params, velocity, alpha), _ = jax.lax.scan(
        body, (params, velocity, alpha0), starts)
    return params, velocity, alpha


@functools.partial(jax.jit, static_argnames=("hyper", "mesh"),
                   donate_argnums=(0,))
def train_chunk_overlap(state: TrainState, noisy: jax.Array,
                        clean: jax.Array, starts: jax.Array, lr: jax.Array,
                        hyper: TrainHyper, mesh=None) -> TrainState:
    """Drop-in alternative to ``train_chunk`` with explicit DP collectives.

    Same signature plus ``mesh`` (static).  ``mesh=None`` runs the
    identical math unsharded (used by the equivalence tests).  Dropout is
    not supported on this path (the parity trainer's default is
    dropout-free; use ``train_chunk`` for dropout runs).
    """
    if hyper.dropout is not None:
        raise NotImplementedError("overlap step does not support dropout")
    if hyper.act_dtype is not None:
        raise NotImplementedError(
            "overlap step does not support act_dtype (the hand-written "
            "backward keeps f32 activations; silently accepting it would "
            "measure a different program than train_chunk)")
    if mesh is None:
        params, velocity, alpha = _chunk_body(
            state.params, state.velocity, state.alpha, noisy, clean,
            starts, lr, hyper, n_data=1, axis=None)
        return TrainState(params, velocity, alpha)

    n_data = mesh.shape["data"]
    if mesh.shape.get("model", 1) != 1:
        raise NotImplementedError("overlap step is DP-only (model axis "
                                  "must be 1; use train_chunk for TP)")

    def sharded(params, velocity, alpha0, noisy, clean, starts, lr):
        params, velocity, alpha = _chunk_body(
            params, velocity, alpha0, noisy, clean, starts, lr, hyper,
            n_data=n_data, axis="data")
        return params, velocity, alpha

    rep = P()
    fn = jax.shard_map(
        sharded, mesh=mesh,
        in_specs=(rep, rep, rep, rep, rep, P(None, "data"), rep),
        out_specs=(rep, rep, rep),
        check_vma=False)   # psum'd grads -> identical updates on all shards
    params, velocity, alpha = fn(state.params, state.velocity, state.alpha,
                                 noisy, clean, starts, lr)
    return TrainState(params, velocity, alpha)


def shard_overlap_args(mesh, noisy, clean, starts):
    """Place chunk arrays for ``train_chunk_overlap``: frames replicated,
    starts bunch-sharded along the data axis (same layout as
    ``shard_train_args``)."""
    rep = NamedSharding(mesh, P())
    return (jax.device_put(jnp.asarray(noisy), rep),
            jax.device_put(jnp.asarray(clean), rep),
            jax.device_put(jnp.asarray(starts),
                           NamedSharding(mesh, P(None, "data"))))

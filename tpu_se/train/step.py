"""The jit/scan training engine: one dispatch per chunk, not per bunch.

Redesign of the reference's per-bunch CUDA loop
(``BP_GPU.cu:152-185,308-440``):

- A whole traincache chunk (frames [F, 257] + shuffled window starts) lives
  in HBM; ``lax.scan`` runs all ~800 bunches inside ONE compiled program, so
  there is no per-step dispatch overhead and XLA pipelines gather, GEMMs and
  the update.
- The 7-frame context splice is a device-side gather from the frame matrix
  (7x less HBM traffic than uploading pre-spliced 1799-dim rows, which is
  what the reference's host thread materializes).
- The backward pass is jax.vjp of the forward with an EXPLICIT output
  cotangent from ``tpu_se.losses`` — reproducing the reference's
  hand-written gradient chain (including its 1/M and e==0 conventions)
  rather than differentiating a scalar loss.
- Partial bunches are dropped by construction (callers pass
  ``starts[: n_bunches*M]``), matching ``BP_GPU.cu:170-184``.

Under a data mesh, batch-sharded gathers + replicated params turn the vjp
GEMM reductions and the alpha batch-mean into cross-device psums automatically
(GSPMD); see ``tpu_se.parallel`` for the shardings.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

from tpu_se.losses import output_grad_and_alpha
from tpu_se.models import forward
from tpu_se.train.optim import sgd_momentum_init, sgd_momentum_update


@dataclass(frozen=True)
class TrainHyper:
    """Static training hyper-parameters (hashable -> jit static arg).

    ``grad_scale='parity'`` reproduces the reference's double 1/M
    (SURVEY.md §3.2: loss grad / M, then optimizer grad/n again);
    ``'natural'`` applies the batch mean exactly once.
    """
    beta: float = 1.0
    ml: bool = True
    momentum: float = 0.9
    weightcost: float = 1e-5
    bunchsize: int = 128
    context: int = 7
    targ_offset: int = 3
    grad_scale: str = "parity"   # "parity" | "natural"
    compute_dtype: Any = jnp.float32
    activation: str = "sigmoid"  # "sigmoid" | "relu" (the #ifdef RELU build)
    dropout: tuple | None = None  # (visible_omit, hid_omit) or None
    act_dtype: Any = None        # reduced-precision hidden activations
                                 # (throughput knob; parity keeps None)

    def __post_init__(self):
        if self.grad_scale not in ("parity", "natural"):
            raise ValueError(f"bad grad_scale {self.grad_scale!r}")


@jax.tree_util.register_pytree_node_class
@dataclass
class TrainState:
    params: list
    velocity: list
    alpha: jax.Array  # last-bunch GGD scale factors (CrossValid2 uses these)

    def tree_flatten(self):
        return (self.params, self.velocity, self.alpha), None

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)


def make_train_state(params, out_dim: int) -> TrainState:
    return TrainState(params=params,
                      velocity=sgd_momentum_init(params),
                      alpha=jnp.ones(out_dim, dtype=jnp.float32))


def gather_splice(frames: jax.Array, starts: jax.Array, context: int
                  ) -> jax.Array:
    """frames [F, D] + starts [M] -> spliced [M, context*D] (device gather)."""
    idx = starts[:, None] + jnp.arange(context)[None, :]
    m = starts.shape[0]
    return frames[idx].reshape(m, context * frames.shape[1])


@functools.partial(jax.jit, static_argnames=("hyper",), donate_argnums=(0,))
def train_chunk(state: TrainState, noisy: jax.Array, clean: jax.Array,
                starts: jax.Array, lr: jax.Array, hyper: TrainHyper,
                dropout_key: jax.Array | None = None) -> TrainState:
    """Train all full bunches of one chunk.

    noisy/clean: [F, D] normalized frames; starts: [n_bunches, M] int32
    window starts (shuffled); lr: scalar (traced, so the epoch schedule does
    not recompile); dropout_key: PRNG key when hyper.dropout is set.
    """
    opt_n = hyper.bunchsize if hyper.grad_scale == "parity" else 1
    use_dropout = hyper.dropout is not None and dropout_key is not None

    def body(carry, scan_in):
        params, velocity, _alpha = carry
        bunch_starts, step_idx = scan_in
        x = gather_splice(noisy, bunch_starts, hyper.context)
        targ = clean[bunch_starts + hyper.targ_offset]

        def fwd(p):
            rng = (jax.random.fold_in(dropout_key, step_idx)
                   if use_dropout else None)
            return forward(p, x, compute_dtype=hyper.compute_dtype,
                           activation=hyper.activation,
                           dropout_rates=hyper.dropout if use_dropout else None,
                           dropout_rng=rng, act_dtype=hyper.act_dtype)

        out, vjp = jax.vjp(fwd, params)
        dedx, alpha = output_grad_and_alpha(out, targ, hyper.beta, hyper.ml)
        grads = vjp(dedx)[0]
        params, velocity = sgd_momentum_update(
            params, velocity, grads, lr, hyper.momentum, hyper.weightcost,
            opt_n)
        return (params, velocity, alpha), None

    n_bunches = starts.shape[0]
    (params, velocity, alpha), _ = jax.lax.scan(
        body, (state.params, state.velocity, state.alpha),
        (starts, jnp.arange(n_bunches)))
    return TrainState(params, velocity, alpha)


@functools.partial(jax.jit,
                   static_argnames=("context", "compute_dtype", "activation"))
def cv_forward(params, noisy: jax.Array, starts: jax.Array, context: int = 7,
               compute_dtype=jnp.float32,
               activation: str = "sigmoid") -> jax.Array:
    """Forward a batch of CV windows: [N] starts -> [N, out_dim] outputs."""
    x = gather_splice(noisy, starts, context)
    return forward(params, x, compute_dtype=compute_dtype,
                   activation=activation)


@functools.partial(jax.jit, static_argnames=("hyper",))
def cv_chunk_metrics(params, noisy: jax.Array, clean: jax.Array,
                     starts: jax.Array, mask: jax.Array, alpha: jax.Array,
                     hyper: TrainHyper) -> tuple:
    """Device-side CV accumulation for one padded batch of windows.

    Returns (sum squared err, sum abs err, sum (|err|/alpha)^beta) over the
    mask-selected windows — the three reductions behind ``CrossValid``,
    ``CrossValiddB`` and ``CrossValid2`` (``BP_GPU.cu:187-306``).
    """
    x = gather_splice(noisy, starts, hyper.context)
    out = forward(params, x, compute_dtype=hyper.compute_dtype,
                  activation=hyper.activation)
    targ = clean[starts + hyper.targ_offset]
    err = (out - targ) * mask[:, None]
    abs_e = jnp.abs(err)
    sq = jnp.sum(err * err)
    ab = jnp.sum(abs_e)
    pw = jnp.sum((abs_e / alpha) ** hyper.beta * mask[:, None])
    return sq, ab, pw

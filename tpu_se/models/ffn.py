"""The regression DNN: 1799 -> 2048 x3 (sigmoid) -> 257 (linear).

Matches the reference network (``finetune.pl:11-16``; forward pass
``BP_GPU.cu:334-370``: x_l = W_l y_{l-1} + b_l, sigmoid on hidden layers,
identity on the output layer).  Params are a plain pytree —
``[{"w": [n_in, n_out], "b": [n_out]}, ...]`` — so the same structure flows
through jit/vjp/optimizers and the .wts codec.

The backward pass is jax.vjp of this forward: autodiff of sigmoid gives the
reference's ``y(1-y) * dedy`` (``DevFunc.cu:58-71``), and the GEMM
transposes match ``SgemmTN``/``SgemmNT`` (``BP_GPU.cu:430-432``).  Only the
loss gradient is custom (see ``tpu_se.losses``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_LAYERSIZES = (1799, 2048, 2048, 2048, 257)


def gemm_precision(compute_dtype) -> jax.lax.Precision:
    """The ``precision`` of the model's GEMMs for a compute dtype.

    float32 means full fp32 (``HIGHEST``), as the reference's cuBLAS SGEMM
    computes it (``BP_GPU.cu:430-432``); without it a GPU may run float32
    dots in TF32.  Reduced dtypes keep the backend's default.
    """
    if jnp.dtype(compute_dtype) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return jax.lax.Precision.DEFAULT


def init_params(seed: int, layersizes=DEFAULT_LAYERSIZES,
                flag: int = 1, beta: float = 2.0) -> list[dict]:
    """Random init matching Gen_rand_net (``Gen_rand_net.cpp:84-103``).

    flag=1: W ~ U(+-beta*sqrt(6)/sqrt(n_in+n_out));
    flag=0: W ~ U(+-beta/sqrt(n_in)).  Biases zero.
    """
    rng = np.random.default_rng(seed)
    params = []
    for n_in, n_out in zip(layersizes[:-1], layersizes[1:]):
        if flag:
            bound = beta * np.sqrt(6.0) / np.sqrt(n_in + n_out)
        else:
            bound = beta / np.sqrt(n_in)
        w = rng.uniform(-bound, bound, size=(n_in, n_out)).astype(np.float32)
        params.append({"w": jnp.asarray(w),
                       "b": jnp.zeros(n_out, dtype=jnp.float32)})
    return params


def init_params_uniform(seed: int, layersizes=DEFAULT_LAYERSIZES,
                        weight_min: float = -0.1, weight_max: float = 0.1,
                        bias_min: float = -0.1, bias_max: float = 0.1
                        ) -> list[dict]:
    """The trainer's internal fallback init when no ``initwts_file`` is
    given: plain uniform ranges (``Interface.cc:140-143``, keys
    ``init_randem_{weight,bias}_{min,max}``). ``finetune.pl`` never uses
    this path (epoch 1 always loads a Gen_rand_net ``.wts``), but the CLI
    key surface supports it for parity."""
    rng = np.random.default_rng(seed)
    params = []
    for n_in, n_out in zip(layersizes[:-1], layersizes[1:]):
        w = rng.uniform(weight_min, weight_max,
                        size=(n_in, n_out)).astype(np.float32)
        b = rng.uniform(bias_min, bias_max, size=n_out).astype(np.float32)
        params.append({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    return params


def forward(params: list[dict], x: jax.Array,
            compute_dtype=jnp.float32,
            activation: str = "sigmoid",
            dropout_rates: tuple[float, ...] | None = None,
            dropout_rng: jax.Array | None = None,
            act_dtype=None) -> jax.Array:
    """Batched forward: x [M, n_in] -> [M, n_out].

    ``compute_dtype=jnp.bfloat16`` runs the GEMMs in bf16 with float32
    accumulation (params stay float32 — the fast path for benching;
    float32 is the parity default, computed in full fp32, see
    :func:`gemm_precision`).

    ``activation`` selects the hidden nonlinearity: "sigmoid" (default) or
    "relu" — the reference's ``#ifdef RELU`` build (``DevFunc.cu:40-49``,
    ``Makefile:8-16``); autodiff of either matches its hand-written
    derivative kernels.

    ``dropout_rates`` (visible, hidden) enables the reference's input-side
    dropout (``BP_GPU.cu:344-356``): each layer's *input* is zeroed with
    prob p.  The reference rescales weights by (1-p) at CV time
    (``BP_GPU.cu:484-499``); we use the mathematically equivalent inverted
    dropout at train time so inference needs no weight rescaling.
    """
    if activation == "sigmoid":
        act = jax.nn.sigmoid
    elif activation == "relu":
        act = jax.nn.relu
    else:
        raise ValueError(f"unknown activation {activation!r}")
    h = x
    n_layers = len(params)
    precision = gemm_precision(compute_dtype)
    for i, layer in enumerate(params):
        if dropout_rates is not None and dropout_rng is not None:
            p = dropout_rates[0] if i == 0 else dropout_rates[1]
            if p > 0.0:
                dropout_rng, sub = jax.random.split(dropout_rng)
                keep = jax.random.bernoulli(sub, 1.0 - p, h.shape)
                h = jnp.where(keep, h / (1.0 - p), 0.0)
        w = layer["w"].astype(compute_dtype)
        z = jnp.dot(h.astype(compute_dtype), w, precision=precision,
                    preferred_element_type=jnp.float32) + layer["b"]
        h = act(z) if i < n_layers - 1 else z
        if act_dtype is not None and i < n_layers - 1:
            # Opt-in reduced-precision activations (e.g. bf16): halves the
            # device-memory traffic of the inter-layer tensors the vjp must also
            # save.  Output layer stays f32.  Bench/throughput knob — the
            # parity path never sets it.
            h = h.astype(act_dtype)
    return h


def params_from_wts(layers: list[dict]) -> list[dict]:
    """.wts codec output -> device pytree."""
    return [{"w": jnp.asarray(l["w"]), "b": jnp.asarray(l["b"])}
            for l in layers]


def params_to_wts(params: list[dict]) -> list[dict]:
    """Device pytree -> .wts codec input (host numpy)."""
    return [{"w": np.asarray(l["w"]), "b": np.asarray(l["b"])}
            for l in params]


def param_count(params: list[dict]) -> int:
    return sum(int(np.prod(l["w"].shape)) + int(l["b"].shape[0])
               for l in params)

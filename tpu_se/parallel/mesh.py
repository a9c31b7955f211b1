"""Device mesh and sharding layout for the training engine.

The workload is data-parallel by nature (each sample is an independent
1799-dim frame; the ~12.6 M-param model fits on one device, SURVEY.md §2.4), so
the primary mesh axis is ``data``:

- frames [F, 257]: replicated (each device gathers its own bunch shard from
  the full chunk — frames are ~100 MB, far cheaper than cross-device gathers).
- window starts [n_bunches, M]: sharded on the bunch axis ``M`` -> each device
  splices and forwards M/n_data samples.
- params/velocity: replicated; GSPMD turns the vjp weight-gradient GEMM
  reductions and the GGD alpha batch-mean into cross-device psums.

An optional ``model`` axis demonstrates tensor parallelism over the hidden
dims (column-parallel W1, alternating thereafter) for scale-out of wider
variants; with model=1 the specs collapse to replication.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclass(frozen=True)
class MeshConfig:
    data: int
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devices) // model
    n = data * model
    if n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, "
                         f"have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(dev_array, ("data", "model"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, rank: int, batch_dim: int) -> NamedSharding:
    """Shard dimension ``batch_dim`` of a rank-``rank`` array over 'data'."""
    spec = [None] * rank
    spec[batch_dim] = "data"
    return NamedSharding(mesh, P(*spec))


def param_shardings(mesh: Mesh, n_layers: int) -> list[dict]:
    """Per-layer NamedShardings for params/velocity.

    With a trivial model axis everything replicates.  With model > 1 the
    hidden layers alternate column-/row-parallel (Megatron-style): W1
    [in, h] sharded on h, W2 [h, h] on its input dim, etc.; the output
    layer's 257 dim stays replicated.  GSPMD inserts the activation psum
    between the row-parallel GEMM and the next layer.
    """
    tp = mesh.shape["model"] > 1
    out = []
    for i in range(n_layers):
        last = i == n_layers - 1
        if not tp or last:
            w_spec = P()
        elif i % 2 == 0:
            w_spec = P(None, "model")     # column-parallel
        else:
            w_spec = P("model", None)     # row-parallel
        b_spec = P("model") if (tp and not last and i % 2 == 0) else P()
        out.append({"w": NamedSharding(mesh, w_spec),
                    "b": NamedSharding(mesh, b_spec)})
    return out


def shard_train_args(mesh: Mesh, noisy, clean, starts):
    """Place one chunk's arrays with the training layout."""
    rep = replicated_sharding(mesh)
    noisy = jax.device_put(noisy, rep)
    clean = jax.device_put(clean, rep)
    starts = jax.device_put(starts, batch_sharding(mesh, 2, 1))
    return noisy, clean, starts

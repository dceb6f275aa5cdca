"""Device mesh and sharding rules.

The reference is strictly single-device (no DDP/FSDP/NCCL anywhere — SURVEY.md
§2.9); its only parallel axis is the batch. Here it is a 2-D
``jax.sharding.Mesh`` with axes:

  * ``data``  — batch dimension sharded across devices; the gradient
    all-reduce is inserted by jit's partitioner (psum of the mean loss
    gradient). The cards of one host are joined all to all, so the mesh has
    one tier.
  * ``model`` — megatron-style tensor parallelism for the attention/FFN
    projections: QKV and FFN-in kernels column-sharded (head / hidden axis),
    output projections row-sharded so each layer needs exactly one
    reduce-scatter/all-reduce pair, inserted by XLA from the sharding
    annotations.

At the reference's 1-5M-parameter scale TP is never required (SURVEY.md §2.9
recommends exposing it anyway), so ``model=1`` is the default and every rule
degrades to full replication.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a (data, model) mesh. Defaults to all devices on the data axis."""
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        data = len(devices) // model
    n = data * model
    if n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have {len(devices)}")
    if n == len(devices):
        mesh_devices = mesh_utils.create_device_mesh((data, model), devices=devices)
    else:
        mesh_devices = np.array(devices[:n]).reshape(data, model)
    return Mesh(mesh_devices, ("data", "model"))


def ambient_mesh() -> Optional[Mesh]:
    """The Mesh installed by an enclosing ``with mesh:`` block, or None.

    The Triton attention kernel consults this at trace time: under a
    multi-device mesh it must run per shard inside ``jax.shard_map``
    (XLA's SPMD partitioner cannot split a pallas_call on its own; see
    vitiq/ops/pallas/flash_attention.py)."""
    try:
        from jax._src import mesh as mesh_lib

        m = mesh_lib.thread_resources.env.physical_mesh
        return None if m.empty else m
    except (ImportError, AttributeError):
        # private jax._src API moved (JAX upgrade): returning None would
        # SILENTLY disable the shard_map wrapping, so make the breakage
        # visible once rather than eat it
        import warnings

        warnings.warn(
            "vitiq.parallel.mesh.ambient_mesh: jax internal thread_resources "
            "API unavailable in this JAX version — the attention kernel "
            "will not see ambient meshes",
            stacklevel=2)
        return None


def mesh_data_axes(mesh: Mesh) -> tuple:
    """Axis names carrying the batch dimension with size > 1 (('data',) or
    ())."""
    return tuple(a for a in mesh.axis_names
                 if a != "model" and mesh.shape[a] > 1)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) axis split over 'data'; feature axes replicated."""
    return NamedSharding(mesh, P("data"))


def scan_batch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a [K, B, ...] stacked superbatch (device-scan
    superbatching, vitiq/train/loop.py): the scan (K) axis stays unsharded —
    every device steps through the same K sub-batches in lockstep — while
    each sub-batch's B axis splits over the data axes exactly like
    batch_sharding. Scan-of-sharded-steps composes with the partitioner: the
    per-step collectives (grad psums) are identical to the per-dispatch
    path's, just issued from inside one device call."""
    return NamedSharding(mesh, P(None, "data"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch, mesh: Mesh):
    """Place a host batch (pytree of arrays with a leading batch axis) as
    global arrays sharded over the 'data' axis."""
    sharding = batch_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), batch)


# --------------------------------------------------------------------------
# per-host (process-sharded) data feeding — SURVEY §0/§2.9, VERDICT r3 item 6
# --------------------------------------------------------------------------

def process_local_rows(mesh: Mesh, global_batch: int,
                       process_index: Optional[int] = None,
                       process_of_device=None) -> slice:
    """Rows of the global batch owned by one process's devices under
    ``batch_sharding(mesh)``.

    On a multi-host mesh each process must feed ONLY the batch rows its
    addressable devices hold; this derives that row range from the batch
    sharding's device→index map rather than assuming a layout, so it stays
    correct for dp×tp meshes (model-axis devices replicate the same rows).

    `process_of_device` maps a device to its process index (defaults to
    ``d.process_index``); tests inject a fake mapping to exercise the
    multi-host geometry on a single-process CPU mesh.
    """
    sharding = batch_sharding(mesh)
    if process_of_device is None:
        def process_of_device(d):
            return d.process_index
    if process_index is None:
        process_index = jax.process_index()
    imap = sharding.devices_indices_map((global_batch,))
    spans = sorted({
        (idx[0].start or 0,
         global_batch if idx[0].stop is None else idx[0].stop)
        for d, idx in imap.items()
        if process_of_device(d) == process_index
    })
    if not spans:
        raise ValueError(
            f"process {process_index} owns no devices of mesh {mesh.shape}")
    lo, hi = spans[0][0], max(e for _, e in spans)
    cur = lo
    for s, e in spans:
        if s > cur:
            raise ValueError(
                f"process {process_index}'s batch rows are non-contiguous "
                f"({spans}); feed assembly needs one host slice per process "
                f"— reorder the mesh so same-process devices are adjacent "
                f"on the data axis")
        cur = max(cur, e)
    return slice(lo, hi)


def shard_batch_per_process(local_batch, mesh: Mesh, global_batch: int):
    """Assemble the GLOBAL sharded batch from this process's local rows only.

    Multi-host counterpart of `shard_batch`: `local_batch` holds just the
    rows from `process_local_rows(mesh, global_batch)` (on a single-process
    mesh that is the whole batch), and
    `jax.make_array_from_process_local_data` builds the global jax.Array
    without any host ever materializing another host's shard.
    """
    sharding = batch_sharding(mesh)

    def put(x):
        return jax.make_array_from_process_local_data(
            sharding, np.ascontiguousarray(x),
            (global_batch,) + tuple(x.shape[1:]))

    return jax.tree_util.tree_map(put, local_batch)


# --------------------------------------------------------------------------
# tensor-parallel parameter layout
# --------------------------------------------------------------------------

def _spec_for(path: str, ndim: int) -> P:
    """Megatron TP rules keyed on the parameter's path within the model tree.

    Column-parallel (shard output features): w_q/w_k/w_v kernels and ffn
    linear1 — the per-head / per-hidden slices are independent.
    Row-parallel (shard input features): w_concat and ffn linear2 — their
    matmuls contract over the sharded axis, producing the layer's single
    all-reduce.
    Everything else (embeddings, LayerNorms, CLS, head) is replicated.
    """
    col = ("w_q", "w_k", "w_v", "linear1")
    row = ("w_concat", "linear2")
    parts = path.split("/")
    if len(parts) >= 2:
        owner, leaf = parts[-2], parts[-1]
        if owner in col:
            return P(None, "model") if leaf == "kernel" else P("model")
        if owner in row:
            # kernel [in, out]: contract over sharded 'in'; bias replicated
            return P("model", None) if leaf == "kernel" else P()
    return P()


def param_shardings(mesh: Mesh, params):
    """Pytree of NamedShardings matching `params` (TP over 'model', replicated
    over 'data')."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            out = [walk(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
            return type(tree)(out) if isinstance(tree, tuple) else out
        return NamedSharding(mesh, _spec_for(prefix, tree.ndim))

    return walk(params, "")


def shard_params(params, mesh: Mesh):
    """Place parameters on the mesh according to the TP rules."""
    shardings = param_shardings(mesh, params)
    return jax.tree_util.tree_map(jax.device_put, params, shardings)

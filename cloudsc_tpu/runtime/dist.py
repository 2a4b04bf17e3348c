"""Device-mesh distribution of the column axis.

The reference's entire distributed backend is a thin MPI wrapper used for (a)
splitting columns across ranks at load time and (b) reducing validation norms /
gathering perf rows (ref: src/common/module/cloudsc_mpi_mod.F90). The JAX
equivalent:

  * columns are sharded over a 1-D `jax.sharding.Mesh` ("columns" axis); the
    compute path needs NO collectives — XLA SPMD partitions the embarrassingly
    parallel column axis exactly like the reference's MPI column decomposition
    (ref: dwarf_cloudsc.F90:74-77, expand_mod.F90:30-46)
  * validation norms use psum/pmin/pmax inside shard_map — the analogue of
    CLOUDSC_MPI_REDUCE_* (ref: cloudsc_mpi_mod.F90:109-269)
  * multi-host init maps to jax.distributed.initialize; each process owns
    exactly one GPU (a second JAX process on a card fails for want of
    memory, since each reserves most of it at start-up)
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

COLUMN_AXIS = "columns"


def initialize_multihost():
    """jax.distributed init (the CLOUDSC_MPI_INIT analogue); no-op single host.

    Activated by the standard JAX env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) — the launcher contract of the
    reference's `mpirun -np N binary ...` (ref: cloudsc_mpi_mod.F90:58-95).
    Idempotent: safe to call from every entry point.
    """
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return
    if getattr(jax.distributed, "is_initialized", None) and \
            jax.distributed.is_initialized():
        return
    kw = {}
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if nproc is not None and pid is not None:
        # plain-launcher contract (no SLURM/OMPI auto-detection available)
        kw = dict(coordinator_address=addr, num_processes=int(nproc),
                  process_id=int(pid))
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:  # already initialized by the embedding app
        if "already initialized" not in str(e).lower():
            raise


def column_mesh(devices=None) -> Mesh:
    """A 1-D mesh over all (or the given) devices, columns axis only."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (COLUMN_AXIS,))


def _field_spec(ndim: int) -> P:
    """Columns live on the trailing axis of every field array."""
    return P(*([None] * (ndim - 1) + [COLUMN_AXIS]))


def shard_fields(fields: dict, mesh: Mesh) -> dict:
    """Place a field dict on the mesh, sharded over the trailing column axis."""
    out = {}
    for k, v in fields.items():
        sharding = NamedSharding(mesh, _field_spec(np.ndim(v)))
        out[k] = jax.device_put(v, sharding)
    return out


def sharded_cloudsc(params, ptsphy: float, mesh: Mesh, backend: str = "xla",
                    config=None):
    """Jitted CLOUDSC whose inputs/outputs are column-sharded over the mesh.

    The scheme has no cross-column dependency, so the compute path needs no
    collectives (matching the reference, whose compute path has no MPI calls
    either). The XLA scan is plain jit + sharding annotations, which XLA
    partitions itself. backend="triton" runs the fused kernel on each
    device's shard under shard_map: a pallas_call is a custom call XLA
    cannot partition.
    """
    from jax import shard_map

    from .. import kernels

    step = kernels.step_fn(backend)

    def compute(fields):
        return step(fields, params, ptsphy, config)

    def fn(fields):
        if backend == "triton":
            in_specs = ({k: _field_spec(v.ndim) for k, v in fields.items()},)
            shapes = jax.eval_shape(compute, fields)
            out_specs = jax.tree.map(lambda s: _field_spec(s.ndim), shapes)
            return shard_map(compute, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)(fields)
        out = compute(fields)
        specs = jax.tree.map(lambda x: _field_spec(x.ndim), out)
        return jax.lax.with_sharding_constraint(
            out, jax.tree.map(lambda s: NamedSharding(mesh, s), specs)
        )

    return jax.jit(fn)


# -- cross-process collectives (the CLOUDSC_MPI_REDUCE_*/GATHER analogues) -----

def allreduce_field_norms(norms: np.ndarray) -> np.ndarray:
    """Reduce per-field (min, max, maxerr, errsum, refsum) rows across
    processes — the CLOUDSC_MPI_REDUCE_MIN/MAX/SUM triple the reference
    validator issues per field (ref: validate_mod.F90:148-151), batched into
    one allgather for all fields.

    `norms` is (nfields, 5) float64; returns the same shape, globally reduced.
    Single-process: identity.
    """
    if jax.process_count() == 1:
        return norms
    from jax.experimental import multihost_utils

    g = np.asarray(
        multihost_utils.process_allgather(jnp.asarray(norms))
    )  # (nproc, nfields, 5)
    return np.stack(
        [
            g[..., 0].min(axis=0),
            g[..., 1].max(axis=0),
            g[..., 2].max(axis=0),
            g[..., 3].sum(axis=0),
            g[..., 4].sum(axis=0),
        ],
        axis=-1,
    )


def gather_perf_rows(time_s: float, ncols: int) -> np.ndarray:
    """Gather one (seconds, columns) performance row per process to every
    process — the CLOUDSC_MPI_GATHER the reference timer issues before
    printing per-rank rows (ref: timer_mod.F90:167, cloudsc_mpi_mod.F90:271-329).

    Returns (nprocs, 2) float64.
    """
    row = np.asarray([time_s, float(ncols)])
    if jax.process_count() == 1:
        return row[None, :]
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(jnp.asarray(row)))


# -- validation-norm reductions (the CLOUDSC_MPI_REDUCE_* analogues) -----------

def error_norms(field, ref, axis_name: str | None = None):
    """(min, max, maxabserr, errsum, refsum) with optional mesh reduction."""
    diff = jnp.abs(field - ref)
    stats = dict(
        minval=jnp.min(field),
        maxval=jnp.max(field),
        maxerr=jnp.max(diff),
        errsum=jnp.sum(diff),
        refsum=jnp.sum(jnp.abs(ref)),
    )
    if axis_name is not None:
        stats["minval"] = jax.lax.pmin(stats["minval"], axis_name)
        stats["maxval"] = jax.lax.pmax(stats["maxval"], axis_name)
        stats["maxerr"] = jax.lax.pmax(stats["maxerr"], axis_name)
        stats["errsum"] = jax.lax.psum(stats["errsum"], axis_name)
        stats["refsum"] = jax.lax.psum(stats["refsum"], axis_name)
    return stats


def sharded_error_norms(mesh: Mesh, params=None):
    """shard_map'd error norms over the column mesh — the distributed VALIDATE."""
    from jax import shard_map

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, COLUMN_AXIS), P(None, COLUMN_AXIS)),
        out_specs=P(),
    )
    def norms(field, ref):
        s = error_norms(field, ref, axis_name=COLUMN_AXIS)
        return jnp.stack(
            [s["minval"], s["maxval"], s["maxerr"], s["errsum"], s["refsum"]]
        )

    return norms

"""Worker for the 2-rank multi-process test (run via subprocess).

One MPI-rank analogue: joins the jax.distributed coordinator, runs the CLI
end-to-end (config line + perf gather + globally reduced validation table),
then re-runs the library path on this rank's column slice and snapshots the
raw outputs for the parent's bitwise comparison against a single-process run
— the analogue of the reference's 2-rank ctest cases
(ref: src/cloudsc_fortran/CMakeLists.txt:42-73).

Usage: python tests/_mp_worker.py RANK NRANKS PORT OUTDIR [NGPTOTG] [MODE]

MODE "cli" (default): the CLI + per-rank column-slice snapshot above.
MODE "kernel": the fused kernel under shard_map (interpret mode on CPU)
over a GLOBAL 2-process mesh; each rank snapshots its addressable output
shard for the parent's bitwise comparison against a single-process kernel
run (ref: the reference MPI-tests the same kernel it benchmarks,
src/cloudsc_fortran/CMakeLists.txt:42-73).
"""

import contextlib
import io
import os
import sys
from pathlib import Path

rank, nranks, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
outdir = Path(sys.argv[4])
ngptotg = int(sys.argv[5]) if len(sys.argv) > 5 else 100
mode = sys.argv[6] if len(sys.argv) > 6 else "cli"

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = str(nranks)
os.environ["JAX_PROCESS_ID"] = str(rank)
if mode == "kernel":
    # one device per process (the parent pytest env forces 8 virtual CPU
    # devices; here each process models one GPU of a multi-host run)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

if mode == "kernel":
    import functools

    import jax.numpy as jnp
    import numpy as np

    from cloudsc_tpu.data import default_input_path, load_input
    from cloudsc_tpu.kernels.triton_cloudsc import cloudsc_triton
    from cloudsc_tpu.params import Params
    from cloudsc_tpu import kernels
    from cloudsc_tpu.runtime.dist import (column_mesh, initialize_multihost,
                                          shard_fields)
    from cloudsc_tpu.runtime.driver import CloudscDriver

    kernels.step_fn = lambda backend: functools.partial(cloudsc_triton,
                                                        interpret=True)

    initialize_multihost()
    mesh = column_mesh()  # 1 CPU device per process -> nranks global devices
    assert mesh.devices.size == nranks, mesh.devices
    # every process supplies the identical full input; device_put then keeps
    # only this process's addressable shard (global-array semantics)
    inp = load_input(default_input_path(), ngptot=ngptotg, expand=False)
    params = Params.from_input(inp)
    driver = CloudscDriver(params, inp.ptsphy, dtype=jnp.float32,
                           nproma=128, backend="triton", mesh=mesh)
    assert not driver.grouped
    fields, ncol = driver.prepare(inp)
    fields = shard_fields(fields, mesh)
    out = driver._fn(fields)
    jax.block_until_ready(out)
    save = {}
    for name in ("tendency_loc_t", "pfplsl", "plude", "prainfrac_toprfz"):
        shards = getattr(out, name).addressable_shards
        assert len(shards) == 1
        (sh,) = shards
        save[name] = np.asarray(sh.data)
        save[name + "_start"] = np.int64(sh.index[-1].start or 0)
    np.savez(outdir / f"kernel_out_{rank}.npz", **save)
    sys.exit(0)

from cloudsc_tpu.cli import main  # noqa: E402

buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = main(["1", str(ngptotg), "16", "--precision", "fp64"])
(outdir / f"stdout_{rank}.txt").write_text(buf.getvalue())
assert rc == 0

# raw per-rank outputs for the parent's bitwise slice comparison
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cloudsc_tpu.data import default_input_path, load_input  # noqa: E402
from cloudsc_tpu.params import Params  # noqa: E402
from cloudsc_tpu.runtime.driver import CloudscDriver  # noqa: E402

share = (ngptotg - 1) // nranks + 1
ngptot = min(share, ngptotg - rank * share)
inp = load_input(default_input_path(), ngptot=ngptot, ngptotg=ngptotg,
                 rank=rank, nranks=nranks)
params = Params.from_input(inp)
driver = CloudscDriver(params, inp.ptsphy, dtype=jnp.float64, nproma=16,
                       backend="xla")
out, _, _ = driver.run(inp)
np.savez(
    outdir / f"out_{rank}.npz",
    start=rank * share,
    tendency_loc_t=np.asarray(out.tendency_loc_t),
    pfplsl=np.asarray(out.pfplsl),
    plude=np.asarray(out.plude),
    prainfrac_toprfz=np.asarray(out.prainfrac_toprfz),
)
sys.exit(0)

"""Run CLOUDSC column-sharded over a device mesh (several GPUs).

Columns are embarrassingly parallel, so multi-chip CLOUDSC is a pure
data-parallel mesh over the column axis with ZERO collectives in the
compute path — exactly the reference's MPI column decomposition
(ref: dwarf_cloudsc.F90:74-77); only the validation norms reduce
(psum/pmin/pmax, the CLOUDSC_MPI_REDUCE_* analogue).

On a machine with several GPUs just run it; without them, this demo uses
8 virtual CPU devices:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/pod_sharding.py

Multi-host works the same way: launch one process per host with the usual
coordinator env (see runtime/dist.initialize_multihost), give the CLI the
global NGPTOT, and each rank loads only its column slice.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import jax.numpy as jnp
import numpy as np

from cloudsc_tpu.data import default_input_path, load_input
from cloudsc_tpu.params import Params
from cloudsc_tpu.runtime.driver import CloudscDriver
from cloudsc_tpu.validate import device_field_norms, validate_from_norms


def main() -> int:
    ndev = len(jax.devices())
    ngptot = 1024 * ndev
    print(f"{ndev} devices ({jax.default_backend()}), {ngptot} columns")

    inp = load_input(default_input_path(), ngptot=ngptot)
    params = Params.from_input(inp)
    driver = CloudscDriver(params, inp.ptsphy, dtype=jnp.float32,
                           nproma=128, use_mesh=True)
    out, timings, timer = driver.run(inp, iterations=2, fetch_outputs=False)
    print(f"compute {timings.compute_s * 1e3:.1f} ms/step over the mesh "
          f"(compile {timings.compile_s:.1f} s)")

    # validate without gathering fields: norms reduce on device
    from cloudsc_tpu.data import default_reference_path, load_reference
    from cloudsc_tpu.runtime.dist import shard_fields

    ref = load_reference(default_reference_path(), ngptot=ngptot)
    ref_dev = shard_fields(
        {k: jnp.asarray(v, jnp.float32) for k, v in ref.items()}, driver.mesh
    )
    norms = np.asarray(device_field_norms(out, ref_dev))
    # flag against the run's WORKING precision (this driver runs fp32), like
    # the reference's SINGLE build (ref: validate_mod.F90:270)
    validate_from_norms(norms, ngptot, print_table=True,
                        work_eps=float(np.finfo(driver.dtype).eps))
    return 0


if __name__ == "__main__":
    sys.exit(main())

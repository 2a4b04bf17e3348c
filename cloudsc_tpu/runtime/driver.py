"""Driver: orchestrates the CLOUDSC step on device with reference-style timing.

The reference driver loops NPROMA blocks under OpenMP
(ref: src/cloudsc_fortran/cloudsc_driver_mod.F90:129-190); here the block
loop disappears — the whole column batch is one device program and NPROMA
becomes the column-padding granularity. Like the GPU variants we report both
device-compute-only and end-to-end (with transfers) timings
(ref: src/cloudsc_cuda/cloudsc/cloudsc_driver.cu:349-..., README.md:311-318),
plus compile time which has no reference analogue.
"""

from __future__ import annotations

import time

import jax
import numpy as np

from .. import kernels
from ..physics import make_inputs
from .timer import PerformanceTimer, Timings
from .dist import column_mesh, shard_fields, sharded_cloudsc

BACKENDS = ("xla", "triton")


def resolve_backend(backend: str) -> str:
    """'auto' picks the fused Triton kernel on a GPU and the XLA scan
    elsewhere — the analogue of the reference building its gpu-scc-k-caching
    variant for GPUs and the Fortran one for CPUs. The choice follows the
    platform alone; a failure of the chosen engine is an error."""
    if backend == "auto":
        return "triton" if jax.default_backend() == "gpu" else "xla"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; use 'auto', 'xla' or 'triton'"
        )
    return backend


class CloudscDriver:
    def __init__(self, params, ptsphy: float, dtype=None, nproma: int = 128,
                 mesh=None, use_mesh: bool = False, backend: str = "auto",
                 scheme_config=None):
        import jax.numpy as jnp

        self.params = params
        self.ptsphy = ptsphy
        self.scheme_config = scheme_config
        self.dtype = dtype or jnp.float32
        self.nproma = max(int(nproma), 1)
        self.mesh = mesh if mesh is not None else (column_mesh() if use_mesh else None)
        self.backend = resolve_backend(backend)
        # activity-grouped column layout for the fused kernel: expand each
        # snapshot column's copies contiguously (source columns ordered by
        # data.expand.activity_perm) so a block's columns are alike and the
        # value-exact per-block skips fire. A pure permutation — run()
        # gathers outputs back to canonical order outside the timed loop.
        # Multi-process runs keep the cyclic layout: the inverse gather would
        # index a non-addressable global array per host.
        self.grouped = self.backend == "triton" and jax.process_count() == 1
        self.group_perm = None  # source-column order of the last prepare()
        if self.mesh is not None:
            self._fn = sharded_cloudsc(params, ptsphy, self.mesh,
                                       backend=self.backend,
                                       config=scheme_config)
        else:
            step = kernels.step_fn(self.backend)
            self._fn = jax.jit(
                lambda f: step(f, params, ptsphy, scheme_config)
            )

    # -- helpers ---------------------------------------------------------------

    def _pad_multiple(self) -> int:
        """Pad columns to a multiple of NPROMA and, on a mesh, of its size."""
        mult = self.nproma
        if self.mesh is not None:
            mult = int(np.lcm(mult, self.mesh.devices.size))
        return mult

    def prepare(self, inp) -> tuple[dict, int]:
        """InputData -> padded host field dict (+ true column count)."""
        ncol = inp.ngptot
        self.group_perm = None
        klon = int(np.asarray(inp.fields["PT"]).shape[-1])
        if self.grouped and klon < ncol:  # identity layout otherwise
            from ..data.expand import activity_perm

            self.group_perm = activity_perm(
                inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                inp.ptsphy, self.params.ydecldp.rlmin,
                nshards=(self.mesh.devices.size
                         if self.mesh is not None else 1),
            )
        fields = make_inputs(
            inp, dtype=self.dtype,
            column_order="grouped" if self.grouped else "cyclic",
            column_perm=self.group_perm, host=True,
        )
        mult = self._pad_multiple()
        target = -(-ncol // mult) * mult
        if target != ncol:
            padded = {}
            for k, v in fields.items():
                pad = [(0, 0)] * (v.ndim - 1) + [(0, target - ncol)]
                padded[k] = np.pad(v, pad, mode="edge")
            fields = padded
        return fields, ncol

    def _ungroup(self, out, inp, ncol: int):
        """Gather grouped-layout outputs back to canonical column order.

        Copies of a snapshot column are bitwise-identical through the scheme
        (columns are independent; the dynamic skips are value-exact), so
        indexing with group_inverse reconstructs the cyclic-layout outputs
        exactly (tests/test_grouped_columns.py; on the card,
        tests/test_gpu.py)."""
        from ..data.expand import group_inverse

        klon = int(np.asarray(inp.fields["PT"]).shape[-1])
        if klon == ncol:
            return out
        inv = jax.numpy.asarray(
            group_inverse(klon, ncol, perm=self.group_perm)
        )
        return jax.tree.map(lambda a: a[..., inv], out)

    # -- execution ---------------------------------------------------------------

    def chained_fn(self, iterations: int):
        """`iterations` scheme steps chained inside ONE jitted fori_loop, so
        the timed region is one dispatch whatever the step count.

        A zero-scaled data dependency threads each step's output into the
        next step's input — value-exact, and XLA cannot hoist the
        loop-invariant step out. Returns a jitted fn: fields -> the
        dependency array (the completion target).
        """
        call = self._fn

        def body(_, fs):
            out = call(fs)
            fs = dict(fs)
            fs["pt"] = fs["pt"] + 0.0 * out.tendency_loc_t
            return fs

        return jax.jit(
            lambda fs: jax.lax.fori_loop(0, iterations, body, fs)["pt"]
        )

    def run(self, inp, iterations: int = 1, warmup: bool = True,
            fetch_outputs: bool = True):
        """Run the scheme; returns (outputs, Timings, PerformanceTimer).

        With fetch_outputs=True (default) the outputs come back on host,
        column-sliced, and d2h is timed. Mesh/bench-size callers pass False to
        keep the outputs on device (the reference never gathers field data
        either — validation reduces norms, ref: validate_mod.F90:148-151);
        device-side validation then uses validate.device_field_norms.
        """
        fields, ncol = self.prepare(inp)
        fn = self._fn
        timings = Timings()

        t0 = time.perf_counter()
        if self.mesh is not None:
            fields = shard_fields(fields, self.mesh)
        else:
            fields = jax.device_put(fields)
        jax.block_until_ready(fields)
        timings.h2d_s = time.perf_counter() - t0

        chained = None
        if warmup:
            t0 = time.perf_counter()
            fn = fn.lower(fields).compile()
            timings.memory = fn.memory_analysis()
            out = jax.block_until_ready(fn(fields))
            if iterations > 1:
                # the timed loop is one dispatch; warm it up here so the
                # timed region sees no compile
                chained = self.chained_fn(iterations)
                jax.block_until_ready(chained(fields))
            timings.compile_s = time.perf_counter() - t0

        # one row per device: SPMD executes the same program on every mesh
        # device, each holding its column shard — the analogue of the
        # reference's per-thread rows (ref: timer_mod.F90:169-187)
        ndev = self.mesh.devices.size if self.mesh is not None else 1
        timer = PerformanceTimer(ndevices=ndev)
        # energy sampling around the hot loop, gated by EC_PMON exactly like
        # the reference (ref: ec_pmon_mod.F90:14-57, driver samples at
        # cloudsc_driver_mod.F90:170-178)
        from .pmon import EnergySampler

        sampler = EnergySampler()
        sampler.start()
        timer.start()
        t0 = time.perf_counter()
        if chained is not None:
            jax.block_until_ready(chained(fields))
        else:
            for _ in range(iterations):
                out = fn(fields)
            out = jax.block_until_ready(out)
        timings.compute_s = (time.perf_counter() - t0) / iterations
        timer.end()
        timings.energy_line = sampler.stop_and_report()
        # distribute the column count exactly: the first (total % ndev)
        # devices carry one extra column, so the table's TOTAL row sums to
        # the true ncol*iterations (the JUBE scrapes are value-sensitive)
        total_cols = ncol * iterations
        base, extra = divmod(total_cols, ndev)
        for dev in range(ndev):
            timer.log(dev, timings.compute_s * iterations,
                      base + (1 if dev < extra else 0))

        if self.grouped:
            # map grouped-layout outputs back to canonical (cyclic) column
            # order — a pure device-side gather, outside the timed loop just
            # like the reference's validation reload (a production timestep
            # loop would simply keep the grouped layout end to end)
            out = self._ungroup(out, inp, ncol)
        if not fetch_outputs:
            return out, timings, timer
        t0 = time.perf_counter()
        host_out = jax.tree.map(lambda x: np.asarray(x)[..., :ncol], out)
        timings.d2h_s = time.perf_counter() - t0
        return host_out, timings, timer

"""dwarf-cloudsc-tpu command line entry point.

CLI-compatible with every reference variant: `prog NUMOMP NGPTOT NPROMA`
(ref: src/cloudsc_fortran/dwarf_cloudsc.F90:48-83). NUMOMP has no meaning on
an accelerator (accepted for parity; the device count plays its role), NGPTOT
is the total column count and NPROMA the column-padding granularity. Prints
the reference's config line, throughput table and validation table.

Usage:
    python -m cloudsc_tpu 1 163840 128 [--precision fp32|fp64] [--input PATH]
        [--reference PATH] [--mesh] [--iterations N] [--kernel auto|scan|triton]
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dwarf-cloudsc-tpu",
        description="CLOUDSC dwarf on JAX: XLA scan and a fused GPU kernel",
    )
    p.add_argument("numomp", type=int, nargs="?", default=1,
                   help="thread count (reference-CLI parity; unused)")
    p.add_argument("ngptot", type=int, nargs="?", default=100,
                   help="total number of grid-point columns")
    p.add_argument("nproma", type=int, nargs="?", default=128,
                   help="column blocking factor (padding granularity)")
    p.add_argument("--precision", choices=("fp32", "fp64"), default=None,
                   help="working precision (default fp64 on CPU, fp32 on an "
                        "accelerator)")
    p.add_argument("--platform", choices=("auto", "cpu"), default="auto",
                   help="force the JAX platform; 'cpu' runs on the host CPU")
    p.add_argument("--input", default=None,
                   help="input snapshot: input.npz, input.h5 or a Serialbox "
                        "data/ dir (default: the repo's data/input.npz)")
    p.add_argument("--reference", default=None,
                   help="golden outputs for validation: reference.npz or .h5 "
                        "(default: the repo's data/reference.npz)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--mesh", action="store_true",
                   help="shard columns over all visible devices")
    p.add_argument("--iterations", type=int, default=1)
    p.add_argument("--kernel", choices=("auto", "scan", "triton"),
                   default="auto",
                   help="compute engine: the fused Pallas-Triton GPU kernel or "
                        "the XLA scan (auto = triton on a GPU, scan otherwise)")
    p.add_argument("--iwarmrain", type=int, choices=(1, 2), default=2,
                   help="warm rain: 1 Sundqvist / 2 Khairoutdinov-Kogan "
                        "(ref default 2; ref: cloudsc.F90:562-580)")
    p.add_argument("--ievaprain", type=int, choices=(1, 2), default=2,
                   help="rain evaporation: 1 Sundqvist / 2 Abel-Boutle")
    p.add_argument("--ievapsnow", type=int, choices=(1, 2), default=1,
                   help="snow sublimation: 1 Sundqvist / 2 PSD-based")
    p.add_argument("--idepice", type=int, choices=(1, 2), default=1,
                   help="ice deposition: 1 Rotstayn / 2 ice-PSD-based")
    p.add_argument("--sweep-nproma", default=None, metavar="N1,N2,...",
                   help="run a multi-configuration sweep over these NPROMA "
                        "values in ONE process, reusing the loaded input — "
                        "the prototype1 multi-config sweep driver "
                        "(ref: src/prototype1/cloudsc/cloudsc_driver.F90:10-715); "
                        "amortizes load + per-dispatch overhead vs one "
                        "process per point; validation runs on the last "
                        "configuration")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace of the compute loop to DIR "
                        "(the atlas_Trace / gprof analogue)")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax_debug_nans during the run (the validator's "
                        "uninitialized-variable canary, made eager)")
    p.add_argument("--write-input", default=None, metavar="PATH",
                   help="snapshot the (unexpanded) input state to PATH.h5 "
                        "(needs h5py; also via CLOUDSC_WRITE_INPUT)")
    p.add_argument("--write-reference", default=None, metavar="PATH",
                   help="snapshot the outputs as a reference.h5 to PATH "
                        "(needs h5py; also via CLOUDSC_WRITE_REFERENCE)")
    return p


def _peak_gib(dev) -> str:
    """The device's peak bytes in use so far, or "n/a" where the platform
    keeps no allocator statistics (the CPU)."""
    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return "n/a" if peak is None else f"{peak / 2**30:.3f}"


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    for name in ("numomp", "ngptot", "nproma", "iterations"):
        if getattr(args, name) < 1:
            parser.error(f"{name} must be >= 1 (got {getattr(args, name)})")

    import jax

    if args.platform == "cpu":
        # pinned through the config, before any device query
        jax.config.update("jax_platforms", "cpu")

    # multi-process init (the CLOUDSC_MPI_INIT analogue) must precede any
    # device query; a no-op unless the launcher set JAX_COORDINATOR_ADDRESS
    # (ref: dwarf_cloudsc.F90:69 calling cloudsc_mpi_init first)
    from .runtime.dist import initialize_multihost

    initialize_multihost()

    on_accel = jax.default_backend() != "cpu"
    precision = args.precision or ("fp32" if on_accel else "fp64")
    if precision == "fp64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    dtype = jnp.float64 if precision == "fp64" else jnp.float32

    from . import enable_compilation_cache

    enable_compilation_cache()

    from .data import (
        default_input_path, default_reference_path, load_input, load_reference,
    )
    from .params import Params
    from .runtime.driver import CloudscDriver
    from .validate import validate_outputs

    input_path = args.input or default_input_path()
    ref_path = args.reference or default_reference_path()

    # multi-host: argv NGPTOT is the GLOBAL column count; each process takes
    # the reference's per-rank share (ref: dwarf_cloudsc.F90:74-77) and loads
    # its slice (true slicing only when the file is big enough, else the
    # replicated-columns property applies, ref: expand_mod.F90:30-46)
    nranks = jax.process_count()
    rank = jax.process_index()
    ngptotg = args.ngptot
    if nranks > 1:
        share = (ngptotg - 1) // nranks + 1
        ngptot = min(share, ngptotg - rank * share)
    else:
        ngptot = ngptotg
    inp = load_input(input_path, ngptot=ngptot, ngptotg=ngptotg,
                     rank=rank, nranks=nranks, expand=False)
    params = Params.from_input(inp)
    from .native import get_lib

    if get_lib() is None and rank == 0:
        print(" native host library unavailable (no g++, or CLOUDSC_NATIVE=0):"
              " expanding columns with NumPy")

    backend = {"scan": "xla", "triton": "triton", "auto": "auto"}[args.kernel]
    from .physics.scheme import SchemeConfig

    cfg = SchemeConfig(args.iwarmrain, args.ievaprain, args.ievapsnow,
                       args.idepice)
    # snapshot hooks need full host outputs; otherwise accelerator runs
    # validate on device (norm reductions, never a field gather — exactly the
    # reference, ref: validate_mod.F90:148-151). CPU runs keep the host path
    # (golden workflows diff full fields).
    write_input = args.write_input or os.environ.get("CLOUDSC_WRITE_INPUT")
    write_ref = args.write_reference or os.environ.get("CLOUDSC_WRITE_REFERENCE")
    fetch = bool(write_ref) or (not args.mesh and not on_accel)

    if args.debug_nans:
        jax.config.update("jax_debug_nans", True)
    rank0 = rank == 0

    # the prototype1 multi-config sweep: several NPROMA points in ONE
    # process, shared input and device session, one perf table per point
    # (ref: src/prototype1/cloudsc/cloudsc_driver.F90:10-715)
    if args.sweep_nproma:
        try:
            sweep = [int(s) for s in args.sweep_nproma.split(",")]
        except ValueError:
            parser.error(
                f"--sweep-nproma must be comma-separated integers "
                f"(got {args.sweep_nproma!r})"
            )
    else:
        sweep = [args.nproma]
    if not sweep or any(n < 1 for n in sweep):
        parser.error("--sweep-nproma values must be >= 1")

    for nproma in sweep:
        driver = CloudscDriver(
            params, inp.ptsphy, dtype=dtype, nproma=nproma,
            use_mesh=args.mesh, backend=backend, scheme_config=cfg,
        )
        ngpblks = -(-ngptot // nproma)
        ndev = driver.mesh.devices.size if driver.mesh is not None else 1
        if rank0:  # the reference's rank-0-gated config line
            # (ref: cloudsc_driver_mod.F90:121-124)
            print(
                f"     NUMPROC={max(ndev, nranks)}, NUMOMP={args.numomp}, "
                f"NGPTOTG={ngptotg}, NPROMA={nproma}, NGPBLKS={ngpblks}"
            )

        if args.profile:
            with jax.profiler.trace(args.profile):
                out, timings, timer = driver.run(
                    inp, iterations=args.iterations, fetch_outputs=fetch)
            print(f" profiler trace -> {args.profile}")
        else:
            out, timings, timer = driver.run(inp, iterations=args.iterations,
                                             fetch_outputs=fetch)

        # cross-rank perf gather (ref: timer_mod.F90:167) — a collective, so
        # every rank participates; only rank 0 prints
        rank_rows = None
        if nranks > 1:
            from .runtime.dist import gather_perf_rows

            rank_rows = gather_perf_rows(
                timings.compute_s * args.iterations, ngptot * args.iterations,
            )
        if rank0:
            timer.print_performance(nproma, ngpblks, ngptot,
                                    numomp=args.numomp, rank=rank,
                                    rank_rows=rank_rows,
                                    iterations=args.iterations)
            print(
                f" device compute: {timings.compute_s * 1e3:9.3f} ms | h2d:"
                f" {timings.h2d_s * 1e3:9.3f} ms | d2h: {timings.d2h_s * 1e3:9.3f} ms |"
                f" compile: {timings.compile_s:7.3f} s"
            )
            dev = jax.devices()[0]
            print(f" engine: {driver.backend} | precision: {precision} |"
                  f" device: {dev.platform} {dev.device_kind}"
                  f" x{len(jax.devices())}")
            mem = timings.memory
            if mem is not None:
                print(
                    f" memory (GiB): arguments"
                    f" {mem.argument_size_in_bytes / 2**30:.3f} | outputs"
                    f" {mem.output_size_in_bytes / 2**30:.3f} | temp"
                    f" {mem.temp_size_in_bytes / 2**30:.3f} | peak in use "
                    + _peak_gib(dev)
                )
            if timings.energy_line:  # EC_PMON (ref: cloudsc_driver_mod.F90:170-178)
                print(timings.energy_line)

    if not args.no_validate:
        ref = load_reference(ref_path, ngptot=ngptot, ngptotg=ngptotg,
                             rank=rank, nranks=nranks)
        if fetch:
            validate_outputs(out, ref, ngptotg=ngptotg,
                             multiprocess=nranks > 1, print_table=rank0)
        else:
            import numpy as np

            from .runtime.dist import shard_fields
            from .validate import device_field_norms, validate_from_norms

            import jax.numpy as jnp

            ref_cast = {k: jnp.asarray(v, dtype) for k, v in ref.items()}
            if driver.mesh is not None:
                ref_dev = shard_fields(ref_cast, driver.mesh)
            else:
                ref_dev = jax.device_put(ref_cast)
            norms = np.asarray(device_field_norms(out, ref_dev))
            validate_from_norms(norms, ngptotg, print_table=rank0,
                                multiprocess=nranks > 1,
                                work_eps=float(np.finfo(dtype).eps))

    # snapshot hooks for regenerating goldens — the Serialbox write hooks of
    # the reference (CLOUDSC_WRITE_INPUT/CLOUDSC_WRITE_REFERENCE,
    # ref: src/prototype1/support/serialize_mod.F90:62-130, README.md:199-205)
    if write_input:
        from .data import write_h5

        klon = inp.klon_file
        snap = {k: v[..., :klon] if hasattr(v, "ndim") and v.ndim else v
                for k, v in inp.fields.items()}
        write_h5(write_input, snap, inp.scalars)
        print(f" wrote input snapshot -> {write_input}")
    if write_ref:
        import numpy as np

        from .data import write_h5
        from .validate import FIELD_ATTR, REF_DATASET

        klon = inp.klon_file
        snap = {
            REF_DATASET[name]: np.asarray(getattr(out, attr))[..., :klon]
            for name, attr in FIELD_ATTR.items()
        }
        write_h5(
            write_ref, snap,
            {"KLON": klon, "KLEV": inp.klev, "KFLDX": inp.scalars.get("KFLDX", 0)},
        )
        print(f" wrote reference snapshot -> {write_ref}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

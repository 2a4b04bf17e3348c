"""cloudsc-tpu: the IFS CLOUDSC cloud microphysics scheme (the
dwarf-p-cloudsc benchmark) on JAX — an XLA scan engine and a fused GPU kernel
written with Pallas through Triton.

Structure (mirrors the reference component inventory):
  params        physics parameter structs (ref: src/common/module/yo{mcst,ethf,ecldp,ephli}.F90)
  data          input/reference readers + column expansion (ref: file_io_mod/expand_mod)
  physics       the CLOUDSC scheme as precompute + lax.scan + postcompute
                (ref: src/cloudsc_fortran/cloudsc.F90)
  kernels       the fused column kernel for GPUs (ref: the CUDA k-caching
                variant, src/cloudsc_cuda/cloudsc/cloudsc_c_k_caching.cu)
  runtime       drivers, timers, device-mesh distribution (ref: cloudsc_driver_mod,
                timer_mod, cloudsc_mpi_mod)
  validate      golden-file error-norm table (ref: validate_mod.F90)
"""

__version__ = "0.1.0"


def enable_compilation_cache() -> None:
    """Persist XLA compilations across processes (scheme graphs are large).

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads that directory from the
    environment itself and nothing is set here. Otherwise the cache lives in
    one fixed directory of the checkout, `.jax_cache/` (the path is part of
    the cache's key, so it must not move between runs)."""
    import os
    from pathlib import Path

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        cache_dir = Path(__file__).resolve().parents[1] / ".jax_cache"
        jax.config.update("jax_compilation_cache_dir", str(cache_dir))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

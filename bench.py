"""Benchmark entry point — prints ONE JSON line with the metric of record.

Metric: grid-point columns per second per GPU at the dwarf's standard size,
163,840 columns x 137 levels, fp32, through CloudscDriver's chained step (the
path the CLI's performance table times). vs_baseline compares against the
strongest single-GPU number the reference publishes:
dwarf-cloudsc-gpu-scc-hoist at ~340 GF/s on one A100 (ref: README.md:283-292),
i.e. 340e9 / 124823.29 flops-per-column = 2.724e6 columns/s (flop model
ref: timer_mod.F90:26-27).

Runs only on a GPU: on any other platform it exits non-zero and prints no
result. ITERS steps are chained in one dispatch and the chain is timed five
times with `jax.block_until_ready`; the line reports the median and spread.

Environment: CLOUDSC_BENCH_NGPTOT (columns, default 163840 per device),
CLOUDSC_BENCH_ITERS (chained steps, default 10), CLOUDSC_BENCH_BACKEND
(auto | xla | triton), CLOUDSC_BENCH_MESH=1 (shard the columns over every
visible GPU; the rate is then per GPU).
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_COLS_PER_S = 340.0e9 / 124823.29  # A100 scc-hoist, ~2.724e6 col/s
RUNS = 5


def card_identity() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import jax

    from cloudsc_tpu.runtime.dist import initialize_multihost

    initialize_multihost()  # no-op unless a multi-process launcher set env
    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU, JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    card = card_identity()

    import jax.numpy as jnp

    import cloudsc_tpu
    from cloudsc_tpu.data import default_input_path, load_input
    from cloudsc_tpu.params import Params
    from cloudsc_tpu.runtime.driver import CloudscDriver
    from cloudsc_tpu.runtime.dist import shard_fields

    cloudsc_tpu.enable_compilation_cache()
    use_mesh = os.environ.get("CLOUDSC_BENCH_MESH", "0") == "1"
    ndev = len(jax.devices()) if use_mesh else 1
    ngptot = int(os.environ.get("CLOUDSC_BENCH_NGPTOT", 163840 * ndev))
    iters = int(os.environ.get("CLOUDSC_BENCH_ITERS", 10))
    backend = os.environ.get("CLOUDSC_BENCH_BACKEND", "auto")

    inp = load_input(default_input_path(), ngptot=ngptot, expand=False)
    params = Params.from_input(inp)
    driver = CloudscDriver(params, inp.ptsphy, dtype=jnp.float32, nproma=128,
                           backend=backend, use_mesh=use_mesh)
    fields, _ = driver.prepare(inp)
    if driver.mesh is not None:
        fields = shard_fields(fields, driver.mesh)
    else:
        fields = jax.device_put(fields)
    jax.block_until_ready(fields)

    chained = driver.chained_fn(iters)
    t0 = time.perf_counter()
    jax.block_until_ready(chained(fields))  # compile + warm-up
    compile_s = time.perf_counter() - t0

    steps = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(fields))
        steps.append((time.perf_counter() - t0) / iters)
    step_s = statistics.median(steps)
    cols_per_s = ngptot / step_s / ndev

    dev = jax.devices()[0]
    name, power_limit = (s.strip() for s in card.split(",", 1))
    print(json.dumps({
        "metric": f"columns/s per GPU ({ngptot // 1024}K cols x 137 lev, "
                  f"fp32, {driver.backend} engine)",
        "value": round(cols_per_s, 1),
        "unit": "columns/s",
        "vs_baseline": round(cols_per_s / BASELINE_COLS_PER_S, 4),
        "step_s_median": step_s,
        "step_s_min": min(steps),
        "step_s_max": max(steps),
        "runs": RUNS,
        "iterations": iters,
        "compile_s": compile_s,
        "engine": driver.backend,
        "precision": "fp32",
        "ngptot": ngptot,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": ndev,
        "card": name,
        "power_limit": power_limit,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""True multi-process (multi-host analogue) execution — the 2-rank ctest.

The reference ships 2-rank MPI ctest cases (`mpirun -np 2 dwarf-cloudsc-fortran
1 100 16`, ref: src/cloudsc_fortran/CMakeLists.txt:42-73). Here two real
processes join a jax.distributed local coordinator (CPU backend), each runs
the CLI on its per-rank column share with true file slicing (100-column file,
NGPTOTG=100 -> rank 0 gets columns 0-49, rank 1 gets 50-99), the validation
norms are allreduced, and the perf rows gathered. The parent then asserts the
per-rank raw outputs are BITWISE equal to the matching slice of a
single-process run — the distributed-equals-serial property the reference
gets from replicated columns (ref: README.md:167-175), proven here in the
strictly harder true-slicing regime.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "_mp_worker.py"
NGPTOTG = 100


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("mp")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), "2", str(port),
             str(outdir), str(NGPTOTG)],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for rank in range(2)
    ]
    errs = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append(f"rank {rank} TIMED OUT\n{err[-2000:]}")
            continue
        if p.returncode != 0:
            errs.append(f"rank {rank} rc={p.returncode}\n{err[-2000:]}")
    assert not errs, "\n".join(errs)
    return outdir


def test_two_rank_bitwise_equals_single(two_rank_run, input_100, params):
    """Each rank's outputs == the matching column slice of a 1-process run."""
    import jax.numpy as jnp

    from cloudsc_tpu.runtime.driver import CloudscDriver

    driver = CloudscDriver(params, input_100.ptsphy, dtype=jnp.float64,
                           nproma=16, backend="xla")
    single, _, _ = driver.run(input_100)

    for rank in range(2):
        z = np.load(two_rank_run / f"out_{rank}.npz")
        start = int(z["start"])
        for name in ("tendency_loc_t", "pfplsl", "plude", "prainfrac_toprfz"):
            got = z[name]
            want = np.asarray(getattr(single, name))[
                ..., start:start + got.shape[-1]
            ]
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"rank {rank} {name}")


def test_two_rank_table_matches_single(two_rank_run, capsys, input_100,
                                       params, reference_100):
    """Rank 0's globally reduced validation table must match the
    single-process table (numerically: the errsum partial-sum order differs
    across ranks by design, exactly as in the reference's MPI reduction)."""
    out0 = (two_rank_run / "stdout_0.txt").read_text()
    out1 = (two_rank_run / "stdout_1.txt").read_text()
    assert "NUMPROC=2" in out0
    # rank gating: only rank 0 prints the config line and tables
    assert "NUMPROC" not in out1
    assert "@ rank#1" in out0  # the gathered per-rank perf rows

    import jax
    import jax.numpy as jnp

    from cloudsc_tpu.physics import cloudsc, make_inputs
    from cloudsc_tpu.validate import validate_outputs

    fields = make_inputs(input_100, dtype=jnp.float64)
    single = jax.jit(lambda f: cloudsc(f, params, input_100.ptsphy))(fields)
    expect = validate_outputs(single, reference_100, ngptotg=NGPTOTG,
                              print_table=False)

    rows = {}
    for line in out0.splitlines():
        parts = line.split()
        if len(parts) >= 7 and parts[1].endswith(("D1", "D2", "D3")):
            rows[parts[0]] = [float(v) for v in parts[2:7]]
    assert len(rows) == 21, f"validation table incomplete: {len(rows)} rows"
    for e in expect:
        got = rows[e.name]
        want = [e.minval, e.maxval, e.maxerr, e.avgpgp, 100.0 * e.relerr]
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-300,
                                   err_msg=e.name)


@pytest.fixture(scope="module")
def two_rank_kernel_run(tmp_path_factory):
    """2 real processes x the fused kernel under shard_map (interpret
    mode): the multi-host configuration of the GPU engine."""
    outdir = tmp_path_factory.mktemp("mp_kernel")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), "2", str(port),
             str(outdir), "512", "kernel"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for rank in range(2)
    ]
    errs = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append(f"rank {rank} TIMED OUT\n{err[-2000:]}")
            continue
        if p.returncode != 0:
            errs.append(f"rank {rank} rc={p.returncode}\n{err[-2000:]}")
    assert not errs, "\n".join(errs)
    return outdir


def test_two_rank_kernel_bitwise_equals_single(two_rank_kernel_run):
    """Each rank's kernel output shard == the matching column slice of a
    single-process kernel run on the cyclic layout (the multi-process
    regime), bitwise (512 columns over 2 ranks: both shards hold real
    columns)."""
    import jax
    import jax.numpy as jnp

    from cloudsc_tpu.data import default_input_path, load_input
    from cloudsc_tpu.kernels.triton_cloudsc import cloudsc_triton
    from cloudsc_tpu.params import Params
    from cloudsc_tpu.physics import make_inputs

    inp = load_input(default_input_path(), ngptot=512)
    params = Params.from_input(inp)
    fields = make_inputs(inp, dtype=jnp.float32)
    single = jax.jit(lambda f: cloudsc_triton(f, params, inp.ptsphy,
                                              interpret=True))(fields)

    seen_cols = 0
    for rank in range(2):
        z = np.load(two_rank_kernel_run / f"kernel_out_{rank}.npz")
        for name in ("tendency_loc_t", "pfplsl", "plude",
                     "prainfrac_toprfz"):
            got = z[name]
            start = int(z[name + "_start"])
            stop = min(start + got.shape[-1], 512)
            want = np.asarray(getattr(single, name))[..., start:stop]
            np.testing.assert_array_equal(
                got[..., : stop - start], want,
                err_msg=f"rank {rank} {name}",
            )
        seen_cols += stop - start
    assert seen_cols == 512  # the shards tile the whole column set

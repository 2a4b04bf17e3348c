"""Data-layer tests: serialbox archive reading, expansion, parameter hydration."""

import os

import numpy as np
import pytest

from cloudsc_tpu.data import expand_field, get_offsets
from cloudsc_tpu.data.serialbox import SerialboxArchive
from conftest import REFERENCE_DATA

# Raw-serialbox tests need the .dat archive; a clean checkout ships only the
# h5 mirrors (data/*.h5), matching the reference which regenerates input.h5.
needs_serialbox = pytest.mark.skipif(
    not os.path.isdir(REFERENCE_DATA),
    reason="raw Serialbox archive not available (h5-mirror checkout)",
)


@needs_serialbox
def test_archive_shapes():
    ar = SerialboxArchive(REFERENCE_DATA, "input")
    assert ar.field_dims("PT") == (100, 137)
    assert ar.field_dims("PAPH") == (100, 138)
    assert ar.field_dims("PCLV") == (100, 137, 5)
    # h5-mirror layout: reversed dims
    assert ar.read("PT").shape == (137, 100)
    assert ar.read("PCLV").shape == (5, 137, 100)
    assert ar.read("LDCUM").dtype == np.bool_
    assert ar.read("KTYPE").dtype == np.int32


@needs_serialbox
def test_archive_matches_h5_convention():
    """Raw .dat read must agree with the h5-mirror conventions."""
    ar = SerialboxArchive(REFERENCE_DATA, "input")
    g = ar.global_scalars()
    assert g["KLON"] == 100 and g["KLEV"] == 137
    assert abs(g["PTSPHY"] - 3600.0) < 1e-12
    assert len(g) == 173


def test_expand_cyclic():
    f = np.arange(12, dtype=np.float64).reshape(3, 4)
    e = expand_field(f, 10)
    assert e.shape == (3, 10)
    np.testing.assert_array_equal(e[:, 4:8], f)
    np.testing.assert_array_equal(e[:, 8:], f[:, :2])


def test_get_offsets_replication():
    # file smaller than global size -> every rank reads everything (ref trick)
    assert get_offsets(100, 1000, 4000, rank=3, nranks=4) == (0, 100)
    # file large enough -> true decomposition
    start, count = get_offsets(4000, 1000, 4000, rank=1, nranks=4)
    assert (start, count) == (1000, 1000)


def test_get_offsets_uneven_coverage():
    """Rank slices must tile [0, ngptotg) exactly with the reference's
    ceil-stride rule even when ngptotg % nranks != 0
    (ref: expand_mod.F90:37-43 + dwarf_cloudsc.F90:74-77 share rule)."""
    ngptotg, nranks = 10, 4
    share = (ngptotg - 1) // nranks + 1
    covered = []
    for rank in range(nranks):
        ngptot = min(share, ngptotg - rank * share)  # the CLI's per-rank share
        if ngptot <= 0:
            continue
        start, count = get_offsets(ngptotg, ngptot, ngptotg, rank, nranks)
        covered.extend(range(start, start + count))
    assert covered == list(range(ngptotg))


def test_params(params):
    assert params.ydecldp.ncldtop == 15
    assert params.ydecldp.nssopt == 1
    assert isinstance(params.ydcst.rg, float)
    assert params.ydthf.rvtmp2 == 0.0
    assert len(params.ydecldp.rbeta) == 101


def test_per_rank_slicing(tmp_path):
    """True per-rank column slicing when the file holds >= NGPTOTG columns
    (ref: expand_mod.F90:30-46 get_offsets)."""
    import numpy as np

    from cloudsc_tpu.data import load_input, write_h5

    src = load_input(REFERENCE_DATA, ngptot=256)
    big = tmp_path / "big.h5"
    scalars = dict(src.scalars)
    scalars["KLON"] = 256
    fields = {k: v for k, v in src.fields.items()}
    write_h5(big, fields, scalars)

    full = load_input(big, ngptot=256)
    r0 = load_input(big, ngptot=128, ngptotg=256, rank=0, nranks=2)
    r1 = load_input(big, ngptot=128, ngptotg=256, rank=1, nranks=2)
    for name in ("PT", "PAPH", "PCLV"):
        np.testing.assert_array_equal(r0.fields[name],
                                      full.fields[name][..., :128])
        np.testing.assert_array_equal(r1.fields[name],
                                      full.fields[name][..., 128:])


def test_per_rank_slicing_serialbox_dir():
    """The raw Serialbox archive path slices per rank too (memmap hyperslab,
    ref: file_io_mod.F90:158-235) — only the rank's columns leave the file."""
    import numpy as np

    from cloudsc_tpu.data import load_input

    full = load_input(REFERENCE_DATA, ngptot=100)
    r1 = load_input(REFERENCE_DATA, ngptot=50, ngptotg=100, rank=1, nranks=2)
    for name in ("PT", "PAPH", "PCLV", "KTYPE", "LDCUM"):
        np.testing.assert_array_equal(r1.fields[name],
                                      full.fields[name][..., 50:])
    # parameter tables are never column-sliced
    np.testing.assert_array_equal(r1.fields["YRECLDP_RBETA"],
                                  full.fields["YRECLDP_RBETA"])


@pytest.mark.parametrize("name", ["input", "reference"])
def test_npz_matches_h5_bitwise(name):
    """The .npz snapshots the program reads hold exactly the .h5 mirrors'
    datasets: same names, shapes, dtypes and bits (tools/h52npz.py)."""
    h5py = pytest.importorskip("h5py")
    from pathlib import Path

    data = Path(REFERENCE_DATA).resolve().parent
    with h5py.File(data / f"{name}.h5", "r") as h5, \
            np.load(data / f"{name}.npz") as npz:
        assert sorted(h5.keys()) == sorted(npz.files)
        for key in npz.files:
            want, got = np.asarray(h5[key]), npz[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_default_loaders_read_npz_without_h5py():
    """The main path's loaders never import h5py."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['h5py'] = None\n"
            "from cloudsc_tpu.data import (default_input_path, "
            "default_reference_path, load_input, load_reference)\n"
            "inp = load_input(default_input_path(), ngptot=300)\n"
            "ref = load_reference(default_reference_path(), ngptot=300)\n"
            "assert inp.fields['PT'].shape == (137, 300)\n"
            "assert ref['PLUDE'].shape == (137, 300)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

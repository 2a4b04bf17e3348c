"""Input/reference I/O facade.

Loads the CLOUDSC input state from a NumPy .npz snapshot (the default, read
with NumPy alone), an HDF5 mirror (input.h5, needs h5py) or directly from the
raw Serialbox archive (data/*.dat), mirroring the reference's compile-time
HDF5/Serialbox switch at runtime (ref: src/common/module/file_io_mod.F90:49-72).
The .npz and .h5 snapshots hold the same arrays under the same names
(tools/h52npz.py). Arrays are returned in the HDF5-mirror layout: (lev, col),
(nclv, lev, col), (lev+1, col) — level-major with columns on the trailing
axis, the contiguous one.

Reference outputs come from config-files/reference.h5
(dataset list: ref src/common/module/cloudsc_global_state_mod.F90:288-321).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from pathlib import Path

import numpy as np

from .expand import expand_field
from .serialbox import load_input_archive

# Input fields consumed by the kernel, in the reference load order
# (ref: cloudsc_global_state_mod.F90:188-227).
INPUT_FIELDS = [
    "PLCRIT_AER", "PICRIT_AER", "PRE_ICE", "PCCN", "PNICE",
    "PT", "PQ",
    "PVFA", "PVFL", "PVFI", "PDYNA", "PDYNL", "PDYNI",
    "PHRSW", "PHRLW", "PVERVEL", "PAP", "PAPH",
    "PLSM", "LDCUM", "KTYPE",
    "PLU", "PLUDE", "PSNDE", "PMFU", "PMFD",
    "PA", "PCLV", "PSUPSAT",
    "TENDENCY_CML_T", "TENDENCY_CML_Q", "TENDENCY_CML_A", "TENDENCY_CML_CLD",
    "TENDENCY_TMP_T", "TENDENCY_TMP_Q", "TENDENCY_TMP_A", "TENDENCY_TMP_CLD",
]

# Validated output datasets, in the reference validation order
# (ref: cloudsc_global_state_mod.F90:324-345).
REFERENCE_FIELDS = [
    "PLUDE", "PCOVPTOT", "PRAINFRAC_TOPRFZ",
    "PFSQLF", "PFSQIF", "PFCQLNG", "PFCQNNG",
    "PFSQRF", "PFSQSF", "PFCQRNG", "PFCQSNG",
    "PFSQLTUR", "PFSQITUR",
    "PFPLSL", "PFPLSN", "PFHPSL", "PFHPSN",
    "TENDENCY_LOC_A", "TENDENCY_LOC_Q", "TENDENCY_LOC_T", "TENDENCY_LOC_CLD",
]


# The repo ships the 100-column snapshot as .npz (and as the HDF5 mirrors it
# was converted from; the reference commits its .dat archive the same way) so
# tests/CI run on a clean checkout with no external data dependency.
_REPO_DATA = Path(__file__).resolve().parents[2] / "data"


def default_input_path() -> str:
    """Input archive resolution: $CLOUDSC_INPUT > the repo's snapshot."""
    return os.environ.get("CLOUDSC_INPUT") or str(_REPO_DATA / "input.npz")


def default_reference_path() -> str:
    """Golden-output resolution: $CLOUDSC_REFERENCE > the repo's snapshot."""
    return (os.environ.get("CLOUDSC_REFERENCE")
            or str(_REPO_DATA / "reference.npz"))


@contextlib.contextmanager
def _snapshot(path: str | Path):
    """name -> array mapping of a .npz or .h5 snapshot file. Only the .h5
    mirrors need h5py, which is imported here and nowhere on the main path."""
    if Path(path).suffix == ".h5":
        import h5py

        with h5py.File(path, "r") as f:
            yield f
    else:
        with np.load(path) as z:
            yield z


@dataclasses.dataclass
class InputData:
    """The full kernel input: fields expanded to ngptot columns + global scalars."""

    fields: dict          # name -> np.ndarray, trailing axis = columns (ngptot)
    scalars: dict         # all 173 global scalars from the archive
    klon_file: int        # columns in the snapshot (100)
    klev: int             # vertical levels (137)
    ngptot: int           # expanded column count
    ptsphy: float         # physics timestep

    def astype(self, dtype) -> "InputData":
        fields = {
            k: (v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in self.fields.items()
        }
        return dataclasses.replace(self, fields=fields)


def _load_raw(path: str | Path,
              col_slice: tuple[int, int] | None = None) -> tuple[dict, dict]:
    """Load (fields, scalars) from a .npz/.h5 file or a Serialbox directory.

    `col_slice=(start, count)` restricts per-column fields to that column
    range via true hyperslab reads — only the rank's slice ever leaves the
    file (ref: file_io_mod.F90:158-235 load_array start/count)."""
    path = Path(path)
    if path.is_dir():
        return load_input_archive(path, "input", col_slice=col_slice)

    fields, scalars = {}, {}
    with _snapshot(path) as f:
        for k in f.keys():
            if f[k].shape == (1,):
                v = f[k][0]
                scalars[k] = v.item() if hasattr(v, "item") else v
        klon = int(scalars.get("KLON", -1))
        for k in f.keys():
            ds = f[k]
            if ds.shape == (1,):
                continue
            if col_slice is not None and ds.shape[-1] == klon:
                start, count = col_slice
                fields[k] = np.asarray(ds[..., start:start + count])
            else:
                fields[k] = np.asarray(ds)
    return fields, scalars


def _peek_klon(path: str | Path) -> int:
    """The snapshot's column count, read without touching any field data."""
    path = Path(path)
    if path.is_dir():
        from .serialbox import SerialboxArchive

        return int(SerialboxArchive(path, "input").global_scalars()["KLON"])
    with _snapshot(path) as f:
        return int(f["KLON"][0])


def load_input(path: str | Path, ngptot: int | None = None,
               ngptotg: int | None = None, rank: int = 0,
               nranks: int = 1, expand: bool = True) -> InputData:
    """Load the input snapshot and expand to ngptot columns.

    `path` may be the reference's data/ directory (raw Serialbox archive) or an
    input.h5 mirror. Expansion tiles the file columns cyclically
    (ref: expand_mod.F90:237-334). In a multi-host run pass this host's
    (rank, nranks) and the global column count ngptotg: a true per-rank slice
    of the file columns is taken only when the file holds at least ngptotg
    columns — otherwise every rank loads (and tiles) the same columns, which
    keeps distributed results bitwise-comparable to single-host ones
    (ref: expand_mod.F90:30-46, README.md:167-175).
    """
    from .expand import get_offsets

    # this rank's column slice is decided BEFORE the read, so only the slice
    # is ever loaded from the archive (the hyperslab reads of
    # file_io_mod.F90:158-235, not load-everything-then-slice)
    klon = _peek_klon(path)
    ngptot = ngptot or klon
    start, count = get_offsets(klon, ngptot, ngptotg or ngptot, rank, nranks)
    col_slice = (start, count) if (start, count) != (0, klon) else None
    raw_fields, scalars = _load_raw(path, col_slice=col_slice)
    klev = int(scalars["KLEV"])
    fields = {}
    for name in INPUT_FIELDS:
        # expand=False defers the cyclic expansion to the consumer
        # (make_inputs / the fused native packer) — at benchmark sizes the
        # expanded fp64 dict is gigabytes the packed path never needs
        fields[name] = (expand_field(raw_fields[name], ngptot) if expand
                        else raw_fields[name])
    # Parameter tables stored as fields, not per-column data — no expansion
    # (ref: yoecldp.F90:358-366 loads YRECLDP_RBETA(0:100)).
    for name in ("YRECLDP_RBETA", "YRECLDP_RBETAP1"):
        if name in raw_fields:
            fields[name] = raw_fields[name]
    return InputData(
        fields=fields,
        scalars=scalars,
        klon_file=klon,
        klev=klev,
        ngptot=ngptot,
        ptsphy=float(scalars["PTSPHY"]),
    )


def load_reference(path: str | Path, ngptot: int | None = None,
                   ngptotg: int | None = None, rank: int = 0,
                   nranks: int = 1) -> dict:
    """Load the golden outputs (reference.npz or .h5), optionally expanded
    to ngptot.

    Multi-host runs pass (rank, nranks, ngptotg): the reference columns are
    sliced with the SAME get_offsets rule as the input, so each rank validates
    its own slice against the matching golden columns (the reference reloads
    the golden through the identical LOAD_AND_EXPAND path,
    ref: cloudsc_global_state_mod.F90:288-321).
    """
    from .expand import get_offsets

    out = {}
    with _snapshot(path) as f:
        for name in REFERENCE_FIELDS:
            ds = f[name]
            if ngptot is None:
                out[name] = np.asarray(ds)
                continue
            klon = ds.shape[-1]
            start, count = get_offsets(klon, ngptot, ngptotg or ngptot,
                                       rank, nranks)
            if (start, count) != (0, klon):  # hyperslab read of the slice
                arr = np.asarray(ds[..., start:start + count])
            else:
                arr = np.asarray(ds)
            out[name] = expand_field(arr, ngptot)
    return out


def write_h5(path: str | Path, fields: dict, scalars: dict | None = None) -> None:
    """Snapshot fields (+ scalars as shape-(1,) datasets) to HDF5.

    This program's equivalent of the reference's Serialbox write hooks used to
    regenerate goldens (ref: src/prototype1/support/serialize_mod.F90:62-130,
    serialbox2hdf5/serialbox2hdf5.py:41-48).
    """
    import h5py

    with h5py.File(path, "w") as f:
        for name, arr in fields.items():
            arr = np.asarray(arr)
            kw = {"compression": "gzip", "compression_opts": 6} \
                if arr.size > 256 else {}
            f.create_dataset(name, data=arr, **kw)
        for name, val in (scalars or {}).items():
            f.create_dataset(name, shape=(1,), data=np.array([val]))

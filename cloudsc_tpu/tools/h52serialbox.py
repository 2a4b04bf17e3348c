"""HDF5 mirror -> Serialbox "Binary" archive converter (inverse of serialbox2h5).

The reference regenerates its own Serialbox archives from a prototype1 run via
env-gated write hooks (ref: src/prototype1/support/serialize_mod.F90:62-130,
README.md:199-205). This is this framework's equivalent write path: it turns
an input.h5/reference.h5-style snapshot (as written by data.io.write_h5 or the
shipped mirrors) back into the raw archive the reference consumes —
<prefix>_<FIELD>.dat column-major dumps + MetaData-<prefix>.json +
ArchiveMetaData-<prefix>.json (ref: data/MetaData-input.json,
data/ArchiveMetaData-input.json "archive_name": "Binary").

Layout inversion: the h5 mirrors store fields with reversed dims in C order
(ref: serialbox2hdf5/serialbox2hdf5.py:35-48); the .dat files store the
original Fortran dims column-major. Reversing the dims and the memory order
cancel out, so a mirror's C-order flat byte stream IS the original
column-major dump and field round trips are bitwise (tests/test_tools.py
pins generated .dat == reference .dat).

Checksum caveat: the fields_table checksums are written as uppercase SHA-256
of the .dat bytes in Serialbox's unpadded per-byte hex style. Serialbox's
in-library hash is a nonstandard internal implementation we deliberately do
not reproduce; neither this package's reader nor the reference's archive
READ path compares checksums, they are bookkeeping only.

Usage:
    python -m cloudsc_tpu.tools.h52serialbox input.h5 outdir/ [--prefix input]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

# Serialbox TypeID values (ref: data/MetaData-input.json type_id fields:
# LDCUM=1 bool, KTYPE=2 int32, PT=5 float64, __name=6 string)
_TYPE_IDS = {
    np.dtype(np.bool_): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.float32): 4,
    np.dtype(np.float64): 5,
}
_ELEMENT_NAMES = {
    np.dtype(np.bool_): "bool",
    np.dtype(np.int32): "int",
    np.dtype(np.int64): "int",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}


def _scalar_entry(val):
    """global_meta_info record for one scalar (type_id by python type)."""
    if isinstance(val, (bool, np.bool_)):
        return {"type_id": 1, "value": bool(val)}
    if isinstance(val, (int, np.integer)):
        return {"type_id": 2, "value": int(val)}
    if isinstance(val, (float, np.floating)):
        return {"type_id": 5, "value": float(val)}
    return {"type_id": 6, "value": str(val)}


def _field_meta(name: str, dims: tuple[int, ...], dtype: np.dtype) -> dict:
    """field_map record mirroring the reference archive's meta_info shape."""
    sizes = list(dims) + [0] * (4 - len(dims))
    mi = {
        "__bytesperelement": {"type_id": 2, "value": int(dtype.itemsize)},
        "__elementtype": {"type_id": 6, "value": _ELEMENT_NAMES[dtype]},
    }
    for axis, size in zip("ijkl", sizes):
        mi[f"__{axis}minushalosize"] = {"type_id": 2, "value": 0}
        mi[f"__{axis}plushalosize"] = {"type_id": 2, "value": 0}
        mi[f"__{axis}size"] = {"type_id": 2, "value": int(size)}
    mi["__name"] = {"type_id": 6, "value": name}
    mi["__rank"] = {"type_id": 2, "value": len(dims)}
    # key order: bytesperelement, elementtype, then the i/j/k/l triples
    # alphabetically, then name/rank — matches the reference file's sorting
    mi = dict(sorted(mi.items()))
    return {"dims": [int(d) for d in dims], "meta_info": mi,
            "type_id": _TYPE_IDS[dtype]}


def _checksum(data: bytes) -> str:
    # unpadded per-byte uppercase hex (the reference files' variable-length
    # style); see module docstring for why the digest itself is standard
    return "".join(f"{b:X}" for b in hashlib.sha256(data).digest())


def convert(h5_path: str, out_dir: str, prefix: str = "input",
            verify: bool = True) -> int:
    import h5py

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    # shape-(1,) datasets are global scalars — that is the h5-mirror
    # contract (write_h5 stores scalars as shape-(1,); every genuine field
    # in the CLOUDSC data contract has >=100 columns, SURVEY.md appendix A).
    # A hypothetical 1-element FIELD would be misclassified here, so the
    # count line below makes the split visible for eyeballing.
    fields: dict[str, np.ndarray] = {}
    scalars: dict[str, object] = {}
    with h5py.File(h5_path, "r") as f:
        for name in f:
            arr = np.asarray(f[name])
            if arr.shape == (1,):
                scalars[name] = arr[0]
            else:
                fields[name] = arr

    field_map = {}
    fields_table = {}
    for name in sorted(fields):
        arr = fields[name]
        # h5 mirror layout (reversed dims, C order) -> original Fortran dump:
        # the mirror's C-order flat stream IS the original column-major
        # stream (reversing the dims and the memory order cancel out)
        dims = tuple(reversed(arr.shape)) if arr.ndim > 1 else arr.shape
        raw = np.ascontiguousarray(arr).tobytes()
        path = out / f"{prefix}_{name}.dat"
        path.write_bytes(raw)
        field_map[name] = _field_meta(name, dims, arr.dtype)
        fields_table[name] = [[0, _checksum(raw)]]

    meta = {
        "field_map": field_map,
        "global_meta_info": {k: _scalar_entry(scalars[k])
                             for k in sorted(scalars)},
        "prefix": prefix,
        "savepoint_vector": {
            "fields_per_savepoint": [
                {prefix: {name: 0 for name in sorted(fields)}}
            ],
            "savepoints": [{"meta_info": None, "name": prefix}],
        },
        "serialbox_version": 255,
    }
    with open(out / f"MetaData-{prefix}.json", "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    archive = {
        "archive_name": "Binary",
        "archive_version": 0,
        "fields_table": fields_table,
        "serialbox_version": 255,
    }
    with open(out / f"ArchiveMetaData-{prefix}.json", "w") as f:
        json.dump(archive, f, indent=1, sort_keys=True)
    print(f"wrote {len(fields)} fields + {len(scalars)} scalars -> {out}/")

    if verify:  # re-read with the package reader and compare to the source
        from ..data.serialbox import load_input_archive

        back_fields, back_scalars = load_input_archive(out, prefix)
        for name, arr in fields.items():
            if not np.array_equal(back_fields[name], arr):
                print(f"VERIFY FAILED for field {name}", file=sys.stderr)
                return 1
        for name, val in scalars.items():
            got = back_scalars[name]
            if got != val and not (
                isinstance(val, (float, np.floating)) and np.isclose(got, val)
            ):
                print(f"VERIFY FAILED for scalar {name}", file=sys.stderr)
                return 1
        print("verify pass: OK")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="h52serialbox",
        description="Convert an HDF5 mirror back to a Serialbox Binary archive",
    )
    p.add_argument("input", help="source .h5 path")
    p.add_argument("outdir", help="output archive directory")
    p.add_argument("--prefix", default="input",
                   help="archive prefix (default: input)")
    p.add_argument("--no-verify", action="store_true")
    a = p.parse_args(argv)
    return convert(a.input, a.outdir, a.prefix, verify=not a.no_verify)


if __name__ == "__main__":
    sys.exit(main())

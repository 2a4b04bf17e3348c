"""HDF5 mirror -> NumPy .npz converter.

The program reads its snapshots as .npz (NumPy alone, no HDF5 library). This
tool writes one from an input.h5/reference.h5 mirror: one array per dataset,
same names, shapes and dtypes, the shape-(1,) scalars included, and verifies
the result bitwise.

Usage:
    python -m cloudsc_tpu.tools.h52npz data/input.h5 data/input.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def convert(h5_path: str, out_path: str) -> int:
    import h5py

    with h5py.File(h5_path, "r") as f:
        arrays = {k: np.asarray(f[k]) for k in f.keys()}
    np.savez_compressed(out_path, **arrays)
    with np.load(out_path) as back:
        for name, arr in arrays.items():
            got = back[name]
            if got.dtype != arr.dtype or not np.array_equal(got, arr):
                print(f"VERIFY FAILED for {name}", file=sys.stderr)
                return 1
    print(f"wrote {len(arrays)} arrays -> {out_path}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="h52npz", description=__doc__.split("\n")[0])
    p.add_argument("input", help="source .h5 path")
    p.add_argument("output", help="destination .npz path")
    a = p.parse_args(argv)
    return convert(a.input, a.output)


if __name__ == "__main__":
    sys.exit(main())

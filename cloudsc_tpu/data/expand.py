"""Column expansion + per-host slicing.

Replicates the reference "expand" semantics (ref: src/common/module/expand_mod.F90):
the input snapshot holds KLON (=100) columns; benchmark sizes NGPTOT >> KLON are
produced by tiling the snapshot columns cyclically. When the requested global size
exceeds the file size, every rank/host loads the *same* 100 columns (ref:
expand_mod.F90:37-43, README.md:167-175) — which keeps multi-host results bitwise
comparable to single-host runs and is preserved here as the multi-chip test fixture.

Unlike the reference we do not reshape into (NPROMA, ..., NBLOCKS) blocks: the
column axis stays flat and contiguous; XLA and the fused kernel block it.
"""

from __future__ import annotations

import numpy as np


def get_offsets(klon_file: int, ngptot: int, ngptotg: int, rank: int, nranks: int):
    """Per-rank (start, count) into the file columns.

    True distribution only when the file has at least NGPTOTG columns; otherwise
    every rank reads the full file and tiles it (ref: expand_mod.F90:30-46).

    The stride matches the reference exactly: every rank starts at
    rank * ceil(ngptotg / nranks) — the same share rule the entry point uses to
    size NGPTOT (ref: expand_mod.F90:37-43, dwarf_cloudsc.F90:74-77) — so the
    union of rank slices covers columns [0, ngptotg) with no gap or overlap.
    """
    if klon_file >= ngptotg:
        share = (ngptotg - 1) // nranks + 1
        start = rank * share
        return start, min(klon_file, ngptot)
    return 0, klon_file


def expand_field(field: np.ndarray, ngptot: int,
                 order: str = "cyclic") -> np.ndarray:
    """Tile the trailing (column) axis out to ngptot columns.

    order="cyclic" matches the reference expansion (dst col j <- src col
    j % klon; ref: expand_mod.F90:237-334; python twin
    src/cloudsc_python/src/cloudscf2py/inputs.py:23-34). Large expansions go
    through the threaded C++ path (the analogue of the reference's
    OpenMP-parallel EXPAND); numpy otherwise.

    order="grouped" writes every source column's copies contiguously — a
    column PERMUTATION of the cyclic layout (same multiset; see
    group_inverse for the mapping back), used to make the Pallas kernel's
    column tiles homogeneous so per-tile dynamic skips fire at per-column
    granularity.
    """
    klon = field.shape[-1]
    if klon == ngptot:
        return field
    if field.size * (ngptot // max(klon, 1)) > (1 << 20):
        from ..native import expand_native

        out = expand_native(field, ngptot, grouped=(order == "grouped"))
        if out is not None:
            return out
    if order == "grouped":
        return np.ascontiguousarray(
            np.repeat(field, group_counts(klon, ngptot), axis=-1)
        )
    reps = -(-ngptot // klon)  # ceil
    tiled = np.tile(field, (1,) * (field.ndim - 1) + (reps,))
    return np.ascontiguousarray(tiled[..., :ngptot])


def group_counts(klon: int, ncol: int) -> np.ndarray:
    """Multiplicity of each source column in the cyclic expansion to ncol:
    count_g = |{j in [0, ncol): j % klon == g}| = ceil((ncol - g) / klon)."""
    g = np.arange(klon, dtype=np.int64)
    return np.maximum(0, -(-(ncol - g) // klon))


def group_inverse(klon: int, ncol: int,
                  perm: np.ndarray | None = None) -> np.ndarray:
    """inv mapping canonical (cyclic) column j to a grouped-layout column
    holding the same source column (the first member of group j % klon).
    Copies of a source column are bitwise-identical through the scheme
    (columns are independent and the dynamic skips are value-exact), so
    gathering grouped outputs with inv reconstructs the canonical outputs
    exactly.

    `perm` is the optional source-column permutation applied BEFORE the
    grouped expansion (activity sorting): group position p then holds
    source perm[p], and inv routes each canonical column to its source's
    position. Requires ncol >= klon so every source has at least one copy
    (position counts are position-based, not source-based)."""
    counts = group_counts(klon, ncol)
    off = np.concatenate([[0], np.cumsum(counts[:-1])])
    if perm is not None:
        if ncol < klon:
            raise ValueError("sorted grouping requires ncol >= klon")
        pos = np.empty(klon, dtype=np.int64)
        pos[np.asarray(perm, dtype=np.int64)] = np.arange(klon, dtype=np.int64)
        off = off[pos]
    return off[np.arange(ncol, dtype=np.int64) % klon].astype(np.int32)


def activity_perm(pclv: np.ndarray, tcld: np.ndarray, ptsphy: float,
                  rlmin: float, nshards: int = 1) -> np.ndarray:
    """Ascending-activity ordering of the source columns (an argsort, so a
    pure permutation — bitwise-neutral through the scheme for ANY key).

    Key: project the start-of-step condensates (PCLV + dt * TENDENCY_TMP_CLD,
    the section-1 state, ref: cloudsc.F90:669-682), mark levels whose total
    condensate exceeds RLMIN, and order by (levels from the topmost active
    level to the bottom, number of active levels), MOST active first.
    Falling precipitation keeps a column's levels BELOW its topmost
    condensate busy (flux carries, ref: 2698-2702 -> 1720-1726), so
    top-active span tracks the per-level guard activity better than the
    active-level count alone. Clear columns (span 0) sort LAST and pack
    into fully-inert tiles — descending so the tile edge-padding, which
    replicates the final column, duplicates the least-active one.

    With tiles laid out over the grouped (contiguous-copies) expansion this
    makes each tile's few distinct sources have SIMILAR activity profiles,
    pushing the per-tile dynamic-skip rate to the per-column ceiling
    (plain source order leaves tiles mixing adjacent snapshot columns).

    `nshards` > 1 (column-mesh runs: the layout is split contiguously over
    the devices by shard_fields) deals the sorted sources round-robin
    across the shards so every device receives a similar activity mix —
    a fully contiguous sort would hand one device all the busy columns and
    make it the SPMD straggler. Within a shard, stride-nshards neighbors
    still have near-identical activity rank, so tiles stay clustered."""
    q = np.asarray(pclv, np.float64)[:4] + float(ptsphy) * np.asarray(
        tcld, np.float64
    )[:4]
    act = np.maximum(q, 0.0).sum(axis=0) > rlmin        # (nlev, klon)
    nlev = act.shape[0]
    first = np.where(act.any(axis=0), act.argmax(axis=0), nlev)
    span = nlev - first
    order = np.lexsort((act.sum(axis=0), span))[::-1].astype(np.int64)
    if nshards > 1:
        order = np.concatenate([order[s::nshards] for s in range(nshards)])
    return order


def pad_columns(field: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Zero-pad the trailing column axis to a multiple.

    Mirrors the reference's zero-padded tail block (ref: expand_mod.F90:264-265);
    returns (padded, original_ncol).
    """
    ncol = field.shape[-1]
    target = -(-ncol // multiple) * multiple
    if target == ncol:
        return field, ncol
    pad = [(0, 0)] * (field.ndim - 1) + [(0, target - ncol)]
    return np.pad(field, pad), ncol

"""Per-(column, level) guard-activity analysis for the dynamic fast paths.

The dynamic skips (`scheme.inert_skip`, the 5.2.1 no-overshoot cond) fire
only when a guard is False for EVERY column in the batch — the fused
kernel's block of BLOCK columns. The benchmark expansion tiles the 100
snapshot columns cyclically (ref: expand_mod.F90:237-334), so every block
mixes up to BLOCK distinct columns and the skip rate approaches the
whole-snapshot rate. This probe measures, per guard:

  - active fraction over (level, column) work units   (the best any
    per-column schedule could reach)
  - fraction of levels with ANY active column         (today's skip rate)
  - per-column level-activity histogram               (how much an
    activity-sorted column permutation would recover)

Runs the scan engine EAGERLY (Python-loop scan) at 100 columns fp64 on CPU
with `scheme.probe_hook` capturing concrete masks. ~2 min.

Usage: python bench/activity_probe.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from cloudsc_tpu.data import default_input_path, load_input
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import cloudsc, make_inputs, scheme


def pyscan(f, init, xs, **kw):
    carry = init
    ys_list = []
    n = np.asarray(xs).shape[0] if not isinstance(xs, (list, tuple)) else None
    assert n is not None
    for i in range(n):
        x = jax.tree_util.tree_map(lambda a: a[i], xs)
        carry, y = f(carry, x)
        ys_list.append(y)
    ys = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys_list)
    return carry, ys


def tile_rates(a: np.ndarray, inp, params, ngptot: int = 163840,
               tile: int = 128, nshards: int = 1) -> dict:
    """Predicted per-tile activity rate (fraction of (tile, level) units
    where ANY column in the tile is active — the rate the kernel's lax.cond
    actually fires at) for each column layout, from the recorded
    per-(level, source) masks. Pure host model of the real tiling."""
    from cloudsc_tpu.data.expand import activity_perm, group_counts

    nlev, klon = a.shape
    counts = group_counts(klon, ngptot)
    out = {}
    for name in ("cyclic", "grouped", "sorted"):
        if name == "cyclic":
            src = np.arange(ngptot, dtype=np.int64) % klon
        else:
            perm = np.arange(klon, dtype=np.int64)
            if name == "sorted":
                perm = activity_perm(
                    inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                    inp.ptsphy, params.ydecldp.rlmin, nshards=nshards,
                )
            src = np.repeat(perm, counts)
        # edge-pad to whole tiles exactly like the kernel wrapper
        target = -(-ngptot // tile) * tile
        src = np.concatenate([src, np.full(target - ngptot, src[-1])])
        ntile = target // tile
        per_tile = a[:, src.reshape(ntile, tile)]        # (nlev, ntile, tile)
        out[name] = float(per_tile.any(axis=2).mean())
    return out


def record_masks(inp, params, cache_dir=None):
    """Concrete per-(level, source-column) guard masks from one eager fp64
    scan at 100 columns; cached to disk. The masks depend only on the
    snapshot + wired scheme (not on any layout parameter), so the cache is
    keyed on the scheme source and the active skip config — editing
    scheme.py invalidates it."""
    import hashlib
    import inspect

    key = hashlib.sha256()
    key.update(inspect.getsource(scheme).encode())
    key.update(str(inp.ptsphy).encode())
    cache = os.path.join(
        cache_dir, f"cloudsc_activity_masks_{key.hexdigest()[:16]}.npz"
    ) if cache_dir else None
    if cache and os.path.exists(cache):
        with np.load(cache) as z:
            return {k: z[k] for k in z.files}

    fields = make_inputs(inp, dtype=jnp.float64)
    records = {}  # tag -> list of (ncol,) bool arrays, one per level

    def hook(tag, mask):
        records.setdefault(tag, []).append(np.asarray(mask))

    def pycond(pred, true_fn, false_fn, *ops):
        # eager branch execution so nested probe hooks see concrete masks
        return true_fn(*ops) if bool(pred) else false_fn(*ops)

    orig_scan, orig_cond, orig_hook = jax.lax.scan, jax.lax.cond, scheme.probe_hook
    jax.lax.scan = pyscan
    jax.lax.cond = pycond
    scheme.probe_hook = hook
    try:
        out = cloudsc(fields, params, inp.ptsphy)
        assert np.isfinite(np.asarray(out.tendency_loc_t)).all()
    finally:
        jax.lax.scan = orig_scan
        jax.lax.cond = orig_cond
        scheme.probe_hook = orig_hook

    nlev_scanned = max(len(v) for v in records.values())
    stacked = {}
    for tag, masks in records.items():
        a = np.stack(masks)  # (levels recorded, ncol)
        if a.shape[0] < nlev_scanned:
            # nested guard: unrecorded levels had the enclosing branch
            # skipped, so this guard was all-False there (guard subset)
            pad = np.zeros((nlev_scanned - a.shape[0], a.shape[1]), bool)
            a = np.concatenate([a, pad])  # position is irrelevant to stats
        stacked[tag] = a
    if cache:
        np.savez_compressed(cache, **stacked)
    return stacked


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, nargs="+", default=[128],
                    help="kernel column-block widths to model")
    ap.add_argument("--nshards", type=int, default=1,
                    help="model the shard-dealt sorted layout for N shards")
    args = ap.parse_args()

    inp = load_input(default_input_path(), ngptot=100)
    params = Params.from_input(inp)
    records = record_masks(inp, params)
    # Under the grouped (homogeneous-tile) layout a tile runs a section iff
    # its single distinct column is active at that level, so the per-work-
    # unit active fraction IS the grouped-layout skip ceiling.
    print(f"{'guard':>8} {'lev x col act%':>15} {'any-col lev act%':>17}")
    for tag, a in records.items():
        frac_work = a.mean()
        frac_levels_any = a.any(axis=1).mean()
        print(f"{tag:>8} {100 * frac_work:>14.1f}% {100 * frac_levels_any:>16.1f}%")
        per_col = a.mean(axis=0)
        p25, p50, p75 = np.percentile(per_col, [25, 50, 75])
        print(f"{'':>8} per-column active-level fraction: "
              f"min {per_col.min():.2f}  p25 {p25:.2f}  "
              f"median {p50:.2f}  p75 {p75:.2f}  "
              f"max {per_col.max():.2f}  ncols-fully-inert "
              f"{(per_col == 0).sum()}")
        for block in args.block:
            rates = tile_rates(a, inp, params, tile=block,
                               nshards=args.nshards)
            print(f"{'':>8} predicted {block}-column block fire rate at "
                  f"160K cols: "
                  + "  ".join(f"{k} {100 * v:.1f}%" for k, v in rates.items()))


if __name__ == "__main__":
    main()

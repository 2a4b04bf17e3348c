"""Benchmark sweep harness — the JUBE analogue.

The reference drives parameter sweeps with JUBE, scraping the timer/validator
stdout with regex patternsets (ref: benchmark/cloudsc.yml,
benchmark/include/include_patternset.yml:162-173). This does the same natively:
runs the CLI over a (ngptot x nproma x kernel) grid, parses the identical table
formats, and emits a summary table + results.json.

Usage:
    python bench/sweep.py [--ngptot 16384 65536 163840] [--nproma 64 128]
        [--kernel triton scan] [--iterations 3] [--out results.json]
    python bench/sweep.py --weak-scaling 1 2 4   # GPUs per mesh
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).parent.parent

# the same scrape targets JUBE uses (ref: include_patternset.yml:162-173)
RE_TOTAL = re.compile(
    r"^\s*\d+\s*x\s*\d+\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+-1\s*:"
    r"\s*(\d+)\s+(\d+)\s+(\d+)\s*:\s*TOTAL$"
)
RE_DEVICE = re.compile(
    r"device compute:\s*([0-9.]+) ms \| h2d:\s*([0-9.]+) ms \| "
    r"d2h:\s*([0-9.]+) ms \| compile:\s*([0-9.]+) s"
)
RE_FLAGGED = re.compile(r"!!!!\s*$")


def run_case(ngptot: int, nproma: int, kernel: str, iterations: int,
             validate: bool) -> dict:
    cmd = [
        sys.executable, "-m", "cloudsc_tpu", "1", str(ngptot), str(nproma),
        "--kernel", kernel, "--iterations", str(iterations),
    ]
    if not validate:
        cmd.append("--no-validate")
    proc = subprocess.run(
        cmd, capture_output=True, text=True, cwd=ROOT, timeout=1200,
    )
    rec = dict(ngptot=ngptot, nproma=nproma, kernel=kernel,
               iterations=iterations, rc=proc.returncode)
    flagged = 0
    for line in proc.stdout.splitlines():
        m = RE_TOTAL.match(line)
        if m:
            rec["time_ms"] = int(m.group(5))
            rec["mflops"] = int(m.group(6))
            rec["cols_per_s"] = int(m.group(7))
        m = RE_DEVICE.search(line)
        if m:
            rec["compute_ms"] = float(m.group(1))
            rec["h2d_ms"] = float(m.group(2))
            rec["d2h_ms"] = float(m.group(3))
            rec["compile_s"] = float(m.group(4))
        if RE_FLAGGED.search(line):
            flagged += 1
    rec["validation_flags"] = flagged
    if proc.returncode != 0:
        rec["stderr_tail"] = proc.stderr[-500:]
    return rec


def run_weak_scaling(device_counts, out_path: str) -> int:
    """Weak-scaling efficiency over mesh sizes (per-GPU cols/s at N GPUs vs
    the smallest mesh). Each point runs bench.py with CLOUDSC_BENCH_MESH=1 on
    the first N GPUs (CUDA_VISIBLE_DEVICES) and the workload scaled with the
    device count (bench.py does that itself), reporting cols/s PER GPU.
    """
    results = []
    for ndev in device_counts:
        env = dict(os.environ, CLOUDSC_BENCH_MESH="1",
                   CUDA_VISIBLE_DEVICES=",".join(map(str, range(ndev))))
        proc = subprocess.run(
            [sys.executable, str(ROOT / "bench.py")],
            capture_output=True, text=True, cwd=ROOT, timeout=1800, env=env,
        )
        rec = dict(ndev=ndev, rc=proc.returncode)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec.update(json.loads(line))
        if proc.returncode != 0:
            rec["stderr_tail"] = proc.stderr[-500:]
        results.append(rec)
        print(f"  ndev={ndev}: {rec.get('value', 'FAILED')} cols/s/GPU",
              flush=True)

    # the efficiency base is strictly the SMALLEST mesh size; if that run
    # failed, report no efficiencies rather than silently rebasing on a
    # larger mesh (which already carries scaling losses)
    smallest = min(results, key=lambda r: r["ndev"])
    base = smallest.get("value") if smallest["rc"] == 0 else None
    hdr = f"{'ndev':>5} {'cols/s/GPU':>14} {'efficiency':>11}"
    print("\n" + hdr + "\n" + "-" * len(hdr))
    for r in results:
        v = r.get("value")
        r["efficiency"] = round(v / base, 4) if (v and base) else None
        eff_s = f"{v / base:>10.1%}" if (v and base) else f"{'n/a':>10}"
        print(f"{r['ndev']:>5} {v if v else -1:>14} {eff_s}")
    if base is None:
        print(f"\nWARNING: ndev={smallest['ndev']} baseline run failed; "
              "efficiencies not computed")
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"\nwrote {out}")
    return 0 if all(r["rc"] == 0 for r in results) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="CLOUDSC benchmark sweep")
    p.add_argument("--ngptot", type=int, nargs="+",
                   default=[16384, 65536, 163840])
    p.add_argument("--nproma", type=int, nargs="+", default=[128])
    p.add_argument("--kernel", nargs="+", default=["triton", "scan"])
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--validate", action="store_true")
    p.add_argument("--out", default="bench/results.json")
    p.add_argument("--weak-scaling", type=int, nargs="+", metavar="NDEV",
                   default=None,
                   help="weak-scaling mode over these mesh sizes "
                        "(e.g. --weak-scaling 1 2 4)")
    a = p.parse_args(argv)

    if a.weak_scaling:
        return run_weak_scaling(a.weak_scaling, a.out)

    results = []
    for ng, npr, kern in itertools.product(a.ngptot, a.nproma, a.kernel):
        print(f"== ngptot={ng} nproma={npr} kernel={kern}", flush=True)
        rec = run_case(ng, npr, kern, a.iterations, a.validate)
        results.append(rec)
        print("   ", {k: rec.get(k) for k in
                      ("time_ms", "mflops", "cols_per_s", "rc")}, flush=True)

    hdr = f"{'ngptot':>8} {'nproma':>7} {'kernel':>7} {'ms':>8} {'MF/s':>10} {'col/s':>12}"
    print("\n" + hdr + "\n" + "-" * len(hdr))
    for r in results:
        print(f"{r['ngptot']:>8} {r['nproma']:>7} {r['kernel']:>7} "
              f"{r.get('time_ms', -1):>8} {r.get('mflops', -1):>10} "
              f"{r.get('cols_per_s', -1):>12}")

    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2))
    print(f"\nwrote {out}")
    return 0 if all(r["rc"] == 0 for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())

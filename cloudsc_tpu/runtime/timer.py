"""Performance timing + the reference's throughput table.

Reproduces the reference PERFORMANCE_TIMER report (ref:
src/common/module/timer_mod.F90:120-189): MFlop/s from the fixed HPM-derived
flop model ZHPM = 12,482,329 flops per 100 columns at L137 (ref: timer_mod.F90:26-27)
and columns/s, in the same column layout JUBE scrapes
(ref: benchmark/include/include_patternset.yml:162-173).

Here the "threads" of the reference map to devices; per-device rows are
reported with the device id in the tid column. GPU-style split timings
(kernel-only vs end-to-end with transfers, ref: README.md:311-318) are kept as
separate fields.
"""

from __future__ import annotations

import dataclasses
import time


# flops per 100 columns at 137 levels, measured with HPM on IBM P7
# (ref: src/common/module/timer_mod.F90:26-27)
ZHPM = 12482329.0


def _mycpu() -> int:
    """Core id of the calling thread (ref: src/common/module/mycpu.c:1-31)."""
    try:
        import os

        return os.sched_getcpu()
    except (AttributeError, OSError):
        return -1


def flops_for_columns(ncols: int) -> float:
    return ZHPM * (ncols / 100.0)


@dataclasses.dataclass
class Timings:
    compile_s: float = 0.0
    h2d_s: float = 0.0
    compute_s: float = 0.0
    d2h_s: float = 0.0
    energy_line: str | None = None  # EC_PMON report (None unless enabled)
    memory: object = None  # the step's compiled.memory_analysis()

    @property
    def total_s(self) -> float:
        return self.h2d_s + self.compute_s + self.d2h_s


class PerformanceTimer:
    """Wall-clock timer with per-device logging and the reference print format."""

    def __init__(self, ndevices: int = 1):
        self.ndevices = ndevices
        self.tstart = 0.0
        self.tend = 0.0
        self.device_time = [0.0] * ndevices
        self.device_cols = [0] * ndevices
        self.device_calls = [0] * ndevices

    def start(self):
        self.tstart = time.perf_counter()

    def end(self):
        self.tend = time.perf_counter()

    def log(self, device: int, seconds: float, ncols: int, ncalls: int = 1):
        self.device_time[device] += seconds
        self.device_cols[device] += ncols
        self.device_calls[device] += ncalls

    # -- report ---------------------------------------------------------------

    def performance_lines(self, nproma: int, ngpblks: int, ngptot: int,
                          numomp: int | None = None, rank: int = 0,
                          rank_rows=None, iterations: int = 1) -> list[str]:
        """The reference throughput table (ref: timer_mod.F90:169-187).

        `rank_rows` is the cross-process perf gather — (nprocs, 2) rows of
        (seconds, columns), one per rank (ref: timer_mod.F90:167) — printed as
        one extra row per rank; the TOTAL lines then report the global run.
        """
        numomp = numomp if numomp is not None else self.ndevices
        lines = [f" Reference MFLOP count for 100 columns : {1.0e-6 * ZHPM:12.8f}"]
        hdr = ("NUMOMP", "NGPTOT", "#GP-cols", "#BLKS", "NPROMA")
        lines.append(
            " " + "".join(f"{h:>10s}" for h in hdr) + f" {'tid#':>4s} : "
            + "".join(f"{h:>10s}" for h in ("Time(msec)", "MFlops/s", "col/s"))
        )

        def row(tag: int, tloc: float, cols: int, suffix: str) -> str:
            mflops = 1.0e-6 * ZHPM * (cols / 100.0) / tloc if tloc > 0 else 0.0
            thrput = cols / tloc if tloc > 0 else 0.0
            return (
                " " + f"{numomp:>10d}{ngptot:>10d}{cols:>10d}{ngpblks:>10d}"
                + f"{nproma:>10d} {tag:>4d} : {int(tloc * 1000):>10d}"
                + f"{int(mflops):>10d}{int(thrput):>10d} {suffix}"
            )

        for dev in range(self.ndevices):
            lines.append(row(
                dev, self.device_time[dev], self.device_cols[dev],
                f"@ rank#{rank}:device#{dev}:core#{_mycpu()}",
            ))
        nranks = 1
        if rank_rows is not None and len(rank_rows) > 1:
            nranks = len(rank_rows)
            for r, (tloc, cols) in enumerate(rank_rows):
                lines.append(row(r, float(tloc), int(cols), f"@ rank#{r}"))

        tdiff = self.tend - self.tstart
        # the timer span covers every iteration, so the TOTAL throughput
        # counts every processed column (the reference runs its block loop
        # once; `iterations` is this framework's repeat knob)
        gcols = ngptot * iterations
        if rank_rows is not None and len(rank_rows) > 1:
            tdiff = float(max(t for t, _ in rank_rows))
            gcols = int(sum(c for _, c in rank_rows))
        tot_ms = tot_mf = tot_cs = 0
        if tdiff > 0:
            tot_mf = int(1.0e-6 * ZHPM * (gcols / 100.0) / tdiff)
            tot_cs = int(gcols / tdiff)
            tot_ms = int(tdiff * 1000)
        lines.append(
            " " + f"{numomp:>10d}{ngptot:>10d}{sum(self.device_cols):>10d}"
            + f"{ngpblks:>10d}{nproma:>10d} {-1:>4d} : {tot_ms:>10d}"
            + f"{tot_mf:>10d}{tot_cs:>10d} : TOTAL @ rank#{rank}"
        )
        lines.append(
            " " + f"{nranks:>4d} x{numomp:>4d}{ngptot:>10d}{gcols:>10d}"
            + f"{ngpblks:>10d}{nproma:>10d} {-1:>4d} : {tot_ms:>10d}"
            + f"{tot_mf:>10d}{tot_cs:>10d} : TOTAL"
        )
        return lines

    def print_performance(self, nproma: int, ngpblks: int, ngptot: int,
                          numomp: int | None = None, rank: int = 0,
                          rank_rows=None, iterations: int = 1):
        print("\n".join(self.performance_lines(
            nproma, ngpblks, ngptot, numomp, rank=rank, rank_rows=rank_rows,
            iterations=iterations,
        )))

"""Energy/power monitoring — the EC_PMON analogue.

The reference samples Cray pm_counters during the block loop when the EC_PMON
env var is set (ref: src/common/module/ec_pmon_mod.F90:14-57,
cloudsc_driver_mod.F90:170-178). Most hosts have no Cray counters; this reads
the same Cray paths when present and falls back to Linux RAPL
(/sys/class/powercap) so CPU-side energy is still reported where available.
Disabled (returning None) unless EC_PMON is set, matching the reference.
"""

from __future__ import annotations

import os
from pathlib import Path

_CRAY_ENERGY = Path("/sys/cray/pm_counters/energy")
_CRAY_POWER = Path("/sys/cray/pm_counters/power")
_RAPL_GLOB = "intel-rapl:*"
_RAPL_ROOT = Path("/sys/class/powercap")


def enabled() -> bool:
    return bool(os.environ.get("EC_PMON"))


def _read_int(path: Path):
    try:
        return int(path.read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return None


def energy_power():
    """(energy_joules, power_watts) or None when disabled/unsupported."""
    if not enabled():
        return None
    if _CRAY_ENERGY.exists():
        e = _read_int(_CRAY_ENERGY)
        p = _read_int(_CRAY_POWER)
        if e is not None:
            return float(e), float(p or 0)
    if _RAPL_ROOT.is_dir():
        total_uj = 0
        found = False
        for pkg in sorted(_RAPL_ROOT.glob(_RAPL_GLOB)):
            v = _read_int(pkg / "energy_uj")
            if v is not None:
                total_uj += v
                found = True
        if found:
            return total_uj * 1e-6, 0.0
    return None


class EnergySampler:
    """Start/stop sampler printing the reference-style energy line."""

    def __init__(self):
        self._start = None

    def start(self):
        self._start = energy_power()

    def stop_and_report(self, prefix: str = " ") -> str | None:
        if self._start is None:
            return None
        now = energy_power()
        if now is None:
            return None
        de = now[0] - self._start[0]
        return f"{prefix}EC_PMON: energy delta {de:.1f} J, power {now[1]:.0f} W"

"""Energy monitor (the EC_PMON analogue, ref: ec_pmon_mod.F90:14-57)."""

import pytest

from cloudsc_tpu.runtime import pmon


def test_disabled_without_env(monkeypatch):
    monkeypatch.delenv("EC_PMON", raising=False)
    assert pmon.energy_power() is None
    s = pmon.EnergySampler()
    s.start()
    assert s.stop_and_report() is None


def test_enabled_reads_or_none(monkeypatch):
    monkeypatch.setenv("EC_PMON", "1")
    # on hosts without Cray counters/RAPL this is None; where counters exist
    # it must return (energy_J, power_W) floats
    r = pmon.energy_power()
    if r is not None:
        e, p = r
        assert e >= 0.0 and p >= 0.0


def test_driver_backend_validation():
    from cloudsc_tpu.runtime.driver import resolve_backend

    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("cuda")


def test_driver_samples_energy(monkeypatch, tmp_path, input_100, params):
    """driver.run must sample EC_PMON around the hot loop (the in-loop
    sampling of ref: cloudsc_driver_mod.F90:170-178) and surface the report
    in Timings. Counters are faked via the Cray paths."""
    import jax.numpy as jnp

    from cloudsc_tpu.runtime.driver import CloudscDriver

    e = tmp_path / "energy"
    p = tmp_path / "power"
    e.write_text("1000 J")
    p.write_text("50 W")
    monkeypatch.setenv("EC_PMON", "1")
    monkeypatch.setattr(pmon, "_CRAY_ENERGY", e)
    monkeypatch.setattr(pmon, "_CRAY_POWER", p)

    driver = CloudscDriver(params, input_100.ptsphy, dtype=jnp.float64,
                           nproma=16, backend="xla")
    _, timings, _ = driver.run(input_100)
    assert timings.energy_line is not None
    assert "EC_PMON" in timings.energy_line

"""Multi-step integration: CLOUDSC driven in a production-style timestep loop.

The dwarf benchmarks ONE physics step (ref: cloudsc_driver_mod.F90 calls
CLOUDSC once per block and validates); in the IFS the scheme runs every
timestep with the prognostic state advanced by its own tendencies. This
example closes that loop on-device: the whole N-step integration is a single
`lax.scan` inside one jit — no host round-trips between steps, the layout
(and with the fused kernel, the grouped column permutation) persists end to
end.

State advanced each step (what the IFS time-stepping applies):

    T      += dt * tendency_loc_t
    q      += dt * tendency_loc_q
    a      += dt * tendency_loc_a     (clipped to [0, 1])
    cld[m] += dt * tendency_loc_cld[m]

Everything else (dynamical/radiative/convective forcings, VDF fluxes,
supersaturation source) is held fixed — a "frozen large-scale forcing"
single-column experiment. The cumulative-tendency inputs TENDENCY_TMP are
zeroed after the first step: their step-1 values are the other IFS physics'
contributions baked into the snapshot, which CLOUDSC folds into its initial
state (ref: cloudsc.F90:662-682); repeating them every step would
double-apply that forcing.

    python examples/timestep_loop.py          # CPU fp64, 24 h at dt=3600 s

Prints the domain-mean surface precipitation and column water path per step,
plus a water-budget residual: the step's total moisture change against the
precipitation leaving through the surface (sedimentation flux divergence is
the only path out of the column).
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np

from cloudsc_tpu.data import default_input_path, load_input
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import cloudsc, make_inputs

NSTEPS = 24

STATE_KEYS = ("pt", "pq", "pa", "pclv", "tendency_tmp_t", "tendency_tmp_q",
              "tendency_tmp_a", "tendency_tmp_cld", "psupsat")


def column_weight(fields, params):
    """dp/g column-integral weight per level: kg water / m^2 per (kg/kg)."""
    return (fields["paph"][1:] - fields["paph"][:-1]) / params.ydcst.rg


def make_step(fields, params, dt):
    """The scan body advancing (T, q, a, cld) by CLOUDSC's own tendencies."""
    dpog = column_weight(fields, params)

    def step(state, _):
        f = dict(fields)
        f.update(state)
        out = cloudsc(f, params, dt, None)
        nxt = {
            "pt": f["pt"] + dt * out.tendency_loc_t,
            "pq": f["pq"] + dt * out.tendency_loc_q,
            "pa": jnp.clip(f["pa"] + dt * out.tendency_loc_a, 0.0, 1.0),
            "pclv": f["pclv"] + dt * out.tendency_loc_cld,
            # the snapshot's accumulated other-physics tendencies apply once
            "tendency_tmp_t": jnp.zeros_like(f["tendency_tmp_t"]),
            "tendency_tmp_q": jnp.zeros_like(f["tendency_tmp_q"]),
            "tendency_tmp_a": jnp.zeros_like(f["tendency_tmp_a"]),
            "tendency_tmp_cld": jnp.zeros_like(f["tendency_tmp_cld"]),
            "psupsat": jnp.zeros_like(f["psupsat"]),
        }
        # diagnostics: domain-mean surface precip (kg/m^2/s) and the total
        # condensate+vapour path of the advanced state (kg/m^2)
        sprecip = (out.pfplsl[-1] + out.pfplsn[-1]).mean()
        qtot = nxt["pq"] + nxt["pclv"][:4].sum(axis=0)
        wpath = (dpog * qtot).sum(axis=0).mean()
        diag = dict(sprecip=sprecip, wpath=wpath)
        return nxt, diag

    return step


def main():
    inp = load_input(default_input_path(), ngptot=100)
    params = Params.from_input(inp)
    dt = inp.ptsphy
    fields = make_inputs(inp, dtype=jnp.float64)
    dpog = column_weight(fields, params)
    step = make_step(fields, params, dt)

    state0 = {k: fields[k] for k in STATE_KEYS}

    @jax.jit
    def integrate(state):
        return jax.lax.scan(step, state, None, length=NSTEPS)

    final, diags = integrate(state0)
    sprecip = np.asarray(diags["sprecip"])
    wpath = np.asarray(diags["wpath"])

    q0 = np.asarray((dpog * (state0["pq"] + state0["pclv"][:4].sum(axis=0))
                     ).sum(axis=0).mean())
    print(f"{NSTEPS} steps x dt={dt:.0f} s, 100 columns, fp64 scan engine")
    print(f"{'step':>4} {'surf precip mm/day':>19} {'water path kg/m2':>17}")
    for i in range(NSTEPS):
        print(f"{i + 1:>4} {86400.0 * sprecip[i]:>19.4f} {wpath[i]:>17.6f}")

    # budget: water-path change over the run vs cumulative surface precip.
    # CLOUDSC's only external water SOURCE acting on the advanced state is
    # convective detrainment (PLUDE/PSNDE enter ZSOLQA diagonals,
    # ref: cloudsc.F90:1090-1127); the VDF/dynamics "tendencies" are frozen
    # forcings of the saturation budget, never applied to q directly. So
    #   change + surface precip ≈ detrainment put in each step,
    # and the (small) remainder is the supersat source and clipping terms.
    lost = float(dt * sprecip.sum())
    change = float(wpath[-1] - q0)
    src = change + lost
    print(f"\nwater budget over {NSTEPS} steps (domain mean, kg/m2):")
    print(f"  path change        {change:+.6e}")
    print(f"  precip to surface  {lost:+.6e}")
    print(f"  implied in-column source (detrainment + supersat) {src:+.3e}")
    assert src > -1e-9, "scheme destroyed water beyond roundoff"
    assert np.isfinite(sprecip).all() and np.isfinite(wpath).all()


if __name__ == "__main__":
    # config mutation only when run as a script — importers (the test suite)
    # pick the platform themselves and must not have it flipped at import
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    main()

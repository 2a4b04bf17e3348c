"""Gradient-based physics-parameter calibration and sensitivity.

The IFS tunes cloud-scheme parameters (erosion rates, RHcrit, autoconversion
thresholds — the TECLDP scalars, ref: src/common/module/yoecldp.F90:94-235)
by hand against observations; the dwarf ships no tangent-linear/adjoint code
for them. Here the whole scheme is differentiable, so parameter Jacobians are
one `jax.grad` through the scan engine — enabling gradient-based calibration.

    python examples/param_calibration.py        # CPU fp64, ~1 min

Two demos on the 100-column snapshot:
  1. a sensitivity table dJ/dlog(theta) for a handful of TECLDP parameters,
     where J is the mean-square T tendency (which parameters matter at all);
  2. recovery of a hidden RCLDIFF (turbulent erosion rate, used at
     scheme.py's section 3.4) from tendency "observations": start from a
     2x-perturbed value and descend dJ/dtheta back to the truth.

Parameters enter the scheme as plain scalars, so calibrating one is just
`copy(params)` with a traced value in place of the float (they are XLA
compile-time constants only when left as Python floats).
"""

import copy
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from cloudsc_tpu.data import default_input_path, load_input
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import cloudsc, make_inputs

# TECLDP scalars that enter the scheme arithmetically (not as trace-time
# Python branches), so a traced value flows straight through jax.grad
TUNABLE = ("rcldiff", "ramid", "rkooptau", "rtaumel", "rcovpmin")


def with_param(params: Params, name: str, value) -> Params:
    p = copy.copy(params)
    p.ydecldp = copy.copy(params.ydecldp)
    setattr(p.ydecldp, name, value)
    return p


def main() -> int:
    inp = load_input(default_input_path(), ngptot=100)
    params = Params.from_input(inp)
    fields = make_inputs(inp, dtype=jnp.float64)

    # --- 1. which parameters does the T tendency care about? -------------
    def j_of(name):
        def j(theta):
            out = cloudsc(fields, with_param(params, name, theta), inp.ptsphy)
            return jnp.mean(out.tendency_loc_t ** 2)
        return j

    print("sensitivity of J = mean(tendency_T^2) to TECLDP parameters")
    print(f"  {'param':<10} {'value':>12} {'dJ/dlog(theta)':>16}")
    for name in TUNABLE:
        theta0 = getattr(params.ydecldp, name)
        g = jax.jit(jax.grad(j_of(name)))(jnp.float64(theta0))
        print(f"  {name:<10} {theta0:>12.4e} {float(g) * theta0:>16.3e}")
    print("  (exact zeros are honest: that process never binds on this"
          " snapshot,\n   e.g. melting is mass-limited, so d/d rtaumel = 0)")

    # --- 2. recover a hidden RCLDIFF from tendency observations ----------
    true_theta = params.ydecldp.rcldiff
    obs = cloudsc(fields, params, inp.ptsphy)

    def misfit(theta):
        out = cloudsc(fields, with_param(params, "rcldiff", theta), inp.ptsphy)
        return (
            jnp.mean((out.tendency_loc_t - obs.tendency_loc_t) ** 2)
            + 1e6 * jnp.mean((out.tendency_loc_q - obs.tendency_loc_q) ** 2)
        )

    vg = jax.jit(jax.value_and_grad(misfit))
    # descend in log-space (the parameter is positive and scale-free)
    log_theta = jnp.log(jnp.float64(2.0 * true_theta))
    lr = 0.4
    print(f"\nrecovering RCLDIFF (truth {true_theta:.6e}) from a 2x start")
    for it in range(12):
        theta = jnp.exp(log_theta)
        val, g = vg(theta)
        log_theta = log_theta - lr * jnp.sign(g * theta)
        lr *= 0.62
        print(f"  it {it:2d}: theta {float(theta):.6e}  J {float(val):.3e}")
    final = float(jnp.exp(log_theta))
    rel = abs(final - true_theta) / true_theta
    print(f"  recovered {final:.6e}  (rel err {rel:.1e})")
    assert rel < 0.05, "calibration failed to re-approach the truth"

    # --- 3. perturbed-parameter ensemble in ONE compile (vmap) -----------
    # the PPE workflow (run the scheme under N parameter perturbations and
    # look at the output spread) is a single jit(vmap(...)) here — on a
    # device mesh the ensemble axis shards for free
    thetas = jnp.float64(true_theta) * jnp.geomspace(0.25, 4.0, 9)
    ens = jax.jit(jax.vmap(misfit))(thetas)
    print("\nperturbed-parameter ensemble (9 members, one compile):")
    for t, v in zip(np.asarray(thetas), np.asarray(ens)):
        print(f"  rcldiff {t:.3e} -> tendency misfit {v:.3e}")
    # the center member is rcldiff*(1 +- 1ulp of geomspace), so the misfit
    # is zero up to rounding of the parameter itself
    assert float(ens[4]) < 1e-25, "center member must reproduce the obs"
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Block-size / expansion invariance tests.

The reference's expansion tiles the 100 snapshot columns cyclically to any
NGPTOT (ref: expand_mod.F90), so per-column outputs at any size must equal the
100-column outputs replicated — the same property its MPI tests rely on
(ref: README.md:167-175). Column padding (the NPROMA analogue) must not
change unpadded results.
"""

import jax
import numpy as np


def _run(inp, params, dtype=None):
    import jax.numpy as jnp

    from cloudsc_tpu.physics import cloudsc, make_inputs

    fields = make_inputs(inp, dtype=dtype or jnp.float64)
    fn = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy))
    return jax.block_until_ready(fn(fields))


def test_expansion_replicates(input_100, params):
    from cloudsc_tpu.data import load_input
    from conftest import REFERENCE_DATA

    out100 = _run(input_100, params)
    inp250 = load_input(REFERENCE_DATA, ngptot=250)
    out250 = _run(inp250, params)
    for name in ("plude", "pfplsl", "tendency_loc_t", "prainfrac_toprfz"):
        a = np.asarray(getattr(out100, name))
        b = np.asarray(getattr(out250, name))
        # full replicas at the same vector alignment are bitwise identical
        np.testing.assert_array_equal(b[..., :100], b[..., 100:200])
        # the tail block and cross-shape comparisons see ulp-level variance
        # from XLA's per-lane vectorization (main loop vs remainder, FMA
        # contraction) — the physics is identical, the codegen is not
        np.testing.assert_allclose(b[..., 200:250], b[..., :50],
                                   rtol=1e-13, atol=0.0)
        np.testing.assert_allclose(b[..., :100], a, rtol=1e-13, atol=0.0)


def test_dynamic_skips_are_inert(input_100, params):
    """The dynamic fast paths must be value-exact, not approximations.

    Runs the scan engine with every `inert_skip`/no-overshoot branch forced
    to the active body (`SchemeConfig(dynamic_skips=False)`) and diffs
    against the production configuration at the same shape. Any skipped
    region that is not bitwise-inert shows up as a nonzero diff (identical
    shapes mean identical XLA codegen, so there is no ulp noise to hide
    behind).
    """
    import jax.numpy as jnp

    from cloudsc_tpu.physics import cloudsc, make_inputs
    from cloudsc_tpu.physics.scheme import SchemeConfig

    fields = make_inputs(input_100, dtype=jnp.float64)
    fast = jax.jit(lambda f: cloudsc(f, params, input_100.ptsphy))(fields)
    slow = jax.jit(
        lambda f: cloudsc(
            f, params, input_100.ptsphy,
            config=SchemeConfig(dynamic_skips=False),
        )
    )(fields)
    jax.block_until_ready((fast, slow))
    for name in ("plude", "pcovptot", "pfplsl", "pfplsn", "tendency_loc_t",
                 "tendency_loc_q", "tendency_loc_a", "tendency_loc_cld",
                 "prainfrac_toprfz", "pfhpsn", "pfsqlf", "pfcqnng"):
        a = np.asarray(getattr(fast, name))
        b = np.asarray(getattr(slow, name))
        diff = a - b
        assert np.all(diff == 0.0), (
            f"{name}: dynamic skip is not inert "
            f"(max abs diff {np.abs(diff).max()})"
        )


def test_dynamic_skips_inert_alternates_and_rain(input_100, params):
    """Inertness of the fast paths under the alternate scheme versions and
    under a synthetic RAINING state (the snapshot has no rain, so without it
    the rain sub-branch's active body would never be compared)."""
    import jax.numpy as jnp

    from cloudsc_tpu.physics import cloudsc, make_inputs
    from cloudsc_tpu.physics.scheme import SchemeConfig
    from test_scheme_versions import _raining_fields

    base = make_inputs(input_100, dtype=jnp.float64)
    rainy = _raining_fields(input_100, jnp.float64)
    cases = [
        (base, dict(iwarmrain=1)),
        (base, dict(ievapsnow=2)),
        (base, dict(idepice=2)),
        (rainy, {}),
        (rainy, dict(ievaprain=1)),
    ]
    for fields, kw in cases:
        fast = jax.jit(
            lambda f: cloudsc(f, params, input_100.ptsphy,
                              config=SchemeConfig(**kw))
        )(fields)
        slow = jax.jit(
            lambda f: cloudsc(f, params, input_100.ptsphy,
                              config=SchemeConfig(dynamic_skips=False, **kw))
        )(fields)
        jax.block_until_ready((fast, slow))
        for name in ("pcovptot", "pfplsl", "pfplsn", "tendency_loc_t",
                     "tendency_loc_q", "tendency_loc_cld"):
            diff = np.asarray(getattr(fast, name)) - np.asarray(
                getattr(slow, name)
            )
            assert np.all(diff == 0.0), (
                f"{name} not inert under {kw} "
                f"(max abs diff {np.abs(diff).max()})"
            )


def test_padding_invariance(input_100, params):
    """Padded tail columns must not perturb real columns."""
    from cloudsc_tpu.runtime.driver import CloudscDriver
    import jax.numpy as jnp

    out_plain = _run(input_100, params)
    driver = CloudscDriver(params, input_100.ptsphy, dtype=jnp.float64, nproma=64)
    out_pad, _, _ = driver.run(input_100)
    for name in ("plude", "pfplsn", "tendency_loc_q", "pcovptot"):
        a = np.asarray(getattr(out_plain, name))
        b = np.asarray(getattr(out_pad, name))
        np.testing.assert_array_equal(a, b)


def test_scan_unroll_bitwise_invariant(input_100, params, monkeypatch):
    """CLOUDSC_SCAN_UNROLL only restructures the level loop (lax.scan
    unroll); per-level ops and their order are unchanged, so outputs must be
    BITWISE identical — the guard that keeps the fp64 goldens valid for any
    unroll setting (PERF.md)."""
    import jax.numpy as jnp

    base = _run(input_100, params, dtype=jnp.float32)
    monkeypatch.setenv("CLOUDSC_SCAN_UNROLL", "4")
    unrolled = _run(input_100, params, dtype=jnp.float32)
    for name in base._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(base, name)),
            np.asarray(getattr(unrolled, name)), err_msg=name,
        )


def test_s521_round_skip_is_inert(input_100, params):
    """CLOUDSC_S521_ROUND_SKIP per-round conds in the 5.2.1 rescale must be
    value-exact: rescale factors lie in (0,1] and only shrink negative
    entries, so sink sums are non-increasing across rounds and any round
    beyond the per-column overshoot count computes ratio_sel == 1.0 exactly
    (scheme.py _rescale_sinks). Diffs the dynamic configuration against the
    same cond structure with every predicate pinned ON (dynamic_skips=False
    routes force_on through the round conds too), so codegen is identical
    and any non-inert skipped round shows as a nonzero diff. Also checks a
    synthetic raining state (exercises the precip sub-branches) and a
    perturbed supersaturated state (more multi-species overshoots)."""
    import jax.numpy as jnp

    from cloudsc_tpu.physics import cloudsc, make_inputs
    from cloudsc_tpu.physics.scheme import SchemeConfig
    from test_robustness import _perturbed_fields
    from test_scheme_versions import _raining_fields

    base = make_inputs(input_100, dtype=jnp.float64)
    rainy = _raining_fields(input_100, jnp.float64)
    shaken = _perturbed_fields(input_100, jnp.float64, seed=3)
    for fields in (base, rainy, shaken):
        fast = jax.jit(
            lambda f: cloudsc(
                f, params, input_100.ptsphy,
                config=SchemeConfig(s521_round_skip=True),
            )
        )(fields)
        slow = jax.jit(
            lambda f: cloudsc(
                f, params, input_100.ptsphy,
                config=SchemeConfig(s521_round_skip=True,
                                    dynamic_skips=False),
            )
        )(fields)
        jax.block_until_ready((fast, slow))
        for name in ("plude", "pcovptot", "pfplsl", "pfplsn",
                     "tendency_loc_t", "tendency_loc_q", "tendency_loc_a",
                     "tendency_loc_cld", "prainfrac_toprfz", "pfhpsn"):
            diff = np.asarray(getattr(fast, name)) - np.asarray(
                getattr(slow, name)
            )
            assert np.all(diff == 0.0), (
                f"{name}: s521 round skip not inert "
                f"(max abs diff {np.abs(diff).max()})"
            )

"""Math-kernel unit tests vs golden values executed from the reference.

Golden values in tests/golden/units.json were produced by running
`/root/reference/rocket_simulation/utils.py` functions directly
(scripts/gen_golden.py). Tolerances: this machine's XLA transcendental
implementations (pow/atan2/trig) carry ~1e-8 relative error even in f64, so
transcendental-dependent comparisons use rtol=5e-7; pure-arithmetic paths
are held to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from erpl_monte_carlo_sim_tpu import ops

# ~5-min core-correctness tier (CLAUDE.md): goldens + engine basics.
pytestmark = pytest.mark.smoke

RTOL_TRANS = 5e-7
ATOL = 1e-12


def test_euler_quaternion_roundtrip(golden_units):
    for case in golden_units["math"]["euler_quat"]:
        q = np.asarray(ops.euler_to_quaternion(*case["euler"]))
        np.testing.assert_allclose(q, case["quat_wxyz"], rtol=RTOL_TRANS, atol=1e-9)
        e = np.asarray(ops.quaternion_to_euler(jnp.array(case["quat_wxyz"])))
        np.testing.assert_allclose(e, case["euler_back"], rtol=RTOL_TRANS, atol=1e-9)
        R = np.asarray(ops.quaternion_to_rotation_matrix(jnp.array(case["quat_wxyz"])))
        np.testing.assert_allclose(R, case["rotmat"], rtol=RTOL_TRANS, atol=1e-9)


def test_rotation_matrix_orthonormal():
    q = ops.normalize_quaternion(jnp.array([0.3, -0.5, 0.7, 0.2]))
    R = np.asarray(ops.quaternion_to_rotation_matrix(q))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert abs(np.linalg.det(R) - 1.0) < 1e-12


def test_quaternion_multiply_identity():
    q = jnp.array([0.9, 0.1, -0.2, 0.3])
    ident = jnp.array([1.0, 0.0, 0.0, 0.0])
    np.testing.assert_allclose(
        np.asarray(ops.quaternion_multiply(q, ident)), np.asarray(q), atol=ATOL
    )


def test_normalize_quaternion_degenerate():
    q = jnp.zeros(4)
    np.testing.assert_allclose(
        np.asarray(ops.normalize_quaternion(q)), [1.0, 0.0, 0.0, 0.0], atol=ATOL
    )


def test_quaternion_rate_golden(golden_units):
    for case in golden_units["math"]["qrate"]:
        qd = np.asarray(
            ops.angular_velocity_to_quaternion_rate(
                jnp.array(case["omega"]), jnp.array(case["q"])
            )
        )
        np.testing.assert_allclose(qd, case["qdot"], rtol=1e-12, atol=ATOL)


def test_wind_to_body_golden(golden_units):
    for case in golden_units["math"]["wind_to_body"]:
        M = np.asarray(ops.wind_to_body_matrix(case["alpha"], case["beta"]))
        np.testing.assert_allclose(M, case["matrix"], rtol=RTOL_TRANS, atol=1e-9)


def test_aero_angles_golden(golden_units):
    for case in golden_units["math"]["aero_angles"]:
        vb = jnp.array(case["vb"])
        assert float(ops.angle_of_attack(vb)) == pytest.approx(
            case["alpha"], rel=RTOL_TRANS, abs=1e-9
        )
        assert float(ops.sideslip_angle(vb)) == pytest.approx(
            case["beta"], rel=RTOL_TRANS, abs=1e-9
        )


def test_aero_angles_degenerate_guards():
    # atan2(0, -eps) would be pi; the reference returns 0 for tiny u AND w.
    assert float(ops.angle_of_attack(jnp.array([-1e-9, 5.0, 1e-9]))) == 0.0
    assert float(ops.sideslip_angle(jnp.array([1e-9, 5.0, 1e-9]))) == 0.0


def test_mach_number_golden(golden_units):
    for case in golden_units["math"]["mach"]:
        assert float(ops.mach_number(jnp.array(case["v"]), case["T"])) == pytest.approx(
            case["mach"], rel=RTOL_TRANS
        )


def test_interpolate_1d_matches_np_interp():
    rng = np.random.default_rng(0)
    xt = np.sort(rng.uniform(0, 10, 17))
    yt = rng.normal(size=17)
    xs = np.concatenate([rng.uniform(-2, 12, 100), xt])  # includes exact knots
    mine = np.asarray(ops.interpolate_1d(jnp.array(xs), jnp.array(xt), jnp.array(yt)))
    ref = np.interp(xs, xt, yt)
    np.testing.assert_allclose(mine, ref, rtol=1e-12, atol=1e-12)


def test_interpolate_vec_matches_per_component_np_interp():
    rng = np.random.default_rng(1)
    xt = np.sort(rng.uniform(0, 25000, 100))
    yt = rng.normal(size=(100, 3))
    xs = np.concatenate([rng.uniform(-1000, 26000, 200), xt])
    mine = np.stack(
        [np.asarray(ops.interpolate_vec(jnp.float64(x), jnp.array(xt), jnp.array(yt)))
         for x in xs[:50]]
    )
    ref = np.stack([[np.interp(x, xt, yt[:, c]) for c in range(3)] for x in xs[:50]])
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-9)


def test_interpolate_vec_vmap_batched_table():
    """The Monte Carlo hot path: per-lane wind tables under vmap."""
    import jax

    rng = np.random.default_rng(2)
    xt = jnp.array(np.linspace(0, 25000, 100))
    yt = jnp.array(rng.normal(size=(8, 100, 3)))
    xs = jnp.array(rng.uniform(-100, 26000, 8))
    out = jax.vmap(ops.interpolate_vec, in_axes=(0, None, 0))(xs, xt, yt)
    ref = np.stack(
        [[np.interp(float(xs[b]), np.asarray(xt), np.asarray(yt[b, :, c]))
          for c in range(3)] for b in range(8)]
    )
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-9, atol=1e-9)


def test_safe_sqrt_semantics():
    """Primal matches jnp.sqrt on x >= 0 and on NaN (divergence detection
    depends on NaN propagating); gradient at exactly 0 is 0, not inf."""
    import jax
    from erpl_monte_carlo_sim_tpu.ops.math import safe_sqrt

    x = jnp.asarray([0.0, 1e-300, 4.0, jnp.nan])
    got = safe_sqrt(x)
    np.testing.assert_array_equal(np.asarray(got)[:3], np.sqrt(np.asarray(x)[:3]))
    assert np.isnan(np.asarray(got)[3])
    g0 = jax.grad(safe_sqrt)(0.0)
    assert float(g0) == 0.0
    g4 = jax.grad(safe_sqrt)(4.0)
    assert float(g4) == 0.25


def test_bcast_where_shapes_and_bools():
    from erpl_monte_carlo_sim_tpu.ops.math import bcast_where

    mask = jnp.array([True, False])
    a = jnp.ones((2, 3))
    b = jnp.zeros((2, 3))
    out = np.asarray(bcast_where(mask, a, b))
    np.testing.assert_array_equal(out, [[1, 1, 1], [0, 0, 0]])
    # bool operands take the logic-op path
    ab = jnp.array([True, True])
    bb = jnp.array([False, False])
    np.testing.assert_array_equal(
        np.asarray(bcast_where(mask, ab, bb)), [True, False]
    )

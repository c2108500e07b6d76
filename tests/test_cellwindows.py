"""Window-blocked nonlinear convection (ops/cellwindows.py).

Must agree with the gather-table N(u) (fem/assembly.py) to rounding — the
same element integrals, just window-reordered summation (ref counterpart:
the per-step convection reassembly, src/flowcontrol/flowsolver.py:739-771)
— and leave stepper trajectories unchanged.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from flowcontrol_tpu.fem.assembly import (
    geometry_device_tables,
    nonlinear_convection,
)
from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver
from flowcontrol_tpu.ops.cellwindows import (
    build_cell_windows,
    nonlinear_convection_windowed,
)


@pytest.fixture(scope="module")
def lid(tmp_path_factory):
    return LidCavityFlowSolver.make_default(
        Re=500, num_steps=5, verbose=0, n_mesh=12,
        path_out=tmp_path_factory.mktemp("cw"), solver_backend="host_lu",
        precision="f64",
    )


def _build(lid, variant):
    space, geom = lid.space, lid.forms.geom
    built = build_cell_windows(
        space.cell_vel_nodes, space.n_vnodes,
        {"wq": geom.wq, "dphi2": geom.dphi2, "phi2": geom.phi2},
        dtype=np.float64,
    )
    assert built is not None
    tree, static = built
    static["variant"] = variant
    return tree, static


@pytest.mark.parametrize("variant", ["onehot", "take"])
def test_windowed_nl_matches_gather(lid, variant):
    space = lid.space
    n = space.n_dofs
    tree, static = _build(lid, variant)
    geom_dev = geometry_device_tables(lid.forms.geom, dtype=np.float64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    ref = np.asarray(nonlinear_convection(geom_dev, space, jnp.asarray(x)))
    got = np.asarray(
        nonlinear_convection_windowed(tree, static, jnp.asarray(x), n)
    )
    assert np.allclose(got, ref, atol=1e-12)
    # batched (leading dims)
    xb = rng.standard_normal((3, 2, n))
    refb = np.asarray(nonlinear_convection(geom_dev, space, jnp.asarray(xb)))
    gotb = np.asarray(
        nonlinear_convection_windowed(tree, static, jnp.asarray(xb), n)
    )
    assert gotb.shape == refb.shape
    assert np.allclose(gotb, refb, atol=1e-12)


@pytest.mark.parametrize("chunk", [1, 2])
def test_windowed_nl_chunked_matches_gather(lid, chunk):
    """The lax.map-chunked one-hot (the bounded-memory path used at the
    235k cavity, where the full mask is multi-GB) is the same integral."""
    space = lid.space
    n = space.n_dofs
    tree, static = _build(lid, "onehot")
    static["chunk"] = chunk  # force grouping (incl. a padded last group)
    geom_dev = geometry_device_tables(lid.forms.geom, dtype=np.float64)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n)
    ref = np.asarray(nonlinear_convection(geom_dev, space, jnp.asarray(x)))
    got = np.asarray(
        nonlinear_convection_windowed(tree, static, jnp.asarray(x), n)
    )
    assert np.allclose(got, ref, atol=1e-12)
    xb = rng.standard_normal((2, n))
    refb = np.asarray(nonlinear_convection(geom_dev, space, jnp.asarray(xb)))
    gotb = np.asarray(
        nonlinear_convection_windowed(tree, static, jnp.asarray(xb), n)
    )
    assert np.allclose(gotb, refb, atol=1e-12)


def test_windowed_nl_survives_hostile_node_numbering(lid):
    """The reference's stock O1 mesh numbers nodes with NO spatial
    coherence (raw window width spans the whole node range); the RCM
    pre-pass must keep windows narrow for ANY input numbering."""
    space, geom = lid.space, lid.forms.geom
    rng = np.random.default_rng(42)
    shuffle = rng.permutation(space.n_vnodes)
    built = build_cell_windows(
        shuffle[space.cell_vel_nodes], space.n_vnodes,
        {"wq": geom.wq, "dphi2": geom.dphi2, "phi2": geom.phi2},
    )
    assert built is not None
    _, static = built
    assert static["w"] <= 1024, static["w"]  # narrow despite the shuffle


def test_windowed_nl_width_cap(lid):
    space, geom = lid.space, lid.forms.geom
    built = build_cell_windows(
        space.cell_vel_nodes, space.n_vnodes,
        {"wq": geom.wq, "dphi2": geom.dphi2, "phi2": geom.phi2},
        max_width=64,
    )
    assert built is None


@pytest.mark.parametrize("variant", ["onehot", "take"])
def test_stepper_windowed_nl_trajectory(lid, tmp_path, variant):
    """windowed_nl reproduces the gather-path trajectory."""
    def run(**kw):
        fs = LidCavityFlowSolver.make_default(
            Re=500, num_steps=5, verbose=0, n_mesh=12,
            path_out=tmp_path / f"{len(kw)}{variant}", precision="f64", **kw,
        )
        fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
        fs.initialize_time_stepping()
        for _ in range(5):
            y = fs.step(np.zeros(1))
        return y, np.asarray(fs.fields.up_)

    y1, x1 = run(solver_backend="host_lu")
    y2, x2 = run(
        solver_backend="host_lu", stepper_options={"windowed_nl": variant}
    )
    assert np.allclose(x1, x2, atol=1e-10)
    assert np.allclose(y1, y2, atol=1e-12)


def onehot_pick_case(dtype=np.float32):
    """The windowed N(u)'s one-hot pick on real windows of a small mesh,
    jitted, next to the same values gathered by index: (got, want)."""
    import jax

    from flowcontrol_tpu.fem.assembly import CellGeometry
    from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace
    from flowcontrol_tpu.mesh.generation import unit_square_mesh
    from flowcontrol_tpu.ops.cellwindows import (
        _window_rows,
        onehot_mask,
        onehot_pick,
    )

    space = TaylorHoodSpace.build(unit_square_mesh(12, 12))
    geom = CellGeometry(space)
    tree, static = build_cell_windows(
        space.cell_vel_nodes, space.n_vnodes,
        {"wq": geom.wq, "dphi2": geom.dphi2, "phi2": geom.phi2},
        dtype=dtype,
    )
    rng = np.random.default_rng(3)
    u_nodes = rng.standard_normal((space.n_vnodes, 2)).astype(dtype)
    uwin = np.asarray(_window_rows(tree, static, jnp.asarray(u_nodes)))
    rel = np.asarray(tree["rel"])
    got = jax.jit(lambda r, u: onehot_pick(onehot_mask(r, static["w"], u.dtype),
                                           u))(rel, uwin)
    want = np.take_along_axis(uwin, rel[..., None], axis=1)
    return np.asarray(got), want


def test_onehot_pick_exact_f32():
    """The one-hot contraction reproduces the gathered f32 values bit for
    bit (an exact selection at the pinned precision)."""
    got, want = onehot_pick_case(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)

"""Batched multifrontal (nested-dissection) solver vs sparse LU truth."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flowcontrol_tpu.fem.assembly import to_scipy_csr
from flowcontrol_tpu.parallel.dofsharding import mixed_dof_coordinates
from flowcontrol_tpu.solvers.multifrontal import (
    MultifrontalLU,
    _annotate_boundaries,
    _postorder,
    build_nd_tree,
)


@pytest.fixture(scope="module")
def bdf2_system():
    """BDF2 time-step matrix of a small cylinder flow (BC-eliminated)."""
    from flowcontrol_tpu.mesh.generation import cylinder_mesh
    from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

    mesh = cylinder_mesh(
        yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0, n3=0.8, segments=80
    )
    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=1, verbose=0, mesh=mesh,
        solver_backend="host_lu", precision="f64",
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    bcs = fs._bcset_perturbation()
    lhs_e = fs.forms.transient_lhs(2, fs.fields.U0)
    a_csr = to_scipy_csr(lhs_e, fs.space.cell_dofs, fs.space.n_dofs)
    a_bc, _ = bcs.eliminate_csr(a_csr)
    return a_bc, mixed_dof_coordinates(fs.space)


def test_nd_tree_separator_property(bdf2_system):
    """Children subtrees must not couple each other (separators separate),
    every dof is eliminated exactly once, and bd(v) = ancestor elims."""
    a_bc, coords = bdf2_system
    n = a_bc.shape[0]
    g = ((a_bc != 0) + (a_bc != 0).T).tocsr()
    root = build_nd_tree(g, coords, np.arange(n), leaf_max=600)
    _annotate_boundaries(g, root)
    nodes = _postorder(root)
    all_elim = np.concatenate([v.elim for v in nodes])
    assert len(all_elim) == n
    assert len(np.unique(all_elim)) == n

    def subtree(v):
        out = [v.elim] + [subtree(c) for c in v.children]
        return np.concatenate(out)

    def check(v, anc_elims):
        if v.children:
            l, r = (np.sort(subtree(c)) for c in v.children)
            assert g[l][:, r].nnz == 0, "separator fails to separate"
        anc = (
            np.sort(np.concatenate(anc_elims)) if anc_elims
            else np.array([], dtype=int)
        )
        assert np.isin(v.bd, anc).all(), "bd contains non-ancestor dofs"
        for c in v.children:
            check(c, anc_elims + [v.elim])

    check(root, [])
    assert len(nodes) > 3  # actually recursed


def test_multifrontal_matches_splu_f64(bdf2_system, tmp_path, monkeypatch):
    import scipy.sparse.linalg as spla

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    mf = MultifrontalLU(a_bc, coords, leaf_max=700, dtype=jax.numpy.float64)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a_bc.shape[0])
    x = np.asarray(mf.solve(b))
    x_ref = spla.splu(a_bc.tocsc()).solve(b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-11


def test_multifrontal_f32_accuracy_and_batch(bdf2_system, tmp_path,
                                             monkeypatch):
    """f64-factored, f32-rounded factors: rounding-limited solves (~1e-6
    class), batched rhs, refinement reaches deep f32."""
    import scipy.sparse.linalg as spla

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    mf = MultifrontalLU(a_bc, coords, leaf_max=700, dtype=jax.numpy.float32)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((2, 3, a_bc.shape[0]))
    x = np.asarray(mf.solve(b), dtype=np.float64)
    assert x.shape == b.shape
    lu = spla.splu(a_bc.tocsc())
    for i in range(2):
        for j in range(3):
            x_ref = lu.solve(b[i, j])
            rel = np.linalg.norm(x[i, j] - x_ref) / np.linalg.norm(x_ref)
            assert rel < 2e-5, rel
    assert np.asarray(mf.solve(b[0, 0].astype(np.float64))).dtype == np.float64


def test_multifrontal_wide_batch_matches_narrow(bdf2_system, tmp_path,
                                                monkeypatch):
    """Batches wider than 8 take the threaded update-slice sweep (the
    concat sweep's per-stage prefix copies scale with batch width); both
    dataflows run the same tables and einsums, so rows must agree to
    reduction-order noise."""
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    mf = MultifrontalLU(a_bc, coords, leaf_max=700, dtype=jax.numpy.float32)
    rng = np.random.default_rng(7)
    b = rng.standard_normal((16, a_bc.shape[0]))
    x_wide = np.asarray(mf.solve(b), dtype=np.float64)  # threaded
    x_narrow = np.asarray(mf.solve(b[:2]), dtype=np.float64)  # concat
    for j in range(2):
        rel = (np.linalg.norm(x_wide[j] - x_narrow[j])
               / np.linalg.norm(x_narrow[j]))
        assert rel < 1e-6, rel


@pytest.mark.parametrize("precision,tol", [("f64", 1e-9), ("f32", 1e-3)])
def test_stepper_multifrontal_backend_matches_host_lu(tmp_path, monkeypatch,
                                                      precision, tol):
    """End-to-end: the Stepper's default substructure backend (multifrontal)
    reproduces the host_lu/f64 trajectory (ceilings shrunk to force the
    path on a small mesh)."""
    from flowcontrol_tpu.core.stepper import Stepper
    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    from flowcontrol_tpu import config

    # a 2 MB device and a 300-dof dense regime push the small mesh past
    # the single-factor regime
    monkeypatch.setattr(config, "device_hbm_budget_bytes",
                        lambda device=None: 2_000_000)
    monkeypatch.setattr(config, "DENSE_MAX_DOFS", 300)
    monkeypatch.setattr(Stepper, "LAPACK_LU_MAX_N", 300)

    def run(backend, precision):
        fs = LidCavityFlowSolver.make_default(
            Re=500, num_steps=6, verbose=0, n_mesh=12,
            path_out=tmp_path / f"{backend}{precision}",
            solver_backend=backend, precision=precision,
        )
        fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
        fs.initialize_time_stepping()
        for _ in range(5):
            y = fs.step(np.array([0.01]))
        assert (
            backend == "host_lu"
            or "multifrontal" in fs._stepper._solver_kinds
        )
        return y, np.asarray(fs.fields.up_)

    y_ref, x_ref = run("host_lu", "f64")
    y, x = run("dense_lu", precision)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < tol
    assert np.allclose(y, y_ref, rtol=10 * tol, atol=tol)


def test_multifrontal_warm_cache_reproduces(bdf2_system, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    from flowcontrol_tpu.solvers import factor_cache as fc

    a_bc, coords = bdf2_system
    kw = dict(leaf_max=700, dtype=jax.numpy.float32)
    mf = MultifrontalLU(a_bc, coords, **kw)
    assert mf.loaded_from == "build"
    fc.flush()  # cache stores are async — publish before the warm build
    mf2 = MultifrontalLU(a_bc, coords, **kw)  # derived-cache hit
    # the warm path streams fread -> device upload per stage
    assert mf2.loaded_from == "stream"
    assert mf2.solve_err == mf.solve_err
    rng = np.random.default_rng(2)
    b = rng.standard_normal(a_bc.shape[0])
    assert np.allclose(
        np.asarray(mf.solve(b)), np.asarray(mf2.solve(b)),
        rtol=1e-6, atol=1e-9,
    )


def test_layout_ji_matches_canonical(bdf2_system, tmp_path, monkeypatch):
    """The pre-transposed ('ji') stack layout contracts the same operands
    (host transpose happens once at unpack) — solutions agree to reduction
    order (the transposed dot sums in a different order, ~1e-13 rel in
    f64). Guards the single-chip A/B knob (FC_MF_LAYOUT)."""
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    rng = np.random.default_rng(5)
    b = rng.standard_normal(a_bc.shape[0])
    import jax.numpy as jnp

    mf_ij = MultifrontalLU(a_bc, coords, dtype=jnp.float64, layout="ij")
    mf_ji = MultifrontalLU(a_bc, coords, dtype=jnp.float64, layout="ji")
    x_ij = np.asarray(mf_ij.solve(b))
    x_ji = np.asarray(mf_ji.solve(b))
    np.testing.assert_allclose(x_ji, x_ij, rtol=1e-11, atol=1e-13)
    # stage stacks carry distinct keys so layout mixups fail loudly
    assert "inv_t" in mf_ji.tree()["stages"][0]
    assert "inv" not in mf_ji.tree()["stages"][0]
    # the sharded wrapper refuses the experimental layout
    from flowcontrol_tpu.parallel.mf_sharded import ShardedMultifrontal

    with pytest.raises(ValueError, match="canonical"):
        ShardedMultifrontal(mf_ji.tree(), mf_ji.static(), mesh=None)


def test_dp_repack_matches_bucket_and_shrinks_stages(bdf2_system, tmp_path,
                                                     monkeypatch):
    """The penalty-DP repack (default) must reproduce the bucket packing's
    solutions exactly at the operator level (same per-node factors, only
    regrouped) and reduce the stage count. Guards FC_MF_PACK."""
    import scipy.sparse.linalg as spla

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    monkeypatch.setenv("FC_MF_PACK", "bucket")
    mf_b = MultifrontalLU(a_bc, coords, leaf_max=700, dtype=jax.numpy.float64)
    monkeypatch.setenv("FC_MF_PACK", "dp")
    mf_d = MultifrontalLU(a_bc, coords, leaf_max=700, dtype=jax.numpy.float64)
    assert mf_d.n_depths < mf_b.n_depths, (mf_d.n_depths, mf_b.n_depths)
    rng = np.random.default_rng(9)
    b = rng.standard_normal(a_bc.shape[0])
    x_b = np.asarray(mf_b.solve(b))
    x_d = np.asarray(mf_d.solve(b))
    # identical factors, different summation grouping: agreement to
    # reduction order in f64
    np.testing.assert_allclose(x_d, x_b, rtol=1e-11, atol=1e-13)
    x_ref = spla.splu(a_bc.tocsc()).solve(b)
    rel = np.linalg.norm(x_d - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-11, rel
    # padded factor bytes must not grow under the default penalty
    size = lambda mf: sum(
        v.nbytes
        for st in mf.tree()["stages"]
        for v in jax.tree_util.tree_leaves(st)
    )
    assert size(mf_d) <= 1.1 * size(mf_b)


def test_solve_panel_lane0_matches_single(bdf2_system, tmp_path, monkeypatch):
    """The stepper's solve_panel trick (broadcast the single RHS to an
    N-wide panel, keep lane 0 — an A/B knob) must be numerically
    indistinguishable
    from the single-RHS solve: all lanes bitwise-equal, lane 0 within
    reduction-order noise of the unbatched solve."""
    from flowcontrol_tpu.solvers.multifrontal import multifrontal_solve

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    mf = MultifrontalLU(a_bc, coords, leaf_max=700, dtype=jax.numpy.float32)
    rng = np.random.default_rng(7)
    b = rng.standard_normal(a_bc.shape[0]).astype(np.float32)
    st = mf.static()
    x1 = np.asarray(multifrontal_solve(mf.tree(), b, **st))
    import jax.numpy as jnp

    xp = np.asarray(multifrontal_solve(
        mf.tree(), jnp.broadcast_to(jnp.asarray(b), (8, b.shape[0])), **st))
    assert xp.shape == (8,) + b.shape
    for lane in range(1, 8):
        np.testing.assert_array_equal(xp[lane], xp[0])
    rel = np.linalg.norm(xp[0] - x1) / np.linalg.norm(x1)
    assert rel < 2e-5, rel


def test_stepper_solve_panel_trajectory(tmp_path, monkeypatch):
    """End-to-end: forcing stepper_options solve_panel=4 through the
    multifrontal path reproduces the panel-off trajectory."""
    from flowcontrol_tpu.core.stepper import Stepper
    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    from flowcontrol_tpu import config

    # a 2 MB device and a 300-dof dense regime push the small mesh past
    # the single-factor regime
    monkeypatch.setattr(config, "device_hbm_budget_bytes",
                        lambda device=None: 2_000_000)
    monkeypatch.setattr(config, "DENSE_MAX_DOFS", 300)
    monkeypatch.setattr(Stepper, "LAPACK_LU_MAX_N", 300)

    def run(panel):
        fs = LidCavityFlowSolver.make_default(
            Re=500, num_steps=6, verbose=0, n_mesh=12,
            path_out=tmp_path / f"panel{panel}",
            solver_backend="dense_lu", precision="f32",
            stepper_options={"solve_panel": panel},
        )
        fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
        fs.initialize_time_stepping()
        for _ in range(5):
            y = fs.step(np.array([0.01]))
        assert "multifrontal" in fs._stepper._solver_kinds
        return y, np.asarray(fs.fields.up_)

    y0, x0 = run(0)
    y4, x4 = run(4)
    # the panel changes the XLA lowering (batched vs single) so each
    # solve differs by f32 reduction order; over 5 nonlinear steps this
    # accumulates to the same ~1e-3 class as the f32-vs-f64 backend test
    assert np.linalg.norm(x4 - x0) / np.linalg.norm(x0) < 1e-3
    np.testing.assert_allclose(y4, y0, rtol=1e-3, atol=1e-5)


def test_stepper_hot_order_matches_host_lu(tmp_path, monkeypatch):
    """hot_order=True (split-component node-RCM hot layout: zero-permute
    banded mass + windowed N(u), composed multifrontal boundary maps,
    remapped sensors/lifts/BCs) reproduces the host_lu/f64 trajectory to
    rounding. The renumbering is exact, so f64 agreement is ~1e-9."""
    from flowcontrol_tpu.core.stepper import Stepper
    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    from flowcontrol_tpu import config

    # a 2 MB device and a 300-dof dense regime push the small mesh past
    # the single-factor regime
    monkeypatch.setattr(config, "device_hbm_budget_bytes",
                        lambda device=None: 2_000_000)
    monkeypatch.setattr(config, "DENSE_MAX_DOFS", 300)
    monkeypatch.setattr(Stepper, "LAPACK_LU_MAX_N", 300)

    def run(backend, opts=None):
        fs = LidCavityFlowSolver.make_default(
            Re=500, num_steps=6, verbose=0, n_mesh=12,
            path_out=tmp_path / f"{backend}{bool(opts)}",
            solver_backend=backend, precision="f64",
            stepper_options=opts or {},
        )
        fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
        fs.initialize_time_stepping()
        for _ in range(5):
            y = fs.step(np.array([0.01]))
        return y, np.asarray(fs.fields.up_), fs._stepper

    y_ref, x_ref, _ = run("host_lu")
    y, x, st = run("dense_lu", {
        "hot_order": True, "dense_operators": False,
        "banded_operators": True, "windowed_nl": "onehot",
    })
    assert st._hot_src is not None
    assert "perm" not in st._dev["m_banded"]          # zero-permute apply
    assert "perm" not in st._dev["nl_win"]            # zero-permute N(u)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-9
    assert np.allclose(y, y_ref, rtol=1e-8, atol=1e-11)
    # round-trip of the layout converters
    v = np.arange(st.space.n_dofs, dtype=float)
    assert np.array_equal(st.from_hot(st.to_hot(v)), v)

"""Two-level tridiagonal-Schur substructured solver vs sparse LU truth."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flowcontrol_tpu.fem.assembly import to_scipy_csr
from flowcontrol_tpu.parallel.dofsharding import mixed_dof_coordinates
from flowcontrol_tpu.solvers.tridiag import (
    PinchError,
    TridiagSubstructuredLU,
    partition_strips,
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


def test_partition_strips_structure(bdf2_system):
    """Interiors decouple across strips; cuts only couple adjacent cuts;
    interiors only couple their own two cuts (the tridiagonal invariant)."""
    a_bc, coords = bdf2_system
    interiors, cuts = partition_strips(a_bc, coords, 4)
    n = a_bc.shape[0]
    assert sum(map(len, interiors)) + sum(map(len, cuts)) == n
    for d in range(4):
        for e in range(d + 1, 4):
            assert a_bc[np.ix_(interiors[d], interiors[e])].nnz == 0
    # cut c couples only cuts c-1..c+1
    for c in range(len(cuts)):
        for c2 in range(c + 2, len(cuts)):
            assert a_bc[np.ix_(cuts[c], cuts[c2])].nnz == 0
    # strip d interior couples only cuts d-1, d
    for d in range(4):
        for c in range(len(cuts)):
            if c not in (d - 1, d):
                assert a_bc[np.ix_(interiors[d], cuts[c])].nnz == 0


def test_partition_pinch_detection(bdf2_system):
    """Absurdly many strips must raise PinchError, not silently misgroup."""
    a_bc, coords = bdf2_system
    with pytest.raises(PinchError):
        partition_strips(a_bc, coords, a_bc.shape[0] // 4)


@pytest.mark.parametrize("n_blocks", [3, 6])
def test_tridiag_solve_matches_splu_f64(bdf2_system, n_blocks, tmp_path,
                                        monkeypatch):
    import scipy.sparse.linalg as spla

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    slu = TridiagSubstructuredLU(
        a_bc, coords, n_blocks=n_blocks, dtype=jax.numpy.float64,
        block_align=128,
    )
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a_bc.shape[0])
    x = np.asarray(slu.solve(b))
    x_ref = spla.splu(a_bc.tocsc()).solve(b)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-9


def test_tridiag_solve_f32_accuracy_and_batch(bdf2_system, tmp_path,
                                              monkeypatch):
    """f32 pivoted block inverses + f32-rounded tridiagonal Schur factors:
    direct-solver-class accuracy (percent of f32 eps * kappa), batched rhs."""
    import scipy.sparse.linalg as spla

    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    slu = TridiagSubstructuredLU(
        a_bc, coords, n_blocks=4, dtype=jax.numpy.float32, block_align=128,
    )
    rng = np.random.default_rng(1)
    b = rng.standard_normal((2, 3, a_bc.shape[0]))
    x = np.asarray(slu.solve(b), dtype=np.float64)
    assert x.shape == b.shape
    lu = spla.splu(a_bc.tocsc())
    for i in range(2):
        for j in range(3):
            x_ref = lu.solve(b[i, j])
            rel = np.linalg.norm(x[i, j] - x_ref) / np.linalg.norm(x_ref)
            assert rel < 5e-4, rel
    # one refinement sweep reaches deep into f32 territory
    x1 = np.asarray(slu.solve(b[0, 0]), dtype=np.float64)
    r = b[0, 0] - a_bc @ x1
    x1 = x1 + np.asarray(slu.solve(r), dtype=np.float64)
    x_ref = lu.solve(b[0, 0])
    assert np.linalg.norm(x1 - x_ref) / np.linalg.norm(x_ref) < 5e-6
    # output dtype follows the rhs
    assert np.asarray(slu.solve(b[0, 0].astype(np.float64))).dtype == np.float64


@pytest.mark.parametrize("precision,tol", [("f64", 1e-8), ("f32", 2e-4)])
def test_stepper_tridiag_backend_matches_host_lu(tmp_path, monkeypatch,
                                                 precision, tol):
    """End-to-end: the Stepper's tridiag substructured backend reproduces
    the host_lu/f64 trajectory (ceilings shrunk to force the path on a
    small mesh)."""
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

    def run(backend, precision, sub):
        fs = LidCavityFlowSolver.make_default(
            Re=500, num_steps=6, verbose=0, n_mesh=12,
            path_out=tmp_path / f"{backend}{precision}",
            solver_backend=backend, precision=precision,
            stepper_options={"substructure": sub} if backend == "dense_lu"
            else {},
        )
        fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
        fs.initialize_time_stepping()
        for _ in range(5):
            y = fs.step(np.array([0.01]))
        return y, np.asarray(fs.fields.up_)

    y_ref, x_ref = run("host_lu", "f64", None)
    y, x = run("dense_lu", precision, "tridiag")
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < tol
    assert np.allclose(y, y_ref, rtol=10 * tol, atol=tol)


def test_tridiag_warm_cache_reproduces(bdf2_system, tmp_path, monkeypatch):
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))
    a_bc, coords = bdf2_system
    kw = dict(n_blocks=3, dtype=jax.numpy.float32, block_align=128)
    slu = TridiagSubstructuredLU(a_bc, coords, **kw)
    slu2 = TridiagSubstructuredLU(a_bc, coords, **kw)  # cache hit
    rng = np.random.default_rng(2)
    b = rng.standard_normal(a_bc.shape[0])
    assert np.allclose(
        np.asarray(slu.solve(b)), np.asarray(slu2.solve(b)),
        rtol=1e-6, atol=1e-9,
    )

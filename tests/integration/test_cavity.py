"""Open-cavity integration (ref: tests/integration/test_cavity.py)."""

import numpy as np
import pytest

from flowcontrol_tpu.models.cavity import CavityFlowSolver


@pytest.fixture(scope="module")
def cavity_base(coarse_cavity_mesh, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cav")
    fs = CavityFlowSolver.make_default(
        Re=7500, num_steps=10, verbose=0, mesh=coarse_cavity_mesh,
        path_out=tmp, solver_backend="host_lu", precision="f64",
    )
    # reference recipe (ref: run_cavity_example.py:70-71)
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=10, tol=1e-7)
    fs.compute_steady_state(
        u_ctrl=[0.0], method="newton", initial_guess=fs.fields.UP0, max_iter=10
    )
    assert np.abs(fs.fields.U0).max() < 2.0
    return fs.fields.U0.copy(), fs.fields.P0.copy()


def make_solver(mesh, tmp_path, **kw):
    return CavityFlowSolver.make_default(
        Re=7500, verbose=0, mesh=mesh, path_out=tmp_path,
        solver_backend="host_lu", precision="f64", **kw,
    )


def test_cavity_fast(coarse_cavity_mesh, cavity_base, tmp_path):
    u0, p0 = cavity_base
    fs = make_solver(coarse_cavity_mesh, tmp_path, num_steps=3)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    for _ in range(3):
        y = fs.step(np.zeros(1))
    assert np.isfinite(y).all()
    assert np.isfinite(fs.fields.u_).all()
    # wall-shear sensor reads the base-flow-perturbed shear; point sensor
    # reads U in the shear layer
    assert y.shape == (2,)


def test_cavity_force_actuator_fast(coarse_cavity_mesh, cavity_base, tmp_path):
    """FORCE actuator has unit-norm B column (eta normalization,
    ref: actuator.py:295-313) and drives the flow."""
    from flowcontrol_tpu.fem.projection import l2_norm_function

    u0, p0 = cavity_base
    fs = make_solver(coarse_cavity_mesh, tmp_path, num_steps=3)
    act = fs.params_control.actuator_list[0]
    assert np.isclose(
        l2_norm_function(fs.geom, fs.space, act.profile), 1.0, rtol=1e-6
    )
    fs._assign_steady_state(u0, p0)
    fs.params_ic.amplitude = 0.0
    fs.initialize_time_stepping()
    for _ in range(3):
        y = fs.step(np.array([1.0]))
    assert fs.compute_perturbation_energy() > 0


def test_cavity_regression(coarse_cavity_mesh, cavity_base, tmp_path, regression_values):
    vals = regression_values.get("cavity")
    if not vals:
        pytest.skip("regression values not generated")
    u0, p0 = cavity_base
    assert np.isclose(np.abs(u0).max(), vals["U0_max"], rtol=1e-8)
    fs = make_solver(coarse_cavity_mesh, tmp_path, num_steps=10)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    for _ in range(10):
        y = fs.step(np.zeros(1))
    assert np.isclose(fs.t, 0.004, atol=1e-12)  # dt = 4e-4
    assert np.isclose(y[0], vals["y1"], rtol=1e-6)
    assert np.isclose(y[1], vals["y2"], rtol=1e-6)
    assert np.isclose(fs.compute_perturbation_energy(), vals["dE"], rtol=1e-6)


@pytest.mark.heavy
def test_cavity_gmres_backend(coarse_cavity_mesh, cavity_base, tmp_path):
    """SURVEY hard-part #1: the iterative saddle-point solver must hold up at
    the stiff cavity configuration (Re=7500, dt=4e-4). 5 steps of the
    SIMPLE-preconditioned GMRES backend vs the direct host solve.

    Marked ``heavy`` (~24 min on a 1-core host, dominated by the CPU GMRES
    path); run with ``-m heavy``. Verified passing 2026-08-16 (rel 1e-5)."""
    u0, p0 = cavity_base

    def run(backend):
        fs = CavityFlowSolver.make_default(
            Re=7500, num_steps=5, verbose=0, mesh=coarse_cavity_mesh,
            path_out=tmp_path / backend, solver_backend=backend,
            precision="f64",
        )
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        for _ in range(5):
            y = fs.step(np.zeros(1))
        if backend == "gmres":
            # residual-honest Krylov (VERDICT r2 item 6): the adaptive
            # restart loop must report convergence at the stiff config
            assert 0.0 <= fs.last_solve_res <= fs.stepper.krylov_rtol
        return np.asarray(fs.fields.up_, dtype=float)

    x_ref = run("host_lu")
    x_gmres = run("gmres")
    rel = np.linalg.norm(x_gmres - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-5, rel


def test_cavity_gmres_smoke_fast(tmp_path):
    """CI-runnable Krylov smoke (~1 min): 2 GMRES steps at reduced size and
    Re=500 vs the direct host solve — keeps the matrix-free FGMRES+SIMPLE
    path exercised on every push (the full Re=7500 check is the opt-in
    ``heavy`` test above)."""
    from flowcontrol_tpu.mesh.generation import cavity_mesh

    mesh = cavity_mesh(n_coarse=8, n_mid=16, n_fine=32)

    def run(backend):
        fs = CavityFlowSolver.make_default(
            Re=500, num_steps=2, verbose=0, mesh=mesh,
            path_out=tmp_path / backend, solver_backend=backend,
            precision="f64",
        )
        if backend == "host_lu":
            fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
            run.base = (fs.fields.U0.copy(), fs.fields.P0.copy())
        else:
            fs._assign_steady_state(*run.base)
        fs.initialize_time_stepping()
        for _ in range(2):
            fs.step(np.zeros(1))
        return np.asarray(fs.fields.up_, dtype=float)

    x_ref = run("host_lu")
    x_gmres = run("gmres")
    rel = np.linalg.norm(x_gmres - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-5, rel


def test_cavity_dense_f32_production_path_fast(coarse_cavity_mesh, cavity_base, tmp_path):
    """The GPU production configuration (dense_lu factors + f32, with the
    mixed-precision refinement the factor probe asks for) agrees with the
    validation path (host_lu f64) — the fast tier must exercise what the
    card runs. At 30k dofs the policy puts this mesh in the multifrontal
    regime."""
    u0, p0 = cavity_base

    def run(backend, precision):
        fs = CavityFlowSolver.make_default(
            Re=7500, num_steps=3, verbose=0, mesh=coarse_cavity_mesh,
            path_out=tmp_path / f"{backend}_{precision}",
            solver_backend=backend, precision=precision,
        )
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        for _ in range(3):
            y = fs.step(np.zeros(1))
        return y, np.asarray(fs.fields.up_, dtype=float)

    y_ref, x_ref = run("host_lu", "f64")
    y_32, x_32 = run("dense_lu", "f32")
    rel = np.linalg.norm(x_32 - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-4, rel
    assert np.allclose(y_32, y_ref, rtol=5e-4, atol=1e-6)

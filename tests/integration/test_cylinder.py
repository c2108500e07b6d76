"""Cylinder integration: fast smoke + pinned-value regression + restart.

Mirrors ref: tests/integration/test_cylinder.py — 3-tier pattern: *_fast
(coarse mesh, 3 steps, finite values, every push), regression (10 steps,
hard-pinned floats at tight rtol), closed-loop + JSON restart.
Regression constants are OUR pinned values (solver-path-dependent; the
reference's own constants are MUMPS/mesh-specific — SURVEY §4).
"""

import numpy as np
import pytest

from flowcontrol_tpu.models.cylinder import CylinderFlowSolver


def make_solver(mesh, tmp_path, num_steps=10, save_every=0, Tstart=0.0, **kw):
    return CylinderFlowSolver.make_default(
        Re=100,
        num_steps=num_steps,
        verbose=0,
        mesh=mesh,
        path_out=tmp_path,
        save_every=save_every,
        Tstart=Tstart,
        **{"solver_backend": "host_lu", "precision": "f64", **kw},
    )


@pytest.fixture(scope="module")
def base_flow(coarse_cylinder_mesh, tmp_path_factory):
    fs = make_solver(coarse_cylinder_mesh, tmp_path_factory.mktemp("bf"))
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(
        u_ctrl=[0.0, 0.0], method="newton", initial_guess=fs.fields.UP0, max_iter=10
    )
    return fs.fields.U0.copy(), fs.fields.P0.copy(), fs.cl0, fs.cd0


def test_cylinder_fast(coarse_cylinder_mesh, base_flow, tmp_path):
    """3 steps on the coarse mesh; finite fields and sensible measurements."""
    u0, p0, cl0, cd0 = base_flow
    fs = make_solver(coarse_cylinder_mesh, tmp_path, num_steps=3)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    for _ in range(3):
        y = fs.step(np.zeros(2))
    assert np.isfinite(y).all()
    assert np.isfinite(fs.fields.u_).all()
    assert fs.compute_perturbation_energy() > 0
    assert abs(fs.t - 0.015) < 1e-12


def test_cylinder_base_flow_physics_fast(base_flow):
    """Base-flow lift ~ 0 (symmetry), drag near literature value."""
    u0, p0, cl0, cd0 = base_flow
    assert abs(cl0) < 5e-3
    assert 0.9 < cd0 < 1.5  # steady symmetric base flow at Re=100
    # peak velocity 1.15-1.35 (blockage-dependent; reference domain: 1.1922)
    assert 1.1 < np.abs(u0).max() < 1.4


def test_cylinder_actuation_antisymmetry_fast(coarse_cylinder_mesh, base_flow, tmp_path):
    """Equal blowing at both slots is symmetric: the centered wake sensor
    responds antisymmetrically to ±u_ctrl."""
    u0, p0, *_ = base_flow
    ys = []
    for amp in (+0.5, -0.5):
        fs = make_solver(coarse_cylinder_mesh, tmp_path / f"a{amp}", num_steps=3)
        fs._assign_steady_state(u0, p0)
        fs.params_ic.amplitude = 0.0
        fs.initialize_time_stepping()
        for _ in range(3):
            y = fs.step(np.array([amp, amp]))
        ys.append(y)
    # linearity of the early response: y(+a) ≈ -y(-a) for a zero-IC run
    assert np.allclose(ys[0], -ys[1], rtol=0.05, atol=1e-8)


def test_cylinder_regression(coarse_cylinder_mesh, base_flow, tmp_path, regression_values):
    """10-step pinned-value regression (ref pattern:
    tests/integration/test_cylinder.py:66-74)."""
    vals = regression_values.get("cylinder")
    if not vals:
        pytest.skip("regression_values.json not generated")
    u0, p0, *_ = base_flow
    assert np.isclose(np.abs(u0).max(), vals["U0_max"], rtol=1e-8)
    fs = make_solver(coarse_cylinder_mesh, tmp_path, num_steps=10)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    for _ in range(10):
        y = fs.step(np.zeros(2))
    assert np.isclose(fs.t, 0.05, atol=1e-12)
    for i, key in enumerate(["y1", "y2", "y3"]):
        assert np.isclose(y[i], vals[key], rtol=1e-6), key
    assert np.isclose(fs.compute_perturbation_energy(), vals["dE"], rtol=1e-6)
    u_full = fs.fields.u_n + fs.fields.U0
    assert np.isclose(np.abs(u_full).max(), vals["U_max"], rtol=1e-6)


def test_cylinder_closed_loop_and_restart(coarse_cylinder_mesh, base_flow, tmp_path, regression_values):
    """Closed-loop run + JSON-sidecar restart reproduces the continuous run
    (ref: test_cylinder.py regression with restart at T=0.05)."""
    from flowcontrol_tpu.core.controller import Controller

    u0, p0, *_ = base_flow
    # small stable LTI controller
    k = Controller.from_matrices(
        A=np.array([[-2.0, 1.0], [0.0, -3.0]]),
        B=np.array([[0.5], [1.0]]),
        C=np.array([[0.2, 0.1]]),
        D=np.zeros((1, 1)),
    )

    def run(fs, n, k, snap_at=None):
        ys, snap, kx = [], None, None
        y = fs.y_meas
        for i in range(n):
            u = k.step(-y[0], fs.params_time.dt)
            y = fs.step(np.array([u[0], u[0]]))
            ys.append(y)
            if snap_at is not None and i + 1 == snap_at:
                snap = fs.fields.u_n.copy()
                kx = k.x.copy()
        return np.array(ys), snap, kx

    # continuous 10-step run, snapshot of the in-memory state after step 5
    fs1 = make_solver(coarse_cylinder_mesh, tmp_path, num_steps=10, save_every=5)
    fs1._assign_steady_state(u0, p0)
    fs1.initialize_time_stepping()
    k.reset()
    ys_full, u5, kx5 = run(fs1, 10, k, snap_at=5)

    # restart at T = 0.025 (checkpoint after 5 steps)
    fs2 = make_solver(
        coarse_cylinder_mesh, tmp_path, num_steps=5, save_every=5, Tstart=0.025
    )
    fs2._assign_steady_state(u0, p0)
    fs2.initialize_time_stepping(Tstart=0.025)
    assert fs2.order == 2  # restarted at BDF2 directly
    # field-level restart fidelity: the checkpoint write/read roundtrip
    # reproduces the continuous run's in-memory state at the restart time
    assert np.allclose(fs2.fields.u_n, u5, rtol=1e-10, atol=1e-12)
    # restore the controller's internal state at the restart point so the
    # closed loop continues exactly where the continuous run left off
    k.x = kx5.copy()
    y = ys_full[4]
    ys_restart = []
    for _ in range(5):
        u = k.step(-y[0], fs2.params_time.dt)
        y = fs2.step(np.array([u[0], u[0]]))
        ys_restart.append(y)
    ys_restart = np.array(ys_restart)
    # trajectory continuity: the restarted run must reproduce the tail of
    # the continuous run, not merely stay finite (ref regression pins
    # post-restart y_meas values — test_cylinder.py:120-126)
    assert np.allclose(ys_restart, ys_full[5:], rtol=1e-8, atol=1e-12)


def test_cylinder_timeseries_columns_fast(coarse_cylinder_mesh, base_flow, tmp_path):
    """CSV column layout matches the reference exporter exactly
    (ref: exporter.py:186-231)."""
    u0, p0, *_ = base_flow
    fs = make_solver(coarse_cylinder_mesh, tmp_path, num_steps=2, save_every=2)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    fs.step(np.zeros(2))
    fs.step(np.zeros(2))
    df = fs.timeseries
    assert list(df.columns)[:3] == ["time", "dE", "runtime"]
    for col in ["y_meas_1", "y_meas_2", "y_meas_3", "u_ctrl_1", "u_ctrl_2"]:
        assert col in df.columns
    assert (fs.paths.timeseries).exists()
    meta = fs.paths.metadata
    assert meta.exists()
    import json

    m = json.loads(meta.read_text())
    assert set(m) == {
        "Tstart", "dt", "save_every", "checkpoints_written",
        "restart_order", "files",
    }


def test_cylinder_paraview_index_fast(coarse_cylinder_mesh, base_flow, tmp_path):
    """Checkpoints emit a Paraview-readable XDMF temporal index
    (ref: dolfin XDMFFile side effect; mesh/io.write_xdmf_timeseries_index)."""
    import xml.etree.ElementTree as ET

    import h5py

    u0, p0, *_ = base_flow
    fs = make_solver(coarse_cylinder_mesh, tmp_path, num_steps=4, save_every=2)
    fs._assign_steady_state(u0, p0)
    fs.initialize_time_stepping()
    for _ in range(4):
        fs.step(np.zeros(2))
    u_xdmf = fs.paths.U_restart.with_suffix(".xdmf")
    p_xdmf = fs.paths.P_restart.with_suffix(".xdmf")
    assert u_xdmf.exists() and p_xdmf.exists()
    root = ET.parse(u_xdmf).getroot()
    grids = root.findall(".//Grid[@GridType='Uniform']")
    # IC snapshot + 2 checkpoints
    assert len(grids) == 3
    times = [float(g.find("Time").get("Value")) for g in grids]
    assert times == sorted(times)
    nv = coarse_cylinder_mesh.num_vertices
    with h5py.File(fs.paths.U_restart, "r") as f:
        assert f["viz/U/0"].shape == (nv, 3)  # padded vector, vertex slice
        assert f["viz_mesh/geometry"].shape == (nv, 2)
        # vertex slice of the full P2 field matches
        assert np.allclose(f["viz/U/1"][:, :2], f["U/1"][:nv])
    with h5py.File(fs.paths.P_restart, "r") as f:
        assert f["viz/P/0"].shape == (nv,)


def test_cylinder_legacy_param_restart(coarse_cylinder_mesh, base_flow, tmp_path):
    """Legacy ParamRestart fallback path (no JSON sidecar;
    ref: flowsolver.py:578-597)."""
    import flowcontrol_tpu.core.flowsolverparameters as fsp
    from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

    u0, p0, *_ = base_flow
    fs1 = make_solver(coarse_cylinder_mesh, tmp_path, num_steps=6, save_every=3)
    fs1._assign_steady_state(u0, p0)
    fs1.initialize_time_stepping()
    for _ in range(6):
        fs1.step(np.zeros(2))
    # remove the sidecar to force the legacy path
    for p in tmp_path.glob("meta_restart*.json"):
        p.unlink()
    fs2 = CylinderFlowSolver.make_default(
        Re=100, num_steps=3, verbose=0, mesh=coarse_cylinder_mesh,
        path_out=tmp_path, save_every=0, Tstart=0.015,
        solver_backend="host_lu", precision="f64",
    )
    fs2.params_restart = fsp.ParamRestart(
        save_every_old=3, restart_order=2, dt_old=0.005, Trestartfrom=0.0
    )
    # legacy path derives file names from Trestartfrom
    fs2.params_save.path_out = tmp_path
    fs2._assign_steady_state(u0, p0)
    fs2.initialize_time_stepping(Tstart=0.015)
    assert fs2.order == 2
    y = fs2.step(np.zeros(2))
    assert np.isfinite(y).all()


def test_cylinder_dense_f32_production_path_fast(coarse_cylinder_mesh, base_flow, tmp_path):
    """dense_lu + f32 + refinement (the GPU production configuration) vs the
    host_lu f64 validation path on a closed-loop-style actuated run."""
    u0, p0, *_ = base_flow

    def run(backend, precision):
        fs = make_solver(
            coarse_cylinder_mesh, tmp_path / f"{backend}_{precision}",
            num_steps=4, solver_backend=backend, precision=precision,
        )
        fs._assign_steady_state(u0, p0)
        fs.initialize_time_stepping()
        ys = [fs.step(np.array([0.3, -0.2])) for _ in range(4)]
        return np.array(ys), np.asarray(fs.fields.up_, dtype=float)

    y_ref, x_ref = run("host_lu", "f64")
    y_32, x_32 = run("dense_lu", "f32")
    rel = np.linalg.norm(x_32 - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-4, rel
    assert np.allclose(y_32, y_ref, rtol=5e-4, atol=1e-6)

"""chip_smoke.py's phases rehearsed on the CPU at a tiny size, against the
host-f64 reference, and its refusal to run without a GPU.

The stepper options force the regime the platform policy gives a GPU past
the dense range (f32, multifrontal, banded mass, windowed one-hot N(u),
hot dof order) onto a ~2k-dof cylinder.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

GPU_LIKE = dict(
    solver_backend="dense_lu", precision="f32",
    stepper_options=dict(force_substructure=True, dense_operators=False,
                         banded_operators=True, windowed_nl="onehot"),
)
GPU_LIKE_REGIME = dict(chip_smoke.GPU_REGIME,
                       kinds=("multifrontal", "multifrontal"))


@pytest.fixture(scope="module")
def tiny():
    """A ~2k-dof cylinder and its Re=100 base flow."""
    from flowcontrol_tpu.mesh.generation import cylinder_mesh
    from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

    mesh = cylinder_mesh(yinf=4.0, xinf=8.0, xinfa=-3.0, n1=1.6, n2=1.0,
                         n3=0.5, segments=32)
    fs = CylinderFlowSolver.make_default(Re=100, mesh=mesh, verbose=0,
                                         solver_backend="host_lu")
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0, max_iter=5)
    return mesh, (fs.fields.U0.copy(), fs.fields.P0.copy())


@pytest.fixture()
def factor_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOWCONTROL_TPU_FACTOR_CACHE", str(tmp_path))


def test_main_refuses_without_gpu(capsys):
    """No GPU: a non-zero exit and no ok line."""
    rc = chip_smoke.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_phase_main_rehearsal(tiny, factor_cache):
    mesh, base = tiny
    fs = chip_smoke.build_cylinder(mesh=mesh, base_flow=base, **GPU_LIKE)
    res = chip_smoke.phase_main(fs, GPU_LIKE_REGIME, steps=6, batch=3,
                                batch_steps=4, err_steps=5, tol_field=1e-4)
    assert res["regime"]["hot"] and res["regime"]["windowed"] == "onehot"
    assert 0 <= res["field_err"] < 1e-4
    # the host reference and the layers of the built stepper
    out = chip_smoke.phase_layers(fs, res["cpu"])
    assert out["mass"] < 1e-5 and out["nl"] < 1e-5 and out["solve"] < 5e-4


def test_phase_main_rejects_wrong_regime(tiny, factor_cache):
    mesh, base = tiny
    fs = chip_smoke.build_cylinder(mesh=mesh, base_flow=base, **GPU_LIKE)
    with pytest.raises(AssertionError, match="regime"):
        chip_smoke.phase_main(fs, chip_smoke.DENSE_REGIME, steps=2)


def test_phase_dense_rehearsal(tiny, factor_cache):
    """The one-dense-factor regime (LAPACK-sized here), f32."""
    mesh, base = tiny
    fs = chip_smoke.build_cylinder(mesh=mesh, base_flow=base,
                                   solver_backend="dense_lu", precision="f32")
    regime = dict(chip_smoke.DENSE_REGIME, kinds=("lapack", "lapack"))
    res = chip_smoke.phase_main(fs, regime, steps=4, batch=2, batch_steps=3,
                                err_steps=5, tol_field=1e-4)
    assert res["field_err"] < 1e-4


def test_phase_nl_variants_rehearsal(tiny, factor_cache):
    mesh, base = tiny
    fs = chip_smoke.build_cylinder(mesh=mesh, base_flow=base, **GPU_LIKE)
    fs.step(np.zeros(2))
    out = chip_smoke.phase_nl_variants(fs, steps=2)
    assert set(out) == {"onehot", "take", "False"}
    assert all(t > 0 for t in out.values())


def test_phase_sharded_rehearsal(tiny, factor_cache):
    """The four-card phase on four virtual CPU devices."""
    import jax

    mesh, base = tiny
    fs = chip_smoke.build_cylinder(mesh=mesh, base_flow=base, **GPU_LIKE)
    out = chip_smoke.phase_sharded(fs, jax.devices()[:4], GPU_LIKE_REGIME)
    assert set(out) == {"space4", "batch2_space2"}
    for r in out.values():
        assert r["step"] < chip_smoke.TOL_SHARDED
        assert r["closed_loop_y"] < chip_smoke.TOL_SHARDED
    assert (out["space4"]["factor_bytes_per_device"] * 4
            == out["space4"]["factor_bytes_total"])

"""Reference-named compatibility surface.

The reference exposes these exact names (ref: src/utils/{mesh,io,linalg,
optim,signal,mpi}.py); a user switching from the reference must find them
here with the same contracts. Each test exercises the behavior, not just the
import.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import flowcontrol_tpu.utils as flu
from flowcontrol_tpu.mesh.convert import (
    convert_mesh_msh2xml,
    convert_mesh_xml2xdmf,
    read_dolfin_xml,
    write_dolfin_xml,
)
from flowcontrol_tpu.mesh.generation import unit_square_mesh
from flowcontrol_tpu.parallel.mpi_compat import MpiUtils, check_process_rank

GMSH_V2 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
2
1 2 2 0 1 1 2 3
2 2 2 0 1 1 3 4
$EndElements
"""


def test_dolfin_xml_roundtrip(tmp_path, small_mesh):
    path = tmp_path / "m.xml"
    write_dolfin_xml(path, small_mesh)
    back = read_dolfin_xml(path)
    np.testing.assert_allclose(back.coords, small_mesh.coords)
    np.testing.assert_array_equal(back.cells, small_mesh.cells)


def test_convert_mesh_xml2xdmf(tmp_path, small_mesh):
    from flowcontrol_tpu.mesh.io import read_xdmf_mesh

    path = tmp_path / "m.xml"
    write_dolfin_xml(path, small_mesh)
    convert_mesh_xml2xdmf(path)
    back = read_xdmf_mesh(tmp_path / "m.xdmf")
    np.testing.assert_allclose(back.coords, small_mesh.coords)


def test_convert_mesh_msh2xml(tmp_path):
    src = tmp_path / "t.msh"
    src.write_text(GMSH_V2)
    convert_mesh_msh2xml(src)
    mesh = read_dolfin_xml(tmp_path / "t.xml")
    assert mesh.num_vertices == 4 and mesh.num_cells == 2


def test_export_npz_to_mat_roundtrip(tmp_path):
    import scipy.io as sio

    m = sp.random(12, 12, density=0.3, random_state=0, format="csr")
    sp.save_npz(tmp_path / "m.npz", m)
    flu.export_npz_to_mat(tmp_path / "m.npz", tmp_path / "m.mat", "Asp")
    back = sio.loadmat(tmp_path / "m.mat")["Asp"]
    assert abs(sp.csr_matrix(back) - m).max() < 1e-14


def test_export_sparse_matrix_spy(tmp_path):
    fig = tmp_path / "spy.png"
    flu.export_sparse_matrix(np.eye(5), figname=fig)
    assert fig.exists() and fig.stat().st_size > 0


def test_export_boundary_field_normals(tmp_path):
    """Projected facet normals on a unit square: mid-edge vertices point
    along the outward axis normal (the consistent L2 projection couples
    neighbors, so corner discontinuities ripple — direction, not exact
    values, is the invariant; the reference's dolfin projection behaves the
    same way); interior vertices stay exactly zero (ident_zeros rows)."""
    mesh = unit_square_mesh(8, 8)
    out = tmp_path / "bf.npz"
    flu.export_boundary_field(out, mesh)
    d = np.load(out)
    nh = d["boundary_field"]
    coords = d["coords"]
    mid_left = (coords[:, 0] < 1e-12) & (np.abs(coords[:, 1] - 0.5) < 1e-9)
    (idx,) = np.where(mid_left)
    assert len(idx) == 1
    v = nh[idx[0]]
    assert v @ np.array([-1.0, 0.0]) / np.linalg.norm(v) > 0.95
    np.testing.assert_allclose(v, [-1.0, 0.0], atol=0.1)
    interior = (
        (coords[:, 0] > 1e-6) & (coords[:, 0] < 1 - 1e-6)
        & (coords[:, 1] > 1e-6) & (coords[:, 1] < 1 - 1e-6)
    )
    np.testing.assert_allclose(nh[interior], 0.0, atol=1e-14)


def test_eigenproblem_slepc_standard_and_generalized():
    rng = np.random.default_rng(3)
    a = np.diag([-1.0, -2.0, -5.0]) + 0.01 * rng.standard_normal((3, 3))
    vals, vecs = flu.eigenproblem_slepc(a, n=1, sigma=-0.9)
    ref = np.linalg.eigvals(a)
    target = ref[np.argmin(np.abs(ref + 0.9))]
    np.testing.assert_allclose(vals[0], target, rtol=1e-8)
    # generalized: A x = lam E x with E = 2I halves the spectrum
    vals2, _ = flu.eigenproblem_slepc(a, 2.0 * np.eye(3), n=1, sigma=-0.45)
    np.testing.assert_allclose(vals2[0], target / 2.0, rtol=1e-8)


def test_frequency_response_reference_names():
    assert flu.get_frequency_response_sequential is flu.get_frequency_response
    assert flu.get_frequency_response_parallel is flu.get_frequency_response_device
    assert flu.get_mat_vp_slepc is flu.get_mat_vp_shift_invert
    a = sp.csr_matrix(np.array([[-1.0, 0.0], [0.0, -2.0]]))
    q = sp.identity(2, format="csr")
    b = np.array([[1.0], [1.0]])
    c = np.array([[1.0, 1.0]])
    h = flu.get_frequency_response_sequential(a, b, c, q, [0.0, 1.0])
    np.testing.assert_allclose(h[0, 0, 0], 1.0 + 0.5, rtol=1e-12)


def test_parallel_function_wrapper_contract():
    calls = []

    def cost(x):
        calls.append(x)
        return float(np.sum(np.square(x)))

    x = np.array([1.0, 2.0])
    assert flu.parallel_function_wrapper(x, [0], cost) == pytest.approx(5.0)
    # stop flag short-circuits without evaluating, as in the reference
    assert flu.parallel_function_wrapper(x, [1], cost) == 0.0
    assert len(calls) == 1


def test_plotsignal_headless(tmp_path):
    y = np.sin(2 * np.pi * 5 * np.linspace(0, 1, 200, endpoint=False))
    flu.plotsignal(y, Fs=200, Fmin=2, Fmax=10, path_prefix=tmp_path / "sig")
    assert (tmp_path / "sig_time.png").exists()
    assert (tmp_path / "sig_freq.png").exists()


def test_check_process_rank_logs(caplog):
    import logging

    with caplog.at_level(logging.INFO):
        check_process_rank()
        MpiUtils.check_process_rank()
    assert any("Hello I am process" in r.message for r in caplog.records)


def test_nsforms_reference_named_forms(small_space, small_geom):
    """NSForms.transient/steady/picard (ref: nsforms.py:62-187) agree with
    the framework's own assembly paths."""
    from flowcontrol_tpu.core.nsforms import NSForms
    from flowcontrol_tpu.core.steadystate import SteadyStateSolver
    from flowcontrol_tpu.fem.assembly import to_scipy_csr
    from flowcontrol_tpu.fem.bc import BCSet

    space, geom = small_space, small_geom
    forms = NSForms(space, geom, Re=50.0, dt=0.01)
    rng = np.random.default_rng(0)
    up = 0.1 * rng.standard_normal(space.n_dofs)
    f = rng.standard_normal(space.n_dofs)

    # transient == (transient_lhs, rhs_coefficients)
    lhs_e, coeffs = forms.transient(2, np.zeros((space.n_vnodes, 2)))
    np.testing.assert_allclose(
        lhs_e, forms.transient_lhs(2, np.zeros((space.n_vnodes, 2)))
    )
    assert coeffs == forms.rhs_coefficients(2)

    # steady residual == SteadyStateSolver.residual with the same load
    ss = SteadyStateSolver(space, geom, BCSet([], space.n_dofs), 1.0 / 50.0,
                           f_load=f, verbose=False)
    np.testing.assert_allclose(forms.steady(up, f), ss.residual(up),
                               rtol=1e-12, atol=1e-14)

    # picard tensors assemble to the Oseen matrix the Picard solver builds
    a_e, load = forms.picard(up, f)
    a = to_scipy_csr(a_e, space.cell_dofs, space.n_dofs)
    # compare its action against the frozen-advection steady residual
    # linearization: A(up_frozen) @ w == conv-frozen residual of w (w/o N')
    w = rng.standard_normal(space.n_dofs)
    from flowcontrol_tpu.fem.assembly import (
        convection_block,
        place_velocity_scalar,
        velocity_cell_values,
    )

    u_nodes = up[: space.n_vel_dofs].reshape(space.n_vnodes, 2)
    conv = to_scipy_csr(
        place_velocity_scalar(
            convection_block(geom, velocity_cell_values(space, u_nodes))
        ),
        space.cell_dofs, space.n_dofs,
    )
    expect = conv @ w + ss._base_csr @ w
    np.testing.assert_allclose(a @ w, expect, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(load, f)

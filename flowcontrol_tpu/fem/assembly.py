"""Element-tensor assembly and matrix-free operator application.

The device-side replacement for dolfin's SystemAssembler + PETSc matrices
(ref: src/flowcontrol/flowsolver.py:665-701). Strategy:

- Per-cell dense element tensors (15x15 mixed Taylor-Hood) are built ONCE per
  operator as batched einsums over the shape-function tables — this is the
  analogue of assembling the global sparse matrix, but the result stays in
  the shape XLA handles best: a dense ``(nc, 15, 15)`` array. Builders run in
  float64 numpy on the host (setup time, exactness); results are cast to the
  device dtype when shipped into jitted step functions.
- Operator application is gather → batched 15x15 matvec → segment-sum
  scatter, in JAX. No global sparse matrix is needed on the hot path.
- A global scipy CSR matrix can still be materialized host-side for direct
  factorization, operator export, and eigensolves.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from flowcontrol_tpu.fem import element as el
from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace

# Device einsums that touch solution values run at HIGHEST precision: on
# the H100 an f32 dot at DEFAULT or HIGH may run in TF32 (10 mantissa
# bits), which would round every element apply and N(u) contraction to
# ~3 digits. These contractions are small, so full f32 costs little;
# CPU ignores the flag.
_PREC = jax.lax.Precision.HIGHEST

# Velocity local dof (node a, comp c) -> mixed local index 2a + c.
_VEL_IDX = np.arange(12).reshape(6, 2)  # [a, c] -> local mixed index
_P_IDX = np.arange(12, 15)


# ── Geometry bundle ──────────────────────────────────────────────────────────


class CellGeometry:
    """Precomputed per-cell geometry factors + quadrature tables (host numpy).

    ``wq (nc, 7)`` already includes detJ/2, so any integral is
    ``sum_q wq[c, q] * integrand(c, q)``.
    """

    def __init__(self, space: TaylorHoodSpace, dtype=np.float64):
        mesh = space.mesh
        inv_jt, detj = el.cell_geometry(mesh.coords, mesh.cells)
        self.inv_jt = inv_jt.astype(dtype)
        self.detj = detj.astype(dtype)
        self.wq = (el.QP_W[None, :] * (detj * 0.5)[:, None]).astype(dtype)  # (nc,7)
        self.dphi2 = np.einsum("cij,qnj->cqni", inv_jt, el.DPHI2_REF).astype(
            dtype
        )  # (nc, 7, 6, 2)
        self.dphi1 = np.einsum("cij,nj->cni", inv_jt, el.P1_GRAD_REF).astype(
            dtype
        )  # (nc, 3, 2)
        self.phi2 = el.PHI2.astype(dtype)  # (7, 6)
        self.phi1 = el.PHI1.astype(dtype)  # (7, 3)
        self.space = space
        self.dtype = dtype


# ── Scalar element blocks (numpy, setup time) ───────────────────────────────


def scalar_mass_p2(geom: CellGeometry) -> np.ndarray:
    """(nc, 6, 6): ∫ φa φb dx per cell."""
    return np.einsum("cq,qa,qb->cab", geom.wq, geom.phi2, geom.phi2)


def scalar_stiffness_p2(geom: CellGeometry) -> np.ndarray:
    """(nc, 6, 6): ∫ ∇φa·∇φb dx per cell."""
    return np.einsum("cq,cqai,cqbi->cab", geom.wq, geom.dphi2, geom.dphi2)


def scalar_mass_p1(geom: CellGeometry) -> np.ndarray:
    """(nc, 3, 3): ∫ ψa ψb dx per cell (pressure mass)."""
    return np.einsum("cq,qa,qb->cab", geom.wq, geom.phi1, geom.phi1)


def scalar_stiffness_p1(geom: CellGeometry) -> np.ndarray:
    """(nc, 3, 3): ∫ ∇ψa·∇ψb dx per cell (pressure Laplacian)."""
    area = geom.wq.sum(axis=1)
    return np.einsum("c,cai,cbi->cab", area, geom.dphi1, geom.dphi1)


def convection_block(geom: CellGeometry, w_cell: np.ndarray) -> np.ndarray:
    """(nc, 6, 6): ∫ (W·∇φb) φa dx with W given by element values (nc, 6, 2).

    Implements dot(dot(W, nabla_grad(u)), v) for the same-component coupling
    (ref: nsforms.py:254 — advection by base flow).
    """
    w_q = np.einsum("qn,cnd->cqd", geom.phi2, w_cell)  # (nc, 7, 2)
    wdg = np.einsum("cqi,cqbi->cqb", w_q, geom.dphi2)  # (nc, 7, 6)
    return np.einsum("cq,qa,cqb->cab", geom.wq, geom.phi2, wdg)


def linearization_block(geom: CellGeometry, w_cell: np.ndarray) -> np.ndarray:
    """(nc, 6, 6, 2, 2): lin[a,b,i,j] = ∫ φa φb ∂W_j/∂x_i dx.

    Component-coupling term dot(dot(u, nabla_grad(W)), v): the mixed entry
    [(a,j),(b,i)] (ref: nsforms.py:256 — linearization (u·∇)U0).
    """
    gw = np.einsum("cqni,cnj->cqij", geom.dphi2, w_cell)  # (nc,7,2,2)
    return np.einsum("cq,qa,qb,cqij->cabij", geom.wq, geom.phi2, geom.phi2, gw)


def pressure_gradient_block(geom: CellGeometry) -> np.ndarray:
    """(nc, 6, 2, 3): gp[a,d,β] = -∫ ψβ ∂φa/∂x_d dx.

    The -p div(v) term; its transpose is the -q div(u) term
    (ref: nsforms.py:262-264).
    """
    return -np.einsum("cq,qb,cqad->cadb", geom.wq, geom.phi1, geom.dphi2)


# ── Mixed 15x15 element matrix construction (numpy) ─────────────────────────


def place_velocity_scalar(block6: np.ndarray) -> np.ndarray:
    """Scalar (nc,6,6) block -> (nc,15,15) on both velocity components."""
    nc = block6.shape[0]
    out = np.zeros((nc, 15, 15), dtype=block6.dtype)
    for c in range(2):
        out[:, _VEL_IDX[:, c][:, None], _VEL_IDX[:, c][None, :]] += block6
    return out


def place_linearization(lin: np.ndarray) -> np.ndarray:
    """(nc,6,6,2,2) lin[a,b,i,j] -> (nc,15,15) at [(a,j),(b,i)]."""
    nc = lin.shape[0]
    out = np.zeros((nc, 15, 15), dtype=lin.dtype)
    for i in range(2):
        for j in range(2):
            out[:, _VEL_IDX[:, j][:, None], _VEL_IDX[:, i][None, :]] += lin[
                :, :, :, i, j
            ]
    return out


def place_pressure_blocks(gp: np.ndarray) -> np.ndarray:
    """(nc,6,2,3) -> (nc,15,15): -p div(v) and symmetric -q div(u)."""
    nc = gp.shape[0]
    out = np.zeros((nc, 15, 15), dtype=gp.dtype)
    for c in range(2):
        out[:, _VEL_IDX[:, c][:, None], _P_IDX[None, :]] += gp[:, :, c, :]
        out[:, _P_IDX[:, None], _VEL_IDX[:, c][None, :]] += np.swapaxes(
            gp[:, :, c, :], 1, 2
        )
    return out


def linear_operator_element(
    geom: CellGeometry, u0_cell: np.ndarray, inv_re: float, shift: float = 0.0
) -> np.ndarray:
    """Element matrices of the steady linearized NS operator (no mass).

    ``conv(U0) + lin(U0) + (1/Re) K + pressure blocks - shift*M_vel``
    — the Jacobian of the steady residual at U0; also the spatial part of
    every transient LHS (ref: nsforms.py:238-269).
    """
    conv = convection_block(geom, u0_cell)
    lin = linearization_block(geom, u0_cell)
    k = scalar_stiffness_p2(geom)
    gp = pressure_gradient_block(geom)
    a_e = place_velocity_scalar(conv + inv_re * k)
    a_e += place_linearization(lin)
    a_e += place_pressure_blocks(gp)
    if shift:
        a_e -= shift * place_velocity_scalar(scalar_mass_p2(geom))
    return a_e


def mass_velocity_element(geom: CellGeometry) -> np.ndarray:
    """(nc,15,15) with the velocity mass on the diagonal blocks, zero pressure.

    This is the generalized mass matrix E of the reference
    (ref: src/flowcontrol/operatorgetter.py:85-105 — velocity-only mass).
    """
    return place_velocity_scalar(scalar_mass_p2(geom))


def velocity_operator_element(
    geom: CellGeometry, u0_cell: np.ndarray, inv_re: float, shift: float = 0.0
) -> np.ndarray:
    """Velocity-only part of the linearized operator as (nc,15,15).

    Used for the explicit Crank-Nicolson half applied to u_n, which carries
    no pressure contribution (ref: nsforms.py:222-225).
    """
    conv = convection_block(geom, u0_cell)
    lin = linearization_block(geom, u0_cell)
    k = scalar_stiffness_p2(geom)
    a_e = place_velocity_scalar(conv + inv_re * k)
    a_e += place_linearization(lin)
    if shift:
        a_e -= shift * place_velocity_scalar(scalar_mass_p2(geom))
    return a_e


# ── Coefficient gathering ────────────────────────────────────────────────────


def velocity_cell_values(space: TaylorHoodSpace, u_nodes):
    """Gather velocity nodal values (n_vnodes, 2) -> per-cell (nc, 6, 2)."""
    return u_nodes[..., space.cell_vel_nodes, :]


def velocity_cell_dofs(space: TaylorHoodSpace) -> np.ndarray:
    """(nc, 6, 2) global mixed-dof ids of the velocity dofs per cell."""
    return 2 * space.cell_vel_nodes[:, :, None] + np.arange(2)


# ── Matrix-free application (JAX, hot path) ──────────────────────────────────


def build_gather_table(dofs_flat: np.ndarray, n_dofs: int) -> np.ndarray:
    """Transpose scatter map -> padded gather table (ELL layout).

    ``dofs_flat (m,)`` assigns each source slot (flattened per-element
    contribution) a destination dof. Returns ``table (n_dofs, kmax)`` of
    source indices, padded with ``m`` (a zero slot appended by the apply).

    This inverts the scatter into a pure GATHER + small-axis sum (no
    scatter-add inside lax.scan).
    Uses the native single-pass kernel when available.
    """
    try:
        from flowcontrol_tpu import native

        table = native.build_gather_table(dofs_flat, n_dofs)
        if table is not None:
            return table
    except Exception:
        pass
    dofs_flat = np.asarray(dofs_flat, dtype=np.int64).reshape(-1)
    m = dofs_flat.shape[0]
    order = np.argsort(dofs_flat, kind="stable")
    sorted_dofs = dofs_flat[order]
    counts = np.bincount(dofs_flat, minlength=n_dofs)
    kmax = int(counts.max()) if m else 1
    starts = np.zeros(n_dofs + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    col = np.arange(m) - starts[sorted_dofs]
    table = np.full((n_dofs, kmax), m, dtype=np.int64)
    table[sorted_dofs, col] = order
    return table.astype(np.int32)


def gather_assemble(ye_flat, table, n_dofs: int):
    """Sum per-dof contributions: ye_flat (..., m) + table (n, k) -> (..., n)."""
    padded = jnp.concatenate(
        [ye_flat, jnp.zeros(ye_flat.shape[:-1] + (1,), dtype=ye_flat.dtype)],
        axis=-1,
    )
    return jnp.take(padded, table, axis=-1).sum(axis=-1)


def apply_element_tensors_gather(a_e, cell_dofs, table, x, n_dofs: int):
    """y = A x via gather-table assembly. Supports leading batch dims."""
    xe = x[..., cell_dofs]  # (..., nc, 15)
    ye = jnp.einsum("cij,...cj->...ci", a_e, xe, precision=_PREC)
    return gather_assemble(ye.reshape(x.shape[:-1] + (-1,)), table, n_dofs)


def apply_element_tensors(a_e, cell_dofs, x, n_dofs: int):
    """y = A x with A given by element tensors. Supports leading batch dims.

    Scatter-add variant (fine on CPU; prefer the gather-table variant inside
    device scan loops).
    """
    xe = x[..., cell_dofs]  # (..., nc, 15)
    ye = jnp.einsum("cij,...cj->...ci", a_e, xe, precision=_PREC)
    batch = x.shape[:-1]
    y = jnp.zeros(batch + (n_dofs,), dtype=ye.dtype)
    return y.at[..., cell_dofs.reshape(-1)].add(ye.reshape(batch + (-1,)))


def _nonlinear_contributions(geom_dev, space: TaylorHoodSpace, u_mixed):
    """Per-element nonlinear convection contributions r_e (..., nc*12)."""
    n_vnodes = space.n_vnodes
    u_nodes = u_mixed[..., : 2 * n_vnodes].reshape(
        u_mixed.shape[:-1] + (n_vnodes, 2)
    )
    u_e = u_nodes[..., space.cell_vel_nodes, :]  # (..., nc, 6, 2)
    u_q = jnp.einsum("qn,...cnd->...cqd", geom_dev["phi2"], u_e,
                     precision=_PREC)
    g_q = jnp.einsum("cqni,...cnd->...cqid", geom_dev["dphi2"], u_e,
                     precision=_PREC)  # ∂u_d/∂x_i
    conv_q = jnp.einsum("...cqi,...cqid->...cqd", u_q, g_q, precision=_PREC)
    r_e = jnp.einsum("cq,qa,...cqd->...cad", geom_dev["wq"],
                     geom_dev["phi2"], conv_q, precision=_PREC)
    return r_e.reshape(u_mixed.shape[:-1] + (-1,))


def nonlinear_convection(geom_dev, space: TaylorHoodSpace, u_mixed):
    """N(u): assemble ∫ ((u·∇)u)·v dx into a mixed vector. Batched over u.

    ``geom_dev``: dict with wq, phi2, dphi2 (device arrays ok). Scatter-add
    variant (host/CPU); device loops use nonlinear_convection_gather.
    """
    r_flat = _nonlinear_contributions(geom_dev, space, u_mixed)
    batch = u_mixed.shape[:-1]
    vel_dofs = velocity_cell_dofs(space)
    y = jnp.zeros(batch + (space.n_dofs,), dtype=r_flat.dtype)
    return y.at[..., vel_dofs.reshape(-1)].add(r_flat)


def nonlinear_convection_gather(geom_dev, space: TaylorHoodSpace, table, u_mixed):
    """Gather-table variant of N(u) for device scan loops."""
    r_flat = _nonlinear_contributions(geom_dev, space, u_mixed)
    return gather_assemble(r_flat, table, space.n_dofs)


def geometry_device_tables(geom: CellGeometry, dtype=None) -> dict:
    """Ship the quadrature tables needed by hot kernels to a given dtype."""
    dtype = dtype or geom.dtype
    return {
        "wq": jnp.asarray(geom.wq, dtype=dtype),
        "phi2": jnp.asarray(geom.phi2, dtype=dtype),
        "dphi2": jnp.asarray(geom.dphi2, dtype=dtype),
        "phi1": jnp.asarray(geom.phi1, dtype=dtype),
    }


# ── Steady residual (for Newton + autodiff parity) ──────────────────────────


def steady_residual_element(geom_cell, up_cell, inv_re, f_cell=None):
    """Per-cell steady NS residual over local dofs (15,).

    ``geom_cell``: dict with wq (7,), phi2 (7,6), dphi2 (7,6,2), phi1 (7,3)
    for ONE cell. Autodiff of this function with jax.jacfwd gives the element
    Jacobian — the parity check against the hand-coded linearized element
    matrices (mirrors the reference's autodiff-vs-manual A test,
    ref: tests/integration/test_operatorgetter.py:89-103).
    """
    wq, phi2, dphi2, phi1 = (
        geom_cell["wq"],
        geom_cell["phi2"],
        geom_cell["dphi2"],
        geom_cell["phi1"],
    )
    u_loc = up_cell[:12].reshape(6, 2)
    p_loc = up_cell[12:]
    u_q = phi2 @ u_loc  # (7, 2)
    g_q = jnp.einsum("qni,nd->qid", dphi2, u_loc)  # ∂u_d/∂x_i
    p_q = phi1 @ p_loc  # (7,)
    div_q = g_q[:, 0, 0] + g_q[:, 1, 1]
    conv_q = jnp.einsum("qi,qid->qd", u_q, g_q)  # (u·∇)u
    # momentum rows (a, d): conv + (1/Re) ∇u:∇v - p div(v) - f·v
    r_mom = jnp.einsum("q,qa,qd->ad", wq, phi2, conv_q)
    r_mom = r_mom + inv_re * jnp.einsum("q,qai,qid->ad", wq, dphi2, g_q)
    r_mom = r_mom - jnp.einsum("q,qad,q->ad", wq, dphi2, p_q)
    if f_cell is not None:
        f_q = phi2 @ f_cell  # f interpolated on P2 nodes
        r_mom = r_mom - jnp.einsum("q,qa,qd->ad", wq, phi2, f_q)
    # continuity rows: -q div(u)
    r_cont = -jnp.einsum("q,qb,q->b", wq, phi1, div_q)
    return jnp.concatenate([r_mom.reshape(-1), r_cont])


def steady_residual(geom: CellGeometry, space: TaylorHoodSpace, up, inv_re, f_nodes=None):
    """Global steady residual vector (n_dofs,). Runs under JAX (cpu or gpu)."""
    cd = space.cell_dofs
    up_cells = up[cd]  # (nc, 15)
    if f_nodes is not None:
        f_cells = f_nodes[space.cell_vel_nodes, :]  # (nc, 6, 2)
        per_cell = lambda wq, d, u, f: steady_residual_element(
            {"wq": wq, "phi2": geom.phi2, "dphi2": d, "phi1": geom.phi1},
            u,
            inv_re,
            f,
        )
        r_e = jax.vmap(per_cell)(geom.wq, geom.dphi2, up_cells, f_cells)
    else:
        per_cell = lambda wq, d, u: steady_residual_element(
            {"wq": wq, "phi2": geom.phi2, "dphi2": d, "phi1": geom.phi1},
            u,
            inv_re,
        )
        r_e = jax.vmap(per_cell)(geom.wq, geom.dphi2, up_cells)
    y = jnp.zeros(space.n_dofs, dtype=r_e.dtype)
    return y.at[cd.reshape(-1)].add(r_e.reshape(-1))


def steady_jacobian_elements_autodiff(
    geom: CellGeometry, space: TaylorHoodSpace, up, inv_re
):
    """Element Jacobians of the steady residual via jax.jacfwd (nc, 15, 15).

    Functionally identical to dolfin.derivative + assemble
    (ref: src/flowcontrol/operatorgetter.py:61-64).
    """
    up_cells = up[space.cell_dofs]

    def per_cell(wq, dphi2, up_c):
        g = {"wq": wq, "phi2": geom.phi2, "dphi2": dphi2, "phi1": geom.phi1}
        return jax.jacfwd(lambda z: steady_residual_element(g, z, inv_re))(up_c)

    return jax.vmap(per_cell)(geom.wq, geom.dphi2, up_cells)


# ── Global sparse matrix (host-side) ─────────────────────────────────────────


def to_scipy_csr(a_e, cell_dofs, n_dofs: int):
    """Materialize element tensors into a scipy CSR matrix (f64, host)."""
    import scipy.sparse as sp

    a_e = np.asarray(a_e, dtype=np.float64)
    rows = np.repeat(cell_dofs, 15, axis=1).reshape(-1)
    cols = np.tile(cell_dofs, (1, 15)).reshape(-1)
    mat = sp.coo_matrix((a_e.reshape(-1), (rows, cols)), shape=(n_dofs, n_dofs))
    return mat.tocsr()


def assemble_vector_np(r_e: np.ndarray, dofs: np.ndarray, n_dofs: int) -> np.ndarray:
    """Host scatter-add of per-cell values (numpy)."""
    y = np.zeros(n_dofs, dtype=np.float64)
    np.add.at(y, dofs.reshape(-1), np.asarray(r_e, dtype=np.float64).reshape(-1))
    return y


def nonlinear_convection_np(
    geom: CellGeometry, space: TaylorHoodSpace, u_mixed: np.ndarray
) -> np.ndarray:
    """Host (numpy) N(u) for setup-time and reference checks."""
    u_nodes = u_mixed[: space.n_vel_dofs].reshape(space.n_vnodes, 2)
    u_e = u_nodes[space.cell_vel_nodes, :]
    u_q = np.einsum("qn,cnd->cqd", geom.phi2, u_e)
    g_q = np.einsum("cqni,cnd->cqid", geom.dphi2, u_e)
    conv_q = np.einsum("cqi,cqid->cqd", u_q, g_q)
    r_e = np.einsum("cq,qa,cqd->cad", geom.wq, geom.phi2, conv_q)
    return assemble_vector_np(r_e, velocity_cell_dofs(space), space.n_dofs)


def load_vector(geom: CellGeometry, space: TaylorHoodSpace, f_at_qp) -> np.ndarray:
    """Assemble ∫ f·v dx with f given at quadrature points (nc, 7, 2). Host."""
    r_e = np.einsum("cq,qa,cqd->cad", geom.wq, geom.phi2, np.asarray(f_at_qp))
    return assemble_vector_np(r_e, velocity_cell_dofs(space), space.n_dofs)


def quadrature_points_physical(space: TaylorHoodSpace) -> np.ndarray:
    """Physical coordinates of all volume quadrature points (nc, 7, 2)."""
    p = space.mesh.coords[space.mesh.cells]  # (nc, 3, 2)
    return np.einsum("qv,cvd->cqd", el.QP_BARY, p)

"""Matrix-free preconditioned Krylov solvers for the saddle-point NS systems.

A matrix-free alternative to direct factorization at mesh sizes where a
dense factor no longer fits device memory (ref solver: MUMPS LU,
src/flowcontrol/flowsolver.py:812-814). Design:

- The operator is applied matrix-free: gather → per-element 15x15 matvec
  → segment-sum scatter, with Dirichlet rows/cols masked to identity.
- Preconditioner: SIMPLE-type block factorization
      z_u = F̂⁻¹ r_u
      z_p = Ŝ⁻¹ (D z_u - r_p)
      z_u ← z_u - F̂⁻¹ (G z_p)
  with F̂⁻¹ = damped-Jacobi sweeps on the velocity block and
  Ŝ = D diag(F)⁻¹ G inverted EXACTLY as a precomputed dense matrix — the
  pressure space is P1 (~nv dofs), small enough that its dense inverse lives
  comfortably in device memory and applies as one matmul: the
  troublesome Schur complement becomes a dense GEMM.
- FGMRES(m) with a fixed iteration budget (static shapes for XLA) and
  warm starts from the previous time step.

All state is a pytree usable inside jit/scan/vmap.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
class MatFreeOperator:
    """BC-masked matrix-free operator from element tensors (jit-able pytree).

    Uses gather-table assembly (scatter transposed into padded gathers) —
    no scatter-add inside scan loops.
    """

    def __init__(self, a_e, cell_dofs, free_mask, n_dofs: int, table=None):
        self.a_e = a_e  # (nc, 15, 15)
        self.cell_dofs = cell_dofs  # (nc, 15)
        self.free_mask = free_mask  # (n,) 1.0 free, 0.0 Dirichlet
        self.n_dofs = n_dofs  # static
        if table is None:
            from flowcontrol_tpu.fem.assembly import build_gather_table

            table = jnp.asarray(
                build_gather_table(np.asarray(cell_dofs), n_dofs)
            )
        self.table = table

    def tree_flatten(self):
        return (self.a_e, self.cell_dofs, self.free_mask, self.table), (
            self.n_dofs,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        a_e, cell_dofs, free_mask, table = children
        return cls(a_e, cell_dofs, free_mask, n_dofs=aux[0], table=table)

    def apply(self, x):
        from flowcontrol_tpu.fem.assembly import apply_element_tensors_gather

        xm = x * self.free_mask
        y = apply_element_tensors_gather(
            self.a_e, self.cell_dofs, self.table, xm, self.n_dofs
        )
        return y * self.free_mask + x * (1.0 - self.free_mask)


@jax.tree_util.register_pytree_node_class
class HookedOperator:
    """Operator whose ``apply`` delegates to an externally-built function
    (e.g. an SPMD-sharded element apply from parallel.sharding). The
    function is pytree AUX data: any device arrays it closes over become
    jit constants, exactly like the Stepper's apply/nl hooks."""

    def __init__(self, apply_fn):
        self._apply_fn = apply_fn

    def tree_flatten(self):
        return (), (self._apply_fn,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0])

    def apply(self, x):
        return self._apply_fn(x)


@jax.tree_util.register_pytree_node_class
class SimplePreconditioner:
    """SIMPLE block preconditioner with dense Schur inverse (jit-able pytree)."""

    def __init__(self, op, inv_diag_f, s_inv, vel_mask, n_vel: int,
                 jacobi_sweeps: int = 2, omega: float = 0.8):
        self.op = op
        self.inv_diag_f = inv_diag_f  # (n,) 1/diag on velocity, 0 on pressure
        self.s_inv = s_inv  # (np_, np_) dense inverse of approximate Schur
        self.vel_mask = vel_mask  # (n,) 1.0 on velocity dofs
        self.n_vel = n_vel  # static
        self.jacobi_sweeps = jacobi_sweeps  # static
        self.omega = omega  # static

    def tree_flatten(self):
        return (
            (self.op, self.inv_diag_f, self.s_inv, self.vel_mask),
            (self.n_vel, self.jacobi_sweeps, self.omega),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        op, inv_diag_f, s_inv, vel_mask = children
        return cls(op, inv_diag_f, s_inv, vel_mask, *aux)

    def _f_hat_inv(self, r_u):
        """Damped-Jacobi approximate solve of F z = r_u (velocity block)."""
        z = self.inv_diag_f * r_u
        for _ in range(self.jacobi_sweeps - 1):
            az = self.op.apply(z * self.vel_mask) * self.vel_mask
            z = z + self.omega * self.inv_diag_f * (r_u - az)
        return z * self.vel_mask

    def apply(self, r):
        n_vel = self.n_vel
        r_u = r * self.vel_mask
        r_p = r[..., n_vel:]
        z_u = self._f_hat_inv(r_u)
        # D z_u = pressure rows of A(z_u, 0)
        d_zu = self.op.apply(z_u)[..., n_vel:]
        z_p = (d_zu - r_p) @ self.s_inv.T
        # G z_p = velocity rows of A(0, z_p)
        zp_full = jnp.zeros_like(r).at[..., n_vel:].set(z_p)
        g_zp = self.op.apply(zp_full) * self.vel_mask
        z_u = z_u - self._f_hat_inv(g_zp)
        return (z_u * self.vel_mask).at[..., n_vel:].set(z_p)


def build_simple_preconditioner(
    a_bc_csr, free_mask: np.ndarray, n_vel: int, dtype=np.float32,
    jacobi_sweeps: int = 2, op: MatFreeOperator | None = None,
) -> SimplePreconditioner:
    """Host-side construction from the BC-applied sparse matrix (f64)."""
    import scipy.sparse as sp

    n = a_bc_csr.shape[0]
    diag = np.asarray(a_bc_csr.diagonal())
    inv_diag = np.zeros(n)
    vel_sel = np.zeros(n)
    vel_sel[:n_vel] = 1.0
    # bc rows have diag 1 → inv 1 (their "solve" is identity)
    inv_diag[:n_vel] = 1.0 / np.maximum(np.abs(diag[:n_vel]), 1e-30) * np.sign(
        np.where(diag[:n_vel] == 0, 1.0, diag[:n_vel])
    )
    f_diag_inv = sp.diags(inv_diag[:n_vel]).tocsr()
    g = a_bc_csr[:n_vel, n_vel:]
    d = a_bc_csr[n_vel:, :n_vel]
    s_hat = (d @ f_diag_inv @ g).toarray()
    # pressure rows that are themselves constrained (pressure pin) appear as
    # identity rows in A → keep them identity in S
    p_diag = diag[n_vel:]
    fixed_p = np.abs(s_hat).sum(axis=1) < 1e-14
    s_hat[fixed_p, :] = 0.0
    s_hat[fixed_p, fixed_p] = 1.0
    # S_hat of the stabilized saddle point is negative definite-ish; invert as is
    s_inv = np.linalg.inv(s_hat)
    return SimplePreconditioner(
        op=op,
        inv_diag_f=jnp.asarray(inv_diag * vel_sel, dtype=dtype),
        s_inv=jnp.asarray(s_inv, dtype=dtype),
        vel_mask=jnp.asarray(vel_sel, dtype=dtype),
        n_vel=n_vel,
        jacobi_sweeps=jacobi_sweeps,
    )


# ── FGMRES (fixed iteration count, jit/vmap-friendly) ───────────────────────


def fgmres(op_apply, precond_apply, b, x0, n_iter: int, tol: float = 0.0):
    """Right-preconditioned GMRES(m) without restarts, fixed m = n_iter.

    Static shapes: always runs n_iter iterations (tol only used to damp the
    update via the computed minimizer — convergence is checked by caller).
    Supports vmap over leading batch dims of b/x0.
    """
    dtype = b.dtype
    n = b.shape[-1]
    m = n_iter

    r0 = b - op_apply(x0)
    beta = jnp.linalg.norm(r0)
    q0 = r0 / jnp.where(beta > 0, beta, 1.0)

    qs = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(q0)
    zs = jnp.zeros((m, n), dtype=dtype)
    h = jnp.zeros((m + 1, m), dtype=dtype)

    def body(k, state):
        qs, zs, h = state
        z = precond_apply(qs[k])
        w = op_apply(z)
        # modified Gram-Schmidt against all previous (masked)
        def mgs(j, acc):
            w, hcol = acc
            proj = jnp.where(j <= k, jnp.dot(qs[j], w), 0.0)
            w = w - proj * qs[j]
            return w, hcol.at[j].set(proj)

        w, hcol = jax.lax.fori_loop(0, m + 1, mgs, (w, jnp.zeros(m + 1, dtype)))
        hk1 = jnp.linalg.norm(w)
        hcol = hcol.at[k + 1].set(hk1)
        qnew = w / jnp.where(hk1 > 1e-30, hk1, 1.0)
        qs = qs.at[k + 1].set(qnew)
        zs = zs.at[k].set(z)
        h = h.at[:, k].set(hcol)
        return qs, zs, h

    qs, zs, h = jax.lax.fori_loop(0, m, body, (qs, zs, h))
    # least squares min ||beta e1 - H y||
    e1 = jnp.zeros(m + 1, dtype=dtype).at[0].set(beta)
    y, *_ = jnp.linalg.lstsq(h, e1)
    x = x0 + y @ zs
    return x


def fgmres_restarted(op_apply, precond_apply, b, x0, m: int, restarts: int):
    """FGMRES(m) with a fixed number of restart cycles."""
    x = x0
    for _ in range(restarts):
        x = fgmres(op_apply, precond_apply, b, x, m)
    return x

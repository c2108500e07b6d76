"""The plain host-f64 reference: what the device path is checked against.

``CpuLoop`` is the reference's per-step algorithm expressed on this
discretization (ref: flowsolver.py:665-701,703-799): one scipy ``splu`` of
the BDF2 matrix, then per step a host RHS assembly (mass applies and the
nonlinear term, all float64 numpy) and a back-substitution. It shares no
code with the device stepper beyond the element tensors, so agreement
between the two is evidence, not tautology.

``field_err_vs_f64`` runs a stepper rollout and the reference from the same
state and returns the relative L2 error of the final field.
``load_base_flow`` reads a committed base flow or computes one.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

#: committed Re-keyed base flows, one per generated mesh size
BASEFLOW_DIR = Path(__file__).resolve().parents[1] / "models" / "_baseflows"


class CpuLoop:
    """splu factor + per-step host RHS/backsolve, BDF2 with the nonlinear
    term extrapolated (AB2), zero control."""

    def __init__(self, fs):
        import scipy.sparse.linalg as spla

        from flowcontrol_tpu.fem.assembly import to_scipy_csr

        self.fs = fs
        self.bcs = fs._bcset_perturbation()
        lhs_e = fs.forms.transient_lhs(2, fs.fields.U0)
        a_bc, _ = self.bcs.eliminate_csr(
            to_scipy_csr(lhs_e, fs.space.cell_dofs, fs.space.n_dofs)
        )
        self.mass = to_scipy_csr(
            fs.forms.mass_elements(), fs.space.cell_dofs, fs.space.n_dofs
        )
        self.lu = spla.splu(a_bc.tocsc())
        self.dt = fs.params_time.dt

    def run(self, steps: int, u0: np.ndarray, u_prev: np.ndarray | None = None):
        """``steps`` BDF2 steps from (u0, u_prev) in mesh order; returns
        the final mixed state."""
        from flowcontrol_tpu.fem.assembly import nonlinear_convection_np

        fs, dt = self.fs, self.dt
        u_n = np.asarray(u0, dtype=np.float64).copy()
        u_nn = u_n.copy() if u_prev is None else np.asarray(u_prev, np.float64)
        for _ in range(steps):
            rhs = (2.0 / dt) * (self.mass @ u_n) - (0.5 / dt) * (self.mass @ u_nn)
            rhs = rhs - 2.0 * nonlinear_convection_np(fs.geom, fs.space, u_n)
            rhs = rhs + nonlinear_convection_np(fs.geom, fs.space, u_nn)
            rhs[self.bcs.dofs] = 0.0
            u_nn, u_n = u_n, self.lu.solve(rhs)
        return u_n

    def time_legs(self, steps: int, legs: int = 3):
        """Median-of-N host timing legs: (median steps/s, [per-leg])."""
        rng = np.random.default_rng(0)
        u0 = 1e-3 * rng.standard_normal(self.fs.space.n_dofs)
        rates = []
        for _ in range(legs):
            t0 = time.time()
            self.run(steps, u0)
            rates.append(steps / (time.time() - t0))
        return float(np.median(rates)), rates


def field_err_vs_f64(cpu: CpuLoop, st, carry, roll, steps: int = 10) -> float:
    """Relative L2 field error of ``steps`` stepper steps against the host
    f64 reference from the same (u_n, u_nn) state.

    ``roll`` is the stepper's open-loop rollout (``make_rollout_open_loop``)
    and ``carry`` an unbatched carry past the first step (the reference
    runs BDF2 throughout, so the stepper must too: ``carry.it > 0`` or a
    BDF2 start)."""
    if int(carry.it) == 0 and 1 in st._orders:
        raise ValueError("field_err_vs_f64 needs a carry past the BDF1 step")
    u0 = np.asarray(st.from_hot(carry.u_n), dtype=np.float64)
    u_prev = np.asarray(st.from_hot(carry.u_nn), dtype=np.float64)
    ref = cpu.run(steps, u0, u_prev)
    u_seq = np.zeros((steps, st.n_act), dtype=st.dtype)
    carry2, _ = roll(carry, u_seq)
    got = np.asarray(st.from_hot(carry2.u_n), dtype=np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def load_base_flow(fs, name: str) -> Path:
    """Assign the committed base flow ``<name>_n<n_dofs>.npz`` to ``fs``;
    if it is absent, compute it (Picard, then Newton, on the host) and
    save it there. Returns the file's path."""
    path = BASEFLOW_DIR / f"{name}_n{fs.space.n_dofs}.npz"
    if path.exists():
        d = np.load(path)
        fs._assign_steady_state(d["U0"], d["P0"])
        return path
    u_ctrl = [0.0] * fs.params_control.actuator_number
    fs.compute_steady_state(u_ctrl=u_ctrl, method="picard", max_iter=3)
    fs.compute_steady_state(
        u_ctrl=u_ctrl, method="newton", initial_guess=fs.fields.UP0,
        max_iter=10,
    )
    np.savez_compressed(path, U0=fs.fields.U0, P0=fs.fields.P0)
    return path

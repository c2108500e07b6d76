"""Model-based controller synthesis from exported operators + batched tuning.

The full control-design story the reference spreads across
operators-export + Matlab + lticontrol: here in one script —
1. export (A, E, B, C) around the cylinder base flow,
2. build a reduced model (balanced truncation of a stable shift of the
   descriptor system is overkill at this size; we use modal projection on
   the leading eigenmodes),
3. LQG synthesis on the reduced model (utils/lticontrol),
4. evaluate candidate controllers with BATCHED closed-loop rollouts (vmap) —
   the single-program replacement of the reference's MPI master-worker
   optimization loop (ref: src/utils/optim.py:71-107).
"""

import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import flowcontrol_tpu.utils.lticontrol as ltc
from flowcontrol_tpu.core.controller import Controller, stack_controllers
from flowcontrol_tpu.core.operatorgetter import OperatorGetter
from flowcontrol_tpu.models.cylinder import CylinderFlowSolver
from flowcontrol_tpu.utils.linalg import get_mat_vp_shift_invert

logging.basicConfig(level=logging.INFO)
cwd = Path(__file__).parent


def reduced_model(fs, n_modes=8, sigma=0.1 + 0.8j):
    """Petrov-Galerkin modal reduction of (E, A, B, C) onto leading modes."""
    og = OperatorGetter(fs)
    a, e, b, c = og.get_all(autodiff=False)
    vals, v = get_mat_vp_shift_invert(a, e, n=n_modes, sigma=sigma)
    vals_l, w = get_mat_vp_shift_invert(
        a.T.tocsr(), e.T.tocsr(), n=n_modes, sigma=np.conj(sigma)
    )
    # bi-orthogonalize: W^H E V = I
    g = w.conj().T @ (e @ v)
    w = w @ np.linalg.inv(g).conj().T
    ar = w.conj().T @ (a @ v)
    br = w.conj().T @ b
    cr = c @ v
    # realify (conjugate-pair modes): keep real part of the similarity
    ar_r = np.real(np.block([[ar.real, -ar.imag], [ar.imag, ar.real]]))
    br_r = np.vstack([br.real, br.imag])
    cr_r = np.hstack([cr.real, -cr.imag])
    return ltc.ss(ar_r, br_r, cr_r, np.zeros((cr_r.shape[0], br_r.shape[1])))


def main(num_steps=60):
    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=num_steps, verbose=0,
        mesh_kwargs=dict(yinf=5.0, xinf=15.0, xinfa=-5.0, n1=4.0, n2=2.0,
                         n3=0.8, segments=80),
        path_out=cwd / "data_output_synth",
        solver_backend="host_lu", precision="f64",
    )
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard", max_iter=3)
    fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                            initial_guess=fs.fields.UP0)

    rom = reduced_model(fs, n_modes=4)
    print("ROM:", rom, "stable:", ltc.isstable(rom))

    # LQG candidates over a small weight grid — MIMO (2 actuators, 3 sensors)
    candidates = []
    for qx in (0.1, 1.0, 10.0):
        k, _, _ = ltc.lqg_regulator(rom, qx, 1.0, 1.0, 1.0)
        candidates.append(Controller(k.A, k.B, k.C, k.D))
    dt = fs.params_time.dt

    fs.initialize_time_stepping()
    st = fs.stepper
    roll = st.make_rollout_closed_loop(num_steps, feedback_sign=-1.0)

    # batched evaluation: stack same-order controllers and vmap the rollout
    import jax
    import jax.numpy as jnp

    k_stack = stack_controllers(candidates, dt, dtype=np.float64)
    n_cand = k_stack[0].shape[0]
    up0 = np.asarray(fs._carry.u_n)
    carry_b = st.init_carry(
        jnp.asarray(np.repeat(up0[None, :], n_cand, 0), dtype=st.dtype)
    )
    y0_b = np.repeat(np.asarray(fs.y_meas)[None, :], n_cand, 0)
    _, (ys, des, us, div) = roll(carry_b, k_stack, y0_b)
    costs = np.asarray(des)[-1]  # terminal perturbation energy per candidate
    print("terminal dE per candidate:", costs)
    print(f"best candidate: #{int(np.argmin(costs))}")


if __name__ == "__main__":
    main()

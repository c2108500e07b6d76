"""Lid-driven cavity workflows: Re continuation, batched ICs, eigenvalues.

Mirrors the reference's lidcavity script collection
(ref: src/examples/lidcavity/{compute_steady_state_increasing_Re,
batch_run_lidcavity, eig_compute_lidcavity}.py). The batch run uses the
vmapped device rollout instead of a Python loop over cases.
"""

import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver

logging.basicConfig(level=logging.INFO)
cwd = Path(__file__).parent


def steady_state_increasing_Re(res=(1000, 3000, 5000, 8000), n_mesh=32):
    """Continuation in Re (ref: compute_steady_state_increasing_Re.py)."""
    guess = None
    flows = {}
    for re_k in res:
        fs = LidCavityFlowSolver.make_default(
            Re=re_k, num_steps=1, verbose=0, n_mesh=n_mesh,
            path_out=cwd / "data_output_lidcavity",
        )
        if guess is None:
            fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=5)
            guess = fs.fields.UP0
        fs.compute_steady_state(u_ctrl=[0.0], method="newton",
                                initial_guess=guess, max_iter=20)
        guess = fs.fields.UP0
        flows[re_k] = (fs.fields.U0.copy(), fs.fields.P0.copy())
        print(f"Re={re_k}: U0_max={np.abs(fs.fields.U0).max():.4f}")
    return fs, flows


def batch_run(fs, n_batch=8, num_steps=50):
    """Batched perturbed rollouts via ONE vmapped scan
    (ref: batch_run_lidcavity.py runs a Python loop of separate sims)."""
    import jax.numpy as jnp

    fs.initialize_time_stepping()
    st = fs.stepper
    rng = np.random.default_rng(0)
    up0 = np.asarray(fs._carry.u_n)
    batch = up0[None, :] + 1e-3 * rng.standard_normal((n_batch, up0.shape[0]))
    carry = st.init_carry(jnp.asarray(batch, dtype=st.dtype))
    u_seq = np.zeros((num_steps, n_batch, 1), dtype=st.dtype)
    _, outs = st.make_rollout_open_loop()(carry, u_seq)
    de = np.asarray(outs.dE)  # (T, B)
    print("final dE per batch member:", de[-1])
    return de


def eigenvalues(fs):
    """(ref: eig_compute_lidcavity.py)"""
    from flowcontrol_tpu.core.operatorgetter import OperatorGetter
    from flowcontrol_tpu.utils.linalg import get_mat_vp_shift_invert

    og = OperatorGetter(fs)
    a = og.get_A(autodiff=False)
    e = og.get_mass_matrix()
    vals, _ = get_mat_vp_shift_invert(a, e, n=6, sigma=0.0 + 0.5j)
    print("leading eigenvalues:", vals)
    return vals


if __name__ == "__main__":
    fs, flows = steady_state_increasing_Re(res=(1000, 2000))
    batch_run(fs)
    eigenvalues(fs)

"""Open cavity Re=7500 with closed-loop volume-force feedback — the stiff
flagship loop (BASELINE.json config #3) the reference DEFINES but never
closes: its cavity case ships the wall-shear feedback sensor + upstream
Gaussian volume-force actuator pair (ref:
src/examples/cavity/cavityflowsolver.py:254-268), yet its own example runs
open-loop (ref: run_cavity_example.py:73-75).

The controller artifact is synthesized from the 235k stock-mesh operators
by ``tools/cavity_feedback_synth.py`` (modal ROM around the 4 documented
unstable pairs + first-party LQG); this script deploys it in closed loop
and compares the perturbation-energy growth against the open-loop run,
which the Re=7500 instability (max growth rate +0.889,
ref: compute_eigenvalues.py:53-57) drives upward.

Usage:
    python examples/run_cavity_feedback.py [--steps 4000] [--open-loop]

(4000 steps = T 1.6: open grows 17.15x, the closed loop ends at 0.637x
the open energy — tests/integration/test_stock_parity.py.)
"""

import argparse
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from flowcontrol_tpu.core.controller import Controller
from flowcontrol_tpu.models.cavity import CavityFlowSolver

logging.basicConfig(level=logging.INFO)
log = logging.getLogger("cavity_feedback")

STOCK = Path("/root/reference/src/examples/cavity/data_input/cavity_coarse.xdmf")
PKG = Path(__file__).resolve().parents[1] / "flowcontrol_tpu" / "models"
RE = 7500.0


def main(num_steps: int = 400, closed_loop: bool = True):
    fs = CavityFlowSolver.make_default(
        Re=RE, meshpath=STOCK, num_steps=num_steps, save_every=0, verbose=10,
        path_out=Path.cwd() / "data_output_cavity_feedback",
        solver_backend="dense_lu", precision="f32",
    )
    base = PKG / "_baseflows" / f"cavity_re{RE:g}_n{fs.space.n_dofs}.npz"
    d = np.load(base)
    fs._assign_steady_state(d["U0"], d["P0"])
    log.info("loaded committed base flow %s", base.name)
    # initialize ON the leading unstable mode (synthesized artifact): the
    # closed-vs-open contrast then measures the subspace the controller
    # targets — a generic Gaussian bump mostly excites stable transients
    # that swamp it at a 400-step horizon (measured: identical dE)
    mode = np.load(PKG / "_controllers" / f"cavity_mode_re{RE:g}.npz")
    fs.params_ic.amplitude = 0.0
    ic = 1e-3 * np.asarray(mode["v_re"], dtype=float)
    log.info("IC = 1e-3 x Re(v) of mode %s", mode["eig"])
    fs.initialize_time_stepping(ic=ic)

    kpath = PKG / "_controllers" / f"cavity_lqg_re{RE:g}.mat"
    if closed_loop and not kpath.exists():
        raise SystemExit(
            f"{kpath} missing — run tools/cavity_feedback_synth.py first"
        )
    K = Controller.from_file(kpath) if closed_loop else None

    dt = fs.params_time.dt
    for _ in range(num_steps):
        if K is not None:
            # u = +K(y): the interconnection whose closed-loop spectrum
            # the synthesis tool certifies (see run_pinball_feedback.py)
            u_ctrl = K.step(y=np.asarray(fs.y_meas), dt=dt)
        else:
            u_ctrl = np.zeros(1)
        fs.step(u_ctrl=np.asarray(u_ctrl).reshape(-1))
    fs.write_timeseries()

    ts = fs.timeseries
    dE = ts["dE"].to_numpy()
    log.info("mode=%s  dE: start %.3e  peak %.3e  end %.3e",
             "closed" if closed_loop else "open", dE[0], dE.max(), dE[-1])
    print(f"{'closed' if closed_loop else 'open'}-loop: "
          f"dE_end={dE[-1]:.4e} dE_peak={dE.max():.4e} "
          f"y_last={np.asarray(fs.y_meas).round(6)}")
    return ts


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--open-loop", action="store_true")
    args = ap.parse_args()
    main(num_steps=args.steps, closed_loop=not args.open_loop)

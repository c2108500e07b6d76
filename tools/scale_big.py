"""Past the reference's biggest case: a >=500k-dof cylinder through the
production multifrontal path on one GPU.

The reference's largest shipped artifact is the 235k-dof stock cavity
(its MUMPS flagship, ref: src/flowcontrol/flowsolver.py:812-814); this
tool generates a graded cylinder mesh at ~2x that, computes the base
flow, and runs the dense_lu/f32 (multifrontal) stepper on the
GPU — the scaling-axis evidence that the device build exceeds the
reference rather than matching it (SURVEY §5.7). The sharded solve
(parallel/mf_sharded.py) makes per-device factor bytes O(total/n_dev)
where a single card runs out.

Usage:
  python tools/scale_big.py sizes          # print candidate mesh sizes
  python tools/scale_big.py run [density]  # full run (default density 29)

Measured sizes (graded cylinder mesh, round 5): density 12 -> 87,548
dofs; dofs grow ~density^2, so >=500k needs density ~29.
"""
import logging
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

logging.basicConfig(level=logging.INFO)
log = logging.getLogger("scale_big")

CACHE = Path("/tmp/scale_big")
CACHE.mkdir(exist_ok=True)


def build(density: float, backend: str, precision: str, num_steps: int = 50):
    from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

    kw = dict(yinf=10.0, n1=density, n2=density / 2.0, n3=density / 5.5,
              segments=int(24 * density))
    return CylinderFlowSolver.make_default(
        Re=100, num_steps=num_steps, save_every=0, verbose=10,
        path_out=CACHE / "out", solver_backend=backend, precision=precision,
        mesh_kwargs=kw,
    )


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else "sizes"
    if cmd == "sizes":
        import jax

        jax.config.update("jax_platforms", "cpu")
        for d in (12.0, 24.0, 29.0, 32.0):
            t0 = time.time()
            fs = build(d, "host_lu", "f64", num_steps=1)
            log.info("density %.0f: %d cells, %d dofs (%.0fs)",
                     d, fs.mesh.num_cells, fs.space.n_dofs, time.time() - t0)
        return

    density = float(sys.argv[2]) if len(sys.argv) > 2 else 29.0
    t0 = time.time()
    fs = build(density, "dense_lu", "f32")
    n = fs.space.n_dofs
    log.info("mesh: %d cells, %d dofs (%.0fs)", fs.mesh.num_cells, n,
             time.time() - t0)
    assert n > 400_000, f"density {density} only reached {n} dofs"

    base = CACHE / f"baseflow_n{n}.npz"
    if base.exists():
        d = np.load(base)
        fs._assign_steady_state(d["U0"], d["P0"])
    else:
        fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard",
                                max_iter=4)
        fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="newton",
                                max_iter=8, initial_guess=fs.fields.UP0)
        np.savez_compressed(base, U0=fs.fields.U0, P0=fs.fields.P0)
        log.info("base flow done (%.0fs)", time.time() - t0)

    t1 = time.time()
    fs.initialize_time_stepping()
    fs.order = 2
    fs._prepare_systems()
    fs.first_step = False
    prepare_s = time.time() - t1
    st = fs._stepper
    log.info("prepare: %.0fs, kinds=%s", prepare_s, st._solver_kinds)

    roll = st.make_rollout_open_loop()
    u_seq = np.zeros((50, st.n_act), dtype=st.dtype)
    t1 = time.time()
    _, outs = roll(fs._carry, u_seq)
    _ = np.asarray(outs.y)
    compile_s = time.time() - t1
    t1 = time.time()
    _, outs = roll(fs._carry, u_seq)
    y = np.asarray(outs.y)
    single = 50 / (time.time() - t1)
    assert np.isfinite(np.asarray(outs.dE)).all(), "diverged"
    print(f"RESULT n_dofs={n} single={single:.1f} steps/s "
          f"prepare={prepare_s:.0f}s compile={compile_s:.0f}s "
          f"y_last={y[-1].round(6)}")


if __name__ == "__main__":
    main()

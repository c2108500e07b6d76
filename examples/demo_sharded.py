"""SPMD sharded-execution demo (the reference's MPI smoke-test analogue).

Mirrors ref: src/examples/mpitest/demo_poisson.py (an annotated MPI Poisson
demo) with the device-mesh equivalent: an element-sharded simulation step over
a jax.sharding.Mesh of all visible devices, verifying it matches the
single-device result. Run with
``XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu``
for a virtual 8-device mesh.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


def main():
    import os

    import jax

    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        # pin in-process as well: the env var alone can be overridden
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flowcontrol_tpu.models.lidcavity import LidCavityFlowSolver
    from flowcontrol_tpu.parallel.sharding import shard_stepper

    fs = LidCavityFlowSolver.make_default(
        Re=500, num_steps=5, verbose=0, n_mesh=16,
        path_out=Path("/tmp/demo_sharded"),
        solver_backend="dense_lu", precision="f64",
    )
    fs.compute_steady_state(u_ctrl=[0.0], method="picard", max_iter=4)
    fs.compute_steady_state(u_ctrl=[0.0], method="newton",
                            initial_guess=fs.fields.UP0)
    fs.initialize_time_stepping()
    st = fs.stepper

    # single-device reference
    step = jax.jit(st.step_fn())
    carry = st.init_carry(fs._carry.u_n)
    for _ in range(3):
        carry, out = step(st._dev, carry, jnp.zeros(1))
    ref = np.asarray(carry.u_n)

    # sharded: elements over a 'space' axis across all devices
    devs = jax.devices()
    mesh = Mesh(np.array(devs), ("space",))
    shard_stepper(st, mesh, axis="space")
    carry = st.init_carry(fs._carry.u_n)
    # raise XLA CPU's in-process collective rendezvous timeouts (default
    # 40s aborts the process): with more partitions than physical cores the
    # partition threads time-share and can legitimately exceed it
    copts = None
    if devs[0].platform == "cpu":
        copts = {
            "xla_cpu_collective_call_warn_stuck_seconds": 120,
            "xla_cpu_collective_call_terminate_timeout_seconds": 1200,
        }
    with mesh:
        step_sh = (
            jax.jit(st.step_fn())
            .lower(st._dev, carry, jnp.zeros(1))
            .compile(compiler_options=copts)
        )
        for _ in range(3):
            carry, out = step_sh(st._dev, carry, jnp.zeros(1))
    sh = np.asarray(carry.u_n)
    err = np.abs(sh - ref).max()
    print(f"devices: {len(devs)}, sharded-vs-single max err: {err:.2e}")
    assert err < 1e-9

    # ── Krylov leg: the GMRES matvec (solver + preconditioner) is sharded ──
    fs2 = LidCavityFlowSolver.make_default(
        Re=500, num_steps=5, verbose=0, n_mesh=16,
        path_out=Path("/tmp/demo_sharded_gmres"),
        solver_backend="gmres", precision="f64",
    )
    fs2._assign_steady_state(fs.fields.U0.copy(), fs.fields.P0.copy())
    fs2.initialize_time_stepping()
    st2 = fs2.stepper
    step2 = jax.jit(st2.step_fn())
    carry2 = st2.init_carry(fs2._carry.u_n)
    carry2, _ = step2(st2._dev, carry2, jnp.zeros(1))
    ref2 = np.asarray(carry2.u_n)

    shard_stepper(st2, mesh, axis="space")
    carry2 = st2.init_carry(fs2._carry.u_n)
    with mesh:
        step2_sh = (
            jax.jit(st2.step_fn())
            .lower(st2._dev, carry2, jnp.zeros(1))
            .compile(compiler_options=copts)
        )
        carry2, _ = step2_sh(st2._dev, carry2, jnp.zeros(1))
    err2 = np.abs(np.asarray(carry2.u_n) - ref2).max()
    print(f"gmres sharded-vs-single max err: {err2:.2e}")
    assert err2 < 1e-9
    print("sharded demo OK")


if __name__ == "__main__":
    main()

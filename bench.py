"""Benchmark: cylinder Re=100 time-stepping throughput on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

Configuration (BASELINE.json headline): cylinder Re=100, dt=0.005, BDF2
stepping with the nonlinear perturbation term, on a generated cylinder at
the reference's production scale (55,955 mixed dofs, the size of its stock
mesh O1; BENCH_MESH=small selects the 14,661-dof mesh). The host baseline
runs the reference's algorithm (splu factor + per-step RHS/backsolve,
core/reference.py) on the SAME mesh.

The device legs: a single-stream rollout, a batched (B=512) open-loop
rollout and a B=256 closed-loop rollout, each a fused lax.scan, plus the
10-step field error against the host f64 loop. The run needs a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

BENCH_STEPS = int(os.environ.get("BENCH_STEPS", "400"))
BENCH_BATCH = int(os.environ.get("BENCH_BATCH", "512"))
BENCH_BATCH_STEPS = int(os.environ.get("BENCH_BATCH_STEPS", "100"))
CPU_STEPS = int(os.environ.get("BENCH_CPU_STEPS", "20"))
#: "full" = the 55,955-dof generated cylinder (production scale);
#: "small" = the 14,661-dof graded mesh
BENCH_MESH = os.environ.get("BENCH_MESH", "full")
MESH_KWARGS = {
    "full": dict(yinf=10.0, n1=9.4, n2=4.7, n3=9.4 / 5.5, segments=225),
    "small": dict(yinf=10.0, n1=4.5, n2=2.2, n3=0.8, segments=100),
}


def build_solver():
    from flowcontrol_tpu.core.reference import load_base_flow
    from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=BENCH_STEPS, verbose=0,
        mesh_kwargs=MESH_KWARGS[BENCH_MESH],
    )
    load_base_flow(fs, "cylinder_re100")
    return fs


def bench_device(fs, cpu) -> dict:
    import jax.numpy as jnp

    from flowcontrol_tpu.core.controller import Controller
    from flowcontrol_tpu.core.reference import field_err_vs_f64

    fs.params_restart = None
    fs.initialize_time_stepping()
    fs.order = 2  # BDF2 from the first step: single factorization
    fs._prepare_systems()
    fs.first_step = False
    st = fs._stepper
    carry = fs._carry
    roll = st.make_rollout_open_loop()

    u_seq = np.zeros((BENCH_STEPS, st.n_act), dtype=st.dtype)
    t0 = time.time()
    _, outs = roll(carry, u_seq)
    _ = np.asarray(outs.y)
    compile_s = time.time() - t0
    t0 = time.time()
    _, outs = roll(carry, u_seq)
    _ = np.asarray(outs.y)
    single = BENCH_STEPS / (time.time() - t0)
    assert np.isfinite(np.asarray(outs.dE)).all(), "diverged"
    ferr = field_err_vs_f64(cpu, st, carry, roll)

    up_b = np.asarray(st.from_hot(carry.u_n))[None, :].repeat(BENCH_BATCH, 0)
    carry_b = st.init_carry(jnp.asarray(up_b, dtype=st.dtype))
    useq_b = np.zeros((BENCH_BATCH_STEPS, BENCH_BATCH, st.n_act),
                      dtype=st.dtype)
    _, outs_b = roll(carry_b, useq_b)
    _ = np.asarray(outs_b.y)
    t0 = time.time()
    _, outs_b = roll(carry_b, useq_b)
    _ = np.asarray(outs_b.y)
    batched = BENCH_BATCH_STEPS * BENCH_BATCH / (time.time() - t0)

    # batched CLOSED-LOOP rollouts: a population of B controllers stepped in
    # lockstep with B plant copies — the BASELINE.json synthesis metric
    # ("256 vmapped rollouts"): a small stable controller with a gain sweep,
    # fused controller+plant scan on device
    k = Controller.from_matrices(
        A=np.array([[-2.0, 1.0], [0.0, -3.0]]),
        B=np.array([[0.5], [1.0]]), C=np.array([[0.2, 0.1]]),
        D=np.zeros((1, 1)),
    )
    b_cl = 256
    ad, bd, cd, dd = k.discrete(fs.params_time.dt, dtype=st.dtype)
    sel = np.zeros((1, st.ns), dtype=st.dtype)
    sel[0, 0] = 1.0  # feed back sensor 1 (ref: run_cylinder_example.py:84)
    dup = np.ones((st.n_act, 1), dtype=st.dtype)  # same u on both slots
    gains = np.linspace(0.5, 1.5, b_cl, dtype=st.dtype)
    k_mats = (
        np.broadcast_to(ad, (b_cl,) + ad.shape),
        np.broadcast_to(bd @ sel, (b_cl,) + (bd.shape[0], st.ns)),
        gains[:, None, None] * (dup @ cd),
        gains[:, None, None] * (dup @ dd @ sel),
    )
    up_b = np.asarray(st.from_hot(carry.u_n))[None, :].repeat(b_cl, 0)
    carry_b = st.init_carry(jnp.asarray(up_b, dtype=st.dtype))
    y0 = np.zeros((b_cl, st.ns), dtype=st.dtype)
    roll_cl = st.make_rollout_closed_loop(BENCH_BATCH_STEPS)
    _, outs_cl = roll_cl(carry_b, k_mats, y0)
    _ = np.asarray(outs_cl[0])
    t0 = time.time()
    _, outs_cl = roll_cl(carry_b, k_mats, y0)
    _ = np.asarray(outs_cl[0])
    closed = BENCH_BATCH_STEPS * b_cl / (time.time() - t0)
    assert np.isfinite(np.asarray(outs_cl[1])).all(), "closed-loop diverged"
    return {
        "single": single, "batched": batched, "closed": closed,
        "compile_s": compile_s, "field_err_10step_vs_f64": ferr,
    }


def main():
    import jax

    from flowcontrol_tpu.core.reference import CpuLoop

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    fs = build_solver()
    print(f"# mesh: {fs.mesh.num_cells} cells, {fs.space.n_dofs} dofs",
          file=sys.stderr)

    t_leg = time.time()
    cpu = CpuLoop(fs)
    cpu_sps, cpu_legs = cpu.time_legs(CPU_STEPS)
    print(f"# host baseline (splu, same mesh, median of 3): {cpu_sps:.2f} "
          f"steps/s (legs {[round(r, 2) for r in cpu_legs]}) "
          f"[leg {time.time() - t_leg:.0f}s]", file=sys.stderr)

    res = bench_device(fs, cpu)
    print(
        f"# {dev.device_kind}: {res['single']:.1f} steps/s single, "
        f"{res['batched']:.0f} agg steps/s batched (B={BENCH_BATCH}), "
        f"{res['closed']:.0f} agg steps/s closed-loop (B=256), "
        f"setup+compile {res['compile_s']:.1f}s",
        file=sys.stderr,
    )
    single = res["single"]
    print(json.dumps({
        "metric": "cylinder_re100_steps_per_sec",
        "value": round(single, 1),
        "unit": (
            f"single-stream steps/s (n_dofs={fs.space.n_dofs}, dt=0.005, "
            f"BDF2+AB2, host_same_mesh={cpu_sps:.1f}/s; batched/closed-loop "
            f"aggregates in sibling fields)"
        ),
        "vs_baseline": round(single / cpu_sps, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "batched_agg_steps_per_sec": round(res["batched"], 1),
        "batched_B": BENCH_BATCH,
        "closed_loop_agg_steps_per_sec": round(res["closed"], 1),
        "closed_loop_B": 256,
        "setup_compile_s": round(res["compile_s"], 1),
        "cpu_steps_per_sec": round(cpu_sps, 2),
        "cpu_steps_per_sec_spread": [round(min(cpu_legs), 2),
                                     round(max(cpu_legs), 2)],
        "field_err_10step_vs_f64": float(
            f"{res['field_err_10step_vs_f64']:.3g}"
        ),
        "n_dofs": fs.space.n_dofs,
    }))


if __name__ == "__main__":
    main()

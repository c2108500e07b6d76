"""Component-level timing of the single-stream step on the stock meshes.

Times, per executed iteration on the accelerator (batch=1):
  - full step        (the production step_fn)
  - solve only       (the multifrontal direct solve, per order)
  - rhs only         (mass/lvel element applies + lifting)
  - nl only          (the nonlinear convection quadrature kernel)
  - m-apply only     (one mass element apply)
so the single-stream latency budget (VERDICT r2 item 3) is attributable,
not guessed. Ref hot loop being matched:
/root/reference/src/flowcontrol/flowsolver.py:703-799.

Measurement protocol: every leg runs `reps` iterations inside ONE
`lax.scan` whose body reads the input through
`jax.lax.optimization_barrier` (so XLA can neither hoist the body out of
the loop nor dead-code it) and accumulates a scalar from the outputs
which is fetched to host. Per-iteration time = (wall - null-execution
overhead) / reps. Large operands (factor stacks, dev) are passed as jit
ARGUMENTS — closing over them bakes them into the HLO as literals.
A profiler trace (jax.profiler) is the better source of per-kernel device
time on the GPU; this tool gives the wall-clock split.
"""
from __future__ import annotations

import os as _os
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

O1 = Path("/root/reference/src/examples/cylinder/data_input/O1.xdmf")

REPS = int(_os.environ.get("FC_PROFILE_REPS", "100"))

_NULL_S: float | None = None


def _null_overhead_s() -> float:
    """Fixed wall cost of one executed+fetched jitted call (dispatch,
    host sync) — subtracted from every measurement."""
    global _NULL_S
    if _NULL_S is None:
        g = jax.jit(lambda x: x + 1.0)
        _ = np.asarray(g(jnp.float32(0.0)))
        ts = []
        for i in range(5):
            t0 = time.perf_counter()
            _ = np.asarray(g(jnp.float32(i)))
            ts.append(time.perf_counter() - t0)
        _NULL_S = min(ts)
    return _NULL_S


def timed(fn, consts, x0, reps: int | None = None) -> float:
    """ms per iteration of ``fn(consts, x)`` run `reps` times on-device.

    ``consts`` is any pytree of operands that stay fixed across
    iterations (weights/factors); ``x0`` is the pytree fed through the
    optimization barrier each iteration. Returns milliseconds.
    """
    reps = REPS if reps is None else reps

    def body(carry, _, consts):
        x, acc = carry
        y = fn(consts, jax.lax.optimization_barrier(x))
        leaves = [l for l in jax.tree_util.tree_leaves(y)
                  if hasattr(l, "dtype")]
        # FULL-output reduction: consuming only y[0] lets XLA dead-code
        # the einsums down to one output row (measured: 37 TB/s "achieved
        # bandwidth", 45x over the HBM roofline — garbage)
        s = sum(jnp.sum(jnp.real(l)).astype(jnp.float32) for l in leaves)
        # thread the output back into the carry THROUGH a barrier:
        # x_{i+1} formally depends on y_i, so no iteration can be hoisted
        # by loop-invariant code motion. (An arithmetic tie like
        # x + s*0.0 risks being algebraically simplified away.)
        x, _ = jax.lax.optimization_barrier((x, s))
        return (x, acc + s), None

    def run(consts, x):
        (_, acc), _ = jax.lax.scan(
            partial(body, consts=consts), (x, jnp.float32(0.0)), None,
            length=reps)
        return acc

    f = jax.jit(run)
    _ = np.asarray(f(consts, x0))  # compile + first full execution
    t0 = time.perf_counter()
    _ = np.asarray(f(consts, x0))
    wall = time.perf_counter() - t0
    return max(wall - _null_overhead_s(), 0.0) / reps * 1e3


def _bw_probe() -> None:
    """Calibrate the protocol against the chip's HBM roofline: one fused
    read of a 1-GiB constant per iteration. If this prints more than the
    datasheet bandwidth, the protocol is leaking (hoisting/DCE) and every
    other number on this run is suspect."""
    c = jnp.zeros((256, 1024, 1024), jnp.float32)
    t = timed(lambda c, x: jnp.sum(c + x), c, jnp.float32(0.0), reps=20)
    print(f"HBM probe : {t:7.3f} ms / 1 GiB read -> "
          f"{(2**30 / 1e9) / (t / 1e3):.0f} GB/s achieved")


def _solve_microbench(st, oi):
    """Inside-the-solve attribution: time the factor einsums ALONE at the
    real stage shapes, so 'solve is slow' separates into 'the batched
    matvec lowering is slow' vs 'the graph around it is slow'. Also times
    an 8-RHS panel — if it costs ~the same as 1-RHS, the single-RHS
    matvec is leaving most of the factor-read bandwidth unused."""
    tree = st._dev["solvers"][oi]
    if not isinstance(tree, dict) or "stages" not in tree:
        print("  (solve microbench: not a multifrontal solver — skipped)")
        return
    stages = tree["stages"]
    ji = "inv_t" in stages[0]
    ik, gk, fk = ("inv_t", "ginv_t", "fbi_t") if ji else ("inv", "ginv", "fbi")
    fwd_bytes = sum(s[ik].nbytes + s[fk].nbytes for s in stages)
    bwd_bytes = sum(s[gk].nbytes for s in stages)

    def fwd_einsums(stgs, x_parts):
        outs = []
        for s, xe in zip(stgs, x_parts):
            if ji:
                z = jnp.einsum("mji,...mj->...mi", s[ik], xe)
                outs.append(jnp.einsum("mib,...mi->...mb", s[fk], z))
            else:
                z = jnp.einsum("mij,...mj->...mi", s[ik], xe)
                outs.append(jnp.einsum("mbi,...mi->...mb", s[fk], z))
        return outs

    xs = [
        jnp.zeros((s[ik].shape[0], s[ik].shape[1]), dtype=s[ik].dtype)
        for s in stages
    ]
    stk = [{ik: jnp.asarray(s[ik]), fk: jnp.asarray(s[fk])} for s in stages]
    t_ein = timed(fwd_einsums, stk, xs, reps=200)
    gbs = (fwd_bytes / 1e9) / (t_ein / 1e3)
    print(f"  fwd factor einsums alone: {t_ein:7.3f} ms "
          f"({fwd_bytes / 2**30:.2f} GB -> {gbs:.0f} GB/s)")

    # same einsums with an 8-wide RHS panel: bytes identical, flops x8
    xs8 = [jnp.zeros((8,) + x.shape, dtype=x.dtype) for x in xs]
    t_ein8 = timed(fwd_einsums, stk, xs8, reps=200)
    print(f"  fwd einsums, 8-RHS panel: {t_ein8:7.3f} ms "
          f"(x{t_ein8 / t_ein:.2f} vs 1-RHS; bytes equal)")

    # backward (ginv) einsums — the other half of the factor traffic
    def bwd_einsums(stgs, x_parts):
        if ji:
            return [jnp.einsum("mbi,...mb->...mi", s[gk], xe)
                    for s, xe in zip(stgs, x_parts)]
        return [jnp.einsum("mib,...mb->...mi", s[gk], xe)
                for s, xe in zip(stgs, x_parts)]

    gstk = [{gk: jnp.asarray(s[gk])} for s in stages]
    gxs = [
        jnp.zeros(((s[gk].shape[0],) + (s[gk].shape[1],)), dtype=s[gk].dtype)
        if ji else
        jnp.zeros((s[gk].shape[0], s[gk].shape[2]), dtype=s[gk].dtype)
        for s in stages
    ]
    try:
        t_bwd = timed(bwd_einsums, gstk, gxs, reps=200)
        gbs_b = (bwd_bytes / 1e9) / (t_bwd / 1e3)
        print(f"  bwd factor einsums alone: {t_bwd:7.3f} ms "
              f"({bwd_bytes / 2**30:.2f} GB -> {gbs_b:.0f} GB/s)")
    except Exception as e:
        print(f"  (bwd einsum leg skipped: {e})")

    # the NON-einsum half of the solve: inbox gather-sums (forward) and
    # boundary gathers (backward) at the real shapes/tables
    meta = st._schur_static[oi]["stages"]
    total_contrib = st._schur_static[oi]["total_contrib"]
    total = st._schur_static[oi]["total"]
    itabs = [{"t": jnp.asarray(t)} for s in stages for t in s["inbox_ts"]]
    n_gathered = sum(
        int(np.prod(t.shape)) for s in stages for t in s["inbox_ts"]
    )

    def inbox_legs(tabs, buf):
        outs = []
        for tb in tabs:
            padded = jnp.concatenate([buf, jnp.zeros((1,), buf.dtype)])
            outs.append(jnp.take(padded, tb["t"], axis=-1).sum(axis=-2))
        return outs

    buf0 = jnp.zeros((total_contrib,), jnp.float32)
    t_inbox = timed(inbox_legs, itabs, buf0, reps=200)
    print(f"  inbox gather-sums alone:  {t_inbox:7.3f} ms "
          f"({n_gathered / 1e6:.2f} M gathered elems)")

    btabs = [{"t": jnp.asarray(s["bd"])} for s in stages]
    n_bd = sum(int(s["bd"].shape[0]) for s in stages)

    def bd_legs(tabs, x):
        return [jnp.take(x, tb["t"], axis=-1) for tb in tabs]

    x0 = jnp.zeros((total + 1,), jnp.float32)
    t_bd = timed(bd_legs, btabs, x0, reps=200)
    print(f"  bwd bd gathers alone:     {t_bd:7.3f} ms "
          f"({n_bd / 1e3:.0f} k gathered elems)")
    print(f"  factor bytes fwd/bwd: {fwd_bytes / 2**30:.2f} / "
          f"{bwd_bytes / 2**30:.2f} GB, {len(stages)} stages")


def main():
    import os

    # experiment knobs: FC_WINDOWED_NL=onehot|take, FC_BANDED=0|1,
    # FC_PROFILE_MESH=cavity (235k stock cavity instead of the O1 cylinder)
    opts = {}
    if os.environ.get("FC_WINDOWED_NL"):
        opts["windowed_nl"] = os.environ["FC_WINDOWED_NL"]
    if os.environ.get("FC_BANDED"):
        opts["banded_operators"] = os.environ["FC_BANDED"] == "1"
    if os.environ.get("FC_FACTOR_DTYPE"):
        opts["factor_dtype"] = os.environ["FC_FACTOR_DTYPE"]
    if os.environ.get("FC_REFINE"):
        opts["refine_steps"] = int(os.environ["FC_REFINE"])
    baseflows = Path(__file__).resolve().parents[1] / \
        "flowcontrol_tpu/models/_baseflows"
    if os.environ.get("FC_PROFILE_MESH") == "cavity":
        from flowcontrol_tpu.models.cavity import CavityFlowSolver

        fs = CavityFlowSolver.make_default(
            Re=7500,
            meshpath=Path("/root/reference/src/examples/cavity/data_input/"
                          "cavity_coarse.xdmf"),
            num_steps=10, save_every=0, path_out=Path("/tmp/profile_step"),
            verbose=10, solver_backend="dense_lu", precision="f32",
            stepper_options=opts,
        )
        d = np.load(baseflows / f"cavity_re7500_n{fs.space.n_dofs}.npz")
        fs._assign_steady_state(d["U0"], d["P0"])
    else:
        fs = CylinderFlowSolver.make_default(
            Re=100, meshpath=O1, num_steps=10, save_every=0,
            path_out=Path("/tmp/profile_step"), verbose=10,
            solver_backend="dense_lu", precision="f32",
            stepper_options=opts,
        )
        base = baseflows / f"cylinder_re100_n{fs.space.n_dofs}.npz"
        if base.exists():
            d = np.load(base)
            fs._assign_steady_state(d["U0"], d["P0"])
        else:
            fs.compute_steady_state(u_ctrl=[0.0, 0.0], method="picard",
                                    max_iter=2)
    fs.initialize_time_stepping()
    st = fs.stepper  # lazily prepares systems + carry
    dev = st._dev
    n = st.space.n_dofs

    carry = fs._carry
    u_ctrl = jnp.zeros((st.n_act,), dtype=st.dtype)

    d0 = jax.devices()[0]
    print(f"n_dofs={n}  platform={d0.platform} "
          f"({getattr(d0, 'device_kind', '?')})  "
          f"null-exec overhead={_null_overhead_s() * 1e3:.1f} ms  reps={REPS}")
    _bw_probe()

    # FC_PROFILE_LEGS=components skips the two full-step legs: at the 235k
    # cavity the barrier-wrapped full-step scan is a long cold XLA compile
    # (the bench rollout variant rides the persistent cache), while the
    # component legs compile in seconds
    # and attribute the same budget. The full-step wall time is then taken
    # from the bench rollout instead.
    legs = os.environ.get("FC_PROFILE_LEGS", "all")
    if legs != "components":
        # full step, cond-in-scan exactly as the rollout runs it (carry.it
        # is traced, so is1 is data-dependent like in lax.scan)
        step_fn = st.step_fn()
        t_step = timed(lambda d, c: step_fn(d, c, u_ctrl), dev, carry)

        # the same step but pinned past the BDF1 ramp (it=1): measures
        # whether the traced cond costs a second solve inside the loop
        carry1 = carry._replace(it=jnp.asarray(1, dtype=jnp.int32))
        t_step1 = timed(lambda d, c: step_fn(d, c, u_ctrl), dev, carry1)
    else:
        t_step = t_step1 = float("nan")

    nl_f = lambda d, x: st._nl(d, x)
    nl0 = jax.jit(nl_f)(dev, carry.u_n)
    t_nl = timed(nl_f, dev, carry.u_n)
    rhs_f = lambda d, t: st._rhs(d, 2, t[0], u_ctrl, t[1])
    t_rhs = timed(rhs_f, dev, (carry, nl0))

    rhs0 = jax.jit(rhs_f)(dev, (carry, nl0))
    ts_solve = {}
    for oi, kind in enumerate(st._solver_kinds):
        if kind in ("borrowed", "host"):
            # 'borrowed' has no factors of its own (BDF1 rides the BDF2
            # factor via Richardson inside _solve); 'host' is not a device
            # leg. Neither is a _dense_solve_once target.
            continue
        ts_solve[oi] = timed(lambda d, b, _oi=oi:
                             st._dense_solve_once(d, _oi, b), dev, rhs0)
    oi = max(ts_solve)
    rhs8 = jnp.broadcast_to(rhs0, (8,) + rhs0.shape)
    t_solve8 = timed(lambda d, b: st._dense_solve_once(d, oi, b), dev, rhs8)

    t_m = timed(lambda d, x: st._apply(d, "m", x), dev, carry.u_n)
    try:
        t_lvel = timed(lambda d, x: st._apply(d, "lvel", x), dev, carry.u_n)
    except Exception:
        t_lvel = float("nan")

    try:
        x0 = jax.jit(lambda d, b: st._dense_solve_once(d, oi, b))(dev, rhs0)
        t_res = timed(lambda d, t: st._residual(d, oi, t[0], t[1]),
                      dev, (rhs0, x0))
    except Exception:
        t_res = float("nan")

    t_solve = ts_solve[oi]
    print(f"full step : {t_step:7.3f} ms  ({1e3 / t_step:6.1f} steps/s)  "
          f"[it=1: {t_step1:7.3f} ms]")
    per_order = "  ".join(f"oi={k}: {v:7.3f} ms" for k, v in ts_solve.items())
    print(f"  solve   : {per_order}   (B=8 oi={oi}: {t_solve8:7.3f} ms, "
          f"x{t_solve8 / t_solve:.2f})")
    _solve_microbench(st, oi)
    print(f"  rhs     : {t_rhs:7.3f} ms")
    print(f"  nl conv : {t_nl:7.3f} ms")
    print(f"  m apply : {t_m:7.3f} ms")
    print(f"  lvel    : {t_lvel:7.3f} ms")
    print(f"  residual: {t_res:7.3f} ms")
    acc = t_solve + t_rhs + t_nl + t_m
    print(f"  sum(solve+rhs+nl+m) = {acc:.3f} ms; step - sum = "
          f"{t_step - acc:.3f} ms (sensors, carry, cond)")


if __name__ == "__main__":
    main()

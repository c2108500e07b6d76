"""Smoke run of the main path on the GPU: the 56k-dof cylinder end to end.

    python chip_smoke.py              # one GPU: every phase below
    python chip_smoke.py --four-gpus  # four GPUs: the sharded path only

One process drives the card; ``nvidia-smi`` is read by a child process that
never imports JAX. On one GPU the phases are:

1. ``precision``: what an f32 dot lowers to at DEFAULT/HIGH/HIGHEST on this
   card, and whether a one-hot pick through it is exact.
2. ``main``: ``CylinderFlowSolver.make_default(Re=100)`` on the generated
   55,955-dof cylinder with ``solver_backend='auto'``, ``precision='auto'``
   (the regime the platform policy gives a GPU is asserted on the built
   stepper), 3 imperative ``fs.step()`` calls, a 50-step single-stream
   rollout, a B=8 batched open-loop rollout and a B=8 fused closed-loop
   rollout of 20 steps, and the 10-step field error against the host f64
   splu loop.
3. ``layers``: the mass apply, N(u) and the solve of the built stepper,
   each against its plain host reference at 56k.
4. ``nl``: the step timed with each N(u) variant (windowed one-hot,
   windowed take, gather-table).
5. ``dense``: the 14,661-dof cylinder, which the policy puts in the
   one-dense-factor regime, with its 10-step field error.

Every phase that fails stops the run with a non-zero exit and no ``ok``
line. The last line is ``{"ok": true, "device": {...}}``. Times are printed
as context, not as metrics: compile and steady seconds of each phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

#: the generated cylinder at the reference's production scale (55,955 dofs)
MESH_56K = dict(yinf=10.0, n1=9.4, n2=4.7, n3=9.4 / 5.5, segments=225)
#: the 14,661-dof graded cylinder: the one-dense-factor regime
MESH_15K = dict(yinf=10.0, n1=4.5, n2=2.2, n3=0.8, segments=100)

#: 10-step field error vs host f64 at 56k: multifrontal factors computed in
#: f64 and stored in f32 are rounding-limited at ~1e-4 without refinement
#: (with the mixed-precision sweep their error probe asks for, the f32
#: state's rounding remains); TF32 truncation of any f32 dot on the path
#: would show at 1e-3 or more.
TOL_FIELD_56K = 2e-4
#: 10-step field error vs host f64 at 14.7k: one dense factor computed in
#: f64 and stored in f32, a better-conditioned system than the 56k one.
TOL_FIELD_15K = 1e-4
#: sharded vs single device: the same f32 arithmetic with the element sums
#: and solve updates reduced across devices in another order.
TOL_SHARDED = 1e-5
#: batched row / closed-loop zero-gain row vs the single-stream rollout:
#: the same f32 math lowered with a batch axis (other reduction orders).
TOL_BATCH_ROW = 1e-4
#: one layer vs its host f64 reference: f32 storage and f32 sums.
TOL_LAYER = {"mass": 1e-5, "nl": 1e-5}
#: one production solve (with the refinement the probe asked for) vs splu:
#: the per-solve probe that decides refinement holds solves to 1e-4 on
#: random right-hand sides; another random RHS gets 5x that.
TOL_SOLVE = 5e-4

GPU_REGIME = dict(backend="dense_lu", kinds=("borrowed", "multifrontal"),
                  dtype="float32", hot=True, banded=True, windowed="onehot")
DENSE_REGIME = dict(backend="dense_lu", kinds=("block", "block"),
                    dtype="float32", hot=False, banded=False, windowed=False)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_lines() -> list[str]:
    """``nvidia-smi`` name and power limit per card (a child process that
    stays off JAX, so it does not touch the card's memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def check(name: str, value: float, tol: float) -> None:
    ok = np.isfinite(value) and value <= tol
    log(f"  {name}: {value:.3e} (limit {tol:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} = {value:.3e} exceeds {tol:.0e}")


def build_cylinder(mesh_kwargs=None, mesh=None, base_flow=None, **solver_kw):
    """The cylinder at Re=100 through ``make_default``, with its committed
    base flow (or ``base_flow=(U0, P0)``), ready to step."""
    from flowcontrol_tpu.core.reference import load_base_flow
    from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

    fs = CylinderFlowSolver.make_default(
        Re=100, num_steps=100, save_every=0, verbose=0, mesh=mesh,
        mesh_kwargs=mesh_kwargs, **solver_kw,
    )
    if base_flow is None:
        load_base_flow(fs, "cylinder_re100")
    else:
        fs._assign_steady_state(*base_flow)
    fs.initialize_time_stepping()
    return fs


def check_regime(st, expect: dict) -> dict:
    """Assert the regime the stepper was built in."""
    got = dict(
        backend=st.backend,
        kinds=tuple(st._solver_kinds),
        dtype=np.dtype(st.dtype).name,
        hot=st._hot_src is not None,
        banded=bool(st.banded_operators),
        windowed=(st._nl_win_static["variant"]
                  if st._nl_win_static is not None else False),
    )
    log(f"  regime: {got}")
    if got != expect:
        raise AssertionError(f"stepper regime {got} != expected {expect}")
    return got


def batch_carry(st, carry, scales):
    """B copies of an unbatched carry, row k scaled by ``scales[k]`` (exact
    for the cached terms: M(su) = sM(u), N(su) = s^2 N(u))."""
    import jax.numpy as jnp

    s = jnp.asarray(scales, dtype=st.dtype)[:, None]
    b = len(scales)

    def rows(v, p=1):
        return (s ** p) * jnp.broadcast_to(v, (b,) + v.shape)

    return carry._replace(
        u_n=rows(carry.u_n), u_nn=rows(carry.u_nn), mu_n=rows(carry.mu_n),
        mu_nn=rows(carry.mu_nn), n_prev=rows(carry.n_prev, 2),
        u_ctrl_prev=jnp.zeros((b, st.n_act), dtype=st.dtype),
    )


def timed(fn, *args):
    """(result, seconds) with the result fetched to the host."""
    import jax

    t0 = time.time()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.time() - t0


def phase_precision() -> dict:
    """What an f32 dot lowers to here: relative error of a 512-deep f32
    contraction at each precision, and a one-hot pick's exactness."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    b = rng.standard_normal((512, 256)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    vals = rng.standard_normal((1536, 2)).astype(np.float32)
    idx = rng.integers(0, 1536, 768)
    onehot = (idx[:, None] == np.arange(1536)[None, :]).astype(np.float32)
    out = {}
    for p in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(lax.Precision, p)
        mm = jax.jit(lambda x, y, pr=prec: jnp.matmul(x, y, precision=pr))
        out[p] = rel(mm(a, b), ref)
        pick = np.asarray(mm(onehot, vals))
        out[p + "_pick_exact"] = bool(np.array_equal(pick, vals[idx]))
        log(f"  f32 dot at {p}: rel err {out[p]:.2e}, one-hot pick exact: "
            f"{out[p + '_pick_exact']}")
    if not out["HIGHEST_pick_exact"]:
        raise AssertionError("a one-hot pick at HIGHEST is not exact")
    return out


def phase_main(fs, expect: dict, steps: int = 50, batch: int = 8,
               batch_steps: int = 20, err_steps: int = 10,
               tol_field: float = TOL_FIELD_56K) -> dict:
    """The main path through the user's entry points (see module doc)."""
    import jax

    from flowcontrol_tpu.core.reference import CpuLoop, field_err_vs_f64

    res = {"n_dofs": fs.space.n_dofs}
    log(f"  n_dofs={fs.space.n_dofs} cells={fs.mesh.num_cells}")
    n_act = fs.params_control.actuator_number
    t0 = time.time()
    y = fs.step(np.zeros(n_act))
    res["first_step_s"] = time.time() - t0  # build + compile + one step
    st = fs.stepper
    res["regime"] = check_regime(st, expect)
    t0 = time.time()
    for _ in range(2):
        y = fs.step(np.zeros(n_act))
    res["steps_2_3_s"] = time.time() - t0
    if not np.all(np.isfinite(y)) or y.shape != (st.ns,):
        raise AssertionError(f"fs.step() returned {y!r}")
    log(f"  fs.step x3: first {res['first_step_s']:.1f}s (build+compile), "
        f"next two {res['steps_2_3_s']:.3f}s, y={y}")

    carry = fs._carry
    roll = st.make_rollout_open_loop()
    u_seq = np.zeros((steps, st.n_act), dtype=st.dtype)
    (_, outs), res["single_compile_s"] = timed(roll, carry, u_seq)
    (_, outs), res["single_steady_s"] = timed(roll, carry, u_seq)
    y_single = np.asarray(outs.y)
    if not (np.isfinite(y_single).all() and np.isfinite(outs.dE).all()):
        raise AssertionError("single-stream rollout is not finite")
    log(f"  single-stream {steps} steps: compile+run "
        f"{res['single_compile_s']:.1f}s, steady {res['single_steady_s']:.4f}s")

    scales = np.linspace(1.0, 1.5, batch)
    carry_b = batch_carry(st, carry, scales)
    u_b = np.zeros((batch_steps, batch, st.n_act), dtype=st.dtype)
    (_, outs_b), res["batched_compile_s"] = timed(roll, carry_b, u_b)
    (_, outs_b), res["batched_steady_s"] = timed(roll, carry_b, u_b)
    y_b = np.asarray(outs_b.y)
    if y_b.shape != (batch_steps, batch, st.ns) or not np.isfinite(y_b).all():
        raise AssertionError(f"batched rollout: shape {y_b.shape} or non-finite")
    log(f"  batched B={batch} {batch_steps} steps: compile+run "
        f"{res['batched_compile_s']:.1f}s, steady {res['batched_steady_s']:.4f}s")
    check("batched row 0 vs single-stream y", rel(y_b[:, 0], y_single[:batch_steps]),
          TOL_BATCH_ROW)

    # closed loop: a stable 2-state controller with a gain sweep whose row 0
    # has zero gain (so it must reproduce the open-loop trajectory)
    ad = np.array([[0.9, 0.05], [0.0, 0.8]], dtype=st.dtype)
    bd = np.full((2, st.ns), 0.1, dtype=st.dtype)
    cd = np.full((st.n_act, 2), 0.05, dtype=st.dtype)
    dd = np.zeros((st.n_act, st.ns), dtype=st.dtype)
    gains = np.linspace(0.0, 1.5, batch).astype(st.dtype)
    k_mats = (np.broadcast_to(ad, (batch,) + ad.shape),
              np.broadcast_to(bd, (batch,) + bd.shape),
              gains[:, None, None] * cd,
              np.broadcast_to(dd, (batch,) + dd.shape))
    carry_c = batch_carry(st, carry, np.ones(batch))
    y0 = np.zeros((batch, st.ns), dtype=st.dtype)
    roll_cl = st.make_rollout_closed_loop(batch_steps)
    (_, outs_c), res["closed_compile_s"] = timed(roll_cl, carry_c, k_mats, y0)
    (_, outs_c), res["closed_steady_s"] = timed(roll_cl, carry_c, k_mats, y0)
    y_c = np.asarray(outs_c[0])
    if y_c.shape != (batch_steps, batch, st.ns) or not np.isfinite(y_c).all():
        raise AssertionError(f"closed loop: shape {y_c.shape} or non-finite")
    if not np.isfinite(np.asarray(outs_c[1])).all():
        raise AssertionError("closed-loop energies are not finite")
    log(f"  closed-loop B={batch} {batch_steps} steps: compile+run "
        f"{res['closed_compile_s']:.1f}s, steady {res['closed_steady_s']:.4f}s")
    check("closed-loop zero-gain row vs single-stream y",
          rel(y_c[:, 0], y_single[:batch_steps]), TOL_BATCH_ROW)

    t0 = time.time()
    cpu = CpuLoop(fs)
    res["host_factor_s"] = time.time() - t0
    res["field_err"] = field_err_vs_f64(cpu, st, carry, roll, steps=err_steps)
    check(f"{err_steps}-step field error vs host f64", res["field_err"],
          tol_field)
    res["peak_bytes"] = peak_bytes(jax.devices()[0])
    log(f"  peak_bytes_in_use={res['peak_bytes']}")
    res["cpu"] = cpu
    return res


def phase_layers(fs, cpu, seed: int = 0) -> dict:
    """Mass apply, N(u) and the production solve of the built stepper,
    each against its plain host f64 reference, on a random state."""
    import jax

    from flowcontrol_tpu.fem.assembly import nonlinear_convection_np

    st = fs.stepper
    dev = st._dev
    rng = np.random.default_rng(seed)
    x = np.asarray(fs.fields.UP0) + 0.1 * rng.standard_normal(fs.space.n_dofs)
    xh = np.asarray(st.to_hot(x), dtype=st.dtype)
    apply_m = jax.jit(lambda d, v: st._apply(d, "m", v))
    nl = jax.jit(lambda d, v: st._nl(d, v))
    solve = jax.jit(lambda d, r: st._solve(d, 2, r)[0])
    out = {}
    out["mass"] = rel(st.from_hot(apply_m(dev, xh)), cpu.mass @ x)
    check("mass apply vs scipy CSR", out["mass"], TOL_LAYER["mass"])
    out["nl"] = rel(st.from_hot(nl(dev, xh)),
                    nonlinear_convection_np(fs.geom, fs.space, x))
    check("N(u) vs host quadrature", out["nl"], TOL_LAYER["nl"])
    b = rng.standard_normal(fs.space.n_dofs)
    b[cpu.bcs.dofs] = 0.0
    xs = st.from_hot(solve(dev, np.asarray(st.to_hot(b), dtype=st.dtype)))
    out["solve"] = rel(xs, cpu.lu.solve(b))
    check("BDF2 solve vs splu", out["solve"], TOL_SOLVE)
    return out


def phase_nl_variants(fs, steps: int = 50) -> dict:
    """Time the BDF2 step with each N(u) variant: steppers built like the
    main one but starting in BDF2 (one factor, no BDF1 step)."""
    import jax.numpy as jnp

    st = fs.stepper
    up_n = st.from_hot(np.asarray(fs._carry.u_n))
    up_nn = st.from_hot(np.asarray(fs._carry.u_nn))
    out = {}
    for variant in ("onehot", "take", False):
        v = dataclasses.replace(st, windowed_nl=variant, start_order=2,
                                hot_order=None)
        carry = v.init_carry(up_n, up_nn)
        roll = v.make_rollout_open_loop()
        u_seq = jnp.zeros((steps, v.n_act), dtype=v.dtype)
        (_, o), t_c = timed(roll, carry, u_seq)
        (_, o), t_s = timed(roll, carry, u_seq)
        if not np.isfinite(np.asarray(o.y)).all():
            raise AssertionError(f"windowed_nl={variant!r} rollout diverged")
        out[str(variant)] = t_s / steps
        log(f"  windowed_nl={variant!r}: hot={v._hot_src is not None}, "
            f"compile+run {t_c:.1f}s, steady {1e3 * t_s / steps:.4f} ms/step")
    return out


def run_one_gpu() -> dict:
    results = {}
    log("phase precision")
    results["precision"] = phase_precision()
    log("phase main (56k cylinder, auto backend and precision)")
    fs = build_cylinder(mesh_kwargs=MESH_56K)
    res = phase_main(fs, GPU_REGIME)
    cpu = res.pop("cpu")
    results["main"] = res
    log("phase layers (56k)")
    results["layers"] = phase_layers(fs, cpu)
    log("phase nl (N(u) variants at 56k)")
    results["nl"] = phase_nl_variants(fs)
    del fs, cpu
    log("phase dense (14.7k cylinder, one dense factor)")
    fs = build_cylinder(mesh_kwargs=MESH_15K)
    res = phase_main(fs, DENSE_REGIME, tol_field=TOL_FIELD_15K)
    res.pop("cpu")
    results["dense"] = res
    log("phase gpu tests (pytest -m gpu, in this process)")
    results["gpu_tests"] = run_gpu_tests()
    return results


def run_gpu_tests() -> int:
    """Run the ``gpu``-marked tests in this process (a second process could
    not get the card's memory); every one must run and pass."""
    import pytest

    class Tally:
        passed, failed, skipped = 0, 0, 0

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped += 1
            elif report.failed:
                self.failed += 1
            elif report.when == "call":
                self.passed += 1

    tally = Tally()
    os.environ["FLOWCONTROL_TESTS_ON_GPU"] = "1"  # tests/conftest.py
    tests = Path(__file__).resolve().parent / "tests" / "test_gpu.py"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      str(tests)], plugins=[tally])
    log(f"  gpu tests: {tally.passed} passed, {tally.failed} failed, "
        f"{tally.skipped} skipped (rc {rc})")
    if rc != 0 or tally.failed or tally.skipped or not tally.passed:
        raise AssertionError("gpu-marked tests did not all run and pass")
    return tally.passed


CL_STEPS = 5


def phase_sharded(fs, devices, expect: dict | None = None, batch: int = 4,
                  tol: float = TOL_SHARDED):
    """The sharded path on ``devices`` (4): ``shard_stepper`` on an
    all-'space' mesh and on {batch: 2, space: 2}; one step and a fused
    closed-loop rollout each, from the same batched carry as the
    single-device stepper (3 steps past the initial condition, rows
    scaled copies of the state), against that stepper.

    Both steppers run one mixed-precision refinement sweep per solve:
    without it each solve keeps its own f32 sweep rounding, of the size of
    the factors' per-solve probe (up to 1e-4), and that would hide any
    sharding fault below it; with it both converge to the solution of the
    same f32 system within f32 state rounding."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from flowcontrol_tpu.parallel.sharding import shard_stepper

    n_dev = len(devices)
    n_act = fs.params_control.actuator_number
    fs.params_solver.stepper_options = dict(
        fs.params_solver.stepper_options, refine_steps=1
    )
    fs._stepper = None
    fs._prepare_systems()
    fs.first_step = False
    st = fs.stepper
    if expect is not None:
        check_regime(st, expect)
    for _ in range(3):
        fs.step(np.zeros(n_act))
    carry = batch_carry(st, fs._carry, np.linspace(1.0, 1.5, batch))
    ad = np.array([[0.9, 0.05], [0.0, 0.8]], dtype=st.dtype)
    k_mats = (np.broadcast_to(ad, (batch, 2, 2)),
              np.full((batch, 2, st.ns), 0.1, dtype=st.dtype),
              np.linspace(0.5, 1.5, batch, dtype=st.dtype)[:, None, None]
              * np.full((st.n_act, 2), 0.05, dtype=st.dtype),
              np.zeros((batch, st.n_act, st.ns), dtype=st.dtype))
    y0 = np.zeros((batch, st.ns), dtype=st.dtype)
    u0 = jnp.zeros((batch, st.n_act), dtype=st.dtype)

    c1, _ = jax.jit(st.step_fn())(st._dev, carry, u0)
    x_ref = np.asarray(c1.u_n)
    _, outs = jax.jit(st.closed_loop_fn(CL_STEPS))(st._dev, carry, k_mats, y0)
    y_cl_ref = np.asarray(outs[0])
    carry_h = jax.tree_util.tree_map(np.asarray, carry)

    cpu_opts = None
    if devices[0].platform == "cpu":  # virtual devices share a few cores
        cpu_opts = {"xla_cpu_collective_call_warn_stuck_seconds": 240,
                    "xla_cpu_collective_call_terminate_timeout_seconds": 1200}
    results = {}
    meshes = {
        "space4": Mesh(np.array(devices), ("space",)),
        "batch2_space2": Mesh(np.array(devices).reshape(2, n_dev // 2),
                              ("batch", "space")),
    }
    for name, mesh in meshes.items():
        log(f"  mesh {name}: {dict(mesh.shape)}")
        fs._stepper = None
        fs._prepare_systems()
        s2 = fs._stepper
        batched = "batch" in mesh.axis_names
        shard_stepper(s2, mesh, axis="space",
                      batch_axis="batch" if batched else None)
        smf = next(iter(s2._sharded_solvers.values()))
        n_space = mesh.shape["space"]
        if smf.per_device_factor_bytes * n_space != smf.total_factor_bytes:
            raise AssertionError("factor bytes do not split evenly")
        log(f"  factors: total {smf.total_factor_bytes} B, per device "
            f"{smf.per_device_factor_bytes} B ({n_space}-way)")
        s2._dev = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, NamedSharding(mesh, P())), s2._dev
        )
        # the same carry: the hot order is a function of the mesh alone
        assert np.array_equal(s2._hot_src, st._hot_src)
        bs = NamedSharding(mesh, P("batch") if batched else P())
        carry_s = jax.tree_util.tree_map(
            lambda a: jax.device_put(a, bs if a.ndim else
                                     NamedSharding(mesh, P())), carry_h)
        u0_s = jax.device_put(u0, bs)
        with mesh:
            step = jax.jit(s2.step_fn()).lower(
                s2._dev, carry_s, u0_s).compile(compiler_options=cpu_opts)
            c2, _ = step(s2._dev, carry_s, u0_s)
            roll = jax.jit(s2.closed_loop_fn(CL_STEPS)).lower(
                s2._dev, carry_s, k_mats, y0).compile(compiler_options=cpu_opts)
            _, outs2 = roll(s2._dev, carry_s, k_mats, y0)
            jax.block_until_ready(outs2)
        r = {"step": rel(c2.u_n, x_ref),
             "closed_loop_y": rel(outs2[0], y_cl_ref),
             "factor_bytes_total": smf.total_factor_bytes,
             "factor_bytes_per_device": smf.per_device_factor_bytes,
             "peak_bytes": [peak_bytes(d) for d in devices]}
        check(f"{name} step vs single device", r["step"], tol)
        check(f"{name} {CL_STEPS}-step closed loop y vs single device",
              r["closed_loop_y"], tol)
        log(f"  per-device peak_bytes_in_use={r['peak_bytes']}")
        results[name] = r
    return results


def run_four_gpus() -> dict:
    import jax

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four-gpus needs 4 devices, found {len(devices)}")
    fs = build_cylinder(mesh_kwargs=MESH_56K)
    log(f"phase sharded (56k cylinder on {len(devices[:4])} GPUs)")
    return phase_sharded(fs, devices[:4], GPU_REGIME)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import logging

    import jax

    from flowcontrol_tpu.config import compile_cache_dir

    # build-phase timings and the multifrontal's solve-error probe
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    logging.getLogger("flowcontrol_tpu").setLevel(logging.INFO)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    for line in gpu_lines():
        log(f"nvidia-smi: {line}")
    log(f"device_kind: {devices[0].device_kind} x{len(devices)}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {compile_cache_dir()}")
    t0 = time.time()
    if args.four_gpus:
        run_four_gpus()
        count = 4
    else:
        run_one_gpu()
        count = 1
    log(f"total {time.time() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Optimization-campaign utilities for controller tuning.

Behavioral port of ref: src/utils/optim.py. The reference's MPI master-worker
protocol (rank-0 optimizer + all-rank collective cost evaluation + stop-flag
broadcast, ref: optim.py:71-107) is replaced by a single-program pattern:
``batch_evaluate`` runs a whole candidate population through ONE vmapped
closed-loop rollout — the single-program answer to master-worker MPI.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable

import numpy as np


def fun_array(x: np.ndarray, fun: Callable[..., float], **kwargs) -> np.ndarray:
    """Evaluate a scalar cost on a batch of points: (n, dim) -> (n, 1)
    (ref: optim.py:48-68)."""
    x = np.atleast_2d(np.asarray(x))
    out = np.zeros((x.shape[0], 1))
    for i in range(x.shape[0]):
        out[i, 0] = fun(x[i, :], **kwargs)
    return out


def batch_evaluate(thetas: np.ndarray, rollout_cost_fn: Callable) -> np.ndarray:
    """Evaluate a candidate population with one batched (vmapped) rollout.

    ``rollout_cost_fn(thetas (B, dim)) -> costs (B,)`` is typically built
    from Stepper.make_rollout_closed_loop + vmap over stacked controller
    parameters. This replaces the reference's MPI master-worker evaluation
    loop with a single XLA program (SURVEY §2.5-3).
    """
    thetas = np.atleast_2d(np.asarray(thetas))
    return np.asarray(rollout_cost_fn(thetas)).reshape(-1)


def cummin(J: np.ndarray, x: np.ndarray | None = None):
    """Cumulative minimum of a cost history; optionally the matching points
    (ref: optim.py:110-137)."""
    J = np.asarray(J).reshape(-1)
    idx = np.minimum.accumulate(np.arange(len(J)))
    best = np.empty(len(J), dtype=int)
    cur = 0
    for i in range(len(J)):
        if J[i] < J[cur]:
            cur = i
        best[i] = cur
    Jc = J[best]
    if x is None:
        return Jc
    return Jc, np.asarray(x)[best]


def sobol_sample(n: int, ndim: int, bounds=None, seed: int = 0) -> np.ndarray:
    """Sobol low-discrepancy samples in the given box (ref: optim.py:177-225)."""
    from scipy.stats import qmc

    sampler = qmc.Sobol(d=ndim, scramble=True, seed=seed)
    x = sampler.random(n)
    if bounds is not None:
        lo = np.asarray([b[0] for b in bounds])
        hi = np.asarray([b[1] for b in bounds])
        x = lo + x * (hi - lo)
    return x


def write_results(path, x: np.ndarray, J: np.ndarray, columns=None) -> None:
    """Campaign CSV writer (ref: optim.py:140-174)."""
    x = np.atleast_2d(np.asarray(x))
    J = np.asarray(J).reshape(-1)
    cols = columns or [f"x{i + 1}" for i in range(x.shape[1])]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(list(cols) + ["J"])
        w.writerows([*map(repr, map(float, xi)), repr(float(j))]
                    for xi, j in zip(x, J))


def write_optim_csv(path, x, J, diverged=False, append=True) -> None:
    """Append one evaluation record, marking diverged candidates
    (ref: optim.py:291-311 — throw_error=False runs return None and are
    scored as diverged)."""
    x = np.atleast_1d(np.asarray(x, dtype=float))
    row = {f"x{i + 1}": v for i, v in enumerate(x)}
    row["J"] = np.nan if diverged else float(J)
    row["diverged"] = bool(diverged)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = not (append and path.exists())
    with open(path, "a" if append else "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        if header:
            w.writeheader()
        # NaN as an empty field, as pandas writes it
        w.writerow({k: "" if isinstance(v, float) and np.isnan(v) else v
                    for k, v in row.items()})


# ── FlowSolver cost evaluation (ref: optim.py:231-288) ───────────────────────


def compute_signal_cost(signal, Tnorm: float, criterion: str,
                        scaling: Callable | None = None) -> float:
    """Integral (time-averaged) or terminal cost of a 1D timeseries."""
    if criterion not in ("integral", "terminal"):
        raise ValueError(
            f"Unknown criterion {criterion!r}: expected 'integral' or 'terminal'."
        )
    scaling = scaling or (lambda v: v)
    sig = np.asarray(signal).reshape(-1)
    if criterion == "integral":
        return float(np.sum(scaling(sig)) * Tnorm)
    return float(scaling(sig[-1]))


def compute_control_cost(u_ctrl, Tnorm: float) -> float:
    """Time-normalized control effort ∫‖u‖² dt (all channels summed)."""
    return float(np.sum(np.asarray(u_ctrl) ** 2) * Tnorm)


def parallel_function_wrapper(x, stop_all, fun):
    """Reference-compatible cost-evaluation wrapper (ref: optim.py:71-107).

    In the reference, rank 0 drives the optimizer while all MPI ranks
    co-evaluate each collective FEM cost, with ``stop_all`` broadcast as the
    termination flag. This framework is single-program (the solve itself is
    device-parallel), so the wrapper reduces to: evaluate unless stopped.
    The signature and the stop-flag contract are preserved so reference
    optimization drivers port line-for-line; for population-scale search use
    ``batch_evaluate`` (vmapped rollouts) instead.
    """
    if stop_all[0] != 0:
        return 0.0
    return float(fun(x))

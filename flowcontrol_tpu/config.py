"""Global numerical configuration and the platform policy.

Precision policy
----------------
Host-side setup (mesh, DOF maps, global sparse assembly, steady-state Newton)
always runs in float64 numpy/scipy: it is one-time work and accuracy matters.

Device-side hot loops (time stepping, batched rollouts) run in the dtype
that :func:`device_policy` gives the device: float32 on the GPU, float64 on
the CPU (where JAX x64 is cheap and lets the test-suite validate bit-level
physics). Override per solver with ``ParamSolver.precision``.

Platform policy
---------------
:func:`device_policy` is the one place that says what a device gets: the
device dtype, the solver backend and size regime, whether the banded mass
apply and the windowed N(u) are on, and the device memory budget. Nothing
else in the package branches on the platform name.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import jax
import numpy as np

# Enable x64 so host-offloaded solves and CPU test runs are double precision.
# Device hot loops cast to float32 explicitly where the policy says so.
jax.config.update("jax_enable_x64", True)

# float32 dots on the H100 at DEFAULT or HIGH precision may run on the
# tensor cores in TF32, which keeps 10 mantissa bits: a one-hot "pick"
# through such a dot rounds every value to ~3 digits, and every mass or
# factor apply loses the same. The solver's accuracy class is f32, so all
# dots default to full f32 (HIGHEST); CPU ignores the setting.
jax.config.update("jax_default_matmul_precision", "highest")

#: root of the checkout (the directory that holds the package)
CHECKOUT = Path(__file__).resolve().parents[1]


def compile_cache_dir() -> Path:
    """Where the persistent XLA compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads the variable
    itself, and nothing else is configured in code); otherwise the fixed
    ``<checkout>/.cache/jax``. A fixed path matters: the directory is part
    of the cache key, so a moving directory never hits.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    return CHECKOUT / ".cache" / "jax"


def _init_compile_cache() -> None:
    # stepper/rollout programs at production sizes take tens of seconds to
    # compile; a warm restart should pay that once per checkout
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    d = compile_cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(d))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_init_compile_cache()

#: numpy dtype used for all host-side (setup-time) arithmetic.
HOST_DTYPE = np.float64

#: integer dtype for DOF maps / connectivity on device.
INDEX_DTYPE = np.int32

#: size regime of the direct (``dense_lu``) backend: one dense factor up to
#: this many dofs (two scheme factors plus dense mass/refinement operands
#: stay a few GB), the nested-dissection multifrontal above it. The same
#: bound sends ``solver_backend='auto'`` to the host sparse LU on the CPU.
DENSE_MAX_DOFS = 20_000


@dataclass(frozen=True)
class DevicePolicy:
    """What one device gets for a problem of ``n_dofs`` dofs."""

    platform: str
    #: device dtype for ``precision='auto'``
    dtype: type
    #: backend for ``solver_backend='auto'``: 'dense_lu' | 'host_lu'
    backend: str
    #: direct-solver regime of the dense_lu backend: 'dense' (one factor)
    #: | 'multifrontal'
    solver: str
    #: window-banded mass apply (ops/banded.py)
    banded: bool
    #: windowed N(u) variant (ops/cellwindows.py) or False for the
    #: gather-table N(u)
    windowed_nl: str | bool
    #: usable device memory for resident solver state, bytes
    hbm_budget_bytes: int


def _host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def device_hbm_budget_bytes(device=None) -> int:
    """Usable memory for resident solver state on ``device`` (default: the
    first JAX device): 90% of the allocator's limit on the GPU, half the
    host memory on the CPU. A GPU that reports no memory stats raises —
    a guessed budget would size factors for a card that is not there."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return int(0.5 * _host_memory_bytes())
    if device.platform == "gpu":
        stats = device.memory_stats() or {}
        limit = stats.get("bytes_limit", 0)
        if not limit:
            raise RuntimeError(
                f"device {device} reports no memory stats: cannot size the "
                "solver's resident state"
            )
        return int(0.9 * limit)
    raise ValueError(f"no platform policy for {device.platform!r}")


def device_policy(n_dofs: int, device=None) -> DevicePolicy:
    """The platform policy: what ``device`` (default: the first JAX
    device) gets for an ``n_dofs``-dof problem. Unknown platforms raise."""
    device = device or jax.devices()[0]
    platform = device.platform
    small = n_dofs <= DENSE_MAX_DOFS
    solver = "dense" if small else "multifrontal"
    if platform == "cpu":
        return DevicePolicy(
            platform=platform, dtype=np.float64,
            backend="dense_lu" if small else "host_lu", solver=solver,
            banded=False, windowed_nl=False,
            hbm_budget_bytes=device_hbm_budget_bytes(device),
        )
    if platform == "gpu":
        # past the dense range the mass apply and N(u) run through the
        # window-banded tiles and the windowed one-hot N(u): the operands
        # that the hot dof order (core/stepper.py) needs
        return DevicePolicy(
            platform=platform, dtype=np.float32, backend="dense_lu",
            solver=solver, banded=not small,
            windowed_nl=False if small else "onehot",
            hbm_budget_bytes=device_hbm_budget_bytes(device),
        )
    raise ValueError(f"no platform policy for {platform!r}")

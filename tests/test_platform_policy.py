"""The platform policy (config.device_policy), the compile-cache placement
and the import path's optional dependencies."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from flowcontrol_tpu import config

REPO = Path(__file__).resolve().parents[1]


class FakeDevice:
    """A device descriptor: what the policy reads of a JAX device."""

    def __init__(self, platform, stats=None):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


GPU_STATS = {"bytes_limit": 60 * 2**30, "peak_bytes_in_use": 0}


@pytest.mark.parametrize("platform,n_dofs,want", [
    ("cpu", 5_000, dict(dtype=np.float64, backend="dense_lu",
                        solver="dense", banded=False, windowed_nl=False)),
    ("cpu", 56_000, dict(dtype=np.float64, backend="host_lu",
                         solver="multifrontal", banded=False,
                         windowed_nl=False)),
    ("gpu", 14_661, dict(dtype=np.float32, backend="dense_lu",
                         solver="dense", banded=False, windowed_nl=False)),
    ("gpu", 55_955, dict(dtype=np.float32, backend="dense_lu",
                         solver="multifrontal", banded=True,
                         windowed_nl="onehot")),
    ("gpu", 235_374, dict(dtype=np.float32, backend="dense_lu",
                          solver="multifrontal", banded=True,
                          windowed_nl="onehot")),
])
def test_device_policy(platform, n_dofs, want):
    dev = FakeDevice(platform, GPU_STATS if platform == "gpu" else None)
    pol = config.device_policy(n_dofs, dev)
    assert pol.platform == platform
    for k, v in want.items():
        assert getattr(pol, k) == v, (k, getattr(pol, k), v)
    assert pol.hbm_budget_bytes > 0
    if platform == "gpu":
        # 90% of the allocator's limit, never a guessed constant
        assert pol.hbm_budget_bytes == int(0.9 * GPU_STATS["bytes_limit"])


def test_gpu_without_memory_stats_raises():
    with pytest.raises(RuntimeError, match="memory stats"):
        config.device_policy(55_955, FakeDevice("gpu", None))


def test_unknown_platform_raises():
    with pytest.raises(ValueError, match="no platform policy"):
        config.device_policy(1_000, FakeDevice("metal", {}))


def test_policy_bound_is_the_dense_regime_edge():
    dev = FakeDevice("gpu", GPU_STATS)
    assert config.device_policy(config.DENSE_MAX_DOFS, dev).solver == "dense"
    assert (config.device_policy(config.DENSE_MAX_DOFS + 1, dev).solver
            == "multifrontal")


def test_flowsolver_auto_resolves_through_policy(monkeypatch):
    """FlowSolver's 'auto' backend and precision are the policy's."""
    from flowcontrol_tpu.mesh.generation import cylinder_mesh
    from flowcontrol_tpu.models.cylinder import CylinderFlowSolver

    mesh = cylinder_mesh(yinf=4.0, xinf=8.0, xinfa=-3.0, n1=1.6, n2=1.0,
                         n3=0.5, segments=32)
    fs = CylinderFlowSolver.make_default(Re=100, mesh=mesh, verbose=0)
    assert fs._resolve_backend() == "dense_lu"  # small: one dense factor
    assert fs._resolve_dtype() == np.float64  # CPU
    monkeypatch.setattr(config, "DENSE_MAX_DOFS", 10)
    assert fs._resolve_backend() == "host_lu"  # CPU past the dense range
    gpu = config.device_policy(fs.space.n_dofs, FakeDevice("gpu", GPU_STATS))
    assert (gpu.backend, gpu.solver) == ("dense_lu", "multifrontal")


def _run(code, env_extra=None, unset=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    for k in unset:
        env.pop(k, None)
    env.update(env_extra or {})
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR when set (and nothing set in code), else
    the fixed <checkout>/.cache/jax."""
    code = ("import jax, flowcontrol_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    if env_set:
        got = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert got == str(tmp_path)
    else:
        got = _run(code, unset=("JAX_COMPILATION_CACHE_DIR",))
        assert got == str(REPO / ".cache" / "jax")


def test_compile_cache_dir_function(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compile_cache_dir() == tmp_path
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert config.compile_cache_dir() == config.CHECKOUT / ".cache" / "jax"


def test_import_without_pandas_and_h5py():
    """The package imports, and a generated cylinder steps, with pandas and
    h5py absent; h5py-backed I/O says what it needs."""
    code = (
        "import sys; sys.modules['pandas'] = None; sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "import flowcontrol_tpu, flowcontrol_tpu.utils\n"
        "from flowcontrol_tpu.models.cylinder import CylinderFlowSolver\n"
        "fs = CylinderFlowSolver.make_default(Re=100, mesh_kwargs=dict(\n"
        "    yinf=4.0, xinf=8.0, xinfa=-3.0, n1=1.6, n2=1.0, n3=0.5,\n"
        "    segments=32))\n"
        "fs.compute_steady_state(u_ctrl=[0.0, 0.0], method='picard',\n"
        "                        max_iter=2)\n"
        "fs.initialize_time_stepping()\n"
        "assert np.isfinite(fs.step(np.zeros(2))).all()\n"
        "from flowcontrol_tpu.mesh.io import require_h5py\n"
        "try:\n"
        "    require_h5py()\n"
        "except ImportError as e:\n"
        "    print('h5py' in str(e))\n"
    )
    assert _run(code) == "True"

"""Test fixtures: tiny meshes + Taylor-Hood spaces, CPU-pinned JAX.

Mirrors the reference's conftest strategy (ref: tests/conftest.py — tiny
UnitSquareMesh fixtures, determinism pinning). JAX is forced onto an
8-virtual-device CPU platform so sharding tests run without a multi-GPU
host, and x64 is enabled so regression values are solver-exact. The
``gpu``-marked tests run on the card from ``chip_smoke.py``, which sets
FLOWCONTROL_TESTS_ON_GPU=1 so that the CPU pin is skipped.
"""

import os
import sys
from pathlib import Path

# must be set before jax initializes its backends
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

if os.environ.get("FLOWCONTROL_TESTS_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from flowcontrol_tpu.fem.assembly import CellGeometry
from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace
from flowcontrol_tpu.mesh.generation import unit_square_mesh


@pytest.fixture(scope="session")
def small_mesh():
    return unit_square_mesh(4, 4)


@pytest.fixture(scope="session")
def medium_mesh():
    return unit_square_mesh(8, 8)


@pytest.fixture(scope="session")
def small_space(small_mesh):
    return TaylorHoodSpace.build(small_mesh)


@pytest.fixture(scope="session")
def medium_space(medium_mesh):
    return TaylorHoodSpace.build(medium_mesh)


@pytest.fixture(scope="session")
def small_geom(small_space):
    return CellGeometry(small_space)


@pytest.fixture(scope="session")
def medium_geom(medium_space):
    return CellGeometry(medium_space)


@pytest.fixture()
def rng():
    return np.random.default_rng(0)

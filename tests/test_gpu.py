"""Tests that need a GPU. ``python chip_smoke.py`` runs them on the card,
in its own process; everywhere else the ``gpu`` fixture skips them."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture()
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform!r}")
    return dev


def test_policy_on_card(gpu):
    """The card reports memory stats, and the policy gives it f32 and the
    multifrontal past the dense range."""
    from flowcontrol_tpu.config import device_policy

    pol = device_policy(55_955, gpu)
    assert pol.dtype == np.float32 and pol.solver == "multifrontal"
    assert pol.banded and pol.windowed_nl == "onehot"
    assert pol.hbm_budget_bytes > 10 * 2**30


def test_windowed_pick_exact_on_card(gpu):
    """The windowed N(u)'s one-hot contraction, at its pinned precision,
    selects f32 values exactly on the card."""
    from test_cellwindows import onehot_pick_case

    got, want = onehot_pick_case()
    np.testing.assert_array_equal(got, want)


def test_banded_mass_apply_on_card(gpu):
    """Window-banded f32 mass apply vs the scipy CSR product."""
    import jax

    from flowcontrol_tpu.fem.assembly import CellGeometry, to_scipy_csr
    from flowcontrol_tpu.core.nsforms import NSForms
    from flowcontrol_tpu.mesh.dofmap import TaylorHoodSpace
    from flowcontrol_tpu.mesh.generation import cylinder_mesh
    from flowcontrol_tpu.ops.banded import banded_matvec, build_banded

    space = TaylorHoodSpace.build(cylinder_mesh(
        yinf=4.0, xinf=8.0, xinfa=-3.0, n1=1.6, n2=1.0, n3=0.5, segments=32))
    forms = NSForms(space=space, geom=CellGeometry(space), Re=100.0,
                    dt=0.005, is_nonlinear=True, shift=0.0)
    m = to_scipy_csr(forms.mass_elements(), space.cell_dofs, space.n_dofs)
    tree = build_banded(m.tocsr(), dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(space.n_dofs)
    y = np.asarray(jax.jit(banded_matvec)(tree, x.astype(np.float32)))
    ref = m @ x
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-6

"""Frequency response and eigensolvers vs analytic results
(ref: tests/test_linalg.py:1-31 — SISO TF cross-check)."""

import numpy as np
import scipy.sparse as sp

from flowcontrol_tpu.utils.linalg import (
    dense_to_sparse,
    eig_arnoldi_dense_device,
    get_field_response,
    get_frequency_response,
    get_frequency_response_device,
    get_mat_vp_shift_invert,
)


def siso_system():
    """dx = -x + u, y = 2x  →  H(jw) = 2/(jw + 1)."""
    a = sp.csr_matrix(np.array([[-1.0]]))
    q = sp.csr_matrix(np.eye(1))
    b = np.array([[1.0]])
    c = np.array([[2.0]])
    return a, b, c, q


def test_frequency_response_siso_analytic():
    a, b, c, q = siso_system()
    ww = np.array([0.0, 0.5, 1.0, 10.0])
    h = get_frequency_response(a, b, c, q, ww)
    h_ref = 2.0 / (1j * ww + 1.0)
    assert np.allclose(h[:, 0, 0], h_ref, rtol=1e-12)


def test_frequency_response_mimo_shapes():
    n = 6
    rng = np.random.default_rng(0)
    a = sp.csr_matrix(-np.eye(n) + 0.1 * rng.standard_normal((n, n)))
    q = sp.csr_matrix(np.eye(n))
    b = rng.standard_normal((n, 2))
    c = rng.standard_normal((3, n))
    ww = np.array([0.1, 1.0])
    h = get_frequency_response(a, b, c, q, ww)
    assert h.shape == (2, 3, 2)
    # cross-check one entry against a dense solve
    hd = c @ np.linalg.solve(1j * 0.1 * np.eye(n) - a.toarray(), b)
    assert np.allclose(h[0], hd)


def test_frequency_response_device_matches_host():
    n = 8
    rng = np.random.default_rng(1)
    a_d = -2 * np.eye(n) + 0.2 * rng.standard_normal((n, n))
    b = rng.standard_normal((n, 1))
    c = rng.standard_normal((1, n))
    q = np.eye(n)
    ww = np.array([0.2, 1.0, 3.0])
    h_host = get_frequency_response(sp.csr_matrix(a_d), b, c, sp.csr_matrix(q), ww)
    h_dev = get_frequency_response_device(a_d, b, c, q, ww, dtype=np.complex64)
    assert np.allclose(h_dev, h_host, rtol=2e-4, atol=1e-6)


def test_field_response():
    a, b, c, q = siso_system()
    x = get_field_response(a, b, q, [1.0])
    assert np.allclose(x[0, 0, 0], 1.0 / (1j + 1.0))


def test_shift_invert_eig_generalized():
    """A x = λ E x with singular E (mimics the pressure-singular mass)."""
    n = 30
    diag_a = np.concatenate([[1.0], -np.linspace(1, 8, n - 1)])
    a_d = np.diag(diag_a)
    rng = np.random.default_rng(0)
    a_d += 1e-3 * np.triu(rng.standard_normal((n, n)), 1)  # break degeneracy
    e_d = np.eye(n)
    e_d[-1, -1] = 0.0  # singular row (like the pressure block of E)
    a, e = sp.csr_matrix(a_d), sp.csr_matrix(e_d)
    vals, vecs = get_mat_vp_shift_invert(a, e, n=3, sigma=0.5)
    assert np.allclose(np.sort(vals.real), [-1.25, -1.0, 1.0], atol=1e-3)
    # residual check
    for k in range(3):
        r = a_d @ vecs[:, k] - vals[k] * (e_d @ vecs[:, k])
        assert np.abs(r).max() < 1e-8


def test_arnoldi_dense_device_matches_host():
    rng = np.random.default_rng(2)
    n = 30
    a_d = -np.diag(np.linspace(0.5, 5, n)) + 0.1 * rng.standard_normal((n, n))
    a_d[0, 0] = 0.3  # one unstable mode
    e_d = np.eye(n)
    vals_host = get_mat_vp_shift_invert(
        sp.csr_matrix(a_d), sp.csr_matrix(e_d), n=3, sigma=0.3,
        return_vectors=False,
    )
    vals_dev, _ = eig_arnoldi_dense_device(a_d, e_d, n=3, sigma=0.3, n_krylov=25,
                                        dtype=np.complex64)
    assert abs(vals_dev[0] - vals_host[0]) < 1e-2


def test_dense_to_sparse():
    m = dense_to_sparse(np.array([[1.0, 0.0], [0.0, 2.0]]))
    assert m.nnz == 2


def test_modal_rom_block_realification_exact():
    """A single complex pair's real 2x2 block realization reproduces the
    residue sum R/(s-λ) + R̄/(s-λ̄) exactly (the algebra modal_rom uses)."""
    import scipy.linalg as sla

    from flowcontrol_tpu.utils.linalg import modal_rom  # noqa: F401 (API)

    rng = np.random.default_rng(0)
    A0 = np.array([[-0.1, 0.8], [-0.8, -0.1]])
    S = rng.standard_normal((2, 2)) + 2 * np.eye(2)
    A = S @ A0 @ np.linalg.inv(S)
    E = np.eye(2)
    b = rng.standard_normal((2, 1))
    c = rng.standard_normal((1, 2))
    lam_all, V = sla.eig(A)
    lam_l, W = sla.eig(A.T)
    i = int(np.argmax(lam_all.imag))
    lam, v = lam_all[i], V[:, i]
    j = int(np.argmin(np.abs(lam_l - np.conj(lam))))
    w = W[:, j]
    w = w / np.conj(w.conj() @ (E @ v))
    beta = w.conj() @ b
    cv = c @ v
    sg, om = lam.real, lam.imag
    Ak = np.array([[sg, -om], [om, sg]])
    Bk = np.vstack([beta.real, beta.imag])
    Ck = np.column_stack([2 * cv.real, -2 * cv.imag])
    for wq in (0.3, 0.8, 2.0):
        s = 1j * wq
        Hf = c @ np.linalg.solve(s * E - A, b)
        Hr = Ck @ np.linalg.solve(s * np.eye(2) - Ak, Bk)
        assert np.abs(Hf - Hr).max() < 1e-12 * max(1.0, np.abs(Hf).max())


def test_modal_rom_recovers_dominant_modes():
    """modal_rom on a synthetic descriptor system recovers exactly the
    prescribed dominant eigenvalues (biorthogonal pairing + dedup across
    shifts) and realifies them into a stable block-diagonal ROM."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    from flowcontrol_tpu.utils.linalg import modal_rom

    rng = np.random.default_rng(3)
    blocks = [np.array([[-0.1, 0.8], [-0.8, -0.1]]),
              np.array([[-0.3, 1.5], [-1.5, -0.3]]),
              np.array([[-0.05, 0.4], [-0.4, -0.05]]),
              np.array([[-0.2]])]
    for k in range(15):
        blocks.append(np.array([[-5.0 - k]]))
    a0 = sla.block_diag(*blocks)
    n = a0.shape[0]
    V = rng.standard_normal((n, n)) + 3 * np.eye(n)
    M = rng.standard_normal((n, n))
    E = M @ M.T + n * np.eye(n)  # SPD (ARPACK generalized-mode requirement)
    A = E @ (V @ a0 @ np.linalg.inv(V))
    b = rng.standard_normal((n, 2))
    c = rng.standard_normal((2, n))
    rom, kept = modal_rom(
        sp.csr_matrix(A), sp.csr_matrix(E), b, c,
        shifts=[0 + 0.8j, 0 + 1.5j, 0 + 0.4j, 0 + 0j], k_per_shift=4,
        re_min=-1.0,
    )
    expect = np.array([-0.3 + 1.5j, -0.2 + 0j, -0.1 + 0.8j, -0.05 + 0.4j])
    got = np.sort_complex(np.asarray(kept))
    assert len(got) == 4, got
    assert np.allclose(np.sort_complex(expect), got, atol=1e-7), got
    rom_eigs = np.linalg.eigvals(rom.A)
    assert rom_eigs.real.max() < 0
    # every kept λ (and conjugate) appears in the ROM spectrum
    for lam in kept:
        assert np.abs(rom_eigs - lam).min() < 1e-7

"""Eigenvalue analysis and frequency response of (A, E, B, C) systems.

Port of the reference linear-algebra layer (ref: src/utils/linalg.py):

- generalized eigenproblem A x = λ E x via shift-invert
  (ref: linalg.py:52-129, SLEPc Krylov-Schur + MUMPS). Here: a host path
  (scipy ARPACK + splu — the right tool for one-time sparse analysis) and a
  device path (shift-invert Arnoldi in JAX with a dense complex
  factorization, for problems that fit device memory). JAX has complex
  dtypes, so no real 2n×2n embedding (ref: linalg.py:214,400-417) is
  needed on the device path.
- frequency response H(jω) = C (jωE - A)^{-1} B
  (ref: linalg.py:192-328, three variants: sequential / joblib / MPI).
  Here: host sequential and device-vmapped-over-ω dense complex solves —
  the embarrassing ω-parallelism of the reference's joblib/MPI variants
  maps to one batched solve.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

logger = logging.getLogger(__name__)


# ── Generalized eigenproblem (shift-invert) ──────────────────────────────────


def get_mat_vp_shift_invert(
    a_csr,
    e_csr,
    n: int = 10,
    sigma: complex = 0.0,
    return_vectors: bool = True,
):
    """Eigenvalues of A x = λ E x nearest shift σ (host, ARPACK + splu).

    Matches the reference's SLEPc shift-invert usage
    (ref: linalg.py:52-129). E is singular (pressure rows zero): shift-invert
    handles this; spurious infinite eigenvalues are pushed away from σ.
    """
    vals, vecs = spla.eigs(
        a_csr.astype(np.complex128),
        k=n,
        M=e_csr.astype(np.complex128),
        sigma=sigma,
        which="LM",
        return_eigenvectors=True,
    )
    order = np.argsort(-vals.real)
    vals, vecs = vals[order], vecs[:, order]
    if return_vectors:
        return vals, vecs
    return vals


def eig_arnoldi_dense_device(
    a_dense,
    e_dense,
    n: int = 10,
    sigma: complex = 0.0,
    n_krylov: int = 60,
    dtype=np.complex64,
):
    """Device shift-invert Arnoldi with a dense complex factorization.

    For operator sizes that fit HBM as a dense complex matrix. The inner
    solve (A - σE)⁻¹ E v becomes an LU back-substitution; Arnoldi runs in
    complex64 on device. Returns (eigenvalues, Ritz vectors).
    """
    import jax
    import jax.numpy as jnp

    a = jnp.asarray(a_dense, dtype=dtype)
    e = jnp.asarray(e_dense, dtype=dtype)
    m = a.shape[0]
    lu, piv = jax.scipy.linalg.lu_factor(a - sigma * e)

    def opinv(v):
        return jax.scipy.linalg.lu_solve((lu, piv), e @ v)

    key = jax.random.PRNGKey(0)
    v0 = jax.random.normal(key, (m,), dtype=jnp.float32).astype(dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    vs = jnp.zeros((n_krylov + 1, m), dtype=dtype).at[0].set(v0)
    h = jnp.zeros((n_krylov + 1, n_krylov), dtype=dtype)

    def body(k, state):
        vs, h = state
        w = opinv(vs[k])

        def mgs(j, acc):
            w, hcol = acc
            proj = jnp.where(j <= k, jnp.vdot(vs[j], w), 0.0 + 0.0j)
            return w - proj * vs[j], hcol.at[j].set(proj)

        w, hcol = jax.lax.fori_loop(
            0, n_krylov + 1, mgs, (w, jnp.zeros(n_krylov + 1, dtype))
        )
        nrm = jnp.linalg.norm(w)
        hcol = hcol.at[k + 1].set(nrm.astype(dtype))
        vs = vs.at[k + 1].set(w / jnp.where(nrm > 0, nrm, 1.0))
        h = h.at[:, k].set(hcol)
        return vs, h

    import jax.lax

    vs, h = jax.lax.fori_loop(0, n_krylov, body, (vs, h))
    h_small = np.asarray(h)[:n_krylov, :n_krylov].astype(np.complex128)
    theta, z = np.linalg.eig(h_small)
    lam = sigma + 1.0 / theta
    order = np.argsort(-lam.real)[:n]
    vecs = np.asarray(vs)[:n_krylov].T.astype(np.complex128) @ z[:, order]
    return lam[order], vecs


# ── Frequency response ───────────────────────────────────────────────────────


def get_frequency_response(a_csr, b, c, q_csr, ww, d=None, verbose=False):
    """H(jω) = C (jωQ - A)^{-1} B, sequential host solves (f64).

    (ref: linalg.py:192-232 — scipy splu of the real 2n block; complex splu
    here is simpler and equivalent.)
    """
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    if b.shape[0] != a_csr.shape[0]:
        b = b.T
    c = np.atleast_2d(np.asarray(c, dtype=np.float64))
    ww = np.atleast_1d(np.asarray(ww, dtype=np.float64))
    p, m = c.shape[0], b.shape[1]
    h = np.empty((len(ww), p, m), dtype=np.complex128)
    a_c = a_csr.astype(np.complex128).tocsc()
    q_c = q_csr.astype(np.complex128).tocsc()
    for k, w in enumerate(ww):
        lu = spla.splu(1j * w * q_c - a_c)
        x = lu.solve(b.astype(np.complex128))
        h[k] = c @ x
        if verbose and (k % max(1, len(ww) // 10) == 0):
            logger.info(f"freq response {k + 1}/{len(ww)}: w={w:.3f}")
    if d is not None:
        h = h + np.asarray(d)[None, :, :]
    return h


def get_frequency_response_device(a_dense, b, c, q_dense, ww, dtype=np.complex64):
    """Batched device frequency response: vmapped dense complex solves over ω.

    The reference parallelizes over frequencies with joblib processes or MPI
    (ref: linalg.py:235-328); here the whole sweep is ONE batched XLA solve.
    """
    import jax
    import jax.numpy as jnp

    a = jnp.asarray(a_dense, dtype=dtype)
    q = jnp.asarray(q_dense, dtype=dtype)
    b_ = jnp.asarray(np.atleast_2d(b), dtype=dtype)
    if b_.shape[0] != a.shape[0]:
        b_ = b_.T
    c_ = jnp.asarray(np.atleast_2d(c), dtype=dtype)
    ww_ = jnp.asarray(np.atleast_1d(ww))

    def solve_one(w):
        m = (1j * w) * q - a
        x = jnp.linalg.solve(m, b_)
        return c_ @ x

    h = jax.lax.map(solve_one, ww_.astype(dtype))  # sequential map bounds memory
    return np.asarray(h).astype(np.complex128)


def get_field_response(a_csr, b, q_csr, ww):
    """Full-field response X(ω) = (jωQ - A)^{-1} B (ref: linalg.py:331-388)."""
    b = np.asarray(b, dtype=np.complex128).reshape(a_csr.shape[0], -1)
    a_c = a_csr.astype(np.complex128).tocsc()
    q_c = q_csr.astype(np.complex128).tocsc()
    out = np.empty((len(ww),) + b.shape, dtype=np.complex128)
    for k, w in enumerate(np.atleast_1d(ww)):
        out[k] = spla.splu(1j * w * q_c - a_c).solve(b)
    return out


# ── Matrix conversion helpers (ref: linalg.py:20-46) ─────────────────────────


def dense_to_sparse(mat, eliminate_zeros: bool = True):
    m = sp.csr_matrix(np.asarray(mat))
    if eliminate_zeros:
        m.eliminate_zeros()
    return m


def sparse_to_coo_triplets(mat):
    coo = mat.tocoo()
    return np.stack([coo.row, coo.col], axis=1), coo.data


def get_frequency_response_sharded(a_dense, b, c, q_dense, ww,
                                   dtype=np.complex64, axis="omega"):
    """Device-sharded frequency sweep: ω split across a jax.sharding.Mesh.

    The device-mesh counterpart of the reference's MPI/MUMPS-distributed sweep
    (ref: linalg.py:272-328): each device solves its ω shard's dense complex
    systems; no communication is needed (embarrassingly parallel).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = jax.devices()
    mesh = Mesh(np.array(devs), (axis,))
    ww = np.atleast_1d(np.asarray(ww, dtype=np.float64))
    n_pad = (-len(ww)) % len(devs)
    ww_p = np.concatenate([ww, np.full(n_pad, ww[-1])])

    a = jnp.asarray(a_dense, dtype=dtype)
    q = jnp.asarray(q_dense, dtype=dtype)
    b_ = jnp.asarray(np.atleast_2d(b), dtype=dtype)
    if b_.shape[0] != a.shape[0]:
        b_ = b_.T
    c_ = jnp.asarray(np.atleast_2d(c), dtype=dtype)

    def solve_shard(w_shard):
        def one(w):
            x = jnp.linalg.solve((1j * w) * q - a, b_)
            return c_ @ x

        return jax.lax.map(one, w_shard.astype(dtype))

    fn = jax.shard_map(
        solve_shard, mesh=mesh, in_specs=P(axis), out_specs=P(axis)
    )
    ww_dev = jax.device_put(jnp.asarray(ww_p), NamedSharding(mesh, P(axis)))
    h = np.asarray(fn(ww_dev)).astype(np.complex128)
    return h[: len(ww)]


# ── Reference-named entry points ─────────────────────────────────────────────
# The reference exposes one frequency-response routine per execution strategy
# (ref: linalg.py:192/235/272) and names its eigensolver after SLEPc
# (ref: linalg.py:52-129, eig/eig_utils.py:83-253). Same surface here, mapped
# onto this framework's strategies, so reference-style callers port unchanged.

#: sequential host solves (ref: get_frequency_response_sequential)
get_frequency_response_sequential = get_frequency_response
#: the joblib-process sweep maps onto one batched on-device sweep
get_frequency_response_parallel = get_frequency_response_device
#: the MPI/MUMPS-distributed sweep maps onto the device-sharded sweep
get_frequency_response_mpi = get_frequency_response_sharded
#: legacy SLEPc name — backed by ARPACK shift-invert here (no SLEPc needed)
get_mat_vp_slepc = get_mat_vp_shift_invert


def eigenproblem_slepc(a, e=None, n: int = 10, sigma: complex = 0.0,
                       return_vectors: bool = True):
    """Legacy entry point (ref: eig/eig_utils.py:83-253): generalized
    eigenproblem A x = λ E x near shift σ.

    The reference needs a separate complex-build slepc4py environment for
    this; here complex shift-invert is native (ARPACK host path — see
    ``eig_arnoldi_dense_device`` for the on-device variant)."""
    a = sp.csr_matrix(a)
    e = sp.identity(a.shape[0], format="csr") if e is None else sp.csr_matrix(e)
    return get_mat_vp_shift_invert(a, e, n=n, sigma=sigma,
                                   return_vectors=return_vectors)


def modal_rom(a_csr, e_csr, b, c, shifts=(0.0 + 0.75j,), k_per_shift: int = 6,
              re_min: float = -1.0, pair_tol: float = 1e-6):
    """Real modal (Petrov-Galerkin) reduced-order model of Eẋ = Ax + Bu,
    y = Cx from biorthogonal eigenpairs near the given shifts.

    For each right pair (λ, v) of A x = λ E x the matching LEFT vector w
    (wᴴA = λ wᴴ) is the conjugated eigenvector of (Aᵀ, Eᵀ) at λ̄; scaling
    wᴴE v = 1 makes the modal coordinates exactly decoupled, so the ROM
    is block-diagonal by construction — no QR projection whose
    near-singular Er manufactures spurious unstable eigenvalues (observed:
    a max-Re 9.07 artifact on a pinball ROM built by orthonormalized-basis
    projection). Complex pairs realify to [[σ, ω], [-ω, σ]] blocks with
    B_k = [Re(wᴴB); Im(wᴴB)], C_k = 2[Cv_r, -Cv_i].

    This is the reduced-model step the reference performs offline in
    Matlab (ref: src/examples/cylinder/data_input/sysid_o16_d=3_ssest.mat
    is such a fitted ROM) — here derived directly from the exported
    operators. Returns (StateSpace, kept_eigenvalues).
    """
    import scipy.sparse as _sp

    a_csr = _sp.csr_matrix(a_csr)
    e_csr = _sp.csr_matrix(e_csr)
    b = np.atleast_2d(np.asarray(b, dtype=float))
    if b.shape[0] != a_csr.shape[0]:
        b = b.T
    c = np.atleast_2d(np.asarray(c, dtype=float))
    at, et = a_csr.T.tocsr(), e_csr.T.tocsr()

    rights, lefts = [], []
    for s in shifts:
        vals, vecs = get_mat_vp_shift_invert(a_csr, e_csr, n=k_per_shift,
                                             sigma=s)
        rights += [(vals[i], vecs[:, i]) for i in range(len(vals))]
        avals, avecs = get_mat_vp_shift_invert(at, et, n=k_per_shift,
                                               sigma=np.conj(s))
        lefts += [(avals[i], avecs[:, i]) for i in range(len(avals))]

    blocks_a, blocks_b, blocks_c, kept = [], [], [], []
    for lam, v in rights:
        if lam.real < re_min or lam.imag < -pair_tol:
            continue  # keep one of each conjugate pair, drop deep-damped
        if any(abs(lam - k) < 1e-6 * max(1.0, abs(lam)) for k in kept):
            continue  # dedup across shifts
        # matching left vector: wᴴA = λwᴴE ⇔ Aᵀw = λ̄ Eᵀw (A, E real), so
        # the left vector at λ IS the (Aᵀ, Eᵀ) eigenvector at λ̄ — no
        # conjugation (conjugating pairs it with the wrong eigenvalue and
        # biorthogonality zeroes every wᴴEv)
        errs = [abs(al - np.conj(lam)) for al, _ in lefts]
        j = int(np.argmin(errs))
        if errs[j] > pair_tol * max(1.0, abs(lam)):
            continue
        w = lefts[j][1]
        scale = w.conj() @ (e_csr @ v)
        if abs(scale) < 1e-10:
            continue  # defective/unmatched pair
        w = w / np.conj(scale)  # now wᴴ E v = 1
        beta = w.conj() @ b  # (m,) or (m_act,) rows
        cv = c @ v
        if abs(lam.imag) <= pair_tol:  # real mode: 1x1 block
            blocks_a.append(np.array([[lam.real]]))
            blocks_b.append(np.atleast_2d(beta.real))
            blocks_c.append(np.atleast_2d(cv.real).T)
        else:
            # residue algebra: H_pair(s) = R/(s-λ) + R̄/(s-λ̄) with
            # R = (Cv)(wᴴB) equals the real block below exactly
            # (= 2[(s-σ)Re R - ω Im R]/((s-σ)² + ω²))
            sg, om = lam.real, lam.imag
            blocks_a.append(np.array([[sg, -om], [om, sg]]))
            blocks_b.append(np.vstack([beta.real, beta.imag]))
            blocks_c.append(np.column_stack([2 * cv.real, -2 * cv.imag]))
        kept.append(lam)
    if not blocks_a:
        raise ValueError("modal_rom: no usable eigenpairs near the shifts")
    import scipy.linalg as _sla

    ar = _sla.block_diag(*blocks_a)
    br = np.vstack(blocks_b)
    cr = np.hstack(blocks_c)
    from flowcontrol_tpu.utils.statespace import StateSpace

    return (
        StateSpace(ar, br, cr, np.zeros((cr.shape[0], br.shape[1]))),
        np.asarray(kept),
    )

"""Blocked dense LU factorization/solve built from matmuls.

The dense-regime factor above ``Stepper.LAPACK_LU_MAX_N``. This module
implements the classic right-looking blocked LU with block-inverted
diagonal pivots:

    for k:  Dk⁻¹ = inv(A_kk)            (small block — safe custom call)
            L_jk  = A_jk · Dk⁻¹          (matmul)
            A_jl -= L_jk · A_kl          (matmul, trailing update)

and a blocked forward/back substitution whose inner ops are (bs × bs)·(bs × B)
matmuls, and batched right-hand sides amortize the factor reads (the
batched-rollout regime).

No row pivoting across blocks: the time-step matrices are mass-dominated on
the velocity block and pre-ordered velocity-first, so block-diagonal
inversion is stable in practice; pair with one step of iterative refinement
(Stepper does this in f32) for direct-solver-grade accuracy.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _pad_to_blocks(a: np.ndarray, bs: int):
    n = a.shape[0]
    n_pad = (-n) % bs
    if n_pad == 0:
        return a, n
    out = np.eye(n + n_pad, dtype=a.dtype)
    out[:n, :n] = a
    return out, n


@partial(jax.jit, static_argnames=("n", "n_pad", "bs"))
def _block_lu_from_coo(rows, cols, vals, n: int, n_pad: int, bs: int):
    """Densify COO triplets on device (identity on padding rows) and factor.

    Fusing densify+factor into one jit keeps peak HBM at one n_pad^2 buffer
    plus the diagonal-block inverses. Scatter-ADD (entries are unique in a
    CSR->COO conversion) so callers may zero-pad the triplet arrays to a
    common length and share one compiled program across many matrices of
    the same padded size (substructured solves factor k blocks).
    """
    a = jnp.zeros((n_pad, n_pad), dtype=vals.dtype)
    a = a.at[rows, cols].add(vals)
    if n_pad > n:
        pad_ids = jnp.arange(n, n_pad)
        a = a.at[pad_ids, pad_ids].set(jnp.ones((n_pad - n,), dtype=vals.dtype))
    return _block_lu_body(a, bs)


@partial(jax.jit, static_argnames=("bs",), donate_argnums=(0,))
def _block_lu_inplace(a, bs: int):
    return _block_lu_body(a, bs)


def _block_lu_body(a, bs: int):
    """Right-looking blocked LU. Returns (lu, diag_inv).

    lu: (n, n) with strictly-lower L blocks and upper U blocks in place.
    diag_inv: (nb, bs, bs) inverses of the U diagonal blocks.
    """
    n = a.shape[0]
    nb = n // bs

    def outer(k, state):
        a, dinv = state
        r = k * bs
        akk = jax.lax.dynamic_slice(a, (r, r), (bs, bs))
        akk_inv = jnp.linalg.inv(akk)
        dinv = jax.lax.dynamic_update_slice(dinv, akk_inv[None], (k, 0, 0))
        # panel below diag: L = A[r+bs:, r:r+bs] @ akk_inv — computed for the
        # full column (rows above r are multiplied but discarded via masking)
        col = jax.lax.dynamic_slice(a, (0, r), (n, bs))  # (n, bs)
        l_full = col @ akk_inv
        row_ids = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0)
        below = row_ids >= (r + bs)
        l_col = jnp.where(below, l_full, 0.0)
        # store L in place (only rows below the diagonal block)
        new_col = jnp.where(below, l_col, col)
        a = jax.lax.dynamic_update_slice(a, new_col, (0, r))
        # trailing update: A -= L_col @ U_row (U_row = rows r..r+bs, cols all;
        # columns left of r+bs are already finalized and L_col is zero above,
        # so masking the row block to cols >= r+bs keeps them intact).
        # Column-tiled: the full-width (n, bs) @ (bs, n) form can make XLA
        # materialize several full n^2 intermediates at once; per-tile
        # temps stay at O(n * bs). Reading the U tile from the
        # partially-updated matrix is safe: l_col is zero on rows <= r+bs,
        # so the U rows are never modified by this update.
        def inner(t, a):
            c0 = t * bs
            u_tile = jax.lax.dynamic_slice(a, (r, c0), (bs, bs))
            tile_cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (1, bs), 1)
            u_tile = jnp.where(tile_cols >= (r + bs), u_tile, 0.0)
            a_tile = jax.lax.dynamic_slice(a, (0, c0), (n, bs))
            a_tile = a_tile - l_col @ u_tile
            return jax.lax.dynamic_update_slice(a, a_tile, (0, c0))

        a = jax.lax.fori_loop(0, n // bs, inner, a)
        return a, dinv

    dinv0 = jnp.zeros((nb, bs, bs), dtype=a.dtype)
    a, dinv = jax.lax.fori_loop(0, nb, outer, (a, dinv0))
    return a, dinv


class BlockLU:
    """Factor once on device; solve many times (batched RHS supported).

    Accepts a dense ndarray or any scipy sparse matrix. Sparse input is
    densified ON DEVICE from COO triplets (one scatter op): shipping the
    O(nnz) triplets (~10MB at 55k dofs) instead of the n x n dense matrix
    (~12GB) shrinks the host->device transfer by three orders of magnitude
    and skips the 2x 24GB host f64 staging copies.
    """

    def __init__(self, a, bs: int = 1024, dtype=jnp.float32,
                 nnz_pad: int | None = None, store_dtype=None):
        """``store_dtype`` (e.g. jnp.bfloat16) rounds the FINISHED factor for
        storage/solves — halving factor-read bytes and using the bf16
        matmul rate — while the factorization itself runs in ``dtype``.
        (Factorizing WITH bf16 trailing-matrix storage diverges: elimination
        feeds the rounding error forward. A rounded finished factor is just
        a slightly worse preconditioner — pair with iterative refinement.)"""
        self.bs = bs
        self.dtype = dtype
        if hasattr(a, "tocoo"):  # scipy sparse
            coo = a.tocoo()
            self.n = coo.shape[0]
            self.n_pad = self.n + ((-self.n) % bs)
            rows, cols, data = coo.row, coo.col, coo.data
            if nnz_pad is not None and nnz_pad > len(data):
                # zero-pad the triplets so equal-sized matrices with
                # different sparsity share ONE compiled densify+factor
                pad = nnz_pad - len(data)
                rows = np.concatenate([rows, np.zeros(pad, rows.dtype)])
                cols = np.concatenate([cols, np.zeros(pad, cols.dtype)])
                data = np.concatenate([data, np.zeros(pad, data.dtype)])
            lu, dinv = _block_lu_from_coo(
                jnp.asarray(rows, dtype=jnp.int32),
                jnp.asarray(cols, dtype=jnp.int32),
                jnp.asarray(data, dtype=dtype),
                n=self.n, n_pad=self.n_pad, bs=bs,
            )
        else:
            a_pad, self.n = _pad_to_blocks(np.asarray(a, dtype=np.float64), bs)
            self.n_pad = a_pad.shape[0]
            lu, dinv = _block_lu_inplace(jnp.asarray(a_pad, dtype=dtype), bs)
        self.nb = self.n_pad // bs
        if store_dtype is not None and store_dtype != dtype:
            lu = lu.astype(store_dtype)
            dinv = dinv.astype(store_dtype)
        self.lu = lu
        self.dinv = dinv

    def tree(self):
        return (self.lu, self.dinv)

    def solve(self, b):
        return block_lu_solve(
            (self.lu, self.dinv), b, bs=self.bs, n=self.n
        )


def block_lu_inverse_t(factors, n: int, bs: int, chunk: int = 4096,
                       dtype=jnp.float32):
    """Explicit A⁻ᵀ (n, n) from BlockLU factors, by solving against identity
    columns in fixed-size chunks (bounds peak memory to lu + inv + one
    chunk). Apply as ``x = b @ inv`` — one matmul instead of the sequential
    masked trisolve: half the flops, fully matmul-shaped."""
    outs = []
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        rhs = np.zeros((chunk, n), dtype=np.float32)
        rhs[np.arange(e - s), np.arange(s, e)] = 1.0
        outs.append(
            block_lu_solve(factors, jnp.asarray(rhs), bs=bs, n=n)[: e - s]
        )
    return jnp.concatenate(outs, axis=0).astype(dtype)


@partial(jax.jit, static_argnames=("bs", "n"))
def block_lu_solve(factors, b, bs: int, n: int):
    """Solve A x = b given BlockLU factors; b may have leading batch dims."""
    lu, dinv = factors
    n_pad = lu.shape[0]
    nb = n_pad // bs
    b = jnp.asarray(b)
    out_dtype = b.dtype if b.dtype in (jnp.float32, jnp.float64) else lu.dtype
    batch = b.shape[:-1]
    bt = b.astype(lu.dtype).reshape(-1, b.shape[-1]).T  # (n, B)
    nrhs = bt.shape[1]
    if n_pad != n:
        bt = jnp.concatenate(
            [bt, jnp.zeros((n_pad - n, nrhs), dtype=bt.dtype)], axis=0
        )

    # forward: y_k = b_k - sum_{l<k} L_kl y_l   (L unit-block lower)
    def fwd(k, y):
        r = k * bs
        row = jax.lax.dynamic_slice(lu, (r, 0), (bs, n_pad))  # (bs, n_pad)
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n_pad), 1)
        lmask = col_ids < r
        lrow = jnp.where(lmask, row, 0.0)
        yk = jax.lax.dynamic_slice(y, (r, 0), (bs, nrhs)) - lrow @ y
        return jax.lax.dynamic_update_slice(y, yk, (r, 0))

    y = jax.lax.fori_loop(0, nb, fwd, bt)

    # backward: x_k = Ukk^{-1} (y_k - sum_{l>k} U_kl x_l)
    def bwd(i, x):
        k = nb - 1 - i
        r = k * bs
        row = jax.lax.dynamic_slice(lu, (r, 0), (bs, n_pad))
        col_ids = jax.lax.broadcasted_iota(jnp.int32, (1, n_pad), 1)
        umask = col_ids >= (r + bs)
        urow = jnp.where(umask, row, 0.0)
        rhs_k = jax.lax.dynamic_slice(x, (r, 0), (bs, nrhs)) - urow @ x
        xk = dinv[k] @ rhs_k
        return jax.lax.dynamic_update_slice(x, xk, (r, 0))

    x = jax.lax.fori_loop(0, nb, bwd, y)
    x = x[:n].T.reshape(batch + (n,))
    return x.astype(out_dtype)

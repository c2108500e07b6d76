"""Substructured (block-elimination) direct solver: the dense-LU path past
the single-factor regime.

The reference solves every time step with one sparse MUMPS factorization
(ref: src/flowcontrol/flowsolver.py:812-814). A single dense factor costs
4n² bytes — 12.7 GB at the stock cylinder mesh's 56k dofs. Classic
substructuring restores the direct solve with k× less memory and keeps
every operation a dense matmul:

    order dofs = [interior_1 | ... | interior_k | interface]
    A = [[A_II, A_IB], [A_BI, A_BB]],   A_II block-diagonal by construction
    S = A_BB − Σ_d  A_BI,d · A_dd⁻¹ · A_IB,d        (dense, interface-sized)

    solve:  z_d  = A_dd⁻¹ b_d                        (k batched trisolves)
            x_B  = S⁻¹ (b_B − Σ_d A_BI,d z_d)        (small dense solve)
            x_d  = z_d − A_dd⁻¹ (A_IB,d x_B)         (k batched trisolves)

Memory: k·(n/k)² + 2·k·(n/k)·n_B + n_B² floats — ~n²/k for thin interfaces.
The 1-D spatial strip decomposition keeps the interface at a few % of n for
the elongated flow domains here. The Schur complement is assembled HOST-side
in f64 (k sparse factorizations, one-time) so the device factors start from
exact blocks; on-device factors are f32 (pair with the Stepper's iterative
refinement for direct-solver-grade accuracy).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)


def spatial_dof_order(coords: np.ndarray) -> np.ndarray:
    """Sort dofs by (x, y) coordinate — 1-D strip decomposition order."""
    return np.lexsort((coords[:, 1], coords[:, 0]))


def partition_dofs(a_csr, coords: np.ndarray, n_blocks: int):
    """Split dofs into k interior sets + one interface set.

    A dof is interface iff the matrix graph couples it to a dof of another
    strip. Returns (interiors: list[np.ndarray], interface: np.ndarray).
    """
    n = a_csr.shape[0]
    order = spatial_dof_order(coords)
    strip = np.empty(n, dtype=np.int64)
    strip[order] = np.arange(n) // (-(-n // n_blocks))
    g = (a_csr != 0) + (a_csr != 0).T  # symmetrized coupling pattern
    g = g.tocsr()

    def _row_counts(flags: np.ndarray, ptr: np.ndarray) -> np.ndarray:
        """Per-row sums of ``flags`` given CSR row pointers; robust to empty
        rows anywhere (reduceat raises if a start index == len(flags))."""
        if not len(flags):
            return np.zeros(len(ptr) - 1, dtype=np.int64)
        counts = np.add.reduceat(
            flags.astype(np.int64), np.minimum(ptr[:-1], len(flags) - 1)
        )
        counts[np.diff(ptr) == 0] = 0
        return counts

    interface = np.zeros(n, dtype=bool)
    for d in range(n_blocks - 1):
        # dofs of strip d coupled to strips > d (and vice versa)
        left = np.where(strip == d)[0]
        sub = g[left]
        crosses = _row_counts(strip[sub.indices] > d, sub.indptr)
        interface[left[crosses > 0]] = True
    # the matched partners on the right side of each cut
    gi = g[interface]
    partners = np.unique(gi.indices) if interface.any() else np.array([], int)
    # partner dofs in a HIGHER strip than some interface neighbor are also
    # interface (both sides of a cut must be eliminated last)
    for d in range(n_blocks - 1):
        right = partners[(strip[partners] == d + 1)]
        sub = g[right]
        crosses = _row_counts(strip[sub.indices] <= d, sub.indptr)
        interface[right[crosses > 0]] = True
    interiors = [
        np.where((strip == d) & ~interface)[0] for d in range(n_blocks)
    ]
    return interiors, np.where(interface)[0]


class SubstructuredLU:
    """Factor once (host f64 Schur + device f32 block factors); solve many.

    ``solve`` accepts (..., n) right-hand sides (batched rollouts supported).
    Device state lives in ``self.tree()`` — a pytree suitable for passing
    through jit boundaries like the other Stepper solver kinds.
    """

    def __init__(self, a_csr, coords: np.ndarray, n_blocks: int = 4,
                 bs: int = 512, dtype=jnp.float32, store_dtype=None,
                 apply_mode: str = "trisolve"):
        """``apply_mode``:

        - 'trisolve': store the blocked LU factors; each application runs the
          sequential masked fwd/bwd block substitution.
        - 'inverse': precompute explicit block inverses (one-time O(n³/k²)
          per block, disk-cached) so every application is ONE
          dense matmul per block — half the flops of the masked trisolve
          (which multiplies full rows and discards the masked half), no
          sequential block loop, and a plain matmul. The
          inverse is used as a preconditioner exactly like the f32 factors
          (pair with the Stepper's iterative refinement), so the slightly
          larger ‖I−M⁻¹A‖ of an explicit inverse is immaterial.
        """
        from flowcontrol_tpu.solvers.block_lu import BlockLU, block_lu_solve

        a_csr = a_csr.tocsr()
        n = a_csr.shape[0]
        self.n = n
        self.n_blocks = n_blocks
        t_part = time.time()
        interiors, iface = partition_dofs(a_csr, coords, n_blocks)
        # NOTE: np.where gives each set ascending dof order, which already
        # places pressure dofs (highest indices) after velocity within every
        # block — the stable order for the no-pivot elimination. (Verified:
        # an explicit velocity-first regrouping reproduces bit-identical
        # factors.)
        logger.info("substructure: partition %.1fs", time.time() - t_part)
        if not all(len(i) for i in interiors):
            raise ValueError("empty interior block — reduce n_blocks")
        self.n_iface = len(iface)

        n_imax = max(len(i) for i in interiors)
        n_imax += (-n_imax) % bs  # pad to the trisolve block size
        self.n_imax = n_imax

        # permutation: position -> global dof; padding slots point at n
        perm = np.full(n_blocks * n_imax + len(iface), n, dtype=np.int64)
        for d, ids in enumerate(interiors):
            perm[d * n_imax: d * n_imax + len(ids)] = ids
        perm[n_blocks * n_imax:] = iface
        # inverse: global dof -> position
        ipos = np.empty(n, dtype=np.int64)
        valid = perm < n
        ipos[perm[valid]] = np.where(valid)[0]

        # host-exact Schur complement (f64) — the expensive one-time host
        # work (k sparse factorizations + dense interface solves); cached on
        # disk keyed by matrix content so warm restarts skip it entirely
        from flowcontrol_tpu.solvers.factor_cache import load, matrix_key, save

        # the cached Schur complement is dtype-independent (host f64), but
        # key on the factor params anyway so concurrent configs don't race.
        # The coords digest matters: partition_dofs is coordinate-driven, so
        # identical matrices with different dof coordinates must not collide.
        import hashlib

        coords_digest = hashlib.sha256(
            np.ascontiguousarray(coords).tobytes()
        ).hexdigest()[:16]
        key = matrix_key(
            a_csr, "schur-v2", n_blocks, bs, np.dtype(dtype).name,
            coords_digest,
        )
        cached = load(key)
        schur_hit = (
            cached is not None
            and cached["a_bb"].shape == (len(iface), len(iface))
        )
        self.apply_mode = apply_mode
        np_store = np.dtype(store_dtype if store_dtype is not None else dtype)
        inv_cached = None
        if apply_mode == "inverse":
            ikey = matrix_key(
                a_csr, "inv-v4", n_blocks, bs, np.dtype(dtype).name,
                np_store.name, coords_digest,
            )
            inv_cached = load(ikey)
            if inv_cached is not None and (
                inv_cached["inv"].shape != (n_blocks, n_imax, n_imax)
                or inv_cached["s_inv"].shape != (len(iface), len(iface))
            ):
                inv_cached = None
        t0 = time.time()
        # permute the matrix into substructured order ONCE (one global fancy
        # index); all block extraction below is then contiguous-range slicing.
        # Per-block np.ix_ fancy indexing costs minutes at production sizes.
        order_list = np.concatenate(list(interiors) + [iface])
        a_perm = a_csr[order_list][:, order_list].tocsr()
        offs = np.concatenate([[0], np.cumsum([len(i) for i in interiors])])
        n_int = int(offs[-1])
        a_dds = [
            a_perm[offs[d]: offs[d + 1], offs[d]: offs[d + 1]]
            for d in range(n_blocks)
        ]
        logger.info("substructure: permute+slice %.1fs", time.time() - t0)

        # on an inverse-cache hit nothing below needs the factors or the
        # Schur complement — only the coupling blocks and the permutation
        need_factors = inv_cached is None
        t0 = time.time()
        a_bb = None
        if need_factors:
            a_bb = (
                cached["a_bb"] if schur_hit
                else a_perm[n_int:, n_int:].toarray()
            )
        lus, invs, aib_d, abi_d = [], [], [], []
        # common triplet padding => one compiled densify+factor for all blocks
        nnz_pad = max(a_dd.nnz + n_imax for a_dd in a_dds)
        np_dtype = np_store
        t_splu = t_blu = t_slice = 0.0
        for d, ids in enumerate(interiors):
            ni = len(ids)
            t1 = time.time()
            a_dd = a_dds[d]
            a_ib = a_perm[offs[d]: offs[d + 1], n_int:].toarray()
            a_bi = a_perm[n_int:, offs[d]: offs[d + 1]].toarray()
            t_slice += time.time() - t1
            if need_factors and not schur_hit:
                t1 = time.time()
                lu = spla.splu(a_dd.tocsc())
                a_bb -= a_bi @ lu.solve(a_ib)
                t_splu += time.time() - t1
            if need_factors:
                # device blocks, padded (identity on padding diagonal) —
                # built as raw COO triplets: LIL padding takes minutes here
                t1 = time.time()
                a_dd_coo = a_dd.tocoo()
                pad_ids = np.arange(ni, n_imax, dtype=a_dd_coo.row.dtype)
                a_dd_pad = sp.coo_matrix(
                    (
                        np.concatenate(
                            [a_dd_coo.data,
                             np.ones(n_imax - ni, a_dd_coo.data.dtype)]
                        ),
                        (
                            np.concatenate([a_dd_coo.row, pad_ids]),
                            np.concatenate([a_dd_coo.col, pad_ids]),
                        ),
                    ),
                    shape=(n_imax, n_imax),
                )
                blu = BlockLU(a_dd_pad, bs=bs, dtype=dtype, nnz_pad=nnz_pad,
                              store_dtype=store_dtype)
                if apply_mode == "inverse":
                    # A_d⁻ᵀ via n_imax simultaneous trisolves; the LU is
                    # dropped right after — resident memory is unchanged
                    eye = jnp.eye(n_imax, dtype=jnp.float32)
                    inv_t = block_lu_solve((blu.lu, blu.dinv), eye,
                                           bs=bs, n=n_imax)
                    del blu
                    # one Newton-Schulz polish: V <- V(2I - AᵀV) squares
                    # ‖I - AᵀV‖, recovering the accuracy the no-pivot f32
                    # trisolve chain loses when collapsed into one matrix
                    # (measured: unpolished f32 inverse drifts ~1% over 50
                    # steps; polished matches the trisolve path)
                    inv_t = _newton_schulz_t(a_dd_pad, inv_t, dtype=dtype)
                    invs.append(jnp.asarray(inv_t, dtype=np_dtype))
                else:
                    lus.append(blu)
                t_blu += time.time() - t1
            t1 = time.time()
            pad_ib = np.zeros((n_imax, len(iface)), dtype=np_dtype)
            pad_ib[:ni] = a_ib
            pad_bi = np.zeros((len(iface), n_imax), dtype=np_dtype)
            pad_bi[:, :ni] = a_bi
            aib_d.append(pad_ib)
            abi_d.append(pad_bi)
            t_slice += time.time() - t1
        logger.info(
            "substructure: %d blocks, n_imax=%d, n_iface=%d, mode=%s, "
            "schur %s — slice %.1fs, splu+schur %.1fs, device factors %.1fs",
            n_blocks, n_imax, self.n_iface, apply_mode,
            "cached-inv" if not need_factors
            else ("loaded" if schur_hit else "assembled"),
            t_slice, t_splu, t_blu,
        )
        if need_factors and not schur_hit:
            save(key, a_bb=a_bb)

        t0 = time.time()
        self._bs = bs
        dev = {
            "aib": jnp.asarray(np.stack(aib_d), dtype=np_dtype),
            "abi": jnp.asarray(np.stack(abi_d), dtype=np_dtype),
            "perm": jnp.asarray(perm),
            "ipos": jnp.asarray(ipos),
        }
        self._n_pad_iface = None
        if apply_mode == "inverse":
            if inv_cached is not None:
                # cache entries are f32 (npz cannot round-trip bf16)
                dev["inv"] = jnp.asarray(inv_cached["inv"], dtype=np_dtype)
                dev["s_inv"] = jnp.asarray(inv_cached["s_inv"], dtype=np_dtype)
            else:
                s_lu = BlockLU(a_bb, bs=bs, dtype=dtype)
                eye_b = jnp.eye(len(iface), dtype=jnp.float32)
                s_inv_t = block_lu_solve((s_lu.lu, s_lu.dinv), eye_b,
                                         bs=bs, n=len(iface))
                s_inv_t = _newton_schulz_t(
                    sp.csr_matrix(a_bb), s_inv_t, dtype=dtype
                )
                dev["inv"] = jnp.stack(invs)
                dev["s_inv"] = jnp.asarray(s_inv_t, dtype=np_dtype)
                del s_lu, invs
                jax.block_until_ready(dev["inv"])
                # npz cannot round-trip bf16 — coerce only non-native dtypes
                cache_dt = np_dtype if np_dtype.kind == "f" else np.float32
                save(ikey,
                     inv=np.asarray(dev["inv"], dtype=cache_dt),
                     s_inv=np.asarray(dev["s_inv"], dtype=cache_dt))
            jax.block_until_ready(dev["inv"])
        else:
            # dense path: ships the padded f32 interface matrix
            # (~n_iface^2*4B), smaller than its 12B/nnz triplet encoding
            self._s_lu = BlockLU(a_bb, bs=bs, dtype=dtype,
                                 store_dtype=store_dtype)
            dev["lu"] = jnp.stack([l.lu for l in lus])
            dev["dinv"] = jnp.stack([l.dinv for l in lus])
            dev["s_lu"] = self._s_lu.lu
            dev["s_dinv"] = self._s_lu.dinv
            jax.block_until_ready(dev["lu"])
            self._n_pad_iface = self._s_lu.n_pad
        logger.info(
            "substructure: device factors ready in %.1fs", time.time() - t0
        )
        self._dev = dev

    def tree(self):
        return self._dev

    # static solve parameters for the jitted path
    def static(self):
        return dict(
            n=self.n, n_blocks=self.n_blocks, n_imax=self.n_imax,
            n_iface=self.n_iface, bs=self._bs, mode=self.apply_mode,
        )

    def solve(self, b):
        return substructured_solve(self._dev, b, **self.static())


def _newton_schulz_t(a_sparse, v, dtype=jnp.float32, max_iter=4,
                     tol=1e-5):
    """Newton-Schulz polish of a TRANSPOSED inverse: V ≈ A⁻ᵀ →
    V(2I − AᵀV), iterated until a random-probe residual ‖v − AᵀVv‖/‖v‖
    stops improving (the blocked no-pivot trisolve chain that seeds V can
    start percent-level-wrong at production block sizes; each NS iteration
    squares the residual). Densifies A on device from triplets (O(nnz)
    shipped); runs in the factorization dtype."""
    coo = a_sparse.tocoo()
    n = coo.shape[0]
    a = (
        jnp.zeros((n, n), dtype=dtype)
        .at[jnp.asarray(coo.row), jnp.asarray(coo.col)]
        .add(jnp.asarray(coo.data, dtype=dtype))
    )
    v = jnp.asarray(v, dtype=dtype)
    probe = jnp.asarray(
        np.random.default_rng(0).standard_normal(n), dtype=dtype
    )
    pn = jnp.linalg.norm(probe)
    last = float(jnp.linalg.norm(probe - a.T @ (v @ probe)) / pn)
    for i in range(max_iter):
        if last < tol:
            break
        v2 = 2.0 * v - v @ (a.T @ v)
        res = float(jnp.linalg.norm(probe - a.T @ (v2 @ probe)) / pn)
        if not np.isfinite(res) or res >= last:
            break  # stagnated at the dtype floor (or diverging): keep v
        v, last = v2, res
    logger.info("newton-schulz: n=%d probe residual %.2e", n, last)
    return v


def _vmapped_block_solve(lu, dinv, b, bs: int, n: int):
    """block_lu_solve vmapped over a leading block axis of (lu, dinv, b)."""
    from flowcontrol_tpu.solvers.block_lu import block_lu_solve

    return jax.vmap(
        lambda l, d, bb: block_lu_solve((l, d), bb, bs=bs, n=n)
    )(lu, dinv, b)


from functools import partial


@partial(
    jax.jit,
    static_argnames=("n", "n_blocks", "n_imax", "n_iface", "bs", "mode"),
)
def substructured_solve(dev, b, n: int, n_blocks: int, n_imax: int,
                        n_iface: int, bs: int, mode: str = "trisolve"):
    """x = A⁻¹ b via block elimination; b may carry leading batch dims."""
    batch = b.shape[:-1]
    inverse = mode == "inverse"
    dtype = dev["inv"].dtype if inverse else dev["lu"].dtype
    b = jnp.asarray(b)
    out_dtype = b.dtype if b.dtype in (jnp.float32, jnp.float64) else dtype
    b = b.astype(dtype)
    bext = jnp.concatenate(
        [b, jnp.zeros(batch + (1,), dtype=dtype)], axis=-1
    )
    bp = bext[..., dev["perm"]]  # (..., k*n_imax + n_iface)
    bi = bp[..., : n_blocks * n_imax].reshape(batch + (n_blocks, n_imax))
    bb = bp[..., n_blocks * n_imax:]

    # move the block axis to the front for the per-block solves
    bi_t = jnp.moveaxis(bi, -2, 0)  # (k, ..., n_imax)
    if inverse:
        # one dense matmul per block (inv stores A_d⁻ᵀ)
        z = jnp.einsum("k...i,kij->k...j", bi_t, dev["inv"])
    else:
        z = _vmapped_block_solve(dev["lu"], dev["dinv"], bi_t, bs, n_imax)

    # rhs_B = b_B − Σ_d A_BI,d z_d
    rhs_b = bb - jnp.einsum("kbi,k...i->...b", dev["abi"], z)

    if inverse:
        x_b = jnp.einsum("...i,ij->...j", rhs_b, dev["s_inv"])
    else:
        from flowcontrol_tpu.solvers.block_lu import block_lu_solve

        x_b = block_lu_solve(
            (dev["s_lu"], dev["s_dinv"]), rhs_b, bs=bs, n=n_iface
        )

    # x_d = z_d − A_dd⁻¹ (A_IB,d x_B)
    corr = jnp.einsum("kib,...b->k...i", dev["aib"], x_b)
    if inverse:
        x_i = z - jnp.einsum("k...i,kij->k...j", corr, dev["inv"])
    else:
        x_i = z - _vmapped_block_solve(dev["lu"], dev["dinv"], corr, bs, n_imax)

    x_i = jnp.moveaxis(x_i, 0, -2).reshape(batch + (n_blocks * n_imax,))
    xp = jnp.concatenate([x_i, x_b], axis=-1)
    return xp[..., dev["ipos"]].astype(out_dtype)

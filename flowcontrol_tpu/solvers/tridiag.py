"""Two-level substructuring with a block-TRIDIAGONAL interface Schur
complement: a device direct solver for production meshes past one dense
factor's reach — including the reference's stiffest flagship, the
235k-dof stock cavity at Re=7500/dt=4e-4, which the reference hands to
MUMPS without ceremony (ref: src/flowcontrol/flowsolver.py:812-814,
src/examples/cavity/cavityflowsolver.py:254-268).

Why this beats the dense-interface substructuring (solvers/substructure.py)
at scale: a 1-D strip decomposition's interface Schur complement is
block-TRIDIAGONAL — strip d's interior couples only cuts d-1 and d, and a
cut's dofs couple at most the neighboring cuts — so S factors exactly with
O(k * cut^2) memory instead of the dense O((k*cut)^2) that sizes out at
235k dofs. Structure:

    dofs = [I_1 | ... | I_k | C_1 | ... | C_{k-1}]   (C_c = cut between
                                                      strips c and c+1)
    S_cc' = A_CC,cc' - sum_d A_CI,d A_dd^-1 A_IC,d   nonzero iff |c-c'|<=1

    solve: z_d  = A_dd^-1 b_d                 (k block applies)
           r_C  = b_C - A_CI z                (ELL gather, O(nnz))
           x_C  = S^-1 r_C                    (block-tridiagonal sweep)
           x_d  = z_d - A_dd^-1 (A_IC x_C)    (k block applies)

Design choices:
- Strips are sized so interior blocks stay small (~8k dofs): each block
  gets a PIVOTED f32 factorization via
  ``jnp.linalg.inv`` — no f64 emulation, no no-pivot accuracy cliff.
- Each block apply is ONE dense matmul against the stored explicit inverse
  (half the flops of a masked trisolve, no sequential block loop, the
  matmul-shaped). A Newton-Schulz probe/polish guards
  inverse quality per block.
- Couplings A_CI / A_IC are applied as padded ELL gathers (O(nnz) memory
  and bytes) — NOT stored dense; at 235k dofs dense coupling blocks alone
  would cost ~4-8 GB of HBM.
- The interface sweep is a ``lax.scan`` of cut-sized (cm x cm) matmuls.
- The stacked leading ``k`` axis of the inverse stack is the natural
  sharding axis for a multi-chip ``space`` mesh: device d holds k/n_dev
  block inverses; only O(n) vectors move per solve.

Everything host-side (partition, Schur assembly via per-strip splu,
tridiagonal factorization) runs once in f64 and is disk-cached
(solvers/factor_cache.py).
"""

from __future__ import annotations

import hashlib
import logging
import time
from functools import partial

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)


class PinchError(ValueError):
    """A strip is so thin that one dof couples both its neighbor strips —
    the cut structure (and the tridiagonal Schur) would break. Retry with
    fewer, thicker strips."""


def graph_levels(a_csr, coords: np.ndarray, axis: int = 0,
                 g=None) -> np.ndarray:
    """BFS level number of every dof in the (symmetrized) matrix graph,
    seeded from the min-coordinate boundary layer along ``axis``.

    The level structure is the partition's backbone: a dof in level l
    couples only levels l-1..l+1, so any grouping of CONSECUTIVE levels
    into strips yields graph-clean cuts — independent of mesh grading
    (equal-count coordinate bands pinch where a band is locally thinner
    than a coarse far-field cell; levels are immune by construction).

    Dirichlet-eliminated rows are isolated vertices (identity rows couple
    nothing); they take the level of the spatially-nearest connected dof —
    any assignment is valid for them since no coupling constrains them.
    """
    n = a_csr.shape[0]
    if g is None:
        g = ((a_csr != 0) + (a_csr != 0).T).tocsr()
    deg = np.diff(g.indptr)
    offdiag = deg > 1  # isolated (BC) rows hold only their diagonal
    x = coords[:, axis]
    level = np.full(n, -1, dtype=np.int64)

    conn = np.where(offdiag)[0]
    if not len(conn):
        return np.zeros(n, dtype=np.int64)
    xc = x[conn]
    span = float(xc.max() - xc.min()) or 1.0
    seed = conn[xc <= xc.min() + 5e-3 * span]
    lvl = 0
    frontier = seed
    while True:
        while len(frontier):
            level[frontier] = lvl
            # expand: all neighbors of the frontier not yet leveled
            nbrs = np.concatenate([
                g.indices[g.indptr[i]: g.indptr[i + 1]] for i in frontier
            ]) if len(frontier) < 1024 else g[frontier].indices
            nxt = np.unique(nbrs)
            frontier = nxt[level[nxt] < 0]
            lvl += 1
        rest = np.where((level < 0) & offdiag)[0]
        if not len(rest):
            break
        # disconnected component: restart from its leftmost dof
        frontier = rest[x[rest] <= x[rest].min() + 1e-12]

    # isolated dofs: nearest connected dof by x (argpartition-free interp)
    iso = np.where(level < 0)[0]
    if len(iso):
        done = np.where(level >= 0)[0]
        order = np.argsort(x[done])
        pos = np.searchsorted(x[done][order], x[iso])
        pos = np.clip(pos, 0, len(done) - 1)
        level[iso] = level[done[order]][pos]
    return level


def partition_strips(a_csr, coords: np.ndarray, n_blocks: int,
                     level: np.ndarray | None = None):
    """Split dofs into k strip interiors + (k-1) cuts by grouping
    consecutive BFS graph levels into ~equal-count strips.

    Returns (interiors: list[np.ndarray], cuts: list[np.ndarray]); raises
    PinchError when the structure cannot be built (fewer levels than
    2*n_blocks, or a dof still couples both neighbor strips).
    """
    n = a_csr.shape[0]
    if level is None:
        level = graph_levels(a_csr, coords)
    n_lvl = int(level.max()) + 1
    min_lvls = 4  # >= ~1.5 element layers: 2 avoids pinch, but thinner
    # strips can still yield structurally singular interiors (a pressure
    # dof whose velocity neighbors all fall in the cuts)
    if n_lvl < min_lvls * n_blocks:
        raise PinchError(
            f"only {n_lvl} graph levels for n_blocks={n_blocks} "
            f"(need >= {min_lvls} per strip)"
        )
    # group consecutive levels into strips of ~equal dof count
    lvl_counts = np.bincount(level, minlength=n_lvl)
    strip_of_level = np.zeros(n_lvl, dtype=np.int64)
    target = n / n_blocks
    s = 0
    acc = 0
    nlev_s = 0
    for l in range(n_lvl):
        lvls_left = n_lvl - l
        strips_left = n_blocks - s
        must_close = lvls_left <= min_lvls * (strips_left - 1)
        if s < n_blocks - 1 and nlev_s >= min_lvls and (
            acc >= target or must_close
        ):
            s += 1
            acc = 0
            nlev_s = 0
        strip_of_level[l] = s
        acc += int(lvl_counts[l])
        nlev_s += 1
    strip = strip_of_level[level]

    g = ((a_csr != 0) + (a_csr != 0).T).tocsr()
    # per-row min/max neighbor strip (every row has a diagonal -> nonempty)
    s_cols = strip[g.indices]
    ptr = g.indptr
    hi = np.maximum.reduceat(s_cols, ptr[:-1])
    lo = np.minimum.reduceat(s_cols, ptr[:-1])

    pinch = (hi > strip) & (lo < strip)
    if pinch.any():
        raise PinchError(
            f"{int(pinch.sum())} dofs couple both neighbor strips at "
            f"n_blocks={n_blocks} — strips too thin"
        )
    interface = (hi > strip) | (lo < strip)
    cut_idx = np.where(hi > strip, strip, strip - 1)

    interiors = [
        np.where((strip == d) & ~interface)[0] for d in range(n_blocks)
    ]
    cuts = [
        np.where(interface & (cut_idx == c))[0] for c in range(n_blocks - 1)
    ]
    if not all(len(i) for i in interiors):
        raise PinchError(f"empty strip interior at n_blocks={n_blocks}")
    if not all(len(c) for c in cuts):
        raise PinchError(f"empty cut at n_blocks={n_blocks}")
    return interiors, cuts


def _pad_up(x: int, m: int) -> int:
    return x + (-x) % m


def _csr_to_ell(a_csr, n_cols_pad: int):
    """CSR -> padded ELL (vals (m, K), cols (m, K)); pad entries point at
    ``n_cols_pad`` (caller appends a zero slot)."""
    a_csr = a_csr.tocsr()
    m = a_csr.shape[0]
    widths = np.diff(a_csr.indptr)
    K = max(int(widths.max(initial=0)), 1)
    vals = np.zeros((m, K), dtype=np.float64)
    cols = np.full((m, K), n_cols_pad, dtype=np.int64)
    rows = np.repeat(np.arange(m), widths)
    pos = np.arange(len(a_csr.indices)) - np.repeat(a_csr.indptr[:-1], widths)
    vals[rows, pos] = a_csr.data
    cols[rows, pos] = a_csr.indices
    return vals, cols


class TridiagSubstructuredLU:
    """Factor once; solve many (batched RHS supported, jit/scan/vmap-safe).

    ``solve`` accepts (..., n) right-hand sides. Device state lives in
    ``tree()`` (a pytree passed through jit as an ARGUMENT) with static
    solve parameters in ``static()``.
    """

    #: keep interior blocks small enough for a pivoted dense inverse
    BLOCK_MAX_N = 7500

    def __init__(self, a_csr, coords: np.ndarray, n_blocks: int | None = None,
                 dtype=jnp.float32, store_dtype=None,
                 probe_tol: float | None = None,
                 block_align: int = 256, hbm_budget: float | None = None):
        if probe_tol is None:
            probe_tol = 1e-10 if jnp.dtype(dtype) == jnp.float64 else 1e-4
        a_csr = a_csr.tocsr()
        n = a_csr.shape[0]
        self.n = n
        t_all = time.time()

        np_store = np.dtype(
            jnp.dtype(store_dtype if store_dtype is not None else dtype).name
        )
        if n_blocks is None:
            n_blocks = self.auto_blocks(n, hbm_budget=hbm_budget)
        # partition, backing off if strips pinch
        level = graph_levels(a_csr, coords)
        k = min(n_blocks, max(2, (int(level.max()) + 1) // 4))
        while True:
            try:
                interiors, cuts = partition_strips(a_csr, coords, k,
                                                   level=level)
                break
            except PinchError as e:
                if k <= 2:
                    raise
                k_new = max(2, (3 * k) // 4)
                logger.info("tridiag: %s — retrying with k=%d", e, k_new)
                k = k_new
        self.n_blocks = k = len(interiors)
        self.n_cuts = n_cuts = len(cuts)

        n_imax = _pad_up(max(len(i) for i in interiors), block_align)
        if n_imax > self.BLOCK_MAX_N + block_align:
            logger.warning(
                "tridiag: n_imax=%d exceeds the pivoted-LU comfort zone "
                "(%d) — inverse quality may degrade", n_imax, self.BLOCK_MAX_N
            )
        cm = _pad_up(max(len(c) for c in cuts), 128)
        self.n_imax, self.cm = n_imax, cm
        n_int_pad = k * n_imax
        n_cut_pad = n_cuts * cm

        # permutation: position -> global dof (pad slots point at n)
        perm = np.full(n_int_pad + n_cut_pad, n, dtype=np.int64)
        for d, ids in enumerate(interiors):
            perm[d * n_imax: d * n_imax + len(ids)] = ids
        for c, ids in enumerate(cuts):
            perm[n_int_pad + c * cm: n_int_pad + c * cm + len(ids)] = ids
        ipos = np.empty(n, dtype=np.int64)
        valid = perm < n
        ipos[perm[valid]] = np.where(valid)[0]

        # ── permute once; all block extraction is contiguous slicing ───────
        t0 = time.time()
        order_list = np.concatenate(list(interiors) + list(cuts))
        a_perm = a_csr[order_list][:, order_list].tocsr()
        i_offs = np.concatenate([[0], np.cumsum([len(i) for i in interiors])])
        n_int = int(i_offs[-1])
        c_offs = n_int + np.concatenate(
            [[0], np.cumsum([len(c) for c in cuts])]
        )
        logger.info("tridiag: partition+permute %.1fs (k=%d, n_imax=%d, "
                    "cuts max %d -> cm=%d)", time.time() - t0, k,
                    max(len(i) for i in interiors), max(len(c) for c in cuts),
                    cm)

        from flowcontrol_tpu.solvers.factor_cache import (
            load as fc_load,
            matrix_key as fc_key,
            save as fc_save,
        )

        coords_digest = hashlib.sha256(
            np.ascontiguousarray(coords).tobytes()
        ).hexdigest()[:16]
        skey = fc_key(a_csr, "tridiag-schur-v1", k, coords_digest)
        ikey = fc_key(a_csr, "tridiag-inv-v1", k, n_imax, np_store.name,
                      coords_digest)

        # ── interface Schur: block-tridiagonal assembly + factorization ────
        cached_s = fc_load(skey)
        want = {"dinv", "l", "u"}
        if cached_s is not None and want <= set(cached_s):
            dinv_h, l_h, u_h = cached_s["dinv"], cached_s["l"], cached_s["u"]
            schur_src = "cached"
        else:
            t0 = time.time()
            s_diag, s_lo, s_up = self._assemble_schur(
                a_perm, i_offs, c_offs, n_int, k, n_cuts, cm
            )
            dinv_h, l_h, u_h = self._factor_tridiag(s_diag, s_lo, s_up)
            fc_save(skey, dinv=dinv_h, l=l_h, u=u_h)
            schur_src = f"assembled {time.time() - t0:.1f}s"

        # ── interior block inverses (device, pivoted f32, cached) ──────────
        cached_i = fc_load(ikey)
        if cached_i is not None and cached_i["inv"].shape == (k, n_imax,
                                                              n_imax):
            inv = jnp.asarray(cached_i["inv"], dtype=np_store)
            inv_src = "cached"
        else:
            t0 = time.time()
            inv = self._build_block_inverses(
                a_perm, i_offs, k, n_imax, probe_tol, dtype=dtype
            ).astype(np_store)
            jax.block_until_ready(inv)
            fc_save(ikey, inv=np.asarray(
                inv, dtype=np_store if np_store.kind == "f" else np.float32
            ))
            inv_src = f"built {time.time() - t0:.1f}s"

        # ── couplings as padded ELL over POSITION indices ───────────────────
        t0 = time.time()
        # map permuted-matrix indices -> padded positions
        int_pos = np.concatenate([
            d * n_imax + np.arange(len(ids))
            for d, ids in enumerate(interiors)
        ])
        cut_pos = np.concatenate([
            c * cm + np.arange(len(ids)) for c, ids in enumerate(cuts)
        ])
        a_ci = a_perm[n_int:, :n_int].tocsr()  # (n_cut, n_int)
        a_ic = a_perm[:n_int, n_int:].tocsr()  # (n_int, n_cut)
        # re-index columns into padded positions
        a_ci = sp.csr_matrix(
            (a_ci.data, int_pos[a_ci.indices], a_ci.indptr),
            shape=(a_ci.shape[0], n_int_pad),
        )
        a_ic = sp.csr_matrix(
            (a_ic.data, cut_pos[a_ic.indices], a_ic.indptr),
            shape=(a_ic.shape[0], n_cut_pad),
        )
        # expand rows into padded positions
        ci_vals, ci_cols = _csr_to_ell(a_ci, n_int_pad)
        ic_vals, ic_cols = _csr_to_ell(a_ic, n_cut_pad)
        ci_vals_p = np.zeros((n_cut_pad, ci_vals.shape[1]))
        ci_cols_p = np.full((n_cut_pad, ci_vals.shape[1]), n_int_pad,
                            dtype=np.int64)
        ci_vals_p[cut_pos] = ci_vals
        ci_cols_p[cut_pos] = ci_cols
        ic_vals_p = np.zeros((n_int_pad, ic_vals.shape[1]))
        ic_cols_p = np.full((n_int_pad, ic_vals.shape[1]), n_cut_pad,
                            dtype=np.int64)
        ic_vals_p[int_pos] = ic_vals
        ic_cols_p[int_pos] = ic_cols
        logger.info(
            "tridiag: couplings ELL %.1fs (K_ci=%d, K_ic=%d), schur %s, "
            "inverses %s", time.time() - t0, ci_vals.shape[1],
            ic_vals.shape[1], schur_src, inv_src,
        )

        dt = dtype
        self._dev = {
            "inv": inv,  # (k, n_imax, n_imax), A_dd^-T blocks (right-mult)
            "s_dinv": jnp.asarray(dinv_h, dtype=dt),  # (n_cuts, cm, cm)
            "s_l": jnp.asarray(l_h, dtype=dt),  # (n_cuts-1, cm, cm)
            "s_u": jnp.asarray(u_h, dtype=dt),  # (n_cuts-1, cm, cm)
            "ci_vals": jnp.asarray(ci_vals_p, dtype=dt),
            "ci_cols": jnp.asarray(ci_cols_p, dtype=jnp.int32),
            "ic_vals": jnp.asarray(ic_vals_p, dtype=dt),
            "ic_cols": jnp.asarray(ic_cols_p, dtype=jnp.int32),
            "perm": jnp.asarray(perm),
            "ipos": jnp.asarray(ipos),
        }
        logger.info("tridiag: ready in %.1fs", time.time() - t_all)

    # ── construction helpers ────────────────────────────────────────────────

    @classmethod
    def auto_blocks(cls, n: int, hbm_budget: float | None = None,
                    multiple: int = 8) -> int:
        """Pick k: interior blocks must stay under the pivoted-LU ceiling
        AND the inverse stack (4*n^2/k bytes) under the HBM allowance; k is
        rounded to a multiple of ``multiple`` so a device mesh can shard the
        block axis evenly."""
        if hbm_budget is None:
            from flowcontrol_tpu.config import device_hbm_budget_bytes

            hbm_budget = device_hbm_budget_bytes()
        k_size = -(-n // cls.BLOCK_MAX_N)  # blocks small enough to pivot-LU
        k_mem = int(np.ceil(4.0 * n * n / (0.45 * hbm_budget)))
        k = max(2, k_size, k_mem)
        if k > 2:
            k = _pad_up(k, multiple)
        return k

    @staticmethod
    def _assemble_schur(a_perm, i_offs, c_offs, n_int, k, n_cuts, cm):
        """Host f64: S = A_CC - sum_d A_CI,d A_dd^-1 A_IC,d, tridiagonal
        blocks only (asserts nothing falls outside)."""
        # direct part A_CC — verify tridiagonal-by-cut structure
        a_cc = a_perm[n_int:, n_int:].tocsr()
        cut_of = np.concatenate([
            np.full(c_offs[c + 1] - c_offs[c], c) for c in range(n_cuts)
        ])
        coo = a_cc.tocoo()
        spread = np.abs(cut_of[coo.row] - cut_of[coo.col])
        assert spread.max(initial=0) <= 1, (
            "interface couples non-adjacent cuts — partition invariant broken"
        )
        s_diag = np.zeros((n_cuts, cm, cm))
        s_up = np.zeros((max(n_cuts - 1, 1), cm, cm))
        s_lo = np.zeros((max(n_cuts - 1, 1), cm, cm))

        def cut_slice(c):
            return slice(c_offs[c] - n_int, c_offs[c + 1] - n_int)

        for c in range(n_cuts):
            blk = a_cc[cut_slice(c), cut_slice(c)].toarray()
            s_diag[c, : blk.shape[0], : blk.shape[1]] = blk
            if c + 1 < n_cuts:
                up = a_cc[cut_slice(c), cut_slice(c + 1)].toarray()
                lo = a_cc[cut_slice(c + 1), cut_slice(c)].toarray()
                s_up[c, : up.shape[0], : up.shape[1]] = up
                s_lo[c, : lo.shape[0], : lo.shape[1]] = lo

        # eliminate each strip interior (host splu, exact f64)
        for d in range(k):
            rows = slice(i_offs[d], i_offs[d + 1])
            local_cuts = [c for c in (d - 1, d) if 0 <= c < n_cuts]
            col_ranges = [
                (c, slice(c_offs[c], c_offs[c + 1])) for c in local_cuts
            ]
            # interior must not couple farther cuts (partition invariant)
            a_row = a_perm[rows, n_int:]
            lo_pos = min(c_offs[c] for c, _ in col_ranges) - n_int
            hi_pos = max(c_offs[c + 1] for c, _ in col_ranges) - n_int
            outside = a_row[:, :lo_pos].nnz + a_row[:, hi_pos:].nnz
            assert outside == 0, (
                f"strip {d} couples cuts outside {local_cuts}"
            )
            a_dd = a_perm[rows, rows].tocsc()
            try:
                lu = spla.splu(a_dd)
            except RuntimeError as e:  # singular interior: strip too thin
                raise PinchError(
                    f"interior block {d} singular ({e}) — strips too thin"
                ) from e
            a_ic = sp.hstack(
                [a_perm[rows, cr] for _, cr in col_ranges]
            ).toarray()
            x = lu.solve(a_ic)  # (ni, nloc)
            a_ci = sp.vstack(
                [a_perm[cr, rows] for _, cr in col_ranges]
            ).toarray()
            contrib = a_ci @ x  # (nloc, nloc)
            # scatter the 2x2 cut-block structure of `contrib` into S
            sizes = [cr.stop - cr.start for _, cr in col_ranges]
            offs = np.concatenate([[0], np.cumsum(sizes)])
            for a_i, (ca, _) in enumerate(col_ranges):
                for b_i, (cb, _) in enumerate(col_ranges):
                    piece = contrib[offs[a_i]: offs[a_i + 1],
                                    offs[b_i]: offs[b_i + 1]]
                    if ca == cb:
                        s_diag[ca, : piece.shape[0], : piece.shape[1]] -= piece
                    elif cb == ca + 1:
                        s_up[ca, : piece.shape[0], : piece.shape[1]] -= piece
                    else:  # cb == ca - 1
                        s_lo[cb, : piece.shape[0], : piece.shape[1]] -= piece
        # identity on padding diagonal keeps D blocks invertible
        for c in range(n_cuts):
            ni = c_offs[c + 1] - c_offs[c]
            pad = np.arange(ni, cm)
            s_diag[c, pad, pad] = 1.0
        return s_diag, s_lo, s_up

    @staticmethod
    def _factor_tridiag(s_diag, s_lo, s_up):
        """Block-tridiagonal LU (host f64): returns (dinv, l, u) stacks with
        l_c = S_{c+1,c} D_c^-1 and u_c = S_{c,c+1}."""
        n_cuts = s_diag.shape[0]
        dinv = np.zeros_like(s_diag)
        l = np.zeros_like(s_lo)
        d = s_diag[0]
        for c in range(n_cuts):
            dinv[c] = np.linalg.inv(d)
            if c + 1 < n_cuts:
                l[c] = s_lo[c] @ dinv[c]
                d = s_diag[c + 1] - l[c] @ s_up[c]
        return dinv, l, s_up.copy()

    @staticmethod
    def _build_block_inverses(a_perm, i_offs, k, n_imax, probe_tol,
                              dtype=jnp.float32, chunk: int = 4):
        """Pivoted inverse of every (padded) interior block on device
        (``dtype``; f32 uses XLA's pivoted LU custom call — blocks are sized
        small), transposed for right-multiplication;
        probe-verified, with one Newton-Schulz polish if a probe exceeds
        ``probe_tol``."""
        np_dt = np.dtype(jnp.dtype(dtype).name)
        invs = []
        rng = np.random.default_rng(0)
        worst = 0.0
        for d0 in range(0, k, chunk):
            ds = range(d0, min(k, d0 + chunk))
            blocks = []
            for d in ds:
                rows = slice(i_offs[d], i_offs[d + 1])
                ni = i_offs[d + 1] - i_offs[d]
                coo = a_perm[rows, rows].tocoo()
                a = np.zeros((n_imax, n_imax), dtype=np_dt)
                a[coo.row, coo.col] = coo.data
                pad = np.arange(ni, n_imax)
                a[pad, pad] = 1.0
                blocks.append(a)
            a_stack = jnp.asarray(np.stack(blocks))
            v = _chunk_inverse_t(a_stack)
            # probe the apply convention x = b @ inv
            p = jnp.asarray(
                rng.standard_normal((len(blocks), n_imax)), dtype=a_stack.dtype
            )
            x = jnp.einsum("ki,kij->kj", p, v)
            r = p - jnp.einsum("kij,kj->ki", a_stack, x)
            res = np.asarray(
                jnp.linalg.norm(r, axis=-1) / jnp.linalg.norm(p, axis=-1)
            )
            if res.max() > probe_tol:
                v = _newton_schulz_stack(a_stack, v)
                x = jnp.einsum("ki,kij->kj", p, v)
                r = p - jnp.einsum("kij,kj->ki", a_stack, x)
                res = np.asarray(
                    jnp.linalg.norm(r, axis=-1) / jnp.linalg.norm(p, axis=-1)
                )
            worst = max(worst, float(res.max()))
            invs.append(v)
        logger.info("tridiag: block inverses worst probe residual %.2e",
                    worst)
        return jnp.concatenate(invs, axis=0)

    # ── solve ───────────────────────────────────────────────────────────────

    def tree(self):
        return self._dev

    def static(self):
        return dict(
            n=self.n, n_blocks=self.n_blocks, n_imax=self.n_imax,
            n_cuts=self.n_cuts, cm=self.cm,
        )

    def solve(self, b):
        return tridiag_substructured_solve(self._dev, b, **self.static())


@jax.jit
def _chunk_inverse_t(a_stack):
    """Transposed inverses of a stack of blocks (pivoted LU custom call)."""
    return jnp.linalg.inv(a_stack).transpose(0, 2, 1)


@jax.jit
def _newton_schulz_stack(a_stack, v):
    """One Newton-Schulz step per block on TRANSPOSED inverses:
    V <- 2V - V A^T V (squares ||I - A^T V||)."""
    av = jnp.einsum("kpj,kpq->kqj", v, a_stack)  # A^T V (transposed algebra)
    return 2.0 * v - jnp.einsum("kij,kjq->kiq", v, av)


def _ell_matvec(vals, cols, x_pad):
    """y = A x for padded ELL (vals/cols (m, K)); x_pad carries a trailing
    zero slot that padding columns point at. Batched over leading dims."""
    gathered = x_pad[..., cols]  # (..., m, K)
    return jnp.einsum("mk,...mk->...m", vals, gathered)


def _tridiag_sweep(dinv, l, u, r):
    """Solve the block-tridiagonal S x = r; r: (..., n_cuts, cm)."""
    n_cuts = r.shape[-2]
    r_t = jnp.moveaxis(r, -2, 0)  # (n_cuts, ..., cm)
    if n_cuts == 1:
        x0 = jnp.einsum("ij,...j->...i", dinv[0], r_t[0])
        return jnp.moveaxis(x0[None], 0, -2)

    # forward: y_0 = r_0; y_{c+1} = r_{c+1} - l_c y_c
    def fwd(y_prev, inp):
        r_c, l_prev = inp
        y = r_c - jnp.einsum("ij,...j->...i", l_prev, y_prev)
        return y, y

    y0 = r_t[0]
    _, y_rest = jax.lax.scan(fwd, y0, (r_t[1:], l))
    y = jnp.concatenate([y0[None], y_rest], axis=0)

    # backward: x_C = Dinv_C y_C; x_c = Dinv_c (y_c - u_c x_{c+1})
    def bwd(x_next, inp):
        y_c, dinv_c, u_c = inp
        x = jnp.einsum(
            "ij,...j->...i", dinv_c,
            y_c - jnp.einsum("ij,...j->...i", u_c, x_next),
        )
        return x, x

    x_last = jnp.einsum("ij,...j->...i", dinv[-1], y[-1])
    _, x_rest = jax.lax.scan(
        bwd, x_last, (y[:-1], dinv[:-1], u), reverse=True
    )
    x = jnp.concatenate([x_rest, x_last[None]], axis=0)
    return jnp.moveaxis(x, 0, -2)


@partial(
    jax.jit,
    static_argnames=("n", "n_blocks", "n_imax", "n_cuts", "cm"),
)
def tridiag_substructured_solve(dev, b, n: int, n_blocks: int, n_imax: int,
                                n_cuts: int, cm: int):
    """x = A^-1 b via two-level block elimination; b may carry leading
    batch dims. All heavy ops are dense matmuls (block inverses, cm-sized
    tridiagonal sweep) or O(nnz) ELL gathers (couplings)."""
    batch = b.shape[:-1]
    dtype = dev["inv"].dtype
    out_dtype = b.dtype if b.dtype in (jnp.float32, jnp.float64) else dtype
    b = jnp.asarray(b).astype(dtype)
    n_int_pad = n_blocks * n_imax
    n_cut_pad = n_cuts * cm

    bext = jnp.concatenate(
        [b, jnp.zeros(batch + (1,), dtype=dtype)], axis=-1
    )
    bp = bext[..., dev["perm"]]
    bi = bp[..., :n_int_pad].reshape(batch + (n_blocks, n_imax))
    bc = bp[..., n_int_pad:]

    def int_solve(v_blocks):  # (..., k, n_imax) -> (..., k, n_imax)
        return jnp.einsum("...ki,kij->...kj", v_blocks, dev["inv"])

    z = int_solve(bi)
    z_flat = z.reshape(batch + (n_int_pad,))
    z_pad = jnp.concatenate(
        [z_flat, jnp.zeros(batch + (1,), dtype=dtype)], axis=-1
    )
    r_c = bc - _ell_matvec(dev["ci_vals"], dev["ci_cols"], z_pad)

    x_c = _tridiag_sweep(
        dev["s_dinv"], dev["s_l"], dev["s_u"],
        r_c.reshape(batch + (n_cuts, cm)),
    ).reshape(batch + (n_cut_pad,))

    xc_pad = jnp.concatenate(
        [x_c, jnp.zeros(batch + (1,), dtype=dtype)], axis=-1
    )
    v = _ell_matvec(dev["ic_vals"], dev["ic_cols"], xc_pad)
    x_i = z - int_solve(v.reshape(batch + (n_blocks, n_imax)))

    xp = jnp.concatenate(
        [x_i.reshape(batch + (n_int_pad,)), x_c], axis=-1
    )
    return xp[..., dev["ipos"]].astype(out_dtype)

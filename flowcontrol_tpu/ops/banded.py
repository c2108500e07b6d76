"""Window-banded sparse matvec: constant-operator application with no gathers.

A constant sparse operator applied inside the hot step (the velocity mass M;
CN's velocity operator) costs a full gather/scatter element pass through the
ELL gather tables. Reordered by reverse Cuthill-McKee the operator's bandwidth
drops to O(sqrt(n)), so each 128-row block only ever reads a short static
column window: the apply becomes

    1-D permute -> pad -> per-block static window rows -> batched
    (nbc,128,Wc)x(nbc,Wc) einsums -> inverse permute

with zero data-dependent gathers except the 1-D permutes (batched applies
amortize both the permutes and the tile reads).

Row blocks are BUCKETED BY WINDOW WIDTH (128-rounded, classes chosen by a
penalty-DP like the multifrontal stage repack): RCM window widths spread
~2-5x across blocks (stock O1 mass: p50 = 1096, max = 1592), so padding
every block to the global max streams ~1.5x more zero bytes than
per-class padding. Each class is one einsum; the block reorder folds into
the output index map, and all-zero row blocks (pressure rows of the
velocity mass) read a single appended zero slot instead of tiles.

The tiles are dense zero-padded windows (density ~1% — deliberately trading
device-memory bytes for streaming reads; ~250 MB at 56k dofs). Builds
that would exceed ``max_bytes`` return None so callers fall back to the
gather apply.

Role in the reference: dolfin/PETSc CSR matvecs inside the per-step RHS
assembly (ref: src/flowcontrol/flowsolver.py:703-799).
"""
from __future__ import annotations

import logging

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

import jax
import jax.numpy as jnp

logger = logging.getLogger(__name__)

_R = 128  # row-block height

# HIGHEST precision: the tile einsum is matmul-shaped, and on the H100 an
# f32 dot at DEFAULT or HIGH may run in TF32 (10 mantissa bits), which
# would round every mass-apply sum to ~3 digits. CPU ignores the flag.
_PREC = jax.lax.Precision.HIGHEST


def _width_runs(wr: np.ndarray, itemsize: int,
                lam_bytes: float = 8 * 2**20):
    """Contiguous-run variant of :func:`_width_classes` for pre-ordered
    layouts: blocks keep their order (so the class concat IS the output
    layout — no output index map) and classes are contiguous runs chosen
    by the same padded_bytes + lam * n_classes DP. RCM widths vary
    smoothly along the band, so contiguous runs give up ~10% vs sorted
    classes (measured: stock O1 mass 280 vs 255 MB).
    Returns [(class_width, start_block, end_block)] covering all blocks
    in order (width 0 => all-zero run)."""
    nb = len(wr)
    if nb == 0:
        return []
    INF = float("inf")
    best = np.full(nb + 1, INF)
    best[0] = 0.0
    choice = np.zeros(nb + 1, dtype=np.int64)
    # run length bounded at 512 blocks: keeps the DP O(nb*512); a forced
    # split of a longer uniform run costs only one extra einsum dispatch
    for j in range(1, nb + 1):
        wmax = 0
        for i in range(j - 1, max(j - 513, -1), -1):
            if wr[i] > wmax:
                wmax = int(wr[i])
            c = best[i] + (j - i) * _R * wmax * itemsize + lam_bytes
            if c < best[j]:
                best[j] = c
                choice[j] = i
    runs = []
    j = nb
    while j > 0:
        i = int(choice[j])
        runs.append((int(wr[i:j].max(initial=0)), i, j))
        j = i
    runs.reverse()
    return runs


def _width_classes(wr: np.ndarray, itemsize: int,
                   lam_bytes: float = 8 * 2**20):
    """Partition the (descending-sorted unique) block widths into classes.

    DP minimizing  padded_tile_bytes + lam_bytes * n_classes  over
    contiguous groups of the width-sorted blocks — the same objective as
    the multifrontal stage repack (solvers/multifrontal.py:_repack_dp).
    Returns a list of (class_width, block_indices) with blocks sorted by
    width descending inside the original block numbering.
    """
    nz = np.flatnonzero(wr > 0)
    if len(nz) == 0:
        return []
    order = nz[np.argsort(-wr[nz], kind="stable")]
    w_sorted = wr[order]
    m = len(order)
    # candidate boundaries = positions where the width changes
    starts = [0] + [i for i in range(1, m) if w_sorted[i] != w_sorted[i - 1]]
    starts.append(m)
    k = len(starts) - 1  # number of width runs
    best = np.full(k + 1, np.inf)
    best[0] = 0.0
    choice = np.zeros(k + 1, dtype=np.int64)
    for j in range(1, k + 1):
        for i in range(j):
            # group covers runs [i, j): width = width of run i (largest)
            nblocks = starts[j] - starts[i]
            cost = nblocks * _R * int(w_sorted[starts[i]]) * itemsize
            tot = best[i] + cost + lam_bytes
            if tot < best[j]:
                best[j] = tot
                choice[j] = i
    # backtrack
    bounds = []
    j = k
    while j > 0:
        i = int(choice[j])
        bounds.append((starts[i], starts[j]))
        j = i
    bounds.reverse()
    return [(int(w_sorted[a]), order[a:b]) for a, b in bounds]


def build_banded(mat, dtype=np.float32, max_bytes: int = 6_000_000_000,
                 ordered: bool = False):
    """Host-side build: CSR -> (device tree, static meta) or None if too big.

    The returned ``tree`` is a dict of device arrays (a pytree safe to put in
    a jitted closure/argument); apply with :func:`banded_matvec`.

    ``ordered=True`` = the caller's dof layout is ALREADY bandwidth-
    minimizing (the stepper's hot order, core/stepper.py): skip the RCM,
    keep blocks in place with contiguous-run width classes, and emit a
    tree whose apply has ZERO element permutes (in/out are identity).
    """
    m = sp.csr_matrix(mat)
    n = m.shape[0]
    if m.shape[0] != m.shape[1]:
        raise ValueError("banded apply needs a square operator")
    m.eliminate_zeros()
    if ordered:
        mp = m.tocsr()
    else:
        perm = np.asarray(reverse_cuthill_mckee(m, symmetric_mode=False))
        mp = m[perm][:, perm].tocsr()
        iperm = np.empty(n, dtype=np.int64)
        iperm[perm] = np.arange(n)

    nb = (n + _R - 1) // _R
    indptr, indices = mp.indptr, mp.indices
    lo = np.zeros(nb, dtype=np.int64)
    width = np.zeros(nb, dtype=np.int64)
    for b in range(nb):
        r0, r1 = b * _R, min((b + 1) * _R, n)
        cols = indices[indptr[r0]:indptr[r1]]
        if len(cols):
            lo[b] = cols.min()
            width[b] = cols.max() + 1 - lo[b]
    # 128-align each window start; per-block effective width then rounds
    # up to the 128 grid and blocks bucket into width classes
    lo_a = (lo // _R) * _R
    eff = lo - lo_a + width
    wr = (((eff + _R - 1) // _R) * _R).astype(np.int64)
    wr[width == 0] = 0
    itemsize = np.dtype(dtype).itemsize
    if ordered:
        classes = [
            (w, np.arange(a, b)) for w, a, b in _width_runs(wr, itemsize)
        ]
    else:
        classes = _width_classes(wr, itemsize)
    tile_bytes = sum(len(blk) * _R * w * itemsize for w, blk in classes)
    if tile_bytes > max_bytes:
        w2 = int(wr.max(initial=0))
        logger.info(
            "banded build skipped: tiles %.1f GB > cap %.1f GB (n=%d, W=%d)",
            tile_bytes / 1e9, max_bytes / 1e9, n, w2,
        )
        return None

    # Fill the tiles ON DEVICE from COO triplets: the tiles are ~99% zeros,
    # so materializing them host-side and shipping them through the (slow,
    # serialized) device transport would dominate setup — the triplets are
    # ~40x smaller. One one-time scatter per class builds the windows in HBM.
    coo = mp.tocoo()
    rows, cols, vals = coo.row, coo.col, coo.data
    bi = rows // _R

    w_max = int(wr.max(initial=0))
    logger.info(
        "banded operator: n=%d nnz=%d W_max=%d classes=%s tiles=%.0f MB",
        n, mp.nnz, w_max,
        [(w, len(blk)) for w, blk in classes], tile_bytes / 1e6,
    )

    # output layout: class tiles concatenated block-major, one trailing
    # zero row-slot for the all-zero blocks (and the n..npad tail).
    # (ordered mode: classes are contiguous runs in block order, so the
    # concat IS the layout — out_idx/perm are omitted from the tree and
    # the apply has no element permutes. Zero-width runs flow through the
    # same path with w=0: the empty-axis einsum yields exact zeros.)
    out_idx = np.full(n, -1, dtype=np.int64)
    row_off = 0
    per_cls = []  # (nbc, w, idx_host, vals_host, win_host)
    for w, blk in classes:
        wb = w // _R
        pos_of_block = np.full(nb, -1, dtype=np.int64)
        pos_of_block[blk] = np.arange(len(blk))
        sel = pos_of_block[bi] >= 0
        cbi = pos_of_block[bi[sel]]
        cri = rows[sel] - bi[sel] * _R
        cci = cols[sel] - lo_a[bi[sel]]
        win = (lo_a[blk] // _R)[:, None] + np.arange(wb)[None, :]
        nbc = len(blk)
        per_cls.append((
            nbc, int(w),
            np.stack([cbi, cri, cci], axis=1).astype(np.int32),
            vals[sel], win.astype(np.int32),
        ))
        # rows of these blocks land at [row_off, row_off + nbc*_R)
        for j, b in enumerate(blk):
            r0, r1 = b * _R, min((b + 1) * _R, n)
            out_idx[r0:r1] = row_off + j * _R + np.arange(r1 - r0)
        row_off += nbc * _R

    # Fill the tiles from COO triplets. The tiles are ~99% zeros, so ONE
    # jitted call scatters every class on device: only the ~40x-smaller
    # triplets cross the host->device transfer, and there is a single XLA
    # compilation (one scatter per class would compile ~32 programs).
    specs = tuple((nbc, w) for nbc, w, _, _, _ in per_cls)

    def _fill_all(idxs, valss):
        return tuple(
            jnp.zeros((nbc, _R, w), dtype=dtype)
            .at[i[:, 0], i[:, 1], i[:, 2]].set(v)
            for (nbc, w), i, v in zip(specs, idxs, valss)
        )

    tiles_all = jax.jit(_fill_all)(
        [jnp.asarray(idx) for _, _, idx, _, _ in per_cls],
        [jnp.asarray(v, dtype=dtype) for _, _, _, v, _ in per_cls],
    )
    cls_dev = [
        {"tiles": t, "win": jnp.asarray(win)}
        for t, (_, _, _, _, win) in zip(tiles_all, per_cls)
    ]
    if ordered:
        return {"classes": tuple(cls_dev)}
    # all-zero blocks (and any unassigned rows) read the appended zero slot
    out_idx[out_idx < 0] = row_off

    # map original dof i -> position in the concat layout of RCM row iperm[i]
    final_idx = out_idx[iperm]

    tree = {
        "classes": tuple(cls_dev),
        "perm": jnp.asarray(perm, dtype=jnp.int32),
        "out_idx": jnp.asarray(final_idx, dtype=jnp.int32),
    }
    return tree


def banded_matvec(tree, x):
    """y = A x through the banded width-class tiles. Supports leading
    batch dims. Trees from ``build_banded(ordered=True)`` carry no
    perm/out_idx — input and output are identity (zero element permutes)."""
    ordered = "perm" not in tree
    n = x.shape[-1]
    batch = x.shape[:-1]
    # static pad for the window reshape: windows may run past block nb-1
    # (all quantities here come from static shapes, never traced values)
    nb = (n + _R - 1) // _R
    w_max = max(
        (cls["tiles"].shape[2] for cls in tree["classes"]), default=_R
    )
    n_pad = nb * _R - n + max(w_max, _R)
    xp = x if ordered else jnp.take(x, tree["perm"], axis=-1)
    xpad = jnp.concatenate(
        [xp, jnp.zeros(batch + (n_pad,), dtype=x.dtype)], axis=-1
    )
    xw = xpad.reshape(batch + (-1, _R))
    outs = []
    for cls in tree["classes"]:
        tiles, win = cls["tiles"], cls["win"]
        nbc, _, w = tiles.shape
        if w == 0:  # all-zero contiguous run (e.g. pressure rows)
            outs.append(jnp.zeros(batch + (nbc * _R,), dtype=x.dtype))
            continue
        xwin = jnp.take(xw, win, axis=-2).reshape(batch + (nbc, w))
        yp = jnp.einsum("brw,...bw->...br", tiles, xwin, precision=_PREC)
        outs.append(yp.reshape(batch + (nbc * _R,)))
    if ordered:
        return jnp.concatenate(outs, axis=-1)[..., :n]
    outs.append(jnp.zeros(batch + (1,), dtype=x.dtype))  # zero-block slot
    ycat = jnp.concatenate(outs, axis=-1)
    return jnp.take(ycat, tree["out_idx"], axis=-1)

"""Batched multifrontal direct solver: nested dissection with dense
frontal matrices, executed per tree depth as batched dense matmuls.

This is the device-side replacement for MUMPS at production scale — the
reference factors every time-step matrix with sparse multifrontal LU
(ref: src/flowcontrol/flowsolver.py:812-814); 1-D substructuring needs
~4n^2/k + O(k*sep^2) bytes of device memory, which grows past 11 GB for
wide graded meshes (the 235k-dof stock cavity's
cross-section is ~4k dofs — min over k lands above 11 GB). Nested
dissection brings factor storage down to ~sum(sep^2) + n*leaf ≈ 1-2 GB at
235k because separators SHRINK with tree depth.

Structure:

- ORDERING (host): recursive bisection by single BFS-graph-level
  separators (a dof in level l couples only l±1, so one level disconnects
  its sides — see solvers/tridiag.graph_levels). The split axis follows
  the tile's longest extent; the separator level is chosen as the
  smallest level near the dof-count median (graded meshes have cheap and
  expensive fronts — we cut where the front is thin).
- FACTORIZATION (host, f64, disk-cached): classic multifrontal postorder —
  each node assembles its frontal matrix F over [elim | boundary] dofs,
  extend-adds the children's Schur updates, eliminates its own dofs with a
  PIVOTED dense inverse, and passes the Schur complement up. Factors are
  stored f32 (rounding an exact factor costs ~1e-6 solve accuracy —
  measured in round 2 — while f32 *elimination* at these sizes does not).
- SOLVE (device, jit): one forward + one backward sweep over ~10-15 tree
  depths. All nodes at a depth execute as ONE batched dense matmul over
  padded stacks (inv_ii, F_ib, F_bi), with gather/scatter between the
  global vector and the per-node index lists (scatter-add via the padded
  gather-table transpose, the repo's standard assembly layout).
  Per-solve memory traffic = one read of the factors (~2x1.5 GB fwd+bwd
  at 235k).

The per-depth node axis is also the distribution axis: shard the stacks
over a `space` device mesh and each device owns a subtree forest.
"""

from __future__ import annotations

import hashlib
import logging
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from flowcontrol_tpu.solvers.tridiag import graph_levels

logger = logging.getLogger(__name__)

# Sweep einsums run at HIGHEST matmul precision: with a panel or batch
# dim they lower to matmuls, and on the H100 an f32 matmul at DEFAULT or
# HIGH may run in TF32 (10 mantissa bits). A direct solver's selling point
# is backward stability, so full f32 is the only defensible point. CPU
# ignores the flag.
_PREC = jax.lax.Precision.HIGHEST


@dataclass
class _Node:
    elim: np.ndarray  # global dof ids eliminated at this node
    children: list = field(default_factory=list)
    depth: int = 0
    bd: np.ndarray | None = None  # exterior neighbors of the subtree
    delayed: np.ndarray | None = None  # pivots passed up to the parent


def _bincount_levels(level):
    return np.bincount(level[level >= 0])


def _choose_separator(level: np.ndarray, counts: np.ndarray,
                      window: int = 6):
    """Separator = the smallest level near the dof-count median (cut where
    the front is thin), subject to a balance guarantee: unbalanced splits
    recurse deep and fragment the stage structure."""
    n_lvl = len(counts)
    csum = np.cumsum(counts)
    total = csum[-1]
    mid = int(np.searchsorted(csum, total / 2))
    mid = min(max(mid, 1), n_lvl - 2)
    lo = max(1, mid - window)
    hi = min(n_lvl - 1, mid + window + 1)
    cand = np.arange(lo, hi)
    if len(cand):
        left = csum[cand - 1]
        right = total - csum[cand]
        ok = np.minimum(left, right) >= 0.25 * total
        if ok.any():
            cand = cand[ok]
            return int(cand[np.argmin(counts[cand])])
    return mid


def build_nd_tree(g, coords: np.ndarray, dofs: np.ndarray,
                  leaf_max: int = 1536, depth: int = 0,
                  trim_passes: int = 4) -> _Node:
    """Recursive nested-dissection tree over ``dofs`` (global ids).

    ``g`` is the symmetrized global pattern (CSR). Separators are single
    BFS levels of the induced subgraph, seeded along the tile's longest
    coordinate extent.
    """
    if len(dofs) <= leaf_max or depth >= 40:
        return _Node(elim=np.sort(dofs), depth=depth)
    sub = g[dofs][:, dofs].tocsr()  # g symmetric -> sub symmetric
    c = coords[dofs]
    # try BOTH axes and keep the smaller separator: geometric extent is a
    # bad proxy on graded/anisotropic meshes (a tile can be wide in x yet
    # have far cheaper x-fronts than y-fronts)
    best = None
    for axis in (0, 1):
        level = graph_levels(sub, c, axis=axis, g=sub)
        counts = _bincount_levels(level)
        if len(counts) < 5:
            continue
        si = _choose_separator(level, counts)
        if best is None or counts[si] < best[0]:
            best = (int(counts[si]), level, si)
    if best is None:
        logger.warning(
            "multifrontal: unsplittable tile of %d dofs at depth %d — "
            "oversized leaf", len(dofs), depth,
        )
        return _Node(elim=np.sort(dofs), depth=depth)
    _, level, s = best
    # TRIM the level separator: a BFS level is a valid separator but not a
    # minimal one — any level-s vertex with no neighbor strictly on one
    # side can move to the other side without connecting left and right.
    # Factor content is ~sum(sep^2), so thinner separators cut factor
    # bytes (= single-stream HBM time, batched flops, upload) directly:
    # measured -13/-14% content at the stock scales, and together with the
    # 512-dof leaves it beats the canonical tree on BOTH bytes AND
    # per-solve error (tools/mf_err_ab.py) — default ON.
    side = np.sign(level - s).astype(np.int8)  # -1 left, 0 sep, +1 right
    for _ in range(trim_passes):
        sep_loc = np.where(side == 0)[0]
        if not len(sep_loc):
            break
        moved = 0
        for v in sep_loc:
            nbrs = sub.indices[sub.indptr[v]: sub.indptr[v + 1]]
            sn = side[nbrs]
            has_l = (sn < 0).any()
            has_r = (sn > 0).any()
            if not has_r:
                side[v] = -1  # only-left couplings: join the left side
                moved += 1
            elif not has_l:
                side[v] = 1
                moved += 1
        if not moved:
            break
    left = dofs[side < 0]
    right = dofs[side > 0]
    sep = dofs[side == 0]
    if not len(left) or not len(right):
        return _Node(elim=np.sort(dofs), depth=depth)
    if not len(sep):
        # fully trimmed away (no crossing edges): keep one vertex as the
        # node's elim so every tree node eliminates something — moving a
        # no-right-neighbor vertex up is always separator-safe
        sep, left = left[:1], left[1:]
        if not len(left):
            return _Node(elim=np.sort(dofs), depth=depth)
    node = _Node(elim=np.sort(sep), depth=depth)
    node.children = [
        build_nd_tree(g, coords, left, leaf_max, depth + 1, trim_passes),
        build_nd_tree(g, coords, right, leaf_max, depth + 1, trim_passes),
    ]
    return node


def _merge_small_nodes(v: _Node, min_elim: int = 192):
    """Collapse nodes with tiny elim sets into their parent (the parent
    adopts the grandchildren). Tiny separators/leaves fragment the batched
    per-depth stages into hundreds of single-node matmuls; merging costs a
    slightly fatter parent front and buys an order of magnitude fewer
    stages."""
    new_children = []
    for c in v.children:
        _merge_small_nodes(c, min_elim)
        if len(c.elim) < min_elim:
            v.elim = np.sort(np.concatenate([v.elim, c.elim]))
            new_children.extend(c.children)
        else:
            new_children.append(c)
    v.children = new_children


def _set_depths(v: _Node, depth: int = 0):
    v.depth = depth
    for c in v.children:
        _set_depths(c, depth + 1)


def _annotate_boundaries(g, root: _Node):
    """bd(v) = exterior neighbors of subtree(v) — by the separator
    property these are exactly ancestor elim dofs. Bottom-up pass."""

    def visit(v) -> np.ndarray:  # returns subtree dof set (sorted)
        if not v.children:
            sub = v.elim
        else:
            parts = [visit(c) for c in v.children] + [v.elim]
            sub = np.sort(np.concatenate(parts))
        nbrs = np.unique(g[sub].indices)
        v.bd = np.setdiff1d(nbrs, sub, assume_unique=False)
        return sub

    visit(root)
    # normalize depths so stacking groups by actual tree depth
    return root


def _postorder(root: _Node):
    out = []

    def rec(v):
        for c in v.children:
            rec(c)
        out.append(v)

    rec(root)
    return out


class MultifrontalLU:
    """Factor once (host f64, disk-cached); solve many on device.

    ``solve`` accepts (..., n) right-hand sides; device state is a pytree
    (``tree()``) + static shape info (``static()``) so the jitted solve can
    sit inside scans/vmaps like the other solver kinds.
    """

    #: per-solve relative-error ceiling (measured by _measure_solve_err)
    #: below which the f32 factors need no refinement sweep. The f32
    #: trajectory gates are 1e-4-class field errors, and a single solve
    #: above that breaks them on its own: the Re=7500 cavity's 30k-dof
    #: test mesh probes at 7.5e-4 and its 3-step f32 field error was
    #: 3.6e-4 with no sweep. Above the ceiling the stepper runs one
    #: mixed-precision (f64-residual) sweep.
    ZERO_SWEEP_ERR = 1e-4

    def __init__(self, a_csr, coords: np.ndarray, leaf_max: int | None = None,
                 dtype=jnp.float32, store_dtype=None, layout: str | None = None,
                 trim: bool | None = None, inbox: str | None = None):
        import os

        a_csr = a_csr.tocsr()
        n = a_csr.shape[0]
        self.n = n
        # knob resolution: explicit argument > FC_* env var > default.
        # Host probe (tools/mf_err_ab.py): trimming cuts physical factor
        # bytes 13/15% at leaf 1536 (and 39/42% at leaf 512) at the
        # 56k/235k stock meshes with per-solve error BETTER than the
        # canonical tree. Leaf 1536 is inherited from the previous
        # accelerator and not yet measured on the GPU: below it the extra
        # leaf nodes grow the inbox-gather traffic.
        if leaf_max is None:
            leaf_max = int(os.environ.get("FC_MF_LEAF_MAX", "1536"))
        # 'ij' = canonical stacks; 'ji' = stacks pre-transposed ON HOST so
        # the solve's dot_generals contract the leading (non-minor) dim —
        # an A/B knob for the observed XLA transpose-of-the-factor-stack
        # (a {0,2,1} transpose of the full stack per solve would triple the
        # HBM traffic). Env FC_MF_LAYOUT overrides.
        self.layout = layout or os.environ.get("FC_MF_LAYOUT", "ij")
        if self.layout not in ("ij", "ji"):
            raise ValueError(f"layout must be 'ij' or 'ji', got {self.layout}")
        if trim is None:
            trim = os.environ.get("FC_MF_TRIM", "1") == "1"
        self.trim = bool(trim)
        self.leaf_max = int(leaf_max)
        t_all = time.time()
        np_store = np.dtype(
            jnp.dtype(store_dtype if store_dtype is not None else dtype).name
        )

        from flowcontrol_tpu.solvers.factor_cache import (
            entry_dir as fc_entry_dir,
            load as fc_load,
            matrix_key as fc_key,
            save_async as fc_save_async,
        )

        coords_digest = hashlib.sha256(
            np.ascontiguousarray(coords).tobytes()
        ).hexdigest()[:16]
        # trimmed separators build a different tree than the canonical v4
        # ordering — distinct cache keys; untrimmed keeps the v4 key so
        # existing warm caches stay valid
        ver = "multifrontal-v5t" if self.trim else "multifrontal-v4"
        key = fc_key(a_csr, ver, leaf_max, np_store.name, coords_digest)
        # knobs that shape the DERIVED (upload-ready) representation
        pack = os.environ.get("FC_MF_PACK", "dp")
        if pack not in ("dp", "bucket"):
            raise ValueError(f"FC_MF_PACK must be 'dp'|'bucket', got {pack}")
        lam_mb = float(os.environ.get("FC_MF_PACK_LAM_MB", "8"))
        # segmented inbox gathers (see _build_tables): 'split' sorts each
        # stage's nodes by inbox load so the gather tables shrink to the
        # real contribution count; 'full' keeps one max-kmax table/stage
        self.inbox = inbox or os.environ.get("FC_MF_INBOX", "split")
        if self.inbox not in ("split", "full"):
            raise ValueError(f"FC_MF_INBOX must be 'split'|'full', "
                             f"got {self.inbox}")
        # derived cache: the post-repack, post-sort, table-complete,
        # layout-final representation — a warm load is pure fread +
        # straight H2D, skipping ~35 s of host transforms at 235k dofs
        # (and 13% fewer bytes than the canonical payload after DP repack)
        # d2: tile-physical (8,128) DP padding granularity (inherited and
        # not yet re-priced for the GPU: ROADMAP queue 1, item 3)
        dkey = f"{key}-d2-{pack}-{lam_mb:g}-{self.inbox}-{self.layout}"
        tables = stacks = None
        ded = fc_entry_dir(dkey)
        if ded is not None:
            # STREAMING warm load: read each stage's factor stacks and
            # hand them to the device immediately, so the next fread
            # overlaps the in-flight H2D transfer — measured fread 15 s +
            # upload 20 s sequential at the 235k cavity, ~max of the two
            # interleaved. Any read error falls back to the cold path.
            try:
                tables, stacks, self.solve_err = _load_derived_streaming(
                    ded, n
                )
                self.loaded_from = "stream"
                logger.info(
                    "multifrontal: streamed derived (upload-ready) cache"
                )
            except Exception as e:
                # keep the exception visible: a format drift between
                # _encode_derived and _load_derived_streaming would
                # otherwise look like a silent permanent warm-path rebuild
                logger.warning(
                    "derived cache entry unreadable (%r), rebuilding: %s",
                    e, ded,
                )
                tables = stacks = None
        if tables is None:
            cached = fc_load(key)
            if cached is not None and int(cached["n"]) == n:
                payload = {k: v for k, v in cached.items()}
                self.loaded_from = "primary"
                logger.info("multifrontal: loaded cached factors")
            else:
                payload = self._factorize(a_csr, coords, leaf_max, np_store,
                                          trim=self.trim)
                self.loaded_from = "build"
                # background store (atomic tmp+rename publish; the
                # downstream transforms _repack_dp /
                # _sort_nodes_by_inbox_load build fresh arrays, never
                # writing the payload's) — the 2+ GB disk write (52 s at
                # the 235k cavity) overlaps repack/tables/upload
                fc_save_async(key, n=np.int64(n), **payload)
            # in-memory repack (disk format stays canonical): penalty-DP
            # grouping strictly dominates the fixed bucket grid — measured
            # on the real payloads: 235k stock cavity 71 stages/2.42 GB ->
            # 50/2.11 GB, 56k stock cylinder 46/0.54 -> 24/0.50 at the
            # default penalty. Fewer stages (less per-stage dispatch/gather
            # setup) AND fewer padded bytes. FC_MF_PACK=bucket restores v4.
            if pack == "dp":
                payload = _repack_dp(payload, n, lam_bytes=lam_mb * 2**20)
            if self.inbox == "split":
                payload = _sort_nodes_by_inbox_load(payload, n)
            self.solve_err = _measure_solve_err(a_csr, payload, n)
            logger.info("multifrontal: measured per-solve error %.2e "
                        "(store dtype %s)", self.solve_err, np_store.name)
            tables = self._build_tables(payload)
            stacks = self._layout_stacks(payload)
            # background store (atomic; _finalize_device only reads the
            # stacks) — overlaps the derived write with the H2D upload
            fc_save_async(dkey, n=np.int64(n),
                          solve_err=np.float64(self.solve_err),
                          **_encode_derived(tables, stacks))
        # zero-sweep gate: host-f64 factors rounded to f32 on the canonical
        # ordering sit in the "rounding-limited" trajectory class and need
        # no refinement; restructured trees (trimmed separators, small
        # leaves) can leave it. The class is decided by the MEASURED
        # per-solve error (see _measure_solve_err), calibrated against the
        # 5-step f32-vs-f64 trajectory gates at both stock scales.
        self.recommended_refine = (
            0 if 0 <= self.solve_err < self.ZERO_SWEEP_ERR
            or np.dtype(np_store) == np.float64
            else 1
        )
        self._finalize_device(tables, stacks)
        logger.info(
            "multifrontal: ready in %.1fs — %d depths, factor %.2f GB",
            time.time() - t_all, self.n_depths,
            sum(v.nbytes for v in jax.tree_util.tree_leaves(self._dev))
            / 2**30,
        )

    # ── host factorization ──────────────────────────────────────────────────

    @staticmethod
    def _factorize(a_csr, coords, leaf_max, np_store, trim: bool = True):
        n = a_csr.shape[0]
        t0 = time.time()
        g = ((a_csr != 0) + (a_csr != 0).T).tocsr()
        root = build_nd_tree(g, coords, np.arange(n), leaf_max=leaf_max,
                             trim_passes=4 if trim else 0)
        _merge_small_nodes(root)
        _set_depths(root)
        _annotate_boundaries(g, root)
        nodes = _postorder(root)
        logger.info(
            "multifrontal: tree %.1fs — %d nodes, max depth %d, "
            "max elim %d, max bd %d", time.time() - t0, len(nodes),
            max(v.depth for v in nodes),
            max(len(v.elim) for v in nodes),
            max(len(v.bd) for v in nodes),
        )

        t0 = time.time()
        updates: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        stats_flops = 0.0
        n_delayed = 0
        import scipy.linalg as sla

        for v in nodes:
            # DELAYED PIVOTING (the multifrontal essential for saddle-point
            # matrices): a frontal pivot block of an indefinite matrix can
            # be singular even though A is not (e.g. a pressure dof whose
            # velocity couplings all sit outside the block). Dofs whose
            # pivot falls below threshold are NOT eliminated here — they
            # join the boundary and are passed up into the parent's front,
            # exactly as MUMPS delays pivots up the assembly tree.
            delayed_in = (
                np.concatenate([c.delayed for c in v.children])
                if v.children else np.array([], dtype=np.int64)
            )
            elim = np.concatenate([v.elim, delayed_in.astype(np.int64)])
            bd_static = v.bd
            ids = np.concatenate([elim, bd_static])
            # assemble each ORIGINAL entry A[i,j] exactly once across the
            # tree: at the deeper of node(i), node(j) — i.e. here iff i or
            # j belongs to THIS node's tree-assigned elim set (pre-delay;
            # a delayed dof's original data was already assembled at its
            # own node). Everything else arrives via children updates.
            f = a_csr[ids][:, ids].toarray()
            own = np.isin(ids, v.elim)
            # ...and never for pairs involving a DELAYED dof: its original
            # row/col was assembled at its own (deeper) node
            dly = np.isin(ids, delayed_in)
            f *= (own[:, None] | own[None, :]) & ~(
                dly[:, None] | dly[None, :]
            )
            # position of any global id inside `ids` (ids is NOT sorted)
            order = np.argsort(ids, kind="stable")
            ids_sorted = ids[order]
            for c in v.children:
                bd_c, u_c = updates.pop(id(c))
                loc = order[np.searchsorted(ids_sorted, bd_c)]
                assert np.array_equal(ids[loc], bd_c)
                f[np.ix_(loc, loc)] += u_c

            # choose the eliminable subset of `elim`
            keep = np.arange(len(elim))
            scale = max(np.abs(f[: len(elim), : len(elim)]).max(), 1e-300)
            while True:
                ne = len(keep)
                if ne == 0:
                    break
                f_ii = f[np.ix_(keep, keep)]
                lu, piv = sla.lu_factor(f_ii, check_finite=False)
                du = np.abs(np.diag(lu))
                bad = np.where(du <= 1e-10 * scale)[0]
                if not len(bad):
                    break
                # drop the dependent columns (pivot order = column order
                # under partial pivoting) and retry
                keep = np.delete(keep, bad)
            if len(keep) == 0 and len(bd_static) == 0:
                raise np.linalg.LinAlgError(
                    "singular root front — matrix is singular"
                )
            delayed_mask = np.ones(len(elim), dtype=bool)
            delayed_mask[keep] = False
            v.delayed = elim[delayed_mask]
            n_delayed += len(v.delayed)
            elim_kept = elim[keep]
            bd_full = np.concatenate([v.delayed, bd_static])
            # reorder the front as [kept | delayed | static bd]
            sel = np.concatenate(
                [keep, np.where(delayed_mask)[0],
                 len(elim) + np.arange(len(bd_static))]
            )
            f = f[np.ix_(sel, sel)]
            ne = len(keep)
            inv_ii = (
                sla.lu_solve((lu, piv), np.eye(ne), check_finite=False)
                if ne else np.zeros((0, 0))
            )
            f_ib = f[:ne, ne:]
            f_bi = f[ne:, :ne]
            # the backward sweep applies inv_ii @ f_ib as ONE stored
            # operator (ginv): composed here in f64 (it is needed for the
            # Schur update anyway) and rounded once — one einsum and one
            # factor-stack read per stage instead of two (the inv stack,
            # the largest one, is then read only by the forward sweep)
            giv = inv_ii @ f_ib if ne else f_ib
            stats_flops += 2 * ne**3 / 3 + 2 * ne * ne * len(bd_full) * 2
            if len(bd_full):
                updates[id(v)] = (bd_full, f[ne:, ne:] - f_bi @ giv)
            else:
                updates[id(v)] = (bd_full, np.zeros((0, 0)))
            v.elim = elim_kept
            v.bd = bd_full
            v.inv_ii = inv_ii.astype(np_store)
            v.ginv = giv.astype(np_store)
            v.f_bi = f_bi.astype(np_store)
        if n_delayed:
            logger.info("multifrontal: %d delayed pivots", n_delayed)
        logger.info("multifrontal: numeric factorization %.1fs (%.1f Gflop)",
                    time.time() - t0, stats_flops / 1e9)

        # ── pack padded stacks: stages = (depth, size-bucket) groups ────────
        # Nodes at one tree depth vary wildly in size (a 100-dof leaf next
        # to a 2k separator): padding a whole depth to its max wastes ~8x
        # (measured 12.2 GB padded vs 1.5 GB content at the 235k cavity).
        # Bucketing by padded size keeps stages tight; execution order only
        # needs children-before-parents, i.e. deeper stages first.
        grid = [128, 256, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144,
                8192, 12288, 16384]

        def bucket(x: int) -> int:
            for gv in grid:
                if x <= gv:
                    return gv
            return x

        groups: dict[tuple, list] = {}
        for v in nodes:
            key = (v.depth, bucket(max(len(v.elim), 1)),
                   bucket(max(len(v.bd), 1)))
            groups.setdefault(key, []).append(v)
        stage_keys = sorted(groups, key=lambda k: (-k[0], k[1], k[2]))
        payload: dict[str, np.ndarray] = {}
        payload["depth_order"] = np.asarray([k[0] for k in stage_keys])
        for di, key in enumerate(stage_keys):
            group = groups[key]
            e_max = key[1]
            b_max = key[2]
            m = len(group)
            elim_idx = np.full((m, e_max), n, dtype=np.int64)
            bd_idx = np.full((m, b_max), n, dtype=np.int64)
            inv_ii = np.zeros((m, e_max, e_max), dtype=np_store)
            g_inv = np.zeros((m, e_max, b_max), dtype=np_store)
            f_bi = np.zeros((m, b_max, e_max), dtype=np_store)
            for i, v in enumerate(group):
                ne, nb = len(v.elim), len(v.bd)
                elim_idx[i, :ne] = v.elim
                bd_idx[i, :nb] = v.bd
                inv_ii[i, :ne, :ne] = v.inv_ii
                g_inv[i, :ne, :nb] = v.ginv
                f_bi[i, :nb, :ne] = v.f_bi
            payload[f"elim_{di}"] = elim_idx
            payload[f"bd_{di}"] = bd_idx
            payload[f"inv_{di}"] = inv_ii
            payload[f"ginv_{di}"] = g_inv
            payload[f"fbi_{di}"] = f_bi
        return payload

    def _unpack(self, payload, dtype):
        tables = self._build_tables(payload)
        stacks = self._layout_stacks(payload)
        self._finalize_device(tables, stacks)

    def _build_tables(self, payload):
        """Build the SCATTER-FREE device representation.

        The work vector is laid out in (stage, node, slot) order so each
        stage's eliminated block is CONTIGUOUS: stage writes are static
        slice updates and all cross-stage reads are gathers — scatters
        never appear in the solve (the first scatter-based version of this
        solve, scatter inside lax.scan, hit a 68 GB compile-time OOM at
        235k dofs).

        Forward-sweep updates flow through per-stage INBOX tables over a
        compact contribution buffer, not total-wide delta vectors: every
        stage writes its boundary updates (m·b_max values) into its slice
        of one flat buffer, and a consuming stage gathers ONLY the
        contributions addressed to its own elim slots. Gather volume is a
        large part of the solve's cost: total-wide per-stage tables cost n_stages × total × kmax gathered
        elements (~36M at the 235k cavity) while the inboxes cost
        Σ contributions (~1-2M) — measured 10-30× less gather traffic.
        """
        n = self.n
        depths = payload["depth_order"]
        self.n_depths = len(depths)

        # slot layout: stage si owns [offset_si, offset_si + m*e_max)
        offsets = []
        total = 0
        for di in range(self.n_depths):
            m, e_max = payload[f"elim_{di}"].shape
            offsets.append(total)
            total += m * e_max
        self.total_slots = total

        # global dof -> slot (each dof eliminated exactly once)
        slot_of = np.full(n + 1, total, dtype=np.int64)  # pad -> pad slot
        for di in range(self.n_depths):
            elim_idx = payload[f"elim_{di}"]  # (m, e_max), pad == n
            flat = elim_idx.reshape(-1)
            slots = offsets[di] + np.arange(flat.size)
            real = flat < n
            slot_of[flat[real]] = slots[real]
        # slot -> global dof (pad slots -> n, reading the appended zero)
        perm = np.full(total, n, dtype=np.int64)
        for di in range(self.n_depths):
            flat = payload[f"elim_{di}"].reshape(-1)
            perm[offsets[di]: offsets[di] + flat.size] = flat

        # contribution buffer layout: stage si's updates occupy
        # [c_off_si, c_off_si + m*b_max); dest slot of every contribution
        c_offsets = []
        total_contrib = 0
        dest_parts = []
        for di in range(self.n_depths):
            bd_idx = payload[f"bd_{di}"]
            bd_slots = slot_of[np.minimum(bd_idx, n)]  # (m, b_max)
            c_offsets.append(total_contrib)
            total_contrib += bd_slots.size
            dest_parts.append(bd_slots.reshape(-1))
        dest = np.concatenate(dest_parts) if dest_parts else np.zeros(0, int)
        self.total_contrib = total_contrib

        # int32 index vectors: half the index bytes of int64, and
        # total < 2^31 by construction
        assert total < 2**31 - 1
        tables = {
            "n_depths": self.n_depths,
            "total": total,
            "total_contrib": total_contrib,
            "perm": perm.astype(np.int32),
            "ipos": slot_of[:n].astype(np.int32),
            "stages": [],   # per-stage dicts of host int32 index arrays
            "static": [],   # per-stage static tuples
        }
        table_bytes = 0
        for di in range(self.n_depths):
            elim_idx = payload[f"elim_{di}"]
            bd_idx = payload[f"bd_{di}"]
            bd_slots = slot_of[np.minimum(bd_idx, n)]  # (m, b_max)
            # INBOX: contribution positions addressed to this stage's slot
            # range, localized. Pad value is total_contrib (the appended
            # zero of the buffer). Contributions to this stage only come
            # from deeper (already-executed) stages, so the buffer holds
            # them all by the time this stage gathers. Stored TRANSPOSED
            # (kmax, width): a tiled layout pads the minor-most dim, so a
            # (width, kmax~small) layout would balloon.
            #
            # SEGMENTED (self.inbox == 'split'): nodes arrive sorted by
            # descending inbox load (_sort_nodes_by_inbox_load), so the
            # single max-kmax table splits into a few per-load-bucket
            # tables and the untargeted tail (every leaf stage) gathers
            # NOTHING — gather volume drops from width x kmax to ~the
            # real contribution count (measured 0.15M -> ~0.05M indices
            # at stock 56k, and the widest stages are the all-leaf ones).
            width = elim_idx.size
            off = offsets[di]
            e_max_d = elim_idx.shape[1]
            m_d = elim_idx.shape[0]
            dloc = dest - off
            dloc = np.where((dest >= off) & (dloc < width), dloc, width)
            cnt = np.bincount(dloc[dloc < width], minlength=width)
            node_load = cnt.reshape(m_d, e_max_d).max(axis=1)
            if self.inbox == "split":
                segs = _inbox_segments(node_load)
            else:
                segs = [(0, m_d, max(int(node_load.max(initial=0)), 1))]
            inbox_ts = []
            seg_static = []
            for (m0, m1, kcap) in segs:
                ln = (m1 - m0) * e_max_d
                if kcap == 0 or ln == 0:
                    seg_static.append((m0, m1, False))
                    continue
                lo = m0 * e_max_d
                dseg = dloc - lo
                dseg = np.where((dloc >= lo) & (dseg < ln), dseg, ln)
                tab = _table_skip_pads(dseg, ln)
                # zero-sentinel-at-0 convention: the sweep gathers from a
                # GROWING buffer [zero | contributions written so far], so
                # real positions shift +1 and pads point at the leading
                # zero. Contributions addressed to this stage come only
                # from deeper (earlier) stages, i.e. positions < c_off.
                tab = np.where(tab >= len(dseg), 0, tab + 1)
                assert tab.max(initial=0) <= c_offsets[di]
                table_bytes += tab.nbytes // 2  # int32 on device
                inbox_ts.append(
                    np.ascontiguousarray(tab.T.astype(np.int32))
                )
                seg_static.append((m0, m1, True))
            # backward-sweep boundary gather, suffix-relative: at stage si
            # the finalized solution covers slots [offsets[si+1], total) and
            # the sweep keeps it as [zero | that suffix]; bd slots (always
            # strict-ancestor slots, hence >= offsets[si+1]) shift
            # accordingly, pads point at the leading zero
            sfx_base = off + elim_idx.size
            real_bd = bd_slots < total
            assert (bd_slots[real_bd] >= sfx_base).all()
            bd_s = np.where(real_bd, bd_slots - sfx_base + 1, 0)
            tables["stages"].append({
                "bd": bd_slots.astype(np.int32),
                "bd_s": bd_s.astype(np.int32),
                "inbox_ts": tuple(inbox_ts),
            })
            tables["static"].append(
                (elim_idx.shape[1], bd_idx.shape[1], elim_idx.shape[0],
                 offsets[di], c_offsets[di], tuple(seg_static))
            )
        logger.info(
            "multifrontal: %d contributions, inbox tables %.1f MB",
            total_contrib, table_bytes / 2**20,
        )
        return tables

    def _layout_stacks(self, payload):
        """Per-stage factor stacks in their FINAL host layout (the 'ji'
        pre-transpose applied), ready for a straight H2D upload."""
        out = []
        for di in range(len(payload["depth_order"])):
            inv = payload[f"inv_{di}"]
            ginv = payload[f"ginv_{di}"]
            fbi = payload[f"fbi_{di}"]
            if self.layout == "ji":
                inv = np.ascontiguousarray(inv.swapaxes(1, 2))
                ginv = np.ascontiguousarray(ginv.swapaxes(1, 2))
                fbi = np.ascontiguousarray(fbi.swapaxes(1, 2))
            out.append((inv, ginv, fbi))
        return out

    def _finalize_device(self, tables, stacks):
        """Upload tables + stacks; set the device tree and static specs."""
        self.n_depths = int(tables["n_depths"])
        self.total_slots = int(tables["total"])
        self.total_contrib = int(tables["total_contrib"])
        perm_h = np.asarray(tables["perm"])
        ipos_h = np.asarray(tables["ipos"])
        dev = {
            "perm": jnp.asarray(perm_h),
            "ipos": jnp.asarray(ipos_h),
            # host mirrors: build-time consumers (the stepper's hot-order
            # composition) read these instead of pulling the device copy
            # back — a d2h on "perm" blocks on the whole async factor
            # upload queue. The stepper strips them before dev enters any
            # jit argument.
            "perm_host": perm_h,
            "ipos_host": ipos_h,
            "stages": [],
        }
        # 'ji' stacks carry distinct names so a consumer built for the
        # canonical layout (e.g. the sharded solve) fails loudly instead
        # of multiplying by the transpose
        sfx = "_t" if self.layout == "ji" else ""
        for st_h, (inv, ginv, fbi) in zip(tables["stages"], stacks):
            dev["stages"].append({
                "bd": jnp.asarray(st_h["bd"]),
                "bd_s": jnp.asarray(st_h["bd_s"]),
                "inbox_ts": tuple(jnp.asarray(t) for t in st_h["inbox_ts"]),
                f"inv{sfx}": jnp.asarray(inv),
                f"ginv{sfx}": jnp.asarray(ginv),
                f"fbi{sfx}": jnp.asarray(fbi),
            })
        self._stage_static = [
            (int(e), int(b), int(m), int(off), int(coff),
             tuple((int(m0), int(m1), bool(f)) for (m0, m1, f) in segs))
            for (e, b, m, off, coff, segs) in tables["static"]
        ]
        self._dev = dev

    # ── public API ──────────────────────────────────────────────────────────

    def tree(self):
        return self._dev

    def static(self):
        return dict(n=self.n, total=self.total_slots,
                    total_contrib=self.total_contrib,
                    stages=tuple(self._stage_static), layout=self.layout)

    def solve(self, b):
        # drop the build-time host mirrors: numpy leaves in a jit argument
        # would re-upload on every call
        dev = {k: v for k, v in self._dev.items() if not k.endswith("_host")}
        return multifrontal_solve(dev, b, **self.static())


def _encode_derived(tables: dict, stacks: list) -> dict:
    """Flatten (tables, stacks) into named numpy arrays for the factor
    cache. Static/shape metadata rides as a JSON uint8 sidecar array."""
    import json

    meta = {
        "n_depths": int(tables["n_depths"]),
        "total": int(tables["total"]),
        "total_contrib": int(tables["total_contrib"]),
        "static": [
            [int(e), int(b), int(m), int(off), int(coff),
             [[int(m0), int(m1), bool(f)] for (m0, m1, f) in segs]]
            for (e, b, m, off, coff, segs) in tables["static"]
        ],
        "n_ibt": [len(st["inbox_ts"]) for st in tables["stages"]],
    }
    out = {
        "perm": np.asarray(tables["perm"]),
        "ipos": np.asarray(tables["ipos"]),
        "meta_json": np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        ).copy(),
    }
    for di, (st, (inv, ginv, fbi)) in enumerate(
        zip(tables["stages"], stacks)
    ):
        out[f"bds_{di}"] = np.asarray(st["bd"])
        out[f"bdss_{di}"] = np.asarray(st["bd_s"])
        for si, t in enumerate(st["inbox_ts"]):
            out[f"ibt_{di}_{si}"] = np.asarray(t)
        out[f"inv_{di}"] = inv
        out[f"ginv_{di}"] = ginv
        out[f"fbi_{di}"] = fbi
    return out


def _load_derived_streaming(p, n: int) -> tuple[dict, list, float]:
    """Warm-path loader over a raw-.npy cache dir: loads the small tables,
    then each stage's factor stacks — handing every stack to the device
    (jnp.asarray, async enqueue) as soon as it is read, so the following
    fread overlaps the in-flight H2D transfer. Returns stacks of DEVICE
    arrays; _finalize_device's jnp.asarray is then a no-op."""
    import json

    meta = json.loads(
        bytes(np.load(p / "meta_json.npy", allow_pickle=False)).decode()
    )
    if int(np.load(p / "n.npy", allow_pickle=False)) != n:
        raise ValueError("derived cache entry is for a different n")
    se = p / "solve_err.npy"
    solve_err = (
        float(np.load(se, allow_pickle=False)) if se.exists() else -1.0
    )

    def _ld(name):
        return np.load(p / f"{name}.npy", allow_pickle=False)

    tables = {
        "n_depths": meta["n_depths"],
        "total": meta["total"],
        "total_contrib": meta["total_contrib"],
        "perm": _ld("perm"),
        "ipos": _ld("ipos"),
        "stages": [],
        "static": [
            (e, b, m, off, coff,
             tuple((m0, m1, bool(f)) for (m0, m1, f) in segs))
            for (e, b, m, off, coff, segs) in meta["static"]
        ],
    }
    stacks = []
    for di in range(meta["n_depths"]):
        tables["stages"].append({
            "bd": _ld(f"bds_{di}"),
            "bd_s": _ld(f"bdss_{di}"),
            "inbox_ts": tuple(
                _ld(f"ibt_{di}_{si}") for si in range(meta["n_ibt"][di])
            ),
        })
        stacks.append(tuple(
            jnp.asarray(_ld(f"{nm}_{di}")) for nm in ("inv", "ginv", "fbi")
        ))
    return tables, stacks, solve_err


def _decode_derived(d: dict) -> tuple[dict, list]:
    import json

    meta = json.loads(bytes(np.asarray(d["meta_json"])).decode())
    tables = {
        "n_depths": meta["n_depths"],
        "total": meta["total"],
        "total_contrib": meta["total_contrib"],
        "perm": d["perm"],
        "ipos": d["ipos"],
        "stages": [],
        "static": [
            (e, b, m, off, coff,
             tuple((m0, m1, bool(f)) for (m0, m1, f) in segs))
            for (e, b, m, off, coff, segs) in meta["static"]
        ],
    }
    stacks = []
    for di in range(meta["n_depths"]):
        tables["stages"].append({
            "bd": d[f"bds_{di}"],
            "bd_s": d[f"bdss_{di}"],
            "inbox_ts": tuple(
                d[f"ibt_{di}_{si}"] for si in range(meta["n_ibt"][di])
            ),
        })
        stacks.append((d[f"inv_{di}"], d[f"ginv_{di}"], d[f"fbi_{di}"]))
    return tables, stacks


def _round128(x: int) -> int:
    return max(128, -(-int(x) // 128) * 128)


def _round8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


def _stage_phys_elems(m: int, e: int, b: int) -> int:
    """Physical elements of one stage's three f32 factor stacks under an
    (8, 128) tile layout: only the MINOR dim pads to 128; the second-minor
    pads to 8. inv (m,e,e) -> e8*e128; ginv (m,e,b) -> e8*b128; fbi
    (m,b,e) -> b8*e128. The DP groups and pads at this granularity, which
    is inherited from the previous accelerator's tiles and not yet
    re-priced for the GPU (ROADMAP queue 1, item 3)."""
    e8, b8 = _round8(e), _round8(b)
    e128, b128 = _round128(e), _round128(b)
    return m * (e8 * e128 + e8 * b128 + b8 * e128)


def _measure_solve_err(a_csr, payload: dict, n: int, n_rhs: int = 4) -> float:
    """True-error probe of the rounded (store-dtype) factors, on host.

    Runs the same forward/backward sweeps as the device solve in numpy
    over the canonical payload for synthetic RHS b = A x_true and returns
    the median relative error ||x - x_true|| / ||x_true||. The RESIDUAL
    cannot rank factor orderings (measured at the 235k stock cavity:
    trimmed and canonical trees both show 8.2e-5 raw residual, yet
    1.32e-3 vs 1.7e-4 five-step f32 trajectory error) — the error's
    direction matters, so the zero-sweep refinement recommendation is
    gated on measured per-solve ERROR, not residual (see
    MultifrontalLU.recommended_refine).
    """
    rng = np.random.default_rng(12345)
    xt = rng.standard_normal((n, n_rhs))
    xt /= np.linalg.norm(xt, axis=0, keepdims=True)
    b = a_csr @ xt  # (n, n_rhs) f64
    n_stages = len(payload["depth_order"])
    dt32 = payload["inv_0"].dtype
    bp = np.concatenate([b.astype(dt32), np.zeros((1, n_rhs), dt32)])
    acc = np.zeros((n + 1, n_rhs), dtype=dt32)
    zs = []
    for di in range(n_stages):
        elim = np.minimum(payload[f"elim_{di}"], n)  # (m, e_max) pad -> n
        bd = np.minimum(payload[f"bd_{di}"], n)
        xe = bp[elim] - acc[elim]  # (m, e_max, n_rhs)
        z = np.einsum("mij,mjr->mir", payload[f"inv_{di}"], xe)
        upd = np.einsum("mbi,mir->mbr", payload[f"fbi_{di}"], z)
        np.add.at(acc, bd.reshape(-1), upd.reshape(-1, n_rhs))
        zs.append(z)
    xs = np.zeros((n + 1, n_rhs), dtype=dt32)
    for di in reversed(range(n_stages)):
        elim = np.minimum(payload[f"elim_{di}"], n)
        bd = np.minimum(payload[f"bd_{di}"], n)
        corr = np.einsum("mib,mbr->mir", payload[f"ginv_{di}"], xs[bd])
        xs[elim.reshape(-1)] = (zs[di] - corr).reshape(-1, n_rhs)
    err = np.linalg.norm(xs[:n] - xt, axis=0)
    return float(np.median(err))


def _repack_dp(payload: dict, n: int, lam_bytes: float) -> dict:
    """Regroup the per-depth node forests by a penalty-DP partition.

    The v4 packing groups nodes by (depth, fixed-size-bucket) — simple,
    but it fragments a depth into up to ~8 stages AND over-pads (the
    bucket grid jumps 1024->1536->2048). Here nodes of one depth are
    lex-sorted by (n_elim, n_bd) and split into contiguous groups by a
    DP minimizing  padded_bytes + lam_bytes * n_groups ,  with group
    padding at 128 granularity (keeps every stage 128-aligned).
    lam_bytes prices one stage's fixed overhead in memory-read-equivalent
    bytes (8 MB; not yet re-priced for the GPU). Same-depth nodes are never
    ancestor-related, so any regrouping within a depth is execution-safe.

    Pure host-side transform of the payload dict (the disk cache stays in
    the canonical format); the solve code is unchanged.
    """
    depths = payload["depth_order"]
    itemsize = payload["inv_0"].itemsize if "inv_0" in payload else 4
    lam = lam_bytes / itemsize  # penalty in elements
    # decompose stages into nodes
    per_depth: dict[int, list] = {}
    for di in range(len(depths)):
        e = payload[f"elim_{di}"]
        b = payload[f"bd_{di}"]
        inv = payload[f"inv_{di}"]
        giv = payload[f"ginv_{di}"]
        fbi = payload[f"fbi_{di}"]
        for i in range(e.shape[0]):
            ne = int((e[i] < n).sum())
            nb = int((b[i] < n).sum())
            per_depth.setdefault(int(depths[di]), []).append((
                ne, nb, e[i, :ne], b[i, :nb],
                inv[i, :ne, :ne], giv[i, :ne, :nb], fbi[i, :nb, :ne],
            ))

    groups: list[tuple[int, list]] = []  # (depth, [node, ...])
    for dv, nodes in per_depth.items():
        nodes.sort(key=lambda t: (t[0], t[1]))
        m = len(nodes)
        ne = [t[0] for t in nodes]
        nb = [t[1] for t in nodes]
        best = [np.inf] * (m + 1)
        prev = [0] * (m + 1)
        best[0] = 0.0
        for j in range(1, m + 1):
            mb = 0
            for i in range(j - 1, -1, -1):
                mb = max(mb, nb[i])
                # sorted: max elim in i..j-1 is ne[j-1]; cost = physical
                # tile-padded bytes of the group's three stacks
                c = _stage_phys_elems(j - i, ne[j - 1], mb) + lam
                if best[i] + c < best[j]:
                    best[j] = best[i] + c
                    prev[j] = i
        cuts = []
        j = m
        while j > 0:
            cuts.append((prev[j], j))
            j = prev[j]
        for i, j in reversed(cuts):
            groups.append((dv, nodes[i:j]))

    # rebuild the canonical payload: stages ordered deep -> root
    groups.sort(key=lambda g: (-g[0], max(t[0] for t in g[1])))
    out: dict[str, np.ndarray] = {
        "depth_order": np.asarray([g[0] for g in groups])
    }
    dt = payload["inv_0"].dtype
    for di, (dv, nodes) in enumerate(groups):
        m = len(nodes)
        # logical stack dims pad only to the 8-granular second-minor tile
        # boundary; the minor dim's 128-padding happens physically in HBM
        # either way, so an explicit 128 here would only add bytes on the
        # second-minor axis (see _stage_phys_elems)
        e_max = _round8(max(t[0] for t in nodes))
        b_max = _round8(max(t[1] for t in nodes))
        elim_idx = np.full((m, e_max), n, dtype=np.int64)
        bd_idx = np.full((m, b_max), n, dtype=np.int64)
        inv = np.zeros((m, e_max, e_max), dtype=dt)
        giv = np.zeros((m, e_max, b_max), dtype=dt)
        fbi = np.zeros((m, b_max, e_max), dtype=dt)
        for i, (ne, nb, ei, bi, iv, gv, fb) in enumerate(nodes):
            elim_idx[i, :ne] = ei
            bd_idx[i, :nb] = bi
            inv[i, :ne, :ne] = iv
            giv[i, :ne, :nb] = gv
            fbi[i, :nb, :ne] = fb
        out[f"elim_{di}"] = elim_idx
        out[f"bd_{di}"] = bd_idx
        out[f"inv_{di}"] = inv
        out[f"ginv_{di}"] = giv
        out[f"fbi_{di}"] = fbi
    phys = sum(
        _stage_phys_elems(
            out[f"inv_{d}"].shape[0], out[f"inv_{d}"].shape[1],
            out[f"ginv_{d}"].shape[2],
        ) * itemsize
        for d in range(len(groups))
    )
    logger.info(
        "multifrontal: dp repack %d -> %d stages, %.2f -> %.2f GB padded "
        "(%.2f GB physical w/ HBM tile pad)",
        len(depths), len(groups),
        sum(payload[f"inv_{d}"].nbytes + payload[f"ginv_{d}"].nbytes
            + payload[f"fbi_{d}"].nbytes for d in range(len(depths)))
        / 2**30,
        sum(out[f"inv_{d}"].nbytes + out[f"ginv_{d}"].nbytes
            + out[f"fbi_{d}"].nbytes for d in range(len(groups))) / 2**30,
        phys / 2**30,
    )
    return out


def _sort_nodes_by_inbox_load(payload: dict, n: int) -> dict:
    """Sort every stage's nodes by DESCENDING inbox load (incoming
    forward-sweep contributions to the node's eliminated dofs) so the
    per-stage inbox gather can be SEGMENTED (see _unpack): a handful of
    heavily-targeted separator nodes get a fat-kmax table, the long tail
    gets skinny ones, and untargeted nodes (every leaf stage) get NO
    gather at all. The node order within a stage is arbitrary by
    construction, so this is a pure in-memory permutation of the stage
    stacks — the disk cache format is untouched."""
    n_stages = len(payload["depth_order"])
    counts = np.zeros(n + 1, dtype=np.int64)
    for di in range(n_stages):
        bd = payload[f"bd_{di}"].reshape(-1)
        real = bd[bd < n]
        if len(real):
            counts[:n] += np.bincount(real, minlength=n)
    out = dict(payload)
    for di in range(n_stages):
        elim = payload[f"elim_{di}"]
        load = counts[np.minimum(elim, n)].max(axis=1)
        order = np.argsort(-load, kind="stable")
        if np.array_equal(order, np.arange(len(order))):
            continue
        for nm in ("elim", "bd", "inv", "ginv", "fbi"):
            out[f"{nm}_{di}"] = np.ascontiguousarray(
                payload[f"{nm}_{di}"][order]
            )
    return out


def _inbox_segments(node_load: np.ndarray, max_segs: int = 4):
    """Segment a DESC-sorted node-load vector into ≤ max_segs groups of
    similar kmax (power-of-two buckets, adjacent-merge down to the cap).
    Returns [(m0, m1, kcap)] with kcap == 0 for the untargeted tail."""
    m = len(node_load)
    if m == 0:
        return [(0, 0, 0)]
    bucket = np.where(
        node_load <= 0, 0,
        2 ** np.ceil(np.log2(np.maximum(node_load, 1))).astype(np.int64),
    )
    # boundaries where the bucket value changes (desc-sorted ⇒ monotone)
    cuts = [0] + list(np.flatnonzero(np.diff(bucket)) + 1) + [m]
    segs = [(cuts[i], cuts[i + 1], int(bucket[cuts[i]]))
            for i in range(len(cuts) - 1)]
    # merge smallest-cost boundaries until within the cap (keep the
    # zero-load tail separate — merging it would re-pad it with gathers)
    while len(segs) > max_segs:
        best, cost = None, None
        for i in range(len(segs) - 1):
            (a0, a1, ka), (b0, b1, kb) = segs[i], segs[i + 1]
            if kb == 0:
                continue
            c = (b1 - b0) * (ka - kb)  # extra padded gathers if merged
            if cost is None or c < cost:
                best, cost = i, c
        if best is None:
            break
        (a0, _, ka), (_, b1, _) = segs[best], segs[best + 1]
        segs[best: best + 2] = [(a0, b1, ka)]
    return segs


def _table_skip_pads(dest: np.ndarray, n_out: int) -> np.ndarray:
    """Transposed-scatter gather table over destinations ``dest`` (pad
    entries == n_out are excluded; they point at the appended-zero slot).
    Returns (n_out + 1, kmax) with source positions, pad = len(dest)."""
    real = np.where(dest < n_out)[0]
    d = dest[real]
    order = np.argsort(d, kind="stable")
    d_sorted = d[order]
    pos = real[order]
    counts = np.bincount(d_sorted, minlength=n_out)
    kmax = max(int(counts.max(initial=0)), 1)
    table = np.full((n_out + 1, kmax), len(dest), dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(len(d_sorted)) - starts[d_sorted]
    table[d_sorted, within] = pos
    return table


def _gather_sum_t(contrib, table_t):
    """Sum contributions per output slot; ``table_t (kmax, n_out)`` holds
    contribution indices (pad -> len(contrib), reading an appended zero).
    Transposed layout keeps the 128-lane minor dim on n_out, not kmax."""
    padded = jnp.concatenate(
        [contrib, jnp.zeros(contrib.shape[:-1] + (1,), dtype=contrib.dtype)],
        axis=-1,
    )
    return jnp.take(padded, table_t, axis=-1).sum(axis=-2)


def _gather_sum0(vals0, table_t):
    """Like _gather_sum_t, but for the zero-sentinel-AT-0 convention:
    ``vals0`` already carries a leading zero slot and ``table_t`` values
    are pre-shifted (+1; pad -> 0). No per-call concatenate: the sweep
    grows ``vals0`` incrementally, so the sentinel is placed once."""
    return jnp.take(vals0, table_t, axis=-1).sum(axis=-2)


@partial(jax.jit, static_argnames=("n", "total", "total_contrib", "stages",
                                   "layout"))
def multifrontal_solve(dev, b, n: int, total: int, total_contrib: int,
                       stages, layout: str = "ij"):
    """x = A^-1 b; b may carry leading batch dims.

    Work vector in slot order (see _unpack). Forward sweep (leaves->root):
    xe_v = b[elim_v] − (inbox gather of deeper stages' boundary updates);
    z_v = inv_ii xe_v; the stage's own updates F_bi z_v are APPENDED to a
    growing contribution buffer. Backward (root->leaves):
    x[elim_v] = z_v - inv_ii (F_ib x[bd_v]), with bd gathered from the
    growing suffix of finalized blocks.

    Two dataflows, picked by batch width:

    - CONCAT (single-stream / narrow panels): the first version kept one
      flat work vector and dynamic_update_slice'd every stage's block
      into it — at the 235k stock cavity that slice machinery alone (no
      einsums, no gathers) was a large share of the solve in relayout
      copies. Here every stage reads
      static slices of the CONSTANT slot-ordered input and appends its
      results; the only O(total)-per-stage work left is one memcpy-class
      concatenate. Gather sentinels sit at position 0 (tables pre-shifted
      in _unpack) so growing buffers never invalidate an index.
    - THREADED (wide batches): the concat growth re-copies the buffer
      prefix every stage, which scales with batch width (~25x
      total_contrib bytes x B per solve — real money at B=512); wide
      batches keep the preallocated work vector + update-slices, whose
      fixed relayout cost is amortized over the batch.
    """
    batch = b.shape[:-1]
    wide = int(np.prod(batch)) > 8 if batch else False
    ji = layout == "ji"
    inv_k, ginv_k, fbi_k = (
        ("inv_t", "ginv_t", "fbi_t") if ji else ("inv", "ginv", "fbi")
    )
    dtype = dev["stages"][0][inv_k].dtype
    out_dtype = b.dtype if b.dtype in (jnp.float32, jnp.float64) else dtype

    zero1 = jnp.zeros(batch + (1,), dtype=dtype)
    bext = jnp.concatenate([jnp.asarray(b).astype(dtype), zero1], axis=-1)
    # slot-ordered input (CONSTANT through the sweep: stages read static
    # slices of it, results accumulate in zparts — never written back)
    x0 = bext[..., dev["perm"]]

    n_stages = len(stages)
    if wide:
        return _solve_threaded(
            dev, x0, batch, zero1, total, total_contrib, stages,
            ji, inv_k, ginv_k, fbi_k, dtype, out_dtype,
        )
    # growing contribution buffer [zero | stage-0 updates | stage-1 ... ]
    bufcat = zero1
    zparts = []
    # forward: deepest stages first (stage list is ordered deep -> root)
    for si in range(n_stages):
        st = dev["stages"][si]
        e_max, b_max, m, off, c_off, segs = stages[si]
        xe = jax.lax.slice_in_dim(x0, off, off + m * e_max, axis=-1)
        # segmented inbox reduction: gather only the targeted node
        # segments; untargeted segments (all of every leaf stage)
        # subtract nothing
        ti = 0
        pieces = []
        for (m0, m1, tabbed) in segs:
            seg = jax.lax.slice_in_dim(
                xe, m0 * e_max, m1 * e_max, axis=-1
            )
            if tabbed:
                ln = (m1 - m0) * e_max
                inc = _gather_sum0(bufcat, st["inbox_ts"][ti])[..., :ln]
                ti += 1
                seg = seg - inc
            pieces.append(seg)
        xe = (pieces[0] if len(pieces) == 1
              else jnp.concatenate(pieces, axis=-1))
        xe = xe.reshape(batch + (m, e_max))
        if ji:
            z = jnp.einsum("mji,...mj->...mi", st[inv_k], xe, precision=_PREC)
            upd = jnp.einsum("mib,...mi->...mb", st[fbi_k], z, precision=_PREC)
        else:
            z = jnp.einsum("mij,...mj->...mi", st[inv_k], xe, precision=_PREC)
            upd = jnp.einsum("mbi,...mi->...mb", st[fbi_k], z, precision=_PREC)
        if si < n_stages - 1:  # the root's updates have no consumer
            bufcat = jnp.concatenate(
                [bufcat, upd.reshape(batch + (m * b_max,))], axis=-1
            )
        zparts.append(z)

    # backward: root first. sfx = [zero | finalized slots off_{si+1}..total)
    sfx = zero1
    xparts_rev = []
    for si in reversed(range(n_stages)):
        st = dev["stages"][si]
        e_max, b_max, m, off, c_off, _segs = stages[si]
        xb = jnp.take(sfx, st["bd_s"], axis=-1)  # ancestor slots are final
        if ji:
            corr = jnp.einsum("mbi,...mb->...mi", st[ginv_k], xb, precision=_PREC)
        else:
            corr = jnp.einsum("mib,...mb->...mi", st[ginv_k], xb, precision=_PREC)
        blk = (zparts[si] - corr).reshape(batch + (m * e_max,))
        xparts_rev.append(blk)
        if si > 0:
            sfx = jnp.concatenate([zero1, blk, sfx[..., 1:]], axis=-1)

    # every dof is eliminated exactly once, so ipos has no pad entries
    x = jnp.concatenate(list(reversed(xparts_rev)), axis=-1)
    return x[..., dev["ipos"]].astype(out_dtype)


def _solve_threaded(dev, x0, batch, zero1, total, total_contrib, stages,
                    ji, inv_k, ginv_k, fbi_k, dtype, out_dtype):
    """Wide-batch sweep: preallocated work vector + update-slices (see
    multifrontal_solve docstring). Same tables (zero-sentinel-at-0), so
    inbox gathers read [zero | buf] and bd gathers use the absolute-slot
    ``bd`` key with its end-of-x pad slot."""
    # work vector + trailing pad slot (bd pads point at it)
    x = jnp.concatenate([x0, zero1], axis=-1)
    buf = jnp.zeros(batch + (total_contrib,), dtype=dtype)

    n_stages = len(stages)
    for si in range(n_stages):
        st = dev["stages"][si]
        e_max, b_max, m, off, c_off, segs = stages[si]
        xe = jax.lax.dynamic_slice_in_dim(x, off, m * e_max, axis=-1)
        ti = 0
        buf0 = jnp.concatenate([zero1, buf], axis=-1)
        for (m0, m1, tabbed) in segs:
            if not tabbed:
                continue
            ln = (m1 - m0) * e_max
            inc = _gather_sum0(buf0, st["inbox_ts"][ti])[..., :ln]
            ti += 1
            lo = m0 * e_max
            xe = jax.lax.dynamic_update_slice_in_dim(
                xe,
                jax.lax.dynamic_slice_in_dim(xe, lo, ln, axis=-1) - inc,
                lo, axis=-1,
            )
        xe = xe.reshape(batch + (m, e_max))
        if ji:
            z = jnp.einsum("mji,...mj->...mi", st[inv_k], xe, precision=_PREC)
            upd = jnp.einsum("mib,...mi->...mb", st[fbi_k], z, precision=_PREC)
        else:
            z = jnp.einsum("mij,...mj->...mi", st[inv_k], xe, precision=_PREC)
            upd = jnp.einsum("mbi,...mi->...mb", st[fbi_k], z, precision=_PREC)
        buf = jax.lax.dynamic_update_slice_in_dim(
            buf, upd.reshape(batch + (m * b_max,)), c_off, axis=-1
        )
        x = jax.lax.dynamic_update_slice_in_dim(
            x, z.reshape(batch + (m * e_max,)), off, axis=-1
        )

    for si in reversed(range(n_stages)):
        st = dev["stages"][si]
        e_max, b_max, m, off, c_off, _segs = stages[si]
        xb = x[..., st["bd"]]  # gather: ancestor slots are final
        if ji:
            corr = jnp.einsum("mbi,...mb->...mi", st[ginv_k], xb, precision=_PREC)
        else:
            corr = jnp.einsum("mib,...mb->...mi", st[ginv_k], xb, precision=_PREC)
        z = jax.lax.dynamic_slice_in_dim(
            x, off, m * e_max, axis=-1
        ).reshape(batch + (m, e_max))
        x = jax.lax.dynamic_update_slice_in_dim(
            x, (z - corr).reshape(batch + (m * e_max,)), off, axis=-1
        )

    return x[..., dev["ipos"]].astype(out_dtype)

"""Window-blocked cell kernels: the nonlinear convection term with no
global gathers.

The hot step's one remaining u-dependent element pass is N(u) = ∫((u·∇)u)·v:
gather u at each cell's 6 velocity nodes, per-cell quadrature einsums,
scatter-add 12 values per cell (fem/assembly.nonlinear_convection_gather —
the reference's per-step RHS reassembly, ref: src/flowcontrol/
flowsolver.py:739-771). The global gather + gather-table scatter move
far more bytes than the quadrature needs flops.

Velocity nodes are first RCM-reordered on their cell-sharing graph (the
generated meshes are natively coherent, but the reference's stock O1 mesh
is NOT — its raw window width spans the whole node range); cells sorted by
their smallest (permuted) node and blocked 128 at a time then read a short
static node window. The apply becomes

    pad -> per-block static window rows (128-node granularity) ->
    in-window pick -> per-cell quadrature -> in-window scatter ->
    per-block window rows scatter-add (128-node granularity)

with two in-window pick/scatter variants:

- ``onehot``: build the (768, W) one-hot mask on the fly from an
  iota==index compare and contract with a matmul — zero data-dependent
  addressing anywhere.
- ``take``: jnp.take_along_axis / at[].add inside the (W, 2) window —
  dynamic addressing over a small operand.

Builds whose window width exceeds ``max_width`` return None so callers
fall back to the gather-table path.
"""
from __future__ import annotations

import logging

import numpy as np

import jax.numpy as jnp
from jax import lax

logger = logging.getLogger(__name__)

_RC = 128  # cell-block height
_RN = 128  # node-window row granularity

# All einsums in the windowed pass run at HIGHEST precision. The one-hot
# contractions are exact selections and sums only in full f32: on the H100
# an f32 dot at DEFAULT or HIGH may run in TF32 (10 mantissa bits), which
# turns each pick into a ~3-digit rounding of the value it selects. The
# quadrature einsums touch the same values and get the same pin.
_PREC = lax.Precision.HIGHEST


def node_rcm(cell_vel_nodes: np.ndarray, n_vnodes: int) -> np.ndarray:
    """RCM over the node cell-sharing graph: nodes of one cell land within
    O(bandwidth) of each other regardless of the mesh file's numbering.
    Returns the permutation (new position -> old node id). Also the basis
    of the stepper's hot dof order (core/stepper.py)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    cvn_raw = np.asarray(cell_vel_nodes)
    n_loc = cvn_raw.shape[1]
    rows = np.repeat(cvn_raw, n_loc, axis=1).reshape(-1)
    cols = np.tile(cvn_raw, (1, n_loc)).reshape(-1)
    adj = sp.coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)),
        shape=(n_vnodes, n_vnodes),
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))


def build_cell_windows(cell_vel_nodes: np.ndarray, n_vnodes: int,
                       geom_tables: dict, dtype=np.float32,
                       max_width: int = 8192, node_order=None,
                       split_layout: bool = False,
                       onehot_budget_mb: float | None = None):
    """Host-side build: (nc, 6) node ids -> window-blocked static meta.

    ``geom_tables``: the per-cell quadrature arrays (wq (nc, q),
    dphi2 (nc, q, 6, 2)) plus the shared phi2 (q, 6); they are re-ordered
    to the window cell order here (padded cells get wq=0, so their
    contributions vanish identically — no masking needed downstream).

    ``node_order`` (optional): a precomputed node permutation (new
    position -> old node) to use instead of the internal RCM.
    ``split_layout=True`` = the caller's dof vector is in the stepper's
    hot order ([all u-dofs, all v-dofs] in ``node_order``, pressure after
    2*n_vnodes): the apply then reads/writes u_nodes by reshape/transpose
    with ZERO element permutes (each 1-D permute is a full gather pass).
    """
    cvn_raw = np.asarray(cell_vel_nodes)
    nc, n_loc = cvn_raw.shape
    perm = (
        np.asarray(node_order) if node_order is not None
        else node_rcm(cvn_raw, n_vnodes)
    )
    inew = np.empty(n_vnodes, dtype=np.int64)
    inew[perm] = np.arange(n_vnodes)
    cvn = inew[cvn_raw]  # cell nodes in RCM numbering
    order = np.argsort(cvn.min(axis=1), kind="stable")
    cvn_o = cvn[order]
    nb = (nc + _RC - 1) // _RC
    nc_pad = nb * _RC
    # pad with copies of the last cell's nodes; padded wq rows are zero
    pad = np.broadcast_to(cvn_o[-1:], (nc_pad - nc, n_loc))
    cvn_p = np.concatenate([cvn_o, pad], axis=0).reshape(nb, _RC, n_loc)
    lo = cvn_p.reshape(nb, -1).min(axis=1)
    hi = cvn_p.reshape(nb, -1).max(axis=1)
    lo_a = (lo // _RN) * _RN
    w_max = int((hi - lo_a + 1).max()) if nb else 1
    w = ((w_max + _RN - 1) // _RN) * _RN
    if w > max_width:
        logger.info(
            "cell-window build skipped: width %d > cap %d (n_vnodes=%d)",
            w, max_width, n_vnodes,
        )
        return None
    rel = cvn_p - lo_a[:, None, None]  # (nb, RC, n_loc), all in [0, w)
    wb = w // _RN
    win = (lo_a // _RN)[:, None] + np.arange(wb)[None, :]  # (nb, wb)
    n_rows = (n_vnodes + _RN - 1) // _RN + wb  # padded row count
    logger.info(
        "cell windows: nc=%d blocks=%d width=%d (rows %d)", nc, nb, w, n_rows
    )
    wq = np.asarray(geom_tables["wq"])[order]
    dphi2 = np.asarray(geom_tables["dphi2"])[order]
    nq = wq.shape[1]
    wq_p = np.concatenate([wq, np.zeros((nc_pad - nc, nq), wq.dtype)])
    dphi2_p = np.concatenate(
        [dphi2, np.zeros((nc_pad - nc,) + dphi2.shape[1:], dphi2.dtype)]
    )
    # split: device arrays (safe as a traced jit-argument pytree) vs static
    # meta (python ints/str — shapes and variant; must NOT be traced)
    tree = {
        "rel": jnp.asarray(rel.reshape(nb, _RC * n_loc), dtype=jnp.int32),
        "win": jnp.asarray(win, dtype=jnp.int32),
        "wq": jnp.asarray(wq_p, dtype=dtype),
        "dphi2": jnp.asarray(dphi2_p, dtype=dtype),
        "phi2": jnp.asarray(np.asarray(geom_tables["phi2"]), dtype=dtype),
        "perm": jnp.asarray(perm, dtype=jnp.int32),  # new pos -> old node
        "iperm": jnp.asarray(inew, dtype=jnp.int32),  # old node -> new pos
    }
    # Chunk the one-hot contraction when the full (nb, RC*n_loc, w) mask
    # would be large: XLA is free to materialize it (observed at the 235k
    # cavity: a vectorized f32[8,406,768,1536] = 14.3 GB allocation in
    # a non-scan compile — a device OOM), so above the budget the block axis
    # is processed in lax.map groups sized to keep any materialization
    # bounded. 0 = unchunked (the 56k mask is ~0.3 GB and always fuses).
    if onehot_budget_mb is None:  # env override of the config-surface knob
        onehot_budget_mb = float(
            __import__("os").environ.get("FC_NL_ONEHOT_BUDGET_MB", "512")
        )
    budget = float(onehot_budget_mb) * 2**20
    oh_bytes = nb * (_RC * n_loc) * w * np.dtype(dtype).itemsize
    chunk = 0
    if oh_bytes > budget:
        chunk = max(int(nb * budget / oh_bytes), 1)
        logger.info(
            "cell windows: one-hot mask %.2f GB > budget — chunking the "
            "block axis at %d blocks/group", oh_bytes / 2**30, chunk,
        )
    if split_layout:
        # identity boundaries: drop the per-apply node permutes
        del tree["perm"], tree["iperm"]
    static = {
        "n_vnodes": n_vnodes,
        "n_loc": n_loc,
        "w": w,
        "n_rows": n_rows,
        "variant": "onehot",
        "chunk": chunk,
        "split": split_layout,
    }
    return tree, static


def _window_rows(tree, static, u_nodes):
    """(..., n_vnodes, 2) -> (..., nb, w, 2) per-block window slices."""
    w, n_rows = static["w"], static["n_rows"]
    n_vnodes = static["n_vnodes"]
    batch = u_nodes.shape[:-2]
    pad = n_rows * _RN - n_vnodes
    up = jnp.concatenate(
        [u_nodes, jnp.zeros(batch + (pad, 2), dtype=u_nodes.dtype)], axis=-2
    )
    rows = up.reshape(batch + (n_rows, _RN, 2))
    uwin = jnp.take(rows, tree["win"], axis=-3)  # (..., nb, wb, RN, 2)
    return uwin.reshape(batch + (tree["win"].shape[0], w, 2))


def onehot_mask(rel_b, w: int, dtype):
    """(g, m) in-window indices -> (g, m, w) one-hot selection mask."""
    return (rel_b[:, :, None]
            == jnp.arange(w, dtype=jnp.int32)[None, None, :]).astype(dtype)


def onehot_pick(oh, uwin_b):
    """Select each cell's node values from its block window: an exact
    selection, so it must run at full f32 (see _PREC)."""
    return jnp.einsum("bmw,...bwd->...bmd", oh, uwin_b, precision=_PREC)


def nonlinear_convection_windowed(tree, static, u_mixed, n_dofs: int):
    """N(u) through the window blocks. Supports leading batch dims."""
    n_vnodes, n_loc, w = static["n_vnodes"], static["n_loc"], static["w"]
    nb = tree["win"].shape[0]
    batch = u_mixed.shape[:-1]
    dt = u_mixed.dtype
    split = static.get("split", False)
    if split:
        # hot layout: [u-dofs, v-dofs] already in window node order — a
        # reshape + axis swap, no gather
        u_nodes = jnp.swapaxes(
            u_mixed[..., : 2 * n_vnodes].reshape(batch + (2, n_vnodes)),
            -2, -1,
        )
    else:
        u_nodes = u_mixed[..., : 2 * n_vnodes].reshape(batch + (n_vnodes, 2))
        u_nodes = jnp.take(u_nodes, tree["perm"], axis=-2)  # RCM node order
    uwin = _window_rows(tree, static, u_nodes)  # (..., nb, w, 2)

    def _blocks(rel_b, wq_b, dphi2_b, uwin_b):
        """One-hot pick -> quadrature -> one-hot scatter for a group of
        cell blocks; ``*_b`` leaves carry a leading block axis of the
        group's size (uwin_b: batch + (g, w, 2))."""
        g = rel_b.shape[0]
        oh = onehot_mask(rel_b, w, dt)
        u_e = onehot_pick(oh, uwin_b)
        u_e = u_e.reshape(batch + (g * _RC, n_loc, 2))
        # per-cell quadrature (same math as
        # fem.assembly._nonlinear_contributions, on the window-ordered
        # geometry; padded cells have wq=0 => r_e=0)
        u_q = jnp.einsum("qn,...cnd->...cqd", tree["phi2"], u_e,
                         precision=_PREC)
        g_q = jnp.einsum("cqni,...cnd->...cqid", dphi2_b, u_e,
                         precision=_PREC)
        conv_q = jnp.einsum("...cqi,...cqid->...cqd", u_q, g_q,
                            precision=_PREC)
        r_e = jnp.einsum("cq,qa,...cqd->...cad", wq_b, tree["phi2"],
                         conv_q, precision=_PREC)
        r_e = r_e.reshape(batch + (g, _RC * n_loc, 2))
        return jnp.einsum("bmw,...bmd->...bwd", oh, r_e, precision=_PREC)

    chunk = static.get("chunk", 0)
    if static["variant"] == "onehot" and chunk:
        # bound any materialized one-hot: process the block axis in
        # lax.map groups of `chunk` blocks (see build_cell_windows)
        ng = -(-nb // chunk)
        nbp = ng * chunk

        def _padb(a, axis):
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, nbp - nb)
            return jnp.pad(a, widths)

        nbatch = len(batch)
        xs = (
            _padb(tree["rel"], 0).reshape(ng, chunk, _RC * n_loc),
            _padb(tree["wq"].reshape(nb, _RC, -1), 0)
            .reshape(ng, chunk * _RC, -1),
            _padb(
                tree["dphi2"].reshape((nb, _RC) + tree["dphi2"].shape[1:]), 0
            ).reshape((ng, chunk * _RC) + tree["dphi2"].shape[1:]),
            jnp.moveaxis(
                _padb(uwin, nbatch).reshape(batch + (ng, chunk, w, 2)),
                nbatch, 0,
            ),
        )
        yw = lax.map(lambda c: _blocks(*c), xs)  # (ng,)+batch+(chunk, w, 2)
        yw = jnp.moveaxis(yw, 0, nbatch).reshape(batch + (nbp, w, 2))
        yw = yw[..., :nb, :, :]
    elif static["variant"] == "onehot":
        yw = _blocks(tree["rel"], tree["wq"], tree["dphi2"], uwin)
    else:  # 'take': in-window dynamic pick
        u_e = jnp.take_along_axis(
            uwin,
            jnp.broadcast_to(
                tree["rel"][..., None], batch + (nb, _RC * n_loc, 1)
            ).astype(jnp.int32),
            axis=-2,
        )
        u_e = u_e.reshape(batch + (nb * _RC, n_loc, 2))
        u_q = jnp.einsum("qn,...cnd->...cqd", tree["phi2"], u_e,
                         precision=_PREC)
        g_q = jnp.einsum("cqni,...cnd->...cqid", tree["dphi2"], u_e,
                         precision=_PREC)
        conv_q = jnp.einsum("...cqi,...cqid->...cqd", u_q, g_q,
                            precision=_PREC)
        r_e = jnp.einsum("cq,qa,...cqd->...cad", tree["wq"], tree["phi2"],
                         conv_q, precision=_PREC)
        r_e = r_e.reshape(batch + (nb, _RC * n_loc, 2))
        yw = jnp.zeros(batch + (nb, w, 2), dtype=dt).at[
            ...,
            jnp.arange(nb)[:, None],
            tree["rel"],
            :,
        ].add(r_e)

    n_rows = static["n_rows"]
    yrows = jnp.zeros(batch + (n_rows, _RN, 2), dtype=dt)
    wb = w // _RN
    yrows = yrows.at[..., tree["win"], :, :].add(
        yw.reshape(batch + (nb, wb, _RN, 2))
    )
    y_nodes = yrows.reshape(batch + (n_rows * _RN, 2))[..., :n_vnodes, :]
    if not split:
        y_nodes = jnp.take(y_nodes, tree["iperm"], axis=-2)  # to mesh order
    out = jnp.zeros(batch + (n_dofs,), dtype=dt)
    if split:
        return out.at[..., : 2 * n_vnodes].set(
            jnp.swapaxes(y_nodes, -2, -1).reshape(batch + (2 * n_vnodes,))
        )
    return out.at[..., : 2 * n_vnodes].set(
        y_nodes.reshape(batch + (2 * n_vnodes,))
    )

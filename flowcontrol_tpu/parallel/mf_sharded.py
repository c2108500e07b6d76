"""Distributed multifrontal solve: per-stage node forests sharded over a
``space`` device-mesh axis.

This turns the nested-dissection direct solver (solvers/multifrontal.py)
into a genuinely distributed execution mode — the device-mesh analogue of
the reference's MPI domain decomposition, where dolfin partitions the mesh
across ranks and MUMPS factors/solves distributed
(ref: src/flowcontrol/flowsolver.py:236-238, SURVEY §2.5-1). Each device
owns an equal slice of every stage's factor stacks, so resident factor
bytes per device are O(total/n_dev) — memory scales DOWN with device
count, unlike the replicated dense-LU path (parallel/sharding.py keeps
factors replicated by design).

Two per-stage distribution modes, chosen statically at pack time:

- node mode (m ≥ n_dev): the stage's node stacks (inv_ii, F_ib, F_bi) are
  split across devices along the node axis — a depth-d stage holds up to
  2^d independent subtree fronts, which is where the tree's parallelism
  lives. Boundary updates combine with one ``psum`` over per-device
  gather tables; the eliminated block becomes globally visible with one
  tiled ``all_gather``.
- row mode (m < n_dev — the big top/root fronts): the flattened factor
  ROWS are split across devices, so even a single 4k-wide root front
  shards its (e², 2·e·b) floats n_dev ways. Each device computes row-dot
  products against the (small, replicated) stage vectors and one
  ``all_gather`` rebuilds the result.

The work vector stays replicated over 'space' (it is O(n) — tiny next to
the O(sum sep²) factors). An optional 'batch' mesh axis shards rollout
batches exactly as in parallel/sharding.py; the two compose.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flowcontrol_tpu.solvers.multifrontal import _gather_sum_t, _table_skip_pads


def _pad_rows(a: np.ndarray, n_dev: int) -> np.ndarray:
    """Pad the leading axis to a multiple of n_dev with zeros."""
    r = a.shape[0]
    rem = (-r) % n_dev
    if rem == 0:
        return a
    return np.concatenate(
        [a, np.zeros((rem,) + a.shape[1:], dtype=a.dtype)], axis=0
    )


class ShardedMultifrontal:
    """Wrap a factored MultifrontalLU's device tree into a sharded solve.

    Parameters
    ----------
    mf_tree : pytree from ``MultifrontalLU.tree()`` (stage stacks)
    static : dict from ``MultifrontalLU.static()``
    mesh : jax.sharding.Mesh with a ``space`` (and optionally batch) axis
    """

    def __init__(self, mf_tree, static, mesh: Mesh, axis: str = "space",
                 batch_axis: str | None = None):
        if static.get("layout", "ij") != "ij":
            raise ValueError(
                "ShardedMultifrontal requires the canonical stack layout — "
                "build the MultifrontalLU with layout='ij' (FC_MF_LAYOUT "
                "is a single-device A/B knob only)"
            )
        self.mesh = mesh
        self.axis = axis
        self.batch_axis = batch_axis
        self.n = static["n"]
        self.total = static["total"]
        n_dev = mesh.shape[axis]
        self.n_dev = n_dev
        total = self.total

        shard = NamedSharding(mesh, P(axis))
        repl = NamedSharding(mesh, P())

        stages_dev = []
        st_specs = []
        stage_static = []
        sharded_bytes = 0  # leaves split n_dev ways
        repl_bytes = 0  # small replicated leaves (bd lists, tables)
        max_read = 0
        for si, stt in enumerate(static["stages"]):
            e_max, b_max, m, off = stt[:4]
            st = mf_tree["stages"][si]
            inv = np.asarray(st["inv"])
            ginv = np.asarray(st["ginv"])
            fbi = np.asarray(st["fbi"])
            bd = np.asarray(st["bd"], dtype=np.int64)

            if m >= n_dev:
                # ── node mode: shard the node axis ──────────────────────────
                m_loc = -(-m // n_dev)
                m_pad = m_loc * n_dev

                def pad_nodes(a, fill=0):
                    if a.shape[0] == m_pad:
                        return a
                    pad = np.full((m_pad - a.shape[0],) + a.shape[1:], fill,
                                  dtype=a.dtype)
                    return np.concatenate([a, pad], axis=0)

                inv, ginv, fbi = (pad_nodes(a) for a in (inv, ginv, fbi))
                # pad nodes' bd slots point at the trash slot (== total)
                bd = pad_nodes(bd, fill=total)
                sharded_bytes += inv.nbytes + ginv.nbytes + fbi.nbytes

                # per-device transposed-scatter tables over the LOCAL bd
                # contributions (global positions don't survive the split)
                tables = []
                for d in range(n_dev):
                    dest = bd[d * m_loc: (d + 1) * m_loc].reshape(-1)
                    tables.append(_table_skip_pads(dest, total))
                kmax = max(t.shape[1] for t in tables)
                n_contrib = m_loc * b_max
                padded = []
                for t in tables:
                    if t.shape[1] < kmax:
                        fill = np.full((t.shape[0], kmax - t.shape[1]),
                                       n_contrib, dtype=t.dtype)
                        t = np.concatenate([t, fill], axis=1)
                    padded.append(np.ascontiguousarray(t.T.astype(np.int32)))
                table_t = np.stack(padded)  # (n_dev, kmax, total + 1)
                repl_bytes += table_t.nbytes // n_dev + bd.nbytes // n_dev

                stages_dev.append({
                    "inv": jax.device_put(jnp.asarray(inv), shard),
                    "ginv": jax.device_put(jnp.asarray(ginv), shard),
                    "fbi": jax.device_put(jnp.asarray(fbi), shard),
                    "bd": jax.device_put(
                        jnp.asarray(bd.astype(np.int32)), shard
                    ),
                    "table_t": jax.device_put(jnp.asarray(table_t), shard),
                })
                st_specs.append({k: P(axis) for k in stages_dev[-1]})
                stage_static.append(("node", e_max, b_max, m, m_loc, off))
                max_read = max(max_read, off + m_pad * e_max)
            else:
                # ── row mode: shard the flattened factor rows ───────────────
                inv_rows = _pad_rows(
                    inv.reshape(m * e_max, e_max), n_dev
                )
                ginv_rows = _pad_rows(
                    ginv.reshape(m * e_max, b_max), n_dev
                )
                fbi_rows = _pad_rows(
                    fbi.reshape(m * b_max, e_max), n_dev
                )
                sharded_bytes += (
                    inv_rows.nbytes + ginv_rows.nbytes + fbi_rows.nbytes
                )
                # one FULL update table, replicated: every device holds the
                # all_gather'd updates, so the delta is applied identically
                # (no psum) — the table is O(total·kmax) ints, not factors
                table = _table_skip_pads(bd.reshape(-1), total)
                table_t = np.ascontiguousarray(table.T.astype(np.int32))
                repl_bytes += table_t.nbytes + bd.nbytes
                stages_dev.append({
                    "inv_rows": jax.device_put(jnp.asarray(inv_rows), shard),
                    "ginv_rows": jax.device_put(jnp.asarray(ginv_rows), shard),
                    "fbi_rows": jax.device_put(jnp.asarray(fbi_rows), shard),
                    "bd": jax.device_put(
                        jnp.asarray(bd.astype(np.int32)), repl
                    ),
                    "table_t": jax.device_put(jnp.asarray(table_t), repl),
                })
                st_specs.append(
                    {"inv_rows": P(axis), "ginv_rows": P(axis),
                     "fbi_rows": P(axis), "bd": P(), "table_t": P()}
                )
                stage_static.append(
                    ("row", e_max, b_max, m,
                     (inv_rows.shape[0] // n_dev, fbi_rows.shape[0] // n_dev),
                     off)
                )
                max_read = max(max_read, off + m * e_max)
        self._stages = stages_dev
        self._stage_static = tuple(stage_static)
        self._perm = jax.device_put(jnp.asarray(mf_tree["perm"]), repl)
        self._ipos = jax.device_put(jnp.asarray(mf_tree["ipos"]), repl)
        #: resident factor bytes PER DEVICE (the memory-scaling claim);
        #: index/table bytes are reported separately — they are O(n·kmax)
        #: ints, not O(sum sep²) factors
        self.per_device_factor_bytes = sharded_bytes // n_dev
        self.total_factor_bytes = sharded_bytes
        self.per_device_index_bytes = repl_bytes

        # scratch room: padded node-mode slices may read past ``total + 1``
        self._n_work = max(total + 1, max_read + 1)

        xs = P(batch_axis) if batch_axis else P()
        # check_vma=False: the output IS replicated over 'space' (every
        # device applies identical psum'd deltas and all_gather'd blocks),
        # but the static varying-across-mesh checker cannot infer
        # replication through all_gather outputs.
        self._solve = jax.shard_map(
            self._solve_local, mesh=mesh,
            in_specs=(st_specs, P(), P(), xs), out_specs=xs,
            check_vma=False,
        )

    # ── the per-device solve body (runs under shard_map) ────────────────────

    def _gather_rows(self, rows_loc, vec_nodes, d, n_rows_loc, per_node,
                     m, batch):
        """Row-dot products: rows_loc (n_rows_loc, k) · vec_nodes[node(r)]
        where node(r) = global_row // per_node."""
        gidx = d * n_rows_loc + jnp.arange(n_rows_loc)
        node = jnp.minimum(gidx // per_node, m - 1)
        v_rows = vec_nodes[..., node, :]  # (..., n_rows_loc, k)
        return jnp.einsum("rj,...rj->...r", rows_loc, v_rows)

    def _solve_local(self, stages, perm, ipos, b):
        axis = self.axis
        total = self.total
        batch = b.shape[:-1]
        dtype = stages[0][next(iter(stages[0]))].dtype
        for k in ("inv", "inv_rows"):
            if k in stages[0]:
                dtype = stages[0][k].dtype
        out_dtype = b.dtype if b.dtype in (jnp.float32, jnp.float64) else dtype
        d = jax.lax.axis_index(axis)

        def agather(v):
            return jax.lax.all_gather(v, axis, axis=len(batch), tiled=True)

        bext = jnp.concatenate(
            [jnp.asarray(b).astype(dtype),
             jnp.zeros(batch + (1,), dtype=dtype)], axis=-1,
        )
        x = jnp.concatenate(
            [bext[..., perm],
             jnp.zeros(batch + (self._n_work - total,), dtype=dtype)],
            axis=-1,
        )

        def sub_delta(x, delta):
            return x - jnp.pad(
                delta,
                [(0, 0)] * len(batch) + [(0, self._n_work - total - 1)],
            )

        n_stages = len(stages)
        # forward sweep: deepest stages first
        for si in range(n_stages):
            st = stages[si]
            mode, e_max, b_max, m, loc, off = self._stage_static[si]
            if mode == "node":
                m_loc = loc
                start = off + d * (m_loc * e_max)
                xe = jax.lax.dynamic_slice_in_dim(
                    x, start, m_loc * e_max, axis=-1
                ).reshape(batch + (m_loc, e_max))
                z = jnp.einsum("mij,...mj->...mi", st["inv"], xe)
                upd = jnp.einsum("mbi,...mi->...mb", st["fbi"], z)
                # table_t is stacked per-device (n_dev, kmax, total+1): the
                # local shard under shard_map has a leading length-1 axis
                delta = _gather_sum_t(
                    upd.reshape(batch + (-1,)), st["table_t"][0]
                )
                x = sub_delta(x, jax.lax.psum(delta, axis))
                z_full = agather(z.reshape(batch + (m_loc * e_max,)))
                x = jax.lax.dynamic_update_slice_in_dim(
                    x, z_full[..., : m * e_max], off, axis=-1
                )
            else:
                rz_loc, ru_loc = loc
                xe = jax.lax.dynamic_slice_in_dim(
                    x, off, m * e_max, axis=-1
                ).reshape(batch + (m, e_max))
                z_loc = self._gather_rows(
                    st["inv_rows"], xe, d, rz_loc, e_max, m, batch
                )
                z_flat = agather(z_loc)[..., : m * e_max]
                z_nodes = z_flat.reshape(batch + (m, e_max))
                u_loc = self._gather_rows(
                    st["fbi_rows"], z_nodes, d, ru_loc, b_max, m, batch
                )
                upd = agather(u_loc)[..., : m * b_max]
                # updates are fully replicated after the gather: apply the
                # stage-global table with NO psum
                delta = _gather_sum_t(upd, st["table_t"])
                x = sub_delta(x, delta)
                x = jax.lax.dynamic_update_slice_in_dim(
                    x, z_flat, off, axis=-1
                )

        # backward sweep: root first
        for si in reversed(range(n_stages)):
            st = stages[si]
            mode, e_max, b_max, m, loc, off = self._stage_static[si]
            if mode == "node":
                m_loc = loc
                xb = x[..., st["bd"]]  # (..., m_loc, b_max); ancestors final
                corr = jnp.einsum("mib,...mb->...mi", st["ginv"], xb)
                start = off + d * (m_loc * e_max)
                z = jax.lax.dynamic_slice_in_dim(
                    x, start, m_loc * e_max, axis=-1
                ).reshape(batch + (m_loc, e_max))
                out_full = agather(
                    (z - corr).reshape(batch + (m_loc * e_max,))
                )
                x = jax.lax.dynamic_update_slice_in_dim(
                    x, out_full[..., : m * e_max], off, axis=-1
                )
            else:
                rz_loc, _ = loc
                xb = x[..., st["bd"]]  # (..., m, b_max) replicated
                c_loc = self._gather_rows(
                    st["ginv_rows"], xb, d, rz_loc, e_max, m, batch
                )
                corr2 = agather(c_loc)[..., : m * e_max]
                z = jax.lax.dynamic_slice_in_dim(
                    x, off, m * e_max, axis=-1
                )
                x = jax.lax.dynamic_update_slice_in_dim(
                    x, z - corr2, off, axis=-1
                )

        return x[..., ipos].astype(out_dtype)

    def solve(self, b):
        """x = A⁻¹ b; b replicated over 'space' (sharded over batch_axis)."""
        return self._solve(self._stages, self._perm, self._ipos, b)

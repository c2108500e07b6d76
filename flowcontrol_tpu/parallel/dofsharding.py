"""DOF-sharded operators: true domain decomposition with halo exchange.

This is the memory-scaling counterpart of ``parallel.sharding`` (which
shards element tensors but replicates dof vectors). Here the DOF vector
itself is sharded: each device owns a contiguous block of spatially-ordered
dofs, holds only the element tensors of cells assigned to it, and fetches
the halo it needs from its two neighbors with ``lax.ppermute`` —
the device-mesh analogue of dolfin/PETSc's ghost-dof exchange
(ref: src/flowcontrol/flowsolver.py:236-238, src/utils/mpi.py; SURVEY §5.7-8).

Construction (host, one-time):
1. order all mixed dofs by their spatial coordinate (x, then y) — velocity
   nodes and pressure vertices interleave into one 1-D strip decomposition;
2. split into n_dev equal blocks of ``n_loc`` (zero-padded at the end);
3. assign each cell to the device owning its median dof; every cell's dofs
   must then fall inside that device's 3-block window [left | own | right]
   (asserted — holds whenever n_loc exceeds the dof-index spread of a cell,
   i.e. any mesh at a sane dofs-per-device ratio);
4. per-device element tensors + window-relative connectivity + a padded
   gather table for the local scatter.

Apply (device, per matvec): 2 ppermutes to fetch neighbor shards, local
gather → per-element matvec → window scatter, 2 ppermutes to return
halo contributions. Communication is O(n_loc) per device, NOT O(n): both
memory and bandwidth scale down with device count.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def mixed_dof_coordinates(space) -> np.ndarray:
    """(n_dofs, 2) coordinate of every mixed dof (vel nodes + P1 vertices)."""
    vel = np.repeat(space.vel_node_coords, 2, axis=0)  # (2*n_vnodes, 2)
    return np.concatenate([vel, space.mesh.coords], axis=0)


@dataclass
class DofPartition:
    """Host-side description of a 1-D spatial dof decomposition."""

    perm: np.ndarray  # (n_pad,) spatial position -> global dof (pad: -1)
    iperm: np.ndarray  # (n,) global dof -> spatial position
    n_dofs: int
    n_loc: int
    n_dev: int
    cell_dev: np.ndarray  # (nc,) owning device per cell

    @classmethod
    def build(cls, space, n_dev: int) -> "DofPartition":
        n = space.n_dofs
        coords = mixed_dof_coordinates(space)
        order = np.lexsort((coords[:, 1], coords[:, 0]))  # sort by x, then y
        iperm = np.empty(n, dtype=np.int64)
        iperm[order] = np.arange(n)
        n_loc = -(-n // n_dev)
        n_pad = n_loc * n_dev
        perm = np.full(n_pad, -1, dtype=np.int64)
        perm[:n] = order
        sidx = iperm[space.cell_dofs]  # (nc, 15) spatial indices
        cell_dev = np.clip(
            np.median(sidx, axis=1).astype(np.int64) // n_loc, 0, n_dev - 1
        )
        # window feasibility: every cell dof within owner's 3-block window
        lo = (cell_dev - 1) * n_loc
        hi = (cell_dev + 2) * n_loc
        ok = (sidx >= lo[:, None]) & (sidx < hi[:, None])
        if not ok.all():
            bad = int((~ok.all(axis=1)).sum())
            raise ValueError(
                f"{bad} cells span more than one neighbor block "
                f"(n_loc={n_loc}); use fewer devices or a larger mesh"
            )
        return cls(
            perm=perm, iperm=iperm, n_dofs=n, n_loc=n_loc, n_dev=n_dev,
            cell_dev=cell_dev,
        )

    # ── global <-> sharded vector transport (host-side helpers) ─────────────

    def to_spatial(self, x_global: np.ndarray) -> np.ndarray:
        """(.., n) global-order -> (.., n_pad) spatial-order, zero padded."""
        x = np.asarray(x_global)
        out = np.zeros(x.shape[:-1] + (self.perm.shape[0],), dtype=x.dtype)
        out[..., : self.n_dofs] = 0.0
        valid = self.perm >= 0
        out[..., valid] = x[..., self.perm[valid]]
        return out

    def from_spatial(self, x_spatial: np.ndarray) -> np.ndarray:
        x = np.asarray(x_spatial)
        return x[..., self.iperm]


class DofShardedOperator:
    """y = A x with BOTH the dof vector and the elements sharded.

    ``apply`` consumes/produces spatially-ordered vectors laid out as
    (n_dev * n_loc,) jax arrays sharded over ``axis``; per-device memory is
    O(n/n_dev) for the vector and O(nnz/n_dev) for the elements.
    """

    def __init__(self, a_e, cell_dofs, space, mesh: Mesh, axis: str = "space",
                 dtype=None):
        from flowcontrol_tpu.fem.assembly import build_gather_table

        n_dev = mesh.shape[axis]
        part = DofPartition.build(space, n_dev)
        self.part = part
        self.mesh = mesh
        self.axis = axis
        n_loc = part.n_loc

        a_e = np.asarray(a_e)
        if dtype is not None:
            a_e = a_e.astype(dtype)
        cd_s = part.iperm[np.asarray(cell_dofs)]  # spatial indices (nc, 15)

        # per-device cell groups, padded to a common count
        groups = [np.where(part.cell_dev == d)[0] for d in range(n_dev)]
        nc_max = max(len(g) for g in groups)
        a_loc = np.zeros((n_dev, nc_max) + a_e.shape[1:], dtype=a_e.dtype)
        # window-relative connectivity; padding cells point at the window's
        # first slot with zero tensors (harmless scatter)
        w_idx = np.zeros((n_dev, nc_max, cd_s.shape[1]), dtype=np.int32)
        tables = []
        for d, g in enumerate(groups):
            a_loc[d, : len(g)] = a_e[g]
            rel = cd_s[g] - (d - 1) * n_loc  # within [0, 3*n_loc)
            w_idx[d, : len(g)] = rel
            tables.append(build_gather_table(w_idx[d], 3 * n_loc))
        kmax = max(t.shape[1] for t in tables)
        gt = np.zeros((n_dev, 3 * n_loc, kmax), dtype=tables[0].dtype)
        for d, t in enumerate(tables):
            m = w_idx[d].size
            gt[d, :, : t.shape[1]] = t
            if t.shape[1] < kmax:
                gt[d, :, t.shape[1]:] = m  # points at the zero pad slot
        self.kmax = kmax

        sh = NamedSharding(mesh, P(axis))
        self._a = jax.device_put(a_loc, sh)
        self._widx = jax.device_put(w_idx, sh)
        self._gt = jax.device_put(gt, sh)
        self._vec_sharding = NamedSharding(mesh, P(axis))

        n = n_dev
        fwd = [(i, (i + 1) % n) for i in range(n)]  # i's shard -> right nbr
        bwd = [(i, (i - 1) % n) for i in range(n)]  # i's shard -> left nbr
        axis_name = axis

        def local_apply(a_l, widx_l, gt_l, x_l):
            # x_l: (1, n_loc) — leading shard axis of size 1 inside shard_map
            x_l = x_l[0]
            from_left = jax.lax.ppermute(x_l, axis_name, fwd)
            from_right = jax.lax.ppermute(x_l, axis_name, bwd)
            window = jnp.concatenate([from_left, x_l, from_right])
            xe = window[widx_l[0]]  # (nc_max, 15)
            ye = jnp.einsum("cij,cj->ci", a_l[0], xe)
            from flowcontrol_tpu.fem.assembly import gather_assemble

            yw = gather_assemble(ye.reshape(-1), gt_l[0], 3 * n_loc)
            y_left, y_own, y_right = (
                yw[:n_loc], yw[n_loc: 2 * n_loc], yw[2 * n_loc:],
            )
            # my left-window contributions belong to the left neighbor
            add_from_right = jax.lax.ppermute(y_left, axis_name, bwd)
            add_from_left = jax.lax.ppermute(y_right, axis_name, fwd)
            return (y_own + add_from_right + add_from_left)[None]

        self._apply = jax.jit(
            jax.shard_map(
                local_apply, mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis)),
                out_specs=P(axis),
            )
        )

    # ── public API ───────────────────────────────────────────────────────────

    def shard_vector(self, x_global: np.ndarray):
        """Global-order host vector -> sharded spatial-order device array."""
        xs = self.part.to_spatial(x_global).reshape(
            self.part.n_dev, self.part.n_loc
        )
        return jax.device_put(jnp.asarray(xs), self._vec_sharding)

    def unshard_vector(self, x_sharded) -> np.ndarray:
        return self.part.from_spatial(np.asarray(x_sharded).reshape(-1))

    def apply(self, x_sharded):
        """y = A x on sharded spatial vectors ((n_dev, n_loc) sharded)."""
        return self._apply(self._a, self._widx, self._gt, x_sharded)

    def per_device_nbytes(self) -> int:
        """Bytes of ONE device's shard of the element tensors (diagnostic)."""
        return int(np.asarray(self._a[0]).nbytes)

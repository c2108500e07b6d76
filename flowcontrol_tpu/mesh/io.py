"""XDMF/HDF5 mesh and field I/O.

Interoperable with the reference's data formats:
- mesh XDMF files pointing at HDF5 geometry/topology datasets
  (ref: src/examples/*/data_input/*.xdmf, read by dolfin.XDMFFile in
  flowsolver.py:233-240)
- time-series field snapshots written as XDMF + HDF5, Paraview-readable,
  with an integer counter per checkpoint (ref: src/utils/io.py:21-50
  write_xdmf/read_xdmf).

Pure host-side (h5py + xml) — I/O is not a hot path. h5py is optional
(the ``io`` extra): only these readers and writers need it.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from flowcontrol_tpu.mesh.mesh import Mesh2D


def require_h5py():
    """Import h5py, or say which feature needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is needed for XDMF/HDF5 mesh, checkpoint and snapshot "
            "I/O (pip install 'flowcontrol-tpu[io]'); stepping without "
            "checkpoints (save_every=0) does not need it"
        ) from e
    return h5py


def read_xdmf_mesh(path) -> Mesh2D:
    """Read a triangle mesh from an XDMF file referencing an HDF5 sidecar."""
    h5py = require_h5py()

    path = Path(path)
    tree = ET.parse(path)
    root = tree.getroot()
    geom_item = root.find(".//Geometry/DataItem")
    topo_item = root.find(".//Topology/DataItem")
    if geom_item is None or topo_item is None:
        raise ValueError(f"no Geometry/Topology DataItem found in {path}")

    def load(item):
        ref = item.text.strip()
        h5file, dset = ref.split(":", 1)
        with h5py.File(path.parent / h5file, "r") as f:
            return np.asarray(f[dset])

    coords = load(geom_item)[:, :2].astype(np.float64)
    cells = load(topo_item).astype(np.int32)
    return Mesh2D(coords, cells)


def write_xdmf_mesh(path, mesh: Mesh2D) -> None:
    h5py = require_h5py()

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    h5path = path.with_suffix(".h5")
    with h5py.File(h5path, "w") as f:
        f.create_dataset("mesh/geometry", data=mesh.coords)
        f.create_dataset("mesh/topology", data=mesh.cells.astype(np.int64))
    xml = (
        '<Xdmf Version="3.0"><Domain><Grid Name="mesh" GridType="Uniform">'
        f'<Topology NumberOfElements="{mesh.num_cells}" TopologyType="Triangle" '
        f'NodesPerElement="3"><DataItem Dimensions="{mesh.num_cells} 3" '
        f'NumberType="Int" Format="HDF">{h5path.name}:/mesh/topology</DataItem>'
        "</Topology>"
        f'<Geometry GeometryType="XY"><DataItem Dimensions="{mesh.num_vertices} 2" '
        f'Format="HDF">{h5path.name}:/mesh/geometry</DataItem></Geometry>'
        "</Grid></Domain></Xdmf>"
    )
    path.write_text(xml)


class FieldCheckpointFile:
    """Append-mode field snapshot file (HDF5), counter-indexed like the
    reference's XDMFFile.write_checkpoint / read_checkpoint
    (ref: src/utils/io.py:21-50).

    Layout: ``/<name>/<counter>`` datasets + ``/<name>_time`` (times array).
    An XDMF index for Paraview is written alongside on close/flush when the
    field lives on P1 vertices or P2 nodes of a known mesh.
    """

    def __init__(self, path, mode="a"):
        h5py = require_h5py()

        self.path = Path(path if str(path).endswith(".h5") else str(path) + ".h5")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._h5 = h5py.File(self.path, mode)

    def write(self, name: str, data: np.ndarray, time: float, counter: int | None = None):
        grp = self._h5.require_group(name)
        if counter is None:
            counter = len(grp.keys())
        key = str(counter)
        if key in grp:
            del grp[key]
        grp.create_dataset(key, data=np.asarray(data))
        tname = f"{name}_times"
        times = list(self._h5.attrs.get(tname, []))
        while len(times) <= counter:
            times.append(np.nan)
        times[counter] = time
        self._h5.attrs[tname] = times
        self._h5.flush()
        return counter

    def read(self, name: str, counter: int = 0) -> np.ndarray:
        grp = self._h5[name]
        if str(counter) not in grp:
            # negative counter: from the end
            keys = sorted(int(k) for k in grp.keys())
            counter = keys[counter]
        return np.asarray(grp[str(counter)])

    def n_checkpoints(self, name: str) -> int:
        return len(self._h5[name].keys()) if name in self._h5 else 0

    def times(self, name: str):
        return np.asarray(self._h5.attrs.get(f"{name}_times", []))

    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def write_xdmf_timeseries_index(h5_path, mesh: Mesh2D, name: str, out_path=None):
    """Emit a Paraview-readable XDMF temporal-collection index for a
    :class:`FieldCheckpointFile` (ref: src/utils/io.py:21-50 — the reference's
    dolfin XDMFFile writes this index automatically; here it is explicit).

    Visualization strategy: linear triangles + vertex-sliced data. Velocity
    is P2 (vertices then edge midpoints, dofmap.py layout), so the vertex
    values are simply the first ``n_vertices`` rows; pressure P1 is exact on
    vertices. Vector data is zero-padded to 3 components (XDMF readers
    expect 3D vectors). Padded per-snapshot vertex datasets are written into
    the same HDF5 file under ``/viz/<name>/<counter>`` (small: vertex-only).

    Returns the path of the written ``.xdmf`` file.
    """
    h5py = require_h5py()

    h5_path = Path(h5_path)
    out_path = Path(out_path) if out_path else h5_path.with_suffix(".xdmf")
    nv, nc = mesh.num_vertices, mesh.num_cells

    with h5py.File(h5_path, "a") as f:
        if "viz_mesh/geometry" not in f:
            f.create_dataset("viz_mesh/geometry", data=mesh.coords)
            f.create_dataset("viz_mesh/topology", data=mesh.cells.astype(np.int64))
        times = np.asarray(f.attrs.get(f"{name}_times", []))
        grp = f[name]
        counters = sorted(int(k) for k in grp.keys())
        is_vector = grp[str(counters[0])].ndim == 2 if counters else False
        viz = f.require_group(f"viz/{name}")
        for k in counters:
            key = str(k)
            if key in viz:
                continue
            data = np.asarray(grp[key])[:nv]
            if is_vector:
                data = np.pad(data, ((0, 0), (0, 3 - data.shape[1])))
            viz.create_dataset(key, data=data)

    mesh_xml = (
        f'<Topology NumberOfElements="{nc}" TopologyType="Triangle" '
        f'NodesPerElement="3"><DataItem Dimensions="{nc} 3" NumberType="Int" '
        f'Format="HDF">{h5_path.name}:/viz_mesh/topology</DataItem></Topology>'
        f'<Geometry GeometryType="XY"><DataItem Dimensions="{nv} 2" '
        f'Format="HDF">{h5_path.name}:/viz_mesh/geometry</DataItem></Geometry>'
    )
    attr_type = "Vector" if is_vector else "Scalar"
    dims = f"{nv} 3" if is_vector else f"{nv}"
    grids = []
    for k in counters:
        t = float(times[k]) if k < len(times) and np.isfinite(times[k]) else float(k)
        grids.append(
            f'<Grid Name="{name}_{k}" GridType="Uniform">'
            f'<Time Value="{t!r}"/>{mesh_xml}'
            f'<Attribute Name="{name}" AttributeType="{attr_type}" Center="Node">'
            f'<DataItem Dimensions="{dims}" Format="HDF">'
            f"{h5_path.name}:/viz/{name}/{k}</DataItem></Attribute></Grid>"
        )
    xml = (
        '<?xml version="1.0"?><Xdmf Version="3.0"><Domain>'
        f'<Grid Name="{name}_series" GridType="Collection" '
        f'CollectionType="Temporal">{"".join(grids)}</Grid></Domain></Xdmf>'
    )
    out_path.write_text(xml)
    return out_path


def write_field_snapshot(path, name, data, time, counter=None, append=True):
    """One-shot convenience wrapper (ref: utils.io.write_xdmf)."""
    mode = "a" if append else "w"
    with FieldCheckpointFile(path, mode) as f:
        return f.write(name, data, time, counter)


def read_field_snapshot(path, name, counter=0):
    """One-shot read (ref: utils.io.read_xdmf)."""
    with FieldCheckpointFile(path, "r") as f:
        return f.read(name, counter)

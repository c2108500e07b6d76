"""Field snapshots, timeseries CSV, and restart metadata.

Behavioral port of the reference FlowExporter
(ref: src/flowcontrol/exporter.py): HDF5 snapshot triplets (U / Uprev / P,
full field = perturbation + adjust_baseflow·base), list-of-dicts timeseries
flushed to CSV, JSON restart sidecar rewritten at every checkpoint so a
killed run restarts from the last checkpoint, and progress logging.

CSV column layout matches exactly: time, u_ctrl_*, y_meas_*, dE, runtime.
JSON sidecar fields match exactly: Tstart, dt, save_every,
checkpoints_written, restart_order, files{U, Uprev, P}
(ref: exporter.py:234-262).
"""

from __future__ import annotations

import csv
import json
import logging

import numpy as np

from flowcontrol_tpu.core.flowfield import FlowFieldCollection, SimPaths
from flowcontrol_tpu.mesh.io import FieldCheckpointFile, require_h5py

logger = logging.getLogger(__name__)


class FlowExporter:
    """Handles snapshot export and timeseries CSV logging."""

    def __init__(
        self,
        paths: SimPaths,
        fields: FlowFieldCollection,
        space,
        Tstart: float = 0.0,
        dt: float = 0.0,
        save_every: int = 0,
    ) -> None:
        self.paths = paths
        self.fields = fields
        self.space = space
        self._Tstart = Tstart
        self._dt = dt
        self._save_every = save_every
        self._records: list[dict] = []
        self._checkpoints_written = 0
        self._u_cols = None
        self._y_cols = None
        self._files = {}

    # ── Field export ─────────────────────────────────────────────────────────

    def _file(self, path):
        key = str(path)
        if key not in self._files:
            self._files[key] = FieldCheckpointFile(path, "a")
        return self._files[key]

    def export_snapshots(
        self,
        u_n: np.ndarray,
        u_nn: np.ndarray,
        p_n: np.ndarray,
        time: float,
        append: bool = True,
        adjust_baseflow: float = 0.0,
    ) -> None:
        """Write U/Uprev/P snapshots (ref: exporter.py:85-165).

        ``adjust_baseflow``: 0 → perturbation only, 1 → full field.
        """
        pmbf = adjust_baseflow
        u0 = self.fields.U0 if self.fields.U0 is not None else 0.0
        p0 = self.fields.P0 if self.fields.P0 is not None else 0.0
        usave = np.asarray(u_n) + pmbf * np.asarray(u0)
        usave_n = np.asarray(u_nn) + pmbf * np.asarray(u0)
        psave = np.asarray(p_n) + pmbf * np.asarray(p0)
        self.fields.Usave, self.fields.Usave_n, self.fields.Psave = (
            usave,
            usave_n,
            psave,
        )
        if not append:
            for p in (
                self.paths.U_restart,
                self.paths.Uprev_restart,
                self.paths.P_restart,
            ):
                f = self._file(p)
                f.close()
                del self._files[str(p)]
                require_h5py().File(f.path, "w").close()  # truncate
        self._checkpoints_written += 1
        self._file(self.paths.U_restart).write("U", usave, time)
        self._file(self.paths.Uprev_restart).write("U_n", usave_n, time)
        self._file(self.paths.P_restart).write("P", psave, time)

    # back-compat alias matching the reference method name
    export_xdmf = export_snapshots

    # ── Timeseries ───────────────────────────────────────────────────────────

    def log_ic(self, t: float, y_meas, dE: float) -> None:
        row = {"time": t, "dE": float(dE), "runtime": 0.0}
        for i, v in enumerate(np.atleast_1d(y_meas)):
            row[f"y_meas_{i + 1}"] = float(v)
        self._records.append(row)

    def log(self, u_ctrl, y_meas, dE, t, runtime) -> None:
        u_ctrl = np.atleast_1d(u_ctrl)
        y_meas = np.atleast_1d(y_meas)
        if self._u_cols is None:
            self._u_cols = [f"u_ctrl_{i + 1}" for i in range(len(u_ctrl))]
            self._y_cols = [f"y_meas_{i + 1}" for i in range(len(y_meas))]
        row = {"time": float(t), "dE": float(dE), "runtime": float(runtime)}
        row.update(zip(self._u_cols, (float(v) for v in u_ctrl)))
        row.update(zip(self._y_cols, (float(v) for v in y_meas)))
        self._records.append(row)

    def columns(self) -> list[str]:
        """CSV columns: every record key, in order of first appearance."""
        cols: dict[str, None] = {}
        for row in self._records:
            cols.update(dict.fromkeys(row))
        return list(cols)

    def to_dataframe(self):
        """The timeseries as a pandas DataFrame (pandas is optional and
        imported only here)."""
        import pandas as pd

        return pd.DataFrame(self._records, columns=self.columns())

    def write_metadata(self, restart_order=2) -> None:
        meta = {
            "Tstart": self._Tstart,
            "dt": self._dt,
            "save_every": self._save_every,
            "checkpoints_written": self._checkpoints_written,
            "restart_order": restart_order,
            "files": {
                "U": self.paths.U_restart.name,
                "Uprev": self.paths.Uprev_restart.name,
                "P": self.paths.P_restart.name,
            },
        }
        self.paths.metadata.parent.mkdir(parents=True, exist_ok=True)
        self.paths.metadata.write_text(json.dumps(meta, indent=2))

    def write_paraview_index(self) -> None:
        """Emit Paraview-readable .xdmf temporal indexes next to the U/P
        snapshot files (ref: dolfin XDMFFile does this implicitly;
        see mesh/io.write_xdmf_timeseries_index)."""
        from flowcontrol_tpu.mesh.io import write_xdmf_timeseries_index

        mesh = self.space.mesh
        for path, name in (
            (self.paths.U_restart, "U"),
            (self.paths.P_restart, "P"),
        ):
            f = self._file(path)
            if f.n_checkpoints(name):
                f.close()
                del self._files[str(path)]
                write_xdmf_timeseries_index(f.path, mesh, name)

    def write_timeseries(self) -> None:
        self.paths.timeseries.parent.mkdir(parents=True, exist_ok=True)
        with open(self.paths.timeseries, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.columns(), restval="")
            w.writeheader()
            w.writerows(self._records)

    def log_progress(self, iter, num_steps, t, t_end, runtime) -> None:
        logger.info(
            "--- iter: %5d/%5d --- time: %3.3f/%3.3f --- elapsed %5.5f ---",
            iter,
            num_steps,
            t,
            t_end,
            runtime,
        )

    def reset(self) -> None:
        self._records.clear()
        self._checkpoints_written = 0

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

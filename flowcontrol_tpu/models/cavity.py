"""Flow over an open cavity at Re=7500.

Behavioral port of the reference CavityFlowSolver
(ref: src/examples/cavity/cavityflowsolver.py): channel with inlet/outlet,
slip upper wall, cavity cut into the lower wall with slip/no-slip segment
split, Gaussian volume-force actuator upstream of the cavity, wall-shear +
point sensors, and the channel/cavity-split steady-state initial guess.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from flowcontrol_tpu.core import flowsolverparameters as fsp
from flowcontrol_tpu.core.actuator import ActuatorForceGaussianV
from flowcontrol_tpu.core.flowfield import BoundaryConditions
from flowcontrol_tpu.core.flowsolver import FlowSolver
from flowcontrol_tpu.core.sensor import (
    SENSOR_TYPE,
    SensorHorizontalWallShear,
    SensorPoint,
)

logger = logging.getLogger(__name__)


def default_cavity_mesh(**kwargs):
    """The generated cavity mesh (deterministic, and well under a second
    even at 56k dofs, so nothing is cached)."""
    from flowcontrol_tpu.mesh.generation import cavity_mesh

    return cavity_mesh(**kwargs)


class CavityFlowSolver(FlowSolver):
    """Flow over an open cavity. Proposed Re=7500."""

    def _make_boundaries(self) -> dict:
        """10 boundaries (ref: cavityflowsolver.py:22-149)."""
        ud_m = self.params_mesh.user_data
        L = self.params_flow.user_data["L"]
        D = self.params_flow.user_data["D"]
        xinfa, xinf, yinf = ud_m["xinfa"], ud_m["xinf"], ud_m["yinf"]
        x0ns_left, x0ns_right = ud_m["x0ns_left"], ud_m["x0ns_right"]
        tol = 1e-7

        return {
            "inlet": lambda x: np.abs(x[:, 0] - xinfa) < tol,
            "outlet": lambda x: np.abs(x[:, 0] - xinf) < tol,
            "upper_wall": lambda x: np.abs(x[:, 1] - yinf) < tol,
            "cavity_left": lambda x: (np.abs(x[:, 0]) < tol)
            & (x[:, 1] > -D - tol) & (x[:, 1] < tol),
            "cavity_botm": lambda x: (np.abs(x[:, 1] + D) < tol)
            & (x[:, 0] > -tol) & (x[:, 0] < L + tol),
            "cavity_right": lambda x: (np.abs(x[:, 0] - L) < tol)
            & (x[:, 1] > -D - tol) & (x[:, 1] < tol),
            "lower_wall_left_sf": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= xinfa) & (x[:, 0] <= x0ns_left + tol),
            "lower_wall_left_ns": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= x0ns_left - tol) & (x[:, 0] <= 0),
            "lower_wall_right_ns": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= L - tol) & (x[:, 0] <= x0ns_right + tol),
            "lower_wall_right_sf": lambda x: (np.abs(x[:, 1]) < tol)
            & (x[:, 0] >= x0ns_right - tol) & (x[:, 0] <= xinf),
        }

    def _make_bcs(self) -> BoundaryConditions:
        """(ref: cavityflowsolver.py:151-193)"""
        return BoundaryConditions(
            bcu=[
                self.dirichlet_bc("inlet", value=(0.0, 0.0)),
                self.dirichlet_bc("upper_wall", value=0.0, component=1),
                self.dirichlet_bc("lower_wall_left_sf", value=0.0, component=1),
                self.dirichlet_bc("lower_wall_left_ns", value=(0.0, 0.0)),
                self.dirichlet_bc("lower_wall_right_ns", value=(0.0, 0.0)),
                self.dirichlet_bc("lower_wall_right_sf", value=0.0, component=1),
                self.dirichlet_bc("cavity_left", value=(0.0, 0.0)),
                self.dirichlet_bc("cavity_botm", value=(0.0, 0.0)),
                self.dirichlet_bc("cavity_right", value=(0.0, 0.0)),
            ],
            bcp=[],
        )

    def _default_steady_state_initial_guess(self) -> np.ndarray:
        """u=1 in the channel, u=0 inside the cavity
        (ref: cavityflowsolver.py:195-207)."""
        u = np.zeros((self.space.n_vnodes, 2))
        u[:, 0] = (self.space.vel_node_coords[:, 1] >= 0).astype(float)
        return u

    @classmethod
    def make_default(
        cls,
        Re: float = 7500,
        path_out=None,
        num_steps: int = 10,
        save_every: int = 0,
        Tstart: float = 0.0,
        verbose: int = 0,
        meshpath=None,
        mesh=None,
        mesh_kwargs: dict | None = None,
        **solver_kwargs,
    ) -> "CavityFlowSolver":
        """(ref: cavityflowsolver.py:209-280)"""
        if path_out is None:
            path_out = Path.cwd() / "data_output_cavity"
        params_flow = fsp.ParamFlow(Re=Re, uinf=1.0)
        params_flow.user_data.update({"L": 1.0, "D": 1.0})
        params_time = fsp.ParamTime(num_steps=num_steps, dt=0.0004, Tstart=Tstart)
        params_save = fsp.ParamSave(save_every=save_every, path_out=Path(path_out))
        params_solver = fsp.ParamSolver(
            **{**dict(throw_error=True, is_eq_nonlinear=True, shift=0.0),
               **solver_kwargs}
        )
        if mesh is None and meshpath is None:
            mesh = default_cavity_mesh(**(mesh_kwargs or {}))
        params_mesh = fsp.ParamMesh(meshpath=meshpath, mesh=mesh)
        params_mesh.user_data.update(
            {"xinf": 2.5, "xinfa": -1.2, "yinf": 0.5,
             "x0ns_left": -0.4, "x0ns_right": 1.75}
        )
        if mesh is not None:
            params_mesh.user_data.update(
                {
                    "xinf": float(mesh.coords[:, 0].max()),
                    "xinfa": float(mesh.coords[:, 0].min()),
                    "yinf": float(mesh.coords[:, 1].max()),
                }
            )
        params_control = fsp.ParamControl(
            sensor_list=[
                SensorHorizontalWallShear(
                    sensor_index=100, x_sensor_left=1.0, x_sensor_right=1.1,
                    y_sensor=0.0, sensor_type=SENSOR_TYPE.OTHER,
                ),
                SensorPoint(sensor_type=SENSOR_TYPE.U, position=np.array([0.1, 0.1])),
            ],
            actuator_list=[
                ActuatorForceGaussianV(sigma=0.0849, position=np.array([-0.1, 0.02])),
            ],
        )
        params_ic = fsp.ParamIC()
        return cls(
            params_flow=params_flow,
            params_time=params_time,
            params_save=params_save,
            params_solver=params_solver,
            params_mesh=params_mesh,
            params_control=params_control,
            params_ic=params_ic,
            verbose=verbose,
        )

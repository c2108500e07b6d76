"""flowcontrol_tpu — flow simulation and feedback control in JAX.

A from-scratch JAX/XLA framework with the capability surface of
williamjussiau/FlowControl (FEniCS/PETSc/MPI based): incompressible
Navier-Stokes in perturbation form around a steady base flow, Taylor-Hood
FEM on unstructured triangle meshes, BDF1/BDF2/Crank-Nicolson stepping,
Newton/Picard base-flow solvers, actuators/sensors/LTI controllers,
linearized operator export, eigenvalue/frequency-response analysis,
checkpoint/restart, controller synthesis (Youla/LQG/H∞), and batched
vmapped closed-loop rollouts on the GPU.

Public API mirrors the reference's ``flowcontrol`` package
(ref: src/flowcontrol/__init__.py:49-85).
"""

# numerical configuration first: x64, matmul precision, compile cache
from flowcontrol_tpu import config as _config  # noqa: F401

from flowcontrol_tpu.core.actuator import (
    ACTUATOR_TYPE,
    CYLINDER_ACTUATION_MODE,
    Actuator,
    ActuatorBC,
    ActuatorBCParabolicV,
    ActuatorBCRotation,
    ActuatorBCUniformU,
    ActuatorForceGaussianV,
)
from flowcontrol_tpu.core.controller import Controller
from flowcontrol_tpu.core.exporter import FlowExporter
from flowcontrol_tpu.core.flowfield import (
    BoundaryConditions,
    FlowField,
    FlowFieldCollection,
    SimPaths,
)
from flowcontrol_tpu.core.flowsolver import FlowSolver
from flowcontrol_tpu.core.flowsolverparameters import (
    ParamControl,
    ParamFlow,
    ParamIC,
    ParamMesh,
    ParamRestart,
    ParamSave,
    ParamSolver,
    ParamTime,
)
from flowcontrol_tpu.core.nsforms import NSForms
from flowcontrol_tpu.core.operatorgetter import OperatorGetter
from flowcontrol_tpu.core.sensor import (
    SENSOR_TYPE,
    Sensor,
    SensorHorizontalWallShear,
    SensorIntegral,
    SensorPoint,
)
from flowcontrol_tpu.core.steadystate import SteadyStateSolver
from flowcontrol_tpu.core.stepper import Stepper

__version__ = "0.1.0"

__all__ = [
    "ACTUATOR_TYPE",
    "CYLINDER_ACTUATION_MODE",
    "Actuator",
    "ActuatorBC",
    "ActuatorBCParabolicV",
    "ActuatorBCRotation",
    "ActuatorBCUniformU",
    "ActuatorForceGaussianV",
    "BoundaryConditions",
    "Controller",
    "FlowExporter",
    "FlowField",
    "FlowFieldCollection",
    "FlowSolver",
    "NSForms",
    "OperatorGetter",
    "ParamControl",
    "ParamFlow",
    "ParamIC",
    "ParamMesh",
    "ParamRestart",
    "ParamSave",
    "ParamSolver",
    "ParamTime",
    "SENSOR_TYPE",
    "Sensor",
    "SensorHorizontalWallShear",
    "SensorIntegral",
    "SensorPoint",
    "SimPaths",
    "SteadyStateSolver",
    "Stepper",
]

"""cfd-demo-jax: a 2D incompressible Navier-Stokes framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of TSultanov/cfd-demo
(staggered-grid PISO solver with upwind schemes, iterative pressure
projection, obstacles, tracer particles, meshing and rendering),
designed for an accelerator: pure pytree state, fused whole-array
stencils, lax.scan/while_loop iteration and sharding over device
meshes.
"""

from .core.config import (Box, Cylinder, FlowCase, Grid, InletProfile, PressureSolver,
                          Semantics, SimulationParams, SolverOptions,
                          VelocityScheme, cavity_grid, default_grid,
                          default_js_grid, solver_options_for)
from .core.state import State, init_state, set_params
from .solver.piso import (Scene, StepDiagnostics, make_run, make_scene,
                          make_step, piso_substep, step_fn)

__version__ = "0.1.0"

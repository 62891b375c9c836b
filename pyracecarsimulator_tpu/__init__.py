"""pyracecarsimulator_tpu: differentiable, batched 2D racecar simulator.

A JAX/XLA framework with the capabilities of felrock/PyRacecarSimulator
(see SURVEY.md): 1080-beam 2D lidar scan simulation against occupancy-grid
maps, single-track vehicle dynamics, TTC collision checking — rewritten so
thousands of cars step and scan in lockstep on one accelerator under
jit/vmap/shard_map, differentiable end-to-end.
"""

from .config import CarParams, ScanParams, SimParams
from .state import CarState, zero_state, state_from_pose
from .simulator import (RacecarSimulator, build_sim, make_step_fn,
                        make_scan_fn, StepOutput)

__version__ = "0.1.0"

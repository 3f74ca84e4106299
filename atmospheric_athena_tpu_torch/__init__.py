"""atmospheric_athena_tpu_torch — the PyTorch + CUDA port of
atmospheric_athena_tpu for one NVIDIA H100.

Same decks, same [nvar, Nz+2g, Ny+2g, Nx+2g] state and the same step order
as the JAX package, which stays the reference.  The fused TPU kernels of the
production ioniz_sphere step are hand-written CUDA C++ kernels (csrc/);
each has a plain PyTorch version beside it that runs on the CPU.
"""

from .config import GridConfig, SimConfig
from .par import ParameterDB
from .simulation import Simulation
from .state import State

__version__ = "0.1.0"
__all__ = ["GridConfig", "SimConfig", "ParameterDB", "Simulation", "State"]

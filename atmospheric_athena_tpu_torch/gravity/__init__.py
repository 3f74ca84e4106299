"""Self-gravity (``atmospheric_athena_tpu/gravity``): the FFT and
open-boundary Poisson solvers and the flux correction (selfg.py), the
multigrid solver (multigrid.py)."""

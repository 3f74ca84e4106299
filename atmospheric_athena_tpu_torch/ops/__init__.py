"""Numerical operators: eigensystems, reconstruction, Riemann solvers and
the hand-written GPU kernels with their plain PyTorch versions."""

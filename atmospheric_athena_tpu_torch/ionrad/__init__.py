"""Plane-parallel ionizing radiation: configuration, chemistry, the plane
sweep, the sub-cycle driver and its GPU kernels."""

"""Ionizing radiation: configuration, chemistry, the plane sweep, point
sources, the sub-cycle driver and its GPU kernels."""

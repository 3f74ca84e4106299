"""Utilities: div(B) diagnostics and vector-potential -> interface-field
initializers (reference: src/utils.c), as in
``atmospheric_athena_tpu/utils``."""

from .fields import compute_div_b, vecpot_to_b_interface

__all__ = ["compute_div_b", "vecpot_to_b_interface"]

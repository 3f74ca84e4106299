"""Utilities: leveled logging, div(B) diagnostics and vector-potential ->
interface-field initializers (reference: src/ath_log.c, src/utils.c), as in
``atmospheric_athena_tpu/utils``."""

from .log import ath_log_open, ath_log_set_level, ath_perr, ath_pout
from .fields import compute_div_b, vecpot_to_b_interface

__all__ = ["ath_pout", "ath_perr", "ath_log_set_level", "ath_log_open",
           "compute_div_b", "vecpot_to_b_interface"]

"""Leveled logging (reference: src/ath_log.c), as in
``atmospheric_athena_tpu/utils/log.py``.

`ath_pout(level, ...)` / `ath_perr(level, ...)` write to stdout/stderr (or
to <problem_id>.out/.err files after ath_log_open) when level <= the
configured out_level/err_level (ath_log.c:36, 245-290).  Level -1 always
prints (the reference's unconditional channel)."""

from __future__ import annotations

import sys
from typing import Optional, TextIO

_out_level = 0
_err_level = 0
_out_fp: Optional[TextIO] = None
_err_fp: Optional[TextIO] = None


def ath_log_set_level(out: int, err: int):
    """ath_log_set_level (ath_log.c:110-118)."""
    global _out_level, _err_level
    _out_level = out
    _err_level = err


def ath_log_open(basename: str, lazy: bool = False):
    """Redirect to <basename>.out / <basename>.err (ath_log.c:129-170;
    append mode so restarts keep the history, main.c:329-330)."""
    global _out_fp, _err_fp
    _out_fp = open(basename + ".out", "a")
    _err_fp = open(basename + ".err", "a")


def ath_log_close():
    global _out_fp, _err_fp
    for fp in (_out_fp, _err_fp):
        if fp is not None:
            fp.close()
    _out_fp = _err_fp = None


def ath_pout(level: int, msg: str, *args):
    if level <= _out_level or level < 0:
        fp = _out_fp or sys.stdout
        fp.write(msg % args if args else msg)
        fp.flush()


def ath_perr(level: int, msg: str, *args):
    if level <= _err_level or level < 0:
        fp = _err_fp or sys.stderr
        fp.write(msg % args if args else msg)
        fp.flush()

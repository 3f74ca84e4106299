"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so the
build takes seconds).  The library is built on first use into ``_build/``
beside this file, under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library never loads.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-fmad=false``.  No ``--use_fast_math``: approximate division, exp and log
and flushed denormals would break the float64 comparisons with the plain
versions.  ``-fmad=false`` turns off FMA contraction, so each kernel rounds
after every operation in the order of its plain version, as PyTorch's
one-operation-per-kernel path does; with contraction on, the Roe and PLM
sums differ from the plain version by up to ~3e-11 of a field's maximum in
float64, above the 1e-12 bar.

Nothing here runs at import time; ``lib()`` needs ``nvcc`` and a CUDA
driver, i.e. the machine with the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

# C signatures of the entry points (csrc/hydro.cu, csrc/rad.cu)
_SIGNATURES = {
    "ath_sweep_lrflux_f32": [_P] * 7 + [_I] * 5 + [_D, _D, _P],
    "ath_sweep_lrflux_f64": [_P] * 7 + [_I] * 5 + [_D, _D, _P],
    "ath_flux_pointwise_f32": [_P] * 4 + [_I] * 5 + [_D, _D, _P],
    "ath_flux_pointwise_f64": [_P] * 4 + [_I] * 5 + [_D, _D, _P],
    "ath_rad_rates_f32": [_P] * 14 + [_I, _I, _P, _P],
    "ath_rad_rates_f64": [_P] * 14 + [_I, _I, _P, _P],
    "ath_rad_update_f32": [_P] * 16 + [_L, _P, _P],
    "ath_rad_update_f64": [_P] * 16 + [_L, _P, _P],
    "ath_rad_rates_blocks": [_I],
    "ath_rad_update_blocks": [_L],
    "ath_rad_params_size": [],
    "ath_error_string": [_I],
}
_RESTYPES = {"ath_rad_update_blocks": _L,
             "ath_error_string": ctypes.c_char_p}

_lib = None


def nvcc() -> str:
    cand = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cand:
        p = Path(root) / "bin" / "nvcc"
        if root and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "CUDA kernels are built on the machine with the GPU")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libathena_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp_out),
               *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp_out, out)
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = _RESTYPES.get(name, _I)
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a non-zero cudaGetLastError()."""
    if err != 0:
        msg = lib().ath_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed, CUDA error "
                           f"{err} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def scalar_arg(v, like):
    """`v` (a float or 0-d tensor) as a 1-element tensor of `like`'s dtype
    on its device; the kernels read such scalars through a pointer, so a
    value computed on the device needs no read back to the host."""
    import torch
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(
        1).contiguous()

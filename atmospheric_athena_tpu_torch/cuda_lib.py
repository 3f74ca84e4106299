"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files are compiled by ``nvcc`` into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so the
build takes seconds): one ``nvcc -c`` per source, all started together,
then one link.  The library is built on first use into ``_build/``
beside this file, under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library never loads.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
-fmad=false -Xptxas -v``; ptxas's report of each kernel's registers and
spills is kept in ``build_log`` (source name -> text) when the library is
built.  No ``--use_fast_math``: approximate division, exp and log
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
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double

# C signatures of the entry points (csrc/hydro.cu, csrc/ctu_mid.cu,
# csrc/rad.cu, csrc/rad_batch.cu, csrc/bvals.cu, csrc/util.cu; B5 at orders
# other than 2 and for isothermal gas is built in csrc/hydro_*.cu behind
# ath_sweep_f32/f64, B12 and B13 for isothermal gas in csrc/flux_iso.cu)
_SIGNATURES = {
    "ath_sweep_f32": [_P] * 9 + [_I] * 13 + [_D, _D, _P],
    "ath_sweep_f64": [_P] * 9 + [_I] * 13 + [_D, _D, _P],
    "ath_flux_pointwise_f32": [_P] * 4 + [_I] * 7 + [_D, _D, _P],
    "ath_flux_pointwise_f64": [_P] * 4 + [_I] * 7 + [_D, _D, _P],
    "ath_flux_sweep_df_f32": [_P] * 5 + [_I] * 10 + [_D, _D, _P],
    "ath_flux_sweep_df_f64": [_P] * 5 + [_I] * 10 + [_D, _D, _P],
    "ath_march_info": [_I] * 12 + [_P],
    "ath_gcross_f32": [_P] * 10 + [_I] * 3 + [_P],
    "ath_gcross_f64": [_P] * 10 + [_I] * 3 + [_P],
    "ath_transverse_f32": [_P] * 12 + [_I] * 11 + [_D, _D, _P],
    "ath_transverse_f64": [_P] * 12 + [_I] * 11 + [_D, _D, _P],
    "ath_flux_corrected_f32": [_P] * 6 + [_I] * 7 + [_D, _D, _P],
    "ath_flux_corrected_f64": [_P] * 6 + [_I] * 7 + [_D, _D, _P],
    "ath_grav_source_f32": [_P] * 17 + [_I] * 3 + [_P],
    "ath_grav_source_f64": [_P] * 17 + [_I] * 3 + [_P],
    "ath_final_update_f32": [_P] * 10 + [_I] * 11 + [_P],
    "ath_final_update_f64": [_P] * 10 + [_I] * 11 + [_P],
    "ath_rad_rates_f32": [_P] * 15 + [_I] * 4 + [_P, _P],
    "ath_rad_rates_f64": [_P] * 15 + [_I] * 4 + [_P, _P],
    "ath_rad_fused_f32": [_P] * 26 + [_I, _I, _P, _P],
    "ath_rad_fused_f64": [_P] * 26 + [_I, _I, _P, _P],
    "ath_rad_update_f32": [_P] * 16 + [_L, _P, _P],
    "ath_rad_update_f64": [_P] * 16 + [_L, _P, _P],
    "ath_rad_batch_f32": [_P] * 21 + [_I] * 4 + [_P, _P],
    "ath_rad_batch_f64": [_P] * 21 + [_I] * 4 + [_P, _P],
    "ath_bc_fill_f32": [_P] * 2 + [_I] * 12 + [_P],
    "ath_bc_fill_f64": [_P] * 2 + [_I] * 12 + [_P],
    "ath_max_dti_f32": [_P] * 4 + [_I] * 12 + [_D] * 6 + [_P],
    "ath_max_dti_f64": [_P] * 4 + [_I] * 12 + [_D] * 6 + [_P],
    "ath_rad_rates_blocks": [_I, _I],
    "ath_rad_fused_blocks": [_I],
    "ath_rad_batch_blocks": [_I, _I],
    "ath_rad_update_blocks": [_L],
    "ath_rad_params_size": [],
    "ath_error_string": [_I],
}
_RESTYPES = {"ath_rad_update_blocks": _L,
             "ath_error_string": ctypes.c_char_p}

_lib = None
build_log = {}


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


def _run(cmds):
    """Run the commands in parallel; raise with the first failure's output.
    Returns each command's output (stdout and stderr)."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed, errs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        errs.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return errs


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in sorted(CSRC.glob("*.cu"))]
        errs = _run([[nvcc(), *NVCC_FLAGS, "-c", str(CSRC / f"{o.stem}.cu"),
                      "-o", str(o)] for o in objs])
        build_log.update({f"{o.stem}.cu": e for o, e in zip(objs, errs)})
        tmp_out = Path(tmp) / out.name
        _run([[nvcc(), "-shared", "-o", str(tmp_out), *map(str, objs)]])
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
    """`v` (a float or 0-d tensor, or a list of them) as a 1-D tensor of
    `like`'s dtype on its device; the kernels read such scalars through a
    pointer, so a value computed on the device needs no read back to the
    host."""
    import torch

    def one(x):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    if isinstance(v, (list, tuple)):
        return torch.stack([one(x).reshape(()) for x in v])
    return one(v).reshape(1).contiguous()

"""Legacy-VTK dumps (reference: src/dump_vtk.c:118-245, src/output_vtk.c),
as in ``atmospheric_athena_tpu/io/vtk.py`` and byte-compatible with it:
ASCII header `# vtk DataFile Version 2.0`, `CONSERVED vars at time= %e,
level= 0, domain= 0`, BINARY STRUCTURED_POINTS with DIMENSIONS = ncells+1
per active axis, ORIGIN = domain MinX, SPACING = dx, CELL_DATA, then
big-endian float32 fields: SCALARS density, VECTORS momentum|velocity,
SCALARS total_energy|pressure, [VECTORS cell_centered_B], SCALARS
[specific_]scalar[n].

The interior comes to the host in one copy; the float32 conversion and
the byte swap run there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..state import State, interior_numpy


def _be32(arr):
    return np.asarray(arr, ">f4")


def _write_scalar(fh, name, q):
    fh.write(f"SCALARS {name} float\n".encode())
    fh.write(b"LOOKUP_TABLE default\n")
    fh.write(_be32(q).tobytes())
    fh.write(b"\n")


def _write_vector(fh, name, qx, qy, qz):
    fh.write(f"VECTORS {name} float\n".encode())
    v = np.stack([qx, qy, qz], axis=-1)
    fh.write(_be32(v).tobytes())
    fh.write(b"\n")


def _header(fh, label, time, dims, grid: GridConfig, ncells):
    fh.write(b"# vtk DataFile Version 2.0\n")
    fh.write(f"{label} at time= {time:e}, level= 0, domain= 0\n".encode())
    fh.write(b"BINARY\n")
    fh.write(b"DATASET STRUCTURED_POINTS\n")
    fh.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n".encode())
    fh.write(f"ORIGIN {grid.xmin[0]:e} {grid.xmin[1]:e} "
             f"{grid.xmin[2]:e}\n".encode())
    fh.write(f"SPACING {grid.dx[0]:e} {grid.dx[1]:e} "
             f"{grid.dx[2]:e}\n".encode())
    fh.write(f"CELL_DATA {ncells}\n".encode())


def _grid_dims(grid: GridConfig):
    """DIMENSIONS of a whole-grid dump: cells + 1 per active axis, 2 per
    inactive one."""
    return [n + 1 if n > 1 else 2 for n in grid.Nx]


def dump_vtk(state: State, sim: SimConfig, grid: GridConfig, path: str,
             out: str = "cons"):
    """Write all variables ('cons' or 'prim') as a legacy VTK file."""
    U = interior_numpy(state.U, grid)
    time = float(state.time)
    dims = _grid_dims(grid)
    ncells = grid.Nx[0] * grid.Nx[1] * grid.Nx[2]
    with open(path, "wb") as fh:
        _header(fh, "CONSERVED vars" if out == "cons" else "PRIMITIVE vars",
                time, dims, grid, ncells)
        iscal = 5 if sim.adiabatic else 4
        if out == "cons":
            _write_scalar(fh, "density", U[ID])
            _write_vector(fh, "momentum", U[IM1], U[IM1 + 1], U[IM1 + 2])
            if sim.adiabatic:
                _write_scalar(fh, "total_energy", U[IEN])
        else:
            d1 = 1.0 / U[ID]
            _write_scalar(fh, "density", U[ID])
            _write_vector(fh, "velocity", U[IM1] * d1, U[IM1 + 1] * d1,
                          U[IM1 + 2] * d1)
            if sim.adiabatic:
                ke = 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2 +
                            U[IM1 + 2] ** 2) * d1
                P = (U[IEN] - ke) * sim.gamma_1
                if sim.mhd:
                    B = interior_numpy(state.Bcc, grid)
                    P = P - sim.gamma_1 * 0.5 * (B ** 2).sum(0)
                _write_scalar(fh, "pressure", P)
        if sim.mhd:
            B = interior_numpy(state.Bcc, grid)
            _write_vector(fh, "cell_centered_B", B[0], B[1], B[2])
        for n in range(sim.nscalars):
            q = U[iscal + n]
            if out == "prim":
                q = q / U[ID]
            _write_scalar(fh, f"specific_scalar[{n}]"
                          if out == "prim" else f"scalar[{n}]", q)


def dump_vtk_expr(q, grid: GridConfig, path: str, name: str, time):
    """Single derived-quantity VTK output (output_vtk.c analogue), e.g. the
    ioniz_sphere 'flux' user expression (EdgeFlux); `q` an [Nz, Ny, Nx]
    tensor or array (on a 2D or 1D grid, [Ny, Nx] or [Nx]), `time` a float
    or a 0-d tensor."""
    if isinstance(q, torch.Tensor):
        q = q.cpu().numpy()
    q = np.asarray(q)
    if q.ndim == 3:
        dims = [q.shape[2] + 1, q.shape[1] + 1, q.shape[0] + 1]
    else:
        # a whole 2D or 1D grid's expression, its inactive axes dropped by
        # formats.reduce_data: the dimensions of dump_vtk (the JAX writer
        # raises an IndexError here, ROADMAP C22)
        dims = _grid_dims(grid)
    with open(path, "wb") as fh:
        _header(fh, name, float(time), dims, grid, q.size)
        _write_scalar(fh, name, q)

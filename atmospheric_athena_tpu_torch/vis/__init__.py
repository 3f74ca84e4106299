"""Offline visualization readers, a copy of
``atmospheric_athena_tpu/vis/__init__.py`` (numpy only) — the Python
analogue of the
reference's vis/ tree (vis/matlab/ath_getvar.m & friends, vis/vtk/
join_vtk, vis/particle readers).  The reference ships MATLAB/IDL/sm
scripts that parse its outputs; here the same formats load into plain
numpy dicts, so any Python plotting stack replaces those toolchains.

Readers (all return {"time": float, ...fields: ndarray [Nz, Ny, Nx]}):
  read_vtk(path)   — legacy BINARY STRUCTURED_POINTS dumps (io/vtk.py,
                     byte-compatible with the reference's dump_vtk.c)
  read_bin(path)   — the reference's dump_binary.c layout (io/formats.py)
  read_tab(path)   — tab dumps incl. the header Time= line
  read_hst(path)   — history files -> dict of named columns

read_hst keeps a column name whole ("total E", "x1 Mom.", "scalar 0"); the
JAX reader cuts it at its first space, so "x1 Mom." becomes "x1" and the
scalars of a deck with several share one key (ROADMAP C21).
"""

from __future__ import annotations

import re

import numpy as np


def read_vtk(path: str):
    """Parse a legacy-VTK BINARY STRUCTURED_POINTS cell-data dump
    (vis/vtk/join_vtk.c:150-260 field layout): SCALARS are [Nz,Ny,Nx]
    big-endian float32, VECTORS are [Nz,Ny,Nx,3]."""
    out = {}
    with open(path, "rb") as fh:
        data = fh.read()
    # header lines up to CELL_DATA
    head_end = data.index(b"CELL_DATA")
    head = data[:head_end].decode("ascii", "replace")
    m = re.search(r"time=\s*([-0-9.eE+]+)", head)
    out["time"] = float(m.group(1)) if m else 0.0
    dims = [int(x) for x in
            re.search(r"DIMENSIONS (\d+) (\d+) (\d+)", head).groups()]
    nx, ny, nz = (max(d - 1, 1) for d in dims)
    out["origin"] = tuple(float(x) for x in
                          re.search(r"ORIGIN ([-0-9.eE+]+) ([-0-9.eE+]+)"
                                    r" ([-0-9.eE+]+)", head).groups())
    out["spacing"] = tuple(float(x) for x in
                           re.search(r"SPACING ([-0-9.eE+]+) ([-0-9.eE+]+)"
                                     r" ([-0-9.eE+]+)", head).groups())
    ncell = nx * ny * nz
    pos = data.index(b"\n", head_end) + 1
    while pos < len(data):
        eol = data.find(b"\n", pos)
        if eol < 0:
            break
        line = data[pos:eol].decode("ascii", "replace").strip()
        pos = eol + 1
        if not line:
            continue
        if line.startswith("SCALARS"):
            name = line.split()[1]
            # skip LOOKUP_TABLE line
            pos = data.find(b"\n", pos) + 1
            arr = np.frombuffer(data, ">f4", ncell, pos)
            out[name] = arr.reshape(nz, ny, nx).astype(np.float64)
            pos += 4 * ncell
        elif line.startswith("VECTORS"):
            name = line.split()[1]
            arr = np.frombuffer(data, ">f4", 3 * ncell, pos)
            out[name] = arr.reshape(nz, ny, nx, 3).astype(np.float64)
            pos += 12 * ncell
    return out


def read_bin(path: str):
    """Parse the reference dump_binary.c layout (vis/matlab readers):
    int32 coordsys; int32 [nx ny nz nvar nscalars selfg npart];
    2 float32 (gamma_1, cs | time, dt per branch); coords; var-major
    data.  Returns the stacked data plus coordinate arrays."""
    with open(path, "rb") as fh:
        coordsys = np.fromfile(fh, "<i4", 1)[0]
        nx, ny, nz, nvar, nscal, selfg, npart = np.fromfile(fh, "<i4", 7)
        g1, cs = np.fromfile(fh, "<f4", 2)
        time, dt = np.fromfile(fh, "<f4", 2)
        x1 = np.fromfile(fh, "<f4", nx)
        x2 = np.fromfile(fh, "<f4", ny)
        x3 = np.fromfile(fh, "<f4", nz)
        data = np.fromfile(fh, "<f4", nvar * nz * ny * nx)
    out = dict(coordsys=int(coordsys), time=float(time), dt=float(dt),
               nscalars=int(nscal), selfg=int(selfg),
               gamma_1=float(g1), iso_csound=float(cs),
               x1=x1.astype(np.float64), x2=x2.astype(np.float64),
               x3=x3.astype(np.float64),
               data=data.reshape(nvar, nz, ny, nx).astype(np.float64))
    names = ["d", "M1", "M2", "M3", "E"][:min(nvar, 5)]
    for i, n in enumerate(names):
        out[n] = out["data"][i]
    return out


def read_tab(path: str):
    """Tab dump -> {'time', 'data' [ncol, ...]} (output_tab.c format:
    leading index columns, then one column per variable)."""
    time = 0.0
    with open(path) as fh:
        for line in fh:
            if "Time=" in line:
                time = float(line.split("Time=")[1].split(",")[0])
                break
    a = np.loadtxt(path)
    return {"time": time, "data": a}


def read_hst(path: str):
    """History dump -> dict of named column arrays (dump_history.c
    header '#   [1]=time ...')."""
    names = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") and "]=" in line:
                names = [n.strip() for n in
                         re.split(r"\s+\[\d+\]=", line.rstrip())[1:]]
    a = np.atleast_2d(np.loadtxt(path))
    out = {}
    if names:
        for i, n in enumerate(names[:a.shape[1]]):
            out[n] = a[:, i]
    out["data"] = a
    return out

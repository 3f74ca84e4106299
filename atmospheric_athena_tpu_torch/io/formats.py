"""Derived-quantity expressions, slice/average reduction, and the tab /
binary / ppm / pgm / pdf output formats: a copy of
``atmospheric_athena_tpu/io/formats.py`` (numpy only) whose entry points
take the port's State and bring its interior to the host once, as numpy;
the files are the JAX package's byte for byte, MHD's B1c..B3c and ME
expressions and columns included.

Reference parity:
  - expressions  — src/output.c:1111-1250 (expr_d … expr_S) evaluated
    whole-grid instead of per-cell function pointers.
  - reduction    — OutData1/2/3 (src/output.c:629-930): axes named by an
    x1/x2/x3 range in the <outputN> block are sliced to [l, u] and
    averaged; remaining axes are kept.  Index selection mirrors the
    fc_pos walk at src/output.c:945-985.
  - dump_tab     — src/dump_tab.c:88-260: "# Nx1 =" headers, numbered
    column headers, i/j/k + x1/x2/x3 + all variables per row.
  - dump_binary  — src/dump_binary.c:40-215: coordsys int, ndata[7],
    (gamma_1, iso_cs), (t, dt), coordinate vectors, then NVAR fields in
    ConsS/PrimS memory order, all little-endian float32.
  - output_tab   — src/output_tab.c:43-260: index + value rows of the
    reduced single-variable data.
  - output_ppm   — src/output_ppm.c:17-142: "P6" + dmin/dmax comment +
    palette lookup with linear interpolation between the 256 entries.
  - output_pgm   — src/output_pgm.c:30-90: "P5", 8-bit grayscale.
  - output_pdf   — src/output_pdf.c:30-255: sqrt(N)-bin histogram with
    mean/variance/skewness/kurtosis header, .prb extension.

Palettes: the reference ships 7 hand-made 256-entry lookup tables
(src/palette.h).  We generate them procedurally from their documented
shapes (rainbow, step8/step32 = quantized rainbow, heat, idl1/idl2,
jh_colors); images are functionally equivalent but not byte-identical to
the reference's tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..state import interior_numpy


def as_numpy(q):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(q, torch.Tensor):
        return q.detach().cpu().numpy()
    return np.asarray(q)

# --------------------------------------------------------------------------
# derived expressions (src/output.c:1111-1250)
# --------------------------------------------------------------------------


#: the expressions the JAX package forms with the Newtonian conversion
SR_NEWTONIAN = ("V1", "V2", "V3", "P", "cs2", "S")


def _refuse_sr(what):
    raise NotImplementedError(
        f"{what} of an SR state (ROADMAP C43: the JAX package's prim "
        "outputs form V = M/d and P = Gamma_1 (E - M^2/2d), io/formats.py:"
        "43, 115, the Newtonian conversion, where the reference's SR "
        "dumps invert with Cons_to_Prim; cons outputs, d, M, E, B and the "
        "scalars are written)")


def _prim_pressure(U, Bcc, sim: SimConfig):
    if not sim.adiabatic:
        return U[ID] * sim.iso_csound2
    P = U[IEN] - 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2
                        + U[IM1 + 2] ** 2) / U[ID]
    if sim.mhd and Bcc is not None:
        P = P - 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)
    return sim.gamma_1 * P


def evaluate(name: str, state, sim: SimConfig, grid: GridConfig,
             problem=None):
    """Evaluate expression `name` over ACTIVE cells -> np.ndarray
    [Nz, Ny, Nx] (inactive axes size 1)."""
    if problem is not None:
        usr = getattr(problem, "get_usr_expr", lambda n: None)(name)
        if usr is not None:
            return as_numpy(usr(state, sim, grid))
    if sim.special_relativity and name in SR_NEWTONIAN:
        _refuse_sr(f"the output expression {name!r}")
    U = interior_numpy(state.U, grid)
    Bcc = None
    if sim.mhd and state.Bcc is not None:
        Bcc = interior_numpy(state.Bcc, grid)
    iscal = 5 if sim.adiabatic else 4
    simple = {"d": lambda: U[ID],
              "M1": lambda: U[IM1], "M2": lambda: U[IM1 + 1],
              "M3": lambda: U[IM1 + 2],
              "V1": lambda: U[IM1] / U[ID],
              "V2": lambda: U[IM1 + 1] / U[ID],
              "V3": lambda: U[IM1 + 2] / U[ID],
              "P": lambda: _prim_pressure(U, Bcc, sim)}
    if sim.adiabatic:
        simple["E"] = lambda: U[IEN]
        simple["cs2"] = lambda: (sim.gamma * _prim_pressure(U, Bcc, sim)
                                 / U[ID])
        simple["S"] = lambda: (_prim_pressure(U, Bcc, sim)
                               / U[ID] ** sim.gamma)
    if Bcc is not None:
        simple["B1c"] = lambda: Bcc[0]
        simple["B2c"] = lambda: Bcc[1]
        simple["B3c"] = lambda: Bcc[2]
        simple["ME"] = lambda: 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2
                                      + Bcc[2] ** 2)
    for n in range(sim.nscalars):
        simple[f"s{n}"] = (lambda n=n: U[iscal + n])
    if name not in simple:
        raise KeyError(f"unknown output expression '{name}' "
                       f"(valid: {sorted(simple)})")
    return np.asarray(simple[name]())


def stack_cons(state, sim: SimConfig, grid: GridConfig):
    """All conserved variables in ConsS memory order (athena.h:81-110):
    (d, M1, M2, M3, [E], [B1c, B2c, B3c], s...) over active cells."""
    U = interior_numpy(state.U, grid)
    iscal = 5 if sim.adiabatic else 4
    cols = [U[ID], U[IM1], U[IM1 + 1], U[IM1 + 2]]
    names = ["d", "M1", "M2", "M3"]
    if sim.adiabatic:
        cols.append(U[IEN])
        names.append("E")
    if sim.mhd and state.Bcc is not None:
        B = interior_numpy(state.Bcc, grid)
        cols += [B[0], B[1], B[2]]
        names += ["B1c", "B2c", "B3c"]
    for n in range(sim.nscalars):
        cols.append(U[iscal + n])
        names.append(f"s{n}")
    return np.stack(cols), names


def stack_prim(state, sim: SimConfig, grid: GridConfig):
    """PrimS memory order: (d, V1, V2, V3, [P], [B1c..], r...)."""
    if sim.special_relativity:
        _refuse_sr("a primitive-variable output")
    cons, _ = stack_cons(state, sim, grid)
    d = cons[0]
    cols = [d, cons[1] / d, cons[2] / d, cons[3] / d]
    names = ["d", "V1", "V2", "V3"]
    i = 4
    if sim.adiabatic:
        Bcc = cons[5:8] if sim.mhd else None
        cols.append(_prim_pressure(cons, Bcc, sim))
        names.append("P")
        i = 5
    if sim.mhd:
        cols += [cons[i], cons[i + 1], cons[i + 2]]
        names += ["B1c", "B2c", "B3c"]
        i += 3
    for n in range(sim.nscalars):
        cols.append(cons[i + n] / d)
        names.append(f"r{n}")
    return np.stack(cols), names


# --------------------------------------------------------------------------
# slice / average reduction (OutData1/2/3, src/output.c:629-930)
# --------------------------------------------------------------------------


def parse_slice(par, block: str, axname: str):
    """x1 = '5e3' | '5.3:10e4' | ':' | '5:' | ':10' (output.c parse_slice).
    Returns (l, u) or None if the key is absent."""
    if not par.exist(block, axname):
        return None
    expr = par.gets(block, axname)
    if ":" in expr:
        lo, hi = expr.split(":", 1)
        l = float(lo) if lo.strip() else -np.inf
        u = float(hi) if hi.strip() else np.inf
    else:
        l = u = float(expr)
    if l > u:
        raise ValueError(f"[parse_slice]: lower {l} > upper {u}")
    return (l, u)


def _range_indices(grid: GridConfig, axis: int, l, u):
    """Active-cell index range [start, end] for the slab [l, u], following
    the fc_pos walks of output.c:945-985 (cell containing l .. last cell
    whose left face <= u)."""
    N = grid.Nx[axis]
    if N == 1:
        return 0, 0
    faces = grid.xmin[axis] + np.arange(N + 1) * grid.dx[axis]
    if u < faces[0] or l >= faces[-1]:
        return None  # slice outside the domain -> no output (OutData3)
    start = max(0, int(np.searchsorted(faces, l, side="right")) - 1)
    end = min(N - 1, max(start,
                         int(np.searchsorted(faces, u, side="right")) - 1))
    return start, end


def reduce_data(q, grid: GridConfig, ranges):
    """Slice+average `q` [Nz, Ny, Nx] per the x1/x2/x3 ranges.

    ranges: {axis: (l, u)} for axes given in the block (reduce_xN=1).
    Returns (data, kept_axes) with reduced axes averaged out, or None if a
    slice misses the domain; kept_axes lists Athena axes in x1<x2<x3 order.
    """
    keep = []
    for axis in range(3):
        adim = 2 - axis
        if axis in ranges:
            r = _range_indices(grid, axis, *ranges[axis])
            if r is None:
                return None
            s, e = r
            q = q.take(np.arange(s, e + 1), axis=adim).mean(
                axis=adim, keepdims=True)
        elif grid.active(axis):
            keep.append(axis)
    # drop reduced + inactive axes; result dims ordered [x3][x2][x1]
    out = q.reshape([q.shape[2 - a] for a in (2, 1, 0) if a in keep])
    return out, keep


# --------------------------------------------------------------------------
# tab formats
# --------------------------------------------------------------------------


def dump_tab(path, state, sim: SimConfig, grid: GridConfig, out="cons",
             dat_fmt=None, level=0, domain=0):
    """All-variable table (dump_tab_cons/prim, src/dump_tab.c:88-260)."""
    fmt = " " + (dat_fmt or "%12.8e")
    data, names = (stack_prim if out == "prim" else stack_cons)(
        state, sim, grid)
    nmax = max(grid.Nx)
    zone_fmt = "%%%dd" % (2 + int(np.log10(nmax)))
    act = [grid.active(a) for a in range(3)]
    coords = [grid.cc_coords(a)[grid.lo(a):grid.hi(a) + 1] for a in range(3)]

    with open(path, "w") as f:
        for a in range(3):
            if act[a]:
                f.write("# Nx%d = %d\n" % (a + 1, grid.Nx[a]))
                f.write("# x%d-size = %g\n" % (a + 1,
                                               grid.Nx[a] * grid.dx[a]))
        f.write("# %s vars at Time= %g, level= %i, domain= %i\n" %
                ("CONSERVED" if out != "prim" else "PRIMITIVE",
                 float(state.time), level, domain))
        col = 1
        hdr = []
        # zone headers use the dimension thresholds of dump_tab.c:136-144
        for nm, cond in (("i-zone", True), ("j-zone", grid.Nx[1] > 2),
                         ("k-zone", grid.Nx[2] > 3)):
            if cond:
                hdr.append("[%d]=%s" % (col, nm))
                col += 1
        for nm, cond in (("x1", act[0]), ("x2", grid.Nx[1] > 2),
                         ("x3", grid.Nx[2] > 3)):
            if cond:
                hdr.append("[%d]=%s" % (col, nm))
                col += 1
        for nm in names:
            hdr.append("[%d]=%s" % (col, nm))
            col += 1
        f.write("# " + " ".join(hdr) + "\n")

        Nz, Ny, Nx = data.shape[1:]
        for k in range(Nz):
            for j in range(Ny):
                for i in range(Nx):
                    row = []
                    ijk = (i + grid.lo(0), j + grid.lo(1), k + grid.lo(2))
                    for a, idx in enumerate(ijk):
                        if act[a]:
                            row.append(zone_fmt % idx)
                    for a, idx in enumerate((i, j, k)):
                        if act[a]:
                            row.append(fmt % coords[a][idx])
                    row += [fmt % v for v in data[:, k, j, i]]
                    f.write("".join(row) + "\n")


def output_tab(path, data, kept_axes, dat_fmt=None):
    """Single-variable table of reduced data (output_tab_1d/2d/3d)."""
    fmt = " " + (dat_fmt or "%12.8e")
    with open(path, "w") as f:
        if data.ndim == 1:
            for i in range(data.shape[0]):
                f.write(fmt % float(i) + fmt % data[i] + "\n")
        elif data.ndim == 2:
            for j in range(data.shape[0]):
                for i in range(data.shape[1]):
                    f.write(fmt % float(i) + fmt % float(j)
                            + fmt % data[j, i] + "\n")
        else:
            for k in range(data.shape[0]):
                for j in range(data.shape[1]):
                    for i in range(data.shape[2]):
                        f.write(fmt % float(i) + fmt % float(j)
                                + fmt % float(k) + fmt % data[k, j, i]
                                + "\n")


# --------------------------------------------------------------------------
# binary dump (src/dump_binary.c:40-215)
# --------------------------------------------------------------------------


def dump_binary(path, state, sim: SimConfig, grid: GridConfig, out="cons",
                coordsys=-1):
    data, _ = (stack_prim if out == "prim" else stack_cons)(
        state, sim, grid)
    nvar = data.shape[0]
    with open(path, "wb") as f:
        np.asarray([coordsys], "<i4").tofile(f)
        np.asarray([grid.Nx[0], grid.Nx[1], grid.Nx[2], nvar, sim.nscalars,
                    1 if sim.self_gravity else 0, 0], "<i4").tofile(f)
        if sim.adiabatic:
            np.asarray([sim.gamma_1, 0.0], "<f4").tofile(f)
        else:
            np.asarray([0.0, sim.iso_csound], "<f4").tofile(f)
        np.asarray([float(state.time), float(state.dt)], "<f4").tofile(f)
        for a in range(3):
            cc = grid.cc_coords(a)[grid.lo(a):grid.hi(a) + 1]
            np.asarray(cc, "<f4").tofile(f)
        np.asarray(data, "<f4").tofile(f)  # [nvar][k][j][i], var-major


# --------------------------------------------------------------------------
# images: palettes + ppm/pgm
# --------------------------------------------------------------------------


def _rainbow_rgb(x):
    """Blue->cyan->green->yellow->red rainbow over x in [0,1]."""
    h = (1.0 - np.asarray(x)) * (2.0 / 3.0)  # hue: blue(2/3) -> red(0)
    i = np.floor(h * 6.0).astype(int) % 6
    fr = h * 6.0 - np.floor(h * 6.0)
    r = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [1.0, 1.0 - fr, 0.0, 0.0, fr, 1.0])
    g = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [fr, 1.0, 1.0, 1.0 - fr, 0.0, 0.0])
    b = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                  [0.0, 0.0, fr, 1.0, 1.0, 1.0 - fr])
    return np.stack([r, g, b], -1)


def _make_palettes():
    x = np.linspace(0.0, 1.0, 256)
    pal = {}
    pal["rainbow"] = _rainbow_rgb(x)
    pal["step8"] = _rainbow_rgb(np.floor(x * 8) / 7.0)
    pal["step32"] = _rainbow_rgb(np.floor(x * 32) / 31.0)
    # heat: black -> red -> white
    pal["heat"] = np.stack([np.clip(2 * x, 0, 1),
                            np.clip(2 * x - 1, 0, 1),
                            np.clip(2 * x - 1, 0, 1)], -1)
    # jh_colors: blue -> gray -> red diverging (John Hawley's table)
    lo = np.array([0.0, 0.0, 0.5])
    mid = np.array([0.5, 0.5, 0.5])
    hi = np.array([0.5, 0.0, 0.0])
    t = x[:, None]
    pal["jh_colors"] = np.where(
        t < 0.5, lo + (mid - lo) * (2 * t), mid + (hi - mid) * (2 * t - 1))
    # idl1: black -> blue -> red; idl2: black-blue-red-black
    pal["idl1"] = np.stack([np.clip(2 * x - 1, 0, 1),
                            np.zeros_like(x),
                            np.clip(2 * x, 0, 1)
                            - np.clip(2 * x - 1, 0, 1)], -1)
    seg = np.clip
    pal["idl2"] = np.stack([seg(3 * x - 1, 0, 1) - seg(3 * x - 2, 0, 1),
                            np.zeros_like(x),
                            seg(3 * x, 0, 1) - seg(3 * x - 1, 0, 1)], -1)
    return {k: np.asarray(v, np.float32) for k, v in pal.items()}


PALETTES = _make_palettes()


def _to_rgb(data2d, dmin, dmax, rgb):
    """compute_rgb (output_ppm.c:96-142): 0..255 index + linear interp."""
    if dmax == dmin:
        g = (data2d > dmax).astype(np.uint8) * 255
        return np.stack([g, g, g], -1)
    x = (data2d - dmin) * 255.0 / (dmax - dmin)
    i = np.clip(x.astype(int), 0, 255)
    lo = np.clip(x, 0.0, 255.0)
    der = np.concatenate([rgb[1:] - rgb[:-1], np.zeros((1, 3), rgb.dtype)])
    out = (rgb[i] + (lo - i)[..., None] * der[i]) * 255.0
    oob = (x <= 0.0) | (x >= 255.0)
    edge = rgb[np.where(x <= 0.0, 0, 255)] * 255.0
    out = np.where(oob[..., None], edge, out)
    return out.astype(np.uint8)


def output_ppm(path, data, dmin=None, dmax=None, palette="rainbow",
               gmin=np.inf, gmax=-np.inf):
    """P6 color image of 2D data (output_ppm.c:17-95).  Returns updated
    (gmin, gmax) running global extrema."""
    amin, amax = float(data.min()), float(data.max())
    gmin, gmax = min(gmin, amin), max(gmax, amax)
    lo = amin if dmin is None else dmin
    hi = amax if dmax is None else dmax
    rgb = PALETTES[palette]
    ny, nx = data.shape
    with open(path, "wb") as f:
        f.write(b"P6\n")
        f.write(("# dmin= %.7e, dmax= %.7e, gmin= %.7e, gmax= %.7e\n" %
                 (amin, amax, gmin, gmax)).encode())
        f.write(("%d %d\n255\n" % (nx, ny)).encode())
        img = _to_rgb(data[::-1], lo, hi, rgb)  # rows written top=max-y
        f.write(img.tobytes())
    return gmin, gmax


def output_pgm(path, data, dmin=None, dmax=None, gmin=np.inf, gmax=-np.inf):
    """P5 grayscale image (output_pgm.c:30-90)."""
    amin, amax = float(data.min()), float(data.max())
    gmin, gmax = min(gmin, amin), max(gmax, amax)
    lo = amin if dmin is None else dmin
    hi = amax if dmax is None else dmax
    ny, nx = data.shape
    span = (hi - lo) * (1.0 + np.finfo(np.float32).eps)
    with open(path, "wb") as f:
        f.write(("P5\n%d %d\n255\n" % (nx, ny)).encode())
        if span > 0:
            gray = np.clip(256.0 / span * (data[::-1] - lo),
                           0, 255).astype(np.uint8)
        else:
            gray = np.zeros((ny, nx), np.uint8)
        f.write(gray.tobytes())
    return gmin, gmax


# --------------------------------------------------------------------------
# pdf (distribution function, src/output_pdf.c; .prb extension)
# --------------------------------------------------------------------------


def output_pdf(path, q, time, out_name, dat_fmt=None):
    data = np.asarray(q, np.float64).ravel()
    n = data.size
    dmin, dmax = data.min(), data.max()
    mean = data.mean()
    size_pdf = int(np.sqrt(n))
    var = adev = sdev = skew = kurt = 0.0
    if n > 1:
        s = data - mean
        adev = np.abs(s).mean()
        ep = s.sum()
        var = (np.sum(s ** 2) - ep * ep / n) / (n - 1)
        sdev = np.sqrt(var)
        if sdev > 0:
            skew = np.sum(s ** 3) / (var * sdev * n)
            kurt = np.sum(s ** 4) / (var * var * n) - 3.0
    fmt = dat_fmt or "%21.15e"
    with open(path, "w") as f:
        f.write("# Time = %21.15e\n" % time)
        f.write('# expr = "%s"\n' % out_name)
        f.write("# Nbin = %d\n" % (size_pdf if dmax > dmin else 1))
        f.write("# dmin = %21.15e\n" % dmin)
        f.write("# dmax = %21.15e\n" % dmax)
        f.write("# mean = %21.15e\n" % mean)
        f.write("# variance = %21.15e\n" % var)
        f.write("# std. dev. = %21.15e\n" % sdev)
        f.write("# avg. dev. = %21.15e\n" % adev)
        f.write("# skewness = %21.15e\n" % skew)
        f.write("# kurtosis = %21.15e\n#\n" % kurt)
        if dmax > dmin:
            scl = size_pdf / (dmax - dmin)
            idx = np.minimum((scl * (data - dmin)).astype(int), size_pdf - 1)
            pdf = np.bincount(idx, minlength=size_pdf)
            delta = (dmax - dmin) / size_pdf
            norm = size_pdf / (n * (dmax - dmin))
            for b in range(size_pdf):
                f.write((fmt + "  " + fmt + "\n") %
                        (dmin + (b + 0.5) * delta, pdf[b] * norm))
        else:
            f.write((fmt + "  " + fmt + "\n") % (dmax, 1.0))

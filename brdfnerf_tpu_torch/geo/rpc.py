"""RPC (rational polynomial coefficient) satellite camera model: the
port's copy of the JAX package's geo/rpc.py.

  * projection_np   : (lon, lat, alt) -> (col, row), direct rational polys
  * localization_np : (col, row, alt) -> (lon, lat), Newton inversion with
    the analytic 2x2 Jacobian
  * projection, localization_normalized, localization: the same on torch
    tensors, on their device and in their dtype (the JAX package's
    batched device functions), 12 Newton iterations by default

Polynomial term ordering and normalization follow the standard RPC00B
convention used by rpcm's `apply_poly` (x=nlat, y=nlon, z=nalt), so RPC
dicts written by the reference's generate_dataset.py (its per-image JSON
"rpc" field, generate_dataset.py:152-163) are consumed unchanged.  The JAX
package dispatches large batches to a native C++ kernel; the port runs
the NumPy bodies, which are that kernel's source of truth (ROADMAP.md
Queue 1 item 7).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RPCModel(NamedTuple):
    """All fields are float64 scalars except the four (20,) coefficient
    vectors."""

    row_offset: np.ndarray
    col_offset: np.ndarray
    lat_offset: np.ndarray
    lon_offset: np.ndarray
    alt_offset: np.ndarray
    row_scale: np.ndarray
    col_scale: np.ndarray
    lat_scale: np.ndarray
    lon_scale: np.ndarray
    alt_scale: np.ndarray
    row_num: np.ndarray
    row_den: np.ndarray
    col_num: np.ndarray
    col_den: np.ndarray


def rpc_from_dict(d: dict) -> RPCModel:
    """Build from an rpcm-format dict (the JSON "rpc" field).

    Fields are kept as FLOAT64 NumPy arrays: the host-side paths (ray
    ingestion, DSM tooling) need full precision — an f32-quantized
    lat/lon offset shifts an image's georeference by up to ~0.4 m,
    independently per view."""

    def arr(k):
        return np.asarray(d[k], dtype=np.float64)
    return RPCModel(
        row_offset=arr("row_offset"), col_offset=arr("col_offset"),
        lat_offset=arr("lat_offset"), lon_offset=arr("lon_offset"),
        alt_offset=arr("alt_offset"),
        row_scale=arr("row_scale"), col_scale=arr("col_scale"),
        lat_scale=arr("lat_scale"), lon_scale=arr("lon_scale"),
        alt_scale=arr("alt_scale"),
        row_num=arr("row_num"), row_den=arr("row_den"),
        col_num=arr("col_num"), col_den=arr("col_den"),
    )


_RPC00B_FIELD_MAP = {
    # RPC00B / IKONOS-sidecar field -> rpcm-style dict key.  LINE = image
    # row, SAMP = image column; LONG = longitude (the spec's 'L' poly
    # variable), LAT = latitude ('P'), HEIGHT = altitude ('H').
    "LINE_OFF": "row_offset", "SAMP_OFF": "col_offset",
    "LAT_OFF": "lat_offset", "LONG_OFF": "lon_offset",
    "HEIGHT_OFF": "alt_offset",
    "LINE_SCALE": "row_scale", "SAMP_SCALE": "col_scale",
    "LAT_SCALE": "lat_scale", "LONG_SCALE": "lon_scale",
    "HEIGHT_SCALE": "alt_scale",
}
_RPC00B_COEFF_MAP = {
    "LINE_NUM_COEFF": "row_num", "LINE_DEN_COEFF": "row_den",
    "SAMP_NUM_COEFF": "col_num", "SAMP_DEN_COEFF": "col_den",
}


def rpc_dict_from_rpc00b_text(text: str) -> dict:
    """Parse the `_RPC.TXT` sidecar format (IKONOS/WorldView/GeoEye
    vendor products; what rpcm's rpc_from_rpc_file reads) into the
    rpcm-style dict `rpc_from_dict` consumes.

    Lines look like `LINE_OFF: +002486.00 pixels` and
    `LINE_NUM_COEFF_1: +1.154810E-03`; trailing unit words and arbitrary
    whitespace are ignored, keys are case-insensitive, and the 20
    coefficients of each polynomial may appear in any order (indexed by
    their _j suffix, 1-based as in the spec)."""
    scalars: dict = {}
    coeffs = {k: [None] * 20 for k in _RPC00B_COEFF_MAP}
    for line in text.splitlines():
        line = line.strip()
        if not line or ":" not in line:
            continue
        key, _, rest = line.partition(":")
        key = key.strip().upper()
        tok = rest.split()
        if not tok:
            continue
        try:
            val = float(tok[0])
        except ValueError:
            continue
        if key in _RPC00B_FIELD_MAP:
            scalars[_RPC00B_FIELD_MAP[key]] = val
        else:
            base, _, idx = key.rpartition("_")
            if base in _RPC00B_COEFF_MAP and idx.isdigit():
                j = int(idx)
                if 1 <= j <= 20:
                    coeffs[base][j - 1] = val
    missing = [k for k in _RPC00B_FIELD_MAP.values() if k not in scalars]
    for base, vals in coeffs.items():
        holes = [j + 1 for j, v in enumerate(vals) if v is None]
        if holes:
            missing.append(f"{base}_{{{holes[0]}..}}")
    if missing:
        raise ValueError(f"RPC00B sidecar is missing fields: {missing}")
    d = dict(scalars)
    for base, key in _RPC00B_COEFF_MAP.items():
        d[key] = [float(v) for v in coeffs[base]]
    return d


def rpc_dict_from_dimap_xml(path: str) -> dict:
    """Parse a Pléiades/SPOT DIMAP v2 RPC XML (`RPC_*.XML` shipped next to
    the imagery) into the rpcm-style dict.

    Uses the Inverse_Model (ground -> image) coefficients — the direction
    the RPC00B rational polynomials define — plus the RFM_Validity
    offsets/scales.  DIMAP pixel indices are 1-based (first pixel centre
    is (1, 1)); like rpcm's DIMAP loader, LINE_OFF/SAMP_OFF are shifted by
    -1 so projections land in the 0-based pixel grid the datasets use."""
    import xml.etree.ElementTree as ET
    root = ET.parse(path).getroot()

    def find_val(tag):
        el = root.find(f".//{tag}")
        if el is None or el.text is None:
            raise ValueError(f"{path}: DIMAP RPC missing <{tag}>")
        return float(el.text)

    d = {}
    for f, key in _RPC00B_FIELD_MAP.items():
        d[key] = find_val(f)
    d["row_offset"] -= 1.0
    d["col_offset"] -= 1.0
    # Inverse_Model holds SAMP_/LINE_ coefficient tags; scope the search
    # under it when present (some products also carry a Direct_Model with
    # clashing-free names LON_/LAT_, but be defensive)
    scope = root.find(".//Inverse_Model")
    scope = scope if scope is not None else root
    for base, key in _RPC00B_COEFF_MAP.items():
        vals = []
        for j in range(1, 21):
            el = scope.find(f".//{base}_{j}")
            if el is None or el.text is None:
                raise ValueError(f"{path}: DIMAP RPC missing <{base}_{j}>")
            vals.append(float(el.text))
        d[key] = vals
    return d


def rpc_dict_from_geotiff(path: str) -> dict:
    """Read the RPC coefficient tag (50844) embedded in a GeoTIFF, as
    vendor products carry it (the reference reads these via
    rpcm.rpc_from_geotiff, generate_dataset.py:152-163).  Parses the IFD
    only — pixel data is not decoded."""
    from ..utils.geotiff import read_tiff_header, _rpc_dict_from_tag, _T_RPC
    with open(path, "rb") as f:
        buf = f.read()
    _, tags = read_tiff_header(path, buf)
    if _T_RPC not in tags:
        raise ValueError(f"{path}: no RPC coefficient tag (50844)")
    return _rpc_dict_from_tag(tags[_T_RPC])


def rescale_rpc(rpc: RPCModel, alpha: float) -> RPCModel:
    """Scale for an image resize by factor alpha (sat_utils.py:90-108)."""
    return rpc._replace(
        row_scale=rpc.row_scale * alpha, col_scale=rpc.col_scale * alpha,
        row_offset=rpc.row_offset * alpha, col_offset=rpc.col_offset * alpha)


def _poly20(c, x, y, z):
    """The RPC00B cubic polynomial; x=nlat, y=nlon, z=nalt.  Only + and *,
    so one body serves NumPy arrays and tensors alike (c indexable: a
    float64 array, or a tensor in the points' dtype and device)."""
    return (c[0]
            + c[1] * y + c[2] * x + c[3] * z
            + c[4] * y * x + c[5] * y * z + c[6] * x * z
            + c[7] * y * y + c[8] * x * x + c[9] * z * z
            + c[10] * x * y * z
            + c[11] * y * y * y
            + c[12] * y * x * x + c[13] * y * z * z + c[14] * y * y * x
            + c[15] * x * x * x
            + c[16] * x * z * z + c[17] * y * y * z + c[18] * x * x * z
            + c[19] * z * z * z)


def _poly20_grad(c, x, y, z):
    """(d/dx, d/dy) of _poly20 (x = nlat, y = nlon), on arrays or
    tensors as _poly20."""
    dx = (c[2] + c[4] * y + c[6] * z + 2.0 * c[8] * x + c[10] * y * z
          + 2.0 * c[12] * y * x + c[14] * y * y + 3.0 * c[15] * x * x
          + c[16] * z * z + 2.0 * c[18] * x * z)
    dy = (c[1] + c[4] * x + c[5] * z + 2.0 * c[7] * y + c[10] * x * z
          + 3.0 * c[11] * y * y + c[12] * x * x + c[13] * z * z
          + 2.0 * c[14] * y * x + c[17] * 2.0 * y * z)
    return dx, dy


def _monomials20_np(x, y, z):
    """(P, 20) float64 monomial design matrix in _poly20's term order.

    The host hot paths (`localization_np`, `projection_np`) evaluate the
    four rational polynomials of an RPC as ONE (P,20)@(20,4) GEMM over
    this matrix instead of ~40 elementwise numpy temporaries per poly —
    the ingestion profile is memory-traffic-bound, and BLAS turns it into
    a single multithreaded pass (measured ~5x on the Newton loop)."""
    x = np.ascontiguousarray(x, np.float64).ravel()
    y = np.ascontiguousarray(y, np.float64).ravel()
    z = np.ascontiguousarray(z, np.float64).ravel()
    # stored transposed — (20, P) with CONTIGUOUS rows — because strided
    # writes into the columns of a (P, 20) array are ~3x slower at image
    # scale; BLAS consumes the .T view natively (op(A) in dgemm)
    m = np.empty((20, x.shape[0]), np.float64)
    m[0] = 1.0
    m[1] = y
    m[2] = x
    m[3] = z
    np.multiply(y, x, out=m[4])
    np.multiply(y, z, out=m[5])
    np.multiply(x, z, out=m[6])
    np.multiply(y, y, out=m[7])
    np.multiply(x, x, out=m[8])
    np.multiply(z, z, out=m[9])
    np.multiply(m[4], z, out=m[10])   # xyz
    np.multiply(m[7], y, out=m[11])   # y^3
    np.multiply(m[8], y, out=m[12])   # y x^2
    np.multiply(m[9], y, out=m[13])   # y z^2
    np.multiply(m[7], x, out=m[14])   # y^2 x
    np.multiply(m[8], x, out=m[15])   # x^3
    np.multiply(m[9], x, out=m[16])   # x z^2
    np.multiply(m[7], z, out=m[17])   # y^2 z
    np.multiply(m[8], z, out=m[18])   # x^2 z
    np.multiply(m[9], z, out=m[19])   # z^3
    return m.T


def _deriv_coeff_np(c):
    """(10, 2) coefficient matrix giving [d/dx, d/dy] of a 20-term RPC00B
    cubic over the quadratic monomial basis — the FIRST TEN columns of
    `_monomials20_np` ([1, y, x, z, xy, yz, xz, y², x², z²]).  The same
    design-matrix prefix therefore evaluates every Jacobian entry of the
    Newton solve by GEMM (matches `_poly20_grad`)."""
    c = np.asarray(c, np.float64)
    dx = np.array([c[2], c[4], 2 * c[8], c[6], 2 * c[12], c[10],
                   2 * c[18], c[14], 3 * c[15], c[16]], np.float64)
    dy = np.array([c[1], 2 * c[7], c[4], c[5], 2 * c[14], 2 * c[17],
                   c[10], 3 * c[11], c[12], c[13]], np.float64)
    return np.stack([dx, dy], axis=-1)


def projection_np(rpc: RPCModel, lon, lat, alt):
    """Float64 host-side projection (dataset ingestion / DSM eval paths,
    where |UTM| ~ 5e6 m exceeds float32; matches rpcm.projection)."""
    lon = np.asarray(lon, np.float64)
    lat = np.asarray(lat, np.float64)
    alt = np.asarray(alt, np.float64)
    shape = np.broadcast_shapes(lon.shape, lat.shape, alt.shape)
    nlon = np.broadcast_to(
        (lon - float(rpc.lon_offset)) / float(rpc.lon_scale), shape)
    nlat = np.broadcast_to(
        (lat - float(rpc.lat_offset)) / float(rpc.lat_scale), shape)
    nalt = np.broadcast_to(
        (alt - float(rpc.alt_offset)) / float(rpc.alt_scale), shape)
    coeff = np.stack([np.asarray(rpc.col_num, np.float64),
                      np.asarray(rpc.col_den, np.float64),
                      np.asarray(rpc.row_num, np.float64),
                      np.asarray(rpc.row_den, np.float64)], axis=-1)
    vals = _monomials20_np(nlat, nlon, nalt) @ coeff   # (P, 4)
    ncol = (vals[:, 0] / vals[:, 1]).reshape(shape)
    nrow = (vals[:, 2] / vals[:, 3]).reshape(shape)
    return (ncol * float(rpc.col_scale) + float(rpc.col_offset),
            nrow * float(rpc.row_scale) + float(rpc.row_offset))


def localization_np(rpc: RPCModel, col, row, alt, iters: int = 20,
                    tol: float = 1e-12, block: int = 4096):
    """Float64 host-side inverse RPC: (col, row, alt) -> (lon, lat) degrees.

    Vectorized Newton with the analytic 2x2 Jacobian of the rational
    polynomials; replaces rpcm.localization in the ingestion hot loop
    (satellite_rgb_dep.py:46-61 semantics) at sub-1e-9 normalized
    accuracy.  Inputs are processed in `block`-point slices so the
    monomial design matrix and the iteration's temporaries stay
    cache-resident, and each block early-exits on its own convergence.
    """
    # mutual broadcast BEFORE the block split: scalar row/alt against a
    # large col must not slice a size-1 array into empty blocks
    bshape = np.broadcast_shapes(np.shape(col), np.shape(row), np.shape(alt))
    col = np.atleast_1d(np.broadcast_to(np.asarray(col, np.float64), bshape))
    row = np.atleast_1d(np.broadcast_to(np.asarray(row, np.float64), bshape))
    alt = np.atleast_1d(np.broadcast_to(np.asarray(alt, np.float64), bshape))
    if col.size > block:
        c, r, a = col.ravel(), row.ravel(), alt.ravel()
        lon = np.empty_like(c)
        lat = np.empty_like(c)
        for i in range(0, c.size, block):
            s = slice(i, i + block)
            lon[s], lat[s] = localization_np(rpc, c[s], r[s], a[s],
                                             iters=iters, tol=tol)
        return lon.reshape(col.shape), lat.reshape(col.shape)
    tc = (col - float(rpc.col_offset)) / float(rpc.col_scale)
    tr = (row - float(rpc.row_offset)) / float(rpc.row_scale)
    z = (alt - float(rpc.alt_offset)) / float(rpc.alt_scale)

    cn = np.asarray(rpc.col_num, np.float64)
    cd = np.asarray(rpc.col_den, np.float64)
    rn = np.asarray(rpc.row_num, np.float64)
    rd = np.asarray(rpc.row_den, np.float64)
    # (20, 4) value + (10, 8) Jacobian coefficient matrices: each Newton
    # iteration is then two GEMMs over one monomial design matrix instead
    # of ~180 elementwise numpy temporaries (memory-bound at image scale)
    coeff = np.stack([cn, cd, rn, rd], axis=-1)
    dcoeff = np.concatenate([_deriv_coeff_np(c) for c in (cn, cd, rn, rd)],
                            axis=-1)   # columns: [cx cy] per poly

    shape = tc.shape
    tc, tr, z = tc.ravel(), tr.ravel(), z.ravel()
    x = np.zeros_like(tc)   # nlat
    y = np.zeros_like(tc)   # nlon
    for _ in range(iters):
        m = _monomials20_np(x, y, z)
        vals = m @ coeff                      # (P, 4): ncn ncd nrn nrd
        ncn, ncd, nrn, nrd = vals.T
        dv = m[:, :10] @ dcoeff               # (P, 8): d{cn,cd,rn,rd}/dx,dy
        fc = ncn / ncd - tc
        fr = nrn / nrd - tr
        # quotient-rule Jacobian entries
        j_cx = (dv[:, 0] * ncd - ncn * dv[:, 2]) / (ncd * ncd)
        j_cy = (dv[:, 1] * ncd - ncn * dv[:, 3]) / (ncd * ncd)
        j_rx = (dv[:, 4] * nrd - nrn * dv[:, 6]) / (nrd * nrd)
        j_ry = (dv[:, 5] * nrd - nrn * dv[:, 7]) / (nrd * nrd)
        det = j_cy * j_rx - j_cx * j_ry
        det = np.where(np.abs(det) < 1e-30, 1e-30, det)
        dy = (fc * j_rx - fr * j_cx) / det   # nlon update
        dx = (fr * j_cy - fc * j_ry) / det   # nlat update
        y = y - dy
        x = x - dx
        if max(np.max(np.abs(dy)), np.max(np.abs(dx))) < tol:
            break
    x, y = x.reshape(shape), y.reshape(shape)
    lon = y * float(rpc.lon_scale) + float(rpc.lon_offset)
    lat = x * float(rpc.lat_scale) + float(rpc.lat_offset)
    return lon, lat


# ------------------------------------------------------- torch, batched

def _coeffs(c, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(c, np.float64), dtype=like.dtype,
                           device=like.device)


def _tensors(*xs):
    """The arguments as tensors of one floating dtype on one device,
    broadcast together: as torch promotes, tensors with dimensions decide
    over scalars and 0-d tensors."""
    ts = [torch.as_tensor(x) for x in xs]
    lead = [t for t in ts if t.dim()] or ts
    dtype = lead[0].dtype
    for t in lead[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if not dtype.is_floating_point:
        dtype = torch.get_default_dtype()
    device = lead[0].device
    return torch.broadcast_tensors(*[t.to(device=device, dtype=dtype)
                                     for t in ts])


def projection(rpc: RPCModel, lon, lat, alt):
    """Ground (deg, deg, m) -> image (col, row) on tensors, broadcast
    together; the coefficients in the tensors' dtype, on their device."""
    lon, lat, alt = _tensors(lon, lat, alt)
    nlon = (lon - float(rpc.lon_offset)) / float(rpc.lon_scale)
    nlat = (lat - float(rpc.lat_offset)) / float(rpc.lat_scale)
    nalt = (alt - float(rpc.alt_offset)) / float(rpc.alt_scale)
    c = [_coeffs(k, lon) for k in (rpc.col_num, rpc.col_den, rpc.row_num,
                                   rpc.row_den)]
    ncol = _poly20(c[0], nlat, nlon, nalt) / _poly20(c[1], nlat, nlon, nalt)
    nrow = _poly20(c[2], nlat, nlon, nalt) / _poly20(c[3], nlat, nlon, nalt)
    return (ncol * float(rpc.col_scale) + float(rpc.col_offset),
            nrow * float(rpc.row_scale) + float(rpc.row_offset))


def localization_normalized(rpc: RPCModel, col, row, alt, iters: int = 12):
    """Image (col, row) at altitude alt (m) -> NORMALIZED ground (nlon,
    nlat) on tensors: Newton from (0, 0), iters steps, the 2x2 Jacobian
    from the polynomials' analytic derivatives.  In float32 this is the
    accurate interface (absolute float32 degrees quantize to ~0.5 px at a
    full Pleiades scene's scale, as the JAX package's docstring says)."""
    col, row, alt = _tensors(col, row, alt)
    tc = (col - float(rpc.col_offset)) / float(rpc.col_scale)
    tr = (row - float(rpc.row_offset)) / float(rpc.row_scale)
    z = (alt - float(rpc.alt_offset)) / float(rpc.alt_scale)
    cn, cd, rn, rd = (_coeffs(k, col) for k in (
        rpc.col_num, rpc.col_den, rpc.row_num, rpc.row_den))
    y = torch.zeros_like(tc)                       # nlon
    x = torch.zeros_like(tc)                       # nlat
    for _ in range(iters):
        vals = [_poly20(k, x, y, z) for k in (cn, cd, rn, rd)]
        grads = [_poly20_grad(k, x, y, z) for k in (cn, cd, rn, rd)]
        (a, b), (da, db) = vals[:2], grads[:2]
        cx = (da[0] * b - a * db[0]) / (b * b)     # d col / d nlat
        cy = (da[1] * b - a * db[1]) / (b * b)     # d col / d nlon
        (a, b), (da, db) = vals[2:], grads[2:]
        rx = (da[0] * b - a * db[0]) / (b * b)
        ry = (da[1] * b - a * db[1]) / (b * b)
        fc = vals[0] / vals[1] - tc
        fr = vals[2] / vals[3] - tr
        det = cy * rx - cx * ry
        y = y - (rx * fc - cx * fr) / det
        x = x - (-ry * fc + cy * fr) / det
    return y, x


def localization(rpc: RPCModel, col, row, alt, iters: int = 12):
    """Image (col, row) at altitude alt (m) -> ground (lon, lat) degrees:
    localization_normalized denormalized (in float32 the output's own
    quantization dominates; prefer the normalized interface there)."""
    nlon, nlat = localization_normalized(rpc, col, row, alt, iters=iters)
    return (nlon * float(rpc.lon_scale) + float(rpc.lon_offset),
            nlat * float(rpc.lat_scale) + float(rpc.lat_offset))

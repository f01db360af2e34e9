"""Geolocation: predict unknown vertex locations from located neighbours.

Counterpart of ``essentials_tpu/algorithms/geo.py`` (reference parity:
gunrock::geo, geo.hxx:28-397): each iteration every unlocated vertex takes
the spherical centroid of its located neighbours (the sum of their 3-D unit
vectors, normalised); ``spatial_median`` refines the centres with Weiszfeld
sweeps. Each iteration is one ``advance_multi`` over the whole graph: the
source payloads gathered into CSC order (the ``gather_payloads`` kernel),
then one SUM per coordinate over the CSC segments (the ``segment_reduce``
kernel); ``converged`` reads one flag to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.framework.enactor import enact
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops.advance import advance_multi
from essentials_tpu_torch.ops.configs import AdvanceIO, Combine


class GeoState(NamedTuple):
    lat: torch.Tensor    # float32[Vp] degrees, NaN = unknown
    lon: torch.Tensor


class GeoResult(NamedTuple):
    lat: torch.Tensor
    lon: torch.Tensor
    iterations: int
    elapsed_ms: float


def _to_xyz(lat, lon):
    la, lo = torch.deg2rad(lat), torch.deg2rad(lon)
    cl = torch.cos(la)
    return cl * torch.cos(lo), cl * torch.sin(lo), torch.sin(la)


def _to_latlon(x, y, z):
    """Degrees of the direction of (x, y, z); NaN where its norm is at most
    1e-12."""
    norm = torch.sqrt(x * x + y * y + z * z)
    ok = norm > 1e-12
    d = torch.clamp(norm, min=1e-12)
    x, y, z = x / d, y / d, z / d
    lat = torch.rad2deg(torch.asin(torch.clamp(z, -1.0, 1.0)))
    lon = torch.rad2deg(torch.atan2(y, x))
    return torch.where(ok, lat, torch.nan), torch.where(ok, lon, torch.nan)


def _located(lat, lon):
    """(known, x, y, z): the unit vectors of the known positions, 0
    elsewhere."""
    known = ~torch.isnan(lat)
    x, y, z = _to_xyz(torch.nan_to_num(lat), torch.nan_to_num(lon))
    return (known, torch.where(known, x, 0.0), torch.where(known, y, 0.0),
            torch.where(known, z, 0.0))


def init(g: Graph, lat, lon) -> GeoState:
    """[Vp] float32 positions on ``g``'s device from ``lat``/``lon`` (host
    arrays or tensors, NaN = unknown), NaN past them."""
    vp = g.n_vertices_padded

    def pad(a):
        a = torch.as_tensor(np.asarray(a, np.float32) if not isinstance(
            a, torch.Tensor) else a, dtype=torch.float32).to(g.device)
        out = torch.full((vp,), torch.nan, dtype=torch.float32,
                         device=g.device)
        out[:a.numel()] = a
        return out
    return GeoState(pad(lat), pad(lon))


def _src(i: int):
    return lambda e: e.src_vals[i]


def step(g: Graph, state: GeoState, it: int) -> GeoState:
    lat, lon = state
    known, kx, ky, kz = _located(lat, lon)
    sx, sy, sz = advance_multi(
        g, [(_src(0), Combine.SUM), (_src(1), Combine.SUM),
            (_src(2), Combine.SUM)],
        None, src_values=(kx, ky, kz), input_kind=AdvanceIO.GRAPH)
    nlat, nlon = _to_latlon(sx, sy, sz)
    return GeoState(torch.where(known, lat, nlat),
                    torch.where(known, lon, nlon))


def _weiszfeld_messages() -> list:
    """One sweep's four SUM messages: the neighbours' positions and 1,
    each weighted by the inverse chord distance from dst's current
    estimate to src's (known) position (~ inverse haversine for small d).
    The weight is computed once and shared by the four."""
    memo = {}

    def weight(e):
        if "w" not in memo:
            dx = e.src_vals[0] - e.dst_vals[0]
            dy = e.src_vals[1] - e.dst_vals[1]
            dz = e.src_vals[2] - e.dst_vals[2]
            memo["w"] = e.src_vals[3] / (
                torch.sqrt(dx * dx + dy * dy + dz * dz) + 1e-6)
        return memo["w"]
    return [(lambda e, i=i: weight(e) * e.src_vals[i], Combine.SUM)
            for i in range(3)] + [(weight, Combine.SUM)]


def spatial_median(g: Graph, lat, lon, *, iterations: int = 5):
    """Weiszfeld refinement of the per-vertex neighbour centre under
    great-circle distance (reference parity: geo.hxx spatial_median,
    :28-230). Each iteration is one advance over the edge axis: the
    neighbours' positions weighted by 1/chord distance to the current
    estimate (four source and three destination payloads gathered, four
    SUMs). Returns refined (lat, lon) [Vp] for every vertex with located
    neighbours."""
    known, kx, ky, kz = _located(lat, lon)
    kf = known.float()
    est_lat, est_lon = lat, lon
    for _ in range(iterations):
        ex, ey, ez = _to_xyz(torch.nan_to_num(est_lat),
                             torch.nan_to_num(est_lon))
        sx, sy, sz, sw = advance_multi(
            g, _weiszfeld_messages(), None, src_values=(kx, ky, kz, kf),
            dst_values=(ex, ey, ez), input_kind=AdvanceIO.GRAPH)
        sw = torch.clamp(sw, min=1e-12)
        nlat, nlon = _to_latlon(sx / sw, sy / sw, sz / sw)
        est_lat = torch.where(torch.isnan(nlat), est_lat, nlat)
        est_lon = torch.where(torch.isnan(nlon), est_lon, nlon)
    return est_lat, est_lon


def converged(g: Graph, state: GeoState, it: int) -> bool:
    """Every real vertex located (isolated vertices never are, so the
    iteration cap also ends a run)."""
    return not bool(torch.isnan(state.lat[:g.n_vertices]).any())


def run(g: Graph, lat, lon, *, total_iterations: int = 10,
        warmup: bool = True) -> GeoResult:
    """``total_iterations`` caps the label-propagation sweeps (reference
    param geo.hxx total_iterations); convergence = everything located.
    ``elapsed_ms`` covers the iterations, on the device's clock
    (CUDA events) or the host's (CPU)."""
    res = enact(step, converged, g, init(g, lat, lon),
                max_iterations=total_iterations, warmup=warmup)
    v = g.n_vertices
    return GeoResult(res.state.lat[:v], res.state.lon[:v], res.iterations,
                     res.elapsed_ms)


# float32 rounding budgets of cpu_reference's error bound, in units of
# 2^-24 (float32's unit roundoff): a unit vector made from float32 degrees
# (deg2rad, cos, sin and their products), and the lat/lon a normalised sum
# comes back as (asin or atan2, rad2deg), an angle of at most pi
_VEC_ROUNDINGS, _OUT_ROUNDINGS = 32, 8 * np.pi
_F32_U = 2.0 ** -24


def _host_xyz(lat, lon):
    """float64 unit vectors [3, n] of degrees, NaN read as 0."""
    la, lo = np.deg2rad(np.nan_to_num(lat)), np.deg2rad(np.nan_to_num(lon))
    return np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                     np.sin(la)])


def cpu_reference(csr, lat, lon, total_iterations: int = 10, *,
                  error_bound: bool = False):
    """Host iterations in float64, vectorised (each unlocated vertex's sum
    over its CSR row by one ``np.bincount`` a coordinate), with the JAX
    package's loop's semantics and early stop. Returns float32 (lat, lon).

    With ``error_bound``, also the angle in degrees [n] by which a float32
    run may stray from each position, from this run's data alone (0 where
    a position was given): a new position is the direction of S, the sum
    of its m located neighbours' unit vectors, and an error |dS| turns it
    by at most |dS| / (|S| - |dS|). |dS| takes each neighbour's own bound,
    _VEC_ROUNDINGS roundings of a unit vector and a tree sum's ceil(log2
    m) roundings of each term; the new position adds _OUT_ROUNDINGS. A
    longitude's bound is the angle's over cos(lat)."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(off))
    lat = np.array(lat, np.float64)
    lon = np.array(lon, np.float64)
    turn = np.zeros(n)                      # radians
    for _ in range(total_iterations):
        known = ~np.isnan(lat)
        if known[:n].all():
            break
        sx, sy, sz = (np.bincount(src, weights=(c * known)[cols], minlength=n)
                      for c in _host_xyz(lat, lon))
        norm = np.sqrt(sx * sx + sy * sy + sz * sz)
        upd = ~known[:n] & (norm > 1e-12)
        if error_bound:
            m = np.bincount(src, weights=known[cols], minlength=n)
            ds = np.bincount(src, weights=np.where(
                known[:n], turn + _VEC_ROUNDINGS * _F32_U, 0.0)[cols],
                minlength=n)
            ds += 2 * np.ceil(np.log2(np.maximum(m, 2))) * _F32_U * m
            t = np.where(norm > ds, ds / np.maximum(norm - ds, 1e-300),
                         np.pi) + _OUT_ROUNDINGS * _F32_U
            turn = np.where(upd, np.minimum(t, np.pi), turn)
        d = np.where(upd, norm, 1.0)
        nl, nn = lat.copy(), lon.copy()
        nl[:n][upd] = np.rad2deg(np.arcsin(np.clip(sz / d, -1, 1)))[upd]
        nn[:n][upd] = np.rad2deg(np.arctan2(sy / d, sx / d))[upd]
        lat, lon = nl, nn
    out = lat.astype(np.float32), lon.astype(np.float32)
    return (*out, np.rad2deg(turn)) if error_bound else out


def spatial_median_reference(csr, lat, lon, iterations: int = 5):
    """Host ``spatial_median`` in float64 (the JAX package has none):
    the same Weiszfeld sweeps, each destination summing over its
    in-edges. Returns float64 (lat, lon) [n]. Near a located neighbour a
    sweep amplifies rounding (the weight is 1/(d + 1e-6)), so a float32
    run drifts from it with every sweep where an estimate approaches
    one."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    dst = np.asarray(csr.col_indices, np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(off))
    lat = np.asarray(lat, np.float64)[:n]
    lon = np.asarray(lon, np.float64)[:n]
    known = ~np.isnan(lat)
    k = _host_xyz(lat, lon) * known
    est_lat, est_lon = lat.copy(), lon.copy()
    for _ in range(iterations):
        e = _host_xyz(est_lat, est_lon)
        w = known[src] / (np.sqrt(((k[:, src] - e[:, dst]) ** 2).sum(0))
                          + 1e-6)
        sw = np.maximum(np.bincount(dst, weights=w, minlength=n), 1e-12)
        x, y, z = (np.bincount(dst, weights=w * k[i, src], minlength=n) / sw
                   for i in range(3))
        norm = np.sqrt(x * x + y * y + z * z)
        ok = norm > 1e-12
        d = np.maximum(norm, 1e-12)
        est_lat = np.where(ok, np.rad2deg(np.arcsin(np.clip(z / d, -1, 1))),
                           est_lat)
        est_lon = np.where(ok, np.rad2deg(np.arctan2(y / d, x / d)), est_lon)
    return est_lat, est_lon


def spatial_median_objective(csr, lat, lon, est_lat, est_lon):
    """Host Weiszfeld objective in float64: for each vertex, the sum of
    chord distances from its estimate (``est_lat``/``est_lon``) to its
    located in-neighbours' positions (``lat``/``lon``, NaN = unknown).
    Returns (objective, located in-neighbours), both float64 [n]. Where
    float32 rounding decides which of two equally good points a sweep
    heads for, the estimates part but the objective does not."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    dst = np.asarray(csr.col_indices, np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(off))
    lat = np.asarray(lat, np.float64)[:n]
    lon = np.asarray(lon, np.float64)[:n]
    known = (~np.isnan(lat))[src]
    k = _host_xyz(lat, lon)
    e = _host_xyz(np.asarray(est_lat, np.float64)[:n],
                  np.asarray(est_lon, np.float64)[:n])
    d = np.sqrt(((k[:, src] - e[:, dst]) ** 2).sum(0))
    return (np.bincount(dst, weights=np.where(known, d, 0.0), minlength=n),
            np.bincount(dst, weights=known, minlength=n))

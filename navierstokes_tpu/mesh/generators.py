"""Native mesh generators for the reference geometries.

The reference ships gmsh ``.geo`` sources (mesh/domain2D.geo, domain3D.geo,
domain3D2.geo, NACA_*.geo) and requires the gmsh CLI to produce ``.msh``
files (README.md:6-11).  This module generates the equivalent
boundary-conforming simplex meshes natively (numpy + scipy Delaunay /
structured subdivision), so the framework is self-contained; gmsh meshes
remain loadable through mesh/msh_io.py.

Geometries covered (dimensions from the reference .geo files):
  * ``channel_with_cylinder_2d``  — Schaefer-Turek 2D: 2.2 x 0.41 channel,
    r=0.05 circle at (0.2, 0.2)                        (mesh/domain2D.geo:1-10)
  * ``duct_with_box_obstacle_3d`` — 2.5 x 0.41 x 0.41 duct, S=0.1 square
    column at (0.45, 0.15)                             (mesh/domain3D.geo:1-9)
  * ``duct_with_cylinder_3d``     — same duct, r=0.05 cylinder at (0.45, 0.2)
                                                       (mesh/domain3D2.geo:1-9)
  * ``naca_channel_2d``           — 2.2 x 1.0 box, airfoil at (0.4, 0.5)
                                                       (mesh/test.py:45-51)
  * ``rectangle_2d`` / ``box_3d`` — plain domains for tests/manufactured
    solutions.

Boundary tags follow the reference convention: 0=bottom/lateral walls,
1=outlet, 2=top walls, 3=inlet, 4=obstacle (mesh/domain2D.geo:39-44).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from navierstokes_tpu.mesh.geometry import Mesh

# ---------------------------------------------------------------------------
# 2D unstructured (Delaunay with holes)
# ---------------------------------------------------------------------------


def _segment_points(p0, p1, h, include_end=False):
    """Points along segment [p0, p1] with spacing <= h (excluding p1 unless
    include_end)."""
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    length = np.linalg.norm(p1 - p0)
    n = max(1, int(np.ceil(length / h)))
    ts = np.linspace(0.0, 1.0, n + 1)
    if not include_end:
        ts = ts[:-1]
    return p0[None, :] + ts[:, None] * (p1 - p0)[None, :]


def _box_boundary_points_2d(lx, ly, h):
    """Counter-clockwise boundary loop of [0,lx]x[0,ly], corners included."""
    bottom = _segment_points((0, 0), (lx, 0), h)
    right = _segment_points((lx, 0), (lx, ly), h)
    top = _segment_points((lx, ly), (0, ly), h)
    left = _segment_points((0, ly), (0, 0), h)
    return np.concatenate([bottom, right, top, left], axis=0)


def _graded_interior_grid_2d(lx, ly, h, dist_fn, h_near, near_band,
                             clearance_pts):
    """Interior lattice points with geometric grading toward dist_fn()==0.

    Level-k lattice spacing h/2^k is active where dist < near_band / 2^(k-1);
    levels continue until spacing <= h_near.  Points too close to
    ``clearance_pts`` (boundary/obstacle points) are dropped.
    """
    n_levels = 0
    while h / (2.0 ** n_levels) > h_near * 1.0001:
        n_levels += 1

    all_pts = []
    for k in range(n_levels + 1):
        s = h / (2.0 ** k)
        xs = np.arange(s, lx - 0.25 * s, s)
        ys = np.arange(s, ly - 0.25 * s, s)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        d = dist_fn(pts)
        if k == 0:
            # coarse lattice only far away (everywhere if no finer levels)
            keep = (d >= near_band if n_levels > 0
                    else np.ones(len(pts), dtype=bool))
        else:
            lo = near_band / (2.0 ** k) if k < n_levels else -np.inf
            hi = near_band / (2.0 ** (k - 1))
            keep = (d >= lo) & (d < hi)
        # keep clear of the domain boundary
        keep &= (pts[:, 0] > 0.45 * s) & (pts[:, 0] < lx - 0.45 * s)
        keep &= (pts[:, 1] > 0.45 * s) & (pts[:, 1] < ly - 0.45 * s)
        all_pts.append(pts[keep])
    pts = np.concatenate(all_pts, axis=0)

    # Drop lattice points crowding fixed points (boundary loops).
    if len(clearance_pts):
        from scipy.spatial import cKDTree
        tree = cKDTree(clearance_pts)
        # local spacing at each lattice point
        d = dist_fn(pts)
        lvl = np.zeros(len(pts), dtype=int)
        for k in range(1, n_levels + 1):
            lvl[d < near_band / (2.0 ** (k - 1))] = k
        local_h = h / (2.0 ** lvl)
        nearest, _ = tree.query(pts, k=1)
        pts = pts[nearest > 0.55 * local_h]
    return pts


def _inside_loop(loop, pts):
    """Even-odd point-in-polygon test of (n, 2) points against a closed
    (m, 2) vertex loop (the last vertex connects back to the first)."""
    x, y = pts[:, 0], pts[:, 1]
    inside = np.zeros(len(pts), dtype=bool)
    nxt = np.roll(loop, -1, axis=0)
    for (x0, y0), (x1, y1) in zip(loop, nxt):
        if y0 == y1:
            continue                  # a horizontal edge crosses no ray
        crosses = (y0 > y) != (y1 > y)
        x_at = x0 + (y - y0) * ((x1 - x0) / (y1 - y0))
        inside ^= crosses & (x < x_at)
    return inside


def _delaunay_mesh_2d(lx, ly, h, hole_loops, extra_pts, dist_fn, h_near,
                      near_band, smooth_iters=4):
    """Delaunay triangulation of the box minus polygon holes.

    hole_loops: list of (n_i, 2) closed point loops lying ON the hole
    boundary (these become tagged obstacle boundary points).
    """
    box_pts = _box_boundary_points_2d(lx, ly, h if h_near >= h else
                                      max(h_near, h / 2.0))
    fixed = [box_pts] + list(hole_loops) + (
        [extra_pts] if extra_pts is not None and len(extra_pts) else [])
    fixed_pts = np.concatenate(fixed, axis=0)
    interior = _graded_interior_grid_2d(lx, ly, h, dist_fn, h_near, near_band,
                                        fixed_pts)
    # remove interior points inside holes (with margin)
    keep = np.ones(len(interior), dtype=bool)
    for loop in hole_loops:
        keep &= ~_inside_loop(loop, interior)
    interior = interior[keep]

    pts = np.concatenate([fixed_pts, interior], axis=0)
    n_fixed = len(fixed_pts)

    def triangulate(p):
        tri = Delaunay(p)
        cells = tri.simplices.astype(np.int64)
        cent = p[cells].mean(axis=1)
        keep = np.ones(len(cells), dtype=bool)
        for loop in hole_loops:
            keep &= ~_inside_loop(loop, cent)
        # drop degenerate slivers
        e1 = p[cells[:, 1]] - p[cells[:, 0]]
        e2 = p[cells[:, 2]] - p[cells[:, 0]]
        area = 0.5 * np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
        keep &= area > 1e-14
        return cells[keep]

    cells = triangulate(pts)

    # Laplacian smoothing of movable (non-fixed) points, then re-triangulate.
    for _ in range(smooth_iters):
        neigh_sum = np.zeros_like(pts)
        neigh_cnt = np.zeros(len(pts))
        for a in range(3):
            for b in range(3):
                if a == b:
                    continue
                np.add.at(neigh_sum, cells[:, a], pts[cells[:, b]])
                np.add.at(neigh_cnt, cells[:, a], 1.0)
        target = neigh_sum / np.maximum(neigh_cnt, 1.0)[:, None]
        movable = np.arange(len(pts)) >= n_fixed
        pts[movable] = pts[movable] + 0.6 * (target[movable] - pts[movable])
        cells = triangulate(pts)

    mesh = Mesh(2, pts, cells.astype(np.int32),
                np.zeros((0, 2), np.int32), np.zeros((0,), np.int32))
    mesh.ensure_positive_orientation()
    return mesh, n_fixed


def _classify_box_boundary(mesh: Mesh, lx, ly, lz=None, tol=1e-9):
    """Extract boundary facets, classify against the box; return leftovers
    (= obstacle) marked with tag 4."""
    faces, _, _ = mesh.compute_boundary_faces()
    pts = mesh.points
    fp = pts[faces]  # (n, dim, dim)
    tags = np.full(len(faces), 4, dtype=np.int32)

    def on_plane(axis, value):
        return np.all(np.abs(fp[:, :, axis] - value) < tol, axis=1)

    tags[on_plane(1, 0.0)] = 0
    tags[on_plane(1, ly)] = 2
    if lz is not None:
        tags[on_plane(2, 0.0)] = 0
        tags[on_plane(2, lz)] = 2
    tags[on_plane(0, lx)] = 1
    tags[on_plane(0, 0.0)] = 3
    mesh.boundary_faces = faces
    mesh.boundary_tags = tags
    return mesh


def _circle_projector(cx, cy, r, keep_z=False):
    """Radial projection onto the circle |p - c| = r (x/y components; a 3D
    point keeps its z)."""
    c = np.array([cx, cy])

    def proj(p):
        p = np.asarray(p, float)
        v = p[:, :2] - c
        n = np.linalg.norm(v, axis=1, keepdims=True)
        xy = c + r * v / np.maximum(n, 1e-300)
        if keep_z:
            out = p.copy()
            out[:, :2] = xy
            return out
        return xy

    return proj


def channel_with_cylinder_2d(h=0.02, h_near=None, lx=2.2, ly=0.41,
                             cx=0.2, cy=0.2, r=0.05, near_band=None,
                             n_rings=3, wake_levels=0, wake_len=1.2,
                             wake_halfwidth=0.12):
    """Schaefer-Turek 2D cylinder channel (mesh/domain2D.geo geometry).

    ``wake_levels`` > 0 additionally refines a band of halfwidth
    ``wake_halfwidth`` around the wake centerline (length ``wake_len``
    behind the cylinder) to spacing h / 2**wake_levels — the vortex
    street resolution that Cl_max convergence needs (ST 2D-2)."""
    h_near = h_near if h_near is not None else h / 2.0
    near_band = near_band if near_band is not None else 6.0 * r

    # circle boundary + graded offset rings
    n_theta = max(24, int(np.ceil(2 * np.pi * r / h_near)))
    loops, ring_pts = [], []
    growth = 1.35
    rad = r
    for k in range(n_rings + 1):
        stagger = 0.5 * (k % 2)
        theta = (np.arange(n_theta) + stagger) * (2 * np.pi / n_theta)
        ring = np.stack([cx + rad * np.cos(theta), cy + rad * np.sin(theta)],
                        axis=1)
        if k == 0:
            circle = ring
        else:
            ring_pts.append(ring)
        rad += (2 * np.pi * r / n_theta) * (growth ** k)

    extra = np.concatenate(ring_pts, axis=0) if ring_pts else None

    def dist_fn(p):
        d = np.abs(np.hypot(p[:, 0] - cx, p[:, 1] - cy) - r)
        if wake_levels > 0:
            dx = p[:, 0] - np.clip(p[:, 0], cx, cx + wake_len)
            dw = np.hypot(dx, p[:, 1] - cy)
            base = near_band / (2.0 ** wake_levels)
            scale = (near_band - base) / wake_halfwidth
            d = np.minimum(d, base + dw * scale)
        return d

    mesh, _ = _delaunay_mesh_2d(lx, ly, h, [circle], extra, dist_fn, h_near,
                                near_band)
    mesh = _classify_box_boundary(mesh, lx, ly).validate()
    # exact circle for superparametric P2 boundary cells (fem/spaces.py)
    mesh.snap_projectors = {4: _circle_projector(cx, cy, r)}
    return mesh


def rectangle_2d(lx=1.0, ly=1.0, nx=8, ny=8):
    """Structured triangulated rectangle (each quad split along one
    diagonal).  Tags: y=0 -> 0, x=lx -> 1, y=ly -> 2, x=0 -> 3."""
    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    cells = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            # alternate diagonals for isotropy
            if (i + j) % 2 == 0:
                cells += [[v00, v10, v11], [v00, v11, v01]]
            else:
                cells += [[v00, v10, v01], [v10, v11, v01]]
    mesh = Mesh(2, pts, np.array(cells, np.int32),
                np.zeros((0, 2), np.int32), np.zeros((0,), np.int32))
    mesh.ensure_positive_orientation()
    return _classify_box_boundary(mesh, lx, ly).validate()


def naca_channel_2d(airfoil_points, h=0.015, h_near=None,
                    lx=2.2, ly=1.0, dx=0.4, dy=0.5, near_band=0.35):
    """Channel around an airfoil polyline (mesh/test.py Mesh class:
    2.2 x 1.0 box, airfoil centered at (0.4, 0.5), default h=0.015).

    ``airfoil_points``: (n, 2) closed-loop polyline of the transformed
    airfoil, relative to the airfoil center (as produced by
    navierstokes_tpu.mesh.airfoil).
    """
    h_near = h_near if h_near is not None else h / 3.0
    poly = np.asarray(airfoil_points, float) + np.array([dx, dy])

    # resample the polyline to spacing ~h_near
    loop = []
    n = len(poly)
    for i in range(n):
        p0, p1 = poly[i], poly[(i + 1) % n]
        loop.append(_segment_points(p0, p1, h_near))
    loop = np.concatenate(loop, axis=0)
    # dedupe consecutive near-identical points
    keep = np.ones(len(loop), dtype=bool)
    d = np.linalg.norm(np.diff(np.vstack([loop, loop[:1]]), axis=0), axis=1)
    keep[d < 1e-12] = False
    loop = loop[keep]

    def dist_fn(p):
        # distance to polyline vertices (adequate for grading)
        from scipy.spatial import cKDTree
        tree = cKDTree(loop)
        dd, _ = tree.query(p, k=1)
        return dd

    mesh, _ = _delaunay_mesh_2d(lx, ly, h, [loop], None, dist_fn, h_near,
                                near_band)
    return _classify_box_boundary(mesh, lx, ly).validate()


# ---------------------------------------------------------------------------
# 3D structured / extruded
# ---------------------------------------------------------------------------

_KUHN_TETS = (
    (0b000, 0b100, 0b110, 0b111),
    (0b000, 0b100, 0b101, 0b111),
    (0b000, 0b010, 0b110, 0b111),
    (0b000, 0b010, 0b011, 0b111),
    (0b000, 0b001, 0b101, 0b111),
    (0b000, 0b001, 0b011, 0b111),
)


def _tets_from_grid(xs, ys, zs, keep_cube=None):
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    if keep_cube is not None:
        cx = (xs[I] + xs[I + 1]) / 2
        cy = (ys[J] + ys[J + 1]) / 2
        cz = (zs[K] + zs[K + 1]) / 2
        m = keep_cube(cx, cy, cz)
        I, J, K = I[m], J[m], K[m]

    corner = {}
    for b in range(8):
        di, dj, dk = (b >> 2) & 1, (b >> 1) & 1, b & 1
        corner[b] = vid(I + di, J + dj, K + dk)

    cells = []
    for t in _KUHN_TETS:
        cells.append(np.stack([corner[t[0]], corner[t[1]],
                               corner[t[2]], corner[t[3]]], axis=1))
    cells = np.concatenate(cells, axis=0)

    # compact unused points
    used = np.unique(cells)
    remap = -np.ones(len(pts), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return pts[used], remap[cells]


def _coords_with(h, length, must_include=()):
    """1D coordinates covering [0, length] with spacing <= h, containing the
    given internal coordinates exactly."""
    knots = np.unique(np.concatenate([[0.0, length], np.asarray(must_include,
                                                                float)]))
    segs = []
    for a, b in zip(knots[:-1], knots[1:]):
        n = max(1, int(np.ceil((b - a) / h)))
        segs.append(np.linspace(a, b, n + 1)[:-1])
    segs.append([length])
    return np.concatenate(segs)


def _graded_coords(h, h_near, length, must_include=(), fine=(), growth=0.15):
    """1D coordinates on [0, length] with spacing ~h_near inside the `fine`
    intervals, growing geometrically (ratio ~1+growth per cell) to ~h away
    from them.  Contains `must_include` coordinates exactly.  Spacing is
    distributed by equidistributing the density 1/h(x) on each knot segment,
    so the grid is smooth and endpoints land exactly."""
    if h_near is None or h_near >= h or not len(fine):
        return _coords_with(h, length, must_include)
    fine = [(float(lo), float(hi)) for lo, hi in fine]

    def hx(x):
        d = min(max(lo - x, x - hi, 0.0) for lo, hi in fine)
        return np.minimum(h, h_near + growth * d)

    knots = np.unique(np.concatenate([[0.0, length],
                                      np.asarray(must_include, float)]))
    segs = []
    for a, b in zip(knots[:-1], knots[1:]):
        xs = np.linspace(a, b, 2049)
        dens = 1.0 / np.array([hx(x) for x in xs])
        cum = np.concatenate(
            [[0.0], np.cumsum((dens[1:] + dens[:-1]) / 2 * np.diff(xs))])
        n = max(1, int(np.ceil(cum[-1])))
        nodes = np.interp(np.linspace(0.0, cum[-1], n + 1), cum, xs)
        segs.append(nodes[:-1])
    segs.append([length])
    return np.concatenate(segs)


def box_3d(lx=1.0, ly=1.0, lz=1.0, n=4):
    xs = np.linspace(0, lx, n + 1)
    ys = np.linspace(0, ly, n + 1)
    zs = np.linspace(0, lz, n + 1)
    pts, cells = _tets_from_grid(xs, ys, zs)
    mesh = Mesh(3, pts, cells.astype(np.int32),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))
    mesh.ensure_positive_orientation()
    return _classify_box_boundary(mesh, lx, ly, lz).validate()


def duct_with_box_obstacle_3d(h=0.05, lx=2.5, ly=0.41, lz=0.41,
                              ox=0.45, oy=0.15, s=0.1, h_near=None,
                              h_z=None):
    """3D duct with a square-section column obstacle (mesh/domain3D.geo).

    With `h_near`, the x/y grids are graded: spacing ~h_near at the column
    faces growing geometrically to ~h in the far field.  The column spans
    the full z height, so z stays uniform — at `h_z` when given, else
    coupled to the refinement (min(h, 2*h_near)) so near-column cells keep
    a bounded aspect ratio instead of the ~h/h_near Kuhn-tet slivers an
    uncoupled default would produce."""
    xs = _graded_coords(h, h_near, lx, (ox, ox + s), fine=[(ox, ox + s)])
    ys = _graded_coords(h, h_near, ly, (oy, oy + s), fine=[(oy, oy + s)])
    if h_z is None:
        h_z = h if h_near is None else min(h, 2.0 * h_near)
    zs = _coords_with(h_z, lz)

    def keep(cx, cy, cz):
        inside = ((cx > ox) & (cx < ox + s) & (cy > oy) & (cy < oy + s))
        return ~inside

    pts, cells = _tets_from_grid(xs, ys, zs, keep)
    mesh = Mesh(3, pts, cells.astype(np.int32),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))
    mesh.ensure_positive_orientation()
    return _classify_box_boundary(mesh, lx, ly, lz).validate()


def duct_with_cylinder_3d(h=0.05, h_near=None, lx=2.5, ly=0.41, lz=0.41,
                          cx=0.45, cy=0.2, r=0.05, n_layers=None):
    """3D duct with a circular cylinder (mesh/domain3D2.geo): the 2D cylinder
    cross-section is extruded along z into prisms, each split into 3 tets with
    the global-index diagonal rule (conforming across prisms)."""
    base = channel_with_cylinder_2d(h=h, h_near=h_near, lx=lx, ly=ly,
                                    cx=cx, cy=cy, r=r)
    nz = n_layers if n_layers is not None else max(1, int(np.ceil(lz / h)))
    zs = np.linspace(0.0, lz, nz + 1)
    n2 = base.n_points

    pts = np.concatenate(
        [np.concatenate([base.points, np.full((n2, 1), z)], axis=1)
         for z in zs], axis=0)

    cells = []
    tri = base.cells.astype(np.int64)
    order = np.argsort(tri, axis=1)
    tri_sorted = np.take_along_axis(tri, order, axis=1)
    for layer in range(nz):
        b = tri_sorted + layer * n2        # bottom, sorted by global id
        t = b + n2                         # top
        v0, v1, v2 = b[:, 0], b[:, 1], b[:, 2]
        w0, w1, w2 = t[:, 0], t[:, 1], t[:, 2]
        cells.append(np.stack([v0, v1, v2, w0], axis=1))
        cells.append(np.stack([v1, v2, w0, w1], axis=1))
        cells.append(np.stack([v2, w0, w1, w2], axis=1))
    cells = np.concatenate(cells, axis=0)

    mesh = Mesh(3, pts, cells.astype(np.int32),
                np.zeros((0, 3), np.int32), np.zeros((0,), np.int32))
    mesh.ensure_positive_orientation()
    mesh = _classify_box_boundary(mesh, lx, ly, lz).validate()
    # cylinder lateral surface: radial x/y projection, z preserved
    mesh.snap_projectors = {4: _circle_projector(cx, cy, r, keep_z=True)}
    return mesh

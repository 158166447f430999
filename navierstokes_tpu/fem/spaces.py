"""Taylor-Hood function space on a simplex mesh (production pair P2/P1;
arbitrary degree pairs supported like the reference ctor,
src/NavierStokes.hpp:173-178).

Replaces deal.II's FESystem/DoFHandler/DoFRenumbering stack (reference:
src/NavierStokes.cpp:31-92).  The DoF layout is canonical and global by
construction — for the production P2/P1 pair:

  * pressure DoFs  = mesh vertices, index = vertex id          (n_p1,)
  * velocity nodes = vertices then unique edges:               (n_p2,)
      node id v            for vertex v
      node id n_points + e for edge e
  * velocity DoF arrays are stored node-major as (n_p2, dim)

and for any other degree the entity-major generalization in
``_lagrange_numbering`` (vertices, edge lattice nodes, 3D face nodes,
cell-interior nodes).  Because the ordering depends only on the mesh
(never on the device count), checkpoints are automatically restorable at
any device count — the property the reference needs 214 lines of raw-MPI
k-way merging to establish (compute_ordered_dofs_indices,
src/NavierStokes.cpp:571-784).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from navierstokes_tpu.fem.reference_elements import (ReferenceSimplex,
                                                     edges_of, facets_of,
                                                     shape_grads,
                                                     shape_values)
from navierstokes_tpu.mesh.geometry import Mesh


def _encode_pairs(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    lo = np.minimum(a, b).astype(np.int64)
    hi = np.maximum(a, b).astype(np.int64)
    return lo * np.int64(n) + hi


def _lagrange_numbering(mesh: Mesh, k: int, cells: np.ndarray,
                        cell_edges: np.ndarray, edge_verts: np.ndarray):
    """Global numbering of the degree-k Lagrange lattice on a simplex mesh.

    Generalizes the P2 vertices-then-edges layout to any degree — the
    arbitrary-degree half of the reference ctor's generality
    (src/NavierStokes.hpp:173-178; deal.II FE_SimplexP/DoFHandler).  Node
    ids, entity-major:

      [0, n_points)                      vertices (= vertex id)
      n_points + e*(k-1) + s             edge e, slot s: the node at
                                         fraction (s+1)/k from the LOWER
                                         vertex id toward the higher —
                                         orientation-independent, so the
                                         two cells sharing an edge agree
      + face f (3D, k == 3)              one interior node per unique face
      + cell-interior nodes              per cell (2D k >= 3)

    Local (per-cell) column order matches
    reference_elements.lattice_multi_indices exactly.  Like the P2 layout,
    the numbering depends only on the mesh, so checkpoints stay
    device-count independent (the property the reference rebuilds with
    214 lines of MPI merging, src/NavierStokes.cpp:571-784).

    Returns (n_nodes, cell_nodes (nc, n_basis) int32, coords,
    edge_node_block (n_edges, k-1), face_key_sorted or None,
    face_node or None)."""
    from navierstokes_tpu.fem.reference_elements import (
        lattice_multi_indices, n_basis)
    dim = mesh.dim
    if dim == 3 and k > 3:
        raise NotImplementedError("3D degree > 3 not supported")
    npnt = mesh.n_points
    nc = mesh.n_cells
    n_edges = edge_verts.shape[0]
    nb = n_basis(dim, k)
    edges = edges_of(dim)

    cell_nodes = np.empty((nc, nb), np.int64)
    cell_nodes[:, :dim + 1] = cells
    col = dim + 1
    if k >= 2:
        for le, (a, b) in enumerate(edges):
            e = cell_edges[:, le].astype(np.int64)
            a_is_lo = cells[:, a] < cells[:, b]
            for r in range(1, k):
                s = np.where(a_is_lo, r - 1, k - r - 1)
                cell_nodes[:, col] = npnt + e * (k - 1) + s
                col += 1
    n_en = n_edges * (k - 1)
    base_f = npnt + n_en
    n_faces = 0
    face_key_sorted = face_node = None
    if dim == 3 and k >= 3:
        fverts = cells[:, np.array(facets_of(3))]          # (nc, 4, 3)
        fs = np.sort(fverts, axis=2).astype(np.int64)
        key = (fs[..., 0] * npnt + fs[..., 1]) * npnt + fs[..., 2]
        face_key_sorted, invf = np.unique(key.ravel(), return_inverse=True)
        n_faces = len(face_key_sorted)
        cell_nodes[:, col:col + 4] = base_f + invf.reshape(nc, 4)
        col += 4
        face_node = base_f + np.arange(n_faces, dtype=np.int64)
    base_i = base_f + n_faces
    n_int = nb - col
    if n_int:
        cell_nodes[:, col:] = (base_i
                               + np.arange(nc, dtype=np.int64)[:, None]
                               * n_int + np.arange(n_int))
    n_nodes = base_i + nc * n_int

    # coordinates: barycentric lattice positions inside each cell (shared
    # nodes receive identical values from every writer)
    alphas = lattice_multi_indices(dim, k).astype(np.float64) / k
    verts = mesh.points[cells]                             # (nc, dim+1, dim)
    xn = np.einsum("la,cad->cld", alphas, verts)           # (nc, nb, dim)
    coords = np.zeros((n_nodes, dim))
    coords[cell_nodes.reshape(-1)] = xn.reshape(-1, dim)

    edge_node_block = (npnt + np.arange(n_en, dtype=np.int64)
                       .reshape(n_edges, k - 1)) if k >= 2 else \
        np.zeros((n_edges, 0), np.int64)
    return (n_nodes, cell_nodes.astype(np.int32), coords, edge_node_block,
            face_key_sorted, face_node)


@dataclasses.dataclass
class FaceData:
    """Precomputed boundary-face quadrature data for one tag.

    Replaces deal.II FEFaceValues loops (reference: src/NavierStokes.cpp:
    257-278 Neumann term, :870-906 force integrals) with flat arrays ready
    for batched device evaluation.
    """
    cells: np.ndarray          # (n_f,) adjacent cell ids
    local_facets: np.ndarray   # (n_f,) local facet index in the cell
    normals: np.ndarray        # (n_f, n_fq, dim) outward unit normals per
    #                            quad point (constant across q on straight
    #                            faces, varying on curved/snapped ones)
    jxw: np.ndarray            # (n_f, n_fq) quadrature weights x |detJ_face|
    qp_phys: np.ndarray        # (n_f, n_fq, dim) physical quad points
    # Cell-basis tables evaluated at this face's quad points:
    phi_v: np.ndarray          # (n_f, n_fq, n_v)
    dphi_v_ref: np.ndarray     # (n_f, n_fq, n_v, dim) reference grads
    phi_p: np.ndarray          # (n_f, n_fq, n_p)

    # Per-quad-point cell-geometry inverse Jacobians for faces whose owning
    # cell is curved (superparametric boundary): (n_f, n_fq, dim, dim), or
    # None for straight (affine) faces.
    jinv_q: np.ndarray | None = None

    @property
    def n_faces(self):
        return len(self.cells)


@dataclasses.dataclass
class CurvedData:
    """Quadratic-geometry quadrature data for the curved (boundary-snapped)
    cell subset — the superparametric replacement for the affine factors of
    ops/assembly.geometric_factors on those cells.

    The reference gets its obstacle-boundary fidelity from gmsh resolving
    the circle at the local mesh size (mesh/domain2D.geo:10); here the P2
    midside nodes on the tagged boundary are projected onto the analytic
    curve and the touched cells integrate with the quadratic map
    x(xi) = sum_a X_a phi2_a(xi) — per-point J, detJ, J^{-1}.
    """
    ids: np.ndarray        # (k,) curved cell ids (sorted)
    qp: np.ndarray         # (n_q, dim) quadrature points (higher-order rule)
    qw: np.ndarray         # (n_q,)
    phi_v: np.ndarray      # (n_q, n_v) P2 values
    dphi_v: np.ndarray     # (n_q, n_v, dim) P2 reference gradients
    phi_p: np.ndarray      # (n_q, n_p) P1 values
    detj_q: np.ndarray     # (k, n_q)
    jinv_q: np.ndarray     # (k, n_q, dim, dim)  jinv[x, d] = dxi_x/dx_d


class TaylorHoodSpace:
    """``rcm=True`` renumbers the P2 (velocity) nodes by reverse
    Cuthill-McKee over the node-coupling graph: vertices and edge-midpoints
    interleave by spatial locality, which keeps the blocked operators'
    neighbor-block counts small (ops/bsr.py).  The ordering remains a pure
    deterministic function of the mesh, so checkpoints stay device-count
    independent."""

    def __init__(self, mesh: Mesh, degree_velocity: int = 2,
                 degree_pressure: int = 1, rcm: bool = True):
        mesh.ensure_positive_orientation()
        self.mesh = mesh
        self.dim = mesh.dim
        self.rs = ReferenceSimplex(self.dim, degree_velocity, degree_pressure)

        # ---- unique edges & P2 numbering --------------------------------
        # (native C++ meshkit when available, numpy fallback — identical
        # ordering: unique edge keys ascending)
        edges = np.array(edges_of(self.dim), dtype=np.int64)
        from navierstokes_tpu import native
        nat = native.unique_edges(mesh.cells, edges, mesh.n_points)
        cells = mesh.cells.astype(np.int64)
        if nat is not None:
            cell_edges, edge_verts = nat
            self.n_edges = edge_verts.shape[0]
            uniq = _encode_pairs(edge_verts[:, 0].astype(np.int64),
                                 edge_verts[:, 1].astype(np.int64),
                                 mesh.n_points)
        else:
            ca = cells[:, edges[:, 0]]                  # (nc, n_edges_local)
            cb = cells[:, edges[:, 1]]
            keys = _encode_pairs(ca, cb, mesh.n_points).ravel()
            uniq, inverse = np.unique(keys, return_inverse=True)
            self.n_edges = len(uniq)
            cell_edges = inverse.reshape(
                (mesh.n_cells, edges.shape[0]))         # local -> global

        kv, kp = degree_velocity, degree_pressure
        self.degree_velocity, self.degree_pressure = kv, kp
        ea = (uniq // np.int64(mesh.n_points)).astype(np.int64)
        eb = (uniq % np.int64(mesh.n_points)).astype(np.int64)
        self._edge_key_sorted = uniq  # sorted by construction (np.unique)
        self._edge_verts = np.stack([ea, eb], axis=1)   # (n_edges, 2)
        self._face_key_sorted = None
        self._face_node = None

        if kv == 2:
            # ---- production P2 fast path (layout unchanged since round 1)
            self.n_p2 = mesh.n_points + self.n_edges
            # cell -> P2 node map, local order = vertices then edges
            # (matches reference_elements shape ordering)
            self.cell_p2 = np.concatenate(
                [cells, mesh.n_points + cell_edges], axis=1).astype(np.int32)
            mids = 0.5 * (mesh.points[ea] + mesh.points[eb])
            # P2 node coordinates (vertices + edge midpoints), used for BC
            # interpolation (deal.II interpolate_boundary_values equivalent,
            # src/NavierStokes.cpp:296-324) and VTU output.
            self.p2_coords = np.concatenate([mesh.points, mids], axis=0)
            # node-id maps (identity unless spatial renumbering below)
            self._vertex_node = np.arange(mesh.n_points, dtype=np.int64)
            self._edge_node_block = (
                mesh.n_points + np.arange(self.n_edges,
                                          dtype=np.int64)[:, None])
        else:
            # ---- arbitrary velocity degree (reference ctor generality,
            # src/NavierStokes.hpp:173-178): degree-kv lattice numbering
            num = _lagrange_numbering(mesh, kv, cells, cell_edges,
                                      self._edge_verts)
            (self.n_p2, self.cell_p2, self.p2_coords,
             self._edge_node_block, self._face_key_sorted,
             self._face_node) = num
            self._vertex_node = np.arange(mesh.n_points, dtype=np.int64)

        if kp == 1:
            self.n_p1 = mesh.n_points
            self.cell_p1 = mesh.cells.astype(np.int32)
        else:
            # higher-order pressure: its own lattice node set (e.g. P2
            # pressure of the P3/P2 pair)
            npp = _lagrange_numbering(mesh, kp, cells, cell_edges,
                                      self._edge_verts)
            self.n_p1, self.cell_p1 = npp[0], npp[1]
            self._p_coords = npp[2]
        if rcm:
            self._reorder_p2()

        # boundary face -> (cell, local facet)
        self._bf_cells, self._bf_locals = mesh.match_boundary_faces()

        # curved-boundary (snapped) state
        self._snapped_nodes = np.zeros(0, dtype=np.int64)
        self._snapped_tags: set[int] = set()
        self._curved_cache: CurvedData | None = None

    def _reorder_p2(self):
        """Hilbert-order the P2 nodes by their coordinates.

        Vertices and edge midpoints interleave along the same space-filling
        curve that orders the mesh vertices (mesh/geometry.py
        reorder_spatial), so any contiguous block of P2 node ids is a
        compact spatial patch AND stays aligned with the P1 (vertex)
        numbering — both needed to keep the velocity-velocity and
        pressure-velocity block graphs narrow (ops/bsr.py)."""
        from navierstokes_tpu.mesh.geometry import hilbert_order
        perm = hilbert_order(self.p2_coords).astype(np.int64)
        inv = np.empty(self.n_p2, dtype=np.int64)
        inv[perm] = np.arange(self.n_p2)
        self.cell_p2 = inv[self.cell_p2.astype(np.int64)].astype(np.int32)
        self.p2_coords = np.ascontiguousarray(self.p2_coords[perm])
        self._vertex_node = inv[self._vertex_node]
        self._edge_node_block = inv[self._edge_node_block]
        if self._face_node is not None:
            self._face_node = inv[self._face_node]

    # ---- curved (superparametric) boundary geometry ----------------------

    def snap_boundaries(self, projectors: dict) -> list[int]:
        """Snap the P2 midside nodes on tagged boundary facets onto analytic
        surfaces: ``projectors[tag]((m, dim) pts) -> (m, dim)``.

        Mesh vertices stay put (the generators already place them on the
        surface; moving them could invert cells) — only the edge-midpoint
        geometry nodes move, by O(h^2/8R), turning the boundary cells into
        quadratic (isoparametric-quality) cells.  The touched cells must
        afterwards integrate with the quadratic map — ``curved_data()``
        provides the per-quadrature-point factors, and ``face_data`` of a
        snapped tag returns per-point normals/JxW from the curved facet map.

        This is the answer to the reference's geometry pipeline,
        where gmsh resolves the r=0.05 circle at the local mesh size
        (mesh/domain2D.geo:10) so the polygonal error shrinks with h; here
        the error drops to O(h^3) at any resolution.  Returns the tags that
        had faces to snap."""
        if self.degree_velocity != 2:
            raise NotImplementedError(
                "curved (superparametric) boundary snapping moves the P2 "
                "midside geometry nodes; degree != 2 velocity spaces use "
                "straight (affine) cells")
        snapped = []
        new_nodes = []
        for tag, proj in projectors.items():
            sel = self.mesh.boundary_tags == tag
            faces = np.asarray(self.mesh.boundary_faces[sel], np.int64)
            if len(faces) == 0:
                continue
            en = []
            d = faces.shape[1]
            for i in range(d):
                for j in range(i + 1, d):
                    en.append(self._edge_node_block[
                        self.edge_id(faces[:, i], faces[:, j]), 0])
            en = np.unique(np.concatenate(en))
            self.p2_coords[en] = np.asarray(proj(self.p2_coords[en]))
            new_nodes.append(en)
            self._snapped_tags.add(tag)
            snapped.append(tag)
        if new_nodes:
            self._snapped_nodes = np.unique(
                np.concatenate([self._snapped_nodes] + new_nodes))
            self._curved_cache = None
            type(self).face_data.cache_clear()
        return snapped

    def curved_data(self) -> CurvedData | None:
        """Quadratic-map quadrature factors for the cells touched by
        ``snap_boundaries`` (None when nothing is snapped).  Uses a
        one-order-higher conical Gauss rule than the affine cells: the
        curved integrands are rational in the reference coordinates, so the
        extra points keep the geometric quadrature error below the O(h^3)
        interpolation error the curving buys."""
        if len(self._snapped_nodes) == 0:
            return None
        if self._curved_cache is not None:
            return self._curved_cache
        from navierstokes_tpu.fem.quadrature import gauss_simplex
        dim = self.dim
        mask = np.zeros(self.n_p2, dtype=bool)
        mask[self._snapped_nodes] = True
        ids = np.flatnonzero(
            mask[self.cell_p2.astype(np.int64)].any(axis=1)).astype(np.int64)
        qp, qw = gauss_simplex(dim, 4)
        phi_v = shape_values(dim, 2, qp)
        dphi_v = shape_grads(dim, 2, qp)
        phi_p = shape_values(dim, 1, qp)
        X = self.p2_coords[self.cell_p2[ids].astype(np.int64)]  # (k,n_v,dim)
        # J[k,q,d,x] = dx_d/dxi_x of the quadratic map x(xi) = sum X phi2
        J = np.einsum("kad,qax->kqdx", X, dphi_v)
        detj_q = np.linalg.det(J)
        if (detj_q <= 0).any():
            bad = int((detj_q.min(axis=1) <= 0).sum())
            raise ValueError(
                f"boundary snapping produced {bad} curved cells with a "
                "non-positive Jacobian — mesh too coarse for the surface "
                "curvature (h_near vs R)")
        jinv_q = np.linalg.inv(J)        # [k,q,x,d] = dxi_x/dx_d
        self._curved_cache = CurvedData(
            ids=ids, qp=qp, qw=qw, phi_v=phi_v, dphi_v=dphi_v, phi_p=phi_p,
            detj_q=detj_q, jinv_q=jinv_q)
        return self._curved_cache

    def pressure_at_p2_nodes(self, p: np.ndarray) -> np.ndarray:
        """Prolong the pressure field to all velocity nodes (exact: the
        pressure space is a subspace of the velocity space pointwise).
        Used for pointwise VTU output."""
        p = np.asarray(p)
        if self.degree_velocity == 2 and self.degree_pressure == 1:
            out = np.zeros(self.n_p2, dtype=p.dtype)
            out[self._vertex_node] = p
            out[self._edge_node_block[:, 0]] = 0.5 * (
                p[self._edge_verts[:, 0]] + p[self._edge_verts[:, 1]])
            return out
        # generic: evaluate the pressure basis at the velocity lattice
        # points cell-by-cell (consistent across cells by continuity)
        from navierstokes_tpu.fem.reference_elements import (node_ref_coords,
                                                             shape_values)
        Np = shape_values(self.dim, self.degree_pressure,
                          node_ref_coords(self.dim, self.degree_velocity))
        out = np.zeros(self.n_p2, dtype=p.dtype)
        out[self.cell_p2.astype(np.int64).reshape(-1)] = np.einsum(
            "lj,cj->cl", Np, p[self.cell_p1.astype(np.int64)]).reshape(-1)
        return out

    # ---- DoF queries -----------------------------------------------------

    @property
    def n_velocity_dofs(self):
        return self.n_p2 * self.dim

    @property
    def n_pressure_dofs(self):
        return self.n_p1

    @property
    def n_dofs(self):
        return self.n_velocity_dofs + self.n_pressure_dofs

    def edge_id(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        key = _encode_pairs(np.asarray(a, np.int64), np.asarray(b, np.int64),
                            self.mesh.n_points)
        idx = np.searchsorted(self._edge_key_sorted, key)
        if (idx >= self.n_edges).any() or \
                (self._edge_key_sorted[np.clip(idx, 0, self.n_edges - 1)]
                 != key).any():
            raise KeyError("edge not in mesh")
        return idx

    def p2_nodes_on_faces(self, faces: np.ndarray) -> np.ndarray:
        """Unique velocity-node ids lying on the given facets: vertices,
        every facet-edge lattice node, and (3D, degree 3) the facet's
        interior node."""
        if len(faces) == 0:
            return np.zeros((0,), np.int64)
        faces = np.asarray(faces, np.int64)
        nodes = [self._vertex_node[faces.ravel()]]
        d = faces.shape[1]
        for i in range(d):
            for j in range(i + 1, d):
                eid = self.edge_id(faces[:, i], faces[:, j])
                nodes.append(self._edge_node_block[eid].ravel())
        if self._face_node is not None and d == 3:
            npnt = self.mesh.n_points
            fs = np.sort(faces, axis=1)
            key = (fs[:, 0] * npnt + fs[:, 1]) * npnt + fs[:, 2]
            idx = np.searchsorted(self._face_key_sorted, key)
            nodes.append(self._face_node[idx])
        return np.unique(np.concatenate(nodes))

    def p2_nodes_on_tag(self, tag: int) -> np.ndarray:
        sel = self.mesh.boundary_tags == tag
        return self.p2_nodes_on_faces(self.mesh.boundary_faces[sel])

    # ---- face quadrature data ---------------------------------------------

    @functools.lru_cache(maxsize=None)
    def face_data(self, tag: int) -> FaceData:
        mesh, rs, dim = self.mesh, self.rs, self.dim
        sel = np.flatnonzero(mesh.boundary_tags == tag)
        cells_of = self._bf_cells[sel].astype(np.int64)
        locals_of = self._bf_locals[sel].astype(np.int64)
        facets = np.array(facets_of(dim), dtype=np.int64)

        n_f = len(sel)
        verts = mesh.cells[cells_of][np.arange(n_f)[:, None],
                                     facets[locals_of]]   # (n_f, dim)
        fpts = mesh.points[verts]                          # (n_f, dim, dim)

        # physical quad points: barycentric combo of facet vertices (in the
        # canonical local facet order used by rs.facet_phi_* tables)
        qp_phys = np.einsum("qk,fkd->fqd", rs.fq_bary, fpts)

        if dim == 2:
            t = fpts[:, 1] - fpts[:, 0]
            detj = np.linalg.norm(t, axis=1)
            nrm = np.stack([t[:, 1], -t[:, 0]], axis=1) / detj[:, None]
        else:
            e1 = fpts[:, 1] - fpts[:, 0]
            e2 = fpts[:, 2] - fpts[:, 0]
            cr = np.cross(e1, e2)
            detj = np.linalg.norm(cr, axis=1)
            nrm = cr / detj[:, None]

        # orient outward: away from the owning cell's centroid
        cell_cent = mesh.points[mesh.cells[cells_of]].mean(axis=1)
        face_cent = fpts.mean(axis=1)
        flip = np.einsum("fd,fd->f", nrm, face_cent - cell_cent) < 0
        nrm[flip] *= -1.0

        jxw = rs.fqw[None, :] * detj[:, None]
        # (3D: fqw sums to 1/2; detj = 2*area -> total = area: correct)
        nrm_q = np.broadcast_to(nrm[:, None, :],
                                (n_f, rs.n_fq, dim)).copy()
        jinv_q = None

        if tag in self._snapped_tags and n_f:
            # Curved facet map (tag was snapped onto an analytic surface):
            # quadratic geometry from the facet's P2 nodes — per-point
            # normals, JxW, physical points, and the owning cell's per-point
            # inverse Jacobian for physical gradients (force integrals,
            # ops/assembly.build_face_arrays).
            fdim = dim - 1
            vn = self._vertex_node[verts]                  # (n_f, dim)
            en = [self._edge_node_block[
                      self.edge_id(verts[:, i], verts[:, j]), 0]
                  for i, j in edges_of(fdim)]
            fnodes = np.concatenate([vn, np.stack(en, axis=1)], axis=1)
            FX = self.p2_coords[fnodes]                    # (n_f, n_geo, dim)
            N = shape_values(fdim, 2, rs.fqp)              # (n_fq, n_geo)
            dN = shape_grads(fdim, 2, rs.fqp)              # (n_fq,n_geo,fdim)
            qp_phys = np.einsum("qa,fad->fqd", N, FX)
            T = np.einsum("fad,qax->fqdx", FX, dN)         # tangent vectors
            if dim == 2:
                tq = T[..., 0]
                detj_q = np.linalg.norm(tq, axis=-1)
                nrm_q = (np.stack([tq[..., 1], -tq[..., 0]], axis=-1)
                         / detj_q[..., None])
            else:
                cr = np.cross(T[..., 0], T[..., 1])
                detj_q = np.linalg.norm(cr, axis=-1)
                nrm_q = cr / detj_q[..., None]
            flip = np.einsum("fd,fd->f", nrm_q.mean(axis=1),
                             face_cent - cell_cent) < 0
            nrm_q[flip] *= -1.0
            jxw = rs.fqw[None, :] * detj_q
            # owning cell's quadratic map evaluated at the facet points
            Xc = self.p2_coords[self.cell_p2[cells_of].astype(np.int64)]
            dphi_c = rs.facet_dphi_v[locals_of]    # (n_f, n_fq, n_v, dim)
            Jc = np.einsum("fad,fqax->fqdx", Xc, dphi_c)
            jinv_q = np.linalg.inv(Jc)

        return FaceData(
            cells=cells_of.astype(np.int32),
            local_facets=locals_of.astype(np.int32),
            normals=nrm_q,
            jxw=jxw,
            qp_phys=qp_phys,
            phi_v=rs.facet_phi_v[locals_of],
            dphi_v_ref=rs.facet_dphi_v[locals_of],
            phi_p=rs.facet_phi_p[locals_of],
            jinv_q=jinv_q,
        )

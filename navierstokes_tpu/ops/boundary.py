"""Dirichlet boundary conditions via projection masking.

The reference interpolates boundary values (velocity components only) and
symmetric-eliminates them with ``MatrixTools::apply_boundary_values``
(src/NavierStokes.cpp:296-329).  The matrix-free equivalent used here is the
standard lifting/projection transform: with P the projector that zeroes
constrained velocity nodes and g the lifted boundary values,

    A_bc x = P A P x + sigma (I - P) x
    b_bc   = P (b - A g) + sigma g

has the solution of the constrained problem with x = g on the boundary,
preserves symmetry of the pressure coupling (like apply_boundary_values'
column elimination), and keeps conditioning via the diagonal-scale sigma.

Precedence parity (cpp:303-318, comment "the latter win over the former"):
the inlet (tag 3) is interpolated first, then walls (tags 0, 2 — which get
the *inlet function*, not zero, in the reference, cpp:317-318) and the
obstacle (tag 4 — zero) override it at shared corners.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.config import InletConfig
from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh.geometry import (TAG_INLET, TAG_OBSTACLE,
                                            TAG_WALL_BOTTOM, TAG_WALL_TOP)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DirichletBC:
    """Static per-problem Dirichlet data (device pytree).

    ``base_values`` are the boundary values at inlet time-factor 1; the
    per-step values are ``base_values * factor(t)`` (covers every reference
    scenario: steady profiles have factor 1, pulsating ones sin(pi t / T),
    and the obstacle/wall zeros stay zero under scaling).
    """
    mask: jax.Array         # (n_p2, 1): 1.0 free node, 0.0 constrained
    base_values: jax.Array  # (n_p2, dim): lifted g at factor 1 (0 at free)

    def lift(self, factor):
        return self.base_values * factor

    def project_u(self, u):
        return u * self.mask


def build_dirichlet(space: TaylorHoodSpace, inlet: InletConfig,
                    dtype=jnp.float32) -> DirichletBC:
    n_p2, dim = space.n_p2, space.dim
    values = np.zeros((n_p2, dim))
    constrained = np.zeros(n_p2, dtype=bool)

    def apply(tag, vals_fn):
        nodes = space.p2_nodes_on_tag(tag)
        if len(nodes) == 0:
            return
        constrained[nodes] = True
        values[nodes] = 0.0
        v = np.asarray(vals_fn(space.p2_coords[nodes]))
        if v.ndim == 2:
            # full dim-vector profile (reference InletVelocity::vector_value,
            # src/NavierStokes.hpp:77-122)
            values[nodes, :] = v
        else:
            values[nodes, 0] = v

    present = set(space.mesh.boundary_tags.tolist())

    # pulsating/ramped profiles evaluate to 0 at t=0; the base (spatial)
    # profile is the t-modulation-free evaluation — the per-step factor
    # (_time_factor) multiplies it back in
    def base_profile(pts):
        saved = inlet.pulsating, inlet.ramp
        try:
            inlet.pulsating = False
            inlet.ramp = 0.0
            return inlet.evaluate(pts, t=0.0)
        finally:
            inlet.pulsating, inlet.ramp = saved

    if TAG_INLET in present:
        apply(TAG_INLET, base_profile)
    for tag in (TAG_WALL_BOTTOM, TAG_WALL_TOP):
        if tag in present:
            apply(tag, base_profile)          # reference: walls <- inlet fn
    if TAG_OBSTACLE in present:
        apply(TAG_OBSTACLE, lambda pts: np.zeros(len(pts)))

    mask = (~constrained).astype(np.float64)[:, None]
    out = DirichletBC(mask=jnp.asarray(mask, dtype),
                      base_values=jnp.asarray(values, dtype))
    # host copy (plain attribute): setup-time consumers read it instead of
    # pulling the device array back
    out.host_mask = mask
    return out

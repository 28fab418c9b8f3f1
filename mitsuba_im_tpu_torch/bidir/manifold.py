"""The batched specular manifold walk
(``mitsuba_im_tpu/bidir/manifold.py``; Jakob and Marschner 2012, the
reference Mitsuba's ``SpecularManifold::move``): given chains of K
specular vertices between two fixed endpoints, walk the vertices along
the scene's surfaces until every generalized half-vector constraint
vanishes.

For a specular vertex x_i between x_{i-1} and x_{i+1}, with wi and wo the
unit directions toward them, h = normalize(wi + eta_i wo), turned into the
normal's hemisphere; the vertex is consistent when the two tangential
components of h vanish (eta_i = 1 a mirror, otherwise the relative index
of the wi side over the wo side).

Every function takes a batch of B chains at once: start (B, 3), positions
and normals (B, K, 3), target (B, 3), eta (B, K) (:func:`chain_constraints`
and :func:`_offset_constraints` broadcast over any leading dimensions).
The constraint Jacobian is the reference's ``jax.jacfwd`` over the
tangent-plane offsets: ``torch.func.jacfwd`` under ``torch.func.vmap``
over the lanes, the constraints themselves its auxiliary output (the
primal of the same forward pass; on the CPU ~200 operations a step against
~290 for a jvp of the lanes times the basis directions folded into one
batch).  The (2K x 2K) systems are solved by
``torch.linalg.solve_ex`` without its error check, so that a singular lane
comes out non-finite, as the reference's does, without raising or reading
the info back to the host.  :func:`manifold_walk` runs exactly ``n_iter``
Newton iterations (the reference's ``fori_loop``; a converged lane still
moves whenever its residual falls), each re-projecting the chain vertex
by vertex through the scene's closest-hit query (``tri_closest`` or
``hier_closest``) and the hit's point and shading normal alone
(``Scene.point_normal_v``, the interaction record's values).  The
residual an iteration starts from is carried from the last (the kept
chain's), the same value the reference recomputes.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from ..core.v3 import V3


def _normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp_min((v * v).sum(-1, keepdim=True),
                                           eps))


def _sign(neg: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """-1 where ``neg``, else 1 (a ``torch.where`` of two numbers would
    take a Python decomposition under ``torch.func``'s transforms)."""
    return 1.0 - 2.0 * neg.to(like.dtype)


def _tangent_frame(n: torch.Tensor):
    """Duff et al.'s branchless orthonormal basis: n (..., 3) -> (t, b)."""
    s = _sign(n[..., 2] < 0.0, n)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]],
                    -1)
    bt = torch.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


def chain_constraints(start, positions, target, normals, eta):
    """The (..., 2K) tangential half-vector components of chains start
    (..., 3), positions (..., K, 3), target (..., 3), normals (..., K, 3),
    eta (..., K), vertex by vertex (manifold.h ``computeDerivatives``'s
    residual)."""
    prev = torch.cat([start.unsqueeze(-2), positions[..., :-1, :]], -2)
    nxt = torch.cat([positions[..., 1:, :], target.unsqueeze(-2)], -2)
    wi = _normalize(prev - positions)
    wo = _normalize(nxt - positions)
    h = _normalize(wi + eta.unsqueeze(-1) * wo)
    # h in the normal's hemisphere, so that eta < 1 refraction is stable
    h = h * _sign((h * normals).sum(-1, keepdim=True) < 0.0, h)
    t, b = _tangent_frame(normals)
    return torch.stack([(h * t).sum(-1), (h * b).sum(-1)], -1).flatten(-2)


def _offset_constraints(du, start, positions, target, normals, eta):
    """The constraints after moving each vertex by du (..., 2K) in its
    tangent plane."""
    t, b = _tangent_frame(normals)
    disp = du.unflatten(-1, (positions.shape[-2], 2))
    p = positions + disp[..., :1] * t + disp[..., 1:] * b
    return chain_constraints(start, p, target, normals, eta)


def _constraints_twice(du, start, positions, target, normals, eta):
    c = _offset_constraints(du, start, positions, target, normals, eta)
    return c, c


# the lanes' (2K x 2K) Jacobians in the offsets at du, and the constraints
# there (the primal of the same forward pass)
_jac_du = vmap(jacfwd(_constraints_twice, has_aux=True))


def _solve(J: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """J^-1 c over the batch; a singular lane comes out non-finite."""
    return torch.linalg.solve_ex(J, c, check_errors=False).result


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _newton_step(start, positions, target, normals, eta, damping: float):
    """One tangent-plane Newton step of every lane: (tentative positions
    (B, K, 3), max |constraint| (B,) before it)."""
    B, K = positions.shape[0], positions.shape[1]
    zero = positions.new_zeros((B, 2 * K))
    J, c = _jac_du(zero, start, positions, target, normals, eta)
    # Levenberg-style damping keeps early far-from-manifold steps stable
    J = J + damping * _eye(2 * K, J)
    du = -_solve(J, c).unflatten(-1, (K, 2))
    t, b = _tangent_frame(normals)
    return positions + du[..., :1] * t + du[..., 1:] * b, c.abs().amax(-1)


def _project(scene, prev, tentative, cur_p, cur_n, cur_s, ok):
    """Re-project each lane's tentative vertex by a trace from ``prev``:
    the hit's position, shading normal and shape where the ray hits, the
    current ones elsewhere.  A lane whose ray is not finite misses, as it
    does in the reference's plain intersector."""
    d = _normalize(tentative - prev)
    fin = torch.isfinite(prev).all(-1) & torch.isfinite(d).all(-1)
    o3 = V3.from_array(torch.where(fin[:, None], prev, 0.0))
    d3 = V3.from_array(torch.where(fin[:, None], d,
                                   d.new_tensor([0.0, 0.0, 1.0])))
    rec = scene.ray_intersect_v(o3, d3)
    p, ns = scene.point_normal_v(o3, d3, rec)
    hit = rec.valid & fin
    return (torch.where(hit[:, None], torch.stack(list(p), -1), cur_p),
            torch.where(hit[:, None], torch.stack(list(ns), -1), cur_n),
            torch.where(hit, rec.shape, cur_s), ok & hit)


def _reproject(scene, start, tent, p, n, s, ok):
    """Re-project a chain vertex by vertex, each traced from the last."""
    prev = start
    out_p, out_n, out_s = [], [], []
    for i in range(tent.shape[1]):
        pi, ni, si, ok = _project(scene, prev, tent[:, i], p[:, i], n[:, i],
                                  s[:, i], ok)
        out_p.append(pi)
        out_n.append(ni)
        out_s.append(si)
        prev = pi
    return (torch.stack(out_p, 1), torch.stack(out_n, 1),
            torch.stack(out_s, 1), ok)


def manifold_walk(scene, start, positions, target, eta, n_iter: int = 20,
                  tol: float = 1e-6, damping: float = 0.0):
    """Move B specular chains onto their manifold with the endpoints
    ``start`` (B, 3) and ``target`` (B, 3) held, from ``positions`` (B, K,
    3) on the surfaces, with relative indices ``eta`` (B, K).

    Returns (positions (B, K, 3), shading normals (B, K, 3), shape ids (B,
    K) int32, converged (B,)): converged where the final max |constraint|
    is below ``tol`` and every first re-projection hit a surface.  Each
    iteration takes a Newton step scaled by the lane's backtracking factor,
    re-projects the chain, and keeps it only where the residual fell (the
    factor back to 1) or else halves the factor (down to 1/64)."""
    B, K = positions.shape[0], positions.shape[1]
    n0 = torch.zeros_like(positions)
    n0[..., 2] = 1.0
    s0 = torch.zeros((B, K), dtype=torch.int32, device=positions.device)
    ok0 = torch.ones((B,), dtype=torch.bool, device=positions.device)
    _, normals, shapes, ok0 = _reproject(scene, start, positions, positions,
                                         n0, s0, ok0)
    p, n, s = positions, normals, shapes
    scale = torch.ones((B,), dtype=positions.dtype, device=positions.device)
    # the kept chain's residual, carried: each iteration's r_old is the
    # residual of the chain it starts from
    r_old = chain_constraints(start, p, target, n, eta).abs().amax(-1)
    for _ in range(n_iter):
        tent, _resid = _newton_step(start, p, target, n, eta, damping)
        tent = p + scale[:, None, None] * (tent - p)
        # sequential re-projection keeps the vertices on the surfaces
        p2, n2, s2, okp = _reproject(scene, start, tent, p, n, s, ok0)
        # step control: only steps that lower the residual are taken
        r_new = chain_constraints(start, p2, target, n2, eta).abs().amax(-1)
        accept = okp & (r_new < r_old)
        scale = torch.where(accept, 1.0,
                            torch.clamp_min(scale * 0.5, 1.0 / 64.0))
        keep = accept[:, None, None]
        p = torch.where(keep, p2, p)
        n = torch.where(keep, n2, n)
        s = torch.where(accept[:, None], s2, s)
        r_old = torch.where(accept, r_new, r_old)
    resid = chain_constraints(start, p, target, n, eta)
    converged = ok0 & (resid.abs().amax(-1) < tol)
    return p, n, s, converged


def manifold_map_jacobian(start, positions, target, normals, eta,
                          target_frame=None, damping: float = 0.0):
    """The derivative of each lane's chain through the manifold map, by the
    implicit function theorem on c(du; dt) = 0: d(du)/d(dt) = -J_u^-1 J_t,
    both Jacobians by forward mode through the constraints, dt the
    target's offset in ``target_frame`` (t, b) each (B, 3) (by default
    Duff's basis around start -> target).

    Returns (J_first (B, 2, 2), J_full (B, 2K, 2)): the first vertex's
    tangent response and the whole chain's."""
    B, K = positions.shape[0], positions.shape[1]
    if target_frame is None:
        tf_t, tf_b = _tangent_frame(_normalize(target - start))
    else:
        tf_t, tf_b = target_frame

    def c_of(du, dt, start, positions, target, normals, eta, tf_t, tf_b):
        tgt = target + dt[0] * tf_t + dt[1] * tf_b
        return _offset_constraints(du, start, positions, tgt, normals, eta)

    zero_u = positions.new_zeros((B, 2 * K))
    zero_t = positions.new_zeros((B, 2))
    J_u, J_t = vmap(jacfwd(c_of, argnums=(0, 1)))(
        zero_u, zero_t, start, positions, target, normals, eta, tf_t, tf_b)
    J_u = J_u + damping * _eye(2 * K, J_u)
    J_full = -_solve(J_u, J_t)
    return J_full[:, :2, :], J_full


def manifold_map_det(start, positions, target, normals, eta,
                     target_frame=None):
    """|det| of each lane's 2 x 2 target -> first-vertex manifold map, the
    density conversion of a manifold mutation's proposal
    (``mut_manifold.cpp``'s ``det``): (B,)."""
    J2, _ = manifold_map_jacobian(start, positions, target, normals, eta,
                                  target_frame)
    return torch.abs(J2[:, 0, 0] * J2[:, 1, 1] - J2[:, 0, 1] * J2[:, 1, 0])


def reflection_constraint_ok(start, positions, target, normals, eta,
                             tol: float = 1e-4):
    """(B,) max |constraint| < tol (the verification of specular chains)."""
    resid = chain_constraints(start, positions, target, normals, eta)
    return resid.abs().amax(-1) < tol

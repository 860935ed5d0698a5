"""Flex (deformable) kinematics and passive forces (port of
mujoco_tpu/ops/flex.py).

Counterparts: ``flex`` (:23; vertex positions, interpolated vertices,
edge lengths and Jacobians, mj_flex), ``elasticity_passive`` (:166; the
element stretch metric with its Rayleigh damping, and thin-plate
bending), ``edge_passive`` (:267; edge spring-dampers),
``contact_body_weights`` (:284; the bodies a flex contact side acts on),
``node_positions``/``node_point_jacobians`` (:402-431), ``strain_rows``
(:432; FLEXSTRAIN rows) and ``interp_passive`` (:462; the corotational
FEM of interpolated flexes). Topology is static numpy (Model.flx), every
tensor has the env batch leading.

A point Jacobian contracted with a vector is formed without the (B, k,
nv, 3) Jacobian: for dof n with motion axis (ω_n; v_n) about the subtree
CoM o_n, vᵀ·J(p)[:, n] = v·(v_n + o_n × ω_n) + (p × v)·ω_n. The edge
Jacobians, the Jacobian-transpose force insertions and the strain rows go
through that form (``_contract``), one (B, k, nv) product each.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const, index

# an element's edges as (vertex, vertex) within it, dim 2 and dim 3
# (engine_passive.c:41-44)
_ELEM_EDGES = {
    2: np.array([[1, 2], [2, 0], [0, 1]], dtype=np.int64),
    3: np.array([[0, 1], [1, 2], [2, 0], [2, 3], [0, 3], [1, 3]],
                dtype=np.int64),
}


def _vert_flexid(flx) -> np.ndarray:
  return np.repeat(np.arange(flx.nflex), flx.vertnum)


def _triu_index(n: int) -> np.ndarray:
  """(n, n) index into the packed upper triangle (row-major over j ≥ i)."""
  idx = np.zeros((n, n), dtype=np.int64)
  k = 0
  for i in range(n):
    for j in range(i, n):
      idx[i, j] = idx[j, i] = k
      k += 1
  return idx


def _axes(m: Model, d: Data):
  """(W, ω), each (B, nv, 3): W_n = v_n + o_n × ω_n, the dof's linear
  axis moved to the world origin, and its angular axis."""
  o = d.subtree_com[:, index(m.body_rootid[m.dof_bodyid], m.device)]
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  return lin + mjm.cross(o, ang), ang


def _contract(axes, pts, mask, vec):
  """vecᵀ·J(pts) per point, (B, k, nv): pts and vec (B, k, 3), mask (k,
  nv) or (B, k, nv), the dofs that move each point's body."""
  w, ang = axes
  rows = vec @ w.transpose(1, 2) + mjm.cross(pts, vec) @ ang.transpose(1, 2)
  return rows * mask


def _node_mask(m: Model, bodies) -> torch.Tensor:
  return const(m.tree.ancestor_mask[np.asarray(bodies)], m.device, m.dtype)


def flex(m: Model, d: Data) -> Data:
  """flexvert_xpos, flexedge_length and flexedge_J (mj_flex)."""
  flx = m.flx
  if flx.nflex == 0:
    return d
  dev = m.device
  bid = np.maximum(flx.vertbodyid, 0)
  base = d.xpos[:, index(bid, dev)]
  offset = mjm.mat_vec(d.xmat[:, index(bid, dev)], m.flex_vert)
  centered = flx.centered[_vert_flexid(flx)] | flx.vert_iszero
  xpos = torch.where(const(centered, dev)[:, None], base, base + offset)
  if flx.nnode:
    # an interpolated vertex blends its cell's nodes by fixed weights
    node = node_positions(m, d)
    w = const(flx.vert_nodew, dev, m.dtype)
    ipos = (w[..., None] * node[:, index(flx.vert_node, dev)]).sum(-2)
    interp = np.asarray(flx.interp)[_vert_flexid(flx)] >= 1
    xpos = torch.where(const(interp, dev)[:, None], ipos, xpos)

  v1, v2 = flx.edge[:, 0], flx.edge[:, 1]
  p1, p2 = xpos[:, index(v1, dev)], xpos[:, index(v2, dev)]
  length = mjm.norm_safe(p2 - p1)
  uvec = (p2 - p1) / length[..., None]
  ej = d.flexedge_J
  if flx.nedge:
    axes = _axes(m, d)
    ej = (_contract(axes, p2, _node_mask(m, bid[v2]), uvec)
          - _contract(axes, p1, _node_mask(m, bid[v1]), uvec))
    # a rigid or interpolated flex's edges have no Jacobian
    if flx.edge_rigid.any():
      ej = ej * const(~flx.edge_rigid, dev, m.dtype)[:, None]
  return d.replace(flexvert_xpos=xpos, flexedge_length=length,
                   flexedge_J=ej)


def edge_passive(m: Model, d: Data):
  """Edge spring-dampers → (qfrc_spring, qfrc_damper) additions
  (engine_passive.c:760-791)."""
  flx = m.flx
  fid = index(flx.edge_flexid, m.device)
  live = const(~(flx.rigid[flx.edge_flexid] | flx.edge_rigid), m.device,
               m.dtype)
  spring = live * m.flex_edgestiffness[fid] * (m.flexedge_length0
                                               - d.flexedge_length)
  damper = live * -m.flex_edgedamping[fid] * d.flexedge_velocity
  jt = d.flexedge_J.transpose(1, 2)
  return mjm.mat_vec(jt, spring), mjm.mat_vec(jt, damper)


def _vert_qvel(m: Model, d: Data):
  """(B, nvert, 3) slide velocities of the 3-dof vertex bodies, 0 for the
  others (engine_passive.c:502-507)."""
  flx = m.flx
  adr = np.where(flx.vert_free, np.maximum(flx.vert_dofadr, 0), 0)
  cols = np.clip(adr[:, None] + np.arange(3), 0, max(m.nv - 1, 0))
  v = d.qvel[:, index(cols, m.device)]
  return torch.where(const(flx.vert_free, m.device)[:, None], v, 0.0)


def _body_frame_dofs(m: Model, d: Data, bodies, force, dofadr):
  """qfrc of world forces (B, k, 3) on bodies with three slide dofs at
  dofadr, each rotated into its body's frame."""
  dev = m.device
  loc = mjm.mat_vec(d.xmat[:, index(bodies, dev)].transpose(-1, -2), force)
  cols = index((np.asarray(dofadr)[:, None] + np.arange(3)).reshape(-1), dev)
  qfrc = torch.zeros_like(d.qvel)
  return qfrc.index_add(1, cols, loc.reshape(loc.shape[0], -1))


def _insert_vertex_forces(m: Model, d: Data, force, verts_mask):
  """qfrc of per-vertex world forces (B, nvert, 3): a simple vertex body
  takes them in its body frame on its 3 slide dofs
  (engine_passive.c:639-647), any other through its point Jacobian."""
  flx = m.flx
  dev = m.device
  qfrc = torch.zeros_like(d.qvel)
  simple = np.nonzero(flx.vert_simple & verts_mask)[0]
  if len(simple):
    qfrc = qfrc + _body_frame_dofs(m, d, flx.vertbodyid[simple],
                                   force[:, index(simple, dev)],
                                   flx.vert_dofadr[simple])
  other = np.nonzero(verts_mask & ~flx.vert_simple)[0]
  if len(other):
    ix = index(other, dev)
    rows = _contract(_axes(m, d), d.flexvert_xpos[:, ix],
                     _node_mask(m, flx.vertbodyid[other]), force[:, ix])
    qfrc = qfrc + rows.sum(1)
  return qfrc


def elasticity_passive(m: Model, d: Data, enbl_spring: bool,
                       enbl_damper: bool):
  """Element stretch and thin-plate bending → (qfrc_spring, qfrc_damper)
  additions. Stretch: the Saint-Venant metric over each element's squared
  edge elongations, its Rayleigh damping folded in
  (mj_flexPassiveStretch, engine_passive.c:551-651). Bending: the
  discrete thin-plate operator over each interior edge and its flap
  (mj_flexPassiveBend, :459-547), on 3-dof vertex bodies only."""
  flx = m.flx
  dev, dtype = m.device, m.dtype
  nbatch = d.qpos.shape[0]
  spring_add = torch.zeros_like(d.qvel)
  damper_add = torch.zeros_like(d.qvel)
  dt = m.timestep(3)

  if flx.has_stretch.any():
    fvert = d.qpos.new_zeros((nbatch, flx.nvert, 3))
    touched = np.zeros(flx.nvert, dtype=bool)
    for dm in (2, 3):
      els = np.nonzero((flx.dim[flx.elem_flexid] == dm)
                       & flx.has_stretch[flx.elem_flexid])[0]
      if not len(els):
        continue
      nloc = 3 if dm == 2 else 6
      tab = _ELEM_EDGES[dm]
      verts = flx.elem[els, :dm + 1]
      eidx = index(flx.elemedge[els, :nloc], dev)
      fid = index(flx.elem_flexid[els], dev)
      kd = torch.where(dt > 0, m.flex_damping[fid][:, None] / dt, 0.0)
      length = d.flexedge_length[:, eidx]
      length0 = m.flexedge_length0[eidx]
      prev = length - d.flexedge_velocity[:, eidx] * dt
      elong = (length * length - length0 * length0
               + (length * length - prev * prev) * kd)
      metric = m.flex_stiffness[index(els, dev)][
          :, index(_triu_index(nloc), dev)]              # (E, nloc, nloc)
      c = (elong[..., None, :] @ metric)[..., 0, :]        # (B, E, nloc)
      va, vb = verts[:, tab[:, 0]], verts[:, tab[:, 1]]
      gvec = (d.flexvert_xpos[:, index(va, dev)]
              - d.flexvert_xpos[:, index(vb, dev)])
      contrib = (c[..., None] * gvec).reshape(nbatch, -1, 3)
      fvert = fvert.index_add(1, index(va.reshape(-1), dev), -contrib)
      fvert = fvert.index_add(1, index(vb.reshape(-1), dev), contrib)
      touched[np.unique(verts)] = True
    spring_add = spring_add + _insert_vertex_forces(m, d, fvert, touched)

  eb = np.nonzero(flx.has_bending[flx.edge_flexid]
                  & (flx.edgeflap[:, 1] >= 0))[0]
  if len(eb):
    v = np.concatenate([flx.edge[eb], flx.edgeflap[eb]], axis=1)  # (E, 4)
    vi = index(v, dev)
    bend = m.flex_bending[index(eb, dev)]
    bm = bend[:, :16].reshape(-1, 4, 4)
    x = d.flexvert_xpos[:, vi]                                  # (B,E,4,3)
    e0, e1, e2 = x[:, :, 1] - x[:, :, 0], x[:, :, 2] - x[:, :, 0], \
        x[:, :, 3] - x[:, :, 0]
    f1, f2, f3 = mjm.cross(e1, e2), mjm.cross(e2, e0), mjm.cross(e0, e1)
    frc = torch.stack([-(f1 + f2 + f3), f1, f2, f3], dim=2)
    spring = bm @ x + bend[:, 16, None, None] * frc
    damper = bm @ _vert_qvel(m, d)[:, vi]
    free = const(flx.vert_free[v], dev, dtype)[..., None]
    fdmp = m.flex_damping[index(flx.edge_flexid[eb], dev)]
    flat = vi.reshape(-1)
    vs = np.nonzero(flx.vert_free)[0]
    if len(vs):
      if enbl_spring:
        bs = d.qpos.new_zeros((nbatch, flx.nvert, 3)).index_add(
            1, flat, (-spring * free).reshape(nbatch, -1, 3))
        spring_add = spring_add + _body_frame_dofs(
            m, d, flx.vertbodyid[vs], bs[:, index(vs, dev)],
            flx.vert_dofadr[vs])
      if enbl_damper:
        bd = d.qpos.new_zeros((nbatch, flx.nvert, 3)).index_add(
            1, flat, (-damper * free * fdmp[:, None, None]).reshape(
                nbatch, -1, 3))
        damper_add = damper_add + _body_frame_dofs(
            m, d, flx.vertbodyid[vs], bd[:, index(vs, dev)],
            flx.vert_dofadr[vs])
  return spring_add, damper_add


def contact_body_weights(m: Model, d: Data, vids, conflex, pos):
  """(bodies, weights), each (B, ncon, K): the bodies a flex contact side
  acts on. An ordinary flex spreads the contact over its element's
  vertex bodies by inverse distance (mj_elemBodyWeight,
  engine_core_constraint.c:221; K 8, the last 4 zero); an interpolated
  one over its cell's node bodies by the basis at the contact's rest
  coordinates (:270-360; K 8 or 27). vids (B, ncon, 4) vertex ids (−1
  pad), conflex (ncon,) each slot's static flex (−1: not a flex slot),
  pos (B, ncon, 3)."""
  flx = m.flx
  dev, dtype = m.device, m.dtype
  nbatch, ncon = vids.shape[0], vids.shape[1]
  valid = vids >= 0
  vsafe = vids.long().clamp(min=0)
  env = torch.arange(nbatch, device=dev)[:, None, None]
  vpos = d.flexvert_xpos[env, vsafe]                         # (B,ncon,4,3)
  dist = mjm.norm_safe(pos[:, :, None, :] - vpos)
  w = torch.where(valid, 1.0 / torch.clamp(dist, min=mjm.MINVAL), 0.0)
  w = w / torch.clamp(w.sum(-1, keepdim=True), min=mjm.MINVAL)
  vb = index(flx.vertbodyid, dev)[vsafe]
  zeros_i = torch.zeros_like(vb)
  bodies = torch.cat([vb.clamp(min=0), zeros_i], -1)
  weights = torch.cat([torch.where(vb >= 0, w, 0.0), torch.zeros_like(w)],
                      -1)

  conflex = np.asarray(conflex)
  order_np = np.where(conflex >= 0,
                      np.asarray(flx.interp)[np.maximum(conflex, 0)], 0)
  if not (order_np >= 1).any():
    return bodies, weights
  omax = int(order_np.max())
  npc = (omax + 1) ** 3
  pad = lambda t, n: torch.cat(
      [t, t.new_zeros(t.shape[:-1] + (n - t.shape[-1],))], -1)
  if npc > weights.shape[-1]:
    bodies, weights = pad(bodies, npc), pad(weights, npc)
  # the contact's rest coordinates, its cell and the place in it
  v0 = const(flx.vert0, dev, dtype)[vsafe]                   # (B,ncon,4,3)
  coord = (w[..., None] * v0).sum(-2)
  cn_np = np.asarray(flx.cellnum)[np.maximum(conflex, 0)].astype(np.float64)
  cn = const(cn_np, dev, dtype)
  ci = torch.minimum(torch.clamp(torch.floor(coord * cn), min=0.0),
                     torch.clamp(cn - 1.0, min=0.0))
  local = torch.clamp(coord * cn - ci, 0.0, 1.0)
  ci = ci.long()
  order = index(order_np, dev)
  ny = index(cn_np[:, 1].astype(np.int64) * order_np + 1, dev)
  nz = index(cn_np[:, 2].astype(np.int64) * order_np + 1, dev)
  nadr = index(np.asarray(flx.nodeadr)[np.maximum(conflex, 0)], dev)
  quad = const(order_np == 2, dev)

  def phi(s, i):
    """mju_flexPhi at each slot's order (engine_util_misc.h:130)."""
    lin = 1.0 - s if i == 0 else (s if i == 1 else torch.zeros_like(s))
    q = (2 * s * s - 3 * s + 1 if i == 0 else
         (4 * (s - s * s) if i == 1 else 2 * s * s - s))
    return torch.where(quad, q, lin)

  node_body = index(np.concatenate([np.asarray(flx.nodebodyid),
                                    np.zeros(1, np.int64)]), dev)
  ib, iw = [], []
  for i0 in range(omax + 1):
    for i1 in range(omax + 1):
      for i2 in range(omax + 1):
        idx = (((ci[..., 0] * order + i0) * ny + (ci[..., 1] * order + i1))
               * nz + (ci[..., 2] * order + i2))
        wk = phi(local[..., 0], i0) * phi(local[..., 1], i1) * phi(
            local[..., 2], i2)
        ok = (i0 <= order) & (i1 <= order) & (i2 <= order)
        # the reference skips weights below 1e-5 (the quadratic lobes)
        ib.append(node_body[torch.clamp(nadr + idx, 0, flx.nnode)])
        iw.append(torch.where(ok & (wk >= 1e-5), wk, 0.0))
  ibod, iwgt = torch.stack(ib, -1), torch.stack(iw, -1)
  if ibod.shape[-1] < weights.shape[-1]:
    ibod, iwgt = pad(ibod, weights.shape[-1]), pad(iwgt, weights.shape[-1])
  is_interp = const(order_np >= 1, dev)[:, None]
  return (torch.where(is_interp, ibod, bodies),
          torch.where(is_interp, iwgt, weights))


def _center_grad(order: int) -> np.ndarray:
  """(npe, 3) basis gradients at the cell centre (mju_defGradient at p =
  (.5, .5, .5); nodes x slowest, z fastest)."""
  if order == 1:
    phi, dphi = [0.5, 0.5], [-1.0, 1.0]
  else:
    phi, dphi = [0.0, 1.0, 0.0], [-1.0, 0.0, 1.0]
  return np.asarray([[dphi[i] * phi[j] * phi[k], phi[i] * dphi[j] * phi[k],
                      phi[i] * phi[j] * dphi[k]]
                     for i in range(order + 1) for j in range(order + 1)
                     for k in range(order + 1)])


def node_positions(m: Model, d: Data):
  """(B, nnode, 3) world node positions (mju_flexGatherState): the body
  origin for a centred or zero-offset node, else the body-frame offset."""
  flx = m.flx
  dev = m.device
  nb = index(flx.nodebodyid, dev)
  node_flexid = np.repeat(np.arange(flx.nflex), flx.nodenum)
  cent = flx.centered[node_flexid] | flx.node_iszero
  base = d.xpos[:, nb]
  return torch.where(const(cent, dev)[:, None], base,
                     base + mjm.mat_vec(d.xmat[:, nb], m.flex_node))


def node_point_jacobians(m: Model, d: Data, gmat: np.ndarray, node_xp):
  """(B, k, nv, 3) translational Jacobians of the nodes ``gmat`` at
  node_xp (B, k, 3), ancestor-masked (cell_pos_and_jac,
  engine_core_constraint.c:51-103)."""
  dev = m.device
  o = d.subtree_com[:, index(m.body_rootid[m.dof_bodyid], dev)]
  ang, lin = d.cdof[..., :3], d.cdof[..., 3:]
  off = node_xp[:, :, None, :] - o[:, None]
  jac = lin[:, None] + mjm.cross(ang[:, None].expand_as(off), off)
  return jac * _node_mask(m, np.asarray(m.flx.nodebodyid)[gmat])[..., None]


def _rotation(m: Model, xp, order: int):
  """The corotational rotation of cells with nodes xp (B, C, npe, 3):
  the rotational part of the deformation gradient at the cell centre
  (mju_defGradient, mju_mat2Rot)."""
  g = const(_center_grad(order), m.device, m.dtype)
  return mjm.mat_to_rot_quat(xp.transpose(-1, -2) @ g)


def strain_rows(m: Model, d: Data, ent: dict):
  """The rows of one FLEXSTRAIN equality (one interpolated cell;
  engine_core_constraint.c:806-980, volume mode): (pos (B, neig), J (B,
  neig, nv)). pos_e = eigvec_e · displacement of the cell's nodes from
  flex_node0 in the corotational frame; J_e = Σ_n rot(eigvec_e[n])·J_n,
  the rotation held constant, as the reference does."""
  dev, dtype = m.device, m.dtype
  npe, neig = ent["npe"], ent["neig"]
  gmat = int(m.flx.nodeadr[ent["flex"]]) + np.asarray(ent["gind"])
  xp = node_positions(m, d)[:, index(gmat, dev)]             # (B, npe, 3)
  quat = _rotation(m, xp, ent["order"])                      # (B, 4)
  xr = mjm.rot_vec_quat(xp, mjm.conj_quat(quat)[:, None])
  displ = (xr - m.flex_node0[index(gmat, dev)]).reshape(xp.shape[0], -1)
  eig = const(ent["eigvecs"], dev, dtype)                    # (neig, ndof)
  pos = displ @ eig.T
  dsdx = mjm.rot_vec_quat(eig.reshape(1, neig, npe, 3),
                          quat[:, None, None])               # (B,neig,npe,3)
  nbatch = xp.shape[0]
  pts = xp[:, None].expand(nbatch, neig, npe, 3).reshape(nbatch, -1, 3)
  mask = _node_mask(m, np.tile(np.asarray(m.flx.nodebodyid)[gmat], neig))
  rows = _contract(_axes(m, d), pts, mask, dsdx.reshape(nbatch, -1, 3))
  return pos, rows.reshape(nbatch, neig, npe, -1).sum(2)


def _interp_cells(flx, f: int):
  """(gmat (C, npe) global node ids, kadr (C,) stiffness addresses) of
  flex f's active cells."""
  order = int(flx.interp[f])
  ndof = 3 * (order + 1) ** 3
  cx, cy, cz = (int(x) for x in flx.cellnum[f])
  ny, nz = cy * order + 1, cz * order + 1
  active = np.asarray(flx.interp_cell_active[f])
  gind, kadr = [], []
  for fe in range(cx * cy * cz):
    if not active[fe]:
      continue
    ci, cj, ck = fe // (cy * cz), (fe // cz) % cy, fe % cz
    gind.append([((ci * order + li) * ny + (cj * order + lj)) * nz
                 + (ck * order + lk) for li in range(order + 1)
                 for lj in range(order + 1) for lk in range(order + 1)])
    kadr.append(int(flx.interp_stiffadr[f]) + fe * ndof * ndof)
  return (int(flx.nodeadr[f]) + np.asarray(gind, dtype=np.int64),
          np.asarray(kadr, dtype=np.int64))


def interp_passive(m: Model, d: Data, enbl_spring: bool, enbl_damper: bool):
  """Corotational FEM of the interpolated flexes → (qfrc_spring,
  qfrc_damper) additions (mj_flexPassiveInterp, engine_passive.c:61-215):
  per active cell, the nodes' positions and velocities rotated into the
  cell's corotational frame, the compiled stiffness (−K) applied to the
  displacement from flex_node0 and to the velocity, rotated back and
  gathered per node; the dampers scale by flex_damping."""
  flx = m.flx
  dev, dtype = m.device, m.dtype
  nbatch = d.qpos.shape[0]
  zero = torch.zeros_like(d.qvel)
  if not flx.nnode or (np.asarray(flx.interp_stiffadr) < 0).all():
    return zero, zero
  nb = np.asarray(flx.nodebodyid)
  nbi = index(nb, dev)
  node_flexid = np.repeat(np.arange(flx.nflex), flx.nodenum)
  cent = flx.centered[node_flexid] | flx.node_iszero
  node_xpos = node_positions(m, d)
  cvel = d.cvel[:, nbi]
  node_vel = cvel[..., 3:] + mjm.cross(
      cvel[..., :3],
      node_xpos - d.subtree_com[:, index(m.body_rootid[nb], dev)])

  frc = d.qpos.new_zeros((nbatch, flx.nnode, 3))
  dmp = d.qpos.new_zeros((nbatch, flx.nnode, 3))
  for f in range(flx.nflex):
    order = int(flx.interp[f])
    if order < 1 or int(flx.interp_stiffadr[f]) < 0:
      continue
    gmat, kadr = _interp_cells(flx, f)
    if not len(gmat):
      continue
    npe = (order + 1) ** 3
    ndof = 3 * npe
    stiff = m.flex_stiffness_interp[index(
        kadr[:, None] + np.arange(ndof * ndof), dev)].reshape(-1, ndof, ndof)
    gi = index(gmat, dev)
    xp, vl = node_xpos[:, gi], node_vel[:, gi]               # (B,C,npe,3)
    quat = _rotation(m, xp, order)                           # (B, C, 4)
    qrot = mjm.conj_quat(quat)[..., None, :]
    displ = (mjm.rot_vec_quat(xp, qrot)
             - m.flex_node0[gi]).reshape(nbatch, -1, ndof)
    back = quat[..., None, :]
    flat = gi.reshape(-1)
    if enbl_spring:
      fe = mjm.mat_vec(stiff, displ).reshape(nbatch, -1, npe, 3)
      frc = frc.index_add(1, flat, mjm.rot_vec_quat(fe, back).reshape(
          nbatch, -1, 3))
    if enbl_damper:
      vr = mjm.rot_vec_quat(vl, qrot).reshape(nbatch, -1, ndof)
      de = mjm.mat_vec(stiff, vr).reshape(nbatch, -1, npe, 3)
      dmp = dmp.index_add(1, flat, mjm.rot_vec_quat(de, back).reshape(
          nbatch, -1, 3))
  dmp = dmp * m.flex_damping[index(node_flexid, dev)][:, None]

  # a node at its 3-dof body's origin takes the force in the body frame;
  # any other (an offset node, a pinned node under moving bodies) through
  # its point Jacobian
  simple = (np.asarray(m.body_dofnum)[nb] == 3) & cent
  other = np.nonzero(~simple & (nb > 0))[0]
  simple = np.nonzero(simple)[0]

  def scatter(force):
    qfrc = torch.zeros_like(d.qvel)
    if len(simple):
      qfrc = qfrc + _body_frame_dofs(m, d, nb[simple],
                                     force[:, index(simple, dev)],
                                     np.asarray(m.body_dofadr)[nb[simple]])
    if len(other):
      ix = index(other, dev)
      qfrc = qfrc + _contract(_axes(m, d), node_xpos[:, ix],
                              _node_mask(m, nb[other]), force[:, ix]).sum(1)
    return qfrc

  return (scatter(frc) if enbl_spring else zero,
          scatter(dmp) if enbl_damper else zero)

"""Abstract scene export, the mjv_updateScene analog (port of
mujoco_tpu/vis.py).

``update_scene`` turns (Model, Data) into a fixed-shape table of visual
geoms per env: the model geoms, then contact point and force glyphs.
``render.render_scene`` ray-casts it on the device, and
``update_scene_into`` fills one env of it into a pip ``mujoco.MjvScene``
for the viewer. Slot types and categories are static; poses, sizes,
colors and the active mask are tensors with the env axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, GeomType, Model
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const
from mujoco_tpu_torch.utils.struct import dataclass, field, static_field

# glyph categories (mjtCatBit analog: model geoms are mjCAT_DYNAMIC and
# STATIC, glyphs mjCAT_DECOR)
CAT_GEOM = 0
CAT_CONTACT_POINT = 1
CAT_CONTACT_FORCE = 2


@dataclass
class Scene:
  """Fixed-shape visual geom table (mjvScene / mjvGeom analog)."""
  geom_type: np.ndarray = static_field()   # (N,) GeomType per slot
  category: np.ndarray = static_field()    # (N,) CAT_* per slot
  objid: np.ndarray = static_field()       # (N,) source geom or contact
  pos: torch.Tensor = field()              # (B, N, 3)
  mat: torch.Tensor = field()              # (B, N, 3, 3)
  size: torch.Tensor = field()             # (B, N, 3)
  rgba: torch.Tensor = field()             # (B, N, 4)
  active: torch.Tensor = field()           # (B, N) bool

  @property
  def nslot(self):
    return len(self.geom_type)


def update_scene(m: Model, d: Data, contact_points: bool = True,
                 contact_forces: bool = False) -> Scene:
  """The scene table at the current state (mujoco_tpu/vis.py:55).

  Slots: the ngeom model geoms (colors by the setMaterial rule), then
  ncon contact-point cylinders (addContactGeoms: radius and half height
  from vis.scale.contactwidth / contactheight × stat.meansize, z along the
  contact normal), then ncon contact-force capsules along the force
  (force × vis.map.force / stat.meanmass). A slot out of use is
  inactive rather than absent."""
  from mujoco_tpu_torch.ops.render import _materials
  dev, dtype = m.device, d.qpos.dtype
  nbatch = d.qpos.shape[0]
  vm = m.vis_meta
  scl = float(vm["meansize"])
  ncon = m.con.ncon if contact_points or contact_forces else 0
  # a (1 or B, …) table, per env where the Model randomizes it
  env = lambda x: x.to(dtype).expand((nbatch,) + x.shape[1:])
  full = lambda v, n: torch.full((nbatch, n), v, dtype=dtype, device=dev)
  color = lambda key, n: const(np.asarray(vm[key]), dev, dtype).expand(
      nbatch, n, 4)

  types = list(np.asarray(m.geom_type, dtype=np.int64))
  cats = [CAT_GEOM] * m.ngeom
  objid = list(range(m.ngeom))
  pos, mat, size = [d.geom_xpos], [d.geom_xmat], [env(m.per_env("geom_size"))]
  rgba = [env(_materials(m, dtype)[0])]
  active = [torch.ones((nbatch, m.ngeom), dtype=torch.bool, device=dev)]

  if ncon:
    con = d.contact
    is_active = con.dist < con.includemargin
    # frame rows [n; t1; t2]: the glyph's columns [t1, t2, n] put the
    # cylinder's axis along the normal
    gmat = torch.stack([con.frame[..., 1, :], con.frame[..., 2, :],
                        con.frame[..., 0, :]], -1)
  if ncon and contact_points:
    w = float(vm["contactwidth"]) * scl
    h = float(vm["contactheight"]) * scl
    types += [int(GeomType.CYLINDER)] * ncon
    cats += [CAT_CONTACT_POINT] * ncon
    objid += list(range(ncon))
    pos.append(con.pos)
    mat.append(gmat)
    size.append(torch.stack([full(w, ncon), full(w, ncon),
                             torch.clamp(-con.dist / 2, min=h)], -1))
    rgba.append(color("rgba_contactpoint", ncon))
    active.append(is_active)
  if ncon and contact_forces:
    from mujoco_tpu_torch.ops.sensor import contact_force
    ft = contact_force(m, d)                        # (B, ncon, 6)
    fworld = torch.einsum("bcji,bcj->bci", con.frame, ft[..., :3])
    vec = fworld * (float(vm["map_force"])
                    / max(float(vm["meanmass"]), 1e-12))
    length = mjm.norm_safe(vec)
    zaxis = vec / torch.clamp(length, min=mjm.MINVAL)[..., None]
    ez = const(np.array([0.0, 0.0, 1.0]), dev, dtype)
    ex = const(np.array([1.0, 0.0, 0.0]), dev, dtype)
    ref = torch.where(zaxis[..., 2:3].abs() < 0.9, ez, ex)
    x = mjm.normalize(mjm.cross(ref, zaxis))
    y = mjm.cross(zaxis, x)
    w = float(vm["forcewidth"]) * scl
    types += [int(GeomType.CAPSULE)] * ncon
    cats += [CAT_CONTACT_FORCE] * ncon
    objid += list(range(ncon))
    pos.append(con.pos + 0.5 * vec)               # centered on the arrow
    mat.append(torch.stack([x, y, zaxis], -1))
    size.append(torch.stack([full(w, ncon), length / 2,
                             torch.zeros_like(length)], -1))
    rgba.append(color("rgba_contactforce", ncon))
    active.append(is_active & (length > mjm.MINVAL))

  return Scene(geom_type=np.asarray(types, dtype=np.int32),
               category=np.asarray(cats, dtype=np.int32),
               objid=np.asarray(objid, dtype=np.int32),
               pos=torch.cat(pos, 1), mat=torch.cat(mat, 1),
               size=torch.cat(size, 1), rgba=torch.cat(rgba, 1),
               active=torch.cat(active, 1))


def update_scene_into(m: Model, d: Data, scn, catmask: int = 7,
                      env: int = 0) -> int:
  """Fill a pip ``mujoco.MjvScene`` with env ``env`` of the scene table
  (mujoco_tpu/vis.py:159; the viewer's mjv_updateScene); returns the
  geoms written. catmask selects the categories (1 << CAT_*): without
  CAT_GEOM the caller draws the model geoms by the reference's own
  update."""
  import mujoco

  scene = update_scene(m, d, contact_points=True, contact_forces=True)
  host = lambda x: x[env].detach().cpu().numpy()
  pos = host(scene.pos).astype(np.float64)
  mat = host(scene.mat).astype(np.float64)
  size = host(scene.size).astype(np.float64)
  rgba = host(scene.rgba).astype(np.float32)
  active = host(scene.active)
  n0 = scn.ngeom
  for i in range(scene.nslot):
    if not active[i] or not catmask & (1 << int(scene.category[i])):
      continue
    if scn.ngeom >= scn.maxgeom:
      break
    g = scn.geoms[scn.ngeom]
    t = int(scene.geom_type[i])
    mujoco.mjv_initGeom(g, t, size[i], pos[i], mat[i].ravel(), rgba[i])
    if t == GeomType.CAPSULE:
      # an mjv capsule holds its half length in size[2]
      g.size[2] = size[i][1]
      g.size[1] = size[i][0]
    scn.ngeom += 1
  return scn.ngeom - n0


def apply_perturb_force(m: Model, d: Data, body: int, localpos, refselpos,
                        refquat=None, localmass: float = 1.0,
                        translate: bool = True, rotate: bool = False):
  """Data with xfrc_applied[:, body] the mouse perturbation of every env
  (mjv_applyPerturbForce; mujoco_tpu/vis.py:192): a critically damped
  spring from the selection point to refselpos (vis.map.stiffness 100)
  with torsional damping, or in rotate mode a spring of the body's
  inertial frame toward refquat (stiffnessrot 500). localpos (3,),
  refselpos and refquat (3,) / (4,) or per env (B, ·)."""
  dev, dtype = m.device, d.qpos.dtype
  stiffness, stiffnessrot = 100.0, 500.0
  vec = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
  ang = d.cvel[:, body, :3]
  root = int(m.body_rootid[body])
  lin = d.cvel[:, body, 3:] + mjm.cross(
      ang, d.xipos[:, body] - d.subtree_com[:, root])
  invweight = m.body_invweight0[body, 1].to(dtype)
  inertia = torch.where(invweight > 0,
                        1.0 / torch.clamp(invweight, min=1e-15), 1.0)
  force = torch.zeros_like(ang)
  torque = torch.zeros_like(ang)
  if translate:
    selpos = d.xpos[:, body] + mjm.mat_vec(d.xmat[:, body], vec(localpos))
    diff = selpos - vec(refselpos)
    force = -stiffness * localmass * diff
    arm = selpos - d.xipos[:, body]
    svel = lin + mjm.cross(ang, arm)
    force = force - math.sqrt(stiffness) * localmass * svel
    torque = mjm.cross(arm, force)
    diffn = diff / torch.clamp(torch.linalg.vector_norm(
        diff, dim=-1, keepdim=True), min=1e-15)
    torque = torque - (math.sqrt(stiffnessrot) * inertia
                       * mjm.dot(diffn, ang))[..., None] * diffn
  if rotate and refquat is not None:
    xiquat = mjm.mul_quat(d.xquat[:, body],
                          m.per_env("body_iquat")[:, body].to(dtype))
    difquat = mjm.mul_quat(vec(refquat), mjm.conj_quat(xiquat))
    torque = (mjm.quat_to_vel(difquat) * (stiffnessrot * inertia)
              - math.sqrt(stiffnessrot) * inertia * ang)
  xfrc = d.xfrc_applied.clone()
  xfrc[:, body] = torch.cat([force, torque], -1)
  return d.replace(xfrc_applied=xfrc)

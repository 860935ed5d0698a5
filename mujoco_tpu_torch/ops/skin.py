"""Skins: bone-weighted vertex skinning and area-weighted normals (port of
mujoco_tpu/ops/skin.py, ``skin_update`` :25; mjv_updateActiveSkin).

Every (bone, vertex) weight entry is posed in one gather and summed into
its vertex by one ``index_add_``; the face normals are summed into their
three corners by one more. The tables that say which entry belongs to
which bone and vertex are static, built once per call from the Model's
numpy fields.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.utils.device import index
from mujoco_tpu_torch.utils.math import (MINVAL, conj_quat, cross, mul_quat,
                                         norm_safe, normalize, quat_to_mat)


def skin_update(m: Model, d: Data):
  """Posed skin vertices and unit normals, each (B, nskinvert, 3).

  Per bone j: R_j = quat2mat(xquat[body_j] · bindquat_j⁻¹), t_j =
  xpos[body_j] − R_j bindpos_j; each weight entry k adds w_k (R_bone(k)
  v_vid(k) + t_bone(k)) to its vertex. Normals are the area-weighted sums
  of the face normals, normalized; skin_inflate moves each vertex along
  its normal."""
  nvert = m.skin_vert.shape[0]
  dev, dtype = m.device, d.qpos.dtype
  nbatch = d.qpos.shape[0]
  if nvert == 0:
    z = torch.zeros((nbatch, 0, 3), dtype=dtype, device=dev)
    return z, z
  # static tables: each weight entry's bone and global vertex id
  nbone = len(m.skin_bonebodyid)
  entry_bone = np.repeat(np.arange(nbone), m.skin_bonevertnum)
  skin_of_bone = np.repeat(np.arange(m.nskin), m.skin_bonenum)
  entry_vid = (np.asarray(m.skin_vertadr)[skin_of_bone][entry_bone]
               + np.asarray(m.skin_bonevertid))
  bodies = index(m.skin_bonebodyid, dev)
  q = mul_quat(d.xquat[:, bodies],
               conj_quat(normalize(m.skin_bonebindquat.to(dtype))))
  rot = quat_to_mat(q)                                  # (B, nbone, 3, 3)
  trans = d.xpos[:, bodies] - torch.einsum(
      "bnij,nj->bni", rot, m.skin_bonebindpos.to(dtype))
  eb, ev = index(entry_bone, dev), index(entry_vid, dev)
  posed = (torch.einsum("beij,ej->bei", rot[:, eb],
                        m.skin_vert.to(dtype)[ev]) + trans[:, eb])
  w = m.skin_bonevertweight.to(dtype)[:, None]
  vert = torch.zeros((nbatch, nvert, 3), dtype=dtype, device=dev)
  vert = vert.index_add(1, ev, w * posed)
  # area-weighted vertex normals: each face's cross product into its
  # three corners
  face = np.asarray(m.skin_face, dtype=np.int64)
  corner = [vert[:, index(face[:, k], dev)] for k in range(3)]
  fn = cross(corner[1] - corner[0], corner[2] - corner[0])
  normal = torch.zeros_like(vert).index_add(
      1, index(face.T.ravel(), dev), fn.repeat(1, 3, 1))
  normal = normal / torch.clamp(norm_safe(normal), min=MINVAL)[..., None]
  skin_of_vert = np.repeat(np.arange(m.nskin), m.skin_vertnum)
  inflate = m.skin_inflate.to(dtype)[index(skin_of_vert, dev)][:, None]
  return vert + inflate * normal, normal

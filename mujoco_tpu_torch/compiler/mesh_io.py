"""Mesh file loading (OBJ / STL) and volumetric mesh frames.

Counterpart of the reference's mesh pipeline
(src/user/user_mesh.cc: LoadOBJ, LoadSTL, and
mjCMesh::Compile's inertia/frame processing): meshes are re-centered at
their volumetric center of mass and rotated into the principal inertia
frame; the removed transform is stored as (mesh_pos, mesh_quat) and composed
back into every geom that references the mesh.
"""

from __future__ import annotations

import os
import struct as _struct

import numpy as np


def load_obj(path: str, data: bytes | None = None):
  """Wavefront OBJ: v/f records, polygon faces fan-triangulated
  (user_mesh.cc LoadOBJ via tinyobjloader). Returns (verts, faces)."""
  verts, faces = [], []
  if data is not None:
    lines = data.decode(errors="replace").splitlines()
  else:
    with open(path, "r", errors="replace") as f:
      lines = f.read().splitlines()
  for line in lines:
    t = line.split("#", 1)[0].split()
    if not t:
      continue
    if t[0] == "v":
      verts.append([float(t[1]), float(t[2]), float(t[3])])
    elif t[0] == "f":
      idx = []
      for w in t[1:]:
        s = w.split("/")[0]
        i = int(s)
        idx.append(i - 1 if i > 0 else len(verts) + i)
      for k in range(1, len(idx) - 1):   # fan triangulation
        faces.append([idx[0], idx[k], idx[k + 1]])
  if not verts:
    raise ValueError(f"OBJ file {path} has no vertices")
  return (np.asarray(verts, dtype=np.float64),
          np.asarray(faces, dtype=np.int32).reshape(-1, 3))


def load_stl(path: str, data: bytes | None = None):
  """STL, binary or ASCII (user_mesh.cc LoadSTL). Duplicate vertices are
  merged exactly (the reference welds identical coordinates)."""
  if data is not None:
    raw = data
  else:
    with open(path, "rb") as f:
      raw = f.read()
  is_ascii = raw[:5] == b"solid" and b"facet" in raw[:1000]
  tris = []
  if is_ascii:
    cur = []
    for line in raw.decode(errors="replace").splitlines():
      t = line.split()
      if t[:1] == ["vertex"]:
        cur.append([float(t[1]), float(t[2]), float(t[3])])
        if len(cur) == 3:
          tris.append(cur)
          cur = []
  else:
    (ntri,) = _struct.unpack_from("<I", raw, 80)
    off = 84
    for _ in range(ntri):
      vals = _struct.unpack_from("<12f", raw, off)
      tris.append([vals[3:6], vals[6:9], vals[9:12]])
      off += 50
  if not tris:
    raise ValueError(f"STL file {path} has no facets")
  flat = np.asarray(tris, dtype=np.float64).reshape(-1, 3)
  verts, inverse = np.unique(flat, axis=0, return_inverse=True)
  faces = inverse.reshape(-1, 3).astype(np.int32)
  return verts, faces


def load_msh(path: str, data: bytes | None = None):
  """Legacy binary MSH (user_mesh.cc LoadMSH:1101): int32 header
  [nvert, nnormal, ntexcoord, nface], float32 vertices (3n), normals (3n),
  texcoords (2n), int32 faces (3f). Normals/texcoords are parsed for
  layout validation and discarded (the engine recomputes shading)."""
  if data is not None:
    raw = data
  else:
    with open(path, "rb") as f:
      raw = f.read()
  if len(raw) < 16:
    raise ValueError(f"missing header in MSH file '{path}'")
  nv, nn, nt, nf = _struct.unpack_from("<4i", raw, 0)
  if nv < 4 or nf < 0 or nn < 0 or nt < 0 or (nn and nn != nv) or \
      (nt and nt != nv):
    raise ValueError(f"invalid sizes in MSH file '{path}'")
  expect = 16 + 12 * nv + 12 * nn + 8 * nt + 12 * nf
  if len(raw) != expect:
    raise ValueError(f"unexpected file size in MSH file '{path}' "
                     f"({len(raw)} != {expect})")
  off = 16
  verts = np.frombuffer(raw, dtype="<f4", count=3 * nv,
                        offset=off).reshape(nv, 3).astype(np.float64)
  off += 12 * nv + 12 * nn + 8 * nt
  faces = (np.frombuffer(raw, dtype="<i4", count=3 * nf,
                         offset=off).reshape(nf, 3).astype(np.int32)
           if nf else None)
  return verts, faces


def load_mesh_file(path: str, data: bytes | None = None):
  """Dispatch by extension; `data` (mjVFS analog) bypasses the filesystem."""
  ext = os.path.splitext(path)[1].lower()
  if ext == ".obj":
    return load_obj(path, data)
  if ext == ".stl":
    return load_stl(path, data)
  if ext == ".msh":
    return load_msh(path, data)
  raise NotImplementedError(f"mesh file format '{ext}' "
                            "(OBJ/STL/MSH supported)")


def volumetric_frame(verts: np.ndarray, faces: np.ndarray):
  """(volume, com, inertia_about_com) of the closed triangle mesh at unit
  density, by signed-tetrahedron integrals to the origin (mjCMesh inertia
  computation, user_mesh.cc). Face winding is normalized by the sign of the
  total volume."""
  v0 = verts[faces[:, 0]]
  v1 = verts[faces[:, 1]]
  v2 = verts[faces[:, 2]]
  cross = np.cross(v1 - v0, v2 - v0)
  detj = np.einsum("ij,ij->i", v0, np.cross(v1, v2)) * 1.0  # 6*signed vol
  vol = detj.sum() / 6.0
  sign = 1.0 if vol >= 0 else -1.0
  vol *= sign
  if vol < 1e-14:
    raise ValueError("mesh has (near-)zero volume; cannot compute inertia")
  com = sign * ((v0 + v1 + v2) / 4.0 * detj[:, None]).sum(axis=0) / (6 * vol)

  # inertia via canonical-tetrahedron covariance (the standard closed form)
  a, b, c = v0 - com, v1 - com, v2 - com
  detj = sign * np.einsum("ij,ij->i", a, np.cross(b, c))
  # covariance integral C = ∫ x xᵀ dV summed over tets
  cov = np.zeros((3, 3))
  for p in (a, b, c):
    for q in (a, b, c):
      w = 2.0 if p is q else 1.0
      cov += (w * np.einsum("i,ij,ik->jk", detj, p, q))
  cov /= 120.0
  inertia = np.eye(3) * np.trace(cov) - cov
  return vol, com, inertia

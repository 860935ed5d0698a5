"""USD export: a scene or a trajectory of one env as a .usda stage (port
of mujoco_tpu/usd_export.py).

The stage is written as plain usda 1.0 text, the prim schema of MuJoCo's
USD exporter (python/mujoco/usd/exporter.py, shapes.py): one Xform per
geom with a typed Gprim child (Sphere, Cube, Capsule, Cylinder, Mesh), a
displayColor by the setMaterial rule, flexes and skins as Mesh prims with
their points, UsdLux lights, a Camera per model camera, and time-sampled
xformOp:transform rows for a trajectory. Given the same Model and state
it writes the same text as the reference, byte for byte. The port's Data
is batched, so ``export_usd`` takes the env to write (default 0).

Usage:
  export_usd(m, d, "scene.usda")              # one frame
  export_usd(m, [d0, d1, ...], "traj.usda", fps=60, env=3)
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

from mujoco_tpu_torch.models.types import Data, GeomType, Model


def _np(x) -> np.ndarray:
  """A tensor (or array) as a float64 numpy array."""
  if hasattr(x, "detach"):
    x = x.detach().cpu().double().numpy()
  return np.asarray(x, dtype=np.float64)


def _mat4(pos, mat) -> str:
  """Row-major USD matrix4d from a position and a 3x3 rotation."""
  m = np.asarray(mat, dtype=np.float64).reshape(3, 3)
  p = np.asarray(pos, dtype=np.float64)
  rows = [(*m[:, 0], 0.0), (*m[:, 1], 0.0), (*m[:, 2], 0.0), (*p, 1.0)]
  return "( " + ", ".join(
      "(" + ", ".join(repr(float(x)) for x in r) + ")" for r in rows) + " )"


def _resolved_rgba(m: Model) -> np.ndarray:
  """Per-geom display color under the setMaterial rule
  (engine_vis_visualize.c:225-247)."""
  rgba = _np(m.geom_rgba).copy()
  if m.nmat:
    matid = np.asarray(m.geom_matid)
    mrgba = _np(m.mat_rgba)
    default = np.array([0.5, 0.5, 0.5, 1.0])
    for g in range(rgba.shape[0]):
      if matid[g] >= 0 and np.allclose(rgba[g], default, atol=1e-7):
        rgba[g] = mrgba[matid[g]]
  return rgba


def _geom_prim(m: Model, g: int, rgba) -> List[str]:
  """Typed Gprim block for geom g (shapes.py mapping): USD capsules and
  cylinders are z-axis aligned, matching the MuJoCo convention."""
  t = int(m.geom_type[g])
  size = [float(x) for x in _np(m.geom_size[g])]
  rgba = [float(x) for x in np.asarray(rgba)]
  col = f"color3f[] primvars:displayColor = [({rgba[0]!r}, {rgba[1]!r}, {rgba[2]!r})]"
  op = f"float[] primvars:displayOpacity = [{rgba[3]!r}]"
  if t == GeomType.PLANE:
    # finite quad (infinite planes get a large default extent)
    hx = float(size[0]) if size[0] > 0 else 100.0
    hy = float(size[1]) if size[1] > 0 else 100.0
    return [
        'def Mesh "shape"', "{",
        f"  point3f[] points = [(-{hx!r}, -{hy!r}, 0), ({hx!r}, -{hy!r}, 0),"
        f" ({hx!r}, {hy!r}, 0), (-{hx!r}, {hy!r}, 0)]",
        "  int[] faceVertexCounts = [4]",
        "  int[] faceVertexIndices = [0, 1, 2, 3]",
        f"  {col}", f"  {op}", "}"]
  if t == GeomType.SPHERE:
    return ['def Sphere "shape"', "{",
            f"  double radius = {float(size[0])!r}",
            f"  {col}", f"  {op}", "}"]
  if t == GeomType.CAPSULE:
    return ['def Capsule "shape"', "{",
            '  uniform token axis = "Z"',
            f"  double radius = {float(size[0])!r}",
            f"  double height = {2 * float(size[1])!r}",
            f"  {col}", f"  {op}", "}"]
  if t == GeomType.ELLIPSOID:
    # unit sphere under a non-uniform scale (exporter shapes.py does the
    # same through the prim transform)
    return ['def Sphere "shape"', "{",
            "  double radius = 1",
            "  double3 xformOp:scale = "
            f"({size[0]!r}, {size[1]!r}, {size[2]!r})",
            '  uniform token[] xformOpOrder = ["xformOp:scale"]',
            f"  {col}", f"  {op}", "}"]
  if t == GeomType.CYLINDER:
    return ['def Cylinder "shape"', "{",
            '  uniform token axis = "Z"',
            f"  double radius = {float(size[0])!r}",
            f"  double height = {2 * float(size[1])!r}",
            f"  {col}", f"  {op}", "}"]
  if t == GeomType.BOX:
    return ['def Cube "shape"', "{",
            "  double size = 2",
            "  double3 xformOp:scale = "
            f"({size[0]!r}, {size[1]!r}, {size[2]!r})",
            '  uniform token[] xformOpOrder = ["xformOp:scale"]',
            f"  {col}", f"  {op}", "}"]
  if t == GeomType.MESH:
    mid = int(m.geom_dataid[g])
    vadr, vnum = int(m.mesh_vertadr[mid]), int(m.mesh_vertnum[mid])
    fadr, fnum = int(m.mesh_faceadr[mid]), int(m.mesh_facenum[mid])
    verts = _np(m.mesh_vert[vadr:vadr + vnum])
    faces = np.asarray(m.mesh_face[fadr:fadr + fnum], dtype=np.int64)
    pts = ", ".join("({!r}, {!r}, {!r})".format(*map(float, v))
                    for v in verts)
    idx = ", ".join(str(int(i)) for i in faces.ravel())
    counts = ", ".join(["3"] * fnum)
    return ['def Mesh "shape"', "{",
            f"  point3f[] points = [{pts}]",
            f"  int[] faceVertexCounts = [{counts}]",
            f"  int[] faceVertexIndices = [{idx}]",
            f"  {col}", f"  {op}", "}"]
  # hfield and others: aabb placeholder box
  return ['def Cube "shape"', "{", "  double size = 2",
          f"  {col}", f"  {op}", "}"]


class _Frame:
  """One env of a batched Data: the fields the stage reads, as numpy."""

  def __init__(self, d: Data, env: int):
    self.d, self.env = d, env

  def __getattr__(self, name):
    return _np(getattr(self.d, name)[self.env])


def export_usd(m: Model, data: Union[Data, Sequence[Data]], path: str,
               fps: float = 60.0, env: int = 0) -> str:
  """Write the Model and env ``env`` of the frame(s) to ``path`` as usda
  (a per-env Model at that env's leaves); returns the text."""
  m = m.envs(env)
  datas = [data] if isinstance(data, Data) else list(data)
  frames = [_Frame(d, env) for d in datas]
  nfr = len(frames)
  rgba = _resolved_rgba(m)
  geom_names = {v: k for k, v in m.names.get("geom", {}).items()}

  out = [
      "#usda 1.0", "(",
      '  defaultPrim = "World"',
      '  upAxis = "Z"',
      "  metersPerUnit = 1",
      f"  timeCodesPerSecond = {fps!r}",
      "  startTimeCode = 0",
      f"  endTimeCode = {nfr - 1}",
      ")", "",
      'def Xform "World"', "{"]

  def geom_name(g):
    return geom_names.get(g) or f"geom_{g}"

  for g in range(m.ngeom):
    nm = "".join(c if c.isalnum() or c == "_" else "_" for c in geom_name(g))
    out.append(f'  def Xform "{nm}"')
    out.append("  {")
    if nfr == 1:
      d = frames[0]
      out.append("    matrix4d xformOp:transform = "
                 + _mat4(np.asarray(d.geom_xpos[g]),
                         np.asarray(d.geom_xmat[g])))
    else:
      out.append("    matrix4d xformOp:transform.timeSamples = {")
      for t, d in enumerate(frames):
        out.append(f"      {t}: "
                   + _mat4(np.asarray(d.geom_xpos[g]),
                           np.asarray(d.geom_xmat[g])) + ",")
      out.append("    }")
    out.append('    uniform token[] xformOpOrder = ["xformOp:transform"]')
    for line in _geom_prim(m, g, rgba[g]):
      out.append("    " + line)
    out.append("  }")

  # deformables and skins: Mesh prims with time-sampled points (the
  # USD-native way to ship soft-body animation; the reference exporter
  # re-tessellates through mjvScene)
  def _animated_mesh(name, faces, pts_per_frame, rgba_):
    counts = ", ".join(["3"] * len(faces))
    idx = ", ".join(str(int(i)) for i in np.asarray(faces).ravel())
    out.append(f'  def Mesh "{name}"')
    out.append("  {")
    if nfr == 1:
      pts = ", ".join("({!r}, {!r}, {!r})".format(*map(float, v))
                      for v in pts_per_frame[0])
      out.append(f"    point3f[] points = [{pts}]")
    else:
      out.append("    point3f[] points.timeSamples = {")
      for t, pv in enumerate(pts_per_frame):
        pts = ", ".join("({!r}, {!r}, {!r})".format(*map(float, v))
                        for v in pv)
        out.append(f"      {t}: [{pts}],")
      out.append("    }")
    out.append(f"    int[] faceVertexCounts = [{counts}]")
    out.append(f"    int[] faceVertexIndices = [{idx}]")
    rgba_ = [float(x) for x in rgba_]
    out.append("    color3f[] primvars:displayColor = "
               f"[({rgba_[0]!r}, {rgba_[1]!r}, {rgba_[2]!r})]")
    out.append(f"    float[] primvars:displayOpacity = [{rgba_[3]!r}]")
    out.append("  }")

  flx = m.flx
  if flx.nflex:
    for f in range(flx.nflex):
      dim = int(flx.dim[f])
      if dim < 2:
        continue
      va = int(flx.vertadr[f])
      ea, en = int(flx.elemadr[f]), int(flx.elemnum[f])
      tris = []
      for e in range(ea, ea + en):
        ev = np.asarray(flx.elem[e]) - va
        combos = ([(0, 1, 2)] if dim == 2
                  else [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])
        for c in combos:
          tris.append([ev[c[0]], ev[c[1]], ev[c[2]]])
      pts = [np.asarray(fr.flexvert_xpos[va:va + int(flx.vertnum[f])])
             for fr in frames]
      rgba_f = _np(m.flex_rgba[f])
      _animated_mesh(f"flex_{f}", np.asarray(tris), pts, rgba_f)

  if m.nskin:
    from mujoco_tpu_torch.ops.skin import skin_update
    allverts = [_np(skin_update(m, d)[0][env]) for d in datas]
    for s in range(m.nskin):
      va, vn = int(m.skin_vertadr[s]), int(m.skin_vertnum[s])
      fa, fn = int(m.skin_faceadr[s]), int(m.skin_facenum[s])
      pts = [v[va:va + vn] for v in allverts]
      _animated_mesh(f"skin_{s}", np.asarray(m.skin_face[fa:fa + fn]),
                     pts, _np(m.skin_rgba[s]))

  # lights (lights.py: directional → DistantLight, else SphereLight)
  d0 = frames[0]
  for li in range(m.nlight):
    directional = int(np.asarray(m.light_type)[li]) == 1
    pos = [float(x) for x in np.asarray(d0.light_xpos[li])]
    kind = "DistantLight" if directional else "SphereLight"
    diffuse = [float(x) for x in _np(m.light_diffuse[li])]
    out += [f'  def {kind} "light_{li}"', "  {",
            f"    color3f inputs:color = "
            f"({diffuse[0]!r}, {diffuse[1]!r}, {diffuse[2]!r})",
            "    float inputs:intensity = 500",
            "    double3 xformOp:translate = "
            f"({pos[0]!r}, {pos[1]!r}, {pos[2]!r})",
            '    uniform token[] xformOpOrder = ["xformOp:translate"]',
            "  }"]

  # cameras (camera.py: vertical aperture from fovy at the USD default
  # focal length)
  for c in range(m.ncam):
    fovy = float(_np(m.cam_fovy)[c])
    focal = float(24.0 / (2.0 * np.tan(np.radians(fovy) / 2.0)))
    out += [f'  def Camera "camera_{c}"', "  {",
            f"    float focalLength = {focal!r}",
            "    float horizontalAperture = 24",
            "    float verticalAperture = 24",
            "    matrix4d xformOp:transform = "
            + _mat4(np.asarray(d0.cam_xpos[c]),
                    np.asarray(d0.cam_xmat[c])),
            '    uniform token[] xformOpOrder = ["xformOp:transform"]',
            "  }"]

  out.append("}")
  text = "\n".join(out) + "\n"
  with open(path, "w") as f:
    f.write(text)
  return text

"""Compiler core: spec tree → CompiledModel (flat numpy model arrays).

Counterpart of mjCModel::Compile (src/user/user_model.cc:4862)
for the supported subset: per-element compilation (orientation resolution,
geom inertia — user_objects.cc), addressing, name tables, and the
qpos0-derived constants (mj_setConst, engine_setconst.c:860-1332) computed
with this package's own engine (compiler/setconst.py), on the CUDA card or,
when asked, on the CPU.

The output CompiledModel is attribute-compatible with the subset of
mujoco.MjModel that models/io.put_model consumes, so a single bridge serves
both the reference compiler and this one.
"""

from __future__ import annotations

import copy
import math
import os
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from mujoco_tpu_torch.compiler.parser import Element, Spec, parse_mjcf

_SOLREF = (0.02, 1.0)
_SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)

_CABLE_GEOM_QUAT = "0.7071067811865476 0 -0.7071067811865476 0"

_GEOMTYPES = {"plane": 0, "hfield": 1, "sphere": 2, "capsule": 3,
              "ellipsoid": 4, "cylinder": 5, "box": 6, "mesh": 7}
_JNTTYPES = {"free": 0, "ball": 1, "slide": 2, "hinge": 3}
_JNT_NQ = {0: 7, 1: 4, 2: 1, 3: 1}
_JNT_NV = {0: 6, 1: 3, 2: 1, 3: 1}
_CAMLIGHT_MODES = {"fixed": 0, "track": 1, "trackcom": 2, "targetbody": 3,
                   "targetbodycom": 4}
_INTEGRATORS = {"Euler": 0, "RK4": 1, "implicit": 2, "implicitfast": 3}
_CONES = {"pyramidal": 0, "elliptic": 1}
_SOLVERS = {"PGS": 0, "CG": 1, "Newton": 2}

_DISABLE_BITS = {
    "constraint": 1 << 0, "equality": 1 << 1, "frictionloss": 1 << 2,
    "limit": 1 << 3, "contact": 1 << 4, "spring": 1 << 5, "damper": 1 << 6,
    "gravity": 1 << 7, "clampctrl": 1 << 8, "warmstart": 1 << 9,
    "filterparent": 1 << 10, "actuation": 1 << 11, "refsafe": 1 << 12,
    "sensor": 1 << 13, "midphase": 1 << 14, "eulerdamp": 1 << 15,
    "autoreset": 1 << 16, "nativeccd": 1 << 17,
}
_ENABLE_BITS = {"override": 1 << 0, "energy": 1 << 1, "fwdinv": 1 << 2,
                "invdiscrete": 1 << 3, "sleep": 1 << 4, "multiccd": 1 << 5}

_SENSORS = {
    # name: (type enum, dim, objtype kw, needstage) — mjtSensor values
    "touch": (0, 1, "site", 3),
    "accelerometer": (1, 3, "site", 3),
    "velocimeter": (2, 3, "site", 2),
    "gyro": (3, 3, "site", 2),
    "force": (4, 3, "site", 3),
    "torque": (5, 3, "site", 3),
    "magnetometer": (6, 3, "site", 1),
    "rangefinder": (7, 1, "site", 1),
    "jointpos": (9, 1, "joint", 1),
    "jointvel": (10, 1, "joint", 2),
    "tendonpos": (11, 1, "tendon", 1),
    "tendonvel": (12, 1, "tendon", 2),
    "actuatorpos": (13, 1, "actuator", 1),
    "actuatorvel": (14, 1, "actuator", 2),
    "actuatorfrc": (15, 1, "actuator", 3),
    "jointactuatorfrc": (16, 1, "joint", 3),
    "ballquat": (18, 4, "joint", 1),
    "ballangvel": (19, 3, "joint", 2),
    "jointlimitpos": (20, 1, "joint", 1),
    "jointlimitvel": (21, 1, "joint", 2),
    "jointlimitfrc": (22, 1, "joint", 3),
    "framepos": (26, 3, "obj", 1),
    "framequat": (27, 4, "obj", 1),
    "framexaxis": (28, 3, "obj", 1),
    "frameyaxis": (29, 3, "obj", 1),
    "framezaxis": (30, 3, "obj", 1),
    "framelinvel": (31, 3, "obj", 2),
    "frameangvel": (32, 3, "obj", 2),
    "framelinacc": (33, 3, "obj", 3),
    "frameangacc": (34, 3, "obj", 3),
    "subtreecom": (35, 3, "body", 1),
    "subtreelinvel": (36, 3, "body", 2),
    "subtreeangmom": (37, 3, "body", 2),
    "e_potential": (43, 1, "none", 1),
    "e_kinetic": (44, 1, "none", 2),
    "clock": (45, 1, "none", 1),
}
_OBJTYPE = {"body": 1, "xbody": 2, "joint": 3, "dof": 4, "geom": 5,
            "site": 6, "camera": 7, "tendon": 18, "actuator": 19, "none": 0}


def _f(attrs, key, default=None, n=None):
  """Float array attribute."""
  if key not in attrs:
    if default is None:
      return None
    v = np.array(default, dtype=np.float64)
  else:
    v = np.fromstring(attrs[key], sep=" ", dtype=np.float64)
  v = np.atleast_1d(v)
  if n is not None:
    out = np.zeros(n, dtype=np.float64)
    out[:min(n, len(v))] = v[:n]
    return out
  return v


def _s(attrs, key, default=None):
  return attrs.get(key, default)


def _b(attrs, key, default=False):
  v = attrs.get(key)
  if v is None:
    return default
  return v in ("true", "1")


class _AutoLimited:
  """limited="auto": infer from range presence (compiler autolimits)."""

  @staticmethod
  def parse(attrs, key, range_key, autolimits):
    v = attrs.get(key, "auto")
    if v == "auto":
      return 1 if (autolimits and range_key in attrs) else 0
    return 1 if v == "true" else 0


def _quat_from_attrs(attrs, deg: bool, eulerseq: str = "xyz"):
  """Orientation resolver (mjCAlternative::Set, user_objects.cc)."""
  if "quat" in attrs:
    q = _f(attrs, "quat", n=4)
    return q / max(np.linalg.norm(q), 1e-15)
  scale = math.pi / 180.0 if deg else 1.0
  if "euler" in attrs:
    e = _f(attrs, "euler", n=3) * scale
    q = np.array([1.0, 0, 0, 0])
    for axis_ch, ang in zip(eulerseq, e):
      axis = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1],
              "X": [1, 0, 0], "Y": [0, 1, 0], "Z": [0, 0, 1]}[axis_ch]
      r = _axis_angle_quat(np.array(axis, dtype=float), ang)
      if axis_ch.islower():
        q = _mulquat(q, r)       # intrinsic: post-multiply
      else:
        q = _mulquat(r, q)       # extrinsic: pre-multiply
    return q
  if "axisangle" in attrs:
    aa = _f(attrs, "axisangle", n=4)
    axis = aa[:3] / max(np.linalg.norm(aa[:3]), 1e-15)
    return _axis_angle_quat(axis, aa[3] * scale)
  if "xyaxes" in attrs:
    xy = _f(attrs, "xyaxes", n=6)
    x = xy[:3] / max(np.linalg.norm(xy[:3]), 1e-15)
    y = xy[3:]
    y = y - x * np.dot(x, y)
    y = y / max(np.linalg.norm(y), 1e-15)
    z = np.cross(x, y)
    return _mat2quat(np.stack([x, y, z], axis=1))
  if "zaxis" in attrs:
    z = _f(attrs, "zaxis", n=3)
    z = z / max(np.linalg.norm(z), 1e-15)
    # minimal rotation taking (0,0,1) to z (mjuu_z2quat)
    axis = np.cross(np.array([0.0, 0, 1]), z)
    s = np.linalg.norm(axis)
    if s < 1e-10:
      return np.array([1.0, 0, 0, 0]) if z[2] > 0 else \
          np.array([0.0, 1, 0, 0])
    ang = math.atan2(s, z[2])
    return _axis_angle_quat(axis / s, ang)
  return np.array([1.0, 0, 0, 0])


def _axis_angle_quat(axis, ang):
  return np.concatenate([[math.cos(ang / 2)], axis * math.sin(ang / 2)])


def _mulquat(a, b):
  w1, x1, y1, z1 = a
  w2, x2, y2, z2 = b
  return np.array([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _rotvec(v, q):
  w, r = q[0], q[1:]
  return v + 2 * np.cross(r, np.cross(r, v) + w * v)


def _conj(q):
  return q * np.array([1.0, -1, -1, -1])


def _mat2quat(mat):
  t = np.trace(mat)
  if t > 0:
    s = math.sqrt(t + 1.0) * 2
    return np.array([0.25 * s, (mat[2, 1] - mat[1, 2]) / s,
                     (mat[0, 2] - mat[2, 0]) / s,
                     (mat[1, 0] - mat[0, 1]) / s])
  i = int(np.argmax(np.diag(mat)))
  j, k = (i + 1) % 3, (i + 2) % 3
  s = math.sqrt(max(1e-15, 1.0 + mat[i, i] - mat[j, j] - mat[k, k])) * 2
  q = np.zeros(4)
  q[0] = (mat[k, j] - mat[j, k]) / s
  q[1 + i] = 0.25 * s
  q[1 + j] = (mat[j, i] + mat[i, j]) / s
  q[1 + k] = (mat[k, i] + mat[i, k]) / s
  return q / np.linalg.norm(q)


def _quat2mat(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _geom_mass_inertia(gtype: int, size, density: float,
                       mass: Optional[float], mesh: Optional[dict] = None):
  """Geom mass + diagonal inertia in the geom frame (mjCGeom::SetInertia,
  user_objects.cc). Returns (mass, diag_inertia(3,))."""
  if gtype == 7:  # mesh: volumetric quantities at unit density
    vol = mesh["volume"]
    m = mass if mass is not None else density * vol
    return m, mesh["principal"] * (m / vol)
  r = size[0]
  if gtype == 2:  # sphere
    vol = 4.0 / 3.0 * math.pi * r ** 3
    m = mass if mass is not None else density * vol
    i = 2.0 / 5.0 * m * r * r
    return m, np.array([i, i, i])
  if gtype == 3:  # capsule: cylinder + two half spheres
    h = size[1]
    vol_c = math.pi * r * r * (2 * h)
    vol_s = 4.0 / 3.0 * math.pi * r ** 3
    vol = vol_c + vol_s
    m = mass if mass is not None else density * vol
    mc = m * vol_c / vol
    ms = m * vol_s / vol
    # cylinder part
    izz = mc * r * r / 2
    ixx_c = mc * (r * r / 4 + h * h / 3)
    # sphere part: two hemispheres at ±h
    i_s = 2.0 / 5.0 * ms * r * r
    ixx_s = i_s + ms * (h * h + 3.0 / 8.0 * 2 * h * r)
    return m, np.array([ixx_c + ixx_s, ixx_c + ixx_s, izz + i_s])
  if gtype == 4:  # ellipsoid
    a, b, c = size[:3]
    vol = 4.0 / 3.0 * math.pi * a * b * c
    m = mass if mass is not None else density * vol
    return m, m / 5.0 * np.array([b * b + c * c, a * a + c * c,
                                  a * a + b * b])
  if gtype == 5:  # cylinder
    h = size[1]
    vol = math.pi * r * r * (2 * h)
    m = mass if mass is not None else density * vol
    izz = m * r * r / 2
    ixx = m * (3 * r * r + 4 * h * h) / 12.0
    return m, np.array([ixx, ixx, izz])
  if gtype == 6:  # box
    a, b, c = size[:3]
    vol = 8.0 * a * b * c
    m = mass if mass is not None else density * vol
    return m, m / 3.0 * np.array([b * b + c * c, a * a + c * c,
                                  a * a + b * b])
  if gtype in (0, 1):  # plane/hfield: massless
    return 0.0, np.zeros(3)
  raise NotImplementedError(
      "geom inertia for this type needs an explicit <inertial> "
      f"(geom type {gtype})")


class CompiledModel(SimpleNamespace):
  """Flat model arrays, attribute-compatible with the put_model surface."""
  is_mjtpu_compiled = True


def load_xml(xml: str, base_dir: Optional[str] = None,
             assets: Optional[dict] = None, device=None) -> "CompiledModel":
  """MJCF string → CompiledModel (mj_loadXML analog). `assets` is the
  mjVFS analog: a filename → bytes dict consulted before the filesystem by
  includes, mesh files, and texture files (the from_xml_string(assets=)
  contract). `device` is where set_const runs the engine: the CUDA card
  when None (raising where there is none), "cpu" on the host."""
  return compile_spec(parse_mjcf(xml, base_dir=base_dir, assets=assets),
                      device=device)


def load_xml_path(path: str, device=None) -> "CompiledModel":
  """Compile an MJCF file; <include> and meshdir resolve relative to it."""
  import os
  with open(path) as f:
    xml = f.read()
  base = os.path.dirname(os.path.abspath(path))
  spec = parse_mjcf(xml, base_dir=base)
  if "meshdir" in spec.compiler and not os.path.isabs(
      spec.compiler["meshdir"]):
    spec.compiler["meshdir"] = os.path.join(base, spec.compiler["meshdir"])
  elif "meshdir" not in spec.compiler:
    spec.compiler["meshdir"] = base
  return compile_spec(spec, device=device)


def compile_spec(spec: Spec, device=None) -> "CompiledModel":
  """Spec → CompiledModel: the numpy compile, then set_const on the
  port's engine on `device` (the CUDA card when None)."""
  from mujoco_tpu_torch.compiler import setconst
  from mujoco_tpu_torch.utils.device import default_device
  device = default_device(device)
  _expand_replicates(spec)
  c = _Compiler(spec)
  m = c.run()
  setconst.set_const(m, device=device)
  return m


# <replicate>: meta-element cloning a subtree count times with accumulated
# frame offsets and zero-padded name suffixes, pulling referencing
# actuators/sensors/tendons/equalities/contacts along with each copy
# (xml_native_reader.cc:2494-2562 + the mjs_attach suffix machinery,
# user_api.cc). Expanded here as a spec-level pass: each copy is wrapped in
# a <frame pos quat>, so downstream compilation needs no new machinery.
_REPL_REF_ATTRS = ("joint", "joint1", "joint2", "site", "geom", "geom1",
                   "geom2", "body1", "body2", "subtree1", "subtree2",
                   "tendon", "tendon1", "tendon2", "objname", "target",
                   "refname", "sidesite", "body")


def _expand_replicates(spec: Spec) -> None:
  deg = _s(spec.compiler, "angle", "degree") == "degree"
  eseq = _s(spec.compiler, "eulerseq", "xyz")

  def collect_names(el: Element, out):
    if "name" in el.attrs:
      out.add(el.attrs["name"])
    for c in el.children:
      collect_names(c, out)

  def rename(el: Element, names, suffix):
    if el.attrs.get("name") in names:
      el.attrs["name"] = el.attrs["name"] + suffix
    for a in _REPL_REF_ATTRS:
      if el.attrs.get(a) in names:
        el.attrs[a] = el.attrs[a] + suffix
    for c in el.children:
      rename(c, names, suffix)

  def references(el: Element, names) -> bool:
    if any(el.attrs.get(a) in names for a in _REPL_REF_ATTRS):
      return True
    return any(references(c, names) for c in el.children)

  def expand(parent: Element) -> None:
    new_children = []
    for el in parent.children:
      if el.kind != "replicate":
        expand(el)
        new_children.append(el)
        continue
      expand(el)                              # nested replicates first
      count = int(el.attrs["count"])
      offset = _f(el.attrs, "offset", [0, 0, 0], 3)
      rot = _quat_from_attrs(el.attrs, deg, eseq)
      euler = _f(el.attrs, "euler", [0, 0, 0], 3)
      sep = el.attrs.get("sep", "")
      ndigits = len(str(count))

      names = set()
      for c in el.children:
        collect_names(c, names)
      reffing = []                            # (list, element) to clone
      for lst in (spec.actuators, spec.sensors, spec.tendons,
                  spec.equalities, spec.contacts):
        for t in lst:
          if references(t, names):
            reffing.append((lst, t))

      pos = np.zeros(3)
      quat = np.array([1.0, 0, 0, 0])
      for i in range(count):
        suffix = sep + str(i).zfill(ndigits)
        # orientation recomputed from i*euler for precision
        # (xml_native_reader.cc:2536-2540); position accumulated by
        # mjuu_frameaccum
        qi = _quat_from_attrs({"euler": " ".join(repr(float(x) * i)
                                                 for x in euler)}, deg, eseq)
        frame = Element(kind="frame", attrs={
            "pos": " ".join(repr(float(x)) for x in pos),
            "quat": " ".join(repr(float(x)) for x in qi)})
        for c in el.children:
          cc = copy.deepcopy(c)
          rename(cc, names, suffix)
          frame.children.append(cc)
        new_children.append(frame)
        for lst, t in reffing:
          tt = copy.deepcopy(t)
          rename(tt, names, suffix)
          lst.append(tt)
        pos = pos + _rotvec(offset, quat)
        quat = _mulquat(quat, rot)
      for lst, t in reffing:
        lst.remove(t)
    parent.children[:] = new_children

  expand(spec.worldbody)


# builtin texture synthesis, byte-exact vs mjCTexture::Builtin2D /
# BuiltinCube (user_objects.cc:5024-5260; C double→byte casts truncate, as
# does numpy's astype(uint8))

def _tex_interp(c1, c2, pos):
  """interp (user_objects.cc:5025): sigmoid blend, alpha weights c1."""
  alpha = np.clip(0.5 * (1 + pos / np.sqrt(1 + pos * pos) * np.sqrt(2.0)),
                  0.0, 1.0)
  return (255 * (alpha[..., None] * c1 + (1 - alpha[..., None]) * c2)
          ).astype(np.uint8)


def _tex_checker(c1, c2, w, h):
  out = np.empty((h, w, 3), dtype=np.uint8)
  out[:] = (255 * c2).astype(np.uint8)
  out[:h // 2, :w // 2] = (255 * c1).astype(np.uint8)
  out[h // 2:, w // 2:] = (255 * c1).astype(np.uint8)
  return out


def _tex_marks(face, mark, markrgb, w, h):
  rgbm = (255 * markrgb).astype(np.uint8)
  if mark == "edge":
    face[:, 0] = rgbm
    face[:, w - 1] = rgbm
    face[0, :] = rgbm
    face[h - 1, :] = rgbm
  elif mark == "cross":
    face[:, w // 2] = rgbm
    face[h // 2, :] = rgbm
  elif mark == "random":
    raise NotImplementedError("mark='random' (uses the C RNG stream)")


def _builtin_2d(builtin, rgb1, rgb2, mark, markrgb, w, h):
  if builtin == "gradient":
    c = np.arange(w, dtype=np.float64)
    r = np.arange(h, dtype=np.float64)
    x = 2 * c[None, :] / (w - 1) - 1
    y = 1 - 2 * r[:, None] / (h - 1)
    pos = 2 * np.sqrt(x * x + y * y) - 1
    out = _tex_interp(np.asarray(rgb2), np.asarray(rgb1),
                      np.broadcast_to(pos, (h, w)))
  elif builtin == "checker":
    out = _tex_checker(rgb1, rgb2, w, h)
  elif builtin == "flat":
    out = np.broadcast_to((255 * np.asarray(rgb1)).astype(np.uint8),
                          (h, w, 3)).copy()
  else:
    raise NotImplementedError(f"texture builtin '{builtin}'")
  _tex_marks(out, mark, markrgb, w, h)
  return out.reshape(-1)


def _builtin_cube(builtin, rgb1, rgb2, mark, markrgb, w):
  faces = np.zeros((6, w, w, 3), dtype=np.uint8)
  if builtin == "gradient":
    c = np.arange(w, dtype=np.float64)
    r = np.arange(w, dtype=np.float64)
    x = np.broadcast_to(2 * c[None, :] / (w - 1) - 1, (w, w))
    y = np.broadcast_to(1 - 2 * r[:, None] / (w - 1), (w, w))
    den = np.sqrt(1 + x * x + y * y)
    elside = np.arcsin(y / den) / (0.5 * np.pi)
    elup = 1 - np.arccos(1.0 / den) / (0.5 * np.pi)
    side = _tex_interp(np.asarray(rgb1), np.asarray(rgb2), elside)
    for f in (0, 1, 4, 5):
      faces[f] = side
    faces[2] = _tex_interp(np.asarray(rgb1), np.asarray(rgb2), elup)
    faces[3] = _tex_interp(np.asarray(rgb1), np.asarray(rgb2), -elup)
  elif builtin == "checker":
    for f in (0, 1, 2, 3):
      faces[f] = _tex_checker(rgb1, rgb2, w, w)
    for f in (4, 5):
      faces[f] = _tex_checker(rgb2, rgb1, w, w)
  elif builtin == "flat":
    for f in (0, 1, 2, 4, 5):
      faces[f] = (255 * np.asarray(rgb1)).astype(np.uint8)
    faces[3] = (255 * np.asarray(rgb2)).astype(np.uint8)
  else:
    raise NotImplementedError(f"texture builtin '{builtin}'")
  for f in range(6):
    _tex_marks(faces[f], mark, markrgb, w, w)
  return faces.reshape(-1)


class _Compiler:
  def __init__(self, spec: Spec):
    self.spec = spec
    self.deg = _s(spec.compiler, "angle", "degree") == "degree"
    self.eulerseq = _s(spec.compiler, "eulerseq", "xyz")
    self.autolimits = _b(spec.compiler, "autolimits", True)
    # element accumulation lists
    self.bodies: List[dict] = []
    self.joints: List[dict] = []
    self.geoms: List[dict] = []
    self.sites: List[dict] = []
    self.cams: List[dict] = []
    self.lights: List[dict] = []
    self.meshes: List[dict] = []
    self.flexes: List[dict] = []
    self.hfields: List[dict] = []
    self.textures: List[dict] = []
    self.materials: List[dict] = []
    self.skins: List[dict] = []
    self._pending_skins: List[Element] = []
    self.names: Dict[str, Dict[str, int]] = {
        k: {} for k in ("body", "joint", "geom", "site", "camera", "light",
                        "actuator", "sensor", "tendon", "equality", "key",
                        "mesh", "hfield", "texture", "material", "skin")}

  # ----- passes ------------------------------------------------------------

  def run(self) -> CompiledModel:
    self._compile_assets()
    # world body
    self.bodies.append(dict(name="world", parentid=0, pos=np.zeros(3),
                            quat=np.array([1.0, 0, 0, 0]), mocap=False,
                            explicit_inertial=None, gravcomp=0.0,
                            jnt=[], geomids=[]))
    self.names["body"]["world"] = 0
    for child in self.spec.worldbody.children:
      self._compile_element(child, parent=0,
                            fpos=np.zeros(3), fquat=np.array([1.0, 0, 0, 0]))
    self._reorder_by_body()
    self._compile_skins()
    self._compute_inertia()
    self._address()
    self._compile_tendons()
    self._compile_actuators()
    self._compile_equalities()
    self._compile_contacts()
    self._compile_sensors()
    self._compile_keyframes()
    return self._emit()

  def _reorder_by_body(self) -> None:
    """The reference stores per-body element lists, so its global arrays
    come out grouped by body id (mjCModel list assembly, user_model.cc);
    a document-order walk interleaves world elements with body elements
    when a world geom/site/cam/light appears after a <body>. Stable-sort by
    body and remap ids so addressing (e.g. body_geomadr contiguity) and
    field ordering match."""
    def sort(lst, kind):
      order = sorted(range(len(lst)), key=lambda i: lst[i]["body"])
      if order == list(range(len(lst))):
        return {i: i for i in order}
      remap = {old: new for new, old in enumerate(order)}
      lst[:] = [lst[i] for i in order]
      nm = self.names[kind]
      for n in list(nm):
        nm[n] = remap[nm[n]]
      return remap

    gremap = sort(self.geoms, "geom")
    for b in self.bodies:
      b["geomids"] = sorted(gremap[g] for g in b["geomids"])
    sort(self.sites, "site")
    sort(self.cams, "camera")
    sort(self.lights, "light")

  # ----- tree --------------------------------------------------------------

  def _compile_element(self, el: Element, parent: int, fpos, fquat):
    if el.kind == "frame":
      pos = fpos + _rotvec(_f(el.attrs, "pos", [0, 0, 0], 3), fquat)
      quat = _mulquat(fquat, _quat_from_attrs(el.attrs, self.deg,
                                              self.eulerseq))
      for child in el.children:
        self._compile_element(child, parent, pos, quat)
      return
    if el.kind == "body":
      self._compile_body(el, parent, fpos, fquat)
      return
    handler = {"joint": self._compile_joint, "geom": self._compile_geom,
               "site": self._compile_site, "camera": self._compile_camera,
               "light": self._compile_light,
               "inertial": self._compile_inertial,
               "flexcomp": self._compile_flexcomp,
               "composite": self._compile_composite}[el.kind]
    handler(el, parent, fpos, fquat)

  def _compile_body(self, el: Element, parent: int, fpos, fquat):
    bid = len(self.bodies)
    pos = fpos + _rotvec(_f(el.attrs, "pos", [0, 0, 0], 3), fquat)
    quat = _mulquat(fquat, _quat_from_attrs(el.attrs, self.deg,
                                            self.eulerseq))
    name = _s(el.attrs, "name", f"body{bid}")
    self.bodies.append(dict(
        name=name, parentid=parent, pos=pos, quat=quat,
        sleep=_s(el.attrs, "sleep", "auto"),
        mocap=_b(el.attrs, "mocap", False),
        gravcomp=float(_s(el.attrs, "gravcomp", "0")),
        explicit_inertial=None, jnt=[], geomids=[]))
    self.names["body"][name] = bid
    for child in el.children:
      self._compile_element(child, bid, np.zeros(3),
                            np.array([1.0, 0, 0, 0]))

  def _compile_joint(self, el: Element, body: int, fpos, fquat):
    a = el.attrs
    jid = len(self.joints)
    jtype = _JNTTYPES[_s(a, "type", "hinge")]
    scale = math.pi / 180.0 if self.deg else 1.0
    rng = _f(a, "range", [0, 0], 2)
    if jtype in (1, 3):
      rng = rng * scale
    axis = _f(a, "axis", [0, 0, 1], 3)
    axis = axis / max(np.linalg.norm(axis), 1e-15)
    name = _s(a, "name", f"joint{jid}")
    self.joints.append(dict(
        name=name, body=body, type=jtype,
        pos=fpos + _rotvec(_f(a, "pos", [0, 0, 0], 3), fquat),
        axis=_rotvec(axis, fquat),
        ref=float(_s(a, "ref", "0")) * (scale if jtype in (1, 3) else 1.0),
        springref=float(_s(a, "springref", "0"))
        * (scale if jtype in (1, 3) else 1.0),
        stiffness=float(_s(a, "stiffness", "0")),
        damping=float(_s(a, "damping", "0")),
        armature=float(_s(a, "armature", "0")),
        frictionloss=float(_s(a, "frictionloss", "0")),
        limited=_AutoLimited.parse(a, "limited", "range", self.autolimits),
        range=rng,
        margin=float(_s(a, "margin", "0")) * (scale if jtype == 3 else 1.0),
        solref=_f(a, "solreflimit", _SOLREF, 2),
        solimp=_f(a, "solimplimit", _SOLIMP, 5),
        actfrclimited=_AutoLimited.parse(a, "actuatorfrclimited",
                                         "actuatorfrcrange", self.autolimits),
        actfrcrange=_f(a, "actuatorfrcrange", [0, 0], 2),
        actgravcomp=_b(a, "actuatorgravcomp", False),
    ))
    self.names["joint"][name] = jid
    self.bodies[body]["jnt"].append(jid)

  def _compile_geom(self, el: Element, body: int, fpos, fquat):
    a = el.attrs
    gid = len(self.geoms)
    gtype = _GEOMTYPES[_s(a, "type", "sphere")]
    size = _f(a, "size", [0, 0, 0], 3)
    pos = fpos + _rotvec(_f(a, "pos", [0, 0, 0], 3), fquat)
    quat = _mulquat(fquat, _quat_from_attrs(a, self.deg, self.eulerseq))
    if "fromto" in a:
      ft = _f(a, "fromto", n=6)
      p1, p2 = ft[:3], ft[3:]
      mid = 0.5 * (p1 + p2)
      dvec = p1 - p2  # reference convention: z along from-to reversed
      ln = np.linalg.norm(dvec)
      pos = fpos + _rotvec(mid, fquat)
      zq = _quat_from_attrs({"zaxis": f"{dvec[0]} {dvec[1]} {dvec[2]}"},
                            self.deg)
      quat = _mulquat(fquat, zq)
      size = np.array([size[0], ln / 2, 0.0])
    dataid = -1
    if gtype == 7:
      dataid = self.names["mesh"][a["mesh"]]
      # compose the mesh's removed CoM/principal transform into the geom
      # frame (mjCGeom::Compile mesh branch, user_objects.cc)
      md = self.meshes[dataid]
      pos = pos + _rotvec(md["pos"], quat)
      quat = _mulquat(quat, md["quat"])
    elif "mesh" in a and a["mesh"]:
      # geom fitting: primitive sized to the referenced mesh
      # (mjCMesh::FitGeom, user_mesh.cc:944-1018 + the frame accumulation
      # in mjCGeom::Compile, user_objects.cc:4043-4060)
      md = self.meshes[self.names["mesh"][a["mesh"]]]
      fitscale = float(_s(a, "fitscale", "1"))
      center = np.zeros(3)
      if _b(self.spec.compiler, "fitaabb", False):
        vmin = md["verts"].min(axis=0)
        vmax = md["verts"].max(axis=0)
        center = 0.5 * (vmin + vmax)
        half = vmax - center
        if gtype == 2:                       # sphere
          size = np.array([half.max(), 0, 0])
        elif gtype in (3, 5):                # capsule / cylinder
          r = max(half[0], half[1])
          hz = half[2] - (r if gtype == 3 else 0.0)
          size = np.array([r, hz, 0])
        elif gtype in (4, 6):                # ellipsoid / box
          size = half.copy()
        else:
          raise ValueError(f"invalid geom type {gtype} in mesh fitting")
      else:
        # equivalent-inertia box (boxsz_, user_mesh.cc:1506-1510)
        ev = np.asarray(md["principal"], dtype=np.float64)
        vol = md["volume"]
        bs = 0.5 * np.sqrt(np.maximum(
            6 * (ev.sum() - 2 * ev) / max(vol, 1e-15), 0.0))
        if gtype == 2:                       # sphere
          size = np.array([bs.mean(), 0, 0])
        elif gtype == 3:                     # capsule
          r = (bs[0] + bs[1]) / 2
          size = np.array([r, max(0.0, bs[2] - r / 2), 0])
        elif gtype == 5:                     # cylinder
          size = np.array([(bs[0] + bs[1]) / 2, bs[2], 0])
        elif gtype in (4, 6):                # ellipsoid / box
          size = bs.copy()
        else:
          raise ValueError(f"invalid geom type {gtype} in mesh fitting")
      size = size * fitscale
      meshpos = md["pos"] + _rotvec(center, md["quat"])
      pos = pos + _rotvec(meshpos, quat)
      quat = _mulquat(quat, md["quat"])
    if gtype == 1:
      dataid = self.names["hfield"][a["hfield"]]
    name = _s(a, "name", f"geom{gid}")
    matid = (self.names["material"][a["material"]] if "material" in a
             and a["material"] else -1)
    self.geoms.append(dict(
        name=name, body=body, type=gtype, size=size, pos=pos, quat=quat,
        matid=matid,
        contype=int(_s(a, "contype", "1")),
        conaffinity=int(_s(a, "conaffinity", "1")),
        condim=int(_s(a, "condim", "3")),
        group=int(_s(a, "group", "0")),
        priority=int(_s(a, "priority", "0")),
        rgba=_f(a, "rgba", [0.5, 0.5, 0.5, 1], 4),
        friction=_f(a, "friction", [1, 0.005, 0.0001], 3),
        solmix=float(_s(a, "solmix", "1")),
        solref=_f(a, "solref", _SOLREF, 2),
        solimp=_f(a, "solimp", _SOLIMP, 5),
        margin=float(_s(a, "margin", "0")),
        gap=float(_s(a, "gap", "0")),
        density=float(_s(a, "density", "1000")),
        mass=float(a["mass"]) if "mass" in a else None,
        dataid=dataid,
    ))
    self.names["geom"][name] = gid
    self.bodies[body]["geomids"].append(gid)

  def _compile_site(self, el: Element, body: int, fpos, fquat):
    a = el.attrs
    sid = len(self.sites)
    name = _s(a, "name", f"site{sid}")
    stype = _GEOMTYPES[_s(a, "type", "sphere")]
    self.sites.append(dict(
        name=name, body=body, type=stype,
        size=_f(a, "size", [0.005, 0.005, 0.005], 3),
        pos=fpos + _rotvec(_f(a, "pos", [0, 0, 0], 3), fquat),
        quat=_mulquat(fquat, _quat_from_attrs(a, self.deg, self.eulerseq))))
    self.names["site"][name] = sid

  def _compile_camera(self, el: Element, body: int, fpos, fquat):
    a = el.attrs
    cid = len(self.cams)
    name = _s(a, "name", f"camera{cid}")
    self.cams.append(dict(
        name=name, body=body,
        mode=_CAMLIGHT_MODES[_s(a, "mode", "fixed")],
        target=_s(a, "target"),
        pos=fpos + _rotvec(_f(a, "pos", [0, 0, 0], 3), fquat),
        quat=_mulquat(fquat, _quat_from_attrs(a, self.deg, self.eulerseq)),
        fovy=float(_s(a, "fovy", "45")),
        projection={"perspective": 0, "orthographic": 1}[
            _s(a, "projection", "perspective")],
        resolution=_f(a, "resolution", [1, 1], 2),
        intrinsic=_f(a, "intrinsic", [0, 0, 0, 0], 4),
        sensorsize=_f(a, "sensorsize", [0, 0], 2)))
    self.names["camera"][name] = cid

  def _compile_light(self, el: Element, body: int, fpos, fquat):
    a = el.attrs
    lid = len(self.lights)
    name = _s(a, "name", f"light{lid}")
    d = _f(a, "dir", [0, 0, -1], 3)
    # light type: explicit type attr wins, else the legacy directional flag
    # (mjs_defaultLight: spot; xml_native_reader.cc light section)
    ltype = {"spot": 0, "directional": 1, "point": 2, "image": 3}.get(
        _s(a, "type", ""), 1 if _b(a, "directional", False) else 0)
    self.lights.append(dict(
        name=name, body=body,
        mode=_CAMLIGHT_MODES[_s(a, "mode", "fixed")],
        target=_s(a, "target"),
        pos=fpos + _rotvec(_f(a, "pos", [0, 0, 0], 3), fquat),
        dir=_rotvec(d / max(np.linalg.norm(d), 1e-15), fquat),
        type=ltype,
        active=_b(a, "active", True),
        castshadow=_b(a, "castshadow", True),
        ambient=_f(a, "ambient", [0, 0, 0], 3),
        diffuse=_f(a, "diffuse", [0.7, 0.7, 0.7], 3),
        specular=_f(a, "specular", [0.3, 0.3, 0.3], 3),
        attenuation=_f(a, "attenuation", [1, 0, 0], 3),
        cutoff=float(_s(a, "cutoff", "45")),
        exponent=float(_s(a, "exponent", "10"))))
    self.names["light"][name] = lid

  def _compile_inertial(self, el: Element, body: int, fpos, fquat):
    a = el.attrs
    mass = float(a["mass"])
    ipos = fpos + _rotvec(_f(a, "pos", [0, 0, 0], 3), fquat)
    iquat = _mulquat(fquat, _quat_from_attrs(a, self.deg, self.eulerseq))
    if "diaginertia" in a:
      inertia = _f(a, "diaginertia", n=3)
    elif "fullinertia" in a:
      fi = _f(a, "fullinertia", n=6)
      mat = np.array([[fi[0], fi[3], fi[4]],
                      [fi[3], fi[1], fi[5]],
                      [fi[4], fi[5], fi[2]]])
      vals, fiq = _eig3(mat)
      inertia = vals
      iquat = _mulquat(iquat, fiq)
    else:
      inertia = np.zeros(3)
    self.bodies[body]["explicit_inertial"] = (mass, ipos, iquat, inertia)

  def _compile_composite(self, el: Element, body: int, fpos, fquat):
    """<composite> expansion (mjCComposite, user_composite.cc). Supported:
    type="cable" with curve="s" — a serial chain of ball-jointed segment
    bodies (B_first, B_1, ..., B_last), capsule/cylinder/box geoms along
    the local x axis; initial="none" welds the head, "free" adds a free
    joint. Other composite types are superseded by flexcomp and raise."""
    a = el.attrs
    ctype = _s(a, "type", "particle")
    if ctype != "cable":
      # parity with the reference: every non-cable composite type is a
      # deprecation error there too (user_composite.cc:191-224)
      replacement = {"particle": "replicate", "grid": "flex",
                     "rope": "cable", "loop": "flexcomp",
                     "cloth": "shell"}.get(ctype)
      if replacement:
        raise ValueError(
            f'The "{ctype}" composite type is deprecated. Please use '
            f'"{replacement}" instead.')
      raise ValueError("Unknown shape in composite")
    if _s(a, "curve", "s") != "s":
      raise NotImplementedError("cable composite with a non-straight curve")
    cnt = [int(x) for x in _s(a, "count", "20 1 1").split()]
    n = cnt[0]
    length = float(_s(a, "size", "1").split()[0])
    offset = _f(a, "offset", [0, 0, 0], 3)
    initial = _s(a, "initial", "free")
    prefix = _s(a, "prefix", "")

    geom_a: Dict[str, str] = {}
    joint_a: Dict[str, str] = {}
    for c in el.children:
      if c.kind == "geom":
        geom_a.update(c.attrs)
      elif c.kind == "joint":
        if c.attrs.get("kind", "main") != "main":
          raise NotImplementedError("cable joint kind != main")
        joint_a.update({k: v for k, v in c.attrs.items() if k != "kind"})
      else:
        raise NotImplementedError(f"cable composite child <{c.kind}>")

    seg = length / (n - 1)
    gtype = geom_a.get("type", "capsule")
    radius = float(geom_a.get("size", "0.01").split()[0])
    half = seg / 2
    gattrs = dict(geom_a)
    gattrs.pop("type", None)
    gattrs.pop("size", None)
    # capsule/cylinder along local +x: zaxis -> x
    gattrs.update(type=gtype, pos=f"{half!r} 0 0", quat=_CABLE_GEOM_QUAT,
                  size=f"{radius!r} {half!r}" if gtype in ("capsule",
                                                           "cylinder")
                  else f"{half!r} {radius!r} {radius!r}")

    parent_el = None
    top = None
    for i in range(n - 1):
      name = (f"{prefix}B_first" if i == 0 else
              (f"{prefix}B_last" if i == n - 2 else f"{prefix}B_{i}"))
      battrs = {"name": name,
                "pos": (" ".join(repr(float(x)) for x in offset)
                        if i == 0 else f"{seg!r} 0 0")}
      bel = Element(kind="body", attrs=battrs)
      if i == 0:
        if initial == "free":
          bel.children.append(Element(kind="joint", attrs={"type": "free"}))
        elif initial == "ball":
          bel.children.append(Element(
              kind="joint", attrs=dict(joint_a, type="ball")))
        elif initial != "none":
          raise NotImplementedError(f"cable initial='{initial}'")
      else:
        bel.children.append(Element(kind="joint",
                                    attrs=dict(joint_a, type="ball")))
      bel.children.append(Element(kind="geom", attrs=dict(gattrs)))
      if parent_el is None:
        top = bel
      else:
        parent_el.children.append(bel)
      parent_el = bel
    if top is not None:
      self._compile_body(top, body, fpos, fquat)

  def _compile_flexcomp(self, el: Element, body: int, fpos, fquat):
    """Procedural flex generation (mjCFlexcomp, user_flexcomp.cc): grid /
    direct vertex layouts -> per-vertex slide-jointed point bodies (pinned
    vertices ride the parent body), line/triangle/tetrahedron elements and
    deduplicated edges. Covers dim-1 (cable), dim-2 (shell) and dim-3
    (solid, 6 tets per grid cube — MakeGrid cube2tets,
    user_flexcomp.cc:903-946)."""
    a = el.attrs
    fid = len(self.flexes)
    name = _s(a, "name", f"flex{fid}")
    dim = int(_s(a, "dim", "2"))
    if dim not in (1, 2, 3):
      raise ValueError(f"flexcomp dim {dim}")
    radius = float(_s(a, "radius", "0.005"))
    mass = float(_s(a, "mass", "1"))
    pos = fpos + _rotvec(_f(a, "pos", [0, 0, 0], 3), fquat)
    quat = _mulquat(fquat, _quat_from_attrs(a, self.deg, self.eulerseq))

    pins = set()
    edge_a: Dict[str, str] = {}
    contact_a: Dict[str, str] = {}
    for c in el.children:
      if c.kind == "pin":
        for tok in c.attrs.get("id", "").split():
          pins.add(int(tok))
      elif c.kind == "edge":
        edge_a.update(c.attrs)
      elif c.kind == "contact":
        contact_a.update(c.attrs)
      else:
        raise NotImplementedError(f"flexcomp child <{c.kind}>")

    ftype = _s(a, "type", "grid")
    if ftype == "grid":
      cnt = [int(x) for x in _s(a, "count", "10 10 10").split()]
      cnt += [1] * (3 - len(cnt))
      nx, ny, nz = cnt[:3]
      if dim < 3 and nz != 1:
        raise ValueError("dim<3 grid flexcomp needs count '... 1'")
      spacing = _f(a, "spacing", [0.02, 0.02, 0.02], 3)
      verts = []                                 # x-major vertex order:
      for ix in range(nx):                       # id = (ix*ny + iy)*nz + iz
        for iy in range(ny):
          for iz in range(nz):
            verts.append(np.array([(ix - (nx - 1) / 2) * spacing[0],
                                   (iy - (ny - 1) / 2) * spacing[1],
                                   (iz - (nz - 1) / 2) * spacing[2]]))
      if dim == 1:
        if ny != 1:
          raise ValueError("dim-1 flexcomp needs count of the form 'n 1 1'")
        elems = [(i, i + 1) for i in range(nx - 1)]
      elif dim == 2:
        elems = []
        for ix in range(nx - 1):                 # two triangles per cell
          for iy in range(ny - 1):
            v00 = ix * ny + iy
            v01 = v00 + 1
            v10 = v00 + ny
            v11 = v10 + 1
            elems.append((v00, v10, v11))
            elems.append((v00, v11, v01))
      else:
        # 6 tetrahedra per cube (cube2tets, user_flexcomp.cc:903-910)
        cube2tets = ((0, 3, 1, 7), (0, 1, 4, 7), (1, 3, 2, 7),
                     (1, 2, 6, 7), (1, 5, 4, 7), (1, 6, 5, 7))
        elems = []
        for ix in range(nx - 1):
          for iy in range(ny - 1):
            for iz in range(nz - 1):
              c = [(ix + 0) * ny * nz + (iy + 0) * nz + iz + 0,
                   (ix + 1) * ny * nz + (iy + 0) * nz + iz + 0,
                   (ix + 1) * ny * nz + (iy + 1) * nz + iz + 0,
                   (ix + 0) * ny * nz + (iy + 1) * nz + iz + 0,
                   (ix + 0) * ny * nz + (iy + 0) * nz + iz + 1,
                   (ix + 1) * ny * nz + (iy + 0) * nz + iz + 1,
                   (ix + 1) * ny * nz + (iy + 1) * nz + iz + 1,
                   (ix + 0) * ny * nz + (iy + 1) * nz + iz + 1]
              for t in cube2tets:
                elems.append(tuple(c[v] for v in t))
    elif ftype == "direct":
      pts = _f(a, "point").reshape(-1, 3)
      verts = [p for p in pts]
      ei = _f(a, "element").astype(np.int32).reshape(-1, dim + 1)
      elems = [tuple(int(x) for x in row) for row in ei]
    else:
      raise NotImplementedError(f"flexcomp type '{ftype}'")

    # reorder tets so right-handed face orientation points outward
    # (mjCFlex::Compile, user_mesh.cc:4842-4863): faces are (0,1,2),
    # (0,2,3), (0,3,1), (1,3,2); wrong-handed tets swap v1<->v2
    if dim == 3:
      fixed = []
      for el_v in elems:
        p = [np.asarray(verts[v]) for v in el_v]
        if np.dot(np.cross(p[1] - p[0], p[2] - p[0]), p[3] - p[0]) > 0:
          el_v = (el_v[0], el_v[2], el_v[1], el_v[3])
        fixed.append(el_v)
      elems = fixed

    # edges per element in reference order (eledge simplex connectivity,
    # user_mesh.cc:3390): dim-1 elements ARE the edges; dim-2 triangles
    # contribute (v1,v2), (v2,v0), (v0,v1); dim-3 tets contribute
    # (v0,v1), (v1,v2), (v2,v0), (v2,v3), (v0,v3), (v1,v3)
    eledge = {1: ((0, 1),),
              2: ((1, 2), (2, 0), (0, 1)),
              3: ((0, 1), (1, 2), (2, 0), (2, 3), (0, 3), (1, 3))}
    edges, seen = [], set()
    for el_v in elems:
      for i, j in eledge[dim]:
        k = (min(el_v[i], el_v[j]), max(el_v[i], el_v[j]))
        if k not in seen:
          seen.add(k)
          edges.append(k)

    nvert = len(verts)
    vmass = mass / nvert
    # vertex rotational inertia: box of half-size `inertiabox`
    # (mjCFlexcomp inertiabox attribute, default 0.005 -- independent of
    # the contact radius)
    ibox = float(_s(a, "inertiabox", "0.005"))
    ih = (vmass / 3.0) * (2.0 * ibox * ibox)
    vertbody, vert_off = [], []
    for i, v in enumerate(verts):
      p = pos + _rotvec(v, quat)
      if i in pins:
        vertbody.append(body)
        vert_off.append(p)
      else:
        bid = len(self.bodies)
        bel = Element(kind="body", attrs={
            "name": f"{name}_{i}",
            "pos": " ".join(repr(float(x)) for x in p)})
        for ax in ("1 0 0", "0 1 0", "0 0 1"):
          bel.children.append(Element(kind="joint",
                                      attrs={"type": "slide", "axis": ax}))
        bel.children.append(Element(kind="inertial", attrs={
            "pos": "0 0 0", "mass": repr(vmass),
            "diaginertia": f"{ih!r} {ih!r} {ih!r}"}))
        self._compile_body(bel, body, np.zeros(3),
                           np.array([1.0, 0, 0, 0]))
        self.bodies[bid]["flex_simple"] = True
        vertbody.append(bid)
        vert_off.append(np.zeros(3))

    self.names.setdefault("flex", {})[name] = fid
    self.flexes.append(dict(
        name=name, dim=dim, radius=radius, verts=vert_off,
        vertbody=vertbody, elems=elems, edges=edges, pins=pins,
        centered=not pins, edge_attrs=edge_a, contact_attrs=contact_a))

  # ----- assets ------------------------------------------------------------

  def _compile_assets(self):
    mesh_vert, mesh_face = [], []
    hf_data = []
    mats: List[Element] = []
    skins: List[Element] = []
    for el in self.spec.assets:
      if el.kind == "mesh":
        if "vertex" in el.attrs:
          verts = _f(el.attrs, "vertex").reshape(-1, 3)
          faces = (_f(el.attrs, "face").astype(np.int32).reshape(-1, 3)
                   if "face" in el.attrs else None)
          default_name = f"mesh{len(self.meshes)}"
        elif "file" in el.attrs:
          from mujoco_tpu_torch.compiler import mesh_io
          from mujoco_tpu_torch.compiler.parser import vfs_find
          meshdir = _s(self.spec.compiler, "meshdir", "")
          path = os.path.join(meshdir, el.attrs["file"])
          data = vfs_find(getattr(self.spec, "vfs", None), el.attrs["file"])
          verts, faces = mesh_io.load_mesh_file(path, data=data)
          default_name = os.path.splitext(
              os.path.basename(el.attrs["file"]))[0]
        else:
          raise NotImplementedError("mesh asset needs vertex or file data")
        name = _s(el.attrs, "name", default_name)
        scale = _f(el.attrs, "scale", [1, 1, 1], 3)
        verts = verts * scale
        if faces is None or len(faces) == 0:
          faces = _convex_hull_faces(verts)
        # volumetric CoM + principal frame (mjCMesh::Compile inertia
        # processing, user_mesh.cc): re-center, rotate, remember (pos, quat)
        from mujoco_tpu_torch.compiler import mesh_io
        vol, com, imat = mesh_io.volumetric_frame(verts, faces)
        vals, mq = _eig3(imat)
        rot = _quat2mat(mq)
        verts = (verts - com) @ rot                      # rows are axes
        self.names["mesh"][name] = len(self.meshes)
        self.meshes.append(dict(name=name, verts=verts, faces=faces,
                                pos=com, quat=mq, volume=vol,
                                principal=vals))
      elif el.kind == "hfield":
        name = _s(el.attrs, "name", f"hfield{len(self.hfields)}")
        if "file" in el.attrs:
          # grayscale PNG, image rows reversed so data row 0 is the south
          # edge (mjCHField::LoadPNG, user_objects.cc)
          from PIL import Image
          from mujoco_tpu_torch.compiler.parser import vfs_find
          import io as _io
          blob = vfs_find(getattr(self.spec, "vfs", None),
                          el.attrs["file"])
          meshdir = _s(self.spec.compiler, "meshdir", "")
          img = Image.open(_io.BytesIO(blob) if blob is not None
                           else os.path.join(meshdir, el.attrs["file"]))
          arr = np.asarray(img.convert("L"), dtype=np.float64)
          data = arr[::-1].reshape(-1)
          nrow, ncol = arr.shape
        else:
          nrow = int(el.attrs["nrow"])
          ncol = int(el.attrs["ncol"])
          if "elevation" in el.attrs:
            data = _f(el.attrs, "elevation")
            if data.size != nrow * ncol:
              raise ValueError("elevation data length must match nrow*ncol")
            # rows are given top-first in the XML, stored south-first
            # (xml_native_reader.cc hfield elevation reversal)
            data = data.reshape(nrow, ncol)[::-1].reshape(-1)
          else:
            data = np.zeros(nrow * ncol, dtype=np.float64)
        # normalize elevation to [0, 1] (mjCHField::Compile)
        emin, emax = data.min(), data.max()
        data = data - emin
        if emax - emin > 1e-10:
          data = data / (emax - emin)
        self.names["hfield"][name] = len(self.hfields)
        self.hfields.append(dict(
            name=name, nrow=nrow, ncol=ncol,
            size=_f(el.attrs, "size", n=4),
            data=data.astype(np.float64)))
      elif el.kind == "texture":
        self._compile_texture(el)
      elif el.kind == "material":
        mats.append(el)                  # second pass: may reference textures
      elif el.kind == "skin":
        skins.append(el)                 # after bodies: resolves body names
      else:
        raise NotImplementedError(f"asset <{el.kind}>")
    for el in mats:
      self._compile_material(el)
    self._pending_skins = skins

  def _compile_texture(self, el: Element) -> None:
    """<texture>: builtin pattern synthesis byte-exact vs mjCTexture
    (Builtin2D/BuiltinCube, user_objects.cc:5069,5142) or PNG/image file
    loading; cube/skybox builtins store 6 stacked w×w faces
    (tex_height = 6*width)."""
    a = el.attrs
    tid = len(self.textures)
    ttype = {"2d": 0, "cube": 1, "skybox": 2}[_s(a, "type", "cube")]
    builtin = _s(a, "builtin", "none")
    rgb1 = _f(a, "rgb1", [0.8, 0.8, 0.8], 3)
    rgb2 = _f(a, "rgb2", [0.5, 0.5, 0.5], 3)
    mark = _s(a, "mark", "none")
    markrgb = _f(a, "markrgb", [0, 0, 0], 3)
    w = int(_s(a, "width", "0"))
    h = int(_s(a, "height", "0"))
    if "file" in a:
      if ttype != 0:
        raise NotImplementedError("cube/skybox file textures")
      from PIL import Image
      from mujoco_tpu_torch.compiler.parser import vfs_find
      texturedir = _s(self.spec.compiler, "texturedir", "")
      data = vfs_find(getattr(self.spec, "vfs", None), a["file"])
      if data is not None:
        import io as _io
        img = Image.open(_io.BytesIO(data)).convert("RGB")
      else:
        img = Image.open(os.path.join(texturedir, a["file"])).convert("RGB")
      data = np.asarray(img, dtype=np.uint8)
      if _b(a, "vflip", False):
        data = data[::-1]
      if _b(a, "hflip", False):
        data = data[:, ::-1]
      h, w = data.shape[:2]
      flat = np.ascontiguousarray(data).reshape(-1)
      name = _s(a, "name", os.path.splitext(os.path.basename(a["file"]))[0])
    elif builtin != "none":
      if w <= 0:
        raise ValueError("builtin texture needs width")
      if ttype == 0:
        if h <= 0:
          raise ValueError("builtin 2d texture needs height")
        flat = _builtin_2d(builtin, rgb1, rgb2, mark, markrgb, w, h)
      else:
        flat = _builtin_cube(builtin, rgb1, rgb2, mark, markrgb, w)
        h = 6 * w
      name = _s(a, "name", f"texture{tid}")
    else:
      raise NotImplementedError("texture without file or builtin")
    self.names["texture"][name] = tid
    self.textures.append(dict(name=name, type=ttype, width=w, height=h,
                              data=flat))

  def _compile_skins(self) -> None:
    """<skin> assets with inline <bone> children (mjCSkin::Compile,
    user_mesh.cc:3114-3262): per-vertex weight normalization, bindquat
    normalization, body/material name resolution. Runs after the tree walk
    so bone body names resolve. SKN files are not supported (inline only)."""
    for el in self._pending_skins:
      a = el.attrs
      if "file" in a:
        raise NotImplementedError("skin .skn files (use inline skin data)")
      sid = len(self.skins)
      name = _s(a, "name", f"skin{sid}")
      verts = _f(a, "vertex").reshape(-1, 3)
      faces = _f(a, "face").astype(np.int32).reshape(-1, 3)
      texcoord = (_f(a, "texcoord").reshape(-1, 2)
                  if "texcoord" in a else np.zeros((0, 2)))
      matname = _s(a, "material", "")
      bones = []
      for c in el.children:
        if c.kind != "bone":
          raise NotImplementedError(f"skin child <{c.kind}>")
        ca = c.attrs
        q = _f(ca, "bindquat", [1, 0, 0, 0], 4)
        bones.append(dict(
            body=self.names["body"][ca["body"]],
            bindpos=_f(ca, "bindpos", [0, 0, 0], 3),
            bindquat=q / max(np.linalg.norm(q), 1e-15),
            vertid=_f(ca, "vertid").astype(np.int32),
            vertweight=_f(ca, "vertweight")))
      if not bones:
        raise ValueError(f"skin {name} has no bones")
      # normalize weights so each vertex's total is 1
      vw = np.zeros(len(verts))
      for b in bones:
        np.add.at(vw, b["vertid"], b["vertweight"])
      if (vw <= 1e-15).any():
        raise ValueError(f"skin {name}: vertex with zero total weight")
      for b in bones:
        b["vertweight"] = b["vertweight"] / vw[b["vertid"]]
      self.skins.append(dict(
          name=name, verts=verts, faces=faces, texcoord=texcoord,
          matid=self.names["material"][matname] if matname else -1,
          rgba=_f(a, "rgba", [1, 1, 1, 1], 4),
          inflate=float(_s(a, "inflate", "0")),
          group=int(_s(a, "group", "0")),
          bones=bones))
      self.names["skin"][name] = sid

  def _compile_material(self, el: Element) -> None:
    """<material> (mjs_defaultMaterial, user_init.c:284-292)."""
    a = el.attrs
    mid = len(self.materials)
    name = a["name"]
    texname = _s(a, "texture", "")
    self.materials.append(dict(
        name=name,
        texid=self.names["texture"][texname] if texname else -1,
        texrepeat=_f(a, "texrepeat", [1, 1], 2),
        texuniform=_b(a, "texuniform", False),
        emission=float(_s(a, "emission", "0")),
        specular=float(_s(a, "specular", "0.5")),
        shininess=float(_s(a, "shininess", "0.5")),
        reflectance=float(_s(a, "reflectance", "0")),
        rgba=_f(a, "rgba", [1, 1, 1, 1], 4)))
    self.names["material"][name] = mid

  # ----- inertia -----------------------------------------------------------

  def _compute_inertia(self):
    inertiafromgeom = _s(self.spec.compiler, "inertiafromgeom", "auto")
    for b, body in enumerate(self.bodies):
      if b == 0:
        body.update(mass=0.0, ipos=np.zeros(3),
                    iquat=np.array([1.0, 0, 0, 0]), inertia=np.zeros(3))
        continue
      use_geom = (inertiafromgeom == "true"
                  or (inertiafromgeom == "auto"
                      and body["explicit_inertial"] is None))
      if not use_geom and body["explicit_inertial"] is not None:
        mass, ipos, iquat, inertia = body["explicit_inertial"]
        body.update(mass=mass, ipos=ipos, iquat=iquat, inertia=inertia)
        continue
      # accumulate geom inertias (mjCBody::InertiaFromGeom,
      # user_objects.cc:2457): geoms with tiny mass are skipped; a single
      # geom copies its frame verbatim; multiple geoms eig-decompose with
      # the reference's exact Jacobi solver
      sel = []
      for gid in body["geomids"]:
        g = self.geoms[gid]
        gm, gi = _geom_mass_inertia(
            g["type"], g["size"], g["density"], g["mass"],
            self.meshes[g["dataid"]] if g["type"] == 7 else None)
        if gm > 1e-14:
          sel.append((g, gm, gi))
      if not sel:
        body.update(mass=0.0, ipos=np.zeros(3),
                    iquat=np.array([1.0, 0, 0, 0]), inertia=np.zeros(3))
        continue
      if len(sel) == 1:
        g, gm, gi = sel[0]
        body.update(mass=gm, ipos=g["pos"].copy(), iquat=g["quat"].copy(),
                    inertia=gi)
        continue
      total_m = sum(gm for _, gm, _ in sel)
      com = sum(gm * g["pos"] for g, gm, _ in sel) / total_m
      itot = np.zeros((3, 3))
      for g, gm, gi in sel:
        rot = _quat2mat(g["quat"])
        i_world = rot @ np.diag(gi) @ rot.T
        r = g["pos"] - com
        i_world += gm * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
        itot += i_world
      vals, quat = _eig3(itot)
      body.update(mass=total_m, ipos=com, iquat=quat, inertia=vals)

def _eig3(mat):
  """Faithful port of the reference's Jacobi eigensolver (mju_eig3,
  engine_util_solve.c:1089-1181): same rotation order, quaternion
  accumulation, and descending bubble sort — so principal inertia frames
  are BIT-compatible with the reference compiler even in degenerate
  (axisymmetric) cases."""
  eps = 1e-15 * 1000
  quat = np.array([1.0, 0, 0, 0])
  eigval = np.zeros(3)
  for _ in range(500):
    vec = _quat2mat(quat)
    D = vec.T @ mat @ vec
    eigval[:] = np.diag(D)
    if abs(D[0, 1]) > abs(D[0, 2]) and abs(D[0, 1]) > abs(D[1, 2]):
      rk, ck, rotk = 0, 1, 2
    elif abs(D[0, 2]) > abs(D[1, 2]):
      rk, ck, rotk = 0, 2, 1
    else:
      rk, ck, rotk = 1, 2, 0
    if abs(D[rk, ck]) < eps:
      break
    tau = (D[ck, ck] - D[rk, rk]) / (2 * D[rk, ck])
    if tau >= 0:
      t = 1.0 / (tau + math.sqrt(1 + tau * tau))
    else:
      t = -1.0 / (-tau + math.sqrt(1 + tau * tau))
    c = 1.0 / math.sqrt(1 + t * t)
    if c > 1.0 - eps:
      break
    tmp = np.zeros(4)
    tmp[rotk + 1] = (-math.sqrt(0.5 - 0.5 * c) if tau >= 0
                     else math.sqrt(0.5 - 0.5 * c))
    if rotk == 1:
      tmp[rotk + 1] = -tmp[rotk + 1]
    tmp[0] = math.sqrt(1.0 - tmp[rotk + 1] ** 2)
    tmp /= np.linalg.norm(tmp)
    quat = _mulquat(quat, tmp)
    quat /= np.linalg.norm(quat)
  # sort eigenvalues descending (bubble: 0, 1, 0) with axis-swap rotations
  for j in (0, 1, 0):
    if eigval[j] + eps < eigval[j + 1]:
      eigval[j], eigval[j + 1] = eigval[j + 1], eigval[j]
      tmp = np.zeros(4)
      tmp[0] = 0.707106781186548
      tmp[(j + 2) % 3 + 1] = tmp[0]
      quat = _mulquat(quat, tmp)
      quat /= np.linalg.norm(quat)
  return np.maximum(eigval, 0.0), quat


def _convex_hull_faces(verts: np.ndarray) -> np.ndarray:
  """Brute-force convex hull triangulation for small inline meshes (the
  reference uses qhull, user_mesh.cc): every triple of vertices whose plane
  has all other vertices on one side becomes a face, oriented outward."""
  n = len(verts)
  faces = []
  center = verts.mean(axis=0)
  for i in range(n):
    for j in range(i + 1, n):
      for k in range(j + 1, n):
        nrm = np.cross(verts[j] - verts[i], verts[k] - verts[i])
        ln = np.linalg.norm(nrm)
        if ln < 1e-12:
          continue
        nrm = nrm / ln
        d = (verts - verts[i]) @ nrm
        if (d <= 1e-10).all() or (d >= -1e-10).all():
          # orient outward from the centroid
          if np.dot(nrm, verts[i] - center) < 0:
            faces.append((i, k, j))
          else:
            faces.append((i, j, k))
  return np.array(sorted(set(faces)), dtype=np.int32).reshape(-1, 3)


# addressing + the remaining compile sections live in core2.py (split for
# readability); attach them to _Compiler here
from mujoco_tpu_torch.compiler import core2 as _core2  # noqa: E402

for _name in ("_address", "_compile_tendons", "_compile_actuators",
              "_compile_equalities", "_compile_contacts", "_compile_sensors",
              "_compile_keyframes", "_emit"):
  setattr(_Compiler, _name, getattr(_core2, _name))

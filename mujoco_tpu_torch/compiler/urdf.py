"""URDF importer: <robot> → spec tree → CompiledModel.

Counterpart of the reference's URDF reader
(src/xml/xml_urdf.cc): links become bodies positioned at
their joint origins, the root link is welded into the world (matching the
reference's static-base conversion with fusestatic), collision geometry
becomes geoms (visuals are discarded, mirroring discardvisual), and link
inertials carry over as explicit <inertial> elements with the full inertia
tensor. Joint mapping (urJoint_map, xml_urdf.cc:35): revolute→hinge with
limits, continuous→hinge, prismatic→slide, fixed→weld, floating→free,
spherical→ball; planar is not supported. <mimic> becomes an mjEQ_JOINT
polynomial coupling (the reference's URDF reader drops mimic silently).
"""

from __future__ import annotations

import math
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from mujoco_tpu_torch.compiler.parser import Element, Spec

_JOINT_MAP = {"revolute": "hinge", "continuous": "hinge",
              "prismatic": "slide", "fixed": None, "floating": "free",
              "spherical": "ball"}


def _floats(s: Optional[str], default):
  if s is None:
    return np.asarray(default, dtype=np.float64)
  return np.array([float(x) for x in s.split()], dtype=np.float64)


def _origin(el: Optional[ET.Element]):
  """URDF <origin xyz rpy> → (pos, quat). rpy is extrinsic X-Y-Z
  (roll-pitch-yaw): R = Rz(y) Ry(p) Rx(r)."""
  if el is None:
    return np.zeros(3), np.array([1.0, 0, 0, 0])
  xyz = _floats(el.get("xyz"), [0, 0, 0])
  r, p, y = _floats(el.get("rpy"), [0, 0, 0])
  def axang(ax, ang):
    c, s = math.cos(ang / 2), math.sin(ang / 2)
    return np.array([c, s * ax[0], s * ax[1], s * ax[2]])
  q = _mul(_mul(axang([0, 0, 1], y), axang([0, 1, 0], p)),
           axang([1, 0, 0], r))
  return xyz, q


def _mul(a, b):
  w1, x1, y1, z1 = a
  w2, x2, y2, z2 = b
  return np.array([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _fmt(v) -> str:
  return " ".join(repr(float(x)) for x in np.asarray(v).ravel())


class _UrdfReader:

  def __init__(self, root: ET.Element, mesh_dir: str = ""):
    self.root = root
    self.mesh_dir = mesh_dir
    self.links: Dict[str, ET.Element] = {}
    self.joints: List[ET.Element] = []
    self.assets: List[Element] = []
    self.mesh_names: Dict[str, str] = {}

  def run(self) -> Spec:
    equalities: List[Element] = []
    for el in self.root:
      if el.tag == "link":
        self.links[el.get("name")] = el
      elif el.tag == "joint":
        mimic = el.find("mimic")
        if mimic is not None:
          # URDF mimic: q = multiplier*q_ref + offset. The reference's URDF
          # reader silently DROPS mimic tags (xml_urdf.cc has no handling);
          # here it maps onto the native mjEQ_JOINT coupling with
          # polycoef = [offset, multiplier, 0, 0, 0] (URDF joints have
          # qpos0 = 0, so the polynomial is absolute).
          mult = float(mimic.get("multiplier", "1"))
          off = float(mimic.get("offset", "0"))
          equalities.append(Element(kind="joint", attrs={
              "joint1": el.get("name"), "joint2": mimic.get("joint"),
              "polycoef": f"{off} {mult} 0 0 0"}))
        self.joints.append(el)

    children = {}
    child_names = set()
    for j in self.joints:
      parent = j.find("parent").get("link")
      child = j.find("child").get("link")
      children.setdefault(parent, []).append(j)
      child_names.add(child)
    roots = [n for n in self.links if n not in child_names]
    if len(roots) != 1:
      raise ValueError(f"URDF needs exactly one root link, got {roots}")

    world = Element(kind="body", attrs={})
    # root link welded into the world (xml_urdf.cc static-base conversion)
    self._emit_link_contents(self.links[roots[0]], world,
                             include_inertial=False)
    for j in children.get(roots[0], []):
      self._emit_joint_subtree(j, world, children)

    return Spec(option={}, flags={},
                compiler={"angle": "radian", "meshdir": self.mesh_dir},
                worldbody=world, assets=self.assets, actuators=[],
                sensors=[], tendons=[], equalities=equalities, contacts=[],
                keyframes=[])

  def _emit_joint_subtree(self, joint: ET.Element, parent: Element,
                          children) -> None:
    jtype = joint.get("type")
    if jtype not in _JOINT_MAP:
      raise NotImplementedError(f"URDF joint type '{jtype}'")
    child_name = joint.find("child").get("link")
    pos, quat = _origin(joint.find("origin"))
    body = Element(kind="body", attrs={
        "name": child_name, "pos": _fmt(pos), "quat": _fmt(quat)})
    parent.children.append(body)

    mjt = _JOINT_MAP[jtype]
    if mjt is not None:
      attrs = {"name": joint.get("name"), "type": mjt}
      if mjt in ("hinge", "slide"):
        axis = _floats((joint.find("axis").get("xyz")
                        if joint.find("axis") is not None else None),
                       [1, 0, 0])
        attrs["axis"] = _fmt(axis)
      limit = joint.find("limit")
      if jtype in ("revolute", "prismatic") and limit is not None:
        lo = limit.get("lower")
        hi = limit.get("upper")
        if lo is not None and hi is not None:
          attrs["limited"] = "true"
          attrs["range"] = f"{float(lo)} {float(hi)}"
      if limit is not None and limit.get("effort"):
        e = float(limit.get("effort"))
        if e > 0:
          attrs["actuatorfrcrange"] = f"{-e} {e}"
      dyn = joint.find("dynamics")
      if dyn is not None:
        if dyn.get("damping"):
          attrs["damping"] = dyn.get("damping")
        if dyn.get("friction"):
          attrs["frictionloss"] = dyn.get("friction")
      body.children.append(Element(kind="joint", attrs=attrs))

    self._emit_link_contents(self.links[child_name], body,
                             include_inertial=True)
    for j in children.get(child_name, []):
      self._emit_joint_subtree(j, body, children)

  def _emit_link_contents(self, link: ET.Element, body: Element,
                          include_inertial: bool) -> None:
    inert = link.find("inertial")
    if inert is not None and include_inertial:
      pos, quat = _origin(inert.find("origin"))
      mass = inert.find("mass").get("value")
      im = inert.find("inertia")
      fi = [im.get(k, "0") for k in ("ixx", "iyy", "izz", "ixy", "ixz",
                                     "iyz")]
      body.children.append(Element(kind="inertial", attrs={
          "pos": _fmt(pos), "quat": _fmt(quat), "mass": mass,
          "fullinertia": " ".join(fi)}))
    # collision geometry only (discardvisual semantics)
    for col in link.findall("collision"):
      geom = self._geom(col, link.get("name"))
      if geom is not None:
        body.children.append(geom)

  def _geom(self, col: ET.Element, link_name: str) -> Optional[Element]:
    pos, quat = _origin(col.find("origin"))
    g = col.find("geometry")
    attrs = {"pos": _fmt(pos), "quat": _fmt(quat)}
    box = g.find("box")
    sph = g.find("sphere")
    cyl = g.find("cylinder")
    mesh = g.find("mesh")
    if box is not None:
      size = _floats(box.get("size"), [0.1, 0.1, 0.1]) / 2
      attrs.update(type="box", size=_fmt(size))
    elif sph is not None:
      attrs.update(type="sphere", size=sph.get("radius"))
    elif cyl is not None:
      r = float(cyl.get("radius"))
      h = float(cyl.get("length")) / 2
      attrs.update(type="cylinder", size=f"{r} {h}")
    elif mesh is not None:
      fn = mesh.find("filename").text if mesh.find("filename") is not None \
          else mesh.get("filename")
      key = (fn, mesh.get("scale", ""))
      if key not in self.mesh_names:
        name = f"{link_name}_mesh{len(self.mesh_names)}"
        masset = {"name": name, "file": fn}
        if mesh.get("scale"):
          masset["scale"] = mesh.get("scale")
        self.assets.append(Element(kind="mesh", attrs=masset))
        self.mesh_names[key] = name
      attrs.update(type="mesh", mesh=self.mesh_names[key])
    else:
      raise NotImplementedError("URDF geometry without box/sphere/cylinder/"
                                "mesh")
    return Element(kind="geom", attrs=attrs)


def load_urdf(xml: str, mesh_dir: str = "", device=None):
  """URDF string → CompiledModel (mj_loadXML's URDF branch analog)."""
  from mujoco_tpu_torch.compiler.core import compile_spec
  root = ET.fromstring(xml)
  if root.tag != "robot":
    raise ValueError("not a URDF document (root must be <robot>)")
  return compile_spec(_UrdfReader(root, mesh_dir).run(), device=device)


def load_urdf_path(path: str, device=None):
  with open(path) as f:
    xml = f.read()
  return load_urdf(xml, mesh_dir=os.path.dirname(os.path.abspath(path)),
                   device=device)

"""Procedural model editing API (mjSpec / mjs_* analog) + MJCF writer.

Counterpart of the reference's mutable model-description layer
(src/user/user_api.cc, C surface mujoco.h:1632-2130, struct
defs mjspec.h): build or edit a model programmatically — add bodies, joints,
geoms, sites, actuators, sensors, tendons, equalities — then compile to a
CompiledModel, serialize back to MJCF (the xml_native_writer.cc analog), or
attach another spec with name prefixing (mjs_attach namespacing).

The spec is a thin mutable wrapper over the parser's Element tree, so
anything the native compiler supports can be expressed; unsupported MJCF
raises at compile time, not edit time (mirroring the reference, where
mjs_* edits are validated by mjCModel::Compile).

Example:
    spec = MjSpec()
    spec.set_option(timestep=0.002)
    body = spec.worldbody.add_body(name="pend", pos=[0, 0, 1])
    body.add_joint(name="swing", type="hinge", axis=[0, 1, 0])
    body.add_geom(type="capsule", size=[0.03], fromto=[0, 0, 0, 0.3, 0, 0])
    spec.add_actuator("motor", joint="swing", gear=[2])
    model = spec.compile()
    xml = spec.to_xml()
"""

from __future__ import annotations

import copy
from typing import List, Optional
from xml.etree import ElementTree as ET

import numpy as np

from mujoco_tpu_torch.compiler.parser import Element, Spec, parse_mjcf
from mujoco_tpu_torch.compiler import schema_data as _schema


def validate_attrs(kind: str, attrs: dict) -> None:
  """Edit-time validation against the MJCF grammar (the reference's
  mjs_set* setters are typed and validate immediately; our table is
  generated from src/xml/mjcf.schema by tools/gen_schema.py). Checks
  attribute names (with did-you-mean), numeric arity, enum keywords, and
  bools. Unknown element kinds are left to compile-time."""
  tbl = _schema.ELEMENTS.get(kind)
  if tbl is None:
    return
  for k, s in attrs.items():
    spec = tbl.get(k)
    if spec is None:
      import difflib
      close = difflib.get_close_matches(k, tbl, 1)
      hint = f"; did you mean {close[0]!r}?" if close else ""
      raise ValueError(f"<{kind}> has no attribute {k!r}{hint} "
                       "(mjcf.schema)")
    base, lo, hi = spec
    if base in ("double", "float", "int"):
      vals = s.split()
      if lo and not (lo <= len(vals) <= (hi or len(vals))):
        raise ValueError(f"<{kind}> {k}: expected {lo}"
                         + (f"..{hi}" if hi != lo else "")
                         + f" values, got {len(vals)}: {s!r}")
      for v in vals:
        try:
          float(v)
        except ValueError:
          raise ValueError(f"<{kind}> {k}: non-numeric value {v!r}") \
              from None
    elif base.startswith("enum:") and hi == 1:
      keys = _schema.ENUMS.get(base[5:], ())
      if keys and s not in keys:
        raise ValueError(f"<{kind}> {k}: {s!r} is not one of {keys}")
    elif base == "bool" and s not in ("true", "false"):
      raise ValueError(f"<{kind}> {k}: expected true/false, got {s!r}")


def _attr(v) -> str:
  """Python value → MJCF attribute string."""
  if isinstance(v, str):
    return v
  if isinstance(v, bool):
    return "true" if v else "false"
  if isinstance(v, (list, tuple, np.ndarray)):
    return " ".join(_attr(x) for x in np.asarray(v).ravel().tolist())
  if isinstance(v, np.generic):
    v = v.item()
  return repr(v) if isinstance(v, float) else str(v)


class MjsElement:
  """Handle to one element in the spec tree (mjsBody/mjsGeom/... analog)."""

  def __init__(self, el: Element):
    self._el = el

  @property
  def kind(self) -> str:
    return self._el.kind

  @property
  def name(self) -> Optional[str]:
    return self._el.attrs.get("name")

  def get(self, attr: str) -> Optional[str]:
    return self._el.attrs.get(attr)

  def set(self, **attrs) -> "MjsElement":
    """Set attributes (mjs_set* setters); validated against the grammar
    at edit time like the reference's typed setters."""
    new = {k: _attr(v) for k, v in attrs.items()}
    validate_attrs(self._el.kind, new)
    self._el.attrs.update(new)
    return self

  def _add(self, kind: str, **attrs) -> "MjsElement":
    a = {k: _attr(v) for k, v in attrs.items()}
    validate_attrs(kind, a)
    el = Element(kind=kind, attrs=a)
    self._el.children.append(el)
    return MjsElement(el)

  # mjs_addBody / addJoint / addGeom / addSite / addCamera / addLight /
  # addFrame / addFreeJoint
  def add_body(self, **attrs) -> "MjsElement":
    return self._add("body", **attrs)

  def add_joint(self, **attrs) -> "MjsElement":
    return self._add("joint", **attrs)

  def add_freejoint(self, **attrs) -> "MjsElement":
    attrs["type"] = "free"
    return self._add("joint", **attrs)

  def add_geom(self, **attrs) -> "MjsElement":
    return self._add("geom", **attrs)

  def add_site(self, **attrs) -> "MjsElement":
    return self._add("site", **attrs)

  def add_camera(self, **attrs) -> "MjsElement":
    return self._add("camera", **attrs)

  def add_light(self, **attrs) -> "MjsElement":
    return self._add("light", **attrs)

  def add_frame(self, **attrs) -> "MjsElement":
    return self._add("frame", **attrs)

  def add_flexcomp(self, children=(), **attrs) -> "MjsElement":
    """children: (kind, attrs) pairs, e.g. [("edge", {"equality": True}),
    ("pin", {"id": "0 2"})]."""
    el = self._add("flexcomp", **attrs)
    for ck, cattrs in children:
      el._el.children.append(
          Element(kind=ck, attrs={k: _attr(v) for k, v in cattrs.items()}))
    return el

  def set_inertial(self, **attrs) -> "MjsElement":
    return self._add("inertial", **attrs)

  def bodies(self) -> List["MjsElement"]:
    return [MjsElement(c) for c in self._el.children if c.kind == "body"]

  def children(self, kind: Optional[str] = None) -> List["MjsElement"]:
    return [MjsElement(c) for c in self._el.children
            if kind is None or c.kind == kind]

  def delete(self, child: "MjsElement") -> None:
    """mjs_delete: remove a direct child element."""
    self._el.children.remove(child._el)

  def find(self, name: str, kind: Optional[str] = None):
    """Recursive find-by-name (mjs_findElement)."""
    return _find(self._el, name, kind)


def _find(el: Element, name: str, kind: Optional[str]):
  for c in el.children:
    if c.attrs.get("name") == name and (kind is None or c.kind == kind):
      return MjsElement(c)
    got = _find(c, name, kind)
    if got is not None:
      return got
  return None


class MjSpec:
  """Mutable model description (mjSpec analog)."""

  def __init__(self, spec: Optional[Spec] = None):
    if spec is None:
      spec = Spec(option={}, flags={}, compiler={},
                  worldbody=Element(kind="body", attrs={}),
                  assets=[], actuators=[], sensors=[], tendons=[],
                  equalities=[], contacts=[], keyframes=[])
    self.spec = spec

  # ----- construction / io
  @classmethod
  def from_xml(cls, xml: str, base_dir: Optional[str] = None) -> "MjSpec":
    return cls(parse_mjcf(xml, base_dir=base_dir))

  def copy(self) -> "MjSpec":
    return MjSpec(copy.deepcopy(self.spec))

  def compile(self, device=None):
    """Spec → CompiledModel (mj_compile); set_const runs on `device`
    (the CUDA card when None)."""
    from mujoco_tpu_torch.compiler.core import compile_spec
    return compile_spec(copy.deepcopy(self.spec), device=device)

  # ----- top-level sections
  @property
  def worldbody(self) -> MjsElement:
    return MjsElement(self.spec.worldbody)

  def set_option(self, **attrs) -> "MjSpec":
    new = {k: _attr(v) for k, v in attrs.items()}
    validate_attrs("option", new)
    self.spec.option.update(new)
    return self

  def set_flag(self, **attrs) -> "MjSpec":
    new = {k: _attr(v) for k, v in attrs.items()}
    validate_attrs("flag", new)
    self.spec.flags.update(new)
    return self

  def set_compiler(self, **attrs) -> "MjSpec":
    new = {k: _attr(v) for k, v in attrs.items()}
    validate_attrs("compiler", new)
    self.spec.compiler.update(new)
    return self

  def _add_to(self, lst: List[Element], kind: str, children=(),
              **attrs) -> MjsElement:
    a = {k: _attr(v) for k, v in attrs.items()}
    validate_attrs(kind, a)
    el = Element(kind=kind, attrs=a)
    for ck, cattrs in children:
      ca = {k: _attr(v) for k, v in cattrs.items()}
      validate_attrs(ck, ca)
      el.children.append(Element(kind=ck, attrs=ca))
    lst.append(el)
    return MjsElement(el)

  def add_actuator(self, kind: str = "general", **attrs) -> MjsElement:
    """kind: motor/position/velocity/muscle/general/adhesion/..."""
    return self._add_to(self.spec.actuators, kind, **attrs)

  def add_sensor(self, kind: str, **attrs) -> MjsElement:
    return self._add_to(self.spec.sensors, kind, **attrs)

  def add_tendon(self, kind: str = "spatial", path=(), **attrs) -> MjsElement:
    """path: sequence of (wrap-kind, attrs) pairs, e.g.
    [("site", {"site": "a"}), ("geom", {"geom": "g"})]."""
    return self._add_to(self.spec.tendons, kind, children=path, **attrs)

  def add_equality(self, kind: str, **attrs) -> MjsElement:
    return self._add_to(self.spec.equalities, kind, **attrs)

  def add_contact_pair(self, **attrs) -> MjsElement:
    return self._add_to(self.spec.contacts, "pair", **attrs)

  def add_exclude(self, **attrs) -> MjsElement:
    return self._add_to(self.spec.contacts, "exclude", **attrs)

  def add_keyframe(self, **attrs) -> MjsElement:
    return self._add_to(self.spec.keyframes, "key", **attrs)

  def add_mesh(self, **attrs) -> MjsElement:
    return self._add_to(self.spec.assets, "mesh", **attrs)

  def add_hfield(self, **attrs) -> MjsElement:
    return self._add_to(self.spec.assets, "hfield", **attrs)

  def find(self, name: str, kind: Optional[str] = None):
    got = _find(self.spec.worldbody, name, kind)
    if got is not None:
      return got
    for lst in (self.spec.actuators, self.spec.sensors, self.spec.tendons,
                self.spec.equalities, self.spec.assets, self.spec.keyframes):
      for el in lst:
        if el.attrs.get("name") == name and (kind is None or el.kind == kind):
          return MjsElement(el)
    return None

  def delete(self, handle: MjsElement) -> None:
    """mjs_delete for top-level list elements (actuators, sensors,
    tendons, equalities, contact pairs, keyframes, assets)."""
    for lst in (self.spec.actuators, self.spec.sensors, self.spec.tendons,
                self.spec.equalities, self.spec.contacts, self.spec.assets,
                self.spec.keyframes):
      if handle._el in lst:
        lst.remove(handle._el)
        return
    raise ValueError("element not found in any top-level list")

  # ----- attach (mjs_attach with namespacing)
  _REF_ATTRS = ("joint", "joint1", "joint2", "site", "geom", "geom1",
                "geom2", "body1", "body2", "subtree1", "subtree2", "tendon",
                "tendon1", "tendon2", "mesh", "hfield", "objname", "target",
                "refname", "sidesite", "body")

  def attach(self, other: "MjSpec", prefix: str = "",
             frame: Optional[MjsElement] = None) -> "MjSpec":
    """Merge `other` into this spec, prefixing every name and name
    reference (mjs_attach, user_api.cc: attach sub-specs w/ namespacing).
    `frame`: optional body/frame handle to attach the world children under
    (defaults to this spec's worldbody)."""
    src = copy.deepcopy(other.spec)

    def rename(el: Element):
      if "name" in el.attrs:
        el.attrs["name"] = prefix + el.attrs["name"]
      for a in self._REF_ATTRS:
        if a in el.attrs:
          el.attrs[a] = prefix + el.attrs[a]
      for c in el.children:
        rename(c)

    target = (frame._el if frame is not None else self.spec.worldbody)
    for c in src.worldbody.children:
      rename(c)
      target.children.append(c)
    for lst_name in ("assets", "actuators", "sensors", "tendons",
                     "equalities", "contacts", "keyframes"):
      for el in getattr(src, lst_name):
        rename(el)
        getattr(self.spec, lst_name).append(el)
    return self

  # ----- MJCF writer (xml_native_writer.cc analog)
  def to_xml(self) -> str:
    root = ET.Element("mujoco")
    if self.spec.compiler:
      ET.SubElement(root, "compiler", dict(self.spec.compiler))
    if self.spec.option or self.spec.flags:
      opt = ET.SubElement(root, "option", dict(self.spec.option))
      if self.spec.flags:
        ET.SubElement(opt, "flag", dict(self.spec.flags))
    if self.spec.assets:
      asset = ET.SubElement(root, "asset")
      for el in self.spec.assets:
        _emit(asset, el)
    wb = ET.SubElement(root, "worldbody")
    for c in self.spec.worldbody.children:
      _emit(wb, c)
    for tag, lst in (("tendon", self.spec.tendons),
                     ("actuator", self.spec.actuators),
                     ("sensor", self.spec.sensors),
                     ("equality", self.spec.equalities),
                     ("contact", self.spec.contacts),
                     ("keyframe", self.spec.keyframes)):
      if lst:
        sec = ET.SubElement(root, tag)
        for el in lst:
          _emit(sec, el)
    ET.indent(root)
    return ET.tostring(root, encoding="unicode")


def _emit(parent: ET.Element, el: Element) -> None:
  # freejoints parse to joint type="free"; write back as <freejoint> so the
  # no-defaults semantics survive a round trip
  if el.kind == "joint" and el.attrs.get("type") == "free":
    a = {k: v for k, v in el.attrs.items() if k != "type"}
    ET.SubElement(parent, "freejoint", a)
    return
  node = ET.SubElement(parent, el.kind, dict(el.attrs))
  for c in el.children:
    _emit(node, c)

"""MJCF parser: XML → spec tree with resolved default classes.

Counterpart of the schema-driven reader
(src/xml/xml_native_reader.cc) for the supported subset.
Elements carry their raw attribute dicts after the defaults cascade; the
compiler core interprets them.
"""

from __future__ import annotations

import copy
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional

import numpy as np

# element kinds that participate in the defaults cascade (mjCDef members,
# src/user/user_objects.h)
_DEFAULT_KINDS = ("joint", "geom", "site", "camera", "light", "tendon",
                  "general", "motor", "position", "velocity", "muscle",
                  "pair", "equality", "mesh", "material")


@dataclass
class Element:
  kind: str
  attrs: Dict[str, str]
  children: List["Element"] = dfield(default_factory=list)


@dataclass
class Spec:
  option: Dict[str, str]
  flags: Dict[str, str]
  compiler: Dict[str, str]
  worldbody: Element
  assets: List[Element]
  actuators: List[Element]
  sensors: List[Element]
  tendons: List[Element]
  equalities: List[Element]
  contacts: List[Element]
  keyframes: List[Element]
  # <visual> subsections (headlight/rgba/scale/map/global attr dicts keyed
  # by subsection tag); consumed by the mjv-lite layer and the renderer
  visual: Dict[str, Dict[str, str]] = dfield(default_factory=dict)
  # in-memory asset store (mjVFS analog): filename → bytes, looked up
  # before the filesystem by includes, meshes, and textures. Keys match
  # either the full name or the stripped basename (mj_findFileVFS strips
  # directories, engine_vfs.c)
  vfs: Dict[str, bytes] = dfield(default_factory=dict)


class Defaults:
  """Nested default classes (mjCDef tree, user_model.cc ProcessLists)."""

  def __init__(self, parent: Optional["Defaults"] = None):
    self.parent = parent
    self.tables: Dict[str, Dict[str, str]] = {}
    self.classes: Dict[str, "Defaults"] = {}

  def lookup(self, kind: str) -> Dict[str, str]:
    out = dict(self.parent.lookup(kind)) if self.parent else {}
    out.update(self.tables.get(kind, {}))
    return out

  def resolve_class(self, name: Optional[str]) -> "Defaults":
    if name is None:
      return self
    node = self
    while node.parent is not None:
      node = node.parent
    found = _find_class(node, name)
    if found is None:
      raise ValueError(f"unknown default class '{name}'")
    return found


def _find_class(node: Defaults, name: str) -> Optional[Defaults]:
  for cname, child in node.classes.items():
    if cname == name:
      return child
    deeper = _find_class(child, name)
    if deeper is not None:
      return deeper
  return None


def _parse_defaults(el: ET.Element, parent: Optional[Defaults]) -> Defaults:
  d = Defaults(parent)
  for child in el:
    if child.tag == "default":
      name = child.get("class")
      if name is None:
        raise ValueError("nested <default> requires a class name")
      d.classes[name] = _parse_defaults(child, d)
    elif child.tag in _DEFAULT_KINDS:
      d.tables.setdefault(child.tag, {}).update(child.attrib)
  return d


def _resolve(el: ET.Element, defaults: Defaults, childclass: Optional[str],
             kind: Optional[str] = None) -> Dict[str, str]:
  """Attributes of `el` after the defaults cascade: global/class defaults,
  then the element's own attributes (element wins)."""
  kind = kind or el.tag
  cls = el.get("class", childclass)
  table = defaults.resolve_class(cls).lookup(kind)
  out = dict(table)
  out.update(el.attrib)
  out.pop("class", None)
  return out


def _walk_body(el: ET.Element, defaults: Defaults,
               childclass: Optional[str]) -> Element:
  attrs = dict(el.attrib)
  cc = el.get("childclass", childclass)
  out = Element(kind="body" if el.tag in ("body", "worldbody") else el.tag,
                attrs=attrs)
  for child in el:
    if child.tag == "body":
      out.children.append(_walk_body(child, defaults, cc))
    elif child.tag == "frame":
      # frames compose a fixed transform onto their children
      f = Element(kind="frame", attrs=dict(child.attrib))
      inner = _walk_body(child, defaults, cc)
      f.children = inner.children
      out.children.append(f)
    elif child.tag == "freejoint":
      # freejoint takes NO joint defaults (separate MJCF element)
      a = dict(child.attrib)
      a["type"] = "free"
      out.children.append(Element(kind="joint", attrs=a))
    elif child.tag in ("joint", "geom", "site", "camera", "light"):
      out.children.append(
          Element(kind=child.tag, attrs=_resolve(child, defaults, cc)))
    elif child.tag == "inertial":
      out.children.append(Element(kind="inertial", attrs=dict(child.attrib)))
    elif child.tag == "composite":
      comp = Element(kind="composite", attrs=dict(child.attrib))
      for sub in child:
        comp.children.append(Element(kind=sub.tag, attrs=dict(sub.attrib)))
      out.children.append(comp)
    elif child.tag == "flexcomp":
      fc = Element(kind="flexcomp", attrs=dict(child.attrib))
      for sub in child:
        fc.children.append(Element(kind=sub.tag, attrs=dict(sub.attrib)))
      out.children.append(fc)
    elif child.tag == "replicate":
      # meta-element: kept as a subtree, expanded by the compiler's
      # _expand_replicates pass (xml_native_reader.cc:2494)
      rep = Element(kind="replicate", attrs=dict(child.attrib))
      inner = _walk_body(child, defaults, cc)
      rep.children = inner.children
      out.children.append(rep)
    else:
      raise NotImplementedError(f"MJCF element <{child.tag}> in body")
  return out


def vfs_find(vfs: Optional[Dict[str, bytes]], fn: str) -> Optional[bytes]:
  """VFS lookup by full name, then stripped basename (mj_findFileVFS strips
  directory prefixes, engine_vfs.c)."""
  import os
  if not vfs:
    return None
  if fn in vfs:
    return vfs[fn]
  return vfs.get(os.path.basename(fn))


def _splice_includes(root: ET.Element, base_dir: Optional[str],
                     vfs: Optional[Dict[str, bytes]] = None) -> None:
  """Recursively replace <include file=.../> with the included file's
  top-level children (ParseXML include handling, xml.cc:322; the included
  root may be <mujoco> or <mujocoinclude>). Files resolve through the VFS
  first."""
  import os
  for parent in root.iter():
    i = 0
    while i < len(parent):
      child = parent[i]
      if child.tag == "include":
        fn = child.get("file")
        if fn is None:
          raise ValueError("<include> requires a file attribute")
        data = vfs_find(vfs, fn)
        if data is not None:
          sub = ET.fromstring(data.decode()
                              if isinstance(data, bytes) else data)
          subdir = base_dir
        else:
          path = os.path.join(base_dir, fn) if base_dir else fn
          sub = ET.parse(path).getroot()
          subdir = os.path.dirname(path)
        if sub.tag not in ("mujoco", "mujocoinclude"):
          raise ValueError(f"included file {fn} has root <{sub.tag}>")
        _splice_includes(sub, subdir, vfs)
        parent.remove(child)
        for j, el in enumerate(list(sub)):
          parent.insert(i + j, el)
      else:
        i += 1


def parse_mjcf(xml: str, base_dir: Optional[str] = None,
               assets: Optional[Dict[str, bytes]] = None) -> Spec:
  root = ET.fromstring(xml)
  if root.tag != "mujoco":
    raise ValueError("not an MJCF document")
  _splice_includes(root, base_dir, assets)

  option: Dict[str, str] = {}
  flags: Dict[str, str] = {}
  compiler: Dict[str, str] = {}
  defaults = Defaults()
  worldbody = None
  asset_els: List[Element] = []
  visual: Dict[str, Dict[str, str]] = {}
  actuators: List[Element] = []
  sensors: List[Element] = []
  tendons: List[Element] = []
  equalities: List[Element] = []
  contacts: List[Element] = []
  keyframes: List[Element] = []

  for el in root:
    if el.tag == "option":
      option.update(el.attrib)
      for sub in el:
        if sub.tag == "flag":
          flags.update(sub.attrib)
    elif el.tag == "compiler":
      compiler.update(el.attrib)
    elif el.tag == "default":
      defaults = _parse_defaults(el, None)
    elif el.tag == "worldbody":
      wb = _walk_body(el, defaults, None)
      if worldbody is None:
        worldbody = wb
      else:
        worldbody.children.extend(wb.children)
    elif el.tag == "asset":
      for sub in el:
        ae = Element(kind=sub.tag,
                     attrs=_resolve(sub, defaults, None)
                     if sub.tag in _DEFAULT_KINDS
                     else dict(sub.attrib))
        for c in sub:                     # e.g. <skin><bone .../></skin>
          ae.children.append(Element(kind=c.tag, attrs=dict(c.attrib)))
        asset_els.append(ae)
    elif el.tag == "actuator":
      for sub in el:
        actuators.append(Element(kind=sub.tag,
                                 attrs=_resolve(sub, defaults, None)))
    elif el.tag == "sensor":
      for sub in el:
        sensors.append(Element(kind=sub.tag, attrs=dict(sub.attrib)))
    elif el.tag == "tendon":
      for sub in el:
        t = Element(kind=sub.tag, attrs=_resolve(sub, defaults, None,
                                                 kind="tendon"))
        for w in sub:
          t.children.append(Element(kind=w.tag, attrs=dict(w.attrib)))
        tendons.append(t)
    elif el.tag == "equality":
      for sub in el:
        equalities.append(Element(kind=sub.tag,
                                  attrs=_resolve(sub, defaults, None,
                                                 kind="equality")))
    elif el.tag == "contact":
      for sub in el:
        contacts.append(Element(kind=sub.tag,
                                attrs=_resolve(sub, defaults, None,
                                               kind="pair")
                                if sub.tag == "pair" else dict(sub.attrib)))
    elif el.tag == "keyframe":
      for sub in el:
        keyframes.append(Element(kind=sub.tag, attrs=dict(sub.attrib)))
    elif el.tag == "visual":
      for sub in el:
        visual.setdefault(sub.tag, {}).update(dict(sub.attrib))
    elif el.tag in ("size", "statistic", "custom"):
      continue  # no effect on the physics model subset
    else:
      raise NotImplementedError(f"MJCF section <{el.tag}>")

  if worldbody is None:
    worldbody = Element(kind="body", attrs={})
  return Spec(option=option, flags=flags, compiler=compiler,
              worldbody=worldbody, assets=asset_els, actuators=actuators,
              sensors=sensors, tendons=tendons, equalities=equalities,
              contacts=contacts, keyframes=keyframes, visual=visual,
              vfs=dict(assets) if assets else {})

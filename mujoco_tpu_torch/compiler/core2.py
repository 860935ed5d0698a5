"""Compiler back half: addressing, actuator/tendon/equality/sensor/keyframe
compilation and the CompiledModel emission (continues core.py's _Compiler;
counterpart of mjCModel::TryCompile's list passes,
src/user/user_model.cc:5205-5432)."""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from mujoco_tpu_torch.compiler.core import (_AutoLimited, _ENABLE_BITS,
                                      _DISABLE_BITS, _CONES, _INTEGRATORS,
                                      _JNT_NQ, _JNT_NV, _OBJTYPE, _SENSORS,
                                      _SOLIMP, _SOLREF, _SOLVERS,
                                      CompiledModel, _b, _f, _s)

_DYN = {"none": 0, "integrator": 1, "filter": 2, "filterexact": 3,
        "muscle": 4, "dcmotor": 5, "user": 7}
_GAIN = {"fixed": 0, "affine": 1, "muscle": 2, "dcmotor": 3, "so3": 4,
         "pid": 5, "user": 6}
_BIAS = {"none": 0, "affine": 1, "muscle": 2, "dcmotor": 3, "so3": 4,
         "user": 5}


def _address(self):
  """qpos/dof addressing + body derived fields (SetSizes analog)."""
  nq = nv = 0
  self.dof = []  # per dof: (bodyid, jntid)
  for j, jnt in enumerate(self.joints):
    jnt["qposadr"] = nq
    jnt["dofadr"] = nv
    nq += _JNT_NQ[jnt["type"]]
    nv += _JNT_NV[jnt["type"]]
    for k in range(_JNT_NV[jnt["type"]]):
      self.dof.append((jnt["body"], j))
  self.nq, self.nv = nq, nv

  nb = len(self.bodies)
  parent = np.array([b["parentid"] for b in self.bodies], dtype=np.int32)
  self.body_parentid = parent
  # weldid: self if jointed, else parent's weldid
  weldid = np.zeros(nb, dtype=np.int32)
  for b in range(1, nb):
    weldid[b] = b if self.bodies[b]["jnt"] else weldid[parent[b]]
  self.body_weldid = weldid
  # rootid: top-most non-world ancestor
  rootid = np.zeros(nb, dtype=np.int32)
  for b in range(1, nb):
    rootid[b] = b if parent[b] == 0 else rootid[parent[b]]
  self.body_rootid = rootid
  # subtreemass
  mass = np.array([b["mass"] for b in self.bodies])
  subtree = mass.copy()
  for b in range(nb - 1, 0, -1):
    subtree[parent[b]] += subtree[b]
  self.body_subtreemass = subtree
  # mocap ids
  mocapid = np.full(nb, -1, dtype=np.int32)
  nmocap = 0
  for b in range(nb):
    if self.bodies[b]["mocap"]:
      mocapid[b] = nmocap
      nmocap += 1
  self.body_mocapid = mocapid
  self.nmocap = nmocap

  # dof_parentid: previous dof in the same joint → previous joint in the
  # same body → last dof of the nearest jointed ancestor body
  last_dof_of_body = np.full(nb, -1, dtype=np.int32)
  for j, jnt in enumerate(self.joints):
    b = jnt["body"]
    nvj = _JNT_NV[jnt["type"]]
    for k in range(nvj):
      i = jnt["dofadr"] + k
      if k > 0:
        pid = i - 1
      elif last_dof_of_body[b] >= 0:
        pid = last_dof_of_body[b]
      else:
        anc = parent[b]
        while anc != 0 and last_dof_of_body[anc] < 0:
          anc = parent[anc]
        pid = last_dof_of_body[anc] if anc != 0 else (
            last_dof_of_body[0])
      jnt.setdefault("dof_parent", []).append(pid)
      last_dof_of_body[b] = i

  # qpos0 / qpos_spring
  qpos0 = np.zeros(nq)
  qspring = np.zeros(nq)
  for jnt in self.joints:
    adr = jnt["qposadr"]
    t = jnt["type"]
    if t in (2, 3):
      qpos0[adr] = jnt["ref"]
      qspring[adr] = jnt["springref"]
    elif t == 1:
      qpos0[adr:adr + 4] = [1, 0, 0, 0]
      qspring[adr:adr + 4] = [1, 0, 0, 0]
    else:  # free: global body frame
      b = self.bodies[jnt["body"]]
      # compose up to world (free bodies are direct children of world in
      # the supported subset)
      if b["parentid"] != 0:
        raise NotImplementedError("free joints only on children of world")
      qpos0[adr:adr + 3] = b["pos"]
      qpos0[adr + 3:adr + 7] = b["quat"]
      qspring[adr:adr + 7] = qpos0[adr:adr + 7]
  self.qpos0 = qpos0
  self.qpos_spring = qspring


def _compile_tendons(self):
  from mujoco_tpu_torch.compiler.core import _f as f
  self.tendon_list = []
  self.wraps = []
  for el in self.spec.tendons:
    a = el.attrs
    tid = len(self.tendon_list)
    name = _s(a, "name", f"tendon{tid}")
    adr = len(self.wraps)
    if el.kind == "spatial":
      for w in el.children:
        if w.kind == "site":
          self.wraps.append((3, self.names["site"][w.attrs["site"]], 0.0))
        elif w.kind == "geom":
          gid = self.names["geom"][w.attrs["geom"]]
          gtype = self.geoms[gid]["type"]
          wtype = 4 if gtype == 2 else 5  # sphere / cylinder wrap
          side = w.attrs.get("sidesite")
          prm = float(self.names["site"][side]) if side else -1.0
          self.wraps.append((wtype, gid, prm))
        elif w.kind == "pulley":
          self.wraps.append((2, -1, float(w.attrs.get("divisor", "1"))))
        else:
          raise NotImplementedError(f"tendon wrap <{w.kind}>")
    elif el.kind == "fixed":
      for w in el.children:
        if w.kind != "joint":
          raise NotImplementedError(f"fixed tendon element <{w.kind}>")
        self.wraps.append((1, self.names["joint"][w.attrs["joint"]],
                           float(w.attrs.get("coef", "0"))))
    else:
      raise NotImplementedError(f"tendon <{el.kind}>")
    self.names["tendon"][name] = tid
    self.tendon_list.append(dict(
        name=name, adr=adr, num=len(self.wraps) - adr,
        limited=_AutoLimited.parse(a, "limited", "range", self.autolimits),
        range=f(a, "range", [0, 0], 2),
        solref_lim=f(a, "solreflimit", _SOLREF, 2),
        solimp_lim=f(a, "solimplimit", _SOLIMP, 5),
        solref_fri=f(a, "solreffriction", _SOLREF, 2),
        solimp_fri=f(a, "solimpfriction", _SOLIMP, 5),
        margin=float(_s(a, "margin", "0")),
        stiffness=float(_s(a, "stiffness", "0")),
        damping=float(_s(a, "damping", "0")),
        armature=float(_s(a, "armature", "0")),
        frictionloss=float(_s(a, "frictionloss", "0")),
        springlength=f(a, "springlength", [-1, -1], 2),
    ))


def _compile_actuators(self):
  self.act_list = []
  na = 0
  for el in self.spec.actuators:
    a = dict(el.attrs)
    aid = len(self.act_list)
    name = _s(a, "name", f"actuator{aid}")
    kind = el.kind
    dynprm = np.zeros(10)
    gainprm = np.zeros(10)
    biasprm = np.zeros(10)
    dyn, gain, bias = 0, 0, 0
    ctrlspec = 0
    dynprm[0] = 1.0
    gainprm[0] = 1.0

    def _kv_or_dampratio(default_kv="0"):
      # kv stored as -kv; dampratio stored POSITIVE in biasprm[2], resolved
      # to -damping by setconst (engine_setconst.c:1135; mjs_setToOrientation)
      if "kv" in a and "dampratio" in a:
        raise ValueError(f"actuator {name}: kv and dampratio cannot both "
                         "be defined")
      if "dampratio" in a:
        dr = float(a["dampratio"])
        if dr < 0:
          raise ValueError(f"actuator {name}: dampratio cannot be negative")
        return dr
      kv = float(_s(a, "kv", default_kv))
      if kv < 0:
        raise ValueError(f"actuator {name}: kv cannot be negative")
      return -kv

    if kind == "motor":
      pass
    elif kind == "position":
      kp = float(_s(a, "kp", "1"))
      gainprm[0] = kp
      bias = 1
      biasprm[:3] = [0, -kp, _kv_or_dampratio()]
    elif kind == "orientation":
      # SO3 geodesic servo shortcut (xml_native_reader.cc:1285,
      # mjs_setToOrientation, user_api.cc:1328)
      kp = float(_s(a, "kp", "1"))
      gain, bias = 4, 4
      gainprm[0] = kp
      biasprm[:3] = [0, -kp, _kv_or_dampratio()]
      inp = _s(a, "input", "expmap")
      if inp not in ("expmap", "quat"):
        raise ValueError(f"actuator {name}: so3 input must be expmap or "
                         "quat")
      ctrlspec = 1 if inp == "expmap" else 2
    elif kind == "velocity":
      kv = float(_s(a, "kv", "1"))
      gainprm[0] = kv
      bias = 1
      biasprm[:3] = [0, 0, -kv]
    elif kind == "muscle":
      dyn, gain, bias = 4, 2, 2
      dynprm[:3] = _f(a, "timeconst", [0.01, 0.04], 2).tolist() + [0.0]
      dynprm[2] = float(_s(a, "tausmooth", "0"))
      prm = np.array([0.75, 1.05, -1, 200, 0.5, 1.6, 1.5, 1.3, 1.2, 0])
      prm[:2] = _f(a, "range", [0.75, 1.05], 2)
      prm[2] = float(_s(a, "force", "-1"))
      prm[3] = float(_s(a, "scale", "200"))
      prm[4] = float(_s(a, "lmin", "0.5"))
      prm[5] = float(_s(a, "lmax", "1.6"))
      prm[6] = float(_s(a, "vmax", "1.5"))
      prm[7] = float(_s(a, "fpmax", "1.3"))
      prm[8] = float(_s(a, "fvmax", "1.2"))
      gainprm[:10] = prm
      biasprm[:10] = prm
      a.setdefault("ctrllimited", "true")
      a.setdefault("ctrlrange", "0 1")
    elif kind == "general":
      dyn = _DYN[_s(a, "dyntype", "none")]
      gain = _GAIN[_s(a, "gaintype", "fixed")]
      bias = _BIAS[_s(a, "biastype", "none")]
      dynprm = _f(a, "dynprm", [1] + [0] * 9, 10)
      gainprm = _f(a, "gainprm", [1] + [0] * 9, 10)
      biasprm = _f(a, "biasprm", [0] * 10, 10)
      if "input" in a:
        # input signature (ReadInputSpec): so3 chart selection only; the
        # PID token-list form is not modeled (single-input PID)
        if gain != 4:
          raise NotImplementedError(
              f"actuator {name}: input= is only supported for so3")
        if a["input"] not in ("expmap", "quat"):
          raise ValueError(f"actuator {name}: so3 input must be expmap or "
                           "quat")
        ctrlspec = 1 if a["input"] == "expmap" else 2
    else:
      raise NotImplementedError(f"actuator <{kind}>")

    # SO3 servo: resolve transmission to mjTRN_SO3 downstream (put_model),
    # validate here what needs compile-time info (user_objects.cc:7118-7182)
    if (gain == 4) != (bias == 4):
      raise ValueError(f"actuator {name}: gaintype and biastype must both "
                       "be 'so3'")
    if gain == 4 and ctrlspec == 0:
      ctrlspec = 1  # expmap is the default chart

    # transmission
    if "joint" in a:
      trntype = 0
      trnid = (self.names["joint"][a["joint"]], -1)
    elif "jointinparent" in a:
      trntype = 1
      trnid = (self.names["joint"][a["jointinparent"]], -1)
    elif "tendon" in a:
      trntype = 3
      trnid = (self.names["tendon"][a["tendon"]], -1)
    elif "site" in a:
      trntype = 4
      ref = a.get("refsite")
      trnid = (self.names["site"][a["site"]],
               self.names["site"][ref] if ref else -1)
    elif "cranksite" in a:
      trntype = 2
      trnid = (self.names["site"][a["cranksite"]],
               self.names["site"][a["slidersite"]])
    else:
      raise NotImplementedError("actuator transmission")

    actdim = int(_s(a, "actdim", "-1"))
    if actdim < 0:
      if gain == 4 and dyn == 1:
        actdim = 3  # so3 integrator: 3-wide expmap setpoint
      else:
        actdim = 0 if dyn == 0 else 1
    if gain == 4 and dyn == 1 and actdim != 3:
      raise ValueError(f"actuator {name}: so3 integrator requires actdim 3")
    actadr = na if actdim else -1
    na += actdim

    self.names["actuator"][name] = aid
    self.act_list.append(dict(
        name=name, trntype=trntype, trnid=trnid,
        dyn=dyn, gain=gain, bias=bias,
        dynprm=dynprm, gainprm=gainprm, biasprm=biasprm,
        actadr=actadr, actnum=actdim,
        ctrllimited=_AutoLimited.parse(a, "ctrllimited", "ctrlrange",
                                       self.autolimits),
        ctrlrange=_f(a, "ctrlrange", [0, 0], 2),
        forcelimited=_AutoLimited.parse(a, "forcelimited", "forcerange",
                                        self.autolimits),
        forcerange=_f(a, "forcerange", [0, 0], 2),
        actlimited=_AutoLimited.parse(a, "actlimited", "actrange",
                                      self.autolimits),
        actrange=_f(a, "actrange", [0, 0], 2),
        actearly=_b(a, "actearly", False),
        ctrlspec=ctrlspec,
        group=int(_s(a, "group", "0")),
        gear=_f(a, "gear", [1, 0, 0, 0, 0, 0], 6),
        cranklength=float(_s(a, "cranklength", "0")),
        lengthrange=_f(a, "lengthrange", [0, 0], 2),
    ))
  self.na = na


def _compile_equalities(self):
  self.eq_list = []
  for el in self.spec.equalities:
    a = el.attrs
    eid = len(self.eq_list)
    name = _s(a, "name", f"equality{eid}")
    data = np.zeros(11)
    data[10] = 1.0  # torquescale default (all equality types in the model)
    objtype = 1  # mjOBJ_BODY
    if el.kind == "connect":
      et = 0
      if "site1" in a:
        objtype = 6
        o1 = self.names["site"][a["site1"]]
        o2 = self.names["site"][a["site2"]]
      else:
        o1 = self.names["body"][a["body1"]]
        o2 = self.names["body"][a.get("body2", "world")]
        data[0:3] = _f(a, "anchor", [0, 0, 0], 3)
    elif el.kind == "weld":
      et = 1
      if "site1" in a:
        objtype = 6
        o1 = self.names["site"][a["site1"]]
        o2 = self.names["site"][a["site2"]]
      else:
        o1 = self.names["body"][a["body1"]]
        o2 = self.names["body"][a.get("body2", "world")]
        data[0:3] = _f(a, "anchor", [0, 0, 0], 3)
        if "relpose" in a:
          rp = _f(a, "relpose", n=7)
          data[3:6] = rp[:3]
          data[6:10] = rp[3:]
      data[10] = float(_s(a, "torquescale", "1"))
    elif el.kind == "joint":
      et = 2
      o1 = self.names["joint"][a["joint1"]]
      o2 = self.names["joint"][a["joint2"]] if "joint2" in a else -1
      data[0:5] = _f(a, "polycoef", [0, 1, 0, 0, 0], 5)
      objtype = 0  # the reference stores joint/tendon equalities untyped
    elif el.kind == "tendon":
      et = 3
      o1 = self.names["tendon"][a["tendon1"]]
      o2 = self.names["tendon"][a["tendon2"]] if "tendon2" in a else -1
      data[0:5] = _f(a, "polycoef", [0, 1, 0, 0, 0], 5)
      objtype = 0
    else:
      raise NotImplementedError(f"equality <{el.kind}>")
    self.names["equality"][name] = eid
    self.eq_list.append(dict(
        name=name, type=et, obj1=o1, obj2=o2, objtype=objtype, data=data,
        active=_b(a, "active", True),
        solref=_f(a, "solref", _SOLREF, 2),
        solimp=_f(a, "solimp", _SOLIMP, 5)))
  _flex_equalities(self)


def _flex_equalities(self):
  """mjEQ_FLEX edge equality per flexcomp with <edge equality="true"/>
  (mjCFlexcomp, user_flexcomp.cc; pip emits objtype=0, obj2=-1,
  data[1]=data[10]=1)."""
  from mujoco_tpu_torch.compiler.core import _b as b_, _f as f_
  for fid, fx in enumerate(self.flexes):
    ea = fx["edge_attrs"]
    if ea.get("equality", "false") not in ("true", "1"):
      continue
    data = np.zeros(11)
    data[1] = 1.0
    data[10] = 1.0
    self.eq_list.append(dict(
        name=f"{fx['name']}_eq", type=4, obj1=fid, obj2=-1, objtype=0,
        data=data, active=True,
        solref=f_(ea, "solref", _SOLREF, 2),
        solimp=f_(ea, "solimp", _SOLIMP, 5)))


def _compile_contacts(self):
  self.pair_list = []
  self.exclude_list = []
  for el in self.spec.contacts:
    a = el.attrs
    if el.kind == "pair":
      g1 = self.names["geom"][a["geom1"]]
      g2 = self.names["geom"][a["geom2"]]
      fr = _f(a, "friction", [1, 1, 0.005, 0.0001, 0.0001], 5)
      self.pair_list.append(dict(
          geom1=g1, geom2=g2,
          condim=int(_s(a, "condim", "3")),
          friction=fr,
          solref=_f(a, "solref", _SOLREF, 2),
          solreffriction=_f(a, "solreffriction", [0, 0], 2),
          solimp=_f(a, "solimp", _SOLIMP, 5),
          margin=float(_s(a, "margin", "0")),
          gap=float(_s(a, "gap", "0"))))
    elif el.kind == "exclude":
      b1 = self.names["body"][a["body1"]]
      b2 = self.names["body"][a["body2"]]
      self.exclude_list.append((min(b1, b2) << 16) + max(b1, b2))
    else:
      raise NotImplementedError(f"contact <{el.kind}>")


def _compile_sensors(self):
  self.sensor_list = []
  adr = 0
  for el in self.spec.sensors:
    a = el.attrs
    if el.kind not in _SENSORS:
      raise NotImplementedError(f"sensor <{el.kind}>")
    stype, dim, objkind, needstage = _SENSORS[el.kind]
    name = _s(a, "name", f"sensor{len(self.sensor_list)}")
    reftype, refid = 0, -1
    if objkind == "none":
      objtype, objid = 0, -1
    elif objkind == "obj":
      kw = a["objtype"]
      objtype = _OBJTYPE[kw]
      table = {"body": "body", "xbody": "body", "geom": "geom",
               "site": "site", "camera": "camera"}[kw]
      objid = self.names[table][a["objname"]]
      if "reftype" in a:
        rkw = a["reftype"]
        reftype = _OBJTYPE[rkw]
        rtable = {"body": "body", "xbody": "body", "geom": "geom",
                  "site": "site", "camera": "camera"}[rkw]
        refid = self.names[rtable][a["refname"]]
    else:
      objtype = _OBJTYPE[objkind]
      objid = self.names[
          {"site": "site", "joint": "joint", "tendon": "tendon",
           "actuator": "actuator", "body": "body"}[objkind]][a[objkind]]
    # actuator sensors report one value per force output: dim 3 on an SO3
    # actuator's 3-wide output block (engine_sensor.c:653)
    if objkind == "actuator" and el.kind in ("actuatorpos", "actuatorvel",
                                             "actuatorfrc"):
      if self.act_list[objid]["gain"] == 4:
        dim = 3
    self.names["sensor"][name] = len(self.sensor_list)
    self.sensor_list.append(dict(
        name=name, type=stype, datatype=0, needstage=needstage,
        objtype=objtype, objid=objid, reftype=reftype, refid=refid,
        dim=dim, adr=adr, cutoff=float(_s(a, "cutoff", "0"))))
    adr += dim
  self.nsensordata = adr


def _compile_keyframes(self):
  self.key_list = []
  for el in self.spec.keyframes:
    a = el.attrs
    name = _s(a, "name", f"key{len(self.key_list)}")
    self.names["key"][name] = len(self.key_list)
    self.key_list.append(dict(
        name=name,
        time=float(_s(a, "time", "0")),
        qpos=_f(a, "qpos", self.qpos0, self.nq),
        qvel=_f(a, "qvel", [0] * self.nv, self.nv),
        act=_f(a, "act", [0] * self.na, self.na),
        # ctrl block size = total controls (SO3 blocks are 3-4 wide)
        ctrl=_f(a, "ctrl", [0] * _nctrl(self.act_list),
                _nctrl(self.act_list)),
        mpos=_f(a, "mpos", [0] * (3 * self.nmocap), 3 * self.nmocap),
        mquat=_f(a, "mquat", [1, 0, 0, 0] * self.nmocap, 4 * self.nmocap)))


def _nctrl(act_list) -> int:
  """Total control dimension: 1 per actuator, 3 (expmap) / 4 (quat) for
  SO3 blocks (mjmodel.h nu vs nactuator)."""
  n = 0
  for x in act_list:
    n += (4 if x.get("ctrlspec", 0) == 2 else 3) if x["gain"] == 4 else 1
  return n


def _emit(self) -> CompiledModel:
  m = CompiledModel()
  m.is_mjtpu_compiled = True
  m.name_tables = self.names

  # ----- option
  o = self.spec.option
  fl = self.spec.flags
  disable = 0
  enable = 0
  for k, bit in _DISABLE_BITS.items():
    if fl.get(k, "enable") == "disable":
      disable |= bit
  for k, bit in _ENABLE_BITS.items():
    if fl.get(k, "disable") == "enable":
      enable |= bit
  m.opt = SimpleNamespace(
      timestep=float(_s(o, "timestep", "0.002")),
      gravity=_f(o, "gravity", [0, 0, -9.81], 3),
      wind=_f(o, "wind", [0, 0, 0], 3),
      magnetic=_f(o, "magnetic", [0, -0.5, 0], 3),
      density=float(_s(o, "density", "0")),
      viscosity=float(_s(o, "viscosity", "0")),
      impratio=float(_s(o, "impratio", "1")),
      tolerance=float(_s(o, "tolerance", "1e-8")),
      sleep_tolerance=float(_s(o, "sleep_tolerance", "0")),
      ls_tolerance=float(_s(o, "ls_tolerance", "0.01")),
      integrator=_INTEGRATORS[_s(o, "integrator", "Euler")],
      cone=_CONES[_s(o, "cone", "pyramidal")],
      solver=_SOLVERS[_s(o, "solver", "Newton")],
      iterations=int(_s(o, "iterations", "100")),
      ls_iterations=int(_s(o, "ls_iterations", "50")),
      noslip_iterations=int(_s(o, "noslip_iterations", "0")),
      disableflags=disable, enableflags=enable, disableactuator=0)
  m.stat = SimpleNamespace(meaninertia=1.0)

  # ----- sizes
  nb, nj, ng = len(self.bodies), len(self.joints), len(self.geoms)
  m.nq, m.nv, m.na = self.nq, self.nv, self.na
  m.nu = len(self.act_list)
  m.nbody, m.njnt, m.ngeom = nb, nj, ng
  m.nsite = len(self.sites)
  m.ncam = len(self.cams)
  m.nlight = len(self.lights)
  m.neq = len(self.eq_list)
  m.ntendon = len(self.tendon_list)
  m.nwrap = len(self.wraps)
  m.nsensor = len(self.sensor_list)
  m.nsensordata = self.nsensordata
  m.nmocap = self.nmocap
  m.nkey = len(self.key_list)
  m.npair = len(self.pair_list)
  m.nexclude = len(self.exclude_list)
  m.nhfield = len(self.hfields)
  m.nflex = 0
  m.nflexvert = m.nflexedge = m.nflexelem = 0

  m.qpos0 = self.qpos0
  m.qpos_spring = self.qpos_spring

  # ----- bodies
  def barr(key, default=0.0, n=None):
    if n is None:
      return np.array([b[key] for b in self.bodies])
    return np.stack([np.asarray(b[key], dtype=np.float64)
                     for b in self.bodies])

  m.body_parentid = self.body_parentid
  m.body_rootid = self.body_rootid
  m.body_weldid = self.body_weldid
  m.body_mocapid = self.body_mocapid
  m.body_jntnum = np.array([len(b["jnt"]) for b in self.bodies],
                           dtype=np.int32)
  m.body_jntadr = np.array(
      [b["jnt"][0] if b["jnt"] else -1 for b in self.bodies], dtype=np.int32)
  m.body_dofnum = np.array(
      [sum(_JNT_NV[self.joints[j]["type"]] for j in b["jnt"])
       for b in self.bodies], dtype=np.int32)
  m.body_dofadr = np.array(
      [self.joints[b["jnt"][0]]["dofadr"] if b["jnt"] else -1
       for b in self.bodies], dtype=np.int32)
  m.body_geomnum = np.array([len(b["geomids"]) for b in self.bodies],
                            dtype=np.int32)
  m.body_geomadr = np.array(
      [b["geomids"][0] if b["geomids"] else -1 for b in self.bodies],
      dtype=np.int32)
  m.body_pos = barr("pos", n=3)
  m.body_quat = barr("quat", n=4)
  m.body_ipos = barr("ipos", n=3)
  m.body_iquat = barr("iquat", n=4)
  m.body_mass = barr("mass")
  m.body_subtreemass = self.body_subtreemass
  m.body_inertia = barr("inertia", n=3)
  m.body_gravcomp = barr("gravcomp")
  m.body_invweight0 = np.zeros((nb, 2))

  # ----- joints
  def jarr(key, n=None, dtype=np.float64):
    if n is None:
      return np.array([j[key] for j in self.joints], dtype=dtype)
    return (np.stack([np.asarray(j[key], dtype=np.float64)
                      for j in self.joints])
            if nj else np.zeros((0, n)))

  m.jnt_type = jarr("type", dtype=np.int32)
  m.jnt_qposadr = jarr("qposadr", dtype=np.int32)
  m.jnt_dofadr = jarr("dofadr", dtype=np.int32)
  m.jnt_bodyid = jarr("body", dtype=np.int32)
  m.jnt_limited = jarr("limited", dtype=np.int32)
  m.jnt_actfrclimited = jarr("actfrclimited", dtype=np.int32)
  m.jnt_actgravcomp = jarr("actgravcomp", dtype=np.int32)
  m.jnt_solref = jarr("solref", n=2)
  m.jnt_solimp = jarr("solimp", n=5)
  m.jnt_pos = jarr("pos", n=3)
  m.jnt_axis = jarr("axis", n=3)
  m.jnt_stiffness = jarr("stiffness")
  m.jnt_range = jarr("range", n=2)
  m.jnt_actfrcrange = jarr("actfrcrange", n=2)
  m.jnt_margin = jarr("margin")

  # ----- dofs
  m.dof_bodyid = np.array([b for b, _ in self.dof], dtype=np.int32)
  m.dof_jntid = np.array([j for _, j in self.dof], dtype=np.int32)
  dof_parent = []
  for jnt in self.joints:
    dof_parent.extend(jnt.get("dof_parent", []))
  m.dof_parentid = np.array(dof_parent, dtype=np.int32)
  m.dof_armature = np.concatenate(
      [[j["armature"]] * _JNT_NV[j["type"]] for j in self.joints]) \
      if nj else np.zeros(0)
  m.dof_damping = np.concatenate(
      [[j["damping"]] * _JNT_NV[j["type"]] for j in self.joints]) \
      if nj else np.zeros(0)
  m.dof_frictionloss = np.concatenate(
      [[j["frictionloss"]] * _JNT_NV[j["type"]] for j in self.joints]) \
      if nj else np.zeros(0)
  m.dof_solref = np.stack(
      [j["solref"] for j in self.joints for _ in range(_JNT_NV[j["type"]])]
  ) if nj else np.zeros((0, 2))
  m.dof_solimp = np.stack(
      [j["solimp"] for j in self.joints for _ in range(_JNT_NV[j["type"]])]
  ) if nj else np.zeros((0, 5))
  m.dof_invweight0 = np.zeros(self.nv)

  # ----- geoms
  def garr(key, n=None, dtype=np.float64):
    if n is None:
      return np.array([g[key] for g in self.geoms], dtype=dtype)
    return (np.stack([np.asarray(g[key], dtype=np.float64)
                      for g in self.geoms])
            if ng else np.zeros((0, n)))

  m.geom_type = garr("type", dtype=np.int32)
  m.geom_contype = garr("contype", dtype=np.int32)
  m.geom_conaffinity = garr("conaffinity", dtype=np.int32)
  m.geom_condim = garr("condim", dtype=np.int32)
  m.geom_bodyid = garr("body", dtype=np.int32)
  m.geom_dataid = garr("dataid", dtype=np.int32)
  m.geom_group = garr("group", dtype=np.int32)
  m.geom_priority = garr("priority", dtype=np.int32)
  m.geom_solmix = garr("solmix")
  m.geom_rgba = (np.stack([g["rgba"] for g in self.geoms])
                 if self.geoms else np.zeros((0, 4)))
  m.geom_solref = garr("solref", n=2)
  m.geom_solimp = garr("solimp", n=5)
  m.geom_size = garr("size", n=3)
  m.geom_pos = garr("pos", n=3)
  m.geom_quat = garr("quat", n=4)
  m.geom_friction = garr("friction", n=3)
  m.geom_margin = garr("margin")
  m.geom_gap = garr("gap")
  m.geom_fluid = np.zeros((ng, 12))
  m.geom_rbound = _rbound(self)
  m.geom_matid = garr("matid", dtype=np.int32)

  # ----- sites / cams / lights
  m.site_bodyid = np.array([s["body"] for s in self.sites], dtype=np.int32)
  m.site_type = np.array([s["type"] for s in self.sites], dtype=np.int32)
  m.site_size = (np.stack([s["size"] for s in self.sites])
                 if self.sites else np.zeros((0, 3)))
  m.site_pos = (np.stack([s["pos"] for s in self.sites])
                if self.sites else np.zeros((0, 3)))
  m.site_quat = (np.stack([s["quat"] for s in self.sites])
                 if self.sites else np.zeros((0, 4)))

  nc = len(self.cams)
  m.cam_bodyid = np.array([c["body"] for c in self.cams], dtype=np.int32)
  m.cam_targetbodyid = np.array(
      [self.names["body"][c["target"]] if c["target"] else -1
       for c in self.cams], dtype=np.int32)
  m.cam_mode = np.array([c["mode"] for c in self.cams], dtype=np.int32)
  m.cam_pos = (np.stack([c["pos"] for c in self.cams])
               if nc else np.zeros((0, 3)))
  m.cam_quat = (np.stack([c["quat"] for c in self.cams])
                if nc else np.zeros((0, 4)))
  m.cam_fovy = np.array([c["fovy"] for c in self.cams])
  m.cam_resolution = (np.stack([c["resolution"] for c in self.cams])
                      .astype(np.int32) if nc else np.zeros((0, 2),
                                                            dtype=np.int32))
  m.cam_intrinsic = (np.stack([c["intrinsic"] for c in self.cams])
                     if nc else np.zeros((0, 4)))
  m.cam_sensorsize = (np.stack([c["sensorsize"] for c in self.cams])
                      if nc else np.zeros((0, 2)))
  m.cam_pos0 = np.zeros((nc, 3))
  m.cam_poscom0 = np.zeros((nc, 3))
  m.cam_mat0 = np.zeros((nc, 9))
  m.cam_projection = np.array([c.get("projection", 0) for c in self.cams],
                              dtype=np.int32)

  nl = len(self.lights)
  m.light_bodyid = np.array([l["body"] for l in self.lights], dtype=np.int32)
  m.light_targetbodyid = np.array(
      [self.names["body"][l["target"]] if l["target"] else -1
       for l in self.lights], dtype=np.int32)
  m.light_mode = np.array([l["mode"] for l in self.lights], dtype=np.int32)
  m.light_pos = (np.stack([l["pos"] for l in self.lights])
                 if nl else np.zeros((0, 3)))
  m.light_dir = (np.stack([l["dir"] for l in self.lights])
                 if nl else np.zeros((0, 3)))
  m.light_pos0 = np.zeros((nl, 3))
  m.light_poscom0 = np.zeros((nl, 3))
  m.light_dir0 = np.zeros((nl, 3))
  larr = lambda k, dv=None: np.array([l[k] for l in self.lights])
  m.light_type = larr("type").astype(np.int32)
  m.light_active = larr("active").astype(bool)
  m.light_castshadow = larr("castshadow").astype(bool)
  m.light_ambient = (np.stack([l["ambient"] for l in self.lights])
                     if nl else np.zeros((0, 3)))
  m.light_diffuse = (np.stack([l["diffuse"] for l in self.lights])
                     if nl else np.zeros((0, 3)))
  m.light_specular = (np.stack([l["specular"] for l in self.lights])
                      if nl else np.zeros((0, 3)))
  m.light_attenuation = (np.stack([l["attenuation"] for l in self.lights])
                         if nl else np.zeros((0, 3)))
  m.light_cutoff = larr("cutoff").astype(np.float64)
  m.light_exponent = larr("exponent").astype(np.float64)

  # ----- materials / textures (mjmodel.h mat_*/tex_*; tex_data is the
  # reference's flat byte stream, tex_adr in bytes, nchannel == 3)
  nmat, ntex = len(self.materials), len(self.textures)
  m.nmat, m.ntex = nmat, ntex
  marr = lambda k: np.array([x[k] for x in self.materials])
  m.mat_texid = (marr("texid").astype(np.int32) if nmat
                 else np.zeros(0, dtype=np.int32))
  m.mat_texuniform = (marr("texuniform").astype(bool) if nmat
                      else np.zeros(0, dtype=bool))
  m.mat_texrepeat = (np.stack([x["texrepeat"] for x in self.materials])
                     if nmat else np.zeros((0, 2)))
  m.mat_rgba = (np.stack([x["rgba"] for x in self.materials])
                if nmat else np.zeros((0, 4)))
  m.mat_emission = (marr("emission").astype(np.float64) if nmat
                    else np.zeros(0))
  m.mat_specular = (marr("specular").astype(np.float64) if nmat
                    else np.zeros(0))
  m.mat_shininess = (marr("shininess").astype(np.float64) if nmat
                     else np.zeros(0))
  m.mat_reflectance = (marr("reflectance").astype(np.float64) if nmat
                       else np.zeros(0))
  m.tex_type = np.array([t["type"] for t in self.textures], dtype=np.int32)
  m.tex_width = np.array([t["width"] for t in self.textures],
                         dtype=np.int32)
  m.tex_height = np.array([t["height"] for t in self.textures],
                          dtype=np.int32)
  m.tex_adr = (np.cumsum(
      [0] + [t["data"].size for t in self.textures[:-1]]).astype(np.int64)
      if ntex else np.zeros(0, dtype=np.int64))
  m.tex_nchannel = np.full(ntex, 3, dtype=np.int32)
  m.tex_data = (np.concatenate([t["data"] for t in self.textures])
                if ntex else np.zeros(0, dtype=np.uint8))
  _skin_emit(self, m)

  # ----- meshes / hfields
  if self.meshes:
    m.mesh_vertadr = np.cumsum(
        [0] + [len(x["verts"]) for x in self.meshes[:-1]]).astype(np.int32)
    m.mesh_vertnum = np.array([len(x["verts"]) for x in self.meshes],
                              dtype=np.int32)
    m.mesh_faceadr = np.cumsum(
        [0] + [len(x["faces"]) for x in self.meshes[:-1]]).astype(np.int32)
    m.mesh_facenum = np.array([len(x["faces"]) for x in self.meshes],
                              dtype=np.int32)
    m.mesh_vert = np.concatenate([x["verts"] for x in self.meshes])
    m.mesh_face = np.concatenate([x["faces"] for x in self.meshes])
    m.mesh_pos = np.stack([x["pos"] for x in self.meshes])
    m.mesh_quat = np.stack([x["quat"] for x in self.meshes])
  else:
    m.mesh_vertadr = np.zeros(0, dtype=np.int32)
    m.mesh_vertnum = np.zeros(0, dtype=np.int32)
    m.mesh_faceadr = np.zeros(0, dtype=np.int32)
    m.mesh_facenum = np.zeros(0, dtype=np.int32)
    m.mesh_vert = np.zeros((0, 3))
    m.mesh_face = np.zeros((0, 3), dtype=np.int32)
    m.mesh_pos = np.zeros((0, 3))
    m.mesh_quat = np.zeros((0, 4))
  if self.hfields:
    m.hfield_nrow = np.array([h["nrow"] for h in self.hfields],
                             dtype=np.int32)
    m.hfield_ncol = np.array([h["ncol"] for h in self.hfields],
                             dtype=np.int32)
    m.hfield_adr = np.cumsum(
        [0] + [h["nrow"] * h["ncol"] for h in self.hfields[:-1]]
    ).astype(np.int32)
    m.hfield_size = np.stack([h["size"] for h in self.hfields])
    m.hfield_data = np.concatenate([h["data"] for h in self.hfields])
  else:
    m.hfield_nrow = np.zeros(0, dtype=np.int32)
    m.hfield_ncol = np.zeros(0, dtype=np.int32)
    m.hfield_adr = np.zeros(0, dtype=np.int32)
    m.hfield_size = np.zeros((0, 4))
    m.hfield_data = np.zeros(0)

  # ----- pairs / excludes
  npair = len(self.pair_list)
  m.pair_geom1 = np.array([p["geom1"] for p in self.pair_list],
                          dtype=np.int32)
  m.pair_geom2 = np.array([p["geom2"] for p in self.pair_list],
                          dtype=np.int32)
  m.pair_dim = np.array([p["condim"] for p in self.pair_list],
                        dtype=np.int32)
  m.pair_friction = (np.stack([p["friction"] for p in self.pair_list])
                     if npair else np.zeros((0, 5)))
  m.pair_solref = (np.stack([p["solref"] for p in self.pair_list])
                   if npair else np.zeros((0, 2)))
  m.pair_solreffriction = (
      np.stack([p["solreffriction"] for p in self.pair_list])
      if npair else np.zeros((0, 2)))
  m.pair_solimp = (np.stack([p["solimp"] for p in self.pair_list])
                   if npair else np.zeros((0, 5)))
  m.pair_margin = np.array([p["margin"] for p in self.pair_list])
  m.pair_gap = np.array([p["gap"] for p in self.pair_list])
  m.exclude_signature = np.array(self.exclude_list, dtype=np.int64)

  # ----- equality
  ne = len(self.eq_list)
  m.eq_type = np.array([e["type"] for e in self.eq_list], dtype=np.int32)
  m.eq_obj1id = np.array([e["obj1"] for e in self.eq_list], dtype=np.int32)
  m.eq_obj2id = np.array([e["obj2"] for e in self.eq_list], dtype=np.int32)
  m.eq_objtype = np.array([e["objtype"] for e in self.eq_list],
                          dtype=np.int32)
  m.eq_active0 = np.array([e["active"] for e in self.eq_list],
                          dtype=np.int32)
  m.eq_data = (np.stack([e["data"] for e in self.eq_list])
               if ne else np.zeros((0, 11)))
  m.eq_solref = (np.stack([e["solref"] for e in self.eq_list])
                 if ne else np.zeros((0, 2)))
  m.eq_solimp = (np.stack([e["solimp"] for e in self.eq_list])
                 if ne else np.zeros((0, 5)))

  # ----- tendons
  nt = len(self.tendon_list)
  m.tendon_adr = np.array([t["adr"] for t in self.tendon_list],
                          dtype=np.int32)
  m.tendon_num = np.array([t["num"] for t in self.tendon_list],
                          dtype=np.int32)
  m.tendon_limited = np.array([t["limited"] for t in self.tendon_list],
                              dtype=np.int32)
  m.tendon_range = (np.stack([t["range"] for t in self.tendon_list])
                    if nt else np.zeros((0, 2)))
  m.tendon_solref_lim = (np.stack([t["solref_lim"]
                                   for t in self.tendon_list])
                         if nt else np.zeros((0, 2)))
  m.tendon_solimp_lim = (np.stack([t["solimp_lim"]
                                   for t in self.tendon_list])
                         if nt else np.zeros((0, 5)))
  m.tendon_solref_fri = (np.stack([t["solref_fri"]
                                   for t in self.tendon_list])
                         if nt else np.zeros((0, 2)))
  m.tendon_solimp_fri = (np.stack([t["solimp_fri"]
                                   for t in self.tendon_list])
                         if nt else np.zeros((0, 5)))
  m.tendon_margin = np.array([t["margin"] for t in self.tendon_list])
  m.tendon_stiffness = np.array([t["stiffness"] for t in self.tendon_list])
  m.tendon_damping = np.array([t["damping"] for t in self.tendon_list])
  m.tendon_armature = np.array([t["armature"] for t in self.tendon_list])
  m.tendon_frictionloss = np.array(
      [t["frictionloss"] for t in self.tendon_list])
  m.tendon_lengthspring = (np.stack([t["springlength"]
                                     for t in self.tendon_list])
                           if nt else np.zeros((0, 2)))
  m.tendon_length0 = np.zeros(nt)
  m.tendon_invweight0 = np.zeros(nt)
  m.wrap_type = np.array([w[0] for w in self.wraps], dtype=np.int32)
  m.wrap_objid = np.array([w[1] for w in self.wraps], dtype=np.int32)
  m.wrap_prm = np.array([w[2] for w in self.wraps])

  # ----- actuators (enum values already in the engine's v3.11 convention)
  nu = len(self.act_list)
  al = self.act_list
  m.actuator_trntype = np.array([x["trntype"] for x in al], dtype=np.int32)
  m.actuator_dyntype = np.array([x["dyn"] for x in al], dtype=np.int32)
  m.actuator_gaintype = np.array([x["gain"] for x in al], dtype=np.int32)
  m.actuator_biastype = np.array([x["bias"] for x in al], dtype=np.int32)
  m.actuator_trnid = (np.array([x["trnid"] for x in al], dtype=np.int32)
                      .reshape(nu, 2) if nu else
                      np.zeros((0, 2), dtype=np.int32))
  m.actuator_actadr = np.array([x["actadr"] for x in al], dtype=np.int32)
  m.actuator_actnum = np.array([x["actnum"] for x in al], dtype=np.int32)
  m.actuator_group = np.array([x["group"] for x in al], dtype=np.int32)
  m.actuator_ctrllimited = np.array([x["ctrllimited"] for x in al],
                                    dtype=np.int32)
  m.actuator_forcelimited = np.array([x["forcelimited"] for x in al],
                                     dtype=np.int32)
  m.actuator_actlimited = np.array([x["actlimited"] for x in al],
                                   dtype=np.int32)
  m.actuator_actearly = np.array([x["actearly"] for x in al],
                                 dtype=np.int32)
  m.actuator_dynprm = (np.stack([x["dynprm"] for x in al])
                       if nu else np.zeros((0, 10)))
  m.actuator_gainprm = (np.stack([x["gainprm"] for x in al])
                        if nu else np.zeros((0, 10)))
  m.actuator_biasprm = (np.stack([x["biasprm"] for x in al])
                        if nu else np.zeros((0, 10)))
  m.actuator_ctrlrange = (np.stack([x["ctrlrange"] for x in al])
                          if nu else np.zeros((0, 2)))
  m.actuator_forcerange = (np.stack([x["forcerange"] for x in al])
                           if nu else np.zeros((0, 2)))
  m.actuator_actrange = (np.stack([x["actrange"] for x in al])
                         if nu else np.zeros((0, 2)))
  m.actuator_gear = (np.stack([x["gear"] for x in al])
                     if nu else np.zeros((0, 6)))
  m.actuator_cranklength = np.array([x["cranklength"] for x in al])
  m.actuator_lengthrange = (np.stack([x["lengthrange"] for x in al])
                            if nu else np.zeros((0, 2)))
  m.actuator_ctrlspec = np.array([x.get("ctrlspec", 0) for x in al],
                                 dtype=np.int32)
  m.actuator_acc0 = np.zeros(nu)

  # ----- sensors
  ns = len(self.sensor_list)
  sl = self.sensor_list
  m.sensor_type = np.array([x["type"] for x in sl], dtype=np.int32)
  m.sensor_datatype = np.array([x["datatype"] for x in sl], dtype=np.int32)
  m.sensor_needstage = np.array([x["needstage"] for x in sl],
                                dtype=np.int32)
  m.sensor_objtype = np.array([x["objtype"] for x in sl], dtype=np.int32)
  m.sensor_objid = np.array([x["objid"] for x in sl], dtype=np.int32)
  m.sensor_reftype = np.array([x["reftype"] for x in sl], dtype=np.int32)
  m.sensor_refid = np.array([x["refid"] for x in sl], dtype=np.int32)
  m.sensor_dim = np.array([x["dim"] for x in sl], dtype=np.int32)
  m.sensor_adr = np.array([x["adr"] for x in sl], dtype=np.int32)
  m.sensor_cutoff = np.array([x["cutoff"] for x in sl])

  # ----- keyframes
  nk = len(self.key_list)
  m.key_time = np.array([k["time"] for k in self.key_list])
  m.key_qpos = (np.stack([k["qpos"] for k in self.key_list])
                if nk else np.zeros((0, self.nq)))
  m.key_qvel = (np.stack([k["qvel"] for k in self.key_list])
                if nk else np.zeros((0, self.nv)))
  m.key_act = (np.stack([k["act"] for k in self.key_list])
               if nk else np.zeros((0, self.na)))
  m.key_ctrl = (np.stack([k["ctrl"] for k in self.key_list])
                if nk else np.zeros((0, nu)))
  m.key_mpos = (np.stack([k["mpos"] for k in self.key_list])
                if nk else np.zeros((0, 3 * self.nmocap)))
  m.key_mquat = (np.stack([k["mquat"] for k in self.key_list])
                 if nk else np.zeros((0, 4 * self.nmocap)))
  _flex_emit(self, m)
  _tree_meta(self, m)
  _body_simple(self, m)
  _visual_emit(self, m)
  return m


def _skin_emit(self, m) -> None:
  """mjModel skin_* arrays (CopyObjects skin section, user_model.cc):
  flat vertex/face/bone tables with per-skin addressing; bone weight lists
  concatenated in bone order."""
  skins = self.skins
  ns = len(skins)
  m.nskin = ns
  arr = lambda k, dt: np.array([s[k] for s in skins], dtype=dt)
  m.skin_matid = arr("matid", np.int32)
  m.skin_group = arr("group", np.int32)
  m.skin_inflate = arr("inflate", np.float64)
  m.skin_rgba = (np.stack([s["rgba"] for s in skins])
                 if ns else np.zeros((0, 4)))
  m.skin_vertnum = np.array([len(s["verts"]) for s in skins],
                            dtype=np.int32)
  m.skin_vertadr = (np.concatenate(
      [[0], np.cumsum(m.skin_vertnum)[:-1]]).astype(np.int32)
      if ns else np.zeros(0, dtype=np.int32))
  m.skin_facenum = np.array([len(s["faces"]) for s in skins],
                            dtype=np.int32)
  m.skin_faceadr = (np.concatenate(
      [[0], np.cumsum(m.skin_facenum)[:-1]]).astype(np.int32)
      if ns else np.zeros(0, dtype=np.int32))
  m.skin_bonenum = np.array([len(s["bones"]) for s in skins],
                            dtype=np.int32)
  m.skin_boneadr = (np.concatenate(
      [[0], np.cumsum(m.skin_bonenum)[:-1]]).astype(np.int32)
      if ns else np.zeros(0, dtype=np.int32))
  m.skin_vert = (np.concatenate([s["verts"] for s in skins])
                 if ns else np.zeros((0, 3)))
  m.skin_face = (np.concatenate([s["faces"] for s in skins])
                 if ns else np.zeros((0, 3), dtype=np.int32))
  tc = [s["texcoord"] for s in skins if len(s["texcoord"])]
  m.skin_texcoord = np.concatenate(tc) if tc else np.zeros((0, 2))
  m.skin_texcoordadr = np.full(ns, -1, dtype=np.int32)
  off = 0
  for i, s in enumerate(skins):
    if len(s["texcoord"]):
      m.skin_texcoordadr[i] = off
      off += len(s["texcoord"])
  bones = [b for s in skins for b in s["bones"]]
  nb = len(bones)
  m.skin_bonebodyid = np.array([b["body"] for b in bones], dtype=np.int32)
  m.skin_bonebindpos = (np.stack([b["bindpos"] for b in bones])
                        if nb else np.zeros((0, 3)))
  m.skin_bonebindquat = (np.stack([b["bindquat"] for b in bones])
                         if nb else np.zeros((0, 4)))
  m.skin_bonevertnum = np.array([len(b["vertid"]) for b in bones],
                                dtype=np.int32)
  m.skin_bonevertadr = (np.concatenate(
      [[0], np.cumsum(m.skin_bonevertnum)[:-1]]).astype(np.int32)
      if nb else np.zeros(0, dtype=np.int32))
  m.skin_bonevertid = (np.concatenate([b["vertid"] for b in bones])
                       if nb else np.zeros(0, dtype=np.int32))
  m.skin_bonevertweight = (np.concatenate([b["vertweight"] for b in bones])
                           if nb else np.zeros(0))


def _visual_emit(self, m) -> None:
  """<visual> subsections as a nested namespace mirroring mjVisual, so
  put_model's _vis_meta_of reads compiled models and pip models alike."""
  vis = getattr(self.spec, "visual", None)
  if not vis:
    return
  from types import SimpleNamespace
  sections = {}
  for tag, attrs in vis.items():
    vals = {}
    for k, s in attrs.items():
      try:
        arr = np.array([float(x) for x in s.split()])
        vals[k] = float(arr[0]) if arr.size == 1 else arr
      except ValueError:
        vals[k] = s
    sections[tag] = SimpleNamespace(**vals)
  m.vis = SimpleNamespace(**sections)


def _body_simple(self, m) -> None:
  """mjModel.body_simple (user_model.cc:1012-1062): leaf bodies with an
  identity inertial frame that are direct world children (or children of a
  static direct world child), demoted for offset/misaligned joints or
  multiple rotational dofs; promoted to 2 when every joint is a slide.
  Consumed by setconst's invweight shortcuts
  (engine_setconst.c:913-921, 940-948)."""
  nbody = len(self.bodies)
  par = m.body_parentid
  simple = np.zeros(nbody, dtype=np.int32)
  simple[0] = 1        # world: init passes, never demoted (parent demotion
                       # skips id 0, user_model.cc:2926-2928)
  jnts_of = {}
  for jd in self.joints:
    jnts_of.setdefault(jd["body"], []).append(jd)
  is_parent = np.zeros(nbody, dtype=bool)
  for b in range(1, nbody):
    is_parent[par[b]] = True
  for b in range(1, nbody):
    sameframe = (np.abs(m.body_ipos[b]).max() < 1e-14
                 and np.abs(m.body_iquat[b]
                            - np.array([1.0, 0, 0, 0])).max() < 1e-14)
    chain_ok = (par[b] == 0
                or (par[b] > 0 and par[par[b]] == 0
                    and m.body_dofnum[par[b]] == 0))
    if not sameframe or not chain_ok or is_parent[b]:
      continue
    ok, rotfound = True, False
    for jd in jnts_of.get(b, []):
      axis_aligned = int(np.sum(np.abs(jd["axis"]) > 1e-14)) == 1
      if rotfound or np.abs(jd["pos"]).max() > 1e-14 or \
          (jd["type"] in (2, 3) and not axis_aligned):
        ok = False
        break
      if jd["type"] in (1, 3):          # ball / hinge
        rotfound = True
    if not ok:
      continue
    simple[b] = 1
    if m.body_dofnum[b] > 0 and all(
        jd["type"] == 2 for jd in jnts_of.get(b, [])):
      simple[b] = 2
  # inertia-bearing tendons demote every wrapped body (FinalizeSimple,
  # user_model.cc:4256-4273)
  for t in range(len(self.tendon_list)):
    if m.tendon_armature[t] == 0:
      continue
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    for w in range(adr, adr + num):
      wt, oid = int(m.wrap_type[w]), int(m.wrap_objid[w])
      if wt == 3:         # site
        simple[m.site_bodyid[oid]] = 0
      elif wt in (4, 5):  # sphere/cylinder geom
        simple[m.geom_bodyid[oid]] = 0
  m.body_simple = simple


def _flex_emit(self, m) -> None:
  """Flex model arrays (mjModel flex_* fields; generation:
  user_flexcomp.cc). Derived flexedge_length0/invweight0 are filled by
  setconst with the engine's own forward pass."""
  flexes = self.flexes
  nflex = len(flexes)
  m.nflex = nflex
  zi = lambda n: np.zeros((n,), dtype=np.int32)
  if nflex == 0:
    m.nflexvert = m.nflexedge = m.nflexelem = 0
    for fname in ("flex_dim", "flex_vertadr", "flex_vertnum",
                  "flex_edgeadr", "flex_edgenum", "flex_elemadr",
                  "flex_elemnum", "flex_elemdataadr", "flex_vertbodyid",
                  "flex_edgeequality", "flex_condim", "flex_priority",
                  "flex_contype", "flex_conaffinity", "flex_selfcollide"):
      setattr(m, fname, zi(0))
    m.flex_elem = zi(0)
    m.flex_edge = zi(0).reshape(0, 2)
    m.flex_centered = np.zeros(0, dtype=bool)
    m.flex_rigid = np.zeros(0, dtype=bool)
    m.flexedge_rigid = np.zeros(0, dtype=bool)
    m.flex_internal = np.zeros(0, dtype=bool)
    for fname in ("flex_radius", "flexedge_length0", "flexedge_invweight0",
                  "flex_edgestiffness", "flex_edgedamping", "flex_damping",
                  "flex_margin", "flex_gap", "flex_solmix"):
      setattr(m, fname, np.zeros(0))
    m.flex_vert = np.zeros((0, 3))
    m.flex_friction = np.zeros((0, 3))
    m.flex_solref = np.zeros((0, 2))
    m.flex_solimp = np.zeros((0, 5))
    return

  nv_list = [len(f["verts"]) for f in flexes]
  ne_list = [len(f["edges"]) for f in flexes]
  nl_list = [len(f["elems"]) for f in flexes]
  m.nflexvert = sum(nv_list)
  m.nflexedge = sum(ne_list)
  m.nflexelem = sum(nl_list)
  cum = lambda xs: np.cumsum([0] + xs[:-1]).astype(np.int32)
  m.flex_vertadr = cum(nv_list)
  m.flex_vertnum = np.array(nv_list, dtype=np.int32)
  m.flex_edgeadr = cum(ne_list)
  m.flex_edgenum = np.array(ne_list, dtype=np.int32)
  m.flex_elemadr = cum(nl_list)
  m.flex_elemnum = np.array(nl_list, dtype=np.int32)
  m.flex_dim = np.array([f["dim"] for f in flexes], dtype=np.int32)
  m.flex_elemdataadr = cum([n * (f["dim"] + 1)
                            for n, f in zip(nl_list, flexes)])
  m.flex_elem = np.concatenate(
      [np.asarray(f["elems"], dtype=np.int32).ravel() for f in flexes])
  m.flex_edge = np.concatenate(
      [np.asarray(f["edges"], dtype=np.int32).reshape(-1, 2)
       for f in flexes])
  m.flex_vertbodyid = np.concatenate(
      [np.asarray(f["vertbody"], dtype=np.int32) for f in flexes])
  m.flex_vert = np.concatenate(
      [np.stack(f["verts"]) for f in flexes])
  m.flex_centered = np.array([f["centered"] for f in flexes], dtype=np.int32)
  m.flex_rigid = np.array(
      [len(f["pins"]) == len(f["verts"]) for f in flexes], dtype=np.int32)
  # an edge is rigid when both endpoints ride the same rigid body
  er = []
  for f in flexes:
    vb = f["vertbody"]
    for (a, b) in f["edges"]:
      er.append(a in f["pins"] and b in f["pins"] and vb[a] == vb[b])
  m.flexedge_rigid = np.array(er, dtype=np.int32)
  m.flex_edgeequality = np.array(
      [1 if f["edge_attrs"].get("equality", "false") in ("true", "1")
       else 0 for f in flexes], dtype=np.int32)
  ca = [f["contact_attrs"] for f in flexes]
  m.flex_condim = np.array([int(c.get("condim", "3")) for c in ca],
                           dtype=np.int32)
  m.flex_priority = np.array([int(c.get("priority", "0")) for c in ca],
                             dtype=np.int32)
  m.flex_contype = np.array([int(c.get("contype", "1")) for c in ca],
                            dtype=np.int32)
  m.flex_conaffinity = np.array([int(c.get("conaffinity", "1"))
                                 for c in ca], dtype=np.int32)
  selfmap = {"none": 0, "narrow": 1, "bvh": 2, "sap": 3, "auto": 4}
  m.flex_selfcollide = np.array(
      [selfmap[c.get("selfcollide", "auto")] for c in ca], dtype=np.int32)
  m.flex_internal = np.array(
      [c.get("internal", "false") in ("true", "1") for c in ca],
      dtype=np.int32)
  m.flex_radius = np.array([f["radius"] for f in flexes])
  ea = [f["edge_attrs"] for f in flexes]
  m.flex_edgestiffness = np.array([float(e.get("stiffness", "0"))
                                   for e in ea])
  m.flex_edgedamping = np.array([float(e.get("damping", "0")) for e in ea])
  m.flex_damping = np.array([float(c.get("damping", "0")) for c in ca])
  m.flex_friction = np.stack(
      [_f(c, "friction", [1, 0.005, 0.0001], 3) for c in ca])
  m.flex_solref = np.stack([_f(c, "solref", _SOLREF, 2) for c in ca])
  m.flex_solimp = np.stack([_f(c, "solimp", _SOLIMP, 5) for c in ca])
  m.flex_margin = np.array([float(c.get("margin", "0")) for c in ca])
  m.flex_gap = np.array([float(c.get("gap", "0")) for c in ca])
  m.flex_solmix = np.array([float(c.get("solmix", "1")) for c in ca])
  m.flexedge_length0 = np.zeros(m.nflexedge)
  m.flexedge_invweight0 = np.zeros(m.nflexedge)
  m.flex_body_simple = np.array(
      [bool(b.get("flex_simple")) for b in self.bodies], dtype=bool)

  # fragment topology: elemlayer (dim-3 surface distance) + evpairs
  # (dim<3 internal element-vertex pairs), mjCFlex::Compile fragment
  # processing (user_mesh.cc:5470-5665)
  m.flex_activelayers = np.array(
      [int(c.get("activelayers", "1")) for c in ca], dtype=np.int32)
  layers, evpairs, evnum = [], [], []
  for f in flexes:
    layer, ev = _flex_topology(f["dim"], f["elems"])
    layers.append(layer)
    evpairs.append(ev)
    evnum.append(len(ev) // 2)
  m.flex_elemlayer = (np.concatenate(layers).astype(np.int32)
                      if layers else np.zeros(0, dtype=np.int32))
  m.flex_evpairnum = np.array(evnum, dtype=np.int32)
  m.flex_evpairadr = np.where(
      m.flex_evpairnum > 0,
      np.cumsum([0] + evnum[:-1]), -1).astype(np.int32)
  m.flex_evpair = (np.concatenate(evpairs).astype(np.int32)
                   if evpairs else np.zeros(0, dtype=np.int32))


def _flex_topology(dim: int, elems):
  """Border fragments -> element connectivity -> elemlayer + evpairs.

  Mirrors mjCFlex::Compile's fragment pass (user_mesh.cc:5470-5665):
  fragments are each element's (dim)-vertex faces, keyed by sorted vertex
  ids; a fragment appearing once is border, consecutive equal fragments
  connect their elements. elemlayer is 0 for dim<3 and the value-iterated
  distance from border elements for dim-3; evpairs (dim<3 only) pair each
  connected border element with the opposite vertex of its neighbor."""
  nelem = len(elems)
  frag_order = {1: ((0,), (1,)),
                2: ((0, 1), (2, 0), (1, 2)),
                3: ((0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2))}[dim]
  frags = []
  for e, el in enumerate(elems):
    for orig in frag_order:
      ov = tuple(el[i] for i in orig)
      frags.append((tuple(sorted(ov)), e, ov))
  frags.sort(key=lambda t: (t[0], t[1], t[2]))

  border = np.zeros(nelem, dtype=bool)
  connect = []                        # (e1, e2, sorted frag verts)
  cnt = 1
  for n in range(1, len(frags)):
    if frags[n - 1][0] == frags[n][0]:
      connect.append((frags[n - 1][1], frags[n][1], frags[n][0]))
      cnt += 1
    else:
      if cnt == 1:
        border[frags[n - 1][1]] = True
      cnt = 1
  if cnt == 1 and frags:
    border[frags[-1][1]] = True

  if dim < 3:
    layer = np.zeros(nelem, dtype=np.int32)
  else:
    layer = np.full(nelem, nelem + 1, dtype=np.int32)
    layer[border] = 0
    change = True
    while change:
      change = False
      for e1, e2, _ in connect:
        if layer[e1] > layer[e2] + 1:
          layer[e1] = layer[e2] + 1
          change = True
        elif layer[e2] > layer[e1] + 1:
          layer[e2] = layer[e1] + 1
          change = True

  ev = []
  if dim < 3:
    for e1, e2, frag in connect:
      if border[e1] or border[e2]:
        pair = (e1, e2)
        for ei in range(2):
          for v in elems[pair[ei]]:
            if v not in frag:
              ev.extend([pair[1 - ei], v])
  return layer, np.array(ev, dtype=np.int32)


def _tree_meta(self, m) -> None:
  """Kinematic-tree tables + sleep policies (user_model.cc tree
  assignment; AUTO policy resolution: mj_setConst,
  engine_setconst.c:340-470). A tree is a maximal set of bodies whose
  chain to the world carries dofs; static bodies get treeid -1."""
  nbody = len(self.bodies)
  nv = self.nv
  parent = m.body_parentid
  dofnum = m.body_dofnum
  has_chain = np.zeros(nbody, dtype=bool)
  treeid = np.full(nbody, -1, dtype=np.int32)
  ntree = 0
  for b in range(1, nbody):
    has_chain[b] = has_chain[parent[b]] or dofnum[b] > 0
    if has_chain[b]:
      if has_chain[parent[b]]:
        treeid[b] = treeid[parent[b]]
      else:
        treeid[b] = ntree
        ntree += 1
  m.ntree = ntree
  m.body_treeid = treeid
  m.dof_treeid = treeid[m.dof_bodyid].astype(np.int32)
  m.tree_bodyadr = np.array(
      [np.nonzero(treeid == t)[0][0] for t in range(ntree)], dtype=np.int32)
  m.tree_bodynum = np.array(
      [(treeid == t).sum() for t in range(ntree)], dtype=np.int32)
  m.tree_dofadr = np.array(
      [np.nonzero(m.dof_treeid == t)[0][0] for t in range(ntree)],
      dtype=np.int32)
  m.tree_dofnum = np.array(
      [(m.dof_treeid == t).sum() for t in range(ntree)], dtype=np.int32)

  # tendon tree spans (unique wrap-body trees, first two recorded)
  ntendon = len(self.tendon_list)
  m.tendon_treeid = np.full((ntendon, 2), -1, dtype=np.int32)
  m.tendon_treenum = np.zeros(ntendon, dtype=np.int32)
  for t in range(ntendon):
    trees = []
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    for w in range(adr, adr + num):
      wt, oid = int(m.wrap_type[w]), int(m.wrap_objid[w])
      if wt == 1:    # joint
        b = int(m.jnt_bodyid[oid])
      elif wt == 3:  # site
        b = int(m.site_bodyid[oid])
      elif wt in (4, 5):  # sphere/cylinder geom
        b = int(m.geom_bodyid[oid])
      else:
        continue
      tid = int(treeid[b])
      if tid >= 0 and tid not in trees:
        trees.append(tid)
    m.tendon_treenum[t] = len(trees)
    for k, tid in enumerate(trees[:2]):
      m.tendon_treeid[t, k] = tid

  # per-tree policy: explicit body sleep attrs override AUTO
  # (ProcessLists, user_model.cc:3215)
  policy = np.zeros(ntree, dtype=np.int32)  # AUTO
  names = {"never": 3, "allowed": 4, "init": 5}
  for b, body in enumerate(self.bodies):
    sl = body.get("sleep", "auto")
    if sl != "auto" and treeid[b] >= 0:
      if sl not in names:
        raise ValueError(f"unknown sleep policy '{sl}'")
      policy[treeid[b]] = names[sl]

  # AUTO resolution: actuated trees never auto-sleep
  def mark_never(tid):
    if tid >= 0 and policy[tid] == 0:
      policy[tid] = 1  # AUTO_NEVER
  for i in range(len(m.actuator_trntype)):
    trn = int(m.actuator_trntype[i])
    tid0 = int(m.actuator_trnid[i, 0])
    if trn in (0, 1):    # joint
      mark_never(int(treeid[m.jnt_bodyid[tid0]]))
    elif trn in (2, 4):  # slidercrank / site
      mark_never(int(treeid[m.site_bodyid[tid0]]))
    elif trn == 5:       # body (adhesion)
      mark_never(int(treeid[tid0]))
    elif trn == 3:       # tendon: all spanned trees
      tt = int(tid0)
      for k in range(int(m.tendon_treenum[tt])):
        mark_never(int(m.tendon_treeid[tt, k]))

  # inter-tree tendons with stiffness/damping (or >2 trees) block sleep
  for t in range(ntendon):
    tn = int(m.tendon_treenum[t])
    if tn < 2:
      continue
    coupled = (tn > 2 or m.tendon_stiffness[t] != 0
               or m.tendon_damping[t] != 0)
    if not coupled:
      continue
    for k in range(min(tn, 2)):
      tid = int(m.tendon_treeid[t, k])
      if tid >= 0:
        if policy[tid] in (4, 5):
          raise ValueError(
              f"tree {tid} marked sleepable but coupled by tendon {t}")
        if policy[tid] == 0:
          policy[tid] = 1

  # remaining AUTO -> AUTO_ALLOWED (engine_setconst.c:464)
  policy[policy == 0] = 2
  m.tree_sleep_policy = policy


def _rbound(self) -> np.ndarray:
  """Bounding sphere radius per geom (mjCGeom::SetBoundingVolume)."""
  out = np.zeros(len(self.geoms))
  for i, g in enumerate(self.geoms):
    t, s = g["type"], g["size"]
    if t in (0, 1):
      out[i] = 0.0
    elif t == 2:
      out[i] = s[0]
    elif t in (3,):
      out[i] = s[0] + s[1]
    elif t == 5:
      out[i] = math.hypot(s[0], s[1])
    elif t in (4, 6):
      out[i] = float(np.linalg.norm(s))
    elif t == 7:
      # symmetric AABB around the (CoM-centered) frame origin
      # (mjCGeom::SetBoundingVolume mesh branch)
      v = self.meshes[g["dataid"]]["verts"]
      out[i] = float(np.linalg.norm(
          np.maximum(np.abs(v.min(axis=0)), np.abs(v.max(axis=0)))))
  return out

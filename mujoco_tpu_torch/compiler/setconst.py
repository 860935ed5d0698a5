"""qpos0-derived model constants, computed with this package's own engine
(mj_setConst, src/engine/engine_setconst.c:860-1332), on a device:

  tendon_length0        tendon lengths at qpos0
  tendon_lengthspring   springlength < 0 → resolved to length0
  body_invweight0       mean diag of J M⁻¹ Jᵀ at the body CoM (tran, rot)
  dof_invweight0        mean diag of the joint block of M⁻¹
  tendon_invweight0     ten_J M⁻¹ ten_Jᵀ
  actuator_acc0         |M⁻¹ momentᵀ| per actuator
  actuator_lengthrange  muscles: from tendon/joint limits when computable
  eq_data completion    connect/weld anchors resolved in the other body
  cam/light *0 fields   tracking-mode reference poses
  stat.meaninertia      mean diag of M at qpos0

The engine runs at f64 on ``device``. Where the reference solves one
right-hand side per M⁻¹ product, each group of rows (a body's six Jacobian
rows, a joint's unit rows, the tendons, the actuators, the flex edges) is
one ``smooth.solve_m`` call of shape (1, k, nv): the same math. The
muscles' length-range simulations run as one batch of 2·n envs.
"""

from __future__ import annotations

import numpy as np
import torch


def set_const(cm, device) -> None:
  """Fill the derived constants of a CompiledModel in place, running the
  engine on ``device``."""
  from mujoco_tpu_torch.models import io
  from mujoco_tpu_torch.ops import smooth, support

  m = io.put_model(cm, dtype=torch.float64, device=device)
  d = io.make_data(m, device=device)
  d = smooth.kinematics(m, d)
  d = smooth.com_pos(m, d)
  d = smooth.tendon(m, d)
  d = smooth.crb(m, d)
  d = smooth.factor_m(m, d)
  d = smooth.transmission(m, d)
  host = lambda t: t[0].detach().cpu().numpy()

  nv = cm.nv
  nb = cm.nbody

  # tendon length0 / springlength resolution
  if cm.ntendon:
    len0 = host(d.ten_length)
    cm.tendon_length0 = len0
    ls = cm.tendon_lengthspring
    for t in range(cm.ntendon):
      if ls[t, 0] < 0 and ls[t, 1] < 0:
        ls[t] = (len0[t], len0[t])

  if nv == 0:
    cm.stat.meaninertia = 1.0
    return

  qM = host(d.qM)

  def minv(rows):
    """M⁻¹ of each row of a (k, nv) array, as (k, nv)."""
    rhs = torch.as_tensor(np.asarray(rows, dtype=np.float64).reshape(-1, nv),
                          device=m.device)
    return host(smooth.solve_m(m, d, rhs[None]))

  bsimple = getattr(cm, "body_simple", np.zeros(nb, dtype=np.int32))

  # body_invweight0 (engine_setconst.c:905-936); slide-only simple bodies
  # shortcut to 1/mass with zero rotation (engine_setconst.c:913-921)
  inv = np.zeros((nb, 2))
  for b in range(1, nb):
    if cm.body_dofnum[cm.body_weldid[b]] == 0:
      continue
    if bsimple[b] == 2:
      inv[b, 0] = 1.0 / max(cm.body_mass[b], 1e-15)
      inv[b, 1] = 0.0
      continue
    jacp, jacr = support.jac(m, d, d.xipos[:, b], b)    # (1, 3, nv) each
    jac6 = np.concatenate([host(jacp), host(jacr)])
    a = jac6 @ minv(jac6).T
    inv[b, 0] = np.trace(a[:3, :3]) / 3
    inv[b, 1] = np.trace(a[3:, 3:]) / 3
  cm.body_invweight0 = inv

  # dof_invweight0 (engine_setconst.c:938-987); the same simple-body
  # shortcut applies per joint (engine_setconst.c:940-948)
  dinv = np.zeros(nv)
  for j in range(cm.njnt):
    adr = int(cm.jnt_dofadr[j])
    if bsimple[cm.jnt_bodyid[j]] == 2:
      dinv[adr] = 1.0 / max(cm.body_mass[cm.jnt_bodyid[j]], 1e-15)
      continue
    dnum = {0: 6, 1: 3}.get(int(cm.jnt_type[j]), 1)
    jac = np.zeros((dnum, nv))
    for k in range(dnum):
      jac[k, adr + k] = 1.0
    a = jac @ minv(jac).T
    if dnum == 6:
      dinv[adr:adr + 3] = np.trace(a[:3, :3]) / 3
      dinv[adr + 3:adr + 6] = np.trace(a[3:, 3:]) / 3
    elif dnum == 3:
      dinv[adr:adr + 3] = np.trace(a) / 3
    else:
      dinv[adr] = a[0, 0]
  cm.dof_invweight0 = dinv

  # tendon_invweight0 (engine_setconst.c:1028-1036)
  if cm.ntendon:
    tj = host(d.ten_J)
    cm.tendon_invweight0 = np.einsum("tv,tv->t", tj, minv(tj))

  # actuator_acc0 (engine_setconst.c:1037-1044); multi-output (SO3) blocks
  # use the first output row (outadr), matching the reference's oadr indexing
  if cm.nu:
    mom = host(d.actuator_moment)
    oadr = np.asarray(m.actuator_outadr)
    cm.actuator_acc0 = np.linalg.norm(minv(mom[oadr]), axis=1)
    # dampratio resolution (engine_setconst.c:1135-1178): for position-like
    # actuators (gainprm[0] == -biasprm[1], incl. SO3 servos; PID
    # single-sources kp), biasprm[2] > 0 is a damping RATIO — convert to
    # -damping via the reflected inertia of the transmission
    dof_m0 = np.diag(qM)
    for i in range(cm.nu):
      gp, bp = cm.actuator_gainprm[i], cm.actuator_biasprm[i]
      is_pid = cm.actuator_gaintype[i] == 5
      if not is_pid and gp[0] != -bp[1]:
        continue
      if bp[2] <= 0:
        continue
      row = mom[oadr[i]]
      trn2 = row * row
      mass = float(np.sum(np.where(trn2 > 1e-15, dof_m0 / np.maximum(
          trn2, 1e-15), 0.0)))
      kp = -bp[1] if is_pid else gp[0]
      bp[2] = -bp[2] * 2 * np.sqrt(max(kp * mass, 0.0))
    # muscle lengthrange via the reference's mini-simulation
    # (mj_setLengthRange + evalAct, engine_setconst.c: default mjLROpt —
    # accel 20, timeconst 1, timestep 0.01, inttotal 10, interval 2):
    # push the transmission both ways with an acceleration-scaled force
    # under exponential velocity decay; record the length extremes over the
    # final window. Explicit user ranges are kept (useexisting).
    need = [i for i in range(cm.nu)
            if (cm.actuator_gaintype[i] == 2 or cm.actuator_biastype[i] == 2)
            and not cm.actuator_lengthrange[i, 0]
            < cm.actuator_lengthrange[i, 1]]
    if need:
      cm.actuator_lengthrange[need] = length_ranges(cm, need, device)

  # eq_data completion (engine_setconst.c:1050-1105)
  xpos = host(d.xpos)
  xmat = host(d.xmat)
  xquat = host(d.xquat)
  for i in range(cm.neq):
    if cm.eq_objtype[i] != 1:  # body semantics only
      continue
    id1, id2 = int(cm.eq_obj1id[i]), int(cm.eq_obj2id[i])
    data = cm.eq_data[i]
    if cm.eq_type[i] == 0:  # connect: anchor is in body1 local frame
      p = xpos[id1] + xmat[id1] @ data[0:3]
      data[3:6] = xmat[id2].T @ (p - xpos[id2])
    elif cm.eq_type[i] == 1:  # weld: anchor given in body2
      if np.any(data[6:10]):
        data[6:10] /= np.linalg.norm(data[6:10])
        continue
      p = xpos[id2] + xmat[id2] @ data[0:3]
      data[3:6] = xmat[id1].T @ (p - xpos[id1])
      data[6:10] = _mulquat(_conj(xquat[id1]), xquat[id2])

  # camera / light reference poses, computed in FIXED mode (the reference
  # temporarily forces fixed mode during setconst, engine_setconst.c:835-858)
  subtree = host(d.subtree_com)
  for i in range(cm.ncam):
    b = int(cm.cam_bodyid[i])
    cpos = xpos[b] + xmat[b] @ cm.cam_pos[i]
    cmat = _quat2mat(_mulquat(xquat[b], cm.cam_quat[i]))
    cm.cam_pos0[i] = cpos - xpos[b]
    cm.cam_poscom0[i] = cpos - subtree[b]
    cm.cam_mat0[i] = cmat.reshape(9)
  for i in range(cm.nlight):
    b = int(cm.light_bodyid[i])
    lpos = xpos[b] + xmat[b] @ cm.light_pos[i]
    ldir = xmat[b] @ cm.light_dir[i]
    cm.light_pos0[i] = lpos - xpos[b]
    cm.light_poscom0[i] = lpos - subtree[b]
    cm.light_dir0[i] = ldir

  # flex edge rest lengths and inverse weights (engine_setconst.c:989-1026)
  if getattr(cm, "nflex", 0):
    from mujoco_tpu_torch.ops import flex as flex_mod
    d = flex_mod.flex(m, d)
    cm.flexedge_length0 = host(d.flexedge_length)
    ej = host(d.flexedge_J)
    inv = np.zeros(cm.nflexedge)
    solve = []
    for f in range(cm.nflex):
      ea, en = int(cm.flex_edgeadr[f]), int(cm.flex_edgenum[f])
      va = int(cm.flex_vertadr[f])
      for e in range(ea, ea + en):
        v1, v2 = cm.flex_edge[e]
        b1 = int(cm.flex_vertbodyid[va + v1])
        b2 = int(cm.flex_vertbodyid[va + v2])
        if cm.flexedge_rigid[e]:
          inv[e] = 0.0
        elif (self_simple(cm, b1) and self_simple(cm, b2)):
          # slide-only point bodies (body_simple==2 shortcut)
          inv[e] = (1 / cm.body_mass[b1] + 1 / cm.body_mass[b2]) / 2
        else:
          solve.append(e)
    if solve:
      inv[solve] = np.einsum("ev,ev->e", ej[solve], minv(ej[solve]))
    cm.flexedge_invweight0 = inv

  # body characteristic lengths → dof_length sleep-tolerance weights
  # (engine_setconst.c:1244-1310): max of com-joint distances and
  # rbound + com-geom distance, floored at 1e-5; rotational dofs inherit
  # the body length, linear dofs are 1
  xipos_n = host(d.xipos)
  xanchor = host(d.xanchor)
  gx = host(d.geom_xpos)
  blen = np.zeros(nb)
  for j in range(cm.njnt):
    bid = int(cm.jnt_bodyid[j])
    blen[bid] = max(blen[bid], np.linalg.norm(xipos_n[bid] - xanchor[j]))
    pb = int(cm.body_parentid[bid])
    blen[pb] = max(blen[pb], np.linalg.norm(xipos_n[pb] - xanchor[j]))
  blen[0] = 0.0
  for b in range(1, nb):
    for g in range(int(cm.body_geomadr[b]),
                   int(cm.body_geomadr[b]) + int(cm.body_geomnum[b])):
      if cm.geom_rbound[g] > 0:
        blen[b] = max(blen[b], cm.geom_rbound[g]
                      + np.linalg.norm(xipos_n[b] - gx[g]))
  # flex edges widen the endpoint bodies (engine_setconst.c:1278-1284)
  if getattr(cm, "nflex", 0):
    for f in range(cm.nflex):
      ea, en = int(cm.flex_edgeadr[f]), int(cm.flex_edgenum[f])
      va = int(cm.flex_vertadr[f])
      for e in range(ea, ea + en):
        for v in cm.flex_edge[e]:
          b = int(cm.flex_vertbodyid[va + int(v)])
          blen[b] = max(blen[b], cm.flexedge_length0[e])
  blen[1:] = np.maximum(blen[1:], 1e-5)
  dof_length = np.ones(nv)
  for v in range(nv):
    j = int(cm.dof_jntid[v])
    t = int(cm.jnt_type[j])
    off = v - int(cm.jnt_dofadr[j])
    if t in (1, 3) or (t == 0 and off >= 3):  # ball/hinge/free-rot
      dof_length[v] = blen[int(cm.dof_bodyid[v])]
  cm.dof_length = dof_length

  # stat.meaninertia (engine_setconst.c:1324-1331)
  cm.stat.meaninertia = float(np.trace(qM) / nv)

  # remaining mjStatistic fields (setStat, engine_setconst.c:1190-1340):
  # bounding box over bodies/joints/sites/geoms at qpos0 → center/extent;
  # meansize = mean body characteristic length; meanmass = mean body mass
  xpos_n = host(d.xpos)
  pts = [xpos_n[1:nb], xipos_n[1:nb]]
  if cm.njnt:
    pts.append(xanchor)
  if getattr(cm, "nsite", 0):
    pts.append(host(d.site_xpos))
  rb = np.zeros(cm.ngeom)
  for g in range(cm.ngeom):
    if cm.geom_rbound[g] > 0:
      rb[g] = cm.geom_rbound[g]
    elif int(cm.geom_type[g]) == 0:                 # plane
      sx, sy = cm.geom_size[g, 0], cm.geom_size[g, 1]
      rb[g] = max(sx, sy) * 0.1 if (sx or sy) else 0.01
    elif int(cm.geom_type[g]) == 1:                 # hfield
      rb[g] = float(np.max(cm.hfield_size[int(cm.geom_dataid[g])])) * 0.1
  if cm.ngeom:
    pts.append(gx - rb[:, None])
    pts.append(gx + rb[:, None])
  allp = np.concatenate([p.reshape(-1, 3) for p in pts]) \
      if pts else np.zeros((0, 3))
  if len(allp):
    xmin, xmax = allp.min(axis=0), allp.max(axis=0)
    cm.stat.center = 0.5 * (xmin + xmax)
    extent = max(1e-5, float((xmax - xmin).max())) \
        if (xmax[0] > xmin[0]) else 1.0
  else:
    cm.stat.center = np.zeros(3)
    extent = 1.0
  if nb > 1:
    cm.stat.meansize = float(np.mean(blen[1:]))
    cm.stat.meanmass = float(np.mean(cm.body_mass[1:]))
  else:
    cm.stat.meansize = 0.1
    cm.stat.meanmass = 1.0
  cm.stat.extent = max(extent, 2 * cm.stat.meansize)


# mj_setLengthRange's defaults (mjLROpt): accel, timeconst, timestep,
# inttotal, interval
LR_ACCEL, LR_TIMECONST, LR_DT, LR_INTTOTAL, LR_INTERVAL = (
    20.0, 1.0, 0.01, 10.0, 2.0)


def length_range_model(cm, device):
  """The Model of the length-range simulation: f64 on ``device``, at
  timestep LR_DT, with frictionloss, contact, spring, damper, gravity and
  actuation disabled (mjCModel::LengthRange, user_model.cc:2579)."""
  from mujoco_tpu_torch.models import io
  from mujoco_tpu_torch.models.types import DisableBit

  m = io.put_model(cm, dtype=torch.float64, device=device)
  disable = int(DisableBit.FRICTIONLOSS | DisableBit.CONTACT
                | DisableBit.SPRING | DisableBit.DAMPER
                | DisableBit.GRAVITY | DisableBit.ACTUATION)
  return m.replace(opt=m.opt.replace(
      timestep=torch.tensor(LR_DT, dtype=torch.float64, device=m.device),
      disableflags=disable))


def length_range_step(m, d, out, sign, decay):
  """One step of every env of the length-range batch (evalAct): decay
  qvel, run the forward pass with qfrc_applied = the env's moment row
  scaled so |M⁻¹ f| = LR_ACCEL, signed by its side, and integrate by
  Euler. ``out`` (B,) is each env's output row, ``sign`` (B,) its side.
  Returns the new Data and each env's actuator length before the step."""
  from mujoco_tpu_torch.ops import forward, linalg_cuda

  envs = torch.arange(out.shape[0], device=out.device)
  d = d.replace(qvel=d.qvel * decay)
  d = forward.fwd_position(m, d)
  d = forward.fwd_velocity(m, d)
  length = d.actuator_length[envs, out]
  moment = d.actuator_moment[envs, out]
  acc = linalg_cuda.spd_solve(d.qM, moment.contiguous())
  nrm = torch.clamp(torch.linalg.vector_norm(acc, dim=1), min=1e-15)
  d = d.replace(qfrc_applied=moment * (sign * LR_ACCEL / nrm)[:, None])
  d = forward.fwd_actuation(m, d)
  d = forward.fwd_acceleration(m, d)
  d = forward.fwd_constraint(m, d)
  d = forward.euler(m, d)
  return d, length


def length_ranges(cm, index, device) -> np.ndarray:
  """mj_setLengthRange's optimization (engine_setconst.c, evalAct) for the
  actuators ``index``, as one batch of 2·len(index) envs: env 2k pushes
  actuator index[k] to its least length, env 2k + 1 to its largest. Each
  env runs, from qpos0, 1000 steps of ``length_range_step`` and keeps the
  extremum of its length over the last LR_INTERVAL seconds. Actuation is
  disabled in that simulation, so no actuator's force, and hence no
  lengthrange, enters another's run: each env's range is the reference's
  run for that actuator and side. Returns (len(index), 2)."""
  from mujoco_tpu_torch.parallel import rollout

  m = length_range_model(cm, device)
  n = len(index)
  out = torch.as_tensor(np.repeat(np.asarray(m.actuator_outadr)[index], 2),
                        dtype=torch.int64, device=m.device)
  sign = torch.tensor([-1.0, 1.0] * n, dtype=torch.float64, device=m.device)
  decay = float(np.exp(-LR_DT / max(0.01, LR_TIMECONST)))
  nstep = int(round(LR_INTTOTAL / LR_DT))
  d = rollout.make_batch(m, 2 * n, device=m.device)
  lmin = torch.full((2 * n,), torch.inf, dtype=torch.float64,
                    device=m.device)
  lmax = torch.full_like(lmin, -torch.inf)
  for _ in range(nstep):
    d, length = length_range_step(m, d, out, sign, decay)
    in_win = d.time.reshape(-1) > (LR_INTTOTAL - LR_INTERVAL)
    lmin = torch.where(in_win, torch.minimum(lmin, length), lmin)
    lmax = torch.where(in_win, torch.maximum(lmax, length), lmax)
  lo = lmin[0::2].cpu().numpy()
  hi = lmax[1::2].cpu().numpy()
  for k, i in enumerate(index):
    if not hi[k] > lo[k]:
      raise ValueError(
          f"invalid lengthrange ({lo[k]}, {hi[k]}) for actuator {i}")
  return np.stack([lo, hi], axis=1)


def _mulquat(a, b):
  w1, x1, y1, z1 = a
  w2, x2, y2, z2 = b
  return np.array([
      w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
      w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
      w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
      w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _conj(q):
  return q * np.array([1.0, -1, -1, -1])


def _quat2mat(q):
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def self_simple(cm, b: int) -> bool:
  """Generated flexcomp point bodies (3 slide dofs, no rotation) — the
  reference's body_simple == 2 class."""
  return bool(cm.flex_body_simple[b]) if hasattr(cm, "flex_body_simple") \
      else False

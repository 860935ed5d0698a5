"""Batched, randomized and split rollouts (port of
mujoco_tpu/parallel/rollout.py: ``make_batch`` :25, ``batched_step`` :32,
``rollout`` :37, ``STATE_FIELDS`` :59, ``scan_steps`` :64 with its split
over a mesh :86-132 and the single-device ``_scan_steps_local`` :135,
``make_mesh`` :173,
``sharded_step`` :177, ``randomize_model`` :195, ``step_randomized`` :224,
``check_reset`` :231).

The env batch is the leading axis of every Data tensor. A batched f32
rollout on the card of a model in the megastep class runs as one launch of
the megastep kernel (``ops/megastep_cuda.py``); everything else takes the
stage path, where a Python loop takes the place of ``lax.scan``. Neither
reads a value back to the host, so a rollout only enqueues work on the
card. A domain-randomized Model carries a leading env axis on the leaves
of ``types.ENV_LEAVES`` and takes the stage path (``draw_leaves``, the
port's own, draws such values from a seed); a split rollout
(``sharded_step``, ``scan_steps(mesh=)``) steps one chunk of the env axis
on each device of a list.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mujoco_tpu_torch.models import io
from mujoco_tpu_torch.models.types import (ENV_LEAVES, Data, EqType,
                                          JointType, Model)
from mujoco_tpu_torch.ops import forward, megastep_cuda
from mujoco_tpu_torch.ops.linalg_cuda import has_tangent
from mujoco_tpu_torch.utils.struct import cached

# the integration state that crosses step boundaries, act (the actuators'
# activations) and the ctrl and sensor history buffers with it; everything
# else in Data, sensordata too, is workspace that forward() recomputes
# from it (the reference's list)
STATE_FIELDS = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart",
                "qacc", "qfrc_applied", "xfrc_applied", "eq_active",
                "mocap_pos", "mocap_quat", "history", "tree_asleep")


def expand(d: Data, nbatch: int) -> Data:
  """Broadcast a batch-of-1 Data to nbatch envs (contiguous copies)."""
  def grow(v):
    if isinstance(v, torch.Tensor):
      return v.expand((nbatch,) + v.shape[1:]).contiguous()
    return v.replace(**{k: grow(getattr(v, k)) for k in v.__dataclass_fields__})
  return grow(d)


def make_batch(m: Model, nbatch: int, dtype: Optional[torch.dtype] = None,
               device=None) -> Data:
  """A Data of nbatch envs, each a copy of make_data's initial state."""
  return expand(io.make_data(m, dtype=dtype, device=device), nbatch)


def batched_step(m: Model) -> Callable[[Data], Data]:
  """A callable that steps a batched Data once (the counterpart of the
  reference's ``jit(vmap(step))``; the port's Data is batched already and
  the step runs op by op, with no graph capture)."""
  return lambda d: forward.step(m, d)


def rollout(m: Model, d: Data, nstep: int,
            ctrl: Optional[torch.Tensor] = None):
  """nstep physics steps of the batch, each starting from the whole Data
  the previous one returned (the reference's ``lax.scan`` over the full
  Data); with ctrl (nstep, B, nu), step t runs at ctrl[t] and nstep is
  ctrl's length. Returns the final Data and the (nstep, B, nq) qpos
  trajectory, qpos after each step (rollout.rollout, python/mujoco/
  rollout.py)."""
  step = batched_step(m)
  if ctrl is not None:
    nstep = ctrl.shape[0]
  traj = []
  for t in range(nstep):
    if ctrl is not None:
      d = d.replace(ctrl=ctrl[t])
    d = step(d)
    traj.append(d.qpos)
  qpos = (torch.stack(traj) if traj else
          d.qpos.new_zeros((0,) + tuple(d.qpos.shape)))
  return d, qpos


def check_reset(m: Model, d: Data, d_fresh: Data) -> Data:
  """Per-env divergence guard (mj_checkPos/Vel analog): an env whose qpos
  or qvel holds a NaN or a magnitude above 1e10 gets d_fresh's integration
  state back; other envs are untouched. d_fresh is a batch of 1 or of B."""
  bad = (~torch.isfinite(d.qpos).all(-1) | ~torch.isfinite(d.qvel).all(-1)
         | (d.qpos.abs().amax(-1) > 1e10) | (d.qvel.abs().amax(-1) > 1e10))

  def pick(fresh, cur):
    b = bad.reshape(bad.shape + (1,) * (cur.dim() - 1))
    return torch.where(b, fresh, cur)

  keys = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart", "qacc")
  if d.history.shape[-1]:
    keys += ("history",)
  return d.replace(**{k: pick(getattr(d_fresh, k), getattr(d, k))
                      for k in keys})


def megastep_eligible(m: Model, d: Data, d_fresh: Data) -> bool:
  """The megastep dispatch's conditions other than the device: a batched
  f32 rollout whose state and Model need no gradient and carry no
  forward-mode tangent, d_fresh a batch of 1, ``megastep_cuda.enabled()``
  (the MJTPU_MEGASTEP switch) and ``megastep_cuda.supported(m)``, which
  refuses a per-env Model (reference ``_scan_steps_local`` :141-150)."""
  state = [getattr(d, k) for k in STATE_FIELDS]
  return (d.qpos.dtype == torch.float32
          and not any(t.requires_grad for t in state)
          and not has_tangent(*state)
          and d_fresh.qpos.shape[0] == 1 and megastep_cuda.enabled()
          and megastep_cuda.supported(m)
          and not megastep_cuda.model_requires_grad(m))


def scan_steps(m: Model, d, nstep: int, d_fresh: Optional[Data] = None,
               check: bool = True, mesh: Optional[Sequence] = None):
  """nstep physics steps carrying only STATE_FIELDS between steps; with
  check=True each step ends with the divergence guard. Returns d_fresh's
  workspace merged with the final state, as the reference does.

  With a ``mesh`` of more than one device (``make_mesh``: a list of
  devices or names), d's envs are split into contiguous chunks, one per
  device (``_split``); each chunk runs ``_scan_steps_local`` on its device
  and its own stream, with a copy of the Model made once per (Model,
  device), so a card's megastep sees only that card's envs. The chunks
  come back as one Data in env order on d's device, as the reference
  returns one Data of the global batch from its ``shard_map``. Given a
  list of per-device Data (``sharded_step``'s ``shard_data``), each runs
  on its own device in place and the list is returned: the counterpart of
  the reference's committed multi-device sharding. A mesh of one device is
  the plain call. A shard that fails raises; none falls back to another
  device or path."""
  if isinstance(d, (list, tuple)):
    return _scan_shards(m, list(d), nstep, d_fresh, check)
  if mesh is not None and len(mesh) > 1:
    out = _scan_shards(m, _split(d, [torch.device(x) for x in mesh]), nstep,
                       d_fresh, check)
    return _gather(out, d.qpos.device)
  return _scan_steps_local(m, d, nstep, d_fresh, check)


def _scan_steps_local(m: Model, d: Data, nstep: int,
                      d_fresh: Optional[Data], check: bool) -> Data:
  """One device's ``scan_steps`` (reference ``_scan_steps_local`` :135).

  As the reference's, a rollout on the card that is ``megastep_eligible``
  goes to the megastep kernel. That path is numerically equivalent to the
  stage path, not bit-identical, and its guard resets time to 0 rather
  than to d_fresh.time. CPU tensors keep the stage path, as the reference
  keeps its XLA path off the TPU."""
  if d_fresh is None:
    d_fresh = io.make_data(m, dtype=d.qpos.dtype, device=d.qpos.device)
  if d.qpos.is_cuda and megastep_eligible(m, d, d_fresh):
    return megastep_cuda.scan_batch(m, d, nstep, d_fresh=d_fresh,
                                    check=check)
  template = expand(d_fresh, d.qpos.shape[0])
  st = {k: getattr(d, k) for k in STATE_FIELDS}
  for _ in range(nstep):
    dd = forward.step(m, template.replace(**st))
    if check:
      dd = check_reset(m, dd, d_fresh)
    st = {k: getattr(dd, k) for k in STATE_FIELDS}
  return template.replace(**st)


def _device(dev) -> torch.device:
  """dev with its index: a bare "cuda" is the current card."""
  dev = torch.device(dev)
  if dev.type == "cuda" and dev.index is None:
    return torch.device("cuda", torch.cuda.current_device())
  return dev


# per Model, its copies on other devices (``struct.cached``: dropped with
# the Model)
_COPIES: dict = {}


def _model_on(m: Model, dev: torch.device) -> Model:
  """m on device dev, copied once per (Model, device)."""
  if _device(m.device) == dev:
    return m
  copies = cached(_COPIES, m, lambda m: {})
  if dev not in copies:
    copies[dev] = m.to(dev)
  return copies[dev]


def _tensors(v):
  if isinstance(v, torch.Tensor):
    return [v]
  return [t for k in v.__dataclass_fields__ for t in _tensors(getattr(v, k))]


def _scan_shards(m: Model, shards: list, nstep: int,
                 d_fresh: Optional[Data], check: bool) -> list:
  """Each shard's ``_scan_steps_local`` on the shard's device; the shards
  on cards run on each card's own stream, all enqueued before any is
  waited for, so the cards run at once."""
  out = []
  for shard in shards:
    dev = _device(shard.qpos.device)
    mm = _model_on(m, dev)
    fresh = None if d_fresh is None else d_fresh.to(dev)
    if dev.type != "cuda":
      out.append(_scan_steps_local(mm, shard, nstep, fresh, check))
      continue
    stream = torch.cuda.Stream(dev)
    current = torch.cuda.current_stream(dev)
    # the shard was written on the card's current stream; its memory must
    # outlive the side stream's reads, the result's its reads after
    stream.wait_stream(current)
    for t in _tensors(shard):
      t.record_stream(stream)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
      res = _scan_steps_local(mm, shard, nstep, fresh, check)
    current.wait_stream(stream)
    for t in _tensors(res):
      t.record_stream(current)
    out.append(res)
  return out


def _gather(shards: list, dev) -> Data:
  """The shards' envs in order as one Data on device dev; a leaf of size 0
  (an absent act or mocap) comes back (B, 0), as the reference restores
  its zero-size leaves to the global batch (:126-130)."""
  def cat(vs):
    if isinstance(vs[0], torch.Tensor):
      return torch.cat([v.to(dev) for v in vs])
    return vs[0].replace(**{k: cat([getattr(v, k) for v in vs])
                            for k in vs[0].__dataclass_fields__})

  return cat(shards)


def randomize_model(m: Model, leaf_updates: dict):
  """A per-env (domain-randomized) Model: each leaf named in
  ``leaf_updates`` (dotted, ``opt.gravity``) takes its value (B, …), one
  row per env, and every other leaf stays one value for all envs. Returns
  (batched Model, axes), axes the names of the per-env leaves, as the
  reference returns its vmap axis spec:

      bm, axes = randomize_model(m, {"geom_friction": fric})   # (B, ngeom, 3)
      d = step_randomized(bm, axes, d)

  The leaves of ``types.ENV_LEAVES`` are admitted; any other raises
  NotImplementedError, and so does a stage that does not read an
  admitted leaf per env (``geom_size`` at a mesh, height-field, SDF or
  flex collision). As in the reference, derived fields are not
  recomputed: ``body_subtreemass``, ``dof_invweight0``, ``geom_rbound``
  (the broadphase does not widen with a larger ``geom_size``),
  ``cam_pos0``, ``cam_poscom0``, ``cam_mat0``, ``light_pos0``,
  ``light_poscom0``, ``light_dir0``, ``tendon_length0``,
  ``tendon_invweight0``, ``actuator_acc0`` and ``actuator_lengthrange``
  keep the model's values. A static choice the compiler made stays the
  model's: rows only for the dofs and tendons with friction loss and for
  the limited joints and tendons, joint damping and tendon armature only
  where the model has some. ``draw_leaves`` draws such values from a
  seed."""
  nbatch = None
  updates = {}
  for name, value in leaf_updates.items():
    if name not in ENV_LEAVES:
      raise NotImplementedError(
          f"randomizing Model.{name} per env is not ported; the admitted "
          f"leaves are {', '.join(ENV_LEAVES)}")
    old = m.leaf(name)
    value = torch.as_tensor(value, dtype=old.dtype, device=old.device)
    if value.shape[1:] != old.shape or value.dim() != old.dim() + 1:
      raise ValueError(f"randomize_model: {name} has shape "
                       f"{tuple(value.shape)}, want (B,) + "
                       f"{tuple(old.shape)}")
    if nbatch not in (None, value.shape[0]):
      raise ValueError("randomize_model: leaves with different env counts")
    nbatch = value.shape[0]
    updates[name] = value.contiguous()
  return m.replace_leaves(updates), tuple(updates)


# the leaves ``draw_leaves`` draws where none are named: the control
# loop's dynamics
DEFAULT_LEAVES = ("opt.gravity", "geom_friction", "body_mass", "body_ipos",
                  "body_inertia", "dof_damping", "dof_armature",
                  "dof_frictionloss", "actuator_gainprm", "actuator_biasprm",
                  "geom_solref", "geom_solimp", "jnt_stiffness",
                  "actuator_gear", "body_pos", "body_quat", "qpos0",
                  "opt.timestep")
# what pixel-RL users randomize: colours, lights and cameras
RENDER_LEAVES = ("geom_rgba", "mat_rgba", "light_pos", "light_dir",
                 "light_ambient", "light_diffuse", "light_specular",
                 "cam_pos", "cam_quat")
# what sim-to-real users randomize first: where geoms, sites (the IMU) and
# joints sit on their bodies, and the contact and constraint parameters
FRAME_LEAVES = ("geom_pos", "geom_quat", "site_pos", "site_quat", "site_size",
                "body_iquat", "jnt_pos", "jnt_axis")
CONTACT_LEAVES = ("geom_margin", "geom_solmix", "pair_friction",
                  "pair_solref", "pair_solreffriction", "pair_solimp",
                  "pair_margin", "pair_gap", "jnt_margin", "dof_solref",
                  "dof_solimp", "jnt_actfrcrange", "opt.impratio")
_MARGINS = ("geom_margin", "pair_margin", "pair_gap", "jnt_margin")
_COLOURS = ("geom_rgba", "mat_rgba", "light_ambient", "light_diffuse",
            "light_specular")
_SOLIMPS = ("geom_solimp", "jnt_solimp", "tendon_solimp_lim",
            "tendon_solimp_fri", "eq_solimp", "pair_solimp", "dof_solimp")
_RANGES = ("jnt_range", "tendon_range", "tendon_lengthspring",
           "actuator_ctrlrange", "actuator_forcerange", "jnt_actfrcrange")


def _turn(q, rng, angle):
  """Quaternions q (…, 4) each turned by up to ``angle`` rad about a random
  axis (q ⊗ δ, δ a unit quaternion)."""
  axis = rng.standard_normal(q.shape[:-1] + (3,))
  axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
  half = 0.5 * rng.uniform(0.0, angle, q.shape[:-1] + (1,))
  w2, v2 = np.cos(half)[..., 0], np.sin(half) * axis
  w1, v1 = q[..., 0], q[..., 1:]
  return np.concatenate([
      (w1 * w2 - (v1 * v2).sum(-1))[..., None],
      w1[..., None] * v2 + w2[..., None] * v1 + np.cross(v1, v2)], axis=-1)


def draw_leaves(m: Model, nbatch: int, seed: int, leaves=None) -> dict:
  """Per-env values of ``leaves`` (``DEFAULT_LEAVES`` by default; any of
  ``types.ENV_LEAVES`` by name), nbatch rows each, as numpy arrays for
  ``randomize_model``, drawn from a numpy seed by one rule per leaf:

  - ``body_pos``: the model's plus an offset in [−0.02, 0.02] per entry;
    ``qpos0``: plus one in [−0.05, 0.05] at a hinge or slide and in
    [−0.02, 0.02] at a free joint's position (a zero entry does not move
    under a factor); ``light_pos`` and ``cam_pos``: plus one in
    [−0.03, 0.03]; ``geom_pos``, ``site_pos`` and ``jnt_pos``: plus one
    in [−0.01, 0.01];
  - the margins and the gap (``geom_margin``, ``pair_margin``,
    ``pair_gap``, ``jnt_margin``): plus an offset in [0, 0.002], so that
    a zero margin moves too and none turns negative;
  - ``body_quat``, ``cam_quat``, ``geom_quat``, ``site_quat``,
    ``body_iquat`` and the ball and free joints' quaternions in ``qpos0``:
    turned by up to 0.05 rad about a random axis;
    ``light_dir`` and ``jnt_axis``: plus an offset in [−0.05, 0.05] per
    entry, rescaled to the model's length;
  - colours (``geom_rgba``, ``mat_rgba``, the lights' ambient, diffuse and
    specular): plus an offset in [−0.2, 0.2] per channel, reflected at 0
    and 1 into [0, 1] (so a channel at 1 moves too); an rgba's alpha
    stays the model's;
  - ``geom_solimp`` and the joint, tendon, equality, pair and dof solimps
    kept valid:
    dmin^[1, 1.5] ≤ dmin ≤ dmax ≤ dmax^[0.7, 1], all in (0, 1), width
    ×[0.7, 1.3], midpoint^[0.7, 1.3], power 1 + (power − 1)·[0.7, 1.3] ≥ 1;
  - ranges (``jnt_range``, ``tendon_range``, ``tendon_lengthspring``,
    ``actuator_ctrlrange``, ``actuator_forcerange``,
    ``jnt_actfrcrange``): each end times a
    factor in [0.95, 1.05], the two then put in order (lo ≤ hi; lo < hi
    where the model's were);
  - ``eq_data``: each entry times a factor in [0.95, 1.05], but a weld's
    relative quaternion (entries 6-9), turned by up to 0.05 rad;
  - the rest of the leaves past the default eighteen (``geom_size``, the
    tendons' stiffness, damping, friction loss, armature and margin, the
    solrefs, ``actuator_dynprm``, ``site_size``, ``geom_solmix``,
    ``pair_friction``, ``opt.impratio``): the model's times a factor in
    [0.95, 1.05] per entry;
  - every other leaf of the eighteen: the model's times a factor in
    [0.7, 1.3] per entry.

  A factor keeps each sign, so a solref keeps its mode (standard where
  positive, direct where negative), and a zero (a tendon's absent
  stiffness or armature) stays zero."""
  rng = np.random.default_rng(seed)
  out = {}
  for name in DEFAULT_LEAVES if leaves is None else leaves:
    base = m.leaf(name).detach().cpu().numpy().astype(np.float64)
    val = np.repeat(base[None], nbatch, axis=0)
    u = lambda a, b, shape=val.shape: rng.uniform(a, b, shape)
    if name == "body_pos":
      val = val + u(-0.02, 0.02)
    elif name in ("light_pos", "cam_pos"):
      val = val + u(-0.03, 0.03)
    elif name in ("geom_pos", "site_pos", "jnt_pos"):
      val = val + u(-0.01, 0.01)
    elif name in _MARGINS:
      val = val + u(0.0, 0.002)
    elif name in ("body_quat", "cam_quat", "geom_quat", "site_quat",
                  "body_iquat"):
      val = _turn(val, rng, 0.05)
    elif name in ("light_dir", "jnt_axis"):
      moved = val + u(-0.05, 0.05)
      val = moved * (np.linalg.norm(val, axis=-1, keepdims=True)
                     / np.linalg.norm(moved, axis=-1, keepdims=True))
    elif name in _COLOURS:
      moved = 1.0 - np.abs(1.0 - np.abs(val + u(-0.2, 0.2)))
      if val.shape[-1] == 4:
        moved[..., 3] = val[..., 3]
      val = moved
    elif name == "qpos0":
      for j in range(m.njnt):
        adr, jt = int(m.jnt_qposadr[j]), int(m.jnt_type[j])
        if jt in (JointType.HINGE, JointType.SLIDE):
          val[:, adr] += u(-0.05, 0.05, (nbatch,))
        else:
          if jt == JointType.FREE:
            val[:, adr:adr + 3] += u(-0.02, 0.02, (nbatch, 3))
            adr += 3
          val[:, adr:adr + 4] = _turn(val[:, adr:adr + 4], rng, 0.05)
    elif name in _SOLIMPS:
      shape = val.shape[:-1]
      val = np.stack([val[..., 0] ** u(1.0, 1.5, shape),
                      val[..., 1] ** u(0.7, 1.0, shape),
                      val[..., 2] * u(0.7, 1.3, shape),
                      val[..., 3] ** u(0.7, 1.3, shape),
                      1 + (val[..., 4] - 1) * u(0.7, 1.3, shape)], axis=-1)
    elif name in _RANGES:
      val = np.sort(val * u(0.95, 1.05), axis=-1)
    elif name == "eq_data":
      val = val * u(0.95, 1.05)
      for e in np.nonzero(np.asarray(m.eq_type) == EqType.WELD)[0]:
        val[:, e, 6:10] = _turn(base[None, e, 6:10].repeat(nbatch, 0), rng,
                                0.05)
    elif name in DEFAULT_LEAVES:
      val = val * u(0.7, 1.3)
    else:
      val = val * u(0.95, 1.05)
    out[name] = val
  return out


def step_randomized(m_batched: Model, axes, d: Data) -> Data:
  """One step of a per-env Model (``randomize_model``) and a Data of as
  many envs: the stage path, each env at its own leaves."""
  nbatch = d.qpos.shape[0]
  for name in axes:
    if m_batched.leaf(name).shape[0] != nbatch:
      raise ValueError(f"step_randomized: {name} holds "
                       f"{m_batched.leaf(name).shape[0]} envs, Data "
                       f"{nbatch}")
  return forward.step(m_batched, d)


def make_mesh(devices=None) -> list:
  """The devices a split rollout uses, in order: ``devices`` as given (a
  list of devices or names), its first n CUDA devices for an int, every
  CUDA device by default."""
  if devices is None or isinstance(devices, int):
    if not torch.cuda.is_available():
      raise RuntimeError("no CUDA device is available; pass a list of "
                         "devices, e.g. ['cpu', 'cpu']")
    n = torch.cuda.device_count() if devices is None else devices
    return [torch.device("cuda", i) for i in range(n)]
  return [torch.device(dev) for dev in devices]


def _split(d: Data, devices: Sequence[torch.device]) -> list:
  """d's env axis in len(devices) contiguous chunks, each on its device."""
  nbatch = d.qpos.shape[0]
  bounds = [nbatch * i // len(devices) for i in range(len(devices) + 1)]

  def chunk(v, lo, hi, dev):
    if isinstance(v, torch.Tensor):
      return v[lo:hi].to(dev)
    return v.replace(**{k: chunk(getattr(v, k), lo, hi, dev)
                        for k in v.__dataclass_fields__})

  return [chunk(d, lo, hi, dev)
          for lo, hi, dev in zip(bounds, bounds[1:], devices)]


def sharded_step(m: Model, mesh: Sequence[torch.device]):
  """A step with the env axis split over the devices of ``mesh``
  (``make_mesh``). Returns (step_fn, shard_data): shard_data splits a
  Data into one chunk of envs per device; step_fn steps each chunk on its
  own device, each device with a copy of the Model and its own stream, and
  reads nothing back, so the devices run at once. Physics steps are
  independent across envs: the split needs no communication."""
  devices = [torch.device(dev) for dev in mesh]
  models = [m.to(dev) for dev in devices]
  streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
             for dev in devices]

  def shard_data(d: Data) -> list:
    return _split(d, devices)

  def step_fn(shards: Sequence[Data]) -> list:
    out = []
    for mm, shard, stream in zip(models, shards, streams):
      if stream is None:
        out.append(forward.step(mm, shard))
        continue
      # the chunk was written on the device's current stream
      stream.wait_stream(torch.cuda.current_stream(stream.device))
      with torch.cuda.stream(stream):
        nxt = forward.step(mm, shard)
      torch.cuda.current_stream(stream.device).wait_stream(stream)
      out.append(nxt)
    return out

  return step_fn, shard_data

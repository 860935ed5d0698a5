"""System identification: fit model parameters to observed trajectories
(port of mujoco_tpu/sysid.py: ``get_params`` :45, ``apply_params`` :53,
``simulate`` :66, ``fit`` :77).

    spec = [("dof_damping", None), ("body_mass", [1, 2])]
    result = fit(m, d0, ctrls, observed_qpos, spec)
    m_fit = apply_params(m, spec, result.x)

Each spec entry is (Model leaf name, optional list of flat indices); the
parameter vector concatenates the selected entries. The leaves are those
of ``types.ENV_LEAVES``, which a Model may carry per env: ``fit`` rolls
out k parameter vectors at once as a per-env Model of k envs
(``parallel.rollout.randomize_model``), so its Gauss-Newton Jacobian is
one rollout of n copies, each with one unit direction as a forward-mode
tangent (``minimize.least_squares``). On the card at f64 that rollout
takes the stage path, whose LDL and Newton kernels carry the tangents
through their forward-mode rules; the megastep refuses a tangent or a
per-env Model.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mujoco_tpu_torch.minimize import LeastSquaresResult, least_squares
from mujoco_tpu_torch.models.types import ENV_LEAVES, Data, Model
from mujoco_tpu_torch.ops import forward
from mujoco_tpu_torch.ops.derivative_fd import zero_tangents
from mujoco_tpu_torch.ops.linalg_cuda import has_tangent
from mujoco_tpu_torch.parallel import rollout

ParamSpec = Sequence[Tuple[str, Optional[Sequence[int]]]]


def _indices(m: Model, spec: ParamSpec):
  """(name, flat indices, leaf shape) of each spec entry."""
  out = []
  for name, idx in spec:
    if name not in ENV_LEAVES:
      raise NotImplementedError(
          f"sysid of Model.{name} is not ported: it fits the leaves a "
          f"Model may carry per env, {', '.join(ENV_LEAVES)}")
    shape = tuple(m.leaf(name).shape[m.leaf(name).dim() - ENV_LEAVES[name]:])
    sel = (np.arange(int(np.prod(shape))) if idx is None
           else np.asarray(idx, dtype=np.int64))
    out.append((name, sel, shape))
  return out


def get_params(m: Model, spec: ParamSpec) -> torch.Tensor:
  """The selected entries of a plain Model's leaves as one vector."""
  return torch.cat([m.leaf(name).reshape(-1)[sel]
                    for name, sel, _ in _indices(m, spec)])


def apply_params(m: Model, spec: ParamSpec, x) -> Model:
  """The Model with the parameter vector written into its leaves: x (n,)
  gives a Model whose leaves stay one value for all envs; x (k, n) a
  per-env Model of k envs, row i in env i's leaves."""
  x = torch.as_tensor(x, dtype=m.dtype, device=m.device)
  updates, adr = {}, 0
  for name, sel, shape in _indices(m, spec):
    part = x[..., adr:adr + len(sel)]
    adr += len(sel)
    flat = m.leaf(name).reshape(-1)
    idx = torch.as_tensor(sel, device=flat.device)
    if x.dim() == 1:
      updates[name] = flat.scatter(0, idx, part).reshape(shape)
    else:
      rows = flat.expand(x.shape[0], flat.shape[0])
      updates[name] = rows.scatter(1, idx.expand(x.shape[0], len(sel)),
                                   part).reshape((x.shape[0],) + shape)
  if x.dim() == 1:
    return m.replace_leaves(updates)
  return rollout.randomize_model(m, updates)[0]


def simulate(m: Model, d0: Data, ctrls) -> torch.Tensor:
  """Roll d0 (one env, ``make_data``) through len(ctrls) steps at ctrls
  (nstep, nu), returning the (nstep, nq) qpos trajectory."""
  ctrls = torch.as_tensor(ctrls, dtype=d0.qpos.dtype, device=d0.qpos.device)
  d, traj = d0, []
  for u in ctrls:
    d = forward.step(m, d.replace(ctrl=u[None]))
    traj.append(d.qpos[0])
  return torch.stack(traj)


def residual_fn(m: Model, d0: Data, ctrls, observed_qpos, spec: ParamSpec):
  """The fit's residual, x (k, n) → (k, nstep·nq): the k parameter rows
  rolled out at once as a per-env Model of k envs from d0 repeated along
  the batch, each row's qpos trajectory minus the observed one."""
  dtype, dev = d0.qpos.dtype, d0.qpos.device
  target = torch.as_tensor(observed_qpos, dtype=dtype, device=dev)
  ctrls = torch.as_tensor(ctrls, dtype=dtype, device=dev)

  def residual(x):
    k = x.shape[0]
    mm, d, traj = apply_params(m, spec, x), rollout.expand(d0, k), []
    if has_tangent(x):
      mm, d = zero_tangents(mm), zero_tangents(d)
    for u in ctrls:
      d = forward.step(mm, d.replace(ctrl=u.expand(k, u.shape[0])))
      traj.append(d.qpos)
    return (torch.stack(traj, dim=1) - target).reshape(k, -1)

  return residual


def fit(m: Model, d0: Data, ctrls, observed_qpos, spec: ParamSpec,
        bounds: Optional[tuple] = None, max_iter: int = 30,
        x0=None) -> LeastSquaresResult:
  """Gauss-Newton parameter fit: min ‖simulate(params) − observed‖².

  observed_qpos: (nstep, nq). bounds default to (1e-6, +inf), so physical
  parameters stay positive. Each iteration is one rollout of n dual
  copies (r and J) and one of a single copy at the trial point (its
  cost). Returns the ``minimize.least_squares`` result; pass result.x to
  ``apply_params`` for the fitted Model."""
  residual = residual_fn(m, d0, ctrls, observed_qpos, spec)
  x0 = get_params(m, spec) if x0 is None else torch.as_tensor(
      x0, dtype=m.dtype, device=m.device)
  if bounds is None:
    bounds = (1e-6, float("inf"))
  return least_squares(residual, x0, bounds=bounds, max_iter=max_iter)

"""SDF collision narrowphase: multi-start gradient descent on the combined
signed distance of the two geoms (port of mujoco_tpu/ops/collision_sdf.py:
``_halton`` :37, ``_descent_step`` :50, ``_step_gradient`` :75,
``_corners`` :94 and ``sdf_collision`` :102; MuJoCo's mjc_SDF,
engine_collision_sdf.c:1040).

Each group of ``ContactMeta.sdfgroups`` (a geom pair with an SDF side)
owns n = opt.sdf_initpoints slots, one per descent start: Halton points
of the intersection of the two geoms' bounding boxes. Each start
descends the COLLISION objective A + B + |max(A, B)| for sdf_iterations
steps, takes one step on the INTERSECTION objective max(A, B), whose
value is the contact's depth, and reads the contact normal from the
MIDSURFACE gradient ∇(A − B); A is the SDF geom's (geom2's) distance and
B the other geom's, the points in geom2's frame throughout. A step is the
gradient and a backtracking line search over a fixed schedule of 15
step sizes, the first that meets the decrease test taken (else the
last); a start that fails to improve freezes there, as stepGradient
returns.

The reference maps one start with ``vmap`` per pair; here the envs and
the starts are two tensor dimensions (B, n, ...) and the 15 trial points
a third, so a step is one evaluation of the gradient at (B, n) and one of
the objective at (B, n, 15). On the CPU the descent stops once every
start of every env is frozen (the remaining steps would leave every value
as it is); on the card it runs its full count and reads nothing back.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.ops import sdf
from mujoco_tpu_torch.utils import math as mjm
from mujoco_tpu_torch.utils.device import const

# stepGradient's backtracking (engine_collision_sdf.c:618-624): alpha
# starts at 2 and is halved before each trial, down to 1e-4, so the trial
# alphas are 1, 0.5, ..., 2·0.5^15; c scales the decrease test
_C = 0.1
_NALPHA = 15
_ALPHAS = 2.0 * (0.5 ** np.arange(1, _NALPHA + 1))


def _halton(n, base):
  """The first n Halton points in a base (mju_Halton)."""
  out = np.zeros(n)
  for i in range(n):
    f, r, x = 1.0, 0.0, i
    while x > 0:
      f /= base
      r += f * (x % base)
      x //= base
    out[i] = r
  return out


def _descent_step(x, objective, grad):
  """One stepGradient iteration at points x (B, n, 3): the gradient and
  the backtracking line search. Returns (x_new, its objective, whether it
  improved)."""
  g = grad(x)
  dist0 = objective(x)
  gg = (g * g).sum(-1)
  alphas = const(_ALPHAS, x.device, x.dtype)
  trials = x[..., None, :] - alphas[:, None] * g[..., None, :]
  dists = objective(trials)                                # (B, n, 15)
  ok = (dists - dist0[..., None]) <= -_C * alphas * gg[..., None]
  # the do-while ends at the first step size that passes, or at the last
  # (the first at or below its floor of 1e-4)
  sel = torch.where(ok.any(-1), ok.to(torch.int32).argmax(-1), _NALPHA - 1)
  x_new = torch.gather(trials, -2, sel[..., None, None].expand(
      sel.shape + (1, 3)))[..., 0, :]
  dist_new = torch.gather(dists, -1, sel[..., None])[..., 0]
  return x_new, dist_new, dist_new <= dist0


def _step_gradient(x, objective, grad, niter: int):
  """stepGradient: niter descent steps; a step that fails to improve
  freezes its start at that (worse) trial point with that step's value
  (engine_collision_sdf.c:652-656)."""
  ret, done = None, torch.zeros(x.shape[:-1], dtype=torch.bool,
                                device=x.device)
  for _ in range(niter):
    x_new, dist_new, improved = _descent_step(x, objective, grad)
    if ret is None:
      x, ret = x_new, dist_new
    else:
      x = torch.where(done[..., None], x, x_new)
      ret = torch.where(done, ret, dist_new)
    done = done | ~improved
    if not done.is_cuda and bool(done.all()):
      break
  return x, ret


def _corners(aabb):
  """(8, 3) corners of a (6,) center and half-size box."""
  c, h = aabb[:3], aabb[3:]
  sgn = np.array([[(-1, 1)[(i >> k) & 1] for k in range(3)]
                  for i in range(8)], dtype=np.float64)
  return c[None, :] + sgn * h[None, :]


def _side(m: Model, g: int, kind, params, dev, dtype):
  """(distance, gradient) functions of one geom in its own frame: a
  primitive's from its geom_size row, a plugin shape's or a mesh grid's
  from its static params."""
  p = m.geom_size[g] if params is None else params
  return (sdf.dist_fn(kind, p, dev, dtype), sdf.grad_fn(kind, p, dev, dtype))


def _group(m: Model, d: Data, grp: dict):
  """dist (B, n), pos (B, n, 3) and frame (B, n, 3, 3) of one SDF
  group's slots."""
  from mujoco_tpu_torch.ops.collision_driver import make_frame
  dtype, dev = d.qpos.dtype, d.qpos.device
  g1, g2, n = int(grp["g1"]), int(grp["g2"]), int(grp["n"])
  f1, gr1 = _side(m, g1, grp["kind1"], grp["params1"], dev, dtype)
  f2, gr2 = _side(m, g2, grp["kind2"], grp["params2"], dev, dtype)

  # x lives in g2's frame; y = A x + b maps it to g1's
  r1, r2 = d.geom_xmat[:, g1], d.geom_xmat[:, g2]
  xpos2 = d.geom_xpos[:, g2]
  a = r1.transpose(-1, -2) @ r2
  b = torch.einsum("bji,bj->bi", r1, xpos2 - d.geom_xpos[:, g1])

  # the 3×3 products as the reference's dot rounds them on the CPU, a
  # chain of fused multiply-adds over k = 0, 1, 2 (addcmul fuses), so a
  # start on a corner of a box, where the box's distance and gradient tie,
  # rounds as it does there
  def to1(x):
    s = (slice(None),) + (None,) * (x.dim() - 2)
    col = lambda j: a[:, :, j][s]
    y = torch.addcmul(x[..., :1] * col(0), x[..., 1:2], col(1))
    return torch.addcmul(y, x[..., 2:], col(2)) + b[s]

  def back(gy):
    """A gradient in g1's frame as one in g2's (the chain rule)."""
    s = (slice(None),) + (None,) * (gy.dim() - 2)
    row = lambda i: a[:, i, :][s]
    y = torch.addcmul(gy[..., :1] * row(0), gy[..., 1:2], row(1))
    return torch.addcmul(y, gy[..., 2:], row(2))

  def d_coll(x):
    av, bv = f2(x), f1(to1(x))
    return av + bv + torch.maximum(av, bv).abs()

  def g_coll(x):
    y = to1(x)
    av, bv = f2(x), f1(y)
    ga, gb = gr2(x), back(gr1(y))
    extra = torch.where((av > bv)[..., None], ga, gb)
    sign = torch.where(torch.maximum(av, bv) > 0, 1.0, -1.0)
    return ga + gb + sign[..., None] * extra

  def d_inter(x):
    return torch.maximum(f2(x), f1(to1(x)))

  def g_inter(x):
    y = to1(x)
    return torch.where((f2(x) > f1(y))[..., None], gr2(x), back(gr1(y)))

  def g_mid(x):
    n2 = mjm.normalize(gr2(x))
    n1 = mjm.normalize(back(gr1(to1(x))))
    return mjm.normalize(n2 - n1)

  # starts: Halton points of the boxes' intersection in g1's frame
  # (engine_collision_sdf.c:1069-1141), mapped to g2's frame
  c1 = const(_corners(grp["aabb1"]), dev, dtype)
  c2 = torch.einsum("bij,kj->bki", a, const(_corners(grp["aabb2"]), dev,
                                             dtype)) + b[:, None]
  lo = torch.maximum(c1.amin(0), c2.amin(1))
  hi = torch.minimum(c1.amax(0), c2.amax(1))
  degenerate = (hi < lo).any(-1)
  h = const(np.stack([_halton(n, 2), _halton(n, 3), _halton(n, 5)], 1),
            dev, dtype)
  starts = back(lo[:, None] + (hi - lo)[:, None] * h - b[:, None])

  xs, _ = _step_gradient(starts, d_coll, g_coll, int(grp["iterations"]))
  xs, dds = _step_gradient(xs, d_inter, g_inter, 1)
  nrms = g_mid(xs)
  # stepGradient's sanity check returns mjMAXVAL: a start that is not
  # finite is parked far away, its normal +z
  bad = ~(torch.isfinite(xs).all(-1) & torch.isfinite(dds)
          & torch.isfinite(nrms).all(-1))
  xs = torch.where(bad[..., None], 0.0, xs)
  nrms = torch.where(bad[..., None], const(np.array([0.0, 0.0, 1.0]), dev,
                                           dtype), nrms)
  dds = torch.where(bad, 1e10, dds)
  # boxes that do not overlap: no contact this step (the early return)
  dds = torch.where(degenerate[:, None], 1e10, dds)
  # a start that converged onto an earlier one's point is dropped
  # (isknown, engine_collision_sdf.c:532)
  diff = ((xs[:, :, None, :] - xs[:, None, :, :]) ** 2).sum(-1)
  earlier = const(np.tril(np.ones((n, n), dtype=bool), -1), dev)
  dup = ((diff < mjm.MINVAL ** 2) & earlier).any(-1)
  dds = torch.where(dup, 1e10, dds)
  # a degenerate normal is skipped (addPreContact)
  dds = torch.where(mjm.norm_safe(nrms) < mjm.MINVAL, 1e10, dds)

  # world contacts, the normal into the SDF geom
  nrm_w = -torch.einsum("bij,bpj->bpi", r2, nrms)
  pos_w = (torch.einsum("bij,bpj->bpi", r2, xs) + xpos2[:, None]
           - 0.5 * dds[..., None] * nrm_w)
  return dds, pos_w, make_frame(nrm_w, torch.zeros_like(nrm_w))


def sdf_collision(m: Model, d: Data, dist, pos, frame):
  """Fill the SDF groups' slots of dist (B, ncon), pos (B, ncon, 3) and
  frame (B, ncon, 3, 3) in place."""
  for grp in m.con.sdfgroups:
    sl = slice(int(grp["adr"]), int(grp["adr"]) + int(grp["n"]))
    dist[:, sl], pos[:, sl], frame[:, sl] = _group(m, d, grp)
  return dist, pos, frame

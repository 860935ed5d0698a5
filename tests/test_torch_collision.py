"""The megastep model class on the port's stage path, at f64 on CPU.

The five primitive colliders the megastep class adds (plane-box,
sphere-sphere, sphere-capsule, sphere-box, capsule-capsule) agree with
mujoco_tpu's on random poses, including a sphere deep inside a box and
parallel capsules, to 1e-12; Euler with implicit joint damping agrees with
mujoco_tpu's ``forward.euler`` on the ``mixed`` scene; and a whole
``forward.step`` agrees with jax.jit(jax.vmap(mujoco_tpu step)) on the
quadruped, ``mixed`` and ``spherebox`` scenes posed in contact, to 1e-9 on
every field the port's Data carries. The four model snapshots match a fresh
compile (tests/test_torch_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import collision_primitive as j_cp
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot
from mujoco_tpu_torch.ops import collision_primitive as t_cp
from mujoco_tpu_torch.ops import forward as t_fwd

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

NPAIR = 64


def _rotations(rng, n):
  q = rng.standard_normal((n, 4))
  q /= np.linalg.norm(q, axis=1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
      2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
      2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                  axis=-1).reshape(n, 3, 3)


def _poses(name, rng):
  """(p1, m1, s1, p2, m2, s2) for NPAIR random pairs of one collider, with
  the degenerate cases the collider branches on mixed in."""
  n = NPAIR
  p1 = rng.uniform(-0.2, 0.2, (n, 3))
  p2 = rng.uniform(-0.2, 0.2, (n, 3))
  m1, m2 = _rotations(rng, n), _rotations(rng, n)
  s1 = np.concatenate([rng.uniform(0.03, 0.12, (n, 1)),
                       rng.uniform(0.05, 0.2, (n, 2))], axis=1)
  s2 = np.concatenate([rng.uniform(0.03, 0.12, (n, 1)),
                       rng.uniform(0.05, 0.2, (n, 2))], axis=1)
  if name == "sphere_box":
    # a third of the sphere centers deep inside the box
    inside = p2[: n // 3] + 0.3 * (m2[: n // 3] @ (
        s2[: n // 3] * rng.uniform(-1, 1, (n // 3, 3)))[..., None])[..., 0]
    p1[: n // 3] = inside
  if name == "capsule_capsule":
    # a third exactly parallel (same or flipped axis): the 2-contact branch
    k = n // 3
    m2[:k] = m1[:k]
    m2[k // 2:k, :, 1:] *= -1.0
    p2[:k] = p1[:k] + 0.6 * (s1[:k, :1] + s2[:k, :1]) * m1[:k, :, 0]
  if name == "sphere_sphere":
    p2[:4] = p1[:4]                      # coincident centers
  return p1, m1, s1, p2, m2, s2


@pytest.mark.parametrize("name", ["plane_box", "sphere_sphere",
                                  "sphere_capsule", "sphere_box",
                                  "capsule_capsule"])
def test_primitive_matches_reference(name):
  args = _poses(name, np.random.default_rng(sum(map(ord, name))))
  ref = jax.vmap(getattr(j_cp, name))(*[jnp.asarray(a) for a in args])
  out = getattr(t_cp, name)(*[torch.from_numpy(a) for a in args])
  assert len(out) == 4
  for what, a, b in zip(("dist", "pos", "normal", "tangent"), ref, out):
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12,
                               atol=1e-12, err_msg=f"{name} {what}")
  if name == "capsule_capsule":
    # the parallel third emits two touching contacts for some pairs
    assert (out[0][: NPAIR // 3, 1] < 0).any()
  if name == "sphere_box":
    assert (out[0][: NPAIR // 3, 0] < -0.03).all()


@pytest.fixture(scope="module")
def models():
  out = {}
  for name in ("quadruped", "mixed", "spherebox"):
    mjm = snapshot.compile_mj(name)
    out[name] = (jio.put_model(mjm),
                 tio.put_model(mjm, dtype=torch.float64, device="cpu"))
  return out


def _free_joints(jm):
  return [int(jm.jnt_qposadr[j]) for j in range(jm.njnt)
          if int(jm.jnt_type[j]) == 0]


def posed_batch(jm, name, nbatch, seed):
  """A reference batch posed in contact: every free body dropped to a
  random pose low over the floor and close to the others, hinge and slide
  joints and velocities perturbed, random controls."""
  rng = np.random.default_rng(seed)
  d = j_roll.make_batch(jm, nbatch)
  qpos = np.array(d.qpos)
  qpos += 0.05 * rng.standard_normal(qpos.shape)
  for qa in _free_joints(jm):
    lo, hi = (0.12, 0.5) if name == "quadruped" else (0.03, 0.3)
    qpos[:, qa:qa + 2] = rng.uniform(-0.12, 0.12, (nbatch, 2))
    qpos[:, qa + 2] = rng.uniform(lo, hi, nbatch)
    quat = rng.standard_normal((nbatch, 4))
    quat[:, 0] += 2.0 if name == "quadruped" else 0.0
    qpos[:, qa + 3:qa + 7] = quat / np.linalg.norm(quat, axis=1,
                                                   keepdims=True)
  qvel = 0.3 * rng.standard_normal(np.shape(d.qvel))
  ctrl = rng.uniform(-1.2, 1.2, np.shape(d.ctrl))
  return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                   ctrl=jnp.asarray(ctrl))


@pytest.mark.parametrize("name", ["quadruped", "mixed", "spherebox"])
def test_step_matches_reference(models, name):
  jm, tm = models[name]
  jd = posed_batch(jm, name, 6, 11)
  ref = tio.flatten(jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))(jd))
  out = tio.flatten(t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd))))
  assert np.asarray(out["efc_active"])[:, tm.efc.nl:].any()
  for k, v in out.items():
    a = np.asarray(ref[k])
    assert a.shape == v.shape, k
    if v.dtype.kind in "biu":
      np.testing.assert_array_equal(v, a, err_msg=k)
    else:
      np.testing.assert_allclose(v, a, rtol=1e-9, atol=1e-9, err_msg=k)


def test_eulerdamp_matches_reference(models):
  jm, tm = models["mixed"]
  assert tm.has_dof_damping and not tm.disabled(0x8000)
  jd = jax.jit(jax.vmap(lambda d: j_fwd.forward(jm, d)))(
      posed_batch(jm, "mixed", 5, 3))
  ref = jax.vmap(lambda d: j_fwd.euler(jm, d))(jd)
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  out = t_fwd.euler(tm, td)
  undamped = td.qvel + tm.opt.timestep * td.qacc
  assert (out.qvel - undamped).abs().max() > 1e-6
  np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                             rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                             rtol=1e-10, atol=1e-10)
  np.testing.assert_array_equal(out.qacc_warmstart.numpy(),
                                np.asarray(ref.qacc_warmstart))

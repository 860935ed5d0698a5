"""The SDF narrowphase and the SDF scenes' steps against mujoco_tpu's, at
f64 on the CPU.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_sdf_scenes.py -q

Each scene of ``zoo.SDF`` (``sdf_nutbolt`` and the reference's scenes of
tests/test_sdf.py) from a start in contact (``zoo.SDF_START``, moved by a
seed), B 16, 10 steps, each step of the reference's state through both
packages: the SDF slots' dist and the contact positions of the slots it
keeps within 1e-10, the frames within 1e-9, qacc within 1e-8. The descent
picks a step size by comparing objective values, so an env may be
decided by the last bit: the first Halton start of a box's pair sits on
the box's corner, where its distance and gradient field tie, and a
gradient there as small as the rounding of the frame map steers the
descent (``box_on_nut`` misses in about a quarter of its env-steps; the
reference's XLA rounds its 3×3 products in an order of fused
multiply-adds that varies with the product's shape). An env that misses
passes only if the reference, rerun on 32 copies of its state moved at
the last bits, gives the port's result on one copy or moves as far
itself, or the port rerun on the same copies accounts for the
reference's result likewise (``explained``), as tests/test_torch_
collision_scenes.py and chip_smoke.judge_envs judge such envs. The moves
are 1e-15 relative in qpos and qvel, then, where those leave the
deciding bits of the corner start alone, 1e-14, 1e-13 and 1e-12: still
two orders below the tolerances, so a copy that hits is a state the
comparison cannot tell from the env's own. The port's f32 collision
keeps the slots its f64 collision keeps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import forward as j_fwd
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import snapshot, zoo
from mujoco_tpu_torch.models.types import GeomType
from mujoco_tpu_torch.ops import collision_driver, smooth
from mujoco_tpu_torch.ops import forward as t_fwd
from tests.test_torch_sdf import sdf_batch

# one intra-op thread per process (tests/test_torch_tendon.py)
torch.set_num_threads(1)

NBATCH = 16
NSTEP = 10
COPIES = 32
MOVES = (1e-15, 1e-14, 1e-13, 1e-12)
TOL = {"dist": 1e-10, "pos": 1e-10, "frame": 1e-9, "qacc": 1e-8}

# each scene's MjModel, compiled once for this file's two tests (a mesh
# SDF's compile takes seconds); the tests only read it
compile_mj = functools.lru_cache(maxsize=None)(snapshot.compile_mj)


def outputs(contact_dist, contact_pos, contact_frame, qacc, slots):
  """The compared outputs per env as float64 numpy: the SDF slots' dist,
  pos where the slot is kept (a parked slot's position lies 5e9 away),
  frame, and qacc."""
  dist = np.asarray(contact_dist, np.float64)[:, slots]
  kept = dist < 1e9
  pos = np.where(kept[..., None], np.asarray(contact_pos)[:, slots], 0.0)
  return {"dist": dist, "pos": pos,
          "frame": np.asarray(contact_frame)[:, slots],
          "qacc": np.asarray(qacc, np.float64)}


def misses(a: dict, b: dict) -> np.ndarray:
  """(B,) envs where a and b differ beyond TOL."""
  bad = np.zeros(a["qacc"].shape[0], dtype=bool)
  for k, tol in TOL.items():
    d = np.abs(a[k] - b[k]).reshape(len(bad), -1)
    bad |= (d > tol).any(1)
  return bad


def explained(port: dict, ref: dict, copies: dict) -> bool:
  """Whether the copies (the reference rerun on last-bit copies of one
  env) account for the port's result: one copy within TOL of it, or the
  port within the copies' own spread around the reference (plus TOL)."""
  hit = ~misses({k: np.broadcast_to(v, copies[k].shape)
                 for k, v in port.items()}, copies)
  within = all(
      np.abs(port[k] - ref[k]).max()
      <= np.abs(copies[k] - ref[k]).max() + tol for k, tol in TOL.items())
  return bool(hit.any() or within)


def moved_copies(jd, e, scale, gen):
  """COPIES copies of env e of jd, qpos and qvel moved by scale·N(0, 1)
  relative, as numpy (the per-field copies cost no JAX dispatch)."""
  env = jax.tree.map(lambda x: np.repeat(np.asarray(x)[e:e + 1], COPIES, 0),
                     jd)
  move = lambda x: x * (1 + scale * gen.standard_normal(x.shape))
  return env.replace(qpos=move(env.qpos), qvel=move(env.qvel))


def ref_copies(jstep, env, slots):
  """The outputs of the reference's step on the copies."""
  ref = [jstep(jax.tree.map(lambda x: jnp.asarray(x[i:i + NBATCH]), env))
         for i in range(0, COPIES, NBATCH)]
  return outputs(*[np.concatenate([np.asarray(x) for x in xs])
                   for xs in zip(*[(c.contact.dist, c.contact.pos,
                                    c.contact.frame, c.qacc) for c in ref])],
                 slots)


def port_copies(tm, env, slots):
  """The outputs of the port's step on the copies."""
  cp = t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(env)))
  return outputs(cp.contact.dist.numpy(), cp.contact.pos.numpy(),
                 cp.contact.frame.numpy(), cp.qacc.numpy(), slots)


@pytest.mark.parametrize("name", zoo.SDF)
def test_sdf_scene_matches_reference(name):
  mjm = compile_mj(name)
  jm = jio.put_model(mjm)
  tm = zoo.load(name, torch.float64, "cpu")
  slots = np.concatenate([np.arange(g["adr"], g["adr"] + g["n"])
                          for g in tm.con.sdfgroups])
  qpos, qvel, ctrl = sdf_batch(name, mjm, NBATCH, 11)
  jd = jax.vmap(lambda q, v, c: jio.make_data(jm).replace(
      qpos=q, qvel=v, ctrl=c))(jnp.asarray(qpos), jnp.asarray(qvel),
                               jnp.asarray(ctrl))
  jstep = jax.jit(jax.vmap(lambda d: j_fwd.step(jm, d)))
  gen = np.random.default_rng(12)
  judged = live = 0
  for _ in range(NSTEP):
    ref_d = jstep(jd)
    got_d = t_fwd.step(tm, tio.data_from_numpy(tm, tio.flatten(jd)))
    ref = outputs(ref_d.contact.dist, ref_d.contact.pos,
                  ref_d.contact.frame, ref_d.qacc, slots)
    got = outputs(got_d.contact.dist.numpy(), got_d.contact.pos.numpy(),
                  got_d.contact.frame.numpy(), got_d.qacc.numpy(), slots)
    live += int((ref["dist"] < 0).sum())
    one = lambda o, e: {k: v[e] for k, v in o.items()}
    for e in np.nonzero(misses(got, ref))[0]:
      judged += 1
      for scale in MOVES:
        # the port's copies are stepped only where the reference's do not
        # account for the env
        env = moved_copies(jd, e, scale, gen)
        if (explained(one(got, e), one(ref, e), ref_copies(jstep, env, slots))
            or explained(one(ref, e), one(got, e),
                         port_copies(tm, env, slots))):
          break
      else:
        raise AssertionError(f"{name}: env {e} differs beyond both sides' "
                             f"last-bit spread")
    jd = ref_d
  # every scene's SDF slots make contacts over the run
  assert live > NBATCH * NSTEP, live
  assert judged <= NBATCH * NSTEP // 2, judged


@pytest.mark.parametrize("name", zoo.SDF)
def test_f32_keeps_the_slots_of_f64(name):
  """The port's collision at f32 and f64 from the same start (B 16): the
  same slots kept (the NaN parking, the degenerate boxes, the MINVAL²
  duplicate test and the degenerate normals decide alike) and the same
  slots in contact, but a box pair's first slot, which its corner tie
  decides."""
  mjm = compile_mj(name)
  qpos = sdf_batch(name, mjm, NBATCH, 13)[0]
  dist = {}
  for dtype in (torch.float64, torch.float32):
    m = zoo.load(name, dtype, "cpu")
    d = tio.make_data(m, device="cpu")
    d = d.replace(qpos=torch.as_tensor(qpos, dtype=dtype),
                  qvel=d.qvel.expand(NBATCH, -1))
    d = collision_driver.collision(m, smooth.kinematics(m, d))
    dist[dtype] = d.contact.dist.double().numpy()
  a, b = dist[torch.float64], dist[torch.float32]
  np.testing.assert_array_equal(a < 1e9, b < 1e9)
  # a box pair's first start sits on the box's corner, where the descent
  # follows a gradient as small as the precision's rounding (above)
  tie = [g["adr"] for g in m.con.sdfgroups if GeomType.BOX in (
      g["kind1"], g["kind2"])]
  same = (a < 0) == (b < 0)
  same[:, tie] = True
  assert same.all(), (a[~same], b[~same])

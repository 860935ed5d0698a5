"""The port's smooth stages against mujoco_tpu's, at f64 on CPU.

The same randomized humanoid batch (qpos, qvel and ctrl from a numpy seed)
goes through jax.vmap of each mujoco_tpu stage and through the port's
batched stage; every field the stage writes agrees to rtol/atol 1e-10
(quaternions up to sign).
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_tpu.models import io as jio
from mujoco_tpu.ops import actuation as j_act
from mujoco_tpu.ops import passive as j_passive
from mujoco_tpu.ops import smooth as j_smooth
from mujoco_tpu.parallel import rollout as j_roll
from mujoco_tpu_torch.models import io as tio
from mujoco_tpu_torch.models import zoo
from mujoco_tpu_torch.ops import actuation as t_act
from mujoco_tpu_torch.ops import passive as t_passive
from mujoco_tpu_torch.ops import smooth as t_smooth

# one intra-op thread per process: pytest runs several workers on a
# few cores, and each worker's idle OpenMP threads would spin against
# the others' (the tensors here are too small to gain from threads)
torch.set_num_threads(1)

NBATCH = 3

# stage name → the Data fields it writes
STAGES = {
    "kinematics": ("qpos", "xpos", "xquat", "xmat", "xipos", "ximat",
                   "xanchor", "xaxis", "geom_xpos", "geom_xmat"),
    "com_pos": ("subtree_com", "cinert", "cdof"),
    "crb": ("crb", "qM"),
    "transmission": ("actuator_length", "actuator_moment"),
    "com_vel": ("cvel", "cdof_dot"),
    "passive": ("qfrc_spring", "qfrc_damper", "qfrc_gravcomp",
                "qfrc_passive"),
    "rne": ("qfrc_bias",),
    "fwd_actuation": ("actuator_force", "qfrc_actuator"),
}


def _jax_chain(m):
  def chain(d):
    out = {}
    d = j_smooth.kinematics(m, d); out["kinematics"] = d
    d = j_smooth.com_pos(m, d); out["com_pos"] = d
    d = j_smooth.crb(m, d); out["crb"] = d
    d = j_smooth.transmission(m, d); out["transmission"] = d
    d = d.replace(actuator_velocity=d.actuator_moment @ d.qvel)
    d = j_smooth.com_vel(m, d); out["com_vel"] = d
    d = j_passive.passive(m, d); out["passive"] = d
    d = d.replace(qfrc_bias=j_smooth.rne(m, d)); out["rne"] = d
    d = j_act.fwd_actuation(m, d); out["fwd_actuation"] = d
    return out
  return jax.jit(jax.vmap(chain))


def _port_chain(m, d):
  out = {}
  d = t_smooth.kinematics(m, d); out["kinematics"] = d
  d = t_smooth.com_pos(m, d); out["com_pos"] = d
  d = t_smooth.crb(m, d); out["crb"] = d
  d = t_smooth.transmission(m, d); out["transmission"] = d
  d = d.replace(actuator_velocity=(d.actuator_moment
                                   @ d.qvel[..., None])[..., 0])
  d = t_smooth.com_vel(m, d); out["com_vel"] = d
  d = t_passive.passive(m, d); out["passive"] = d
  d = d.replace(qfrc_bias=t_smooth.rne(m, d)); out["rne"] = d
  d = t_act.fwd_actuation(m, d); out["fwd_actuation"] = d
  return out


@pytest.fixture(scope="module")
def chains():
  mjm = mujoco.MjModel.from_xml_path(f"{zoo.XML_DIR}/humanoid.xml")
  jm = jio.put_model(mjm)
  tm = tio.put_model(mjm, dtype=torch.float64, device="cpu")
  rng = np.random.default_rng(7)
  jd = j_roll.make_batch(jm, NBATCH)
  jd = jd.replace(
      qpos=jnp.asarray(np.asarray(jd.qpos)
                       + 0.2 * rng.standard_normal(jd.qpos.shape)),
      qvel=jnp.asarray(rng.standard_normal(jd.qvel.shape)),
      ctrl=jnp.asarray(rng.uniform(-1.2, 1.2, jd.ctrl.shape)))
  td = tio.data_from_numpy(tm, tio.flatten(jd))
  return _jax_chain(jm)(jd), _port_chain(tm, td)


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_matches_reference(chains, stage):
  ref, port = chains
  for name in STAGES[stage]:
    a = np.asarray(getattr(ref[stage], name))
    b = getattr(port[stage], name).numpy()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if name == "xquat":
      # quaternions agree up to sign
      sign = np.where(np.sum(a * b, axis=-1, keepdims=True) < 0, -1.0, 1.0)
      b = b * sign
    np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10, err_msg=name)

"""System identification: recover a joint's damping from a trajectory by
Gauss-Newton through the physics, the Jacobian by forward-mode
differentiation of the rollout (the port of examples/sysid_fit.py). The
XML compiles with the port's own compiler, with no pip ``mujoco``.

Run:  python examples_torch/sysid_fit.py                 (the CUDA card)
      EX_DEVICE=cpu python examples_torch/sysid_fit.py
EX_NSTEP sets the trajectory's length (150 steps).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mujoco_tpu_torch import compiler, sysid  # noqa: E402
from mujoco_tpu_torch.models import io  # noqa: E402

DEVICE = os.environ.get("EX_DEVICE") or None
NSTEP = int(os.environ.get("EX_NSTEP", "150"))

XML = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j" type="hinge" axis="0 1 0" damping="0.27"/>
      <geom type="capsule" size="0.04" fromto="0 0 0 0.4 0 0"/>
    </body>
  </worldbody>
  <actuator><motor joint="j" gear="2"/></actuator>
</mujoco>"""

m = io.put_model(compiler.load_xml(XML, device=DEVICE), dtype=torch.float64,
                 device=DEVICE)
d0 = io.make_data(m, device=DEVICE)
ctrls = 0.4 * np.sin(0.1 * np.arange(NSTEP))[:, None]
observed = sysid.simulate(m, d0, ctrls)        # the "measurement"

spec = [("dof_damping", None)]
m_wrong = sysid.apply_params(m, spec, np.array([1.0]))
res = sysid.fit(m_wrong, d0, ctrls, observed, spec)
print(f"true damping 0.27, recovered {float(res.x[0]):.6f} "
      f"(cost {float(res.cost):.2e})")

"""Native MJCF model compiler (the reference's src/user + src/xml layer),
numpy on the host, with the qpos0-derived constants (mj_setConst) computed
by this package's own engine on a device.

Counterpart of mj_loadXML → mjCModel::Compile (src/xml/xml_api.cc:40,
src/user/user_model.cc:4862): parses MJCF, resolves default classes,
computes inertias and addressing, and derives the qpos0-dependent
constants (``setconst.set_const``, engine_setconst.c) with the port's
kinematics, mass matrix, factor and solves; the muscles' length-range
simulation runs the port's forward pass, the LDL kernel and, where a limit
acts, the Newton kernel. Nothing here imports ``mujoco``, so an XML
compiles on a machine without it.

Public API:
  load_xml(xml, device=None)       -> CompiledModel  (attribute-compatible
                                      with the subset of mujoco.MjModel
                                      that io.put_model consumes)
  load_xml_path(path, device=None) -> CompiledModel
  compile_spec(spec, device=None)  -> CompiledModel

``device`` is where set_const runs: the CUDA card when None, which raises
where there is none; ``device="cpu"`` runs it on the host.
"""

from mujoco_tpu_torch.compiler.core import (CompiledModel, compile_spec, load_xml, load_xml_path)
from mujoco_tpu_torch.compiler.spec_api import MjSpec, MjsElement
from mujoco_tpu_torch.compiler.urdf import load_urdf, load_urdf_path
from mujoco_tpu_torch.compiler.serialize import load_model, save_model
from mujoco_tpu_torch.compiler.mjz import load_cached, load_mjz

__all__ = ["CompiledModel", "compile_spec", "load_xml", "load_xml_path", "MjSpec", "MjsElement", "load_urdf", "load_urdf_path", "save_model", "load_model", "load_mjz", "load_cached"]

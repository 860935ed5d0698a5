"""FLEXSTRAIN equalities on a compiled model (port of
mujoco_tpu/models/strain.py).

MuJoCo 3.11's compiler turns ``<flexcomp dof="trilinear|quadratic"> <edge
equality="strain"/>`` into one FLEXSTRAIN equality per cell and stores
each cell's stiffness in eigen form, [neig | √λ₁·v₁ | √λ₂·v₂ …] per ndof²
block, at young 10 and poisson 0.3 (EigendecomposeStiffness,
user_mesh.cc:4127-4167; user_flexcomp.cc:760-805). The pip compiler
(3.10) predates it, so ``with_strain_constraints`` makes that change on a
pip-compiled model::

    mjm = mujoco.MjModel.from_xml_string(xml)   # <elasticity poisson=.3>
    m = io.put_model(strain.with_strain_constraints(mjm))

The flex must be interpolated and compiled at poisson 0.3 (the
eigenvectors depend on it); the √λ scale is brought to young 10, as K is
linear in young. The shell (elastic2d) strain mode is not implemented.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

_STRAIN_YOUNG = 10.0
_STRAIN_POISSON = 0.3
_FLEXSTRAIN = 6     # mjEQ_FLEXSTRAIN


class StrainModel:
  """A compiled model with the FLEXSTRAIN fields replaced; every other
  attribute reads through to ``mjmodel``."""

  def __init__(self, mjmodel: Any, overrides: dict):
    self.mjmodel = mjmodel
    self._overrides = overrides

  def __getattr__(self, name):
    ov = self.__dict__.get("_overrides", {})
    if name in ov:
      return ov[name]
    return getattr(self.__dict__["mjmodel"], name)


def _eigendecompose(block: np.ndarray, ndof: int) -> np.ndarray:
  """EigendecomposeStiffness (user_mesh.cc:4135): the block holds
  −K_physical; returns [neig | √λ·vᵀ …] in an ndof² buffer, the modes
  above 1e-8 of the largest eigenvalue in ascending order of the stored
  eigenvalues."""
  k = block.reshape(ndof, ndof)
  eigval, eigvec = np.linalg.eigh(0.5 * (k + k.T))
  lam = -eigval
  threshold = np.abs(eigval).max() * 1e-8
  out = np.zeros(ndof * ndof)
  neig = 0
  for i in range(ndof):
    if lam[i] > threshold:
      out[1 + neig * ndof:1 + (neig + 1) * ndof] = np.sqrt(lam[i]) * eigvec[
          :, i]
      neig += 1
  out[0] = float(neig)
  return out


def with_strain_constraints(mjm: Any,
                            flexes: Optional[Sequence[int]] = None):
  """A view of mjm with per-cell FLEXSTRAIN equalities in place of the
  FEM elasticity of the given interpolated flexes (default: each
  interpolated flex with a stiffness table)."""
  nflex = int(mjm.nflex)
  interp = np.asarray(mjm.flex_interp, dtype=int)
  stiffadr = np.asarray(mjm.flex_stiffnessadr, dtype=np.int64)
  if flexes is None:
    flexes = [f for f in range(nflex) if interp[f] >= 1 and stiffadr[f] >= 0]
  if not flexes:
    raise ValueError("no interpolated flexes with stiffness tables")
  stiff = np.array(mjm.flex_stiffness, dtype=np.float64, copy=True)
  cellnum = np.asarray(mjm.flex_cellnum).reshape(nflex, 3).astype(int)
  edgeeq = np.array(mjm.flex_edgeequality, dtype=np.int32, copy=True)
  young = getattr(mjm, "flex_young", None)
  poisson = getattr(mjm, "flex_poisson", None)

  new_eq = []                   # (flex, cell coordinates)
  for f in flexes:
    if interp[f] < 1:
      raise ValueError(f"flex {f} is not interpolated")
    ndof = 3 * (int(interp[f]) + 1) ** 3
    _, cy, cz = (int(x) for x in cellnum[f])
    if young is not None and np.size(young):
      scale = _STRAIN_YOUNG / float(np.asarray(young)[f])
      if (poisson is not None and np.size(poisson) and
          abs(float(np.asarray(poisson)[f]) - _STRAIN_POISSON) > 1e-12):
        raise ValueError(f"flex {f}: strain constraints need poisson = "
                         f"{_STRAIN_POISSON}")
    else:
      # pip 3.10 has no flex_young: compile with young 10, poisson 0.3
      scale = 1.0
    for fe in range(int(np.prod(cellnum[f]))):
      a = stiffadr[f] + fe * ndof * ndof
      block = stiff[a:a + ndof * ndof]
      if not block.any():
        continue                # an empty cell
      eig = _eigendecompose(block * scale, ndof)
      stiff[a:a + ndof * ndof] = eig
      if int(eig[0]):
        new_eq.append((f, (float(fe // (cy * cz)), float((fe // cz) % cy),
                           float(fe % cz))))
    edgeeq[f] = 3

  neq0, n = int(mjm.neq), len(new_eq)
  ndata = np.asarray(mjm.eq_data).reshape(neq0, -1).shape[1] if neq0 else 11
  data = np.zeros((n, ndata))
  for k, (_, cell) in enumerate(new_eq):
    data[k, :3] = cell
  cat = lambda old, new, dtype, shape: np.concatenate(
      [np.asarray(old, dtype=dtype).reshape((neq0,) + shape),
       np.asarray(new, dtype=dtype).reshape((n,) + shape)])
  return StrainModel(mjm, {
      "neq": neq0 + n,
      "eq_type": cat(mjm.eq_type, np.full(n, _FLEXSTRAIN), np.int32, ()),
      "eq_obj1id": cat(mjm.eq_obj1id, [f for f, _ in new_eq], np.int32, ()),
      "eq_obj2id": cat(mjm.eq_obj2id, np.full(n, -1), np.int32, ()),
      "eq_objtype": cat(mjm.eq_objtype, np.zeros(n), np.int32, ()),
      "eq_data": cat(mjm.eq_data, data, np.float64, (ndata,)),
      "eq_active0": cat(mjm.eq_active0, np.ones(n), np.int32, ()),
      "eq_solref": cat(mjm.eq_solref, np.tile([0.02, 1.0], (n, 1)),
                       np.float64, (2,)),
      "eq_solimp": cat(mjm.eq_solimp,
                       np.tile([0.9, 0.95, 0.001, 0.5, 2.0], (n, 1)),
                       np.float64, (5,)),
      "flex_stiffness": stiff, "flex_edgeequality": edgeeq})

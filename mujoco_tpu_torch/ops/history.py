"""Ctrl and sensor history ring buffers (port of mujoco_tpu/ops/history.py:
``_find_index`` :41, ``insert`` :52, ``read`` :105, ``read_ctrl`` :155,
``read_sensor`` :169, ``init_ctrl_history`` :185, ``init_sensor_history``
:197 and ``_init_buf`` :210).

A buffer is laid out in Data.history as the reference lays it out, [user,
cursor, times(n), values(n·dim)], with the same cursor moves, so the two
packages' buffers agree word for word. The reference inserts into and reads
from one buffer at a time, a loop over actuators and sensors; here the
buffers of a Model are grouped once by (nsample, dim, interp) and each
group is one gather of its (B, G, 2 + n + n·dim) block, the arithmetic over
all its buffers and envs at once, and one write back (``Group``,
``insert_group``, ``read_group``). Each env has its own time, so a query
time is (B, G).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_tpu_torch.models.types import Data, Model
from mujoco_tpu_torch.utils.device import index
from mujoco_tpu_torch.utils.math import MINVAL
from mujoco_tpu_torch.utils.struct import cached


@dataclasses.dataclass(frozen=True)
class Group:
  """Buffers of equal (n, dim, interp): their owners (actuator or sensor
  ids), addresses in Data.history and the (G, 2 + n + n·dim) table of
  each buffer's words."""
  n: int
  dim: int
  interp: int
  ids: np.ndarray
  adr: np.ndarray
  words: np.ndarray


def groups(adr: np.ndarray, hist: np.ndarray, dims: np.ndarray,
           ids: np.ndarray) -> list:
  """The buffers of objects ``ids`` (each with [nsample, interp] in
  ``hist`` and width ``dims``, its buffer at ``adr``) grouped by (n, dim,
  interp), in a fixed order."""
  keyed = {}
  for i in ids:
    i = int(i)
    key = (int(hist[i, 0]), int(dims[i]), int(hist[i, 1]))
    keyed.setdefault(key, []).append(i)
  out = []
  for (n, dim, interp), members in sorted(keyed.items()):
    members = np.array(members, dtype=np.int64)
    a = np.asarray(adr)[members].astype(np.int64)
    out.append(Group(n, dim, interp, members, a,
                     a[:, None] + np.arange(2 + n + n * dim)))
  return out


def _views(block, n: int, dim: int):
  """(user, cursor, times, values) of a (B, G, L) block: (B, G), (B, G)
  int64, (B, G, n), (B, G, n, dim)."""
  times = block[..., 2:2 + n]
  values = block[..., 2 + n:].reshape(block.shape[:-1] + (n, dim))
  return block[..., 0], block[..., 1].round().long(), times, values


def _logical(cursor, n: int):
  """Physical slot of each logical sample (oldest first): (B, G, n)."""
  ar = torch.arange(n, device=cursor.device)
  return (cursor[..., None] + 1 + ar) % n


def _ordered(times, values, logical):
  lt = torch.gather(times, -1, logical)
  lv = torch.gather(values, -2, logical[..., None].expand(values.shape))
  return lt, lv


def _find_index(lt, t):
  """Smallest logical i with lt[i] ≥ t; 0 if t ≤ the oldest, n if t is
  past the newest (historyFindIndex)."""
  n = lt.shape[-1]
  ge = lt >= t[..., None]
  first = ge.to(torch.int8).argmax(-1)
  i = torch.where(ge.any(-1), first, n)
  return torch.where(t <= lt[..., 0], 0, i)


def _take(x, i):
  """x[..., i] for a (B, G) index i over x's last dim (n)."""
  return torch.gather(x, -1, i[..., None])[..., 0]


def _take_row(x, i):
  """x[..., i, :] for a (B, G) index i over x's (n, dim)."""
  idx = i[..., None, None].expand(i.shape + (1, x.shape[-1]))
  return torch.gather(x, -2, idx)[..., 0, :]


def insert_block(block, n: int, dim: int, t, value):
  """The block with ``value`` (B, G, dim) inserted at time t (B, G),
  dropping the oldest sample (mju_historyInsert): an exact time match
  overwrites, a time older than the oldest replaces it, a time past the
  newest advances the cursor, and any other shifts the older samples
  down. The four cases are computed for every buffer and selected."""
  user, cursor, times, values = _views(block, n, dim)
  value = value.to(values.dtype)
  logical = _logical(cursor, n)
  lt, lv = _ordered(times, values, logical)
  i = _find_index(lt, t)
  i_idx = i.clamp(0, n - 1)
  exact = (i < n) & ((t - _take(lt, i_idx)).abs() < MINVAL)
  app_cursor = (cursor + 1) % n
  ar = torch.arange(n, device=block.device)
  nxt = (ar + 1).clamp(max=n - 1)
  below = ar < (i - 1)[..., None]
  at = ar == (i - 1)[..., None]
  shift_lt = torch.where(below, lt[..., nxt],
                         torch.where(at, t[..., None], lt))
  shift_lv = torch.where(below[..., None], lv[..., nxt, :],
                         torch.where(at[..., None], value[..., None, :], lv))
  is_append = ~exact & (i == n)
  is_shift = ~exact & (i > 0) & (i < n)
  target = torch.where(exact, _take(logical, i_idx),
                       torch.where(is_append, app_cursor, logical[..., 0]))
  hit = ar == target[..., None]
  pt_times = torch.where(hit & ~exact[..., None], t[..., None], times)
  pt_values = torch.where(hit[..., None], value[..., None, :], values)
  # the shifted samples back in physical order (the cursor stays)
  phys = (ar - cursor[..., None] - 1) % n
  sh_times = torch.gather(shift_lt, -1, phys)
  sh_values = torch.gather(shift_lv, -2,
                           phys[..., None].expand(shift_lv.shape))
  new_cursor = torch.where(is_append, app_cursor, cursor)
  new_times = torch.where(is_shift[..., None], sh_times, pt_times)
  new_values = torch.where(is_shift[..., None, None], sh_values, pt_values)
  return torch.cat([user[..., None], new_cursor.to(block.dtype)[..., None],
                    new_times, new_values.flatten(-2)], -1)


def read_block(block, n: int, dim: int, t, interp: int):
  """(B, G, dim) values at time t (B, G) (mju_historyRead): zero-order
  hold (0), linear (1) or cubic Hermite with Catmull-Rom slopes, zero at
  the ends (2); a time outside the samples takes the oldest or newest."""
  _, cursor, times, values = _views(block, n, dim)
  lt, lv = _ordered(times, values, _logical(cursor, n))
  i = _find_index(lt, t)
  i_idx = i.clamp(1, n - 1) if n > 1 else i.clamp(0, 0)
  lo, hi = (i_idx - 1).clamp(min=0), i_idx
  t_hi, t_lo = _take(lt, hi), _take(lt, lo)
  v_hi, v_lo = _take_row(lv, hi), _take_row(lv, lo)
  exact = (t - t_hi).abs() < MINVAL
  below = t <= lt[..., 0] + MINVAL
  above = t >= lt[..., n - 1] - MINVAL
  if interp == 0:
    mid = v_lo
  else:
    safe = lambda x: torch.where(x.abs() > MINVAL, x, 1.0)
    dt = t_hi - t_lo
    alpha = ((t - t_lo) / safe(dt))[..., None]
    if interp == 1:
      mid = v_lo + alpha * (v_hi - v_lo)
    else:
      a2, a3 = alpha * alpha, alpha ** 3
      h00 = 2 * a3 - 3 * a2 + 1
      h10 = a3 - 2 * a2 + alpha
      h01 = -2 * a3 + 3 * a2
      h11 = a3 - a2
      lo_prev = (i_idx - 2).clamp(min=0)
      hi_next = (i_idx + 1).clamp(max=n - 1)
      dt_lo = t_hi - _take(lt, lo_prev)
      m_lo = torch.where((i_idx > 1)[..., None],
                         (v_hi - _take_row(lv, lo_prev))
                         / safe(dt_lo)[..., None], 0.0)
      dt_hi = _take(lt, hi_next) - t_lo
      m_hi = torch.where((i_idx < n - 1)[..., None],
                         (_take_row(lv, hi_next) - v_lo)
                         / safe(dt_hi)[..., None], 0.0)
      dt = dt[..., None]
      mid = h00 * v_lo + h10 * dt * m_lo + h01 * v_hi + h11 * dt * m_hi
  return torch.where(below[..., None], lv[..., 0, :],
                     torch.where(above[..., None], lv[..., n - 1, :],
                                 torch.where(exact[..., None], v_hi, mid)))


def gather_block(buf, g: Group):
  """(B, G, L) words of a group's buffers."""
  return buf[:, index(g.words, buf.device)]


def scatter_block(buf, g: Group, block):
  """buf with a group's buffers replaced by block."""
  words = index(g.words.ravel(), buf.device)
  return buf.index_copy(1, words, block.reshape(buf.shape[0], -1))


def read_group(buf, g: Group, t):
  """(B, G, dim) values of a group's buffers at times t (B, G)."""
  return read_block(gather_block(buf, g), g.n, g.dim, t, g.interp)


def insert_group(buf, g: Group, t, value):
  """buf with value (B, G, dim) inserted at times t (B, G) into a
  group's buffers."""
  return scatter_block(buf, g, insert_block(gather_block(buf, g), g.n,
                                            g.dim, t, value))


_CACHE: dict = {}


def plan(m: Model) -> dict:
  """A Model's buffer groups, made once per Model (``struct.cached``):
  every actuator's and every sensor's buffer (the advance inserts into
  each), and per sensor stage the delayed and interval sensors' (that
  stage reads them back)."""
  return cached(_CACHE, m, _make_plan)


def _make_plan(m: Model) -> dict:
  ahist, shist = np.asarray(m.actuator_history), np.asarray(m.sensor_history)
  sens = np.nonzero(shist[:, 0] > 0)[0] if m.nsensor else np.zeros(0, int)
  timed = (np.asarray(m.sensor_delay) > 0) | (
      np.asarray(m.sensor_interval).reshape(-1, 2)[:, 0] > 0)
  stage = np.asarray(m.sensor_needstage)
  return {"ctrl": groups(m.actuator_historyadr, ahist,
                         np.ones(m.nu, np.int64),
                         np.nonzero(ahist[:, 0] > 0)[0] if m.nu
                         else np.zeros(0, int)),
          "sensor": groups(m.sensor_historyadr, shist, m.sensor_dim, sens),
          "stage": {s: groups(m.sensor_historyadr, shist, m.sensor_dim,
                              sens[timed[sens] & (stage[sens] == s)])
                    for s in (1, 2, 3)}}


def sensor_columns(m: Model, g: Group) -> np.ndarray:
  """(G, dim) sensordata columns of a group's sensors."""
  return np.asarray(m.sensor_adr)[g.ids][:, None] + np.arange(g.dim)


# ---------------------------------------------------------------------------
# one buffer at a time, as the reference's API
# ---------------------------------------------------------------------------


def _one(adr: int, n: int, dim: int, interp: int = 0) -> Group:
  return Group(n, dim, interp, np.zeros(1, np.int64),
               np.array([adr], np.int64),
               adr + np.arange(2 + n + n * dim)[None])


def _times(buf, t):
  return torch.as_tensor(t, dtype=buf.dtype, device=buf.device).expand(
      buf.shape[0]).reshape(-1, 1)


def insert(buf, adr: int, n: int, dim: int, t, value):
  """buf (B, nhistory) with value (B, dim) inserted at time t (a scalar
  or (B,)) into the buffer at adr (mju_historyInsert)."""
  g = _one(adr, n, dim)
  value = torch.as_tensor(value, dtype=buf.dtype, device=buf.device)
  return insert_group(buf, g, _times(buf, t),
                      value.reshape(-1, 1, dim).expand(buf.shape[0], 1, dim))


def read(buf, adr: int, n: int, dim: int, t, interp: int):
  """(B, dim) values of the buffer at adr at time t (mju_historyRead)."""
  return read_group(buf, _one(adr, n, dim, interp), _times(buf, t))[:, 0]


def read_ctrl(m: Model, d: Data, i: int, t, interp: int = -1):
  """(B,) delayed ctrl of actuator i at time t (mj_readCtrl); its live
  ctrl where it has no buffer."""
  n = int(m.actuator_history[i, 0])
  if n <= 0:
    return d.ctrl[:, int(m.actuator_ctrladr[i])]
  if interp < 0:
    interp = int(m.actuator_history[i, 1])
  t = torch.as_tensor(t, dtype=d.history.dtype, device=d.history.device)
  return read(d.history, int(m.actuator_historyadr[i]), n, 1,
              t - float(m.actuator_delay[i]), interp)[:, 0]


def read_sensor(m: Model, d: Data, i: int, t, interp: int = -1):
  """(B, dim) delayed value of sensor i at time t (mj_readSensor); its
  live sensordata where it has no buffer."""
  dim, adr_sd = int(m.sensor_dim[i]), int(m.sensor_adr[i])
  n = int(m.sensor_history[i, 0])
  if n <= 0:
    return d.sensordata[:, adr_sd:adr_sd + dim]
  if interp < 0:
    interp = int(m.sensor_history[i, 1])
  t = torch.as_tensor(t, dtype=d.history.dtype, device=d.history.device)
  return read(d.history, int(m.sensor_historyadr[i]), n, dim,
              t - float(m.sensor_delay[i]), interp)


def init_ctrl_history(m: Model, d: Data, i: int, times, values) -> Data:
  """Data with actuator i's buffer seeded with (times, values), times
  strictly increasing, its user word kept (mj_initCtrlHistory)."""
  n = int(m.actuator_history[i, 0])
  if n <= 0:
    raise ValueError(f"actuator {i} has no history buffer")
  adr = int(m.actuator_historyadr[i])
  return d.replace(history=_init_buf(d.history, adr, n, 1, times, values,
                                     d.history[:, adr]))


def init_sensor_history(m: Model, d: Data, i: int, times, values,
                        phase=0.0) -> Data:
  """Data with sensor i's buffer seeded with (times, values), phase in
  its user word (an interval sensor's previous tick;
  mj_initSensorHistory)."""
  n = int(m.sensor_history[i, 0])
  if n <= 0:
    raise ValueError(f"sensor {i} has no history buffer")
  adr = int(m.sensor_historyadr[i])
  return d.replace(history=_init_buf(
      d.history, adr, n, int(m.sensor_dim[i]), times, values,
      torch.full_like(d.history[:, adr], float(phase))))


def _init_buf(buf, adr, n, dim, times, values, user):
  nbatch = buf.shape[0]
  as_t = lambda x, k: torch.as_tensor(
      np.asarray(x, dtype=np.float64), dtype=buf.dtype,
      device=buf.device).reshape(-1, k).expand(nbatch, k)
  block = torch.cat([user.reshape(nbatch, 1),
                     buf.new_full((nbatch, 1), float(n - 1)),
                     as_t(times, n), as_t(values, n * dim)], -1)
  words = index(adr + np.arange(2 + n + n * dim), buf.device)
  return buf.index_copy(1, words, block)

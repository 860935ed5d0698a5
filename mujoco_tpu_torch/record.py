"""Record: simulate a model and write rendered frames and a USD stage
(port of mujoco_tpu/record.py; MuJoCo's sample/record.cc).

Steps the model, renders every ``--fps``-th state with ``ops/render.py``
(materials, textures and lights included) and writes env 0's frames as
PNG files, and with ``--usd`` the trajectory as a time-sampled USD stage.
The PNG files are written by a small writer on the standard library's
``zlib`` and ``struct``, so no imaging package is needed.

  python -m mujoco_tpu_torch.record <zoo or snapshot name | model.xml>
      [--out DIR] [--seconds S] [--fps F] [--width W] [--height H]
      [--camera ID] [--shadows] [--usd] [--device cpu]

A name loads a committed snapshot (``models/zoo.py``); an XML path is
compiled by the port's own compiler (``compiler.load_xml_path``, with
set_const on the same device), so no pip ``mujoco`` is needed. The device
is the CUDA card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch


def record(m, nstep: int, every: int, camid: int = 0, width: int = 128,
           height: int = 128, shadows: bool = False, d=None):
  """Roll out nstep steps, rendering every ``every``-th state.

  Returns (frames (nframes, B, H, W, 3) uint8 numpy, the Data after each
  rendered step); d defaults to ``io.make_data(m)`` on the Model's
  device."""
  from mujoco_tpu_torch.models import io
  from mujoco_tpu_torch.ops import forward, render

  if d is None:
    d = io.make_data(m, device=m.device)
  frames, datas = [], []
  for t in range(nstep):
    d = forward.step(m, d)
    if t % every == 0:
      rgb, _, _ = render.render(m, d, camid, width, height, shadows=shadows)
      frames.append((torch.clamp(rgb, 0, 1) * 255).to(torch.uint8).cpu())
      datas.append(d)
  return torch.stack(frames).numpy(), datas


def _chunk(kind: bytes, data: bytes) -> bytes:
  return (struct.pack(">I", len(data)) + kind + data
          + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
  """An (H, W, 3) uint8 image as an 8-bit RGB PNG: each row behind its
  filter byte 0, the rows deflated by zlib."""
  image = np.ascontiguousarray(image, dtype=np.uint8)
  height, width = image.shape[:2]
  raw = b"".join(b"\x00" + image[r].tobytes() for r in range(height))
  with open(path, "wb") as f:
    f.write(b"\x89PNG\r\n\x1a\n")
    f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0,
                                        0, 0)))
    f.write(_chunk(b"IDAT", zlib.compress(raw)))
    f.write(_chunk(b"IEND", b""))


def load_model(name: str, device=None):
  """A zoo or snapshot name, or an XML path (the port's compiler)."""
  from mujoco_tpu_torch.models import io, zoo
  if os.path.exists(name):
    from mujoco_tpu_torch.compiler import load_xml_path
    return io.put_model(load_xml_path(name, device=device), device=device)
  fn = getattr(zoo, name, None)
  if callable(fn):
    return fn(device=device)
  return zoo.load(name, device=device)


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument("model", help="zoo or snapshot name, or MJCF path")
  p.add_argument("--out", default="frames")
  p.add_argument("--seconds", type=float, default=2.0)
  p.add_argument("--fps", type=float, default=30.0)
  p.add_argument("--width", type=int, default=128)
  p.add_argument("--height", type=int, default=128)
  p.add_argument("--camera", type=int, default=0)
  p.add_argument("--shadows", action="store_true")
  p.add_argument("--usd", action="store_true",
                 help="also write a time-sampled USD stage")
  p.add_argument("--device", default=None,
                 help="torch device (default: the CUDA card)")
  args = p.parse_args(argv)

  m = load_model(args.model, args.device)
  dt = float(m.opt.timestep)
  nstep = max(1, int(round(args.seconds / dt)))
  every = max(1, int(round(1.0 / (args.fps * dt))))
  frames, datas = record(m, nstep, every, args.camera, args.width,
                         args.height, args.shadows)

  os.makedirs(args.out, exist_ok=True)
  for i, f in enumerate(frames):
    write_png(os.path.join(args.out, f"frame_{i:05d}.png"), f[0])
  print(f"wrote {len(frames)} frames to {args.out}/")

  if args.usd:
    from mujoco_tpu_torch.usd_export import export_usd
    path = os.path.join(args.out, "trajectory.usda")
    export_usd(m, datas, path, fps=args.fps)
    print(f"wrote {path}")


if __name__ == "__main__":
  main()

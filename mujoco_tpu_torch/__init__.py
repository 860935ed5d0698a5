"""PyTorch / CUDA port of mujoco_tpu for NVIDIA Hopper.

A second engine beside ``mujoco_tpu`` (the JAX reference), held against it
stage by stage. This package imports ``torch`` and ``numpy`` only; the pip
``mujoco`` is imported inside ``models.io.put_model`` as a model compiler and
nowhere else, and nothing here imports ``jax`` or ``mujoco_tpu``.

Layout mirrors ``mujoco_tpu/``: ``models/`` (types, io, zoo), ``ops/``
(pipeline stages and the two hand-written CUDA kernels, ``linalg_cuda`` and
``newton_cuda``), ``parallel/`` (rollout), ``utils/``. CUDA sources live in
``csrc/`` and are compiled with nvcc at first use (``ops/cuda_build.py``).
"""

import torch

# f32 matrix products on the card stay in full f32: TF32 keeps ~3 decimal
# digits, which the solver's linesearch comparisons cannot tolerate. Both
# switches are set explicitly rather than relying on PyTorch's defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

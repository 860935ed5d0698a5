"""The port's examples (``examples_torch/``, one per script of
``examples/``) run end to end on the CPU, as tests/test_examples.py runs
the reference's: each as ``python examples_torch/<name>.py`` from the repo
root with no PYTHONPATH, at ``EX_NBATCH=8 EX_NSTEP=10`` and
``EX_DEVICE=cpu`` (their default device is the card).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_examples.py -q
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(f for f in os.listdir(os.path.join(ROOT, "examples_torch"))
                  if f.endswith(".py"))


def test_every_reference_example_has_a_port():
  assert EXAMPLES == sorted(f for f in os.listdir(os.path.join(
      ROOT, "examples")) if f.endswith(".py"))


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name):
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env.update(EX_DEVICE="cpu", EX_NBATCH="8", EX_NSTEP="10",
             OMP_NUM_THREADS="1")
  r = subprocess.run([sys.executable, os.path.join("examples_torch", name)],
                     cwd=ROOT, env=env, capture_output=True, text=True,
                     timeout=600)
  assert r.returncode == 0, f"{name} failed:\n{r.stdout}\n{r.stderr}"
  out = r.stdout
  assert out.strip(), name
  if name == "sysid_fit.py":
    x = float(re.search(r"recovered ([0-9.]+)", out).group(1))
    assert abs(x - 0.27) < 1e-4, out
  if name == "rollout_batch.py":
    assert "8 envs x 10 steps" in out, out
  if name == "procedural_model.py":
    heights = [float(h) for h in re.search(
        r"stack heights: \[(.*)\]", out).group(1).split(",")]
    assert len(heights) == 3 and all(h > 0 for h in heights), out

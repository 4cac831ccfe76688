"""The port's twins of the JAX package's examples (``examples/torch_*.py``)
run with ``--cpu`` in a child process (one OpenMP thread; the shm
example's ring lives in the child), each printing its result line."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script,expect", [
    ("torch_llm_stream.py", "generated tokens: ["),
    ("torch_query_offload.py", "offloaded result: [ 0. 10. 20. 30.]"),
    ("torch_query_dynamic_batching.py", "8 concurrent clients answered correctly"),
    ("torch_shm_handoff.py", "halved: [[0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0], "
                             "[2.0, 2.0, 2.0, 2.0]]"),
    ("torch_fetch_bound.py", "overlay: (2, 64, 64, 4)"),
])
def test_example_twin_runs_on_the_cpu(script, expect):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(REPO / "examples" / script), "--cpu"],
                         cwd=str(REPO), env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert expect in out.stdout, out.stdout[-2000:]


def test_fetch_bound_twin_is_flagged_by_the_deep_lint():
    """``lint --deep`` on ``examples/torch_fetch_bound.py`` with a calibrated
    link emits ``fetch-bound``, as the JAX example's docstring promises."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               NNS_TPU_LINK_D2H_MBPS="38.2", NNS_TPU_LINK_RTT_MS="88")
    out = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.tools.lint", "--deep", "-v",
         "--files", str(REPO / "examples" / "torch_fetch_bound.py")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=240)
    assert "warning[fetch-bound]" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]

"""The PyTorch port's twins of the four JAX examples run on the CPU
(``--device cpu``, the kernels' plain versions), each in its own
interpreter, and exit 0: each exits non-zero where its check fails (the
Dreyfus-Wagner optimum and the engine's best weight; batched answers
equal to single ones; coalescing and cache hits; a restart that resumes
its step and state)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXPECT = {
    "quickstart_torch.py": "verified optimal (Dreyfus-Wagner oracle: 4.0)",
    "relationship_queries_torch.py": "served 6 queries",
    "serving_torch.py": "served from the cache",
    "train_lm_torch.py": "OK: resumed at step 35",
}


@pytest.mark.parametrize("script", sorted(EXPECT))
def test_example_twin_runs_on_the_cpu(script):
    # Two threads each: the suite runs these beside other test workers.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert EXPECT[script] in out.stdout

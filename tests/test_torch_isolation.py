"""Import guard: ``repro_torch``, ``chip_smoke.py`` and the port's
examples never import JAX, the JAX package or ``ml_dtypes`` (the card's
machine has none).  A fresh interpreter imports every ``repro_torch``
module and every module each script names, then each script itself
(without running it), then no ``jax*``, no ``repro`` / ``repro.*`` and no
``ml_dtypes`` module may be loaded."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import ast, importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
for script in sys.argv[1:]:
    tree = ast.parse(open(script).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                importlib.import_module(alias.name)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            importlib.import_module(node.module)
    folder, name = script.rsplit("/", 1)
    sys.path.insert(0, folder)
    importlib.import_module(name[:-3])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
             or m.startswith("jax"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT / "chip_smoke.py"),
         str(ROOT / "examples" / "gnn_train_torch.py")],
        capture_output=True, text=True, env=env, check=True, cwd=ROOT)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.engine.engine" in seen["modules"]
    assert "repro_torch.kernels.lane_superstep.ops" in seen["modules"]
    assert "repro_torch.models.transformer" in seen["modules"]
    assert "repro_torch.kernels.flash_attention.ops" in seen["modules"]
    assert "repro_torch.launch.serve" in seen["modules"]
    for name in ("repro_torch.obs.trace", "repro_torch.obs.metrics",
                 "repro_torch.obs.export", "repro_torch.obs.telemetry",
                 "repro_torch.serve.service", "repro_torch.serve.batcher",
                 "repro_torch.serve.loadgen", "repro_torch.launch.serve_dks",
                 "repro_torch.launch.dks_query",
                 "repro_torch.models.recsys", "repro_torch.data.pipeline",
                 "repro_torch.kernels.embedding_bag.ops",
                 "repro_torch.kernels.embedding_bag.ref",
                 "repro_torch.kernels.segment_minplus.ops",
                 "repro_torch.kernels.segment_minplus.ref",
                 "repro_torch.kernels.counting",
                 "repro_torch.store", "repro_torch.store.artifact",
                 "repro_torch.store.ingest", "repro_torch.store.delta",
                 "repro_torch.live", "repro_torch.live.state",
                 "repro_torch.live.watch", "repro_torch.live.swap",
                 "repro_torch.launch.ingest",
                 "repro_torch.core.dks_sharded", "repro_torch.core.fagin",
                 "repro_torch.core.baselines",
                 "repro_torch.models.moe", "repro_torch.models.kvcache",
                 "repro_torch.optim", "repro_torch.optim.optimizers",
                 "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpointer",
                 "repro_torch.distributed", "repro_torch.distributed.fault",
                 "repro_torch.launch.train", "repro_torch.models.lm",
                 "repro_torch.models.gnn", "repro_torch.graph.sampler",
                 "repro_torch.graph.partition"):
        assert name in seen["modules"], name
    assert seen["bad"] == []

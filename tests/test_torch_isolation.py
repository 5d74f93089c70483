"""Import guard: ``repro_torch``, ``chip_smoke.py`` and the port's
examples never import JAX, the JAX package or ``ml_dtypes`` (the card's
machine has none).  A fresh interpreter imports every ``repro_torch``
module and every module each script names, then each script itself
(without running it: each runs under its ``__main__`` check), then no
``jax*``, no ``repro`` / ``repro.*`` and no
``ml_dtypes`` module may be loaded."""

import ast
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
         *(str(ROOT / "examples" / f"{name}_torch.py")
           for name in ("gnn_train", "quickstart", "relationship_queries",
                        "serving", "train_lm"))],
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
                 "repro_torch.graph.partition",
                 "repro_torch.analysis", "repro_torch.analysis.count",
                 "repro_torch.analysis.roofline", "repro_torch.launch.cells",
                 "repro_torch.launch.dryrun", "repro_torch.launch.analyze",
                 "repro_torch.distributed.comm",
                 "repro_torch.distributed.compression",
                 "repro_torch.distributed.ranks", "repro_torch.launch.mesh",
                 "repro_torch.models.pipeline"):
        assert name in seen["modules"], name
    assert seen["bad"] == []


def uses_torch_distributed(path: Path) -> bool:
    """Does the module's code (not its docstrings) import or reach
    ``torch.distributed``?"""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import) and any(
                a.name.startswith("torch.distributed") for a in node.names):
            return True
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module.startswith("torch.distributed")
                or (node.module == "torch"
                    and any(a.name == "distributed" for a in node.names))):
            return True
        if (isinstance(node, ast.Attribute) and node.attr == "distributed"
                and isinstance(node.value, ast.Name)
                and node.value.id == "torch"):
            return True
    return False


def test_only_comm_calls_torch_distributed():
    """``distributed/comm.py`` is the port's one door to
    ``torch.distributed``: the backend choice, the staging through host
    memory and the refusal to fall back live there alone."""
    pkg = ROOT / "src" / "repro_torch"
    users = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                   if uses_torch_distributed(p))
    assert users == ["distributed/comm.py"]

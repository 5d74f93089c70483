"""Train a reduced LM end to end on the PyTorch port — the trainer, the
prefetching pipeline, the fault guard and checkpoints — then stop it
mid-run and show that a restart resumes without losing a step; the twin
of ``examples/train_lm.py`` (qwen1.5-4b at ``smoke()`` widths, 60 steps
of 8 x 64 tokens, a checkpoint every 20).

The run is stopped after 35 steps and restarted to 60.  Exits non-zero
unless the restart runs exactly steps 35 to 59 (none lost, none run
twice), its first loss lies nearer the stopped run's last than its first
(the trained state came back, not a fresh one), and the loss improves
across the restart.

    PYTHONPATH=src python examples/train_lm_torch.py              # cuda:0
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
(the same driver trains the full config on the card:
 python -m repro_torch.launch.train --arch granite-moe-3b-a800m ...)
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

from repro_torch.device import resolve_device
from repro_torch.launch.train import parser, train_lm

STOP, STEPS = 35, 60


def run(device: str, ckpt_dir: Path, steps: int) -> dict:
    return train_lm(parser().parse_args([
        "--arch", "qwen1.5-4b", "--smoke", "--steps", str(steps),
        "--batch", "8", "--seq", "64", "--lr", "1e-3", "--ckpt-every", "20",
        "--log-every", "10", "--device", device, "--ckpt-dir",
        str(ckpt_dir)]))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0",
                    help="'cpu' runs the port's plain versions")
    dev = resolve_device(ap.parse_args(argv).device)
    tmp = Path(tempfile.mkdtemp(prefix="dks_lm_ckpt_"))
    try:
        # Phase 1: 35 steps, checkpoints at 20 and at the stop.
        out1 = run(str(dev), tmp, STOP)
        print("phase-1:", {k: v for k, v in out1.items() if k != "steps"})
        # Phase 2: the same job restarted; it resumes from the last
        # checkpoint and finishes the 60 steps.
        out2 = run(str(dev), tmp, STEPS)
        print("phase-2 (resumed):",
              {k: v for k, v in out2.items() if k != "steps"})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    resumed = [r["step"] for r in out2["steps"]]
    if resumed != list(range(STOP, STEPS)):
        print(f"FAILED: the restart ran steps {resumed[:3]}..., not "
              f"{STOP}..{STEPS - 1}")
        return 1
    first, last = out1["first_loss"], out1["last_loss"]
    if abs(out2["first_loss"] - last) >= abs(out2["first_loss"] - first):
        print(f"FAILED: the restart's first loss {out2['first_loss']:.3f} "
              f"is not nearer the stopped run's last ({last:.3f}) than its "
              f"first ({first:.3f}): the trained state was lost")
        return 1
    if not out2["last_loss"] < first:
        print("FAILED: training did not improve")
        return 1
    print(f"OK: resumed at step {STOP} with the trained state (loss "
          f"{last:.3f} -> {out2['first_loss']:.3f}); loss improved across "
          f"the restart ({first:.3f} -> {out2['last_loss']:.3f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

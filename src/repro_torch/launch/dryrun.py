"""One-card dry run of every cell: the twin of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun              # meta
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cuda

``--device meta`` (the default) builds every cell of
:mod:`repro_torch.launch.cells` on ``meta`` tensors (no card, no
allocation) and counts one call of its step with
:mod:`repro_torch.analysis.count` (a folded train step's one micro-batch
counted times its trips).  Per cell it records FLOPs (by dtype),
``eager_bytes`` (every eager op's inputs and outputs), ``min_bytes``
(arguments read once, outputs written once), the predicted peak of live
bytes, ``model_flops`` and the useful-FLOPs share, the roofline terms on
the H100 and ``fits_one_card`` (predicted peak within the card's 80 GB).

``--device cuda`` then runs every cell that fits, with content from
``--seed``: one call counted on the card, a warm call, then the median
of :data:`REPS` host-clocked windows, each as many calls as fill
:data:`WINDOW_S` and ended by ``torch.cuda.synchronize()``, divided by
its calls (one call, where the warm call took over 2 s).  A folded train
step (``cells.folded_train_step``) runs one micro-batch there too: its
time is that micro-batch's forward and backward times the trips, plus
the optimizer's update.  It adds the measured ms,
``max_memory_allocated`` over the timed calls, the card's name and
power limit, ``mfu`` (model FLOPs / time / the
dtype's peak) and ``hbm_share`` (``min_bytes`` / time / 3.35 TB/s).  With
no card it fails; it never falls back to the CPU.

JSON goes to ``build/dryrun_torch/<device>/<cell>.json`` (``--out``).

``--mesh single|multi|both`` counts ``repro``'s cells on its production
meshes instead, on ``meta`` only (``--device cuda`` is refused): 16 x 16
(data, model) and 2 x 16 x 16 (pod, data, model), each a
:class:`~repro_torch.distributed.comm.CountingMesh` seen from rank 0.
The cells are ``repro``'s ``iter_cells`` (``cells.mesh_cells``): the LMs
built at ``tp=16``, each argument this rank's slice by ``repro``'s
in-specs, the frontier DKS cells one shard a rank, the dense one's rows
over the data axes and its keyword sets over ``model``; the multi-pod
mesh adds ``lm_pp_cell`` at ``train_4k`` for every LM
(``cells.pp_cells``).  Per cell the record
adds ``mesh``, ``chips``, ``fits_one_card`` (a rank's predicted peak
within 80 GB), the collective bytes and counts by kind, the wire bytes
a rank sends (``repro``'s ring factors) and the three roofline terms, the
collective one over NVLink (its caveat in
:mod:`repro_torch.analysis.roofline`).  These are counted, not measured.
JSON goes to ``build/dryrun_torch/<pod16x16|multipod2x16x16>/<cell>.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis import build_roofline, count_call
from repro_torch.analysis import roofline as rl
from repro_torch.launch import cells as cells_mod

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
GIB = 2 ** 30
LONG_S = 2.0        # a warm call longer than this is timed once
REPS = 3            # timed windows a cell; the median is kept
WINDOW_S = 0.4      # each window's calls last at least this long


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return smi.stdout.strip().splitlines()[0]


def meta_record(cell: cells_mod.Cell, mesh_name: str = "card",
                chips: int = 1) -> dict:
    """Count one call of ``cell`` on ``meta`` (on a mesh of ``chips``
    cards, ``mesh_name``: one rank's call)."""
    t0 = time.perf_counter()
    fn, args = cell.build(torch.device("meta"))
    _, summary = count_call(fn, args)
    del fn, args
    terms = build_roofline(cell.arch_id, cell.shape_name, summary,
                           cell.model_flops, mesh_name, chips)
    return {
        "cell": cell.name, "arch": cell.arch_id, "shape": cell.shape_name,
        "kind": cell.kind, "notes": cell.notes, "device": "meta",
        "mesh": mesh_name, "chips": chips,
        "count_s": time.perf_counter() - t0,
        "count": summary.as_row(),
        "flops": summary.flops, "eager_bytes": summary.eager_bytes,
        "min_bytes": summary.min_bytes, "peak_bytes": summary.peak_bytes,
        "model_flops": cell.model_flops,
        "useful_flops_frac": terms.useful_flops_frac,
        "fits_one_card": summary.peak_bytes <= rl.CARD_BYTES,
        "collective_bytes": summary.collective_bytes,
        "collective_counts": summary.collective_counts,
        "wire_bytes": summary.wire_bytes,
        "roofline": terms.as_row(),
    }


def _sync_s() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def _timed(fn, args, trips: int, calls: int = 1) -> float:
    """Seconds a call of ``calls`` run back to back, ended by a
    synchronize.  A folded train step (``trips`` > 1) runs one
    micro-batch: its time is its ``grad_s`` (that micro-batch's forward
    and backward) times ``trips`` plus its ``update_s``."""
    if trips > 1:
        _, metrics = fn(*args)
        return metrics["grad_s"] * trips + metrics["update_s"]
    t0 = _sync_s()
    for _ in range(calls):
        fn(*args)
    return (_sync_s() - t0) / calls


def cuda_record(cell: cells_mod.Cell, meta: dict, seed: int, card: str,
                dev: torch.device | None = None) -> dict:
    """Run ``cell`` on the card (``dev``, default ``cuda:0``): its count
    there, a warm call, and the median of :data:`REPS` windows of calls
    filling :data:`WINDOW_S` each (one call where the warm call took more
    than :data:`LONG_S`), with the peak memory they reach."""
    dev = dev or torch.device("cuda", 0)
    trips = math.prod(meta["count"]["multiplier"])
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    fn, args = cell.build(dev, torch.Generator(dev).manual_seed(seed))
    summary = count_call(fn, args)[1]         # its result freed here
    warm = _timed(fn, args, trips)
    reps, calls = ((1, 1) if warm > LONG_S or trips > 1
                   else (REPS, math.ceil(WINDOW_S / warm)))
    gc.collect()
    torch.cuda.reset_peak_memory_stats(dev)
    times = [_timed(fn, args, trips, calls) for _ in range(reps)]
    peak = torch.cuda.max_memory_allocated(dev) - base
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    s = statistics.median(times)
    terms = meta["roofline"]
    return {
        **meta, "device": "cuda", "card": card,
        "device_name": torch.cuda.get_device_name(0),
        "ms": s * 1e3, "ms_each": [t * 1e3 for t in times],
        "calls_each": calls, "folded_trips": trips,
        "measured_peak_bytes": peak, "predicted_peak_bytes":
            meta["peak_bytes"],
        "card_flops": summary.flops, "card_count": summary.as_row(),
        "mfu": cell.model_flops / s / terms["peak_flops"],
        "hbm_share": meta["min_bytes"] / s / rl.HBM_BYTES_PER_S,
    }


def write(rec: dict, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{rec['cell']}.json").write_text(json.dumps(rec, indent=1))


def summary_line(rec: dict) -> str:
    r = rec["roofline"]
    line = (f"{rec['cell']:<44s} flops={rec['flops']:.4e} "
            f"min={rec['min_bytes'] / GIB:8.2f}GiB "
            f"eager={rec['eager_bytes'] / GIB:9.2f}GiB "
            f"peak={rec['peak_bytes'] / GIB:7.2f}GiB "
            f"fits={rec['fits_one_card']!s:5s} t_c={r['t_compute']:.3e} "
            f"t_m={r['t_memory']:.3e} ")
    if rec.get("chips", 1) > 1:
        line = (f"{rec['mesh']} {line}wire={rec['wire_bytes'] / 1e9:.3f}GB "
                f"t_x={r['t_collective']:.3e} ")
    line += f"-> {r['bottleneck']}"
    if rec["device"] == "cuda":
        line += (f" | {rec['ms']:.3f} ms, peak "
                 f"{rec['measured_peak_bytes'] / GIB:.2f} GiB, "
                 f"mfu={rec['mfu']:.4f} hbm={rec['hbm_share']:.4f}")
    return line


def run(device: str = "meta", only: str | None = None, seed: int = 0,
        out: Path = OUT_DIR) -> tuple[list[dict], list]:
    """Every cell (``only``: a substring of the name) on ``meta``, then,
    with ``device="cuda"``, on the card where it fits.  Returns the
    records and the failures ``(cell, error)``."""
    if device not in ("meta", "cuda"):
        raise ValueError(f"dryrun: --device meta or cuda, got {device!r}")
    card = None
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun --device cuda: no CUDA device "
                               "(torch.cuda.is_available() is False); it "
                               "never falls back to the CPU")
        card = card_line()
    records, failures = [], []
    for cell in cells_mod.all_cells():
        if only and only not in cell.name:
            continue
        try:
            rec = meta_record(cell)
            write(rec, out / "meta")
            if device == "cuda" and rec["fits_one_card"]:
                rec = cuda_record(cell, rec, seed, card)
                write(rec, out / "cuda")
        except Exception as e:  # noqa: BLE001  (one cell's fault is reported)
            traceback.print_exc()
            failures.append((cell.name, repr(e)))
            print(f"[FAIL] {cell.name}: {e!r}", flush=True)
            continue
        records.append(rec)
        print(f"[OK] {summary_line(rec)}", flush=True)
    return records, failures


def run_mesh(multi_pod: bool, only: str | None = None,
             out: Path = OUT_DIR) -> tuple[list[dict], list]:
    """Every cell of ``cells.mesh_cells`` (on the multi-pod mesh, and of
    ``cells.pp_cells``) counted on ``meta`` at rank 0 of a counting
    production mesh (``only``: a substring of the name).  Returns the
    records and the failures ``(cell, error)``."""
    from repro_torch.launch.mesh import MESH_NAMES, make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, counting=True)
    name = MESH_NAMES[multi_pod]
    makers = cells_mod.mesh_cells(mesh)
    if multi_pod:
        makers += cells_mod.pp_cells(mesh)
    records, failures = [], []
    for cell_name, make in makers:
        if only and only not in cell_name:
            continue
        try:
            rec = meta_record(make(), name, mesh.size)
            write(rec, out / name)
        except Exception as e:  # noqa: BLE001  (one cell's fault is reported)
            traceback.print_exc()
            failures.append((f"{name} {cell_name}", repr(e)))
            print(f"[FAIL] {name} {cell_name}: {e!r}", flush=True)
            continue
        records.append(rec)
        print(f"[OK] {summary_line(rec)}  (counted, not measured)",
              flush=True)
    return records, failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("meta", "cuda"), default="meta")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default=None, help="count on repro's production "
                    "meshes (meta only)")
    ap.add_argument("--only", default=None,
                    help="substring filter on <arch>__<shape>")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.mesh is not None and args.device != "meta":
        print("dryrun: --mesh counts on meta only; --device cuda runs one "
              "card", file=sys.stderr)
        return 2
    try:
        if args.mesh is None:
            records, failures = run(args.device, args.only, args.seed,
                                    args.out)
        else:
            records, failures = [], []
            for multi in {"single": (False,), "multi": (True,),
                          "both": (False, True)}[args.mesh]:
                r, f = run_mesh(multi, args.only, args.out)
                records += r
                failures += f
    except RuntimeError as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 2
    print(f"\n{len(records)} cells OK, {len(failures)} failed")
    for name, err in failures:
        print("FAILED:", name, err)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

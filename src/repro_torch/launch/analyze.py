"""One cell's breakdown: the twin of ``repro.launch.analyze``.

    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --cell dcn-v2__serve_p99                      # meta: no card
    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --cell gin-tu__ogb_products --device cuda

Counts one call of the cell on ``meta`` (:mod:`repro_torch.analysis.count`)
and prints its top ops by bytes and by FLOPs, the loop trips folded, the
predicted peak and the roofline terms on the H100.  With ``--device
cuda`` it runs the cell on the card (content from ``--seed``), warms it,
and adds a ``torch.profiler`` window (:func:`profile_window`): the
device-busy share of the wall, the kernels that lead by device time, and
the launches.  With no card ``--device cuda`` fails.

``--mesh single|multi`` (``multi`` is ``repro``'s ``--multi-pod``) counts
the cell at rank 0 of a counting production mesh instead (on ``meta`` only;
``cells.mesh_cells``, and ``cells.pp_cells``' ``<lm>__train_4k_pp2`` on
the multi-pod mesh) and adds the top collectives by bytes, with the wire
bytes and the collective term (counted, not measured):

    PYTHONPATH=src python -m repro_torch.launch.analyze \
        --cell command-r-plus-104b__train_4k --mesh multi
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable

import torch

from repro_torch.analysis import build_roofline, count_call
from repro_torch.launch import cells as cells_mod

GIB = 2 ** 30


def profile_window(fn: Callable[[], object], steps: int = 1,
                   top: int = 8) -> dict:
    """``steps`` calls of ``fn`` under ``torch.profiler`` (CPU and CUDA),
    ended by a synchronize: per call the profiled host wall ms, the
    kernels' device-busy ms, the launches, and the ``top`` kernels by
    device time as ``(name, ms, launches)``.  ``busy_ms`` is 0 where the
    profiler saw no kernel (device time not measured).  Profiled, the
    host runs slower than unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    return {
        "wall_ms": wall, "busy_ms": busy,
        "busy_share": busy / wall if wall > 0 else 0.0,
        "launches": sum(e.count for e in kernels) // steps,
        "top": [(e.key, e.self_device_time_total / 1e3 / steps,
                 e.count // steps) for e in kernels[:top]]}


def window_line(what: str, w: dict, name_width: int = 60) -> str:
    """One log line of a :func:`profile_window` result."""
    if w["busy_ms"] == 0:
        return (f"  {what}: device time not measured (the profiler saw no "
                f"kernel)")
    top = "; ".join(f"{name[:name_width]} {ms:.3f} ms x{n}"
                    for name, ms, n in w["top"])
    return (f"  {what} under torch.profiler: kernels busy "
            f"{w['busy_ms']:.3f} ms of {w['wall_ms']:.3f} ms wall "
            f"({100 * w['busy_share']:.1f} %), {w['launches']} kernel "
            f"launches; top: {top}")


def op_rows(rows: list, what: str) -> list[str]:
    lines = [f"top ops by {what} (op, calls, GiB, GFLOP):"]
    for name, calls, nbytes, flops in rows:
        lines.append(f"  {name:36s} x{calls:<10.0f} {nbytes / GIB:12.3f} "
                     f"{flops / 1e9:14.3f}")
    return lines


def breakdown(cell: cells_mod.Cell, top: int = 20, mesh_name: str = "card",
              chips: int = 1) -> tuple[list[str], object]:
    """The meta count's report lines, and its summary (on a mesh of
    ``chips`` cards: one rank's, with its top collectives)."""
    fn, args = cell.build(torch.device("meta"))
    _, s = count_call(fn, args, top=top)
    del fn, args
    t = build_roofline(cell.arch_id, cell.shape_name, s, cell.model_flops,
                       mesh_name, chips)
    where = "" if chips == 1 else f" on {mesh_name}, rank 0 of {chips}"
    lines = [
        f"== {cell.name}  ({cell.notes or cell.kind}){where} ==",
        f"arguments {s.arg_bytes / GIB:.2f} GiB, predicted peak "
        f"{s.peak_bytes / GIB:.2f} GiB; min_bytes {s.min_bytes / GIB:.3f} "
        f"GiB, eager_bytes {s.eager_bytes / GIB:.3f} GiB; {s.n_ops:.0f} "
        f"ops, loop trips folded {s.multiplier or 'none'}",
        f"FLOPs {s.flops:.4e} by dtype {s.flops_by_dtype}; model FLOPs "
        f"{cell.model_flops:.4e} (useful {100 * t.useful_flops_frac:.1f} %)",
        f"kernels {s.kernel_calls or 'none'}",
        f"t_compute={t.t_compute:.3e}s t_memory={t.t_memory:.3e}s "
        f"(eager {t.t_memory_eager:.3e}s) t_collective="
        f"{t.t_collective:.3e}s -> {t.bottleneck}   [NVIDIA H100 SXM "
        f"data-sheet peaks, NVLink 4]",
        *op_rows(s.top_bytes, "bytes"), *op_rows(s.top_flops, "FLOPs")]
    if chips > 1:
        lines += [f"collectives (counted, not measured): "
                  f"{ {k: f'{v / GIB:.3f} GiB' for k, v in s.collective_bytes.items()} }, "
                  f"wire {s.wire_bytes / GIB:.3f} GiB a rank",
                  "top collectives by bytes (kind, operand, calls, GiB):"]
        lines += [f"  {kind:20s} {operand:40s} x{calls:<8.0f} "
                  f"{nbytes / GIB:12.3f}"
                  for kind, operand, calls, nbytes in s.top_collectives]
    return lines, s


def mesh_cell(name: str, multi_pod: bool):
    """(the cell ``name`` at rank 0 of a counting production mesh, the
    mesh's name, its size)."""
    from repro_torch.launch.mesh import MESH_NAMES, make_production_mesh

    mesh = make_production_mesh(multi_pod=multi_pod, counting=True)
    makers = dict(cells_mod.mesh_cells(mesh))
    if multi_pod:
        makers.update(cells_mod.pp_cells(mesh))
    if name not in makers:
        raise KeyError(f"no cell {name!r} on {MESH_NAMES[multi_pod]}; it "
                       f"has {sorted(makers)}")
    return makers[name](), MESH_NAMES[multi_pod], mesh.size


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--device", choices=("meta", "cuda"), default="meta")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--mesh", choices=("single", "multi"), default=None,
                    help="count on a production mesh (meta only)")
    args = ap.parse_args(argv)
    mesh = args.mesh
    if mesh is not None and args.device != "meta":
        print("analyze: --mesh counts on meta only",
              file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("analyze --device cuda: no CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if mesh is None:
        cell = cells_mod.get_cell(args.cell)
        lines, summary = breakdown(cell, args.top)
    else:
        cell, name, chips = mesh_cell(args.cell, mesh == "multi")
        lines, summary = breakdown(cell, args.top, name, chips)
    print("\n".join(lines))
    if args.device == "cuda":
        from repro_torch.launch.dryrun import card_line

        dev = torch.device("cuda", 0)
        fn, cargs = cell.build(dev, torch.Generator(dev).manual_seed(
            args.seed))
        fn(*cargs)                     # warm
        w = profile_window(lambda: fn(*cargs), top=args.top)
        print(window_line(f"one call (loop trips folded "
                          f"{summary.multiplier or 'none'})", w))
        print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

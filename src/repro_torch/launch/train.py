"""Training driver (``repro.launch.train``):

    python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
        --steps 16 --batch 4 --seq 2048
    python -m repro_torch.launch.train --arch dcn-v2 --steps 20 --batch 8192
    python -m repro_torch.launch.train --arch granite-moe-3b-a800m --smoke \\
        --steps 20 --device cpu

The loop of ``repro``'s driver on one device: a prefetching data stream
(:mod:`repro_torch.data`), a per-step fault guard (retry and straggler
EMA, :mod:`repro_torch.distributed.fault`), AdamW with f32 moments
(:mod:`repro_torch.optim`), and async checkpoints with a crash-safe commit
and auto-resume (:mod:`repro_torch.checkpoint`, ``repro``'s on-disk
layout).  Weights are random, drawn from ``--seed``.  The model is built at
``--tp`` (default ``repro``'s: 1 under ``--smoke``, else 16), its heads,
vocabulary and experts padded to it, all in this one process, as
``repro``'s training CLI builds without a mesh; ``repro``'s ``--compress``
gradient compression has no counterpart.  Attention is
``repro``'s choice: ``"naive"`` under ``--smoke``, else ``"chunked"``.
Without ``--device`` it runs on ``cuda:0`` and raises when there is no
GPU.  Prints ``TRAINING IMPROVED`` and exits 0 when the last loss is below
the first, else exits 1.  GNN archs are refused, as ``repro``'s driver
refuses them: ``examples/gnn_train_torch.py`` trains them
(:func:`repro_torch.models.gnn.gnn_train_step`).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import GNNConfig, LMConfig, RecsysConfig, get_arch
from repro_torch.data import (PrefetchIterator, lm_synthetic_stream,
                              recsys_synthetic_stream)
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import StepGuard, block_until_ready
from repro_torch.launch.mesh import default_tp
from repro_torch.models import lm as lm_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               global_norm, reduce_replicated, tree_leaves,
                               tree_unflatten)


def opt_config(args) -> AdamWConfig:
    """``repro``'s schedule for a run: warm-up over a twentieth of it."""
    return AdamWConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20))


def _config(args, kind: type):
    cfg = get_arch(args.arch)
    if not isinstance(cfg, kind):
        raise SystemExit(f"{args.arch} is not a {kind.__name__}")
    return cfg.smoke() if args.smoke else cfg


def train_lm(args) -> dict:
    """``args``: the CLI's namespace (:func:`parser`).  Returns the first
    and last loss, the wall time, the guard's events and the per-step
    record (``loss``, ``grad_norm``, ``lr``, ``step_s``, ``grad_s``,
    ``update_s``, ``dropped_frac`` for a MoE model), the tokens per second
    over the steps after the first, and the peak device memory."""
    cfg = _config(args, LMConfig)
    b = tfm.build(cfg, default_tp(args))
    dev = resolve_device(args.device)
    opt_cfg = opt_config(args)
    print(f"{cfg.name}: tp={b.tp} ({b.n_heads_p} q / {b.n_kv_heads_p} kv "
          f"heads, vocab {b.vocab_p}"
          + (f", {b.e_pad} experts" if b.e_pad else "") + ")")
    step_fn = lm_lib.make_train_step(
        opt_cfg, attn_impl="naive" if args.smoke else "chunked",
        grad_accum=args.grad_accum)
    ckpt = Checkpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    start = 0
    if ckpt is not None and ckpt.latest() is not None:
        tree, start = ckpt.restore(lm_lib.train_state_template(b),
                                   device=dev)
        state = lm_lib.train_state_from_tree(b, tree)
        del tree
        print(f"resumed from step {start}")
    else:
        gen = torch.Generator(dev).manual_seed(args.seed)
        state = lm_lib.init_train_state(tfm.init_lm(b, gen))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    stream = PrefetchIterator(lm_synthetic_stream(
        cfg.vocab, args.batch, args.seq, seed=args.seed, skip=start))
    guard = StepGuard()
    record = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(stream).items()}
        state, metrics, info = guard.run(step_fn, state, batch)
        row = {"step": step, "step_s": info["step_time_s"],
               **{k: float(metrics[k]) for k in
                  ("loss", "grad_norm", "lr", "grad_s", "update_s")}}
        if "dropped_frac" in metrics:
            row["dropped_frac"] = metrics["dropped_frac"].tolist()
        record.append(row)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={row['loss']:.4f} "
                  f"lr={row['lr']:.2e} gnorm={row['grad_norm']:.3f} "
                  f"t={row['step_s'] * 1e3:.0f}ms "
                  f"(fwd+bwd {row['grad_s'] * 1e3:.0f}, "
                  f"opt {row['update_s'] * 1e3:.0f})"
                  + (" [straggler]" if info["straggler"] else ""))
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save(lm_lib.train_state_tree(state), step + 1)
    if ckpt is not None:
        ckpt.save(lm_lib.train_state_tree(state), args.steps)
        ckpt.wait()
    wall = time.time() - t0
    if not record:
        raise SystemExit(f"nothing to train: resumed at step {start} of "
                         f"{args.steps}")
    steady = [r["step_s"] for r in record[1:]] or [record[0]["step_s"]]
    return {"first_loss": record[0]["loss"], "last_loss": record[-1]["loss"],
            "wall_s": wall, "guard_events": guard.events, "steps": record,
            "tokens_per_s": args.batch * args.seq * len(steady) / sum(steady),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def recsys_loss_and_grads(params: dict, batch: dict, cfg: RecsysConfig,
                          impl: str = "cuda", mesh=None
                          ) -> tuple[torch.Tensor, dict, torch.Tensor | None]:
    """(``dcn_loss``, its gradient tree shaped like ``params``, the
    gradients' global norm on a mesh, else None).

    On a mesh ``params`` are this rank's slices (``rec_lib.param_specs``)
    and ``batch`` its rows: every rank differentiates ``loss / world
    size``, so that the ``psum`` of the lookup, whose transpose is
    ``psum``, sends the loss's gradient back through it once in all; each
    gradient is then summed over the axes its leaf is not split on (a
    split table's over the data axes, a whole leaf's over every axis),
    and the norm is the whole tree's: each split leaf's squares summed
    over its axes, each whole leaf counted once."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = rec_lib.dcn_loss(params, batch, cfg, impl, mesh)
    seed = None if mesh is None else torch.full_like(loss, 1.0 / mesh.size)
    # The item tower takes no part in the loss: its gradient is zero, as
    # JAX's.
    grads = tree_unflatten(params, torch.autograd.grad(
        loss, leaves, grad_outputs=seed, allow_unused=True,
        materialize_grads=True))
    for p in leaves:
        p.requires_grad_(False)
    if mesh is None:
        return loss.detach(), grads, None
    specs = rec_lib.param_specs(cfg)
    grads = reduce_replicated(grads, specs, mesh)
    return loss.detach(), grads, global_norm(grads, specs, mesh)


def make_recsys_step(cfg: RecsysConfig, opt_cfg: AdamWConfig,
                     impl: str = "cuda", mesh=None):
    """``step((params, opt), batch) -> ((params, opt), {"loss", "grads",
    "grad_norm", "lr"})``: :func:`recsys_loss_and_grads`, then AdamW, in
    place, after the gradients and their norm are complete (on a mesh,
    ``params``, ``opt``, ``batch`` and ``grads`` this rank's)."""

    def step_fn(carry, batch):
        params, opt = carry
        loss, grads, norm = recsys_loss_and_grads(params, batch, cfg, impl,
                                                  mesh)
        _, opt, metrics = adamw_update(opt_cfg, grads, opt, params,
                                       norm=norm)
        return (params, opt), {"loss": loss, "grads": grads, **metrics}

    return step_fn


def train_recsys(args) -> dict:
    """DCN-v2 on ``recsys_synthetic_stream`` with the grouped lookup
    (``impl="cuda"``: the kernel on the card, its plain version on the
    CPU).  Returns the first and last loss and the per-step record
    (``loss``, ``step_s``)."""
    cfg = _config(args, RecsysConfig)
    dev = resolve_device(args.device)
    params = rec_lib.init_dcn(cfg, torch.Generator(dev).manual_seed(args.seed))
    step_fn = make_recsys_step(cfg, opt_config(args))
    stream = PrefetchIterator(
        recsys_synthetic_stream(cfg, args.batch, seed=args.seed))
    record = []
    carry = (params, adamw_init(params))
    for step in range(args.steps):
        batch = rec_lib.batch_to_device(next(stream), dev)
        t0 = time.perf_counter()
        carry, metrics = block_until_ready(step_fn(carry, batch))
        record.append({"step": step, "loss": float(metrics["loss"]),
                       "step_s": time.perf_counter() - t0})
        del metrics  # the gradients, not kept through the next step
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={record[-1]['loss']:.4f} "
                  f"t={record[-1]['step_s'] * 1e3:.1f}ms")
    return {"first_loss": record[0]["loss"], "last_loss": record[-1]["loss"],
            "steps": record}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--tp", type=int, default=None,
                    help="the tensor-parallel degree an LM is padded to "
                         "(default: 1 with --smoke, else 16)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    try:
        cfg = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(e.args[0]) from None
    if isinstance(cfg, GNNConfig):
        raise SystemExit("use examples/gnn_train_torch.py for GNN archs")
    out = train_lm(args) if isinstance(cfg, LMConfig) else train_recsys(args)
    print({k: v for k, v in out.items() if k != "steps"})
    ok = out["last_loss"] < out["first_loss"]
    print("TRAINING", "IMPROVED" if ok else "DID NOT IMPROVE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Serving driver: batched prefill, then greedy decode against a KV cache.

    python -m repro_torch.launch.serve --arch chatglm3-6b --batch 4 \\
        --prompt-len 2048 --gen 32
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
        --batch 4 --prompt-len 2048 --gen 32
    python -m repro_torch.launch.serve --arch qwen1.5-4b --smoke --device cpu

Weights are random, drawn from ``--seed`` (no checkpoint is in the
repository).  The model is built at ``--tp`` (default ``repro``'s: 1
under ``--smoke``, else 16): heads, vocabulary and experts padded to it,
all in this one process, as ``repro``'s CLI builds at ``tp=16`` on one
device; the greedy pick reads the real vocabulary.  The prefill's
attention is ``--attn-impl`` (default "cuda":
the flash kernel on the card, its plain version on the CPU); decode uses
"auto", which picks naive attention at one query row.  ``--gen N``
returns N tokens per prompt, as ``repro``'s CLI does: the prefill's token,
then N - 1 greedy decode steps.  Without ``--device`` it runs on
``cuda:0`` and raises when there is no GPU.  A model whose weights do not
fit the card's free memory (dbrx-132b and command-r-plus-104b at full
depth) is refused before anything is allocated: the CLI runs one process
(several ranks hold a model split over ``model`` through
:func:`repro_torch.launch.mesh.shard_lm`), and it neither cuts the depth
nor falls back to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import LMConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import default_tp
from repro_torch.models import lm as lm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import IMPLS


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor        # [B, gen + 1]: the prefill's token, then one per step
    logits_last: torch.Tensor   # f32 [B, vocab]: the prefill's last position
    prefill_ms: float
    decode_ms: float            # all decode steps
    steps: int

    @property
    def decode_ms_per_step(self) -> float:
        return self.decode_ms / max(self.steps, 1)


def _now(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def generate(model: tfm.LM, prompts: torch.Tensor, gen: int,
             attn_impl: str = "cuda") -> Generation:
    """Prefill ``prompts`` [B, S] with ``attn_impl``, grow the cache to
    S + ``gen``, then ``gen`` greedy decode steps.  Times are host clocks
    ended by a device synchronise."""
    prefill = lm_lib.make_prefill_step(attn_impl)
    decode = lm_lib.make_decode_step()
    t0 = _now(prompts.device)
    logits_last, cache = prefill(model, prompts)
    cache = lm_lib.grow_cache(model.b, cache, prompts.shape[1] + gen,
                              mesh=model.mesh)
    tok = logits_last[:, :model.cfg.vocab].argmax(dim=-1)[:, None]
    t1 = _now(prompts.device)
    out = [tok]
    for _ in range(gen):
        tok, cache = decode(model, cache, tok)
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    t2 = _now(prompts.device)
    return Generation(tokens=tokens, logits_last=logits_last,
                      prefill_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
                      steps=gen)


def param_bytes(cfg: LMConfig | tfm.BuiltLM) -> int:
    """The bytes of a whole model's weights at the build's padded
    dimensions (a config: ``tp=1``)."""
    meta = tfm.LM(cfg, device="meta")
    return sum(p.numel() * p.element_size() for p in meta.parameters())


def check_fits(cfg: LMConfig | tfm.BuiltLM, device: torch.device) -> None:
    """Raise ``RuntimeError`` when the weights alone (padded, for a
    ``BuiltLM``) exceed the free memory of the CUDA ``device``."""
    if device.type != "cuda":
        return
    cfg, need = tfm.as_built(cfg).cfg, param_bytes(cfg)
    free, _ = torch.cuda.mem_get_info(device)
    if need > free:
        raise RuntimeError(
            f"{cfg.name}: {need / 2**30:.1f} GiB of {cfg.param_dtype} "
            f"weights do not fit the {free / 2**30:.1f} GiB free on "
            f"{device}; a model of this size needs the multi-card model "
            f"path (ROADMAP.md)")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens per prompt (the prefill's, then N - 1 "
                         "decode steps)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs the plain versions")
    ap.add_argument("--attn-impl", default="cuda", choices=IMPLS,
                    help="the prefill's attention")
    ap.add_argument("--tp", type=int, default=None,
                    help="the tensor-parallel degree the model is padded "
                         "to (default: 1 with --smoke, else 16)")
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.gen < 1:
        ap.error("--gen must be at least 1")

    cfg = get_arch(args.arch)
    if not isinstance(cfg, LMConfig):
        raise SystemExit("serve only applies to LM archs")
    device = resolve_device(args.device)
    cfg = cfg.smoke() if args.smoke else cfg
    b = tfm.build(cfg, default_tp(args))
    check_fits(b, device)
    gen = torch.Generator(device).manual_seed(args.seed)
    model = tfm.init_lm(b, gen)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    res = generate(model, prompts, args.gen - 1, attn_impl=args.attn_impl)
    n = args.batch * args.prompt_len
    print(f"{cfg.name} on {device}: {cfg.param_count_analytic() / 1e9:.2f} B "
          f"parameters, {cfg.param_dtype}, prefill attention "
          f"{args.attn_impl}; tp={b.tp} ({b.n_heads_p} q / {b.n_kv_heads_p} "
          f"kv heads, vocab {b.vocab_p}"
          + (f", {b.e_pad} experts" if b.e_pad else "") + ")")
    print(f"prefill: {res.prefill_ms:.1f} ms for {args.batch}x"
          f"{args.prompt_len} ({n / res.prefill_ms * 1e3:.0f} tokens/s)")
    print(f"decode:  {res.decode_ms_per_step:.2f} ms per step over "
          f"{res.steps} steps ({res.steps * args.batch / max(res.decode_ms, 1e-9) * 1e3:.1f} "
          f"tokens/s)")
    if device.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    print(f"generated {res.tokens.shape[1]} tokens per prompt")
    print("sample generations (token ids):")
    for row in res.tokens[:2].tolist():
        print("  ", row[:16])
    if not bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise RuntimeError("generated a token outside the vocabulary")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

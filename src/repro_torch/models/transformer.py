"""Decoder-only transformer, dense and MoE, for serving and training
(``repro.models.transformer``), on one process or split over ranks.

Serves and trains the LMs of :mod:`repro_torch.configs`: chatglm3-6b (GQA
kv=2, 2d/partial RoPE), qwen1.5-4b (QKV bias, MHA), command-r-plus-104b
(GQA kv=8), dbrx-132b (MoE 16e top-4) and granite-moe-3b-a800m (MoE 40e
top-8, head dim 64).  Weights keep ``repro``'s ``x @ W`` orientation and
names, one :class:`Block` per layer (a MoE layer's experts under
``moe.*``), so :func:`repro_torch.interop.lm_params_from_numpy` carries a
``repro`` param tree across unchanged.

Tensor parallelism.  :func:`build` pads heads, the vocabulary and the
experts to the tensor-parallel degree ``tp`` as ``repro``'s ``build`` does
(KV heads padded and split when there are at least ``tp`` of them, else
replicated; q heads grown until the KV heads divide them; padded weights
zero, the padded vocabulary masked in the loss and in the greedy pick,
padded experts masked in routing).  Padding can change the GQA grouping
(granite at ``tp=16``: 24 q heads become 32 over 8 replicated KV heads, a
group of 4 for 3), and the port computes what ``repro`` computes at the
same ``tp``.  An :class:`LM` built without a mesh holds the padded weights
whole in one process: ``repro``'s CLIs, which build at ``tp=16`` on one
device.  Built on a :class:`~repro_torch.distributed.comm.Mesh`
(``mesh=``), a rank holds only its slices, :func:`param_specs` cut to the
mesh (:func:`named_param_specs`; :func:`repro_torch.launch.mesh.shard_lm`
cuts a whole model), and the collectives that XLA derives from
``repro``'s ``constrain`` calls are explicit (Megatron's schedule):

- FSDP: a weight split over data axes on its ``FSDP`` dimension is
  all-gathered over the axes its own spec names (``pod`` and ``data`` by
  :func:`param_specs`, ``data`` alone on a pipeline stage cut by
  ``pipeline.stage_layer_specs``) before use; its gradient comes back
  reduce-scattered (the all-gather's transpose);
- attention: each rank's q heads (and its KV heads when they are split;
  else the replicated KV heads its q heads read), ``out @ wo`` summed over
  ``model``; the dense FFN: ``d_ff`` split over ``model``, ``h @ w_down``
  summed; the MoE FFN: :func:`repro_torch.models.moe.moe_block`;
- sequence parallelism where ``repro`` uses it (``S % tp == 0`` and
  ``S > 1``): the residual is split on the sequence over ``model``; each
  entry norm's output is all-gathered along it and each block's partial
  output reduce-scattered back onto it;
- the embedding ``P(TP, FSDP)``: each rank looks up the ids in its rows,
  the rows are summed over ``model`` (reduce-scattered under sequence
  parallelism); :meth:`LM.unembed` gives this rank's slice of the
  vocabulary;
- decode: the cache's sequence axis is split over ``model``
  (:func:`cache_specs`); the rank that owns ``pos`` writes the token's
  K/V, every rank attends over its own positions for every q head, and the
  partial softmaxes are merged across ``model``.

The parameters are created with ``requires_grad=False``, so serving builds
no graph; :func:`repro_torch.models.lm.init_train_state` turns grad on.
Under grad, with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (``repro``'s ``jax.checkpoint`` of the scan
body).  Decode runs against a bf16 cache (:meth:`LM.decode_step`) or an
int8 one (:meth:`LM.decode_step_quant`, :mod:`repro_torch.models.kvcache`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import LMConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec as P
from repro_torch.distributed.comm import (axis_sizes, entry_axes,
                                          filter_spec, local_shape)
from repro_torch.models import kvcache
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (attention, decode_split,
                                          merge_partials, rotary)
from repro_torch.models.common import (FSDP, TP, dense_init, mesh_axes,
                                       mesh_sizes, pad_to, split_keys)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class BuiltLM:
    """A config and its dimensions padded to the tensor-parallel degree
    ``tp`` (``repro``'s ``BuiltLM``)."""

    cfg: LMConfig
    tp: int
    n_heads_p: int
    n_kv_heads_p: int
    vocab_p: int
    e_pad: int  # padded experts (0 if dense)

    @property
    def kv_sharded(self) -> bool:
        return self.n_kv_heads_p % self.tp == 0 and \
            self.n_kv_heads_p >= self.tp


def build(cfg: LMConfig, tp: int = 1) -> BuiltLM:
    """``repro``'s padding rule, verbatim."""
    n_heads_p = pad_to(cfg.n_heads, tp)
    # KV heads: shard when >= tp (pad up), replicate when smaller.
    n_kv_p = pad_to(cfg.n_kv_heads, tp) if cfg.n_kv_heads >= tp \
        else cfg.n_kv_heads
    # Query grouping must divide padded kv heads evenly.
    while n_heads_p % n_kv_p:
        n_heads_p += tp if n_heads_p % tp == 0 else 1
    vocab_p = pad_to(cfg.vocab, tp)
    e_pad = pad_to(cfg.moe.n_experts, tp) if cfg.moe else 0
    return BuiltLM(cfg=cfg, tp=tp, n_heads_p=n_heads_p, n_kv_heads_p=n_kv_p,
                   vocab_p=vocab_p, e_pad=e_pad)


def as_built(cfg: LMConfig | BuiltLM) -> BuiltLM:
    """A :class:`BuiltLM` as it is; a config built at ``tp=1``."""
    return cfg if isinstance(cfg, BuiltLM) else build(cfg, 1)


def param_specs(b: BuiltLM) -> dict:
    """``repro``'s PartitionSpecs (FSDP over the data axes x TP over
    ``model``), for its param tree (layers stacked ``[L, ...]``)."""
    cfg = b.cfg
    kv = TP if b.kv_sharded else None
    specs: dict = {
        "embed": P(TP, FSDP),
        "final_norm": P(None),
        "layers": {
            "attn_norm": P(None, None),
            "ffn_norm": P(None, None),
            "wq": P(None, FSDP, TP),
            "wk": P(None, FSDP, kv),
            "wv": P(None, FSDP, kv),
            "wo": P(None, TP, FSDP),
        },
    }
    if cfg.qkv_bias:
        specs["layers"]["bq"] = P(None, TP)
        specs["layers"]["bk"] = P(None, kv)
        specs["layers"]["bv"] = P(None, kv)
    if cfg.moe is not None:
        specs["layers"]["moe"] = {
            "router": P(None, None, None),
            "w_gate": P(None, TP, FSDP, None),
            "w_up": P(None, TP, FSDP, None),
            "w_down": P(None, TP, None, FSDP),
        }
    else:
        specs["layers"]["w_gate"] = P(None, FSDP, TP)
        specs["layers"]["w_up"] = P(None, FSDP, TP)
        specs["layers"]["w_down"] = P(None, TP, FSDP)
    if not cfg.tie_embeddings:
        specs["head"] = P(FSDP, TP)
    return specs


def _layer_specs(layers: dict, stacked: bool = False) -> dict:
    """One layer's specs from a spec tree's ``layers`` entry, keyed as its
    parameters (``moe.*`` for the experts): the stacking dimension dropped,
    or with ``stacked`` kept (the stacked leaf's spec, which names the
    axes the layer axis is split over as well)."""
    out = {}
    for key, spec in layers.items():
        sub = spec.items() if key == "moe" else ((None, spec),)
        for name, s in sub:
            out[key if name is None else f"moe.{name}"] = (
                s if stacked else P(*s[1:]))
    return out


def named_param_specs(b: BuiltLM, specs: dict | None = None,
                      stacked: bool = False) -> dict:
    """A spec tree (default :func:`param_specs`) keyed as
    ``LM.named_parameters()``; a layer's specs as :func:`_layer_specs`
    gives them (``stacked``: each the stacked leaf's)."""
    top = specs if specs is not None else param_specs(b)
    out = {k: v for k, v in top.items() if k != "layers"}
    layer = _layer_specs(top["layers"], stacked)
    for i in range(b.cfg.n_layers):
        out.update({f"layers.{i}.{k}": s for k, s in layer.items()})
    return out


def _layer_shapes(b: BuiltLM) -> dict:
    """One layer's whole (padded) shapes, the MoE's apart, in parameter
    order."""
    cfg = b.cfg
    d, dh = cfg.d_model, cfg.head_dim
    q_w, kv_w = b.n_heads_p * dh, b.n_kv_heads_p * dh
    shapes = {"attn_norm": (d,), "ffn_norm": (d,), "wq": (d, q_w),
              "wk": (d, kv_w), "wv": (d, kv_w), "wo": (q_w, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(q_w,), bk=(kv_w,), bv=(kv_w,))
    if cfg.moe is None:
        shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff),
                      w_down=(cfg.d_ff, d))
    return shapes


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def gathered(w: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """``w`` (a rank's slice) with its FSDP dimensions whole: each one that
    ``spec`` splits over data axes is all-gathered over them (its
    gradient reduce-scattered back); dimensions split over ``model`` stay
    split."""
    if mesh is None:
        return w
    for d, entry in enumerate(filter_spec(spec, mesh.axis_names)):
        if entry is not None and "model" not in entry_axes(entry):
            w = comm.all_gather(w, entry, dim=d, tiled=True, mesh=mesh)
    return w


def _from_residual(h: torch.Tensor, mesh, sp: bool) -> torch.Tensor:
    """A normed residual with the whole sequence: all-gathered along it
    over ``model`` under sequence parallelism."""
    tp = mesh_axes(mesh, TP)
    if not (sp and tp):
        return h
    return comm.all_gather(h, tp, dim=1, tiled=True, mesh=mesh)


def _to_residual(y: torch.Tensor, mesh, sp: bool) -> torch.Tensor:
    """A block's partial output (each rank's heads or columns) summed over
    ``model`` onto the residual's layout: reduce-scattered along the
    sequence under sequence parallelism, else all-reduced."""
    tp = mesh_axes(mesh, TP)
    if not tp:
        return y
    if sp:
        return comm.reduce_scatter(y, tp, dim=1, mesh=mesh)
    return comm.psum(y, tp, mesh=mesh)


def seq_parallel(mesh, s: int) -> bool:
    """``repro``'s rule: the residual is split on the sequence when
    ``S % tp == 0 and S > 1`` (``tp`` the mesh's ``model`` size); never
    without a mesh."""
    return mesh is not None and s % mesh_sizes(mesh)[1] == 0 and s > 1


def _kv_pick(b: BuiltLM, mesh):
    """The replicated KV heads this rank's q heads read: a slice when they
    form whole GQA groups, else one index per q head (a group of 1).  None
    when the rank's KV heads are its q heads' (split KV heads, or one
    rank)."""
    _, tp = mesh_sizes(mesh)
    if tp == 1 or b.kv_sharded:
        return None
    j = mesh.axis_index(mesh_axes(mesh, TP))
    n = b.n_heads_p // tp
    g = b.n_heads_p // b.n_kv_heads_p
    ids = [(j * n + i) // g for i in range(n)]
    count = ids[-1] - ids[0] + 1
    if n % count == 0 and ids == [ids[0] + i // (n // count)
                                  for i in range(n)]:
        return slice(ids[0], ids[0] + count)
    return ids


class MoE(nn.Module):
    """A layer's experts and router (``repro``'s ``layers/moe/*`` keys),
    ``b.e_pad`` experts of which the config's are real; the router is f32
    whatever the model's dtype.  On a mesh this rank's slice by ``specs``
    (a layer's, by name; default
    :data:`~repro_torch.models.moe.PARAM_SPECS`), whose ``w_gate`` entry
    names the FSDP axes the experts are gathered over."""

    def __init__(self, b: BuiltLM, dtype: torch.dtype, device: torch.device,
                 mesh=None, specs: dict | None = None):
        super().__init__()
        self.spec, self.mesh = b.cfg.moe, mesh
        specs = specs if specs is not None else moe_lib.PARAM_SPECS
        self.fsdp = mesh_axes(mesh, entry_axes(specs["w_gate"][1]))
        shapes = moe_lib.param_shapes(b.cfg.d_model, self.spec, b.e_pad)
        for name, shape in shapes.items():
            setattr(self, name, _param(
                local_shape(shape, specs[name], axis_sizes(mesh)),
                torch.float32 if name == "router" else dtype, device))

    def forward(self, x: torch.Tensor, sp: bool = False
                ) -> tuple[torch.Tensor, dict]:
        """x: the residual's block [B, S, D] (split on the sequence with
        ``sp``) -> (y in the same block, aux)."""
        params = {name: getattr(self, name) for name in moe_lib.PARAMS}
        return moe_lib.moe_block(params, x, self.spec, self.spec.n_experts,
                                 self.mesh, seq_parallel=sp, fsdp=self.fsdp)


class Block(nn.Module):
    """One layer: RMSNorm -> GQA attention -> residual -> RMSNorm ->
    SwiGLU FFN (dense, or :class:`MoE`) -> residual.  Parameter names are
    ``repro``'s layer keys; on a mesh each is this rank's slice."""

    def __init__(self, b: BuiltLM, dtype: torch.dtype, device: torch.device,
                 mesh=None, specs: dict | None = None):
        super().__init__()
        self.b, self.cfg, self.mesh = b, b.cfg, mesh
        self.specs = specs if specs is not None else _layer_specs(
            param_specs(b)["layers"])
        for name, shape in _layer_shapes(b).items():
            setattr(self, name, _param(
                local_shape(shape, self.specs[name], axis_sizes(mesh)),
                dtype, device))
        if b.cfg.moe is not None:
            self.moe = MoE(b, dtype, device, mesh, {
                k[len("moe."):]: v for k, v in self.specs.items()
                if k.startswith("moe.")})
        self.kv_pick = _kv_pick(b, mesh) if mesh is not None else None

    def _w(self, name: str) -> torch.Tensor:
        return gathered(getattr(self, name), self.specs[name], self.mesh)

    def _qkv(self, x, positions):
        """This step's rotated q [B, S, Hq, Dh] and k, v [B, S, Hkv, Dh]:
        the heads this rank holds."""
        cfg = self.cfg
        bsz, s, _ = x.shape
        dh = cfg.head_dim
        q, k, v = x @ self._w("wq"), x @ self._w("wk"), x @ self._w("wv")
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = rotary(q.reshape(bsz, s, -1, dh), positions, cfg.rotary_pct,
                   cfg.rope_theta)
        k = rotary(k.reshape(bsz, s, -1, dh), positions, cfg.rotary_pct,
                   cfg.rope_theta)
        return q, k, v.reshape(bsz, s, -1, dh)

    def _read(self, kv: torch.Tensor) -> torch.Tensor:
        """The KV heads this rank's q heads read (contiguous, as the flash
        kernel takes them)."""
        if self.kv_pick is None:
            return kv
        if isinstance(self.kv_pick, slice):
            return kv[:, :, self.kv_pick].contiguous()
        return kv[:, :, self.kv_pick]

    def _all_heads(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """``t`` [B, S, H, Dh] with all ``n`` heads: gathered over
        ``model`` when this rank holds a slice of them."""
        if t.shape[2] == n:
            return t
        return comm.all_gather(t, mesh_axes(self.mesh, TP), dim=2,
                               tiled=True, mesh=self.mesh)

    def _my_heads(self, out: torch.Tensor, n_local: int) -> torch.Tensor:
        """This rank's ``n_local`` q heads of ``out`` [B, S, Hq, Dh]."""
        if out.shape[2] == n_local:
            return out
        j = self.mesh.axis_index(mesh_axes(self.mesh, TP))
        return out[:, :, j * n_local:(j + 1) * n_local]

    def _decode_split(self, q, k, v, cache_kv, pos: int, seq_axes
                      ) -> torch.Tensor:
        """Attention of this step's queries over a cache split on the
        sequence over ``seq_axes`` ([B, Smax / n, Hkv, Dh] here): the
        owner of each new position writes its K/V (every KV head), every
        rank attends over its own positions with every q head, each row's
        max and sum reduced across ``seq_axes`` before its probabilities
        round (:func:`decode_split`).  Returns this rank's heads'
        output."""
        b, mesh = self.b, self.mesh
        seq = mesh_axes(mesh, seq_axes)
        k_cache, v_cache = cache_kv
        c, s = k_cache.shape[1], q.shape[1]
        lo = mesh.axis_index(seq) * c if seq else 0
        k = self._all_heads(k, b.n_kv_heads_p)
        v = self._all_heads(v, b.n_kv_heads_p)
        a, z = max(pos, lo), min(pos + s, lo + c)
        if z > a:
            k_cache[:, a - lo:z - lo] = k[:, a - pos:z - pos]
            v_cache[:, a - lo:z - lo] = v[:, a - pos:z - pos]
        out = decode_split(self._all_heads(q, b.n_heads_p), k_cache, v_cache,
                           q_offset=pos, k_offset=lo, axes=seq, mesh=mesh)
        return self._my_heads(out, q.shape[2])

    def _attn(self, x, positions, cache_kv, cache_pos, attn_impl,
              seq_axes=TP):
        bsz, s, _ = x.shape
        q, k, v = self._qkv(x, positions)
        if cache_kv is not None and self.mesh is not None:
            out = self._decode_split(q, k, v, cache_kv, cache_pos, seq_axes)
            new_kv = cache_kv
        elif cache_kv is not None:
            k_cache, v_cache = cache_kv
            k_cache[:, cache_pos:cache_pos + s] = k
            v_cache[:, cache_pos:cache_pos + s] = v
            # Positions past the current one are masked by q_offset.
            out = attention(q, k_cache, v_cache, q_offset=cache_pos,
                            impl=attn_impl)
            new_kv = (k_cache, v_cache)
        else:
            out = attention(q, self._read(k), self._read(v), impl=attn_impl)
            new_kv = (k, v)
        return out.reshape(bsz, s, -1) @ self._w("wo"), new_kv

    def _ffn(self, h, sp: bool) -> tuple[torch.Tensor, dict]:
        """The FFN of the normed residual ``h`` (its block), in the
        residual's layout."""
        if self.cfg.moe is not None:
            return self.moe(h, sp)
        h = _from_residual(h, self.mesh, sp)
        y = (F.silu(h @ self._w("w_gate")) * (h @ self._w("w_up"))) \
            @ self._w("w_down")
        return _to_residual(y, self.mesh, sp), {}

    def forward(self, x, positions, cache_kv=None, cache_pos: int = 0,
                attn_impl: str = "auto", sp: bool = False, seq_axes=TP):
        """x [B, S, D] (split on the sequence over ``model`` with ``sp``)
        -> (x, (k, v), aux); with ``cache_kv`` = (k_cache, v_cache) [B,
        Smax, Hkv, Dh] (on a mesh this rank's positions over
        ``seq_axes``) this step's K/V are written into the caches in place
        at ``cache_pos``.  ``aux`` is the MoE layer's (``{}`` for a dense
        one)."""
        eps = self.cfg.norm_eps
        h = _from_residual(rms_norm(x, self.attn_norm, eps), self.mesh, sp)
        attn_out, new_kv = self._attn(h, positions, cache_kv, cache_pos,
                                      attn_impl, seq_axes)
        x = x + _to_residual(attn_out, self.mesh, sp)
        ffn_out, aux = self._ffn(rms_norm(x, self.ffn_norm, eps), sp)
        return x + ffn_out, new_kv, aux

    def decode_quant(self, x, positions, cache_q, pos: int, chunk: int):
        """One token against this layer's int8 cache ``cache_q`` = (k_q,
        k_s, v_q, v_s) [B, Smax, Hkv, *] (on a mesh this rank's positions):
        the token's K/V are quantized and written in place at ``pos`` (on
        a mesh by the rank that holds it, every KV head), then every rank
        attends over its positions with every q head and the partial
        softmaxes are merged across ``model``."""
        cfg, mesh = self.cfg, self.mesh
        tp = mesh_axes(mesh, TP)
        bsz = x.shape[0]
        q, k, v = self._qkv(rms_norm(x, self.attn_norm, cfg.norm_eps),
                            positions)
        k_q, k_s, v_q, v_s = cache_q
        lo = mesh.axis_index(tp) * k_q.shape[1] if tp else 0
        k = self._all_heads(k, self.b.n_kv_heads_p)
        v = self._all_heads(v, self.b.n_kv_heads_p)
        if lo <= pos < lo + k_q.shape[1]:
            at = slice(pos - lo, pos - lo + 1)
            k_q[:, at], k_s[:, at] = kvcache.quantize_kv(k)
            v_q[:, at], v_s[:, at] = kvcache.quantize_kv(v)
        attn = self._my_heads(merge_partials(
            *kvcache.decode_partial_quant(
                self._all_heads(q, self.b.n_heads_p), k_q, k_s, v_q, v_s,
                pos - lo, chunk=chunk, axes=tp, mesh=mesh),
            tp, mesh, q.dtype), q.shape[2])
        attn = attn.reshape(bsz, 1, -1) @ self._w("wo")
        x = x + _to_residual(attn, mesh, False)
        ffn_out, _ = self._ffn(rms_norm(x, self.ffn_norm, cfg.norm_eps),
                               False)
        return x + ffn_out


class LM(nn.Module):
    """Embedding, ``n_layers`` :class:`Block` s, final norm, head, at the
    padded dimensions of a :class:`BuiltLM` (a config: ``tp=1``).  With
    ``mesh`` each parameter is this rank's slice by ``specs``, a spec tree
    in ``repro``'s layout (default :func:`param_specs`;
    :func:`repro_torch.models.pipeline.stage_layer_specs` for a pipeline
    stage), and the forward runs the collectives; without, the model is
    whole in one process.  The tree chooses the axes: each weight is
    gathered over the data axes of its own spec, and the batch's data
    axes (:attr:`data_axes`) are the embedding's FSDP entry's.  The
    parameters are allocated, not initialised: use :func:`init_lm`,
    ``load_state_dict`` or :func:`repro_torch.launch.mesh.shard_lm`."""

    def __init__(self, cfg: LMConfig | BuiltLM,
                 device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None, mesh=None,
                 specs: dict | None = None):
        super().__init__()
        b = as_built(cfg)
        cfg = b.cfg
        dev = resolve_device(device)
        dtype = dtype or DTYPES[cfg.param_dtype]
        self.b, self.cfg, self.mesh = b, cfg, mesh
        self.specs = specs if specs is not None else param_specs(b)
        specs, sizes = self.specs, axis_sizes(mesh)
        self.embed = _param(local_shape((b.vocab_p, cfg.d_model),
                                        specs["embed"], sizes), dtype, dev)
        self.final_norm = _param((cfg.d_model,), dtype, dev)
        if not cfg.tie_embeddings:
            self.head = _param(local_shape((cfg.d_model, b.vocab_p),
                                           specs["head"], sizes), dtype, dev)
        layer = _layer_specs(specs["layers"])
        self.layers = nn.ModuleList(Block(b, dtype, dev, mesh, layer)
                                    for _ in range(cfg.n_layers))

    @property
    def data_axes(self) -> tuple[str, ...]:
        """The mesh axes the batch's rows are split over: those of the
        embedding's FSDP entry (``pod`` and ``data``, or ``data`` alone on
        a pipeline stage); ``()`` without a mesh."""
        return mesh_axes(self.mesh, entry_axes(self.specs["embed"][1]))

    def named_specs(self, stacked: bool = False) -> dict:
        """:func:`named_param_specs` of this model's spec tree."""
        return named_param_specs(self.b, self.specs, stacked)

    def vocab_offset(self) -> int:
        """The first vocabulary entry of this rank's slice."""
        _, tp = mesh_sizes(self.mesh)
        if tp == 1:
            return 0
        return self.mesh.axis_index(mesh_axes(self.mesh, TP)) * \
            (self.b.vocab_p // tp)

    def _embed(self, tokens: torch.Tensor, sp: bool) -> torch.Tensor:
        """tokens [B, S] -> the residual [B, S, D] (its sequence block with
        ``sp``): each rank looks up the ids among its rows of the table,
        zero elsewhere, and the rows are summed over ``model``."""
        table = gathered(self.embed, self.specs["embed"], self.mesh)
        if not mesh_axes(self.mesh, TP):
            return F.embedding(tokens, table)
        rows = table.shape[0]
        local = tokens - self.vocab_offset()
        inside = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), table)
        x = torch.where(inside[..., None], x, torch.zeros_like(x))
        return _to_residual(x, self.mesh, sp)

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None,
                return_cache: bool = False, attn_impl: str = "auto"):
        """Prefill forward: tokens [B, S] (on a mesh this rank's rows of
        the batch) -> (final hidden [B, S, D], cache (k, v) each [L, B, S,
        Hkv, Dh] or None, aux).  On a mesh the hidden state is whole on
        every rank of ``model`` and the cache holds this rank's KV heads
        (every KV head when they are replicated): ``cache_specs(b,
        decode_seq_shard=False)``.  ``aux`` holds ``load_balance`` and
        ``router_z``, each the mean over layers (0 for a dense model).
        Logits are not formed here: :meth:`unembed` the positions that need
        them.  Under grad with ``cfg.remat`` each layer is checkpointed
        (its activations recomputed in the backward)."""
        bsz, s = tokens.shape
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(bsz, s)
        sp = seq_parallel(self.mesh, s)
        x = self._embed(tokens, sp)
        ks, vs, lb, rz = [], [], [], []
        zero = torch.zeros((), device=x.device)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x, (k, v), aux = checkpoint(layer, x, positions,
                                            attn_impl=attn_impl, sp=sp,
                                            use_reentrant=False)
            else:
                x, (k, v), aux = layer(x, positions, attn_impl=attn_impl,
                                       sp=sp)
            if return_cache:
                ks.append(k)
                vs.append(v)
            lb.append(aux.get("load_balance", zero))
            rz.append(aux.get("router_z", zero))
        x = _from_residual(rms_norm(x, self.final_norm, self.cfg.norm_eps),
                           self.mesh, sp)
        aux = {"load_balance": torch.stack(lb).mean(),
               "router_z": torch.stack(rz).mean()}
        return x, ((torch.stack(ks), torch.stack(vs)) if return_cache
                   else None), aux

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """hidden [..., D] -> f32 logits [..., vocab_p] (on a mesh this
        rank's slice of the vocabulary, from :meth:`vocab_offset`)."""
        if self.cfg.tie_embeddings:
            head = gathered(self.embed, self.specs["embed"], self.mesh).T
        else:
            head = gathered(self.head, self.specs["head"], self.mesh)
        return (x @ head.to(x.dtype)).float()

    def _positions(self, cache: dict, key: str, seq_axes=TP) -> int:
        """The cache's length (every rank's positions together)."""
        if self.mesh is None:
            return cache[key].shape[2]
        return cache[key].shape[2] * self.mesh.axis_size(
            mesh_axes(self.mesh, seq_axes))

    def decode_step(self, cache: dict, tokens: torch.Tensor,
                    attn_impl: str = "auto", seq_axes=TP
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode: tokens [B, 1] + cache -> (logits [B, 1, V],
        cache).  The token's K/V go into ``cache["k"]``/``cache["v"]`` in
        place (``repro`` returns new arrays); ``pos`` advances by one.  On
        a mesh the cache is :func:`cache_specs`' with its sequence over
        ``seq_axes`` (this rank's positions; :func:`decode_layout`) and
        the logits this rank's vocabulary slice."""
        pos = int(cache["pos"])
        if pos >= self._positions(cache, "k", seq_axes):
            raise ValueError(f"KV cache full: position {pos} of "
                             f"{self._positions(cache, 'k', seq_axes)}")
        bsz = tokens.shape[0]
        positions = torch.full((bsz, 1), pos, device=tokens.device)
        x = self._embed(tokens, False)
        for i, layer in enumerate(self.layers):
            x, _, _ = layer(x, positions,
                            cache_kv=(cache["k"][i], cache["v"][i]),
                            cache_pos=pos, attn_impl=attn_impl,
                            seq_axes=seq_axes)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.unembed(x), {"k": cache["k"], "v": cache["v"],
                                 "pos": pos + 1}

    def decode_step_quant(self, cache: dict, tokens: torch.Tensor,
                          chunk: int = 2048) -> tuple[torch.Tensor, dict]:
        """One-token decode against an int8 cache
        (:func:`~repro_torch.models.kvcache.init_cache_quant`): tokens
        [B, 1] -> (logits [B, 1, V], cache).  The token's quantized K/V go
        into the cache in place; ``pos`` advances by one.  The cache length
        (on a mesh, each rank's) must be a multiple of ``chunk``."""
        pos = int(cache["pos"])
        if pos >= self._positions(cache, "k_q"):
            raise ValueError(f"KV cache full: position {pos} of "
                             f"{self._positions(cache, 'k_q')}")
        bsz = tokens.shape[0]
        positions = torch.full((bsz, 1), pos, device=tokens.device)
        x = self._embed(tokens, False)
        for i, layer in enumerate(self.layers):
            x = layer.decode_quant(
                x, positions, tuple(cache[n][i] for n in
                                    ("k_q", "k_s", "v_q", "v_s")), pos, chunk)
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        return self.unembed(x), {**cache, "pos": pos + 1}


def _zpad(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` zero-padded at the end of each dimension to ``shape``."""
    if tuple(x.shape) == tuple(shape):
        return x
    out = x.new_zeros(shape)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


@torch.no_grad()
def init_lm(cfg: LMConfig | BuiltLM, generator: torch.Generator) -> LM:
    """An :class:`LM` (whole, no mesh) on ``generator``'s device with
    random weights drawn as ``repro``'s ``init_params`` draws them: normal
    x 1/sqrt(fan_in), embedding x 0.02, norms one, biases zero; a MoE
    router in f32.  Each weight is drawn at the config's width and then
    zero-padded to the :class:`BuiltLM`'s, so the real part equals
    ``tp=1``'s draw (``repro`` draws its embedding, head and experts at
    the padded width)."""
    b = as_built(cfg)
    cfg = b.cfg
    dtype = DTYPES[cfg.param_dtype]
    model = LM(b, device=generator.device, dtype=dtype)
    d, dh = cfg.d_model, cfg.head_dim
    q_w, kv_w = cfg.n_heads * dh, cfg.n_kv_heads * dh
    ks = split_keys(generator, ["embed", "head", "wq", "wk", "wv", "wo",
                                "ffn", "moe"])
    model.embed.copy_(_zpad(dense_init(ks["embed"], (cfg.vocab, d), dtype,
                                       scale=0.02), model.embed.shape))
    model.final_norm.fill_(1)
    if not cfg.tie_embeddings:
        model.head.copy_(_zpad(dense_init(ks["head"], (d, cfg.vocab), dtype),
                               model.head.shape))
    for layer in model.layers:
        for name, key, shape in (("wq", "wq", (d, q_w)),
                                 ("wk", "wk", (d, kv_w)),
                                 ("wv", "wv", (d, kv_w)),
                                 ("wo", "wo", (q_w, d))):
            w = getattr(layer, name)
            w.copy_(_zpad(dense_init(ks[key], shape, dtype), w.shape))
        if cfg.qkv_bias:
            for name in ("bq", "bk", "bv"):
                getattr(layer, name).zero_()
        layer.attn_norm.fill_(1)
        layer.ffn_norm.fill_(1)
        if cfg.moe is not None:
            weights = moe_lib.init_moe(ks["moe"], d, cfg.moe,
                                       cfg.moe.n_experts, dtype)
            for name, w in weights.items():
                p = getattr(layer.moe, name)
                p.copy_(_zpad(w, p.shape))
        else:
            layer.w_gate.copy_(dense_init(ks["ffn"], (d, cfg.d_ff), dtype))
            layer.w_up.copy_(dense_init(ks["ffn"], (d, cfg.d_ff), dtype))
            layer.w_down.copy_(dense_init(ks["ffn"], (cfg.d_ff, d), dtype))
    return model


def cache_specs(b: BuiltLM, decode_seq_shard: bool = True,
                seq_axes=TP, batch_axes=FSDP) -> dict:
    """KV cache shardings (``repro``'s): decode shapes split the sequence
    axis over ``seq_axes`` (the flash-decoding layout), since KV heads are
    few; else the KV heads, where they are split.  The batch is split
    over ``batch_axes`` (None: whole)."""
    seq = seq_axes if decode_seq_shard else None
    kv_heads = None if decode_seq_shard else (TP if b.kv_sharded else None)
    sp = P(None, batch_axes, seq, kv_heads, None)
    return {"k": sp, "v": sp, "pos": P()}


def decode_layout(batch: int) -> tuple:
    """``repro``'s decode cell layout of a batch of ``batch`` sequences:
    (the batch's axes, the cache sequence's axes).  At 32 sequences or
    more the batch is split over the data axes and the sequence over
    ``model``; below, the batch is whole and the sequence is split over
    ``("data", "model")``."""
    if batch >= 32:
        return FSDP, TP
    return None, ("data", "model")


def init_cache(cfg: LMConfig | BuiltLM, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16,
               device: str | torch.device | None = None, mesh=None,
               seq_axes=TP, batch_axes=FSDP) -> dict:
    """A zero KV cache: k, v [L, batch, max_seq, Hkv, Dh] at the padded KV
    heads; pos 0.  On ``mesh``, this rank's slice of it
    (:func:`cache_specs`: the batch over ``batch_axes``, the positions
    over ``seq_axes``)."""
    b = as_built(cfg)
    shape = local_shape((b.cfg.n_layers, batch, max_seq, b.n_kv_heads_p,
                         b.cfg.head_dim),
                        cache_specs(b, True, seq_axes, batch_axes)["k"],
                        axis_sizes(mesh))
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}

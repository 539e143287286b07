"""Step builders, as ``repro.launch.steps``: the train step, prefill and
batched greedy decode as Ripple graphs on the port's ``Graph``/
``Executor``, and the uniform prefill and decode steps of the legacy
loop.

The train step (:func:`make_train_step`) differentiates ``forward_loss``
with autograd, accumulates float32 gradients over ``cfg.microbatches``,
clips them by their global norm and updates the parameters and the
optimizer state in place; on the GPU its forward runs K6 / K7, whose
gradients are their plain versions'.  Given a mesh, an MoE arch's
routed FFNs run expert-parallel (``models/moe.py``'s ``make_moe_a2a``)
where the reference's ``make_ctx`` builds its ``moe_a2a``
(:func:`moe_a2a_for`).

The decode step is a Graph with one node per layer.  Every attention
cache is a *record* DistTensor (fields k, v over the (B, S, Hkv) or (B,
Hkv, S) space), so the executor's layout solver, not the model code,
picks AoS / SoA / AoSoA storage: the node reads the layout off the
RecordArray it is handed and runs the model under it.  The JAX package
memoises the graphs so that a re-built worker hits its executable cache;
here a graph rebuilt over the same ``params`` has the same plan signature
(node closures are keyed by their values, large tensors by identity), so
under ``regions=True`` a re-built worker's decode executor fetches its
captured graph without memoising.  Under ``regions=True`` the decode
nodes take ``out=``: each attention layer writes its token's k/v into its
cache's static buffer in place (a local layer into slot ``pos % W`` of
its ring), each Mamba layer its SSD state, each RG-LRU layer its
recurrent state, and the head the tokens and positions, so no cache is
copied per step.
The sharded specs of the dry run are not ported (ROADMAP "Not ported").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..core.device import resolve_device
from ..core.graph import Graph, in_place
from ..core.layout import RecordArray
from ..core.tensor import DistTensor
from ..models import kvcache as kvc
from ..models.blocks import layer_decode, norm_apply
from ..models.config import ModelConfig
from ..models.lm import (_prefill_to_decode_cache, decode_step,
                         decoder_pass, embed_tokens, forward_loss,
                         lm_logits, prefill)
from ..models.moe import make_moe_a2a
from ..optim import clip_by_global_norm, cosine_schedule, make_optimizer

__all__ = ["CacheSlot", "serving_cache_slots", "DecodeGraph",
           "PrefillGraph", "cache_state_overrides", "make_decode_graph",
           "make_prefill_graph", "make_train_step", "loss_and_grads",
           "moe_a2a_for",
           "make_prefill_step", "make_decode_step", "ENC_LEN_SERVE"]

#: the frozen encoder length of an encoder-decoder's served decode: the
#: frames a request carries, and the cross-cache slots a decode step reads
ENC_LEN_SERVE = 4096


def moe_a2a_for(cfg: ModelConfig, mesh):
    """The expert-parallel MoE FFN that the reference's ``make_ctx``
    builds for a training or prefill shape on ``mesh``, else None: only
    for an MoE arch under the "tp" sharding on a mesh whose "model" axis
    is > 1 and whose "data" size is > 1 and divides the expert count
    (the reference's rules then put the experts on "data").  Its data
    axes are "pod" and "data" where the mesh has them;
    ``cfg.shard_activations`` scatters its output over "model"."""
    if mesh is None or not cfg.n_experts or cfg.train_sharding == "fsdp" \
            or mesh.shape.get("model", 1) <= 1:
        return None
    data = mesh.shape.get("data", 1)
    if data <= 1 or cfg.n_experts % data:
        return None
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return make_moe_a2a(mesh, dp_axes=dp, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor,
                        residual_tp=cfg.shard_activations)


def make_train_step(cfg: ModelConfig, *, lr=None, total_steps: int = 10_000,
                    clip_norm: float = 1.0, device: Any = None, mesh=None):
    """-> ``(train_step, opt)``; ``train_step(state, batch) -> (state,
    metrics)`` with ``state = {"params": module, "opt": opt state,
    "step": int32 scalar tensor}`` on ``device`` (``None``: the GPU),
    updated in place and returned, and ``metrics = {"loss",
    "grad_norm"}`` float32 scalar tensors (no host sync in the step).
    ``batch`` holds ``tokens`` and ``labels`` (numpy arrays or tensors;
    they are moved to ``device``).  The parameters must require grad.
    With ``mesh``, routed FFNs run through :func:`moe_a2a_for`'s
    expert-parallel block where it gives one."""
    dev = resolve_device(device)
    opt = make_optimizer(cfg.optimizer,
                         lr or cosine_schedule(3e-4, 200, total_steps))
    moe_a2a = moe_a2a_for(cfg, mesh)

    def train_step(state, batch):
        params = state["params"]
        batch = {key: torch.as_tensor(v).to(dev, non_blocking=True)
                 for key, v in batch.items()}
        loss, grads = loss_and_grads(params, batch, cfg, moe_a2a=moe_a2a)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        opt.update(grads, state["opt"], params, state["step"])
        state["step"].add_(1)
        return state, {"loss": loss.to(torch.float32),
                       "grad_norm": gnorm.to(torch.float32)}

    return train_step, opt


def loss_and_grads(params, batch, cfg: ModelConfig, *, moe_a2a=None):
    """The train step's objective and its gradients: ``(loss, {parameter
    name: gradient})``.  With ``cfg.microbatches = k > 1`` the batch is
    split into k row blocks, the gradients summed in float32 and divided
    by k, and the loss is the mean of the k losses, as the reference's
    scan; with k = 1 each gradient is in its parameter's dtype.  Routed
    FFNs go through ``moe_a2a`` where given."""
    names, leaves = zip(*params.named_parameters())
    k = cfg.microbatches

    def loss_fn(mb):
        return forward_loss(params, mb, cfg, moe_a2a=moe_a2a)[0]

    if k == 1:
        loss = loss_fn(batch)
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss,
                                                                  leaves)))
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    losses = []
    for i in range(k):
        mb = {key: v.reshape(k, v.shape[0] // k, *v.shape[1:])[i]
              for key, v in batch.items()}
        loss = loss_fn(mb)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g.to(torch.float32))
        losses.append(loss.detach())
    return torch.stack(losses).mean(), {n: a / k for n, a in zip(names, acc)}


def make_prefill_step(cfg: ModelConfig):
    """The legacy loop's prefill: ``prefill_step(params, batch) ->
    (last-token logits, caches)``."""

    def prefill_step(params, batch):
        return prefill(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """The legacy loop's step: ``step(params, caches, tokens) -> (logits,
    caches)``, the whole batch at the caches' one position; an
    encoder-decoder reads ``ENC_LEN_SERVE`` slots of its cross caches."""
    enc_len = ENC_LEN_SERVE if cfg.is_encdec else None

    def step(params, caches, tokens):
        return decode_step(params, caches, tokens, cfg, enc_len=enc_len)

    return step


@dataclass(frozen=True)
class CacheSlot:
    """One decode-cache layer lifted into named executor state tensors.

    ``group``/``part`` address the layer in the cache structure of
    ``models/lm.py`` (``caches["groups"][group]["p{part}"]``; ``group ==
    -1`` is the tail layer ``caches["tail"][part]``).  ``tensors`` is one
    record DistTensor for an attention layer ("A", "L") and two plain
    DistTensors for a state-space layer ("M": SSM state and conv buffer;
    "R": RG-LRU state and conv buffer)."""

    label: str
    kind: str
    group: int
    part: int
    tensors: tuple


def _slot_tensors(cfg: ModelConfig, label: str, kind: str, batch: int,
                  max_seq: int) -> tuple:
    dt = cfg.compute_torch_dtype
    if kind in ("A", "L"):
        S = min(cfg.window, max_seq) if kind == "L" else max_seq
        Hkv = cfg.padded_kv_heads()
        space = ((batch, S, Hkv) if cfg.kv_order == "bsh"
                 else (batch, Hkv, S))
        return (DistTensor(f"kv_{label}", space, dtype=dt,
                           spec=kvc.kv_spec(cfg.head_dim),
                           layout=cfg.kv_layout),)
    if kind == "M":
        H = cfg.padded_ssm_heads()
        P_, N, K = cfg.ssm_head_dim, cfg.ssm_state, cfg.d_conv
        return (DistTensor(f"ssm_{label}", (batch, H, P_, N),
                           dtype=torch.float32),
                DistTensor(f"cv_{label}", (batch, K - 1, H * P_ + 2 * N),
                           dtype=dt))
    if kind == "R":
        R, K = cfg.lru_width, cfg.d_conv
        return (DistTensor(f"rg_{label}", (batch, R), dtype=torch.float32),
                DistTensor(f"cv_{label}", (batch, K - 1, R), dtype=dt))
    raise ValueError(f"unknown layer kind {kind!r}")


def serving_cache_slots(cfg: ModelConfig, batch: int,
                        max_seq: int) -> tuple:
    """Every decode-cache layer as a CacheSlot, in the reference's layer
    order (g0p0, g0p1, ..., g1p0, ..., tail0, ...)."""
    n_groups, pattern, tail = cfg.layer_groups()
    slots = []
    for gi in range(n_groups):
        for pi, kind in enumerate(pattern):
            label = f"g{gi}p{pi}"
            slots.append(CacheSlot(label, kind, gi, pi, _slot_tensors(
                cfg, label, kind, batch, max_seq)))
    for ti, kind in enumerate(tail):
        label = f"t{ti}"
        slots.append(CacheSlot(label, kind, -1, ti, _slot_tensors(
            cfg, label, kind, batch, max_seq)))
    return tuple(slots)


def _slot_params(params, gi: int, pi: int):
    if gi < 0:
        return params[f"tail{pi}"]["layer"]
    return params["groups"][gi][f"p{pi}"]


def _slot_entry(caches, slot: CacheSlot):
    if slot.group < 0:
        return caches["tail"][slot.part]
    return caches["groups"][slot.group][f"p{slot.part}"]


def _guard_graph_serving(cfg: ModelConfig) -> None:
    if cfg.is_encdec or cfg.frontend_dim:
        raise NotImplementedError(
            f"{cfg.name}: graph-native serving covers text-only decoder "
            f"archs; encoder-decoder and VLM archs serve through the "
            f"uniform loop (launch/serve.py's legacy_generate, where "
            f"main sends them)")


def _embed_node(cfg: ModelConfig, params):
    def embed(tokens_t, h_t):
        return embed_tokens(params, tokens_t, cfg)
    return embed


def _outs(out, n: int) -> tuple:
    """A decode node's ``out=`` as one entry per written tensor."""
    return (None,) * n if out is None else out


def _attn_layer_node(cfg: ModelConfig, params, slot: CacheSlot):
    gi, pi, kind = slot.group, slot.part, slot.kind

    @in_place   # the token's k/v land in the cache it reads (index_put_)
    def layer(h_t, kv, pos, out=None):
        # the solver's layout arrives on the RecordArray; run the model
        # under it, so the model code stays layout-polymorphic
        _, kv_out = _outs(out, 2)
        lcfg = cfg.with_(kv_layout=kv.layout)
        h2, store = layer_decode(
            _slot_params(params, gi, pi), h_t, kind, lcfg, cache=kv.data,
            pos=pos, cache_out=None if kv_out is None else kv_out.data)
        return h2, RecordArray(store, kv.spec, kv.layout)

    return layer


def _state_layer_node(cfg: ModelConfig, params, slot: CacheSlot):
    gi, pi, kind = slot.group, slot.part, slot.kind

    @in_place   # the SSD / RG-LRU state is read, then written, element by
    # element
    def layer(h_t, s0, s1, pos, out=None):
        _, s0_out, _ = _outs(out, 3)
        h2, (n0, n1) = layer_decode(_slot_params(params, gi, pi), h_t, kind,
                                    cfg, cache=(s0, s1), pos=pos,
                                    cache_out=(s0_out, None))
        return h2, n0, n1

    return layer


def _head_node(cfg: ModelConfig, params):
    @in_place
    def head(h_t, tokens_t, pos, active, out=None):
        tok_out, pos_out = _outs(out, 2)
        hn = norm_apply(params["final"], h_t, cfg, "ln")
        nxt = torch.argmax(lm_logits(params, hn, cfg), dim=-1).to(
            torch.int32)
        nxt = torch.where(active, nxt, tokens_t, out=tok_out)
        return nxt, torch.add(pos, active.to(torch.int32), out=pos_out)
    return head


@dataclass(frozen=True)
class DecodeGraph:
    """Graph + tensor handles for one batched greedy-decode step.

    ``tokens``/``pos``/``active`` are (B,) per-slot vectors (every batch
    slot sits at its own depth; an inactive slot keeps its token and does
    not advance), ``h`` is the (B, d_model) residual scratch, and each
    CacheSlot contributes its cache tensors."""

    graph: Graph
    tokens: DistTensor
    pos: DistTensor
    active: DistTensor
    h: DistTensor
    slots: tuple


@dataclass(frozen=True)
class PrefillGraph:
    """Graph + tensor handles for a single-request (B=1) prefill: writes
    every decode-cache slot (batch 1) and ``first``, the greedy token that
    follows the prompt."""

    graph: Graph
    prompt: DistTensor
    hseq: DistTensor
    hlast: DistTensor
    first: DistTensor
    slots: tuple


def cache_state_overrides(cfg: ModelConfig, slots: tuple, caches) -> dict:
    """Map a ``prefill()``/``init_caches()`` cache structure onto the
    graph state names (``Executor.init_state(**overrides)`` kwargs);
    attention storages go in as RecordArrays in ``cfg.kv_layout``."""
    out = {}
    for slot in slots:
        entry = _slot_entry(caches, slot)
        if slot.kind in ("A", "L"):
            out[slot.tensors[0].name] = RecordArray(
                entry, kvc.kv_spec(cfg.head_dim), cfg.kv_layout)
        else:
            out[slot.tensors[0].name] = entry[0]
            out[slot.tensors[1].name] = entry[1]
    return out


def make_decode_graph(cfg: ModelConfig, params, *, batch: int,
                      max_seq: int) -> DecodeGraph:
    """One greedy-decode step for ``batch`` slots as a Ripple graph: embed
    -> every layer in the reference's order -> final norm, logits and
    argmax, so the token sequence equals the uniform loop's."""
    _guard_graph_serving(cfg)
    tokens = DistTensor("tokens", (batch,), dtype=torch.int32)
    pos = DistTensor("pos", (batch,), dtype=torch.int32)
    active = DistTensor("active", (batch,), dtype=torch.bool)
    h = DistTensor("h", (batch, cfg.d_model), dtype=cfg.compute_torch_dtype)
    slots = serving_cache_slots(cfg, batch, max_seq)
    g = Graph(name=f"decode_{cfg.name}")
    g.then(_embed_node(cfg, params), args=(tokens, h), writes=(1,))
    for slot in slots:
        if slot.kind in ("A", "L"):
            kv, = slot.tensors
            g.then(_attn_layer_node(cfg, params, slot), args=(h, kv, pos),
                   writes=(0, 1))
        else:
            s0, s1 = slot.tensors
            g.then(_state_layer_node(cfg, params, slot),
                   args=(h, s0, s1, pos), writes=(0, 1, 2))
    g.then(_head_node(cfg, params), args=(h, tokens, pos, active),
           writes=(1, 2))
    return DecodeGraph(g, tokens, pos, active, h, slots)


def make_prefill_graph(cfg: ModelConfig, params, *, prompt_len: int,
                       max_seq: int, use_kernel: bool = True
                       ) -> PrefillGraph:
    """B=1 prompt processing as a Ripple graph: embed -> decoder pass
    (emitting every layer's decode-ready cache) -> first-token head.  The
    cache writes are RecordArrays in ``cfg.kv_layout``; the executor
    converts them to whatever layout its solver chose."""
    _guard_graph_serving(cfg)
    dt = cfg.compute_torch_dtype
    prompt = DistTensor("prompt", (1, prompt_len), dtype=torch.int32)
    hseq = DistTensor("hseq", (1, prompt_len, cfg.d_model), dtype=dt)
    hlast = DistTensor("hlast", (1, cfg.d_model), dtype=dt)
    first = DistTensor("first", (1,), dtype=torch.int32)
    slots = serving_cache_slots(cfg, 1, max_seq)
    flat = tuple(t for slot in slots for t in slot.tensors)

    def body(h_, hl_, *cache_vals):
        hh, _, raw = decoder_pass(params, h_, cfg, want_cache=True,
                                  use_kernel=use_kernel)
        outs = []
        for slot in slots:
            store = _prefill_to_decode_cache(
                _slot_entry(raw, slot), slot.kind, cfg, 1, max_seq, dt,
                h_.device)
            if slot.kind in ("A", "L"):
                outs.append(RecordArray(store, kvc.kv_spec(cfg.head_dim),
                                        cfg.kv_layout))
            else:
                outs.extend(store)
        return (hh[:, -1], *outs)

    def head(hl_, first_):
        return torch.argmax(lm_logits(params, hl_, cfg), dim=-1).to(
            torch.int32)

    g = Graph(name=f"prefill_{cfg.name}_s{prompt_len}")
    g.then(_embed_node(cfg, params), args=(prompt, hseq), writes=(1,))
    g.then(body, args=(hseq, hlast, *flat),
           writes=tuple(range(1, 2 + len(flat))))
    g.then(head, args=(hlast, first), writes=(1,))
    return PrefillGraph(g, prompt, hseq, hlast, first, slots)

"""The training step (port of ``repro/train/step.py``): chunked loss,
microbatch accumulation, remat (the model's ``remat``), optional int8
error-feedback gradient compression, gradient clipping and AdamW.

The reference's step is a pure function that jit donates its state to; the
port's runs eagerly on the card and updates the state in place (gradients
clipped in place, then the optimizer's in-place update), which keeps the
peak at the state, one set of gradients and the activations.  Gradients
come from ``torch.autograd.grad`` over detached leaves of the parameter
tree, so the state's tensors never require grad themselves.  Profiler
ranges name the forward (``train_step/forward``), the clipping and the
optimizer's update; the backward is what remains of a step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.autosharding import constrain
from repro_torch.models.transformer import TransformerLM, param_shapes
from repro_torch.optim.adamw import AdamW, OptState, clip_by_global_norm
from repro_torch.pytree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState
    #: int8 error-feedback residual (grad compression), or None
    ef_residual: Optional[Any]


def chunked_cross_entropy(model: TransformerLM, params: Any, hidden: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512) -> torch.Tensor:
    """Token-mean cross entropy without materialising [B, S, V] logits: the
    unembedding and the log-softmax run per chunk of ``min(chunk, S)``
    positions, logits in f32.  Under autograd, with more than one chunk,
    each chunk is checkpointed, so the backward holds one chunk's logits at
    a time."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the loss chunk {chunk}")
    labels = labels.long()

    def one(h, y):
        # Meshed, the chunk's vocab shards are gathered: the gold-label
        # gather reads across them.
        logits = constrain(model.logits(params, h).to(torch.float32),
                           ("batch", "seq", "gathered"))  # [B, c, V]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None])[..., 0]
        return torch.sum(logz - gold)

    run = one
    if s // chunk > 1 and torch.is_grad_enabled():
        def run(h, y):
            return checkpoint(one, h, y, use_reentrant=False)

    totals = [run(h, y) for h, y in zip(hidden.split(chunk, dim=1), labels.split(chunk, dim=1))]
    return torch.sum(torch.stack(totals)) / (b * s)


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression (optional, cross-pod)
# ---------------------------------------------------------------------------


def _ef_compress(g: torch.Tensor, residual: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (g + residual) to int8 with a per-tensor scale; return the
    dequantized gradient (in g's dtype) and the new residual."""
    acc = g.to(torch.float32) + residual
    scale = torch.clamp(torch.max(torch.abs(acc)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(acc / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq.to(g.dtype), acc - deq


def make_loss_fn(model: TransformerLM, *, aux_weight: float = 0.01,
                 loss_chunk: int = 512) -> Callable:
    """loss_fn(params, tokens, labels[, frontend_embeds]) ->
    (loss + aux_weight * aux, (loss, aux))."""
    def loss_fn(params, tokens, labels, frontend_embeds=None):
        hidden, aux = model.forward(params, tokens, frontend_embeds=frontend_embeds,
                                    return_aux=True)
        loss = chunked_cross_entropy(model, params, hidden, labels, chunk=loss_chunk)
        return loss + aux_weight * aux, (loss, aux)

    return loss_fn


def make_grad_fn(model: TransformerLM, *, microbatches: int = 1, aux_weight: float = 0.01,
                 loss_chunk: int = 512) -> Callable:
    """compute_grads(params, tokens, labels[, frontend_embeds]) -> (grads,
    loss, aux): gradients of the loss with respect to every parameter (a
    tree like ``params``; an unused leaf gets zeros).  With microbatches,
    the batch's rows split into equal consecutive parts and the gradients
    accumulate in f32, each divided by their count, as do loss and aux."""
    loss_fn = make_loss_fn(model, aux_weight=aux_weight, loss_chunk=loss_chunk)
    param_axes = model.param_axes()

    def _constrain_grads(grads):
        """Meshed, pin gradients to the parameter placements: the batch
        axes' partial sums become a reduce-scatter onto the FSDP shards."""
        return tree_map(lambda g, ax: constrain(g, ax), grads, param_axes)

    def grads_of(params, tokens, labels, frontend_embeds):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with record_function("train_step/forward"):
            total, (loss, aux) = loss_fn(tree_unflatten(params, leaves), tokens, labels,
                                         frontend_embeds)
        grads = torch.autograd.grad(total, leaves, materialize_grads=True)
        return _constrain_grads(tree_unflatten(params, list(grads))), loss.detach(), aux.detach()

    def compute_grads(params, tokens, labels, frontend_embeds=None):
        if microbatches <= 1:
            return grads_of(params, tokens, labels, frontend_embeds)
        b = tokens.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        mb = b // microbatches
        acc = _constrain_grads(tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                        params))
        loss_acc = aux_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for i in range(microbatches):
            rows = slice(i * mb, (i + 1) * mb)
            fe = (constrain(frontend_embeds[rows], ("batch", "seq", "embed_act"))
                  if frontend_embeds is not None else None)
            grads, loss, aux = grads_of(params, constrain(tokens[rows], ("batch", "seq")),
                                        constrain(labels[rows], ("batch", "seq")), fe)
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g.to(torch.float32) / microbatches)
            del grads
            loss_acc = loss_acc + loss / microbatches
            aux_acc = aux_acc + aux / microbatches
        return acc, loss_acc, aux_acc

    return compute_grads


def make_train_step(model: TransformerLM, optimizer: AdamW, lr_schedule: Callable, *,
                    microbatches: int = 1, grad_clip: float = 1.0, aux_weight: float = 0.01,
                    loss_chunk: int = 512, grad_compression: bool = False) -> Callable:
    """Returns train_step(state, tokens, labels[, frontend_embeds]) ->
    (state, metrics): the same state, updated in place; metrics ``loss``,
    ``aux_loss``, ``grad_norm`` (before clipping) and ``lr`` (the rate of
    this step, read from the step count before it), f32 scalars on the
    device."""
    compute_grads = make_grad_fn(model, microbatches=microbatches, aux_weight=aux_weight,
                                 loss_chunk=loss_chunk)

    def train_step(state: TrainState, tokens, labels, frontend_embeds=None):
        grads, loss, aux = compute_grads(state.params, tokens, labels, frontend_embeds)
        if grad_compression and state.ef_residual is not None:
            deqs = []
            with torch.no_grad():
                for g, r in zip(tree_leaves(grads), tree_leaves(state.ef_residual)):
                    deq, resid = _ef_compress(g, r)
                    r.copy_(resid)
                    deqs.append(deq)
            grads = tree_unflatten(grads, deqs)
        with record_function("train_step/clip"):
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = lr_schedule(state.opt.step)
        with record_function("train_step/adamw"):
            optimizer.update(grads, state.opt, state.params, lr)
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm, "lr": lr}
        return state, metrics

    return train_step


def make_eval_step(model: TransformerLM, *, loss_chunk: int = 512) -> Callable:
    @torch.no_grad()
    def eval_step(params, tokens, labels, frontend_embeds=None):
        hidden = model.forward(params, tokens, frontend_embeds=frontend_embeds)
        return chunked_cross_entropy(model, params, hidden, labels, chunk=loss_chunk)

    return eval_step


def train_state_shapes(model: TransformerLM, optimizer: AdamW, *,
                       grad_compression: bool = False) -> TrainState:
    """The train state's leaves as meta tensors (the dry run's shapes)."""
    specs = tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"),
                     param_shapes(model.cfg))
    f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), specs)
    return TrainState(params=specs, opt=optimizer.init_shapes(specs),
                      ef_residual=f32 if grad_compression else None)


def train_state_axes(model: TransformerLM, optimizer: AdamW, *,
                     grad_compression: bool = False) -> TrainState:
    axes = model.param_axes()
    return TrainState(params=axes, opt=optimizer.state_axes(axes),
                      ef_residual=axes if grad_compression else None)


def init_train_state(model: TransformerLM, optimizer: AdamW, generator: torch.Generator,
                     device=None, *, grad_compression: bool = False) -> TrainState:
    """Random parameters from ``generator`` (on ``device``), the
    optimizer's fresh state, and a zero f32 residual with compression."""
    params = model.init(generator, device)
    resid = (tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params) if grad_compression else None)
    return TrainState(params=params, opt=optimizer.init(params), ef_residual=resid)

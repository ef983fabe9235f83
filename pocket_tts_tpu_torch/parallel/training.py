"""Flow-matching training step for the FlowLM (conditional flow matching +
EOS BCE). Port of pocket_tts_tpu/parallel/training.py.

Objective, as the JAX package's:
  x_t = (1 - t) * noise + t * latent_target;  v* = latent_target - noise
  L = E_t || flow_net(backbone(x_prefix), s=t, t=t, x_t) - v* ||^2  +  BCE(eos)

The parameters are the port's tensor trees with `requires_grad`, updated by
`torch.optim.Adam` with optax's `adam` defaults (betas 0.9 / 0.999, eps
1e-8). On a mesh (parallel/mesh.make_mesh) each process takes its data
rank's block of the batch's rows and, with `n_model` > 1, its model rank's
slice of the backbone (parallel/mesh.shard_transformer_params), whose layers
run Megatron's f/g pair over `model`; the gradients are then averaged over
`data` (the mean of equal local means is the global mean). The products are
torch.matmul: the gemv kernel takes no product that needs a gradient
(ops/gemv.gemv_takes), and the one-shot backbone runs no other kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pocket_tts_tpu_torch.models.flow_lm import FlowLMSpecs, embed_text_tokens
from pocket_tts_tpu_torch.nn.flow_mlp import flow_mlp_apply
from pocket_tts_tpu_torch.nn.transformer import layer_norm, transformer_oneshot
from pocket_tts_tpu_torch.parallel.mesh import data_rows, model_group, shard_transformer_params

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8


class TrainState(NamedTuple):
    params: dict  # leaves with requires_grad (this rank's slice on a mesh)
    optimizer: torch.optim.Adam


def full_sequence_backbone(specs: FlowLMSpecs, params: dict,
                           embeddings: torch.Tensor) -> torch.Tensor:
    """Teacher-forced causal forward over [B, S, D] (one-shot, no KV cache)."""
    h = transformer_oneshot(specs.transformer, params["transformer"], embeddings)
    return layer_norm(h.float(), params["out_norm"]["w"], params["out_norm"]["b"])


def _draw(latents: torch.Tensor, t, noise, generator):
    """t [B, S, 1] ~ U[0, 1), then noise ~ N(0, 1) like latents, from
    `generator`, where the caller gave none."""
    B, S, _ = latents.shape
    if t is None:
        t = torch.rand((B, S, 1), generator=generator, device=latents.device)
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=latents.device)
    return t, noise


def flow_matching_loss(
    specs: FlowLMSpecs,
    params: dict,
    batch: dict,
    *,
    t: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """batch: tokens [B, Tt] int, latents [B, S, ldim], eos_labels [B, S].
    t [B, S, 1] ~ U[0, 1) and noise [B, S, ldim] ~ N(0, 1) are drawn from
    `generator` unless the caller passes them."""
    tokens, latents, eos_labels = batch["tokens"], batch["latents"], batch["eos_labels"]
    B, S, ldim = latents.shape

    text_emb = embed_text_tokens(params, tokens)
    # teacher forcing: BOS then latents[:-1] as inputs
    bos = params["bos_emb"].expand(B, 1, ldim)
    lat_in = torch.cat([bos, latents[:, :-1]], dim=1)
    seq = torch.cat([text_emb, lat_in @ params["input_linear"].T], dim=1)

    h = full_sequence_backbone(specs, params, seq)[:, -S:]  # [B, S, D]

    t, noise = _draw(latents, t, noise, generator)
    x_t = (1.0 - t) * noise + t * latents
    v_star = latents - noise

    cond = h.reshape(B * S, -1)
    pred = flow_mlp_apply(
        specs.flow, params["flow_net"],
        cond, t.reshape(B * S, 1), t.reshape(B * S, 1), x_t.reshape(B * S, ldim),
    ).reshape(B, S, ldim)
    flow_loss = torch.mean(torch.square(pred - v_star))

    eos_logit = (h @ params["out_eos"]["w"].T + params["out_eos"]["b"])[..., 0]
    eos_loss = F.binary_cross_entropy_with_logits(eos_logit, eos_labels)
    return flow_loss + eos_loss


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _trainable(tree):
    if isinstance(tree, dict):
        return {k: _trainable(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(tree.is_floating_point())


def make_train_step(specs: FlowLMSpecs, lr: float, mesh=None) -> tuple[Callable, Callable]:
    """Returns (init, step). `init(params)`: a TrainState over trainable
    copies of a FlowLM param tree (on a mesh, this rank's slice of it).
    `step(state, batch, *, t=None, noise=None, generator=None)`: one Adam
    step on the global batch, returning (state, loss), the loss of the
    whole batch. On a mesh every process passes the whole batch (and t and
    noise, when given, for all of its rows) and takes its data rank's rows;
    a batch that does not split over `data` raises."""
    tp = None if mesh is None else model_group(mesh, tensor_parallel=True)
    if tp is not None:
        specs = dataclasses.replace(specs, transformer=specs.transformer._replace(tp=tp))

    def init(params: dict) -> TrainState:
        if tp is not None:
            params = {**params, "transformer": shard_transformer_params(
                params["transformer"], specs.transformer.num_heads, tp)}
        params = _trainable(params)
        leaves = [p for p in _leaves(params) if p.requires_grad]
        return TrainState(params, torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS,
                                                   eps=ADAM_EPS))

    def step(state: TrainState, batch: dict, *, t=None, noise=None,
             generator: torch.Generator | None = None):
        if mesh is not None:
            if generator is not None:  # the whole batch's draws, as one process makes them
                t, noise = _draw(batch["latents"], t, noise, generator)
            rows = data_rows(batch["latents"].shape[0], mesh)
            batch = {k: v[rows] for k, v in batch.items()}
            t = None if t is None else t[rows]
            noise = None if noise is None else noise[rows]
        state.optimizer.zero_grad(set_to_none=True)
        loss = flow_matching_loss(specs, state.params, batch, t=t, noise=noise,
                                  generator=generator)
        loss.backward()
        loss = loss.detach()
        if mesh is not None and mesh.size(0) > 1:
            group, n = mesh.get_group("data"), mesh.size(0)
            for p in state.optimizer.param_groups[0]["params"]:
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=group)
                    p.grad /= n
            dist.all_reduce(loss, group=group)
            loss /= n
        state.optimizer.step()
        return state, loss

    return init, step

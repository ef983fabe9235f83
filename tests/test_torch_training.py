"""The port's flow-matching training step (parallel/training.py) against the
JAX package's (pocket_tts_tpu/parallel/training.py, optax.adam), CPU, at
tests/test_training_step.py's SPECS, params from PRNGKey(0) and t and noise
from JAX's key split injected on the port's side.

Bars: the loss and every gradient at 1e-5 of the leaf's largest value, and
3 Adam steps' losses at 1e-5 and params at 1e-5 of the largest param (f32,
the same arithmetic summed in another order). Adam divides each element's
update by that element's gradient scale, so an element whose gradient is
near zero (where the two sums' rounding is a large share of it) moves by a
visibly different fraction of the learning rate: 4.9e-6 in one element of
flow_net/res_blocks/ada/w after 3 steps, 2.6e-5 of that leaf's largest
value but 1.7e-6 of the largest param.

The 2x2 mesh (gloo workers, tests/torch_parallel_worker.py: rows over
`data`, heads and features over `model`) holds each step's loss to the
single process's at 1e-5, and every rank's step-0 gradients to its slice
of JAX's: a TP sum that also summed in its backward would multiply the
replicated gradients by 2, which Adam's normalisation would hide from the
losses."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pocket_tts_tpu.models.flow_lm import init_flow_lm_params
from pocket_tts_tpu.parallel.training import TrainState as JaxTrainState
from pocket_tts_tpu.parallel.training import flow_matching_loss as jax_loss
from pocket_tts_tpu.parallel.training import make_train_step as jax_make_train_step
from pocket_tts_tpu_torch.models.flow_lm import FlowLMSpecs
from pocket_tts_tpu_torch.nn.flow_mlp import FlowMLPConfig
from pocket_tts_tpu_torch.nn.transformer import TransformerConfig
from pocket_tts_tpu_torch.parallel.mesh import ModelGroup, shard_transformer_params
from pocket_tts_tpu_torch.parallel.training import flow_matching_loss, make_train_step
from test_training_step import SPECS as JAX_SPECS
from torch_parallel_worker import flatten, run_ranks
from torch_port import host, port

TOL = 1e-5
LR = 3e-3
B, S, TT = 8, 6, 4


def _spec_dict():
    t, f = JAX_SPECS.transformer, JAX_SPECS.flow
    return {"transformer": dict(d_model=t.d_model, num_heads=t.num_heads,
                                num_layers=t.num_layers, dim_feedforward=t.dim_feedforward),
            "flow": dict(in_channels=f.in_channels, model_channels=f.model_channels,
                         cond_channels=f.cond_channels, num_res_blocks=f.num_res_blocks),
            "ldim": JAX_SPECS.ldim, "n_bins": JAX_SPECS.n_bins,
            "insert_bos_before_voice": JAX_SPECS.insert_bos_before_voice}


def _port_specs():
    s = _spec_dict()
    return FlowLMSpecs(transformer=TransformerConfig(**s["transformer"]),
                       flow=FlowMLPConfig(**s["flow"]), ldim=s["ldim"], n_bins=s["n_bins"],
                       insert_bos_before_voice=s["insert_bos_before_voice"])


@pytest.fixture(scope="module")
def ref():
    """JAX params, batch, the loss key's t and noise, and the loss and grads."""
    params = jax.jit(init_flow_lm_params, static_argnums=0)(JAX_SPECS, jax.random.PRNGKey(0))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    batch = {"tokens": jax.random.randint(k1, (B, TT), 0, JAX_SPECS.n_bins),
             "latents": jax.random.normal(k2, (B, S, JAX_SPECS.ldim)),
             "eos_labels": jnp.zeros((B, S)).at[:, -1].set(1.0)}
    rng = jax.random.PRNGKey(100)
    k_t, k_n = jax.random.split(rng)  # the split inside the JAX loss
    t = jax.random.uniform(k_t, (B, S, 1))
    noise = jax.random.normal(k_n, (B, S, JAX_SPECS.ldim))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_loss(JAX_SPECS, p, batch, rng)))(params)
    return dict(params=params, batch=batch, rng=rng, t=np.array(t), noise=np.array(noise),
                loss=float(loss), grads=grads)


def _port_batch(ref):
    return {"tokens": torch.from_numpy(np.asarray(ref["batch"]["tokens"]).astype(np.int64)),
            "latents": torch.from_numpy(np.array(ref["batch"]["latents"])),
            "eos_labels": torch.from_numpy(np.array(ref["batch"]["eos_labels"]))}


def _assert_rel(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: max |port - jax| / max |jax| = {err:.3g} > {tol}"


def _port_steps(ref, n):
    init, step = make_train_step(_port_specs(), LR)
    state = init(port(ref["params"]))
    t, noise = torch.from_numpy(ref["t"]), torch.from_numpy(ref["noise"])
    losses = []
    for _ in range(n):
        state, loss = step(state, _port_batch(ref), t=t, noise=noise)
        losses.append(float(loss))
    return state, losses


def test_loss_and_gradients_match_jax(ref):
    params = port(ref["params"])
    leaves = {k: v.requires_grad_() for k, v in flatten(params).items()}
    loss = flow_matching_loss(_port_specs(), params, _port_batch(ref),
                              t=torch.from_numpy(ref["t"]), noise=torch.from_numpy(ref["noise"]))
    loss.backward()
    _assert_rel(loss.item(), ref["loss"], TOL, "loss")
    want = flatten(jax.tree.map(np.asarray, ref["grads"]))
    assert want.keys() == leaves.keys()
    for name, leaf in leaves.items():
        got = np.zeros(leaf.shape, np.float32) if leaf.grad is None else host(leaf.grad)
        _assert_rel(got, want[name], TOL, name)


def test_three_adam_steps_match_optax(ref):
    optimizer = optax.adam(LR)
    state = JaxTrainState(ref["params"], optimizer.init(ref["params"]))
    train_step = jax.jit(jax_make_train_step(JAX_SPECS, optimizer))
    jax_losses = []
    for _ in range(3):
        state, loss = train_step(state, ref["batch"], ref["rng"])
        jax_losses.append(float(loss))
    pstate, losses = _port_steps(ref, 3)
    _assert_rel(losses, jax_losses, TOL, "losses")
    want = flatten(jax.tree.map(np.asarray, state.params))
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, leaf in flatten(pstate.params).items():
        err = float(np.abs(host(leaf) - want[name]).max())
        assert err <= TOL * scale, f"{name}: max |port - optax| {err:.3g} > {TOL} x {scale:.3g}"


def test_generator_draws_t_and_noise():
    """Without injected t and noise the loss draws them from the generator:
    the same seed gives the same loss, another seed another one."""
    from pocket_tts_tpu_torch.models.flow_lm import init_flow_lm_params as port_init

    specs = _port_specs()
    params = port_init(specs, torch.Generator().manual_seed(0), torch.float32, "cpu")
    batch = {"tokens": torch.zeros((2, 3), dtype=torch.int64),
             "latents": torch.ones((2, 4, specs.ldim)), "eos_labels": torch.zeros((2, 4))}

    def loss(seed):
        return float(flow_matching_loss(specs, params, batch,
                                        generator=torch.Generator().manual_seed(seed)))

    assert loss(5) == loss(5) and loss(5) != loss(6)


def test_mesh_2x2_matches_the_single_process(ref, tmp_path):
    flat = {f"p/{k}": v for k, v in flatten(jax.tree.map(np.asarray, ref["params"])).items()}
    batch = {k: np.asarray(v) for k, v in ref["batch"].items()}
    batch["tokens"] = batch["tokens"].astype(np.int64)
    np.savez(tmp_path / "inputs.npz", **flat, **batch, t=ref["t"], noise=ref["noise"])
    (tmp_path / "inputs.json").write_text(json.dumps(
        {"specs": _spec_dict(), "lr": LR, "steps": 12}))
    ranks = run_ranks(4, "train4", tmp_path)

    _, single = _port_steps(ref, 12)
    assert single[-1] < single[0] * 0.9, single
    want = jax.tree.map(np.asarray, ref["grads"])
    for r, rank in enumerate(ranks):
        _assert_rel(rank["losses"], single, TOL, f"rank {r} losses")
        tp = ModelGroup(None, 2, int(rank["model_rank"]))
        shard = flatten({**want, "transformer": shard_transformer_params(
            {k: torch.from_numpy(np.array(v)) for k, v in want["transformer"].items()},
            JAX_SPECS.transformer.num_heads, tp)})
        grads = {k[len("g/"):]: v for k, v in rank.items() if k.startswith("g/")}
        for name, g in shard.items():
            got = grads.get(name, np.zeros(np.shape(g), np.float32))
            _assert_rel(got, np.asarray(g), TOL, f"rank {r} grad {name}")

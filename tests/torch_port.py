"""Helpers for the PyTorch port's CPU tests (tests/test_torch_*.py): carry
JAX trees into the port through numpy and back."""

import jax
import numpy as np
import torch

from pocket_tts_tpu_torch.core.bridge import to_numpy, to_torch


def port(tree, dtype=None, device="cpu"):
    """A JAX tree on the port's side. bf16 leaves travel as f32 (lossless)
    and are cast back with `dtype`."""
    host = jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jax.numpy.bfloat16 else np.asarray(a), tree)
    return to_torch(host, device=device, dtype=dtype)


def host(x):
    """A JAX array or a port tensor as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x, np.float32)



def write_small_checkpoint(tmp_path, seed: int = 0):
    """The test suite's small model (tests/small_model.small_config, with the
    toy tokenizer's vocabulary) as a checkpoint: JAX random params from
    PRNGKey(seed), written by the JAX package's save_combined_checkpoint.
    Returns (checkpoint path, tokenizer path)."""
    from pocket_tts_tpu.core.weights import save_combined_checkpoint
    from pocket_tts_tpu.models.flow_lm import build_flow_lm_specs, init_flow_lm_params
    from pocket_tts_tpu.models.mimi import build_mimi_specs, init_mimi_params
    from small_model import small_config
    from test_cli_generate import build_tokenizer_model

    tok = tmp_path / "tok.model"
    n_bins = build_tokenizer_model(tok)
    cfg = small_config(n_bins)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    mimi_specs = build_mimi_specs(cfg.mimi)
    ckpt = tmp_path / "model.safetensors"
    save_combined_checkpoint(ckpt, init_flow_lm_params(build_flow_lm_specs(cfg), k1),
                             mimi_specs, init_mimi_params(mimi_specs, k2))
    return ckpt, tok


def write_small_config(tmp_path, name: str, tokenizer, weights_path=None,
                       without_voice_cloning=None):
    """A YAML config of the small geometry naming a local tokenizer and the
    given checkpoints (None: none)."""
    import yaml

    from small_model import small_config
    from test_cli_generate import build_tokenizer_model

    cfg = small_config(build_tokenizer_model(tokenizer)).model_dump()
    cfg["flow_lm"]["lookup_table"]["tokenizer_path"] = str(tokenizer)
    cfg["weights_path"] = None if weights_path is None else str(weights_path)
    cfg["weights_path_without_voice_cloning"] = (None if without_voice_cloning is None
                                                 else str(without_voice_cloning))
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path

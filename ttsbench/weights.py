"""Seeded weights under the published checkpoint's key names and shapes.

Two draws from one device generator, a uniform and a normal over every
element at once, cut into the checkpoint's tensors by offset
(reference/model.checkpoint_shapes), then shaped per kind:
- a weight: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the PyTorch default;
- a bias: its weight's bound times `bias_scale` (a trained codec's biases
  are small against its signal; full-size random biases would drown the
  latents' part of the audio);
- a weight named in `weight_scale`: its bound times that factor;
- an embedding: N(0, 1);
- norms' scales 1 and offsets 0, the Mimi layer scales `layer_scale`, the
  flow head's sinusoid frequencies exp(-ln(10^4) j / 128).
`init` (the configuration's "init") holds bias_scale, weight_scale and
layer_scale.
Every value is rounded to the serving dtype once, so the program (which
serves that dtype) and the float32 reference see the same numbers.
"""

from __future__ import annotations

import math

import torch

from ttsbench.reference.model import checkpoint_shapes, fan_in


def views(flat, layout: dict[str, tuple[int, tuple]]) -> dict:
    """key -> the view of `flat` (a torch tensor or a numpy array) that
    `layout` (key -> (offset, shape)) gives it."""
    return {k: flat[o:o + math.prod(s)].reshape(s) for k, (o, s) in layout.items()}


def make_state_dict(cfg: dict, seed: int, device, dtype: torch.dtype,
                    init: dict) -> tuple[torch.Tensor, dict[str, tuple[int, tuple]]]:
    """(flat float32 buffer on `device`, its layout: key -> (offset,
    shape)); every value exact in `dtype`. `views` gives the tensors."""
    shapes = checkpoint_shapes(cfg)
    total = sum(math.prod(s) for s, _ in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    uni = torch.rand(total, generator=g, device=device) * 2 - 1
    nrm = torch.randn(total, generator=g, device=device)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    bias_scale, layer_scale = init["bias_scale"], init["layer_scale"]
    weight_scale = init.get("weight_scale", {})
    layout: dict[str, tuple[int, tuple]] = {}
    off = 0
    last_bound = 1.0
    for key, (shape, kind) in shapes.items():
        n = math.prod(shape)
        dst = flat[off:off + n]
        if kind == "w":
            last_bound = weight_scale.get(key, 1.0) / math.sqrt(fan_in(key, shape))
            dst.copy_(uni[off:off + n] * last_bound)
        elif kind == "b":
            dst.copy_(uni[off:off + n] * (last_bound * bias_scale))
        elif kind == "emb":
            dst.copy_(nrm[off:off + n])
        elif kind == "one":
            dst.fill_(1.0)
        elif kind == "zero":
            dst.zero_()
        elif kind == "ls":
            dst.fill_(layer_scale)
        elif kind == "freqs":
            j = torch.arange(n, dtype=torch.float32, device=device)
            dst.copy_(torch.exp(-math.log(10000.0) * j / n))
        else:
            raise ValueError(f"{key}: unknown kind {kind}")
        layout[key] = (off, tuple(shape))
        off += n
    del uni, nrm
    flat.copy_(flat.to(dtype).float())
    return flat, layout

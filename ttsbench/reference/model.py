"""The plain reference of a pocket-tts model: float32 PyTorch, no kernels, no
cache, no batching, written from the published architecture
(kyutai/pocket-tts: a FlowLM of pre-LN transformer layers over text tokens
and voice latents, an AdaLN flow-matching head sampled by LSD, and the
Mimi codec: SEANet encoder and decoder, windowed transformers and
the x16 resamplers). It imports nothing of the program under test.

Weights are a state dict under the published checkpoint's key names
(`checkpoint_shapes` lists them with the shapes the configuration gives);
the configuration is the published YAML as a dict (`flow_lm`, `mimi`).

`Reference.generate` decodes one request autoregressively: the voice
conditioning and the text tokens as the prompt, then one full causal
forward pass over everything so far per frame (no KV cache), the flow head
on the last position with that frame's flow noise, and the whole latent
sequence through the Mimi decoder in one pass. Every streaming stage of the
program is causal, so one pass over the whole sequence gives what a
streaming decoder emits frame by frame.

`precision`: "float32", or "float8" to round both operands of every weight
product (linear and convolution) to float8 e4m3, per-tensor scaled (the
control of the correctness check); "float8:<prefix>"
rounds only the products whose weight key starts with the prefix (which
part of the model a compared number sees)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8_e4m3fn


def seanet_program(s: dict, encoder: bool) -> list[tuple]:
    """The SEANet module list of the published model: ("conv", cin, cout, k,
    stride, dilation) | ("convtr", cin, cout, k, stride) | ("elu",) |
    ("res", [conv, conv]). A module's index in the list is its index in the
    checkpoint's `model.{i}` keys (ELUs take an index too)."""
    nf, ratios = s["n_filters"], list(s["ratios"])
    ops: list[tuple] = []

    def res(dim, dilation):
        hidden = dim // s["compress"]
        return ("res", [("conv", dim, hidden, s["residual_kernel_size"], 1, dilation),
                        ("conv", hidden, dim, 1, 1, 1)])

    if encoder:
        mult = 1
        ops.append(("conv", s["channels"], nf, s["kernel_size"], 1, 1))
        for r in reversed(ratios):
            ops += [res(mult * nf, s["dilation_base"] ** j) for j in range(s["n_residual_layers"])]
            ops += [("elu",), ("conv", mult * nf, 2 * mult * nf, 2 * r, r, 1)]
            mult *= 2
        ops += [("elu",), ("conv", mult * nf, s["dimension"], s["last_kernel_size"], 1, 1)]
    else:
        mult = 2 ** len(ratios)
        ops.append(("conv", s["dimension"], mult * nf, s["kernel_size"], 1, 1))
        for r in ratios:
            ops += [("elu",), ("convtr", mult * nf, mult * nf // 2, 2 * r, r)]
            ops += [res(mult * nf // 2, s["dilation_base"] ** j)
                    for j in range(s["n_residual_layers"])]
            mult //= 2
        ops += [("elu",), ("conv", nf, s["channels"], s["last_kernel_size"], 1, 1)]
    return ops


def checkpoint_shapes(cfg: dict) -> dict[str, tuple[tuple, str]]:
    """Every tensor of the published whole-model checkpoint ("flow_lm.*",
    "mimi.*") as key -> (shape, kind). kind says how a seeded checkpoint
    fills it: "w" a weight (fan-in uniform), "b" a bias (of the weight
    before it), "emb" an embedding (normal), "one", "zero", "ls" the Mimi
    layer scale, "freqs" the flow head's sinusoid frequencies."""
    out: dict[str, tuple[tuple, str]] = {}
    lm, mimi = cfg["flow_lm"], cfg["mimi"]
    t = lm["transformer"]
    D, L = t["d_model"], t["num_layers"]
    Fd = D * t["hidden_scale"]
    ld = mimi["quantizer"]["dimension"]
    M = lm["flow"]["dim"]
    n_bins = lm["lookup_table"]["n_bins"]

    def layers(prefix, n, d, ff, layer_scale):
        for i in range(n):
            p = f"{prefix}layers.{i}."
            out[p + "self_attn.in_proj.weight"] = ((3 * d, d), "w")
            out[p + "self_attn.out_proj.weight"] = ((d, d), "w")
            for norm in ("norm1", "norm2"):
                out[p + norm + ".weight"] = ((d,), "one")
                out[p + norm + ".bias"] = ((d,), "zero")
            out[p + "linear1.weight"] = ((ff, d), "w")
            out[p + "linear2.weight"] = ((d, ff), "w")
            if layer_scale:
                out[p + "layer_scale_1.scale"] = ((d,), "ls")
                out[p + "layer_scale_2.scale"] = ((d,), "ls")

    def linear(name, o, i, bias=True):
        out[name + ".weight"] = ((o, i), "w")
        if bias:
            out[name + ".bias"] = ((o,), "b")

    out["flow_lm.conditioner.embed.weight"] = ((n_bins + 1, D), "emb")
    out["flow_lm.input_linear.weight"] = ((D, ld), "w")
    out["flow_lm.bos_emb"] = ((ld,), "emb")
    out["flow_lm.emb_std"] = ((ld,), "one")
    out["flow_lm.emb_mean"] = ((ld,), "zero")
    out["flow_lm.out_norm.weight"] = ((D,), "one")
    out["flow_lm.out_norm.bias"] = ((D,), "zero")
    linear("flow_lm.out_eos", 1, D)
    out["flow_lm.speaker_proj_weight"] = ((D, mimi["inner_dim"]), "w")
    if lm.get("insert_bos_before_voice"):
        out["flow_lm.bos_before_voice"] = ((1, 1, D), "emb")
    layers("flow_lm.transformer.", L, D, Fd, False)
    fn = "flow_lm.flow_net."
    for i in range(2):
        out[f"{fn}time_embed.{i}.freqs"] = ((128,), "freqs")
        linear(f"{fn}time_embed.{i}.mlp.0", M, 256)
        linear(f"{fn}time_embed.{i}.mlp.2", M, M)
        out[f"{fn}time_embed.{i}.mlp.3.alpha"] = ((M,), "one")
    linear(fn + "cond_embed", M, D)
    linear(fn + "input_proj", M, ld)
    for i in range(lm["flow"]["depth"]):
        out[f"{fn}res_blocks.{i}.in_ln.weight"] = ((M,), "one")
        out[f"{fn}res_blocks.{i}.in_ln.bias"] = ((M,), "zero")
        linear(f"{fn}res_blocks.{i}.mlp.0", M, M)
        linear(f"{fn}res_blocks.{i}.mlp.2", M, M)
        linear(f"{fn}res_blocks.{i}.adaLN_modulation.1", 3 * M, M)
    linear(fn + "final_layer.linear", ld, M)
    linear(fn + "final_layer.adaLN_modulation.1", 2 * M, M)

    s, mt = mimi["seanet"], mimi["transformer"]
    for part, enc in (("encoder", True), ("decoder", False)):
        for i, op in enumerate(seanet_program(s, enc)):
            p = f"mimi.{part}.model.{i}."
            if op[0] == "conv":
                out[p + "conv.weight"] = ((op[2], op[1], op[3]), "w")
                out[p + "conv.bias"] = ((op[2],), "b")
            elif op[0] == "convtr":
                out[p + "convtr.weight"] = ((op[1], op[2], op[3]), "w")
                out[p + "convtr.bias"] = ((op[2],), "b")
            elif op[0] == "res":
                for j, c in enumerate(op[1]):
                    out[f"{p}block.{2 * j + 1}.conv.weight"] = ((c[2], c[1], c[3]), "w")
                    out[f"{p}block.{2 * j + 1}.conv.bias"] = ((c[2],), "b")
    d = mt["d_model"]
    for name in ("encoder_transformer", "decoder_transformer"):
        layers(f"mimi.{name}.transformer.", mt["num_layers"], d, mt["dim_feedforward"], True)
        if mt["input_dimension"] != d:
            out[f"mimi.{name}.input_proj.weight"] = ((d, mt["input_dimension"]), "w")
        if mt["output_dimensions"][0] != d:
            out[f"mimi.{name}.output_projs.0.weight"] = ((mt["output_dimensions"][0], d), "w")
    stride = int(mimi["sample_rate"] / math.prod(s["ratios"]) / mimi["frame_rate"])
    out["mimi.quantizer.output_proj.weight"] = (
        (mimi["quantizer"]["output_dimension"], ld, 1), "w")
    out["mimi.downsample.conv.conv.weight"] = ((mimi["inner_dim"], s["dimension"], 2 * stride),
                                               "w")
    out["mimi.upsample.convtr.convtr.weight"] = ((s["dimension"], 1, 2 * stride), "w")
    return out


def fan_in(key: str, shape: tuple) -> int:
    """The fan-in of a weight, or of the weight a bias belongs to (a
    transposed convolution's [C_in, C_out/groups, K] weight: C_out/groups x K)."""
    if "convtr" in key:
        return shape[1] * shape[2]
    return int(np.prod(shape[1:]))


class Reference:
    """The model over a state dict of float32 tensors (published keys)."""

    def __init__(self, cfg: dict, sd: dict[str, torch.Tensor], precision: str = "float32"):
        self.cfg, self.sd = cfg, sd
        self.precision, _, self.scope = precision.partition(":")
        lm, mimi = cfg["flow_lm"], cfg["mimi"]
        t = lm["transformer"]
        self.D, self.H, self.L = t["d_model"], t["num_heads"], t["num_layers"]
        self.max_period = float(t["max_period"])
        self.mt = mimi["transformer"]
        self.seanet_cfg = mimi["seanet"]
        self.frame = int(mimi["sample_rate"] / mimi["frame_rate"])
        self.stride = int(mimi["sample_rate"] / math.prod(self.seanet_cfg["ratios"])
                          / mimi["frame_rate"])
        self.bos_before_voice = bool(lm.get("insert_bos_before_voice"))
        self.flow_depth = lm["flow"]["depth"]

    # ------------------------------------------------------------ operands

    def _q(self, x: torch.Tensor, key: str = "") -> torch.Tensor:
        if self.precision == "float32" or not key.startswith(self.scope):
            return x
        if self.precision == "float8":
            scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        raise ValueError(f"unknown precision {self.precision!r}")

    def w(self, key: str) -> torch.Tensor:
        return self.sd[key]

    def linear(self, x, key: str, bias: bool = False):
        y = self._q(x, key) @ self._q(self.sd[key + ".weight"], key).T
        return y + self.sd[key + ".bias"] if bias else y

    def conv(self, x, key: str, stride: int = 1, dilation: int = 1, replicate: bool = False,
             bias: bool = True):
        """Causal conv over x [C, T]: left context K_eff - stride (zeros, or
        the first sample repeated)."""
        w = self.sd[key + ".weight"]
        ctx = (w.shape[-1] - 1) * dilation + 1 - stride
        if ctx > 0:
            left = (x[:, :1].expand(-1, ctx) if replicate
                    else torch.zeros((x.shape[0], ctx), dtype=x.dtype, device=x.device))
            x = torch.cat([left, x], dim=1)
        y = F.conv1d(self._q(x, key)[None], self._q(w, key), stride=stride,
                     dilation=dilation)[0]
        b = self.sd.get(key + ".bias") if bias else None
        return y if b is None else y + b[:, None]

    def convtr(self, x, key: str, stride: int, groups: int = 1, bias: bool = True):
        """Transposed conv over x [C, T]: the first T x stride samples of the
        full output (what a streaming decoder has emitted after T steps)."""
        w = self.sd[key + ".weight"]
        y = F.conv_transpose1d(self._q(x, key)[None], self._q(w, key), stride=stride,
                               groups=groups)[0]
        y = y[:, :x.shape[1] * stride]
        b = self.sd.get(key + ".bias") if bias else None
        return y if b is None else y + b[:, None]

    # ---------------------------------------------------------- transformer

    @staticmethod
    def layer_norm(x, w=None, b=None, eps: float = 1e-5):
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + eps)
        return y if w is None else y * w + b

    def rope(self, x, positions, max_period: float):
        """Rotate interleaved pairs of x [T, H, Dh] by position p x
        max_period^(-2j/Dh) for pair j."""
        Dh = x.shape[-1]
        j = torch.arange(Dh // 2, dtype=torch.float32, device=x.device)
        freqs = torch.exp(j * (-math.log(max_period) * 2 / Dh))
        ang = positions.float()[:, None, None] * freqs  # [T, 1, Dh/2]
        xr, xi = x[..., 0::2], x[..., 1::2]
        out = torch.empty_like(x)
        out[..., 0::2] = xr * torch.cos(ang) - xi * torch.sin(ang)
        out[..., 1::2] = xr * torch.sin(ang) + xi * torch.cos(ang)
        return out

    def transformer(self, x, prefix: str, n_layers: int, heads: int, context: int | None,
                    max_period: float, layer_scale: bool):
        """Causal pre-LN stack over x [T, d] at positions 0..T-1 (a key is
        seen by queries up to `context` - 1 positions after it)."""
        T, d = x.shape
        pos = torch.arange(T, device=x.device)
        delta = pos[:, None] - pos[None, :]
        mask = delta >= 0
        if context is not None:
            mask &= delta < context
        for i in range(n_layers):
            p = f"{prefix}layers.{i}."
            h = self.layer_norm(x, self.sd[p + "norm1.weight"], self.sd[p + "norm1.bias"])
            qkv = self.linear(h, p + "self_attn.in_proj").reshape(T, 3, heads, d // heads)
            q = self.rope(qkv[:, 0], pos, max_period)
            k = self.rope(qkv[:, 1], pos, max_period)
            v = qkv[:, 2]
            logits = torch.einsum("thd,shd->hts", q, k) / math.sqrt(d // heads)
            att = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
            o = torch.einsum("hts,shd->thd", att, v).reshape(T, d)
            o = self.linear(o, p + "self_attn.out_proj")
            if layer_scale:
                o = o * self.sd[p + "layer_scale_1.scale"]
            x = x + o
            h = self.layer_norm(x, self.sd[p + "norm2.weight"], self.sd[p + "norm2.bias"])
            f = self.linear(F.gelu(self.linear(h, p + "linear1")), p + "linear2")
            if layer_scale:
                f = f * self.sd[p + "layer_scale_2.scale"]
            x = x + f
        return x

    def mimi_transformer(self, x, name: str):
        mt = self.mt
        key = f"mimi.{name}."
        if key + "input_proj.weight" in self.sd:
            x = self.linear(x, key + "input_proj")
        x = self.transformer(x, key + "transformer.", mt["num_layers"], mt["num_heads"],
                             mt["context"], float(mt.get("max_period", 10000.0)), True)
        if key + "output_projs.0.weight" in self.sd:
            x = self.linear(x, key + "output_projs.0")
        return x

    # --------------------------------------------------------------- SEANet

    def seanet(self, x, part: str):
        for i, op in enumerate(seanet_program(self.seanet_cfg, part == "encoder")):
            key = f"mimi.{part}.model.{i}."
            if op[0] == "elu":
                x = F.elu(x)
            elif op[0] == "conv":
                x = self.conv(x, key + "conv", stride=op[4], dilation=op[5])
            elif op[0] == "convtr":
                x = self.convtr(x, key + "convtr", stride=op[4])
            else:
                v = x
                for j, c in enumerate(op[1]):
                    v = self.conv(F.elu(v), f"{key}block.{2 * j + 1}.conv", dilation=c[5])
                x = x + v
        return x

    # ------------------------------------------------------------ the model

    def voice_conditioning(self, wav: torch.Tensor) -> torch.Tensor:
        """Mono audio [T] at the model's rate -> the voice's FlowLM inputs
        [ceil(T / frame), D]: SEANet encoder, encoder transformer, the
        strided downsample, the speaker projection."""
        pad = (-wav.shape[0]) % self.frame
        x = F.pad(wav.float(), (0, pad))[None]
        emb = self.seanet(x, "encoder")  # [dimension, T / hop]
        h = self.mimi_transformer(emb.T, "encoder_transformer")
        lat = self.conv(h.T, "mimi.downsample.conv.conv", stride=self.stride, replicate=True)
        key = "flow_lm.speaker_proj_weight"
        return self._q(lat.T, key) @ self._q(self.sd[key], key).T

    def prompt(self, cond: torch.Tensor, tokens: list[int]) -> torch.Tensor:
        """The FlowLM's prompt inputs [P, D]: the BOS row (where the config
        inserts it), the voice conditioning, the text tokens' embeddings."""
        parts = []
        if self.bos_before_voice:
            parts.append(self.sd["flow_lm.bos_before_voice"].reshape(1, -1))
        parts.append(cond)
        idx = torch.as_tensor(tokens, dtype=torch.long, device=cond.device)
        parts.append(self.sd["flow_lm.conditioner.embed.weight"][idx])
        return torch.cat(parts)

    def flow_head(self, cond, x0, steps: int):
        fn = "flow_lm.flow_net."
        freqs = self.sd[f"{fn}time_embed.0.freqs"]

        def time_embed(i, tv):
            args = tv * freqs
            e = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
            h = self.linear(F.silu(self.linear(e, f"{fn}time_embed.{i}.mlp.0", True)),
                            f"{fn}time_embed.{i}.mlp.2", True)
            n = h.shape[-1]
            var = (h - h.mean(dim=-1, keepdim=True)).square().sum(dim=-1, keepdim=True) / (n - 1)
            return h * (self.sd[f"{fn}time_embed.{i}.mlp.3.alpha"] / torch.sqrt(1e-5 + var))

        x_cur = x0
        one = torch.ones_like(x0[..., :1])
        for i in range(steps):
            s, t = one * (i / steps), one * ((i + 1) / steps)
            x = self.linear(x_cur, fn + "input_proj", True)
            y = ((time_embed(0, s) + time_embed(1, t)) / 2
                 + self.linear(cond, fn + "cond_embed", True))
            for r in range(self.flow_depth):
                p = f"{fn}res_blocks.{r}."
                shift, scale, gate = self.linear(F.silu(y), p + "adaLN_modulation.1",
                                                 True).chunk(3, dim=-1)
                h = self.layer_norm(x, self.sd[p + "in_ln.weight"], self.sd[p + "in_ln.bias"],
                                    eps=1e-6)
                h = h * (1 + scale) + shift
                h = self.linear(F.silu(self.linear(h, p + "mlp.0", True)), p + "mlp.2", True)
                x = x + gate * h
            shift, scale = self.linear(F.silu(y), fn + "final_layer.adaLN_modulation.1",
                                       True).chunk(2, dim=-1)
            x = self.layer_norm(x, eps=1e-6) * (1 + scale) + shift
            x_cur = x_cur + self.linear(x, fn + "final_layer.linear", True) / steps
        return x_cur

    def decode_latents(self, prompt: torch.Tensor, noise: torch.Tensor, frames: int,
                       lsd_steps: int) -> torch.Tensor:
        """`frames` latents [frames, ldim] after the prompt [P, D], frame i
        from noise[i] (already scaled by sqrt(temp)):
        the BOS latent first, then each frame's latent as the next input, one
        full forward pass over the sequence per frame."""
        t = self.cfg["flow_lm"]["transformer"]
        inputs = [prompt]
        prev = self.sd["flow_lm.bos_emb"]
        latents = []
        for i in range(frames):
            inputs.append(self.linear(prev[None], "flow_lm.input_linear"))
            h = self.transformer(torch.cat(inputs), "flow_lm.transformer.", self.L, self.H,
                                 None, self.max_period, False)[-1:]
            h = self.layer_norm(h, self.sd["flow_lm.out_norm.weight"],
                                self.sd["flow_lm.out_norm.bias"])
            prev = self.flow_head(h, noise[i:i + 1].float(), lsd_steps)[0]
            latents.append(prev)
        del t
        return torch.stack(latents)

    def mimi_decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [n, ldim] -> audio [n x frame]: denormalised, the
        quantizer's output projection, the x16 depthwise upsample, the
        decoder transformer and the SEANet decoder."""
        z = latents * self.sd["flow_lm.emb_std"] + self.sd["flow_lm.emb_mean"]
        x = self.conv(z.T, "mimi.quantizer.output_proj", bias=False)
        x = self.convtr(x, "mimi.upsample.convtr.convtr", stride=self.stride,
                        groups=x.shape[0], bias=False)
        x = self.mimi_transformer(x.T, "decoder_transformer").T
        return self.seanet(x, "decoder")[0]

    def generate(self, cond: torch.Tensor, tokens: list[int], noise: torch.Tensor, frames: int,
                 lsd_steps: int = 1) -> torch.Tensor:
        """One request: its audio [frames x frame]."""
        return self.mimi_decode(self.decode_latents(self.prompt(cond, tokens), noise, frames,
                                                    lsd_steps))

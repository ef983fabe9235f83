"""The yardstick's arithmetic: the H100's peaks, a call's roofline bound,
and the operations and bytes of the kernels and of a whole frame, counted
from the configuration's widths (the published config dict).

Counting rules (a bound counts each input byte once and each output byte
once, and the work these inputs need, not the most a kernel could do):
- decode stack (one call per b1 frame, all FlowLM layers): every layer's
  four weights once, the valid cached keys and values once, the new row's
  key and value, the input and output rows, the position map over the
  attended slots; 2 operations a multiply-add;
- flash decode (one call per layer per batched frame): the rows' valid
  keys and values, q, the new key and value and the output once, the
  position map over the attended slots and the offsets;
- codec (one call per block of K frames, T0 = 16 K codec steps): the
  decoder's weights once, its input, its streaming state in and out, the
  audio out; the convolutions' multiply-adds;
- a frame (`frame_flops`): the FlowLM step (its products and attention
  over the attended positions), the flow head, the EOS head, Mimi's
  latent projection, x16 upsample and windowed transformer over 16
  positions, and the SEANet decoder.
"""

from __future__ import annotations

import math

from ttsbench.reference.model import seanet_program

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 CUDA cores
BYTES = {"bfloat16": 2, "float32": 4}
CODEC_STEPS_PER_FRAME = 16  # the Mimi decoder's 200 Hz steps per 12.5 Hz frame
BLOCK_RAMP = (1, 1, 8, 8, 8, 8)  # then 32-frame blocks: the program's block sizes
STEADY_BLOCK = 32


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """(least ms the chip could take, what bounds it)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def widths(cfg: dict) -> dict:
    t = cfg["flow_lm"]["transformer"]
    mt = cfg["mimi"]["transformer"]
    return dict(L=t["num_layers"], D=t["d_model"], H=t["num_heads"],
                F=t["d_model"] * t["hidden_scale"], M=cfg["flow_lm"]["flow"]["dim"],
                R=cfg["flow_lm"]["flow"]["depth"], ld=cfg["mimi"]["quantizer"]["dimension"],
                mL=mt["num_layers"], md=mt["d_model"], mF=mt["dim_feedforward"],
                mctx=mt["context"], up=cfg["mimi"]["quantizer"]["output_dimension"])


def decode_stack_call(cfg: dict, valid: int, attended: int, dtype: str) -> tuple[int, int]:
    """(bytes, operations) of one decode-stack call at one row: `valid`
    cached positions attended, `attended` slots of position map read."""
    w = widths(cfg)
    L, D, F = w["L"], w["D"], w["F"]
    es = BYTES[dtype]
    weights = L * (es * (4 * D * D + 2 * F * D) + 4 * D * es)
    nbytes = weights + L * valid * 2 * D * es + L * 2 * D * es + 2 * D * es + attended * 4
    flops = L * (2 * (4 * D * D + 2 * F * D) + 4 * (valid + 1) * D)
    return nbytes, flops


def flash_decode_call(cfg: dict, rows: int, valid: int, attended: int,
                      dtype: str) -> tuple[int, int]:
    """(bytes, operations) of one flash-decode call (one layer) over `rows`
    rows whose valid cached positions add up to `valid`, each with
    `attended` slots of position map."""
    w = widths(cfg)
    HDh = w["D"]
    es = BYTES[dtype]
    nbytes = (2 * valid + 4 * rows) * HDh * es + rows * attended * 4 + rows * 4
    flops = 4 * (valid + rows) * HDh
    return nbytes, flops


def _decoder(cfg: dict) -> list[tuple]:
    return seanet_program(cfg["mimi"]["seanet"], encoder=False)


def codec_flops(cfg: dict, T: int) -> int:
    """Operations of one row of the SEANet decoder at T0 = T input steps."""
    flops, t = 0, T
    for op in _decoder(cfg):
        if op[0] == "conv":
            flops += 2 * op[1] * op[2] * op[3] * t
        elif op[0] == "convtr":
            flops += 2 * op[1] * op[2] * op[3] * t
            t *= op[4]
        elif op[0] == "res":
            flops += sum(2 * c[1] * c[2] * c[3] * t for c in op[1])
    return flops


def codec_call(cfg: dict, rows: int, T: int, dtype: str) -> tuple[int, int]:
    """(bytes, operations) of one codec call over `rows` rows of T0 = T."""
    es = BYTES[dtype]
    weights = 0
    state = 0
    for op in _decoder(cfg):
        convs = op[1] if op[0] == "res" else [op] if op[0] in ("conv", "convtr") else []
        for c in convs:
            weights += c[1] * c[2] * c[3] + c[2]
            if c[0] == "conv":
                state += c[1] * ((c[3] - 1) * c[5] + 1 - c[4])
            else:
                state += c[2] * (c[3] - c[4])
    hop = math.prod(op[4] for op in _decoder(cfg) if op[0] == "convtr")
    dim = cfg["mimi"]["seanet"]["dimension"]
    nbytes = (weights + rows * (dim * T + 2 * state + T * hop)) * es
    return nbytes, rows * codec_flops(cfg, T)


def blocks(frames: int) -> list[int]:
    """The block sizes a chunk of `frames` frames is decoded in."""
    out, done = [], 0
    while done < frames:
        k = BLOCK_RAMP[len(out)] if len(out) < len(BLOCK_RAMP) else STEADY_BLOCK
        out.append(k)
        done += k
    return out


def frame_flops(cfg: dict, attended: int) -> int:
    """Operations of one frame of one row: the FlowLM step attending
    `attended` positions, the heads, Mimi's decoder step over 16 positions
    (window-limited attention) and the SEANet decoder."""
    w = widths(cfg)
    L, D, F, M, R, ld = w["L"], w["D"], w["F"], w["M"], w["R"], w["ld"]
    lm = 2 * ld * D + L * (2 * (4 * D * D + 2 * F * D) + 4 * (attended + 1) * D)
    head = 2 * D  # EOS
    flow = 2 * (2 * (256 * M + M * M) + D * M + ld * M + R * (2 * M * M + 3 * M * M)
                + 2 * M * M + M * ld)
    n = CODEC_STEPS_PER_FRAME
    md, mF = w["md"], w["mF"]
    att = w["mctx"]  # a steady stream attends a full window
    mimi = (2 * ld * w["up"] + 2 * w["up"] * 2 * n
            + w["mL"] * n * (2 * (4 * md * md + 2 * mF * md) + 4 * att * md))
    return lm + head + flow + mimi + codec_flops(cfg, n)

"""Per-component step-time profile of the frame step on the card.

The port of tools/profile_step.py. It breaks the b1 / b32 frame time down
into the whole block (FlowLM decode with its flow head, project_latent, the
Mimi decoder), the FlowLM decode alone, the LSD flow MLP alone, the Mimi
decoder step (its SEANet on the codec kernel, and on the plain program),
and the SEANet decoder alone (kernel vs plain), at english.yaml's full width
in bf16 with seeded random weights.

Timing: each component is one block of BLOCK frames, as a lane runs it
(pipeline/step_graphs.py: the K decode steps, then one Mimi decoder call
over the block's latents), captured once as a CUDA graph after an op-by-op
warm-up and replayed between CUDA events: device time, the median of
repeats, divided by BLOCK. (The JAX tool takes the slope of chained
dispatches of a BLOCK-frame scan.) The FlowLM attends the slots below its
write pointer, so the JAX tool's att_len=None over a 768-slot cache is a
cache filled to CAPACITY - BLOCK here (`cap768`) and its att_len=256 one
filled to 256 - BLOCK (`att256`); every replay starts from the same state.

`components` gives each component as a plain function and its inputs, so a
CPU test runs them at a small size without the timing.

Usage: python -m pocket_tts_tpu_torch.tools.profile_step [batch ...]   (default 1 32;
runs on the CUDA card and fails without one).
"""

from __future__ import annotations

import sys
from typing import Callable

import torch

from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
from pocket_tts_tpu_torch.core.tree import tree_map
from pocket_tts_tpu_torch.models.flow_lm import (
    build_flow_lm_specs,
    decode_step,
    init_flow_lm_params,
    init_flow_lm_state,
)
from pocket_tts_tpu_torch.models.mimi import (
    build_mimi_specs,
    decoder_step,
    decoder_upsample_step,
    init_decoder_state,
    init_mimi_params,
)
from pocket_tts_tpu_torch.nn.flow_mlp import lsd_decode
from pocket_tts_tpu_torch.nn.seanet import init_seanet_state, seanet_apply
from pocket_tts_tpu_torch.nn.transformer import StackState
from pocket_tts_tpu_torch.ops.build import add_launches, launch_counts
from pocket_tts_tpu_torch.ops.codec_decode import codec_decode
from pocket_tts_tpu_torch.pipeline.tts import GenerationParams, TTSModel
from pocket_tts_tpu_torch.tools import card_line

BLOCK = 8
DTYPE = torch.bfloat16
CAPACITY = 768
FILLS = {"cap768": CAPACITY - BLOCK, "att256": 256 - BLOCK}  # slots written before the block


def build(device, config=CONFIGS_DIR / "english.yaml", dtype=DTYPE, seed: int = 0) -> TTSModel:
    """A model of `config` with random weights from a seeded generator, every
    f32 leaf cast to `dtype` (as load_model casts), one LSD step and the JAX
    tool's EOS threshold of -4."""
    cfg = load_config(config)
    specs, mimi_specs = build_flow_lm_specs(cfg), build_mimi_specs(cfg.mimi)
    g = torch.Generator(device=device).manual_seed(seed)

    def cast(t):
        return t.to(dtype) if t.dtype == torch.float32 else t

    params = tree_map(cast, init_flow_lm_params(specs, g, torch.float32, device))
    mimi = tree_map(cast, init_mimi_params(mimi_specs, g, torch.float32, device))
    return TTSModel(specs, mimi_specs, params, mimi, None, cfg,
                    GenerationParams(lsd_decode_steps=1, eos_threshold=-4.0), torch.device(device))


def lm_state(model: TTSModel, batch: int, fill: int, device) -> StackState:
    """A FlowLM cache of CAPACITY slots whose first `fill` hold positions
    0 .. fill-1 (random keys and values), both write pointers at `fill`."""
    st = init_flow_lm_state(model.specs, batch, CAPACITY, model._dtype, device)
    g = torch.Generator(device=device).manual_seed(1)
    for cache in (st.k, st.v):
        cache[:, :, :fill] = torch.randn(cache[:, :, :fill].shape, generator=g, device=device) * 0.5
    st.pos[:, :fill] = torch.arange(fill, dtype=torch.int32, device=device)
    return StackState(st.k, st.v, st.pos, torch.full((batch,), fill, dtype=torch.int32,
                                                     device=device),
                      fill, torch.tensor([fill], dtype=torch.int32, device=device))


def full_block(model: TTSModel, lm: StackState, mimi: dict, prev: torch.Tensor,
               noise: torch.Tensor):
    """A lane's block of noise.shape[0] frames (TTSModel._decode_block, no BOS)."""
    is_bos = torch.zeros(prev.shape[0], dtype=torch.bool, device=prev.device)
    return model._decode_block(lm, mimi, prev, is_bos, noise)


def lm_block(model: TTSModel, lm: StackState, prev: torch.Tensor, noise: torch.Tensor):
    """noise.shape[0] FlowLM decode steps, each with its flow head and EOS head."""
    is_bos = torch.zeros(prev.shape[0], dtype=torch.bool, device=prev.device)
    for n in noise:
        prev, _, lm = decode_step(model.specs, model.params, lm, prev, is_bos, n,
                                  lsd_steps=model.gen.lsd_decode_steps,
                                  eos_threshold=model.gen.eos_threshold)
    return prev, lm


def flow_block(model: TTSModel, h: torch.Tensor, x: torch.Tensor):
    """BLOCK chained LSD flow-head decodes on the condition h."""
    for _ in range(BLOCK):
        x = lsd_decode(model.specs.flow, model.params["flow_net"], h, x,
                       model.gen.lsd_decode_steps)
    return x


def decoder_step_plain(specs, params: dict, latent: torch.Tensor, state: dict):
    """models/mimi.decoder_step with its SEANet decoder as the plain program
    (seanet_apply) in place of the codec op."""
    x, new = decoder_upsample_step(specs, params, latent, state)
    audio, new["decoder"] = seanet_apply(specs.decoder, params["decoder"], x, state["decoder"])
    return audio, new


def components(model: TTSModel, batch: int, device) -> dict[str, tuple[Callable, tuple]]:
    """Each component as (function, its inputs) at `batch` rows, in the JAX
    tool's order: one call runs one block of BLOCK frames."""
    g = torch.Generator(device=device).manual_seed(2)
    dt, ldim = model._dtype, model.specs.ldim
    ms = model.mimi_specs
    noise = torch.randn((BLOCK, batch, ldim), generator=g, device=device)
    prev = torch.zeros((batch, ldim), device=device)
    mimi = init_decoder_state(ms, batch, dt, device)
    states = {tag: lm_state(model, batch, fill, device) for tag, fill in FILLS.items()}
    h = torch.zeros((batch, model.specs.transformer.d_model), device=device)
    q = (torch.randn((batch, ms.quantizer_out_dim, BLOCK), generator=g, device=device)
         * 0.5).to(dt)
    x = (torch.randn((batch, ms.arch.dimension, 16 * BLOCK), generator=g, device=device)
         * 0.5).to(dt)
    sea = init_seanet_state(ms.decoder, batch, dt, device)
    out = {f"full_{tag}": (full_block, (model, st, mimi, prev, noise))
           for tag, st in states.items()}
    out.update({f"lm_{tag}": (lm_block, (model, st, prev, noise)) for tag, st in states.items()})
    out["flow_mlp"] = (flow_block, (model, h, prev))
    mp = model.mimi_params
    out["mimi_step"] = (decoder_step, (ms, mp, q, mimi))
    out["mimi_step_plain"] = (decoder_step_plain, (ms, mp, q, mimi))
    out["seanet_kernel"] = (codec_decode, (ms.decoder, mp["decoder"], x, sea,
                                           mp.get("decoder_packed")))
    out["seanet_plain"] = (seanet_apply, (ms.decoder, mp["decoder"], x, sea))
    return out


def graph_ms(run: Callable[[], object], n: int = 5, reps: int = 7) -> float:
    """Device ms of one call of `run`: one op-by-op warm-up on a side
    stream, one CUDA-graph capture, then `reps` times n replays between CUDA
    events; the median. A capture launches nothing, so the kernels' launch
    counts it added are taken back."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    try:
        with torch.cuda.graph(graph):
            run()
    finally:
        after = launch_counts()
        add_launches({k: before[k] - after[k] for k in after})
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


def profile(model: TTSModel, batch: int) -> dict[str, float]:
    """ms per frame of each component at `batch` rows, on the card."""
    return {name: graph_ms(lambda fn=fn, args=args: fn(*args)) / BLOCK
            for name, (fn, args) in components(model, batch, "cuda").items()}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    batches = [int(a) for a in argv] or [1, 32]
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device (the profile times the card)")
    print(card_line(), flush=True)
    model = build("cuda")
    frame_s = model.samples_per_frame / model.sample_rate
    for b in batches:
        res = profile(model, b)
        print(f"\n=== batch {b} (ms/frame) ===", flush=True)
        for k, v in res.items():
            aps = frame_s / (v / 1000) * b
            print(f"  {k:18s} {v:8.3f} ms  ({aps:8.1f} audio-s/s)", flush=True)


if __name__ == "__main__":
    main()

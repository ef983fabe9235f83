#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pocket_tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel of the port from pocket_tts_tpu_torch/csrc (decode
     stack, codec decoder, flash decode, skinny GEMV, stacked int8 GEMV), one
     nvcc per source, in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 and f32, at the main paths' shapes, with kernel, plain and library
     times and the bound: decode_stack at the flagship FlowLM width, 6 layers,
     C in {256, 512} (bf16 also 1024 and 4096, ~900 and ~4000 valid slots;
     int8 also 4096), plain and int8 weights, and 24 layers at C=256 in bf16 and int8, on a mid-generation
     cache with dead and speculative slots, timed as device time by graph
     replay (graph_ms) beside a host loop (cuda_ms), with its share of the
     bound and a profile at C=256 that must show one kernel per call;
     codec_decode on the english.yaml decoder with non-zero states, in bf16
     at B in {1, 32, 128} x T in {16, 128, 512} (every block the paths
     send), in f32 at B=1 (T = 16 and 16*8) and B=32 (T=16), timed as device
     time by graph replay (graph_ms) beside a host loop (cuda_ms), with each
     op's body (a tensor-core tile in bf16, the CUDA cores in f32), in bf16
     each op alone on its tile and with that tile passed over, and profiles
     at B=1, T=16 and B=128, T=512; flash_decode at H=16, Dh=64 (FD_CASES):
     B in {8, 32}, C in {256, 1024} with rows filled from 8 slots up to
     att_len < C (dead slots, slots past the offset), and rows filled as the
     batched paths fill them at B=32 and 128 (C=256, ~200 slots) and at B=8
     (C=4096, ~4,000 slots), each with one all-dead row, timed as device time
     by graph replay over inputs cold in L2 beside a host loop, SDPA timed
     the same way, with each case's splits (the cluster's size), body, share
     of the bound and the parent kernel's time, and at B=1 (FD_B1_CASES: a
     b1 step under a mesh, 16 heads and TP=2's 8); gemv at 1, 8 and 32 rows for
     every product the paths send it (GEMV_GROUPS): the FlowLM's four, whole
     and at one rank's TP=2 shard shapes, plain and int8, the flow head's as
     f32 activations over bf16 weights, and the Mimi decoder transformer's
     four, the kernel and torch.matmul timed as device time by CUDA-graph
     replay (graph_ms), over weights cold in L2 and warm; gemv_stack at the
     int8 GEMV probe's size (48 x [4096, 1024] int8, -128 and 127 included)
     at 1, 3, 8, 32 and 48 rows, timed at 1, 8 and 32 rows as device time
     by graph replay (the 201 MB weight is cold in L2 by size) with its
     share of the bound and its effective GB/s;
  4. reference: a small f32 model's generate_audio (B=1) and
     generate_audio_batch (B=4, ragged voices and prompts) on the card
     (kernels, gemv included: the small FlowLM is 128 wide) against the same
     model and noise on the CPU (plain versions), over whole requests (EOS
     off: every frame up to the length limit, through the 1,1,8,...,32 block
     ramp; frames emitted and decoded are printed);
  5. main paths at english.yaml width with random weights, EOS off: bf16 b1
     (load_model, a voice state by a prompt pass over seeded conditioning,
     round-tripped through export_model_state / import; 3 generate_audio
     requests and one streamed request), then generate_audio_batch_from_texts
     at B=32 in bf16 and in int8 (quantize_config="attention_ffn"), at B=128
     in bf16 (its Mimi stack's T = 512 blocks through the chunked windowed
     attention; each profiled request's peak memory and device time, b128's
     beside the figures before the chunking), and b1
     generate_audio on the int8 model. Every launch counter is
     set to 0 just before each path and read just after; each path checks
     the counters its route predicts and that the callers' voice states are
     bit-unchanged, and prints audio-s/s beside the card's name and power
     limit;
  5b. voice cloning at english.yaml width: the port's own random f32 params
     (a seeded generator) written as a safetensors checkpoint, load_model
     from it in bf16 without allow_random_init, two wav voices (10 s mono
     24 kHz, 6 s stereo 44.1 kHz: the downmix and the resample) cloned
     through cached_get_state_for_audio_prompt (LRU(2): a, b, a with a hit),
     the encoder's time per voice-second in bf16 and f32, the first voice's
     f32 state on the card against the CPU's, then 2 b1 requests and one
     streamed on the cloned voice with the route and the cached state
     checked, and a profile of one request;
  5c. the serving surfaces over 5b's checkpoint, config and wavs: the CLI's
     export-voice (the state held to 5b's at the bf16 bar) and generate from
     the export, in process; `python -m pocket_tts_tpu_torch generate` in a
     subprocess with no --device (the card by default); the HTTP server
     (api/server.py on a ThreadingHTTPServer): /health, /, one url-encoded
     POST /tts on the default voice, then two at once (an LRU hit and a
     multipart voice_wav upload of the stereo wav), every WAV's length
     against the steps run, /metrics (3 requests, no failure or retry),
     the b1 route over the requests and the cached voice bit-unchanged;
     each request's voice, first-chunk and total ms and audio-s/s printed;
  5d. sharded serving over 5b's checkpoint, bf16: `python -m
     pocket_tts_tpu_torch.parallel.launch --processes 1` (NCCL, world 1; the
     report must say mesh_healthy), then in this process a 1 x 1 mesh with
     tensor_parallel=True on a b1 request (16 frames, a cloned voice) and a
     B=4 batch, each held to the unsharded model on the same card at the
     bf16 bar (the b1 route changes from the decode stack to the layer loop:
     decode_stack 0 launches, flash_decode at B=1, gemv); with two cards or
     more, 2 DP processes and TP=2 (`--tp-worker` ranks) against the
     1-process audio;
  5e. the HTTP server on a sharded model over 5b's checkpoint, bf16: an
     unsharded server, then this process as rank 0 of an NCCL group of one
     with the server's gloo control plane beside it and the model on a 1 x 1
     TP mesh behind the server; two requests each (the default voice, a
     voice_wav upload) and /health with the mesh's keys; the mesh server's
     audio held to the unsharded server's at the bf16 bar, its route checked
     (decode stack 0, flash_decode L a step, gemv >= 4L a step); first chunk
     ms, audio-s/s, per-chip audio-s/s and /health ms printed. With two cards
     or more, 2 ranks at TP=2 (`--server-rank` processes, rank 1 a follower)
     held to the 1 x 1 audio, then the follower killed inside a generation
     (rank 0 waiting in an NCCL all-reduce): /health 503 naming the lost
     heartbeat within HEALTH_TIMEOUT_S + 5 s, the request's stream cut (the
     mesh's NCCL communicators aborted) within HEALTH_TIMEOUT_S + 15 s, POST
     /tts 503 at once, rank 0 still answering and exiting with rc 0;
  5f. the quantization sweep (pocket_tts_tpu_torch.tools.evaluate_quantization
     --random-init --voices 1 --skip-wer) on english.yaml in f32: five rows
     printed and read back;
  5g. the flow-matching training step on the english.yaml FlowLM in f32
     (B=8, 64 latent frames, 16 tokens): step 0's loss and gradients on the
     card against the CPU at the f32 bar, then 20 Adam steps (the loss
     finite and lower at the end), ms per step between CUDA events, peak
     memory, and no hand-kernel launch;
  6. the 24-layer models: italian_24l b1 in bf16 (2 requests and one
     streamed, then a profile of one request and of a first chunk) and in
     int8 (2 requests), with the same checks;
  7. the int8 GEMV probe (pocket_tts_tpu_torch.tools.int8_gemv_probe): its
     four variants at full size, 1 and 32 rows, with a 0.15 s chain target,
     counting gemv_stack's launches.
The line before the last is one JSON object with the kernels' numbers; the
last is {"ok": true, "device": {...}}. Matmuls and convolutions run in full
f32 (TF32 off) wherever f32 is compared.

Kernel against plain, each output and each state tensor is held to
max |kernel - plain| <= REL_TOL x max |plain|. In f32 that is 1e-4 (the same
arithmetic summed in another order). In bf16 one rounding flipped by the
summation order moves a value by up to 2^-8 = 3.9e-3 of itself; the limit,
2e-2, allows about five such flips at the largest value (an H100 reads up to
8.7e-3 at these shapes) and fails an error of a few percent of the output.
That bf16 limit is per 6 layers of the decode stack: flips add along the
residual stream like a random walk, so 24 layers are held to sqrt(24 / 6) of
it. Any phase that fails, or a kernel launched on no path, fails the run.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 CUDA cores
REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fns, n: int = 40, reps: int = 7) -> float:
    """Device ms per call: n calls (cycling over `fns`) captured in one CUDA
    graph and replayed between CUDA events, the median of `reps` replays. No
    host launch cost is in it, unlike cuda_ms, whose loop of launches reads
    the host's launch rate below ~0.04 ms."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[reps // 2]


def rel_err(got, ref) -> tuple[float, float]:
    """max |got - ref|, and that over max |ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ------------------------------------------------------------ toy tokenizer


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num: int, wtype: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wtype) + payload


def _piece(text: str, score: float, ptype: int) -> bytes:
    body = _field(1, 2, _varint(len(text.encode())) + text.encode())
    body += _field(2, 5, struct.pack("<f", score))
    body += _field(3, 0, _varint(ptype))
    return _field(1, 2, _varint(len(body)) + body)


WORDS = ["hello", "world", "this", "is", "a", "test", "of", "the", "tts", "card",
         "speech", "runs", "on", "fast", "and", "small"]


def write_tokenizer(path: Path, n_pieces: int) -> None:
    """A toy SentencePiece model of exactly n_pieces pieces (as
    tests/test_cli_generate.py builds one, padded with unused pieces)."""
    normal, unknown, byte = 1, 2, 6
    data = _piece("<unk>", 0.0, unknown)
    count = 1
    for w in WORDS:
        data += _piece("▁" + w, -1.0, normal)
        count += 1
    for p in ".,!?":
        data += _piece(p, -1.5, normal)
        count += 1
    for b in range(256):
        data += _piece(f"<0x{b:02X}>", -20.0, byte)
        count += 1
    while count < n_pieces:
        data += _piece(f"▁zz{count}", -30.0, normal)
        count += 1
    norm = _field(2, 0, _varint(1)) + _field(4, 0, _varint(1)) + _field(5, 0, _varint(1))
    data += _field(3, 2, _varint(len(norm)) + norm)
    path.write_bytes(data)


def write_config(tmp: Path, small: bool = False, name: str = "english",
                 checkpoint: Path | None = None) -> Path:
    """A shipped config (english.yaml unless `name` says otherwise) with a
    local toy tokenizer (and, for `small`, the test suite's small geometry).
    Its checkpoint is the local file `checkpoint`, or none (random weights
    by allow_random_init): the smoke never reaches for the published one."""
    import yaml

    from pocket_tts_tpu_torch.config import CONFIGS_DIR

    cfg = yaml.safe_load((CONFIGS_DIR / f"{name}.yaml").read_text())
    n_bins = cfg["flow_lm"]["lookup_table"]["n_bins"]
    tok = tmp / "tokenizer.model"
    if not tok.exists():
        write_tokenizer(tok, n_bins)
    cfg["flow_lm"]["lookup_table"]["tokenizer_path"] = str(tok)
    cfg["weights_path"] = None if checkpoint is None else str(checkpoint)
    cfg["weights_path_without_voice_cloning"] = None
    if small:
        # FlowLM and flow-head widths of 128, so that their products of at
        # most 32 rows take the gemv kernel as at full width
        cfg["flow_lm"]["transformer"].update(d_model=128, num_heads=4, num_layers=2,
                                             hidden_scale=2)
        cfg["flow_lm"]["flow"].update(dim=128, depth=2)
        cfg["mimi"]["seanet"].update(dimension=64, n_filters=8)
        cfg["mimi"]["transformer"].update(d_model=64, num_heads=4, dim_feedforward=128,
                                          input_dimension=64, output_dimensions=[64],
                                          context=30)
        cfg["mimi"]["quantizer"].update(dimension=8, output_dimension=64)
        cfg["mimi"]["inner_dim"] = 8
        cfg["mimi"]["outer_dim"] = 64
    path = tmp / ("small.yaml" if small else
                  f"{name}{'' if checkpoint is None else '-' + checkpoint.stem}.yaml")
    path.write_text(yaml.safe_dump(cfg))
    return path


# ------------------------------------------------------------ kernel checks


def check_decode_stack(report: dict) -> None:
    import torch

    from pocket_tts_tpu_torch.nn.transformer import StackState, TransformerConfig
    from pocket_tts_tpu_torch.nn.transformer import init_layer_params
    from pocket_tts_tpu_torch.ops import decode_stack as ds
    from pocket_tts_tpu_torch.quant import quantize_flow_lm_int8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    # 6 layers (english.yaml) in every dtype; 24 layers (italian_24l and the
    # other 24-layer configs) in the serving dtypes, bf16 and int8 rows. The
    # caches run up to the pipeline's largest capacity (4096), where each
    # head's slots are split over the most blocks the grid gives it.
    cases = [(6, "bfloat16", torch.bfloat16, False,
              ((256, 100), (512, 300), (1024, 900), (4096, 3993))),
             (6, "float32", torch.float32, False, ((256, 100), (512, 300))),
             (6, "bfloat16", torch.bfloat16, True, ((256, 100), (4096, 3993))),
             (6, "float32", torch.float32, True, ((256, 100),)),
             (24, "bfloat16", torch.bfloat16, False, ((256, 100),)),
             (24, "bfloat16", torch.bfloat16, True, ((256, 100),))]
    for n_layers, dtype_name, dtype, quant, caches in cases:
        cfg = TransformerConfig(d_model=1024, num_heads=16, num_layers=n_layers,
                                dim_feedforward=4096)
        L, D, H, F = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.dim_feedforward
        # the bf16 bar is per 6 layers: flips add along the residual stream
        # like a random walk, so 24 layers get sqrt(24 / 6) = 2x of it
        depth = max(1.0, L / 6) ** 0.5 if dtype_name == "bfloat16" else 1.0
        tol = REL_TOL[dtype_name] * depth
        label = ("24l-" if L == 24 else "") + ("int8-" if quant else "") + dtype_name
        g.manual_seed(1)
        params = init_layer_params(cfg, g, dtype, dev)
        if quant:  # attention_ffn: all four products int8, f32 row scales
            params = quantize_flow_lm_int8({"transformer": params})["transformer"]
        for C, offset in caches:
            # mid-generation cache: positions 0..offset+6 in write order (the
            # last 7 speculative, past the offset), slot 5 dead (pos = -1)
            k = (torch.randn((L, 1, C, H, D // H), generator=g, device=dev) * 0.5).to(dtype)
            v = (torch.randn((L, 1, C, H, D // H), generator=g, device=dev) * 0.5).to(dtype)
            n_filled = offset + 7
            pos = torch.full((1, C), -1, dtype=torch.int32, device=dev)
            pos[0, :n_filled] = torch.arange(n_filled, dtype=torch.int32, device=dev)
            pos[0, 5] = -1
            x = (torch.randn((1, 1, D), generator=g, device=dev) * 0.3).to(dtype)
            off = torch.tensor([offset], dtype=torch.int32, device=dev)

            def fresh():
                return StackState(k.clone(), v.clone(), pos.clone(), off.clone(), n_filled)

            sk = fresh()
            h_k = ds._decode_stack_cuda(cfg, params, x, sk.k, sk.v, sk.pos, sk.offset, n_filled)
            sp = fresh()
            h_p = ds.decode_stack_plain(cfg, params, x, sp.k, sp.v, sp.pos, sp.offset, n_filled)
            torch.cuda.synchronize()
            err, rel = rel_err(h_k, h_p)
            rows = [rel_err(a[:, :, n_filled], b[:, :, n_filled])
                    for a, b in ((sk.k, sp.k), (sk.v, sp.v))]
            row_err, row_rel = max(r[0] for r in rows), max(r[1] for r in rows)
            others = torch.ones(C, dtype=torch.bool, device=dev)
            others[n_filled] = False
            untouched = (torch.equal(sk.k[:, :, others], k[:, :, others])
                         and torch.equal(sk.v[:, :, others], v[:, :, others]))
            if not torch.isfinite(h_k.float()).all():
                raise AssertionError(f"decode_stack {label} C={C}: non-finite output")
            if not untouched:
                raise AssertionError(f"decode_stack {label} C={C}: slots other than "
                                     "write_pos changed")
            def kernel():
                ds._decode_stack_cuda(cfg, params, x, sk.k, sk.v, sk.pos, sk.offset, n_filled)

            ms = graph_ms([kernel], n=20 if L == 24 else 40)
            host_ms = cuda_ms(kernel)
            plain_ms = cuda_ms(lambda: ds.decode_stack_plain(cfg, params, x, sp.k, sp.v, sp.pos,
                                                             sp.offset, n_filled), iters=5)
            es = torch.finfo(dtype).bits // 8
            valid = int(((pos >= 0) & (pos <= offset)).sum().item())
            rows_out = 3 * D + D + F + D  # output rows of the four products
            w_bytes = ((1 if quant else es) * (4 * D * D + 2 * F * D)
                       + (4 * rows_out if quant else 0))
            weights = L * (w_bytes + 4 * D * es)
            nbytes = weights + L * valid * 2 * D * es + L * 2 * D * es + 2 * D * es + C * 4
            flops = L * (2 * (4 * D * D + 2 * F * D) + 4 * (valid + 1) * D)
            b_ms, b_by = bound(nbytes, flops, dtype_name)
            if C == 256:  # one persistent launch per call, in every kind and depth
                # Each call also copies x once (Memcpy DtoD): a trace with fewer
                # than 20 copies lost records (CUPTI has dropped a window's first
                # calls) and is taken again, at most 3 times in all.
                for attempt in range(3):
                    kernels = profile(f"decode_stack {label} C=256 x20",
                                      lambda: [kernel() for _ in range(20)], top=4)
                    copies = sum(n for k, n, _ in kernels if "Memcpy DtoD" in k)
                    if copies == 20:
                        break
                    print(f"decode_stack {label}: the trace holds {copies} of 20 calls' "
                          "copies; profiled again")
                ours = {k: n for k, n, _ in kernels
                        if not any(t in k for t in ("at::native", "Memcpy", "Memset"))}
                if (copies != 20 or sum(ours.values()) != 20
                        or not all("stack_kernel" in k for k in ours)):
                    raise AssertionError(f"decode_stack {label}: kernels per 20 calls {ours} "
                                         f"({copies} copies traced)")
            print(f"decode_stack {label} C={C}: max_abs_err={err:.3g} rel={rel:.3g} "
                  f"row_err={row_err:.3g} row_rel={row_rel:.3g} rel_tol={tol} "
                  f"kernel_ms={ms:.4f} (graph replay; host loop {host_ms:.4f}) "
                  f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
                  f"{nbytes / 1e6:.1f} MB, {nbytes / ms / 1e6:.0f} GB/s effective, "
                  f"{100 * b_ms / ms:.1f}% of the bound)")
            if rel > tol or row_rel > tol:
                raise AssertionError(f"decode_stack {label} C={C}: max |kernel - plain| "
                                     f"/ max |plain| {rel:.3g} (row {row_rel:.3g}) > {tol}")
            report[("decode_stack", label, C)] = dict(
                max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def _rand_seanet_state(spec, B, dtype, g):
    import torch

    from pocket_tts_tpu_torch.nn.conv import ConvState, ConvTrState
    from pocket_tts_tpu_torch.nn.seanet import init_seanet_state

    state = init_seanet_state(spec, B, dtype, "cuda")

    def rnd(t):
        return (torch.randn(t.shape, generator=g, device="cuda") * 0.1).to(dtype)

    out = {}
    for key, s in state.items():
        if isinstance(s, ConvState):
            out[key] = ConvState(rnd(s.previous), torch.zeros_like(s.first))
        elif isinstance(s, ConvTrState):
            out[key] = ConvTrState(rnd(s.partial))
        else:
            out[key] = [ConvState(rnd(c.previous), torch.zeros_like(c.first)) for c in s]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


# The codec shapes (B, T0) held and timed, by dtype: every block the serving
# paths send in bf16 (the block ramp 1, 1, 8, ..., 32 frames of 16 positions,
# at B=1, 32 and 128), and the b1 and B=32 one- and eight-frame blocks in f32.
CODEC_SHAPES = {"bfloat16": tuple((B, T) for B in (1, 32, 128) for T in (16, 128, 512)),
                "float32": ((1, 16), (1, 16 * 8), (32, 16))}


def codec_flops(spec, T: int) -> int:
    """Multiply-adds x 2 of one row of the decoder program at T0 = T."""
    flops, t = 0, T
    for kind, op in spec.ops:
        if kind == "conv":
            flops += 2 * op.in_channels * op.out_channels * op.kernel_size * t
        elif kind == "convtr":
            flops += 2 * op.in_channels * op.out_channels * op.kernel_size * t
            t *= op.stride
        elif kind == "resblock":
            flops += sum(2 * c.in_channels * c.out_channels * c.kernel_size * t
                         for c in op.convs)
    return flops


def codec_tiles(cd, spec, params, packed, x, state, n: int, tiles: dict) -> str:
    """Each op of one bf16 decoder call alone, by graph replay: on the tile it
    takes, and with that tile passed over (the tile the op would take if the
    tile did not exist). Adds (with, without) per op to tiles[its tile]."""
    code = {name: c for c, name in cd.BODIES.items()}
    prog, _, _ = cd.codec_program(spec, params, packed, x, state)
    chosen = cd.run_program(prog)  # fills every op's input
    out = []
    for i, body in enumerate(chosen):
        ms = graph_ms([lambda i=i: cd.run_program(prog, [i])], n=n, reps=5)
        alt = cd.run_program(prog, [i], skip=1 << code[body])[0]
        alt_ms = graph_ms([lambda i=i: cd.run_program(prog, [i], skip=1 << code[body])],
                          n=n, reps=5)
        tiles.setdefault(body, []).append((ms, alt_ms))
        out.append(f"{ms:.4f} {body} | {alt_ms:.4f} {alt}")
    return "; ".join(out)


def check_codec(report: dict) -> None:
    """The decoder kernel against seanet_apply at CODEC_SHAPES with non-zero
    states; kernel times as device time by graph replay (graph_ms) beside the
    host-launched loop (cuda_ms), with the bound share and each op's body; in
    bf16 each op alone on its tile and without it (codec_tiles)."""
    import torch

    from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
    from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
    from pocket_tts_tpu_torch.nn.seanet import init_seanet_params, seanet_apply
    from pocket_tts_tpu_torch.ops import codec_decode as cd

    specs = build_mimi_specs(load_config(CONFIGS_DIR / "english.yaml").mimi)
    spec = specs.decoder
    g = torch.Generator(device="cuda")
    tiles: dict = {}
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = REL_TOL[dtype_name]
        g.manual_seed(2)
        params = init_seanet_params(spec, g, dtype, "cuda")
        packed = cd.pack_decoder_params(spec, params) if dtype == torch.bfloat16 else None
        for B, T in CODEC_SHAPES[dtype_name]:
            label = f"codec_decode {dtype_name} B={B} T={T}"
            x = torch.randn((B, specs.arch.dimension, T), generator=g, device="cuda").to(dtype)
            state = _rand_seanet_state(spec, B, dtype, g)

            def kernel():
                return cd._codec_decode_cuda(spec, params, packed, x, state)

            y_k, s_k = kernel()
            bodies = list(cd.KERNEL.bodies)
            y_p, s_p = seanet_apply(spec, params, x, state)
            torch.cuda.synchronize()
            if y_k.shape != y_p.shape or not torch.isfinite(y_k.float()).all():
                raise AssertionError(f"{label}: bad output {tuple(y_k.shape)}")
            err, rel = rel_err(y_k, y_p)
            states = [rel_err(a, b) for a, b in zip(_leaves(s_k), _leaves(s_p))
                      if a.is_floating_point() and a.numel()]
            st_err, st_rel = max(r[0] for r in states), max(r[1] for r in states)
            if not all(torch.equal(a, b) for a, b in zip(_leaves(s_k), _leaves(s_p))
                       if not a.is_floating_point()):
                raise AssertionError(f"{label}: integer states differ")
            want = "tc_" if dtype_name == "bfloat16" else "cuda_cores"
            if not all(b.startswith(want) for b in bodies):
                raise AssertionError(f"{label}: op bodies {bodies}")
            del y_k, s_k, y_p, s_p
            big = B * T >= 16384  # one call moves gigabytes: fewer calls per timing
            ms = graph_ms([kernel], n=4 if big else 40, reps=5 if big else 7)
            loop_ms = cuda_ms(kernel, iters=5 if big else 20)
            plain_ms = cuda_ms(lambda: seanet_apply(spec, params, x, state),
                               iters=3 if big else 10, warmup=1 if big else 3)
            es = torch.finfo(dtype).bits // 8
            w_elems = sum(t.numel() for t in _leaves(params) if t is not None)
            st_elems = sum(t.numel() for t in _leaves(state) if t.is_floating_point())
            out_elems = B * T * math.prod(op.stride for kind, op in spec.ops if kind == "convtr")
            nbytes = (w_elems + x.numel() + 2 * st_elems + out_elems) * es
            flops = B * codec_flops(spec, T)
            b_ms, b_by = bound(nbytes, flops, dtype_name)
            if dtype_name == "bfloat16" and (B, T) in ((1, 16), (128, 512)):
                n = 20 if B == 1 else 2
                profile(f"codec_decode bf16 B={B} T={T} x{n}",
                        lambda: [kernel() for _ in range(n)], top=12)
            print(f"{label}: max_abs_err={err:.3g} rel={rel:.3g} "
                  f"state_err={st_err:.3g} state_rel={st_rel:.3g} rel_tol={tol} "
                  f"kernel_ms={ms:.4f} (graph_ms; cuda_ms {loop_ms:.4f}) plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.2f} MB, {flops / 1e6:.0f} MFLOP) "
                  f"bound_share={b_ms / ms:.3f} {flops / ms / 1e9:.1f} TFLOP/s bodies={bodies}")
            if rel > tol or st_rel > tol:
                raise AssertionError(f"{label}: max |kernel - plain| / max |plain| {rel:.3g} "
                                     f"(states {st_rel:.3g}) > {tol}")
            if dtype_name == "bfloat16":
                print(f"{label} per op (ms, tile | without that tile): "
                      + codec_tiles(cd, spec, params, packed, x, state, 4 if big else 40, tiles))
            report[("codec_decode", dtype_name, B, T)] = dict(
                max_abs_err=err, ms=ms, cuda_ms=loop_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bodies=bodies)
    for body, pairs in sorted(tiles.items()):
        with_ms, without_ms = sum(p[0] for p in pairs), sum(p[1] for p in pairs)
        worst = max(p[1] / p[0] for p in pairs)
        print(f"codec tile {body}: taken by {len(pairs)} ops of CODEC_SHAPES, "
              f"{with_ms:.4f} ms on it, {without_ms:.4f} without it "
              f"(x{without_ms / with_ms:.3f}; worst op x{worst:.3f})")


def flash_inputs(g, B, C, H, Dh, dtype, att, fill="ramp"):
    """q, caches, k_new / v_new, pos, offset for one flash-decode call. Row 0
    is all dead unless B=1. "ramp": row b fills a prefix of 8 + (att - 8) b / (B - 1)
    slots, every 7th slot dead and its last 3 slots past the offset (half the
    attended slots dead on average); "serving": row b fills att - (b % 8)
    slots, as the batched paths fill their rows (a voice, the prompt, then
    the steps), with a few dead slots (every 61st, a ragged prompt's
    padding). v_new and k_new are strided views of a packed qkv row, as the
    main path gives them."""
    import torch

    q = torch.randn((B, H, Dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, C, H, Dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, C, H, Dh), generator=g, device="cuda").to(dtype)
    packed = torch.randn((B, 3, H, Dh), generator=g, device="cuda").to(dtype)
    pos = torch.full((B, C), -1, dtype=torch.int32, device="cuda")
    offset = torch.zeros((B,), dtype=torch.int32, device="cuda")
    for b in range(1 if B > 1 else 0, B):
        p = torch.arange(C, dtype=torch.int32, device="cuda")
        if fill == "ramp":
            n = min(att, 8 + (att - 8) * b // (B - 1))
            p[6::7] = -1
            offset[b] = n - 4
        else:
            n = att - b % 8
            p[29::61] = -1
            offset[b] = n - 1
        pos[b, :n] = p[:n]
    return q, k, v, packed[:, 1], packed[:, 2], pos, offset


# flash_decode cases (B, C, att_len, fill), each in bf16 and f32 (fill as in
# flash_inputs): the ramp at two batches and caches, the batched paths' own
# rows at B=32 and 128 (C=256, ~200 slots), and a long cache (~4,000 valid
# slots) at B=8.
FD_CASES = ((8, 256, 200, "ramp"), (32, 256, 200, "ramp"), (8, 1024, 900, "ramp"),
            (32, 1024, 900, "ramp"), (32, 256, 200, "serving"), (128, 256, 200, "serving"),
            (8, 4096, 4064, "serving"))
# B=1 cases (B, C, att_len, heads), "serving" fill: a b1 step under a mesh
# (the decode stack refused) with all 16 heads (TP degree 1) or 8 (TP=2)
FD_B1_CASES = ((1, 256, 200, 16), (1, 1024, 900, 16), (1, 256, 200, 8))
# Timed over input sets of at least this many cache bytes in all (4x the
# H100's 50 MB L2), so every call reads its cache rows from HBM, as the
# serving paths do (6 layers of caches outgrow the L2 at B=32).
FD_COLD_BYTES = 200e6


def flash_sets(args, n_sets: int):
    """n_sets copies of one call's inputs (the first is `args` itself)."""
    return [args] + [tuple(a.clone() for a in args) for _ in range(n_sets - 1)]


def flash_sdpa_inputs(args, att: int):
    """SDPA's inputs for the same function: q [B, H, 1, Dh], [cache || new]
    keys and values [B, H, att + 1, Dh] and the boolean mask."""
    import torch

    q, k, v, kn, vn, pos, off = args
    B = q.shape[0]
    valid = (pos[:, :att] >= 0) & (pos[:, :att] <= off[:, None])
    mask = torch.cat([valid, torch.ones((B, 1), dtype=torch.bool, device=q.device)],
                     dim=1)[:, None, None, :]
    kc = torch.cat([k[:, :att], kn[:, None]], dim=1).transpose(1, 2).contiguous()
    vc = torch.cat([v[:, :att], vn[:, None]], dim=1).transpose(1, 2).contiguous()
    return q[:, :, None, :].contiguous(), kc, vc, mask


def flash_bound(args, att: int, dtype_name: str) -> tuple[float, str, int, int]:
    """(bound ms, bound_by, bytes, valid slots) of one call: the valid key and
    value rows, q, k_new, v_new and the output once, pos and offset."""
    q, k, _, _, _, pos, off = args
    B, H, Dh = q.shape
    es = k.element_size()
    n_valid = int(((pos[:, :att] >= 0) & (pos[:, :att] <= off[:, None])).sum().item())
    nbytes = (2 * n_valid + 4 * B) * H * Dh * es + B * att * 4 + B * 4
    flops = 4 * (n_valid + B) * H * Dh
    b_ms, b_by = bound(nbytes, flops, dtype_name)
    return b_ms, b_by, nbytes, n_valid


# Device ms of the parent kernel (commit e5d17bc's csrc/flash_decode.cu: one
# block per (b, h) walking all of its row, K then V) at FD_CASES, by graph
# replay over inputs cold in L2 as below (H100 80GB HBM3 at 700 W), printed
# beside the kernel's own time.
PARENT_FD_MS = {
    ("bfloat16", 8, 256, "ramp"): 0.020644,
    ("bfloat16", 32, 256, "ramp"): 0.021062,
    ("bfloat16", 8, 1024, "ramp"): 0.075750,
    ("bfloat16", 32, 1024, "ramp"): 0.077737,
    ("bfloat16", 32, 256, "serving"): 0.022297,
    ("bfloat16", 128, 256, "serving"): 0.051503,
    ("bfloat16", 8, 4096, "serving"): 0.310980,
    ("float32", 8, 256, "ramp"): 0.031286,
    ("float32", 32, 256, "ramp"): 0.033385,
    ("float32", 8, 1024, "ramp"): 0.132843,
    ("float32", 32, 1024, "ramp"): 0.136197,
    ("float32", 32, 256, "serving"): 0.036334,
    ("float32", 128, 256, "serving"): 0.070340,
    ("float32", 8, 4096, "serving"): 0.593042,
}


def check_flash_decode(report: dict) -> None:
    import torch
    import torch.nn.functional as F

    from pocket_tts_tpu_torch.ops import flash_decode as fd

    def sdpa(s):
        return F.scaled_dot_product_attention(s[0], s[1], s[2], attn_mask=s[3])

    Dh = 64
    g = torch.Generator(device="cuda")
    cases = [(*c, 16) for c in FD_CASES] + [(B, C, att, "serving", H)
                                             for B, C, att, H in FD_B1_CASES]
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = REL_TOL[dtype_name]
        g.manual_seed(5)
        for B, C, att, fill, H in cases:
            label = f"flash_decode {dtype_name} B={B} C={C} att_len={att} {fill}"
            label += f" H={H}" if H != 16 else ""
            args = flash_inputs(g, B, C, H, Dh, dtype, att, fill)
            out_k = fd._flash_decode_cuda(*args, att_len=att)
            out_p = fd.flash_decode_plain(*args, att_len=att)
            torch.cuda.synchronize()
            if out_k.shape != (B, H, Dh) or not torch.isfinite(out_k.float()).all():
                raise AssertionError(f"{label}: bad output")
            err, rel = rel_err(out_k, out_p)
            dead_rel = 0.0 if B == 1 else rel_err(out_k[0], args[4][0])[1]  # all dead
            if rel > tol or dead_rel > tol:
                raise AssertionError(f"{label}: max |kernel - plain| / max |plain| {rel:.3g} "
                                     f"(all-dead row {dead_rel:.3g}) > {tol}")
            plan = fd.plan(*args, att_len=att)
            # device time over inputs cold in L2; the host loop reuses one set
            cache_bytes = 2 * args[1].numel() * args[1].element_size()
            sets = flash_sets(args, max(2, math.ceil(FD_COLD_BYTES / cache_bytes)))
            ms = graph_ms([lambda a=a: fd._flash_decode_cuda(*a, att_len=att) for a in sets],
                          n=max(40, len(sets)))
            host_ms = cuda_ms(lambda: fd._flash_decode_cuda(*args, att_len=att))
            plain_ms = cuda_ms(lambda: fd.flash_decode_plain(*args, att_len=att), iters=10)
            # library: SDPA of the same q over [cache || new] with the same
            # boolean mask, its inputs built outside the timed calls
            lib_sets = [flash_sdpa_inputs(a, att) for a in sets]
            lib_err, _ = rel_err(sdpa(lib_sets[0])[:, :, 0], out_p)
            lib_ms = graph_ms([lambda s=s: sdpa(s) for s in lib_sets], n=max(40, len(sets)))
            lib_host_ms = cuda_ms(lambda: sdpa(lib_sets[0]))
            del sets, lib_sets
            b_ms, b_by, nbytes, n_valid = flash_bound(args, att, dtype_name)
            parent = PARENT_FD_MS.get((dtype_name, B, C, fill), "not measured")
            print(f"{label}: {plan['splits']} splits ({plan['body']} body, {plan['smem']} B "
                  f"shared memory a block) max_abs_err={err:.3g} rel={rel:.3g} "
                  f"all_dead_rel={dead_rel:.3g} rel_tol={tol} kernel_ms={ms:.4f} (graph replay, "
                  f"cold; host loop {host_ms:.4f}) parent_ms={parent} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (host loop "
                  f"{lib_host_ms:.4f}; err {lib_err:.3g}) bound_ms={b_ms:.4f} ({b_by}, "
                  f"{nbytes / 1e6:.2f} MB, {n_valid} valid slots, "
                  f"{100 * b_ms / ms:.1f}% of the bound)")
            report[("flash_decode", dtype_name, B, C, fill) + ((H,) if H != 16 else ())] = dict(
                max_abs_err=err, ms=ms, cuda_ms=host_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_cuda_ms=lib_host_ms,
                splits=plan["splits"], body=plan["body"])


# Every product the smoke's paths send to the gemv kernel: [O, I] by name,
# and the (x dtype, W dtype, int8) kinds it comes in. The FlowLM's four in
# bf16 and int8 (the bf16 and attention_ffn models at B=32) and in f32, whole
# and as one rank's shard under TP=2 (in_proj and w1 split on output
# features, out_proj and w2 on input features: the parallel phase); the
# flow head's aligned linears as f32 activations over bf16 weights (every
# bf16 path) and in f32; the Mimi decoder transformer's four (d=512, F=2048)
# in bf16 and f32. Each at 1, 8 and 32 rows (b1, the block ramp, B=32).
GEMV_GROUPS = [
    ({"in_proj": (3072, 1024), "out_proj": (1024, 1024), "w1": (4096, 1024),
      "w2": (1024, 4096), "in_proj_tp2": (1536, 1024), "out_proj_tp2": (1024, 512),
      "w1_tp2": (2048, 1024), "w2_tp2": (1024, 2048)},
     [("bfloat16", "bfloat16", False), ("float32", "float32", False),
      ("bfloat16", "bfloat16", True), ("float32", "float32", True)]),
    ({"flow_cond_embed": (512, 1024), "flow_time_l0": (512, 256), "flow_mlp": (512, 512),
      "flow_ada": (1536, 512), "flow_final_ada": (1024, 512)},
     [("float32", "bfloat16", False), ("float32", "float32", False)]),
    ({"mimi_in_proj": (1536, 512), "mimi_out_proj": (512, 512), "mimi_w1": (2048, 512),
      "mimi_w2": (512, 2048)},
     [("bfloat16", "bfloat16", False), ("float32", "float32", False)]),
]


def gemv_label(x_name: str, w_name: str, quant: bool) -> str:
    return ("int8-" if quant else "") + (x_name if x_name == w_name
                                         else f"{x_name}-over-{w_name}")


# Bytes of weight copies the gemv timing cycles through, twice the 50 MB L2,
# so that each timed call finds its weights in HBM, as the serving paths'
# FlowLM products do (6 layers of bf16 weights are 151 MB).
GEMV_COLD_BYTES = 100e6


def check_gemv(report: dict) -> None:
    """Each gemv product against its plain version; the kernel and the
    torch.matmul yardstick timed as device time (graph_ms), over weights cold
    in L2 (kernel_ms, library_ms) and warm (the same weight each call)."""
    import torch

    from pocket_tts_tpu_torch.ops import gemv as gv
    from pocket_tts_tpu_torch.quant import quantize_weight

    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    for shapes, kinds in GEMV_GROUPS:
        for x_name, w_name, quant in kinds:
            xdt, wdt = dtypes[x_name], dtypes[w_name]
            # the product computes in promote(x, W), here always x's dtype
            tol = REL_TOL[x_name]
            label = gemv_label(x_name, w_name, quant)
            for name, (O, I) in shapes.items():
                ws_ = torch.finfo(wdt).bits // 8
                w_bytes = O * I * (1 if quant else ws_)
                Ws = [(torch.randn((O, I), generator=g, device="cuda") / I ** 0.5).to(wdt)
                      for _ in range(int(GEMV_COLD_BYTES // w_bytes) + 1)]
                wq = [quantize_weight(W) for W in Ws] if quant else Ws
                W, w = Ws[0], wq[0]
                for R in (1, 8, 32):
                    x = torch.randn((R, I), generator=g, device="cuda").to(xdt)
                    y_k = gv._gemv_cuda(x, w)
                    y_p = gv.gemv_plain(x, w)
                    torch.cuda.synchronize()
                    if (y_k.shape != (R, O) or y_k.dtype != y_p.dtype
                            or not torch.isfinite(y_k.float()).all()):
                        raise AssertionError(f"gemv {label} {name} R={R}: bad output")
                    err, rel = rel_err(y_k, y_p)
                    ms = graph_ms([lambda w=w: gv._gemv_cuda(x, w) for w in wq])
                    warm_ms = graph_ms([lambda: gv._gemv_cuda(x, w)])
                    plain_ms = cuda_ms(lambda: gv.gemv_plain(x, w))  # host-launched loop
                    # library: one torch.matmul for plain weights of x's
                    # dtype; no single call fuses the int8 dequant or takes
                    # f32 activations over bf16 weights
                    lib_ms = lib_warm = None
                    if not quant and xdt == wdt:
                        lib_ms = graph_ms([lambda W=W: torch.matmul(x, W.T) for W in Ws])
                        lib_warm = graph_ms([lambda: torch.matmul(x, W.T)])
                    xs = torch.finfo(xdt).bits // 8
                    nbytes = w_bytes + (4 * O if quant else 0) + R * I * xs + R * O * xs
                    b_ms, b_by = bound(nbytes, 2 * R * O * I, x_name)
                    lib = ("none" if lib_ms is None
                           else f"{lib_ms:.4f} (warm {lib_warm:.4f})")
                    print(f"gemv {label} {name} {O}x{I} R={R}: max_abs_err={err:.3g} "
                          f"rel={rel:.3g} rel_tol={tol} kernel_ms={ms:.4f} (warm {warm_ms:.4f}) "
                          f"library_ms={lib} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
                          f"({b_by}, {nbytes / 1e6:.2f} MB) bound_share={b_ms / ms:.2f}")
                    if rel > tol:
                        raise AssertionError(f"gemv {label} {name} R={R}: max |kernel - plain| "
                                             f"/ max |plain| {rel:.3g} > {tol}")
                    report[("gemv", label, name, R)] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib_ms)
                del Ws, wq


# The rows gemv_stack is held at, and the rows whose times are kept.
GEMV_STACK_ROWS = (1, 3, 8, 32, 48)
GEMV_STACK_TIMED = (1, 8, 32)


def check_gemv_stack(report: dict) -> None:
    """The stacked int8 GEMV against its plain version at the probe's full
    size (48 stacked [4096, 1024] int8 halves of a 24-layer model's FFN);
    int8 -128 and 127 in Wq (the probe's own draws stop at 126)."""
    import torch

    from pocket_tts_tpu_torch.ops import gemv_stack as gs
    from pocket_tts_tpu_torch.tools.int8_gemv_probe import I, L, O
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    Wq = torch.randint(-128, 128, (L, O, I), generator=g, device="cuda", dtype=torch.int8)
    Wq[0, :4, :16] = -128
    Wq[-1, -4:, -16:] = 127
    s = torch.rand((L, O), generator=g, device="cuda")
    n_min, n_max = int((Wq == -128).sum().item()), int((Wq == 127).sum().item())
    tol = REL_TOL["float32"]
    for R in GEMV_STACK_ROWS:
        x = torch.randn((R, I), generator=g, device="cuda").to(torch.bfloat16)
        y_k = gs._gemv_stack_cuda(x, Wq, s)
        y_p = gs.gemv_stack_plain(x, Wq, s)
        torch.cuda.synchronize()
        if y_k.shape != (L, R, O) or not torch.isfinite(y_k).all():
            raise AssertionError(f"gemv_stack R={R}: bad output {tuple(y_k.shape)}")
        err, rel = rel_err(y_k, y_p)
        nbytes = L * O * I + 4 * L * O + 2 * R * I + 4 * L * R * O
        b_ms, b_by = bound(nbytes, 2 * L * R * O * I, "bfloat16")
        line = (f"gemv_stack L={L} O={O} I={I} R={R}: max_abs_err={err:.3g} rel={rel:.3g} "
                f"rel_tol={tol} (Wq holds {n_min} x -128, {n_max} x 127)")
        if R in GEMV_STACK_TIMED:
            # device time; each call reads 201 MB, four times the L2: cold
            ms = graph_ms([lambda: gs._gemv_stack_cuda(x, Wq, s)])
            plain_ms = cuda_ms(lambda: gs.gemv_stack_plain(x, Wq, s), iters=5)
            # library: none; no single PyTorch call takes int8 weights and
            # bf16 x and gives the f32 sum scaled in f32
            line += (f" kernel_ms={ms:.4f} (graph replay) plain_ms={plain_ms:.4f} "
                     f"library_ms=none bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB, "
                     f"{100 * b_ms / ms:.1f}% of the bound, "
                     f"{nbytes / ms / 1e6:.0f} GB/s effective)")
            report[("gemv_stack", R)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(line)
        if rel > tol:
            raise AssertionError(f"gemv_stack R={R}: max |kernel - plain| / max |plain| "
                                 f"{rel:.3g} > {tol}")


# ------------------------------------------------------------ pipeline phases


def frame_source(noise):
    """A pre-drawn [frames, B, ldim] noise stream served K frames at a time,
    in whichever shape the pipeline asks for ((B, ldim) or (K, B, ldim))."""
    served = 0

    def source(shape):
        nonlocal served
        k = 1 if len(shape) == 2 else shape[0]
        out = noise[served:served + k].reshape(shape)
        served += k
        return out
    return source


def check_reference(tmp: Path) -> None:
    """The small model's generate_audio on the card against the CPU."""
    import numpy as np
    import torch

    from pocket_tts_tpu_torch.core.tree import tree_map
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    cfg = write_config(tmp, small=True)
    # EOS off, so the request runs the whole block ramp (see run_main_path)
    card = TTSModel.load_model(config=cfg, allow_random_init=True, device="cuda",
                               eos_threshold=1e9)
    def to_cpu(t):
        return t.cpu()

    cpu = TTSModel(card.specs, card.mimi_specs, tree_map(to_cpu, card.params),
                   tree_map(to_cpu, card.mimi_params), card.tokenizer, card.config, card.gen,
                   torch.device("cpu"))
    cond = torch.randn((1, 12, card.specs.transformer.d_model),
                       generator=torch.Generator().manual_seed(3))
    noise = np.random.default_rng(4).standard_normal((400, 1, card.specs.ldim)).astype(np.float32)
    noise *= card.gen.temp ** 0.5

    text = "hello world this is a test of the tts."
    reset_counts()
    card.decode_steps = 0
    a_card = card.generate_audio(card.state_for_conditioning(cond), text,
                                 noise_source=frame_source(noise))
    counts = read_counts()
    a_cpu = cpu.generate_audio(cpu.state_for_conditioning(cond), text,
                               noise_source=frame_source(noise))
    if a_card.shape != a_cpu.shape or a_card.size == 0:
        raise AssertionError(f"reference: lengths differ {a_card.shape} vs {a_cpu.shape}")
    if counts["decode_stack"] != card.decode_steps or counts["gemv"] == 0:
        raise AssertionError(f"reference: launches {counts} for {card.decode_steps} steps")
    err = float(np.abs(a_card - a_cpu).max())
    print(f"reference small f32 generate_audio card vs cpu: samples={a_card.size} "
          f"({a_card.size // card.samples_per_frame} frames emitted, {card.decode_steps} "
          f"decoded), launches {counts}, max_abs_err={err:.3g} tol=1e-3")
    if not err <= 1e-3:
        raise AssertionError(f"reference: card vs cpu max error {err:.3g} > 1e-3")


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def profile(label: str, fn, top: int = 8) -> list[tuple[str, int, float]]:
    """Run fn under torch.profiler: device busy share of the window and the
    kernels that take most device time. The profiler's own host cost makes
    the window longer, so the busy share is a lower bound. Returns every
    kernel of the window as (name, launches, device us)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels)
    print(f"profile {label}: window {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / wall_us:.1f}%)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:top]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    return [(e.key, e.count, _device_us(e)) for e in kernels]


def device_ms(fn):
    """(fn's result, the device time of its kernels and copies in ms):
    torch.profiler over CUDA activity alone, the durations summed from the
    raw trace events (reading them as `key_averages` does takes tens of
    seconds for a b128 request)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    return out, sum(e.duration_ns() for e in events
                    if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6


def kernel_modules() -> dict:
    from pocket_tts_tpu_torch.ops import codec_decode, decode_stack, flash_decode, gemv, gemv_stack

    return {"decode_stack": decode_stack, "codec_decode": codec_decode,
            "flash_decode": flash_decode, "gemv": gemv, "gemv_stack": gemv_stack}


def reset_counts() -> None:
    for mod in kernel_modules().values():
        mod.KERNEL.launches = 0


def read_counts() -> dict:
    return {name: mod.KERNEL.launches for name, mod in kernel_modules().items()}


def check_reference_batch(tmp: Path) -> None:
    """The small model's generate_audio_batch at B=4 on the card (flash-decode
    kernel) against the CPU: ragged voices and prompts, frame-indexed noise."""
    import numpy as np
    import torch

    from pocket_tts_tpu_torch.core.tree import tree_map
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    cfg = write_config(tmp, small=True)
    card = TTSModel.load_model(config=cfg, allow_random_init=True, device="cuda",
                               eos_threshold=1e9)

    def to_cpu(t):
        return t.cpu()

    cpu = TTSModel(card.specs, card.mimi_specs, tree_map(to_cpu, card.params),
                   tree_map(to_cpu, card.mimi_params), card.tokenizer, card.config, card.gen,
                   torch.device("cpu"))
    B, D, ldim = 4, card.specs.transformer.d_model, card.specs.ldim
    g = torch.Generator().manual_seed(11)
    conds = [torch.randn((1, n, D), generator=g) for n in (12, 5, 20, 9)]
    texts = ["hello world.", "this is a test of the tts card.", "small speech.",
             "the card runs fast and small speech on the world."]
    tokens = [card.tokenizer.encode(t) for t in texts]
    noise = np.random.default_rng(12).standard_normal((400, B, ldim)).astype(np.float32)
    noise *= card.gen.temp ** 0.5

    reset_counts()
    card.decode_steps = 0
    a_card = card.generate_audio_batch([card.state_for_conditioning(c) for c in conds], tokens,
                                       noise_source=frame_source(noise))
    counts, steps = read_counts(), card.decode_steps
    a_cpu = cpu.generate_audio_batch([cpu.state_for_conditioning(c) for c in conds], tokens,
                                     noise_source=frame_source(noise))
    L = card.specs.transformer.num_layers
    if counts["flash_decode"] != L * steps or steps == 0 or counts["gemv"] < 4 * L * steps:
        raise AssertionError(f"reference batch: launches {counts} for {steps} steps of {L} "
                             f"layers (want flash_decode {L * steps}, gemv at least "
                             f"{4 * L * steps})")
    if [a.shape for a in a_card] != [a.shape for a in a_cpu] or a_card[0].size == 0:
        raise AssertionError(f"reference batch: lengths differ {[a.shape for a in a_card]} vs "
                             f"{[a.shape for a in a_cpu]}")
    err = max(float(np.abs(a - b).max()) for a, b in zip(a_card, a_cpu))
    print(f"reference small f32 generate_audio_batch B={B} card vs cpu: prompts "
          f"{[len(t) for t in tokens]} tokens, samples per row {a_card[0].size} "
          f"({a_card[0].size // card.samples_per_frame} frames emitted, {steps} decoded), "
          f"launches {counts}, max_abs_err={err:.3g} tol=1e-3")
    if not err <= 1e-3:
        raise AssertionError(f"reference batch: card vs cpu max error {err:.3g} > 1e-3")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                 capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def make_voice(model, tmp: Path, name: str):
    """A voice state by a prompt pass over seeded conditioning, round-tripped
    through export_model_state / import_state."""
    import torch

    D = model.specs.transformer.d_model
    cond = torch.randn((1, 50, D), generator=torch.Generator(device="cuda").manual_seed(7),
                       device="cuda")
    made = model.state_for_conditioning(cond)
    voice_file = tmp / f"{name}.safetensors"
    model.export_model_state(made, voice_file)
    voice = model.import_state(voice_file)
    n = int(made.offset[0])
    if not (torch.equal(voice.offset, made.offset)
            and torch.equal(voice.k[:, :, :n], made.k[:, :, :n])
            and torch.equal(voice.v[:, :, :n], made.v[:, :, :n])):
        raise AssertionError("voice state changed in the export/import round trip")
    print(f"voice state ({name}): {n} positions, capacity {voice.k.shape[2]}, "
          f"dtype {voice.k.dtype}")
    return voice


def same_state(a, b) -> bool:
    import torch

    return (torch.equal(a.k, b.k) and torch.equal(a.v, b.v) and torch.equal(a.pos, b.pos)
            and torch.equal(a.offset, b.offset) and a.write_pos == b.write_pos)


def check_route(label: str, counts: dict, steps: int, L: int, b1: bool, skinny: bool) -> None:
    """The launch counters a path's route predicts: at B=1 the decode stack
    once per step and no flash decode; at B>1 flash decode once per layer per
    step and no decode stack; the codec kernel on every path; the gemv kernel
    on every product of at most 32 rows (at least the four per layer per step
    of the FlowLM at B<=32) and on none at B=128."""
    want_ds, want_fd = (steps, 0) if b1 else (0, L * steps)
    if steps == 0 or counts["decode_stack"] != want_ds or counts["flash_decode"] != want_fd:
        raise AssertionError(f"{label}: launches {counts} for {steps} decode steps of {L} "
                             f"layers (want decode_stack {want_ds}, flash_decode {want_fd})")
    if counts["codec_decode"] == 0:
        raise AssertionError(f"{label}: codec_decode never launched")
    if skinny and counts["gemv"] < (0 if b1 else 4 * L * steps) + 1:
        raise AssertionError(f"{label}: gemv launched {counts['gemv']} times for {steps} steps")
    if not skinny and counts["gemv"] != 0:
        raise AssertionError(f"{label}: gemv launched {counts['gemv']} times at more than "
                             "32 rows")


MAIN_TEXTS = ["hello world. this is a test of the tts.",
              "the card runs fast and small speech.",
              "this is a test. hello world, this is the speech of the card."]


def run_b1(model, voice, label: str, texts: list[str], seeds: list[int],
           stream_seed: int | None = None) -> dict:
    """b1 generate_audio requests on `model` (and one streamed request when
    `stream_seed` is given): counters set to 0 just before and read just
    after, the route's launches, finite audio and a bit-unchanged voice state
    checked, audio-s/s printed beside the card's name and power limit."""
    import numpy as np

    before = voice.clone()
    reset_counts()
    model.decode_steps = 0
    total_audio, total_wall = 0.0, 0.0
    for i, (text, seed) in enumerate(zip(texts, seeds)):
        t0 = time.perf_counter()
        audio = model.generate_audio(voice, text, seed=seed)
        wall = time.perf_counter() - t0
        if audio.size == 0 or audio.size % model.samples_per_frame or not np.isfinite(audio).all():
            raise AssertionError(f"{label} request {i}: bad audio ({audio.size} samples)")
        secs = audio.size / model.sample_rate
        total_audio += secs
        total_wall += wall
        print(f"{label} request {i}: {secs:.2f} s of audio in {wall:.3f} s "
              f"({secs / wall:.2f} audio-s/s)")
    first = ""
    if stream_seed is not None:
        t0 = time.perf_counter()
        stream = model.generate_audio_stream(voice, texts[0], seed=stream_seed)
        chunk = next(stream)
        first_ms = (time.perf_counter() - t0) * 1e3
        rest = sum(c.size for c in stream) + chunk.size
        print(f"{label} streamed request: first chunk {chunk.size} samples in {first_ms:.2f} ms, "
              f"{rest} samples in all")
        first = f"; first chunk {first_ms:.2f} ms"
    counts, steps = read_counts(), model.decode_steps
    check_route(label, counts, steps, model.specs.transformer.num_layers, b1=True, skinny=True)
    if not same_state(voice, before):
        raise AssertionError(f"{label}: a copy_state=True request changed the voice state")
    print(f"{label}: {len(texts)} requests, {total_audio:.2f} s of audio in {total_wall:.3f} s: "
          f"{total_audio / total_wall:.2f} audio-s/s ({steps} decode steps, launches {counts})"
          f"{first} [{card_line()}]")
    return counts


def run_main_path(tmp: Path):
    """The b1 bf16 path: 3 requests and one streamed request."""
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    cfg = write_config(tmp)
    # Random weights put the EOS logit above the default threshold at the
    # first step; with EOS off every request runs to its length limit.
    model = TTSModel.load_model(config=cfg, allow_random_init=True, param_dtype="bfloat16",
                                eos_threshold=1e9)
    voice = make_voice(model, tmp, "voice-bf16")
    launches = run_b1(model, voice, "main path b1 bf16", MAIN_TEXTS, [1, 2, 3], stream_seed=9)
    # enough rows for every decode-stack and codec kernel
    profile("one generate_audio request",
            lambda: model.generate_audio(voice, MAIN_TEXTS[1], seed=4), top=16)
    return model, voice, launches


BATCH_TEXTS = ["hello world. this is a test of the tts.",
               "the card runs fast and small speech.",
               "this is a test of the speech.",
               "small and fast, the card runs the world.",
               "hello card.",
               "the tts runs on the card and the speech is small.",
               "a test of the world.",
               "fast speech is a small test."]


def run_batch(model, voice, B: int, label: str, seed: int, profile_it: bool = False) -> dict:
    """generate_audio_batch_from_texts over B rows (B copies of one B=1
    voice state), twice (the first warms the shapes); counters reset before
    and read after each run. With `profile_it`, one more request under the
    profiler: its device time and its peak memory above what was held."""
    import numpy as np
    import torch

    before = voice.clone()
    texts = [BATCH_TEXTS[i % len(BATCH_TEXTS)] for i in range(B)]
    L = model.specs.transformer.num_layers
    total = {}
    for run in range(2):
        reset_counts()
        model.decode_steps = 0
        t0 = time.perf_counter()
        outs = model.generate_audio_batch_from_texts([voice] * B, texts, seed=seed + run)
        wall = time.perf_counter() - t0
        counts, steps = read_counts(), model.decode_steps
        total = {k: total.get(k, 0) + n for k, n in counts.items()}
        if len(outs) != B or any(a.size == 0 or a.size % model.samples_per_frame
                                 or not np.isfinite(a).all() for a in outs):
            raise AssertionError(f"{label}: bad audio {[a.size for a in outs]}")
        check_route(label, counts, steps, L, b1=False, skinny=B <= 32)
        secs = sum(a.size for a in outs) / model.sample_rate
        print(f"{label} run {run}: B={B}, {secs:.2f} s of audio in {wall:.3f} s: "
              f"{secs / wall:.2f} audio-s/s ({steps} decode steps, {1e3 * wall / steps:.2f} ms "
              f"per step, launches {counts}) [{card_line()}]")
    if not same_state(voice, before):
        raise AssertionError(f"{label}: the callers' voice state changed")
    if profile_it:
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels = profile(f"one {label} request", lambda: model.generate_audio_batch_from_texts(
            [voice] * B, texts, seed=seed), top=16)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        busy = sum(us for _, _, us in kernels)
        fd_us = sum(us for k, _, us in kernels if "flash_decode" in k)
        fd_n = sum(n for k, n, _ in kernels if "flash_decode" in k)
        print(f"{label}: flash_decode {fd_us / 1e3:.3f} ms of the request's {busy / 1e3:.2f} ms "
              f"device time ({100 * fd_us / busy:.1f}%) in {fd_n} launches "
              f"({fd_us / max(fd_n, 1):.2f} us each); peak memory {peak:.3f} GiB above the "
              f"{held / 2**30:.2f} GiB held [{card_line()}]")
        if B == 128:
            print(f"{label} before the chunked Mimi attention (one masked product): device "
                  f"time {PARENT_B128_DEVICE_MS} ms (the parent commit's smoke), peak memory "
                  f"{PARENT_B128_PEAK_GIB} GiB above what was held (--mimi-attention-check); "
                  "PERF.md")
    return total


# The b128 bf16 request before its Mimi blocks of T = 512 were attended in
# 64-query chunks (one masked product), on an H100 80GB HBM3 at 700 W
# (PERF.md): its device time by the profile of the parent commit's own
# smoke (which does not read peak memory), and its peak memory above what
# was held by `chip_smoke.py --mimi-attention-check`.
PARENT_B128_DEVICE_MS = 559.82
PARENT_B128_PEAK_GIB = 7.153


def mimi_attention_check() -> int:
    """`chip_smoke.py --mimi-attention-check`: not part of the smoke; it
    answers once what chunking the Mimi stack's long blocks changed. The
    b128 request on english.yaml width on one seed, its Mimi blocks of
    T = 512 through the chunked windowed attention (the route), then as one
    masked product (nn.transformer.CHUNKED_MIN_T raised past every block:
    the route before), in bf16 and in f32: each run's peak memory above
    what was held and device time (device_ms), and the chunked audio's gap
    to the one product's (max |a - b| / max |b|; bf16 held to its bar, f32
    printed: a gap near f32 rounding says the bf16 gap is bf16 rounding)."""
    import torch

    from pocket_tts_tpu_torch.nn import transformer as tr
    from pocket_tts_tpu_torch.ops import build
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    build.build_all([m.KERNEL for m in kernel_modules().values()])
    texts = [BATCH_TEXTS[i % len(BATCH_TEXTS)] for i in range(128)]
    chunked_min_t = tr.CHUNKED_MIN_T
    with tempfile.TemporaryDirectory() as d:
        for dtype in ("bfloat16", "float32"):
            model = TTSModel.load_model(config=write_config(Path(d)), allow_random_init=True,
                                        param_dtype=dtype, eos_threshold=1e9)
            voice = make_voice(model, Path(d), f"voice-{dtype}")
            model.generate_audio_batch_from_texts([voice] * 128, texts, seed=209)  # warm
            runs = {}
            for label, min_t in (("chunked", chunked_min_t), ("one product", 1 << 30)):
                tr.CHUNKED_MIN_T = min_t
                try:
                    gc.collect()
                    torch.cuda.empty_cache()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    runs[label], ms = device_ms(lambda: model.generate_audio_batch_from_texts(
                        [voice] * 128, texts, seed=210))
                    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                finally:
                    tr.CHUNKED_MIN_T = chunked_min_t
                print(f"b128 {dtype} Mimi attention {label}: peak memory {peak:.3f} GiB above "
                      f"the {held / 2**30:.2f} GiB held, device time {ms:.2f} ms "
                      f"[{card_line()}]")
            if dtype == "bfloat16":
                hold_audio("b128 bf16 chunked vs one product", runs["chunked"],
                           runs["one product"])
            else:
                got, want = runs["chunked"], runs["one product"]
                err = max(float(abs(a - b).max()) for a, b in zip(got, want))
                rel = err / max(float(abs(b).max()) for b in want)
                print(f"b128 f32 chunked vs one product: max_abs_err={err:.3g} rel={rel:.3g}")
            del model, voice
    print("mimi attention check: done")
    return 0


def run_batched_paths(tmp: Path, model, voice) -> dict:
    """B=32 bf16, B=128 bf16, then the int8 model: B=32 and b1."""
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    paths = {}
    for label, run in (("b32 bf16", lambda: run_batch(model, voice, 32, "b32 bf16", 100,
                                                      profile_it=True)),
                       ("b128 bf16", lambda: run_batch(model, voice, 128, "b128 bf16", 200,
                                                       profile_it=True))):
        t0 = time.perf_counter()
        paths[label] = run()
        print(f"{label}: path {time.perf_counter() - t0:.1f} s with its profiles")
    q_model = TTSModel.load_model(config=write_config(tmp), allow_random_init=True,
                                  param_dtype="bfloat16", eos_threshold=1e9,
                                  quantize_config="attention_ffn")
    q_voice = make_voice(q_model, tmp, "voice-int8")
    t0 = time.perf_counter()
    paths["b32 int8"] = run_batch(q_model, q_voice, 32, "b32 int8", 300, profile_it=True)
    paths["b1 int8"] = run_b1(q_model, q_voice, "b1 int8", BATCH_TEXTS[:2], [400, 401])
    print(f"int8 paths: {time.perf_counter() - t0:.1f} s with the load and the profile")
    return paths


def run_24l_paths(tmp: Path) -> dict:
    """italian_24l (a 24-layer FlowLM; the other 24-layer configs differ only
    in their weights) at b1: bf16 (2 requests and one streamed) and int8
    attention_ffn (2 requests)."""
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    cfg = write_config(tmp, name="italian_24l")
    paths = {}
    for label, quant in (("24l b1 bf16", None), ("24l b1 int8", "attention_ffn")):
        model = TTSModel.load_model(config=cfg, allow_random_init=True, param_dtype="bfloat16",
                                    eos_threshold=1e9, quantize_config=quant)
        if model.specs.transformer.num_layers != 24:
            raise AssertionError(f"{label}: {model.specs.transformer.num_layers} layers")
        voice = make_voice(model, tmp, label.replace(" ", "-"))
        paths[label] = run_b1(model, voice, label, MAIN_TEXTS[:2], [500, 501],
                              stream_seed=None if quant else 509)
        if quant is None:  # where a 24-layer request and its first chunk spend their time
            profile(f"one {label} request",
                    lambda: model.generate_audio(voice, MAIN_TEXTS[1], seed=502), top=12)
            profile(f"{label} first chunk",
                    lambda: next(model.generate_audio_stream(voice, MAIN_TEXTS[0], seed=503)),
                    top=12)
    return paths


def write_wav(path: Path, seconds: float, rate: int, channels: int, seed: int) -> None:
    """A voice file by the stdlib wave module: 16-bit PCM of seeded noise
    shaped like speech (a 150 Hz buzz with 4 Hz syllables)."""
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    buzz = np.sign(np.sin(2 * np.pi * 150 * t)) * (0.5 + 0.5 * np.sin(2 * np.pi * 4 * t))
    audio = 0.2 * buzz[:, None] + 0.05 * rng.standard_normal((t.size, channels))
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())


def event_ms(fn):
    """(fn's result, ms between CUDA events recorded before and after it)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def encoder_ms(model, wav: Path, label: str) -> float:
    """The Mimi encoder alone on one voice (read and resampled as
    get_state_for_audio_prompt does): warm, then the median of 3 runs
    between CUDA events, and the device time a profile of one run sums."""
    import torch

    from pocket_tts_tpu_torch.io.audio import audio_read, convert_audio
    from pocket_tts_tpu_torch.models.mimi import encode_to_latent

    audio, sr = audio_read(wav)
    audio = convert_audio(audio, sr, model.sample_rate, 1)
    x = torch.from_numpy(audio[None]).to(model.device)
    secs = x.shape[-1] / model.sample_rate

    def run():
        return encode_to_latent(model.mimi_specs, model.mimi_params, x)

    run()
    ms = sorted(event_ms(run)[1] for _ in range(3))[1]
    kernels = profile(f"encoder {label} {wav.name}", run, top=6)
    dev = sum(us for _, _, us in kernels) / 1e3
    print(f"encoder {label} {wav.name}: {secs:.2f} s of voice, {ms:.3f} ms between events "
          f"({ms / secs:.3f} ms per voice-second), device {dev:.3f} ms "
          f"({dev / secs:.3f} ms per voice-second) [{card_line()}]")
    return ms / secs


def run_voice_cloning(tmp: Path) -> tuple[dict, dict]:
    """Checkpoint loading and voice cloning at english.yaml width: the port's
    own random f32 params (a seeded generator) written as a checkpoint,
    load_model from it (no allow_random_init) in bf16, two wav voices cloned
    through cached_get_state_for_audio_prompt, the first also in f32 on the
    card against the CPU, then b1 requests on the cloned voice with the
    route and the cached state checked. Returns the launches of the path
    (the cloning and the requests), and the config, the two wavs and voice
    a's bf16 state for the surfaces phase."""
    import torch

    from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
    from pocket_tts_tpu_torch.core.bridge import to_numpy
    from pocket_tts_tpu_torch.core.weights import save_combined_checkpoint
    from pocket_tts_tpu_torch.io.audio import audio_read, convert_audio
    from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs, init_flow_lm_params
    from pocket_tts_tpu_torch.models.mimi import build_mimi_specs, init_mimi_params
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    t0 = time.perf_counter()
    cfg = load_config(CONFIGS_DIR / "english.yaml")
    mimi_specs = build_mimi_specs(cfg.mimi)
    g = torch.Generator(device="cuda").manual_seed(21)
    params = init_flow_lm_params(build_flow_lm_specs(cfg), g, torch.float32, "cuda")
    mimi = init_mimi_params(mimi_specs, g, torch.float32, "cuda")
    ckpt = tmp / "english-random.safetensors"
    save_combined_checkpoint(ckpt, to_numpy(params), mimi_specs, to_numpy(mimi))
    del params, mimi
    config = write_config(tmp, checkpoint=ckpt)
    print(f"voice cloning: checkpoint {ckpt.stat().st_size / 1e6:.1f} MB written in "
          f"{time.perf_counter() - t0:.2f} s")

    t1 = time.perf_counter()
    model = TTSModel.load_model(config=config, param_dtype="bfloat16", eos_threshold=1e9)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    if not model.has_voice_cloning or model.mimi_params["encoder"]["0"].weight.dtype != \
            torch.bfloat16:
        raise AssertionError("voice cloning: the checkpoint loaded without its encoder")
    print(f"voice cloning: load_model bf16 from the checkpoint in {load_s:.2f} s "
          f"[{card_line()}]")

    voices = {"a": (tmp / "voice-a-24k-mono.wav", 10.0, 24000, 1),
              "b": (tmp / "voice-b-44k-stereo.wav", 6.0, 44100, 2)}
    for i, (path, secs, rate, ch) in enumerate(voices.values()):
        write_wav(path, secs, rate, ch, seed=30 + i)
    # the host's one-time cost (scipy.signal's import by the first resample)
    # is kept out of the clone times below
    t2 = time.perf_counter()
    convert_audio(*audio_read(voices["b"][0]), model.sample_rate, 1)
    print(f"voice cloning: first wav read and resample (scipy.signal imported) "
          f"{(time.perf_counter() - t2) * 1e3:.1f} ms on the host")
    reset_counts()
    states, hits = {}, []
    for name in ("a", "b", "a"):  # LRU(2): a and b are built, the second a is a hit
        path = voices[name][0]
        state, ms = event_ms(lambda p=path: model.cached_get_state_for_audio_prompt(str(p)))
        hit = name in states
        if hit and state is not states[name]:
            raise AssertionError("voice cloning: LRU(2) rebuilt voice a")
        states.setdefault(name, state)
        hits.append(hit)
        print(f"voice cloning {name} ({path.name}): state of {int(state.offset[0])} positions "
              f"(capacity {state.k.shape[2]}, {state.k.dtype}) in {ms:.2f} ms between CUDA "
              f"events ({'LRU hit' if hit else 'built'})")
        if not (torch.isfinite(state.k.float()).all() and torch.isfinite(state.v.float()).all()):
            raise AssertionError(f"voice cloning {name}: non-finite bf16 state")
    clone_counts = read_counts()
    print(f"voice cloning LRU(2) a, b, a: hits {hits}, launches {clone_counts}")
    enc_bf16 = encoder_ms(model, voices["a"][0], "bf16")
    encoder_ms(model, voices["b"][0], "bf16")

    # f32 on the card against the CPU, the same checkpoint and voice
    card32 = TTSModel.load_model(config=config, eos_threshold=1e9)
    cpu32 = TTSModel.load_model(config=config, eos_threshold=1e9, device="cpu")
    enc_f32 = encoder_ms(card32, voices["a"][0], "f32")
    got = card32.get_state_for_audio_prompt(voices["a"][0])
    want = cpu32.get_state_for_audio_prompt(voices["a"][0])
    errs = [rel_err(getattr(got, n).cpu(), getattr(want, n)) for n in ("k", "v")]
    err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    same_pos = (torch.equal(got.pos.cpu(), want.pos) and torch.equal(got.offset.cpu(), want.offset)
                and got.write_pos == want.write_pos)
    print(f"voice cloning f32 state card vs cpu: {int(want.offset[0])} positions, "
          f"max_abs_err={err:.3g} rel={rel:.3g} rel_tol={REL_TOL['float32']}")
    if rel > REL_TOL["float32"] or not same_pos:
        raise AssertionError(f"voice cloning: f32 state card vs cpu rel {rel:.3g} "
                             f"(positions equal: {same_pos})")
    del card32, cpu32, got, want

    voice = states["a"]
    counts = run_b1(model, voice, "voice cloning b1 bf16", MAIN_TEXTS[:2], [600, 601],
                    stream_seed=609)
    if model.cached_get_state_for_audio_prompt(str(voices["a"][0])) is not voice:
        raise AssertionError("voice cloning: the cached voice state was evicted")
    profile("one cloned-voice request",
            lambda: model.generate_audio(voice, MAIN_TEXTS[1], seed=602), top=8)
    print(f"voice cloning: encoder {enc_bf16:.3f} ms (bf16) and {enc_f32:.3f} ms (f32) per "
          f"voice-second between events; phase {time.perf_counter() - t0:.1f} s "
          f"[{card_line()}]")
    reuse = {"config": config, "wav_a": voices["a"][0], "wav_b": voices["b"][0],
             "state_a": voice}
    return {k: counts[k] + clone_counts[k] for k in counts}, reuse


# ------------------------------------------------------------ serving surfaces


SURFACE_TEXTS = ["hello world. this is a test of the tts.",
                 "the card runs fast and small speech.",
                 "this is a test of the speech on the card.",
                 "small and fast, the card runs the world."]


def expected_frames(model, text: str) -> tuple[int, int]:
    """(frames emitted, FlowLM decode steps) of a request with EOS off: each
    sentence chunk emits every frame up to its length limit, decoded in the
    pipeline's block ramp (the last block may run past the limit)."""
    from pocket_tts_tpu_torch.default_parameters import MAX_TOKEN_PER_CHUNK
    from pocket_tts_tpu_torch.pipeline.tts import _block_size
    from pocket_tts_tpu_torch.text.splitter import split_into_best_sentences

    frames = steps = 0
    chunks = split_into_best_sentences(model.tokenizer, text, MAX_TOKEN_PER_CHUNK,
                                       model.pad_with_spaces_for_short_inputs,
                                       model.remove_semicolons)
    for i, chunk in enumerate(chunks):
        limit = model._estimate_max_gen_len(len(model._encode_text(chunk)))
        n = 0
        while n < limit:
            n += _block_size(n, warm=i > 0)
        frames, steps = frames + limit, steps + n
    return frames, steps


def check_wav(label: str, data: bytes, model, frames: int) -> None:
    """A streamed 16-bit mono WAV at the model's rate whose PCM holds `frames`
    frames and the writer's 0.2 s tail. The header claims an open-ended size,
    so the length is judged from the bytes."""
    import numpy as np

    fmt = struct.unpack("<4sI4s4sIHHIIHH4sI", data[:44]) if len(data) >= 44 else None
    if fmt is None or fmt[0] != b"RIFF" or fmt[2:4] != (b"WAVE", b"fmt ") or fmt[11] != b"data":
        raise AssertionError(f"{label}: not a WAV ({data[:16]!r})")
    channels, rate, bits = fmt[6], fmt[7], fmt[10]
    want = frames * model.samples_per_frame + int(0.2 * model.sample_rate)
    pcm = np.frombuffer(data[44:44 + 2 * ((len(data) - 44) // 2)], "<i2")
    if (channels, rate, bits) != (1, model.sample_rate, 16) or (len(data) - 44) != 2 * want:
        raise AssertionError(f"{label}: {channels} channels at {rate} Hz, {bits} bits, "
                             f"{len(data) - 44} PCM bytes (want mono {model.sample_rate} Hz "
                             f"16-bit, {2 * want} bytes for {frames} frames and the tail)")
    if not np.abs(pcm[:frames * model.samples_per_frame]).max() > 0:
        raise AssertionError(f"{label}: silent audio")


def run_surfaces(tmp: Path, config: Path, wav_a: Path, wav_b: Path, state_a) -> dict:
    """The serving surfaces on the card, over the voice-cloning phase's
    checkpoint, config and wavs: the CLI's export-voice (the state against
    the one that phase cloned from wav a) and generate from the export (in
    process, the b1 route checked), `python -m pocket_tts_tpu_torch generate`
    in a subprocess with no --device (the card is the default), then the
    HTTP server on a ThreadingHTTPServer: /health and /, one url-encoded
    POST /tts on the default voice (a clone into the LRU), then two at
    once (the default voice again, an LRU hit, and a multipart voice_wav
    upload of wav b), every body a WAV of the expected length, /metrics,
    the route over the three requests and the cached state bit-unchanged.
    Returns the launches of the path (the CLI in process and the server)."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    import torch

    from pocket_tts_tpu_torch.api import cli
    from pocket_tts_tpu_torch.api.server import ServingMetrics, make_handler
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    t0 = time.perf_counter()
    model = TTSModel.load_model(config=config, param_dtype="bfloat16", eos_threshold=1e9)
    print(f"surfaces: tokenizer {type(model.tokenizer).__name__}")
    L = model.specs.transformer.num_layers
    launches = {k: 0 for k in kernel_modules()}

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # the CLI in process: export-voice, then generate from the export
    exported = tmp / "surfaces-voice-a.safetensors"
    reset_counts()
    if cli.main(["-q", "export-voice", str(wav_a), str(exported), "--config", str(config),
                 "--dtype", "bfloat16"]) != 0:
        raise AssertionError("surfaces: export-voice failed")
    add(read_counts())
    got = model.import_state(exported)
    n = int(state_a.offset[0])
    if not (torch.equal(got.offset, state_a.offset) and got.write_pos == n):
        raise AssertionError(f"surfaces: exported voice has offset {got.offset.tolist()}, "
                             f"the cloned one {state_a.offset.tolist()}")
    errs = [rel_err(getattr(got, name)[:, :, :n], getattr(state_a, name)[:, :, :n])
            for name in ("k", "v")]
    rel = max(e[1] for e in errs)
    print(f"surfaces: export-voice state of {n} positions vs the cloned state: "
          f"max_abs_err={max(e[0] for e in errs):.3g} rel={rel:.3g} "
          f"rel_tol={REL_TOL['bfloat16']}")
    if rel > REL_TOL["bfloat16"]:
        raise AssertionError(f"surfaces: exported state rel {rel:.3g}")

    text = SURFACE_TEXTS[0]
    frames, steps = expected_frames(model, text)
    out = tmp / "surfaces-cli.wav"
    gen_args = ["-q", "generate", text, "--config", str(config), "--voice", str(exported),
                "--out", str(out), "--dtype", "bfloat16", "--seed", "0",
                "--eos-threshold", "1e9"]
    reset_counts()
    t1 = time.perf_counter()
    if cli.main(gen_args) != 0:
        raise AssertionError("surfaces: generate failed")
    counts = read_counts()
    check_route("surfaces cli generate", counts, steps, L, b1=True, skinny=True)
    check_wav("surfaces cli generate", out.read_bytes(), model, frames)
    add(counts)
    print(f"surfaces: cli generate {frames} frames ({steps} decode steps) in "
          f"{time.perf_counter() - t1:.2f} s with the model load, launches {counts}")

    # python -m, no --device: the card by default
    out_m = tmp / "surfaces-main.wav"
    t2 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pocket_tts_tpu_torch",
                           *[str(out_m) if a == str(out) else a for a in gen_args]],
                          cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"surfaces: python -m pocket_tts_tpu_torch exited "
                             f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    check_wav("surfaces python -m", out_m.read_bytes(), model, frames)
    print(f"surfaces: python -m pocket_tts_tpu_torch generate (default device) rc 0 in "
          f"{time.perf_counter() - t2:.2f} s")

    # the server
    class RecordingMetrics(ServingMetrics):
        """ServingMetrics that also keeps each request's own numbers."""

        def __init__(self):
            super().__init__()
            self.each: list[dict] = []

        def record(self, **kw) -> None:
            super().record(**kw)
            with self._lock:
                self.each.append(dict(self.last))

    metrics = RecordingMetrics()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(model, default_voice=str(wav_a), metrics=metrics))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if r.status != 200 or json.loads(r.read()) != {"status": "ok"}:
                raise AssertionError("surfaces: /health is not ok")
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            if r.status != 200 or b"<html" not in r.read().lower():
                raise AssertionError("surfaces: / is not the page")

        def post(data: bytes, ctype: str) -> bytes:
            req = urllib.request.Request(url + "/tts", data=data,
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=300) as r:
                if r.status != 200 or r.headers["Content-Type"] != "audio/wav":
                    raise AssertionError(f"surfaces: /tts answered {r.status}")
                return r.read()

        def form(t: str) -> tuple[bytes, str]:
            return ("text=" + t.replace(" ", "+")).encode(), \
                "application/x-www-form-urlencoded"

        boundary = "SURFACESBOUNDARY"
        upload = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"text\"\r\n\r\n"
                  f"{SURFACE_TEXTS[3]}\r\n--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"voice_wav\"; filename=\"{wav_b.name}\"\r\n"
                  "Content-Type: audio/wav\r\n\r\n").encode() + wav_b.read_bytes() + \
            f"\r\n--{boundary}--\r\n".encode()
        requests = [("default voice (clone)", *form(SURFACE_TEXTS[1]), SURFACE_TEXTS[1]),
                    ("default voice (LRU hit)", *form(SURFACE_TEXTS[2]), SURFACE_TEXTS[2]),
                    ("voice_wav upload", upload, f"multipart/form-data; boundary={boundary}",
                     SURFACE_TEXTS[3])]
        reset_counts()
        model.decode_steps = 0
        bodies = [post(*requests[0][1:3])]
        key = f"{wav_a}|True"
        cached = model._voice_state_cache[key]
        before = cached.clone()
        with ThreadPoolExecutor(max_workers=2) as pool:  # two at once
            futures = [pool.submit(post, *r[1:3]) for r in requests[1:]]
            bodies += [f.result() for f in futures]
        counts, served_steps = read_counts(), model.decode_steps
        want_steps = 0
        for (label, _, _, t), body in zip(requests, bodies):
            f, s = expected_frames(model, t)
            want_steps += s
            check_wav(f"surfaces /tts {label}", body, model, f)
        if served_steps != want_steps:
            raise AssertionError(f"surfaces: {served_steps} decode steps, want {want_steps}")
        check_route("surfaces server", counts, served_steps, L, b1=True, skinny=True)
        add(counts)
        if model._voice_state_cache.get(key) is not cached or not same_state(cached, before):
            raise AssertionError("surfaces: the cached default-voice state changed")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            snap = json.loads(r.read())
        if (snap["requests"], snap["failures"], snap["retries"]) != (3, 0, 0) or \
                snap["last_request"] != metrics.each[-1]:
            raise AssertionError(f"surfaces: /metrics {snap}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    for i, m in enumerate(metrics.each):
        print(f"surfaces /tts request {i}: voice_ms {m['voice_ms']} first_chunk_ms "
              f"{m['first_chunk_ms']} total_ms {m['total_ms']} audio_s {m['audio_s']} "
              f"audio_s_per_s {m['audio_s_per_s']}")
    print(f"surfaces: /metrics mean_voice_ms {snap['mean_voice_ms']} mean_first_chunk_ms "
          f"{snap['mean_first_chunk_ms']} overall_audio_s_per_s "
          f"{snap['overall_audio_s_per_s']}; server launches {counts} for {served_steps} "
          f"decode steps")
    print(f"surfaces: phase {time.perf_counter() - t0:.1f} s [{card_line()}]")
    return launches


# ------------------------------------------------------------ sharded serving


PARALLEL_TOKENS = [[3, 7, 2, 9, 4, 8], [9, 4, 8, 1], [5, 5, 2, 7, 1, 6, 3], [2, 9, 6]]
PARALLEL_FRAMES = 16  # the b1 request's length limit: blocks of 1, 1, 8 and 8 frames


def launch_report(args: list[str], label: str) -> dict:
    """`python -m pocket_tts_tpu_torch.parallel.launch` in a subprocess (its
    workers on the card over NCCL): the report line it prints last."""
    from pocket_tts_tpu_torch.parallel.launch import MULTIHOST_TAG

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pocket_tts_tpu_torch.parallel.launch", *args,
                          "--retries", "0", "--timeout", "300"],
                         cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                         timeout=360)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith(MULTIHOST_TAG)]
    if out.returncode or not lines:
        raise AssertionError(f"{label}: rc {out.returncode}\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    report = json.loads(lines[-1][len(MULTIHOST_TAG):])
    print(f"{label}: {report} in {time.perf_counter() - t0:.1f} s with the process start "
          f"[{card_line()}]")
    if not report["mesh_healthy"] or not all(n > 0 for n in report["row_samples"]):
        raise AssertionError(f"{label}: unhealthy mesh or empty rows: {report}")
    return report


def hold_audio(label: str, got: list, want: list) -> float:
    """Rows of audio held to the bf16 bar: max |got - want| <= REL_TOL x
    max |want| over all rows, lengths equal. Returns the relative error."""
    import numpy as np

    if [a.shape for a in got] != [a.shape for a in want] or want[0].size == 0:
        raise AssertionError(f"{label}: lengths {[a.shape for a in got]} vs "
                             f"{[a.shape for a in want]}")
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    rel = err / max(float(np.abs(b).max()) for b in want)
    print(f"{label}: {len(got)} rows of {[a.size for a in got]} samples, max_abs_err={err:.3g} "
          f"rel={rel:.3g} rel_tol={REL_TOL['bfloat16']}")
    if not (all(np.isfinite(a).all() for a in got) and rel <= REL_TOL["bfloat16"]):
        raise AssertionError(f"{label}: rel {rel:.3g} > {REL_TOL['bfloat16']}")
    return rel


def tp_stream(model, wav: Path, noise) -> "np.ndarray":
    """A b1 request from a voice cloned from `wav`: PARALLEL_TOKENS[0] for
    PARALLEL_FRAMES frames, EOS off, frame-indexed noise."""
    import numpy as np

    voice = model.get_state_for_audio_prompt(str(wav))
    return np.concatenate(list(model.generate_audio_stream_from_tokens(
        voice, PARALLEL_TOKENS[0], 2, noise_source=frame_source(noise),
        max_gen_len=PARALLEL_FRAMES)))


def parallel_noise(model, B: int, seed: int):
    import numpy as np

    noise = np.random.default_rng(seed).standard_normal((200, B, model.specs.ldim))
    return (noise * model.gen.temp ** 0.5).astype(np.float32)


def tp_worker(argv: list[str]) -> int:
    """`chip_smoke.py --tp-worker RANK WORLD PORT CONFIG WAV OUT`: one rank of
    a 1 x WORLD tensor-parallel job on cuda:RANK; rank 0 saves the b1
    request's audio to OUT (.npy)."""
    import numpy as np
    import torch

    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import assert_mesh_healthy, initialize_multihost
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    rank, world, port = map(int, argv[:3])
    config, wav, out = argv[3:6]
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank, device=f"cuda:{rank}")
    mesh = make_mesh(1, world)
    model = TTSModel.load_model(config=config, param_dtype="bfloat16", eos_threshold=1e9,
                                device=f"cuda:{rank}")
    model.shard_for_mesh(mesh, tensor_parallel=True)
    audio = tp_stream(model, Path(wav), parallel_noise(model, 1, 71))
    if not assert_mesh_healthy(mesh):
        raise RuntimeError("mesh heartbeat failed")
    if rank == 0:
        np.save(out, audio)
    torch.distributed.destroy_process_group()
    return 0


def run_tp2(config: Path, wav: Path, tmp: Path):
    """Two ranks of `tp_worker` on cuda:0 and cuda:1: rank 0's audio."""
    import socket

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp / "tp2.npy"
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-worker",
                               str(r), "2", str(port), str(config), str(wav), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        raise AssertionError("TP=2 workers failed:\n" + "\n".join(logs))
    return np.load(out)


def run_parallel(tmp: Path, config: Path, wav_a: Path) -> dict:
    """Sharded serving at english.yaml width in bf16 on the voice-cloning
    checkpoint: the launch driver with one process on the card (NCCL, world
    1), then in this process a 1 x 1 mesh with tensor_parallel=True (the
    decode stack refused: the layer loop with flash decode at B=1 and the
    gemv op) on a b1 request and on a B=4 batch, each held to the unsharded
    model on the same card at the bf16 bar, with its route checked. With two
    cards or more, also 2 DP processes and TP=2, each against the 1-process
    audio. Returns the sharded runs' launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import assert_mesh_healthy
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    t0 = time.perf_counter()
    args = ["--config", str(config), "--dtype", "bfloat16", "--utterances", "4"]
    one = launch_report(["--processes", "1", *args], "parallel launch 1 process")

    mesh = make_mesh(1, 1)
    if not assert_mesh_healthy(mesh):
        raise AssertionError("parallel: the 1 x 1 mesh heartbeat failed")
    ref = TTSModel.load_model(config=config, param_dtype="bfloat16", eos_threshold=1e9)
    tp = TTSModel.load_model(config=config, param_dtype="bfloat16", eos_threshold=1e9)
    tp.shard_for_mesh(mesh, tensor_parallel=True)
    L = tp.specs.transformer.num_layers
    noise1 = parallel_noise(ref, 1, 71)
    want1 = tp_stream(ref, wav_a, noise1)
    reset_counts()
    tp.decode_steps = 0
    got1 = tp_stream(tp, wav_a, noise1)
    counts, steps = read_counts(), tp.decode_steps
    check_route("parallel TP 1x1 b1", counts, steps, L, b1=False, skinny=True)
    hold_audio("parallel TP 1x1 b1 vs unsharded (decode stack)", [got1], [want1])

    voices_ref = [ref.get_state_for_audio_prompt(str(wav_a))] * 4
    voices_tp = [tp.get_state_for_audio_prompt(str(wav_a))] * 4
    noise4 = parallel_noise(ref, 4, 72)
    want4 = ref.generate_audio_batch(voices_ref, PARALLEL_TOKENS, frames_after_eos=2,
                                     noise_source=frame_source(noise4))
    reset_counts()
    tp.decode_steps = 0
    got4 = tp.generate_audio_batch(voices_tp, PARALLEL_TOKENS, frames_after_eos=2,
                                   noise_source=frame_source(noise4))
    counts4, steps4 = read_counts(), tp.decode_steps
    check_route("parallel TP 1x1 B=4", counts4, steps4, L, b1=False, skinny=True)
    hold_audio("parallel TP 1x1 B=4 vs unsharded", got4, want4)
    launches = {k: counts[k] + counts4[k] for k in counts}
    print(f"parallel TP 1x1: b1 {steps} steps, launches {counts}; B=4 {steps4} steps, "
          f"launches {counts4} [{card_line()}]")
    dist.destroy_process_group()
    del ref, tp

    ran = ["launch 1 process", "TP 1x1 b1", "TP 1x1 B=4"]
    if torch.cuda.device_count() >= 2:
        two = launch_report(["--processes", "2", *args], "parallel launch 2 processes")
        rel = abs(two["audio_checksum"] - one["audio_checksum"]) / one["audio_checksum"]
        print(f"parallel DP 2 processes vs 1: row samples {two['row_samples']} vs "
              f"{one['row_samples']}, checksum rel {rel:.3g}")
        if two["row_samples"] != one["row_samples"] or rel > REL_TOL["bfloat16"]:
            raise AssertionError("parallel: 2 DP processes differ from 1")
        hold_audio("parallel TP=2 b1 vs TP 1x1", [run_tp2(config, wav_a, tmp)], [got1])
        ran += ["launch 2 processes (DP)", "TP=2 b1"]
    print(f"parallel: ran {ran} on {torch.cuda.device_count()} card(s); phase "
          f"{time.perf_counter() - t0:.1f} s [{card_line()}]")
    return launches


# ------------------------------------------------------------ server mesh


SERVER_SEED = 23  # every request's device noise seed, so two servers compare
SERVER_TEXTS = ["hello world. this is a test of the tts.",
                "the card runs fast and small speech."]


def with_seed(model, seed: int):
    """`model` whose every generate_audio_stream draws its device noise from
    `seed`, whatever seed the server passes (none without a mesh; under one,
    the one rank 0 drew for the request)."""
    real = model.generate_audio_stream

    def stream(state, text, **kw):
        return real(state, text, **{**kw, "seed": seed})

    model.generate_audio_stream = stream
    return model


@contextlib.contextmanager
def http_server(model, default_voice: Path, plane=None):
    """api/server.py's handler on a ThreadingHTTPServer on 127.0.0.1 in a
    thread (what `serve` runs on rank 0): yields (url, serving); shuts down
    and sends `stop` (`serving.stop`, as `serve` does) on exit."""
    import threading
    from http.server import ThreadingHTTPServer

    from pocket_tts_tpu_torch.api.server import make_handler

    handler = make_handler(model, str(default_voice), plane=plane)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", handler.serving
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        handler.serving.stop()


def http_call(url: str, path: str, data: bytes | None = None, ctype: str | None = None,
              timeout: float = 300.0) -> tuple[int, bytes, float]:
    """(status, body, ms) of one request; an error status is returned."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": ctype} if ctype else {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, body, (time.perf_counter() - t0) * 1e3


def mesh_requests(url: str, wav_b: Path, label: str, devices: int | None) -> list:
    """Two POST /tts (the default voice: a clone into the LRU; a multipart
    upload of wav b), then /health (timed) and /metrics: each WAV's PCM as
    float (1/32767), each request's first chunk ms, audio-s/s and per-chip
    audio-s/s printed. `devices`: the mesh's size (None: no mesh)."""
    import numpy as np

    boundary = "MESHBOUNDARY"
    upload = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"text\"\r\n\r\n"
              f"{SERVER_TEXTS[1]}\r\n--{boundary}\r\nContent-Disposition: form-data; "
              f"name=\"voice_wav\"; filename=\"{wav_b.name}\"\r\n"
              "Content-Type: audio/wav\r\n\r\n").encode() + wav_b.read_bytes() + \
        f"\r\n--{boundary}--\r\n".encode()
    bodies = []
    for data, ctype in ((("text=" + SERVER_TEXTS[0].replace(" ", "+")).encode(),
                         "application/x-www-form-urlencoded"),
                        (upload, f"multipart/form-data; boundary={boundary}")):
        status, body, _ = http_call(url, "/tts", data, ctype)
        if status != 200 or body[:4] != b"RIFF":
            raise AssertionError(f"{label}: /tts answered {status}: {body[:200]!r}")
        bodies.append(np.frombuffer(body[44:44 + 2 * ((len(body) - 44) // 2)],
                                    "<i2").astype(np.float32) / 32767)
    want = ({"status": "ok"} if devices is None else
            {"status": "ok", "mesh": "healthy", "devices": devices})
    health_ms = []
    for _ in range(2):  # the first heartbeat also sets up the mesh's communicator
        status, body, ms = http_call(url, "/health", timeout=60)
        if status != 200 or json.loads(body) != want:
            raise AssertionError(f"{label}: /health {status} {body!r}, want {want}")
        health_ms.append(f"{ms:.2f}")
    snap = json.loads(http_call(url, "/metrics", timeout=60)[1])
    if (snap["requests"], snap["failures"]) != (2, 0):
        raise AssertionError(f"{label}: /metrics {snap}")
    last = snap["last_request"]
    print(f"{label}: 2 requests, first chunk ms {last['first_chunk_ms']} (last), mean "
          f"{snap['mean_first_chunk_ms']}; audio-s/s {last['audio_s_per_s']} (last), overall "
          f"{snap['overall_audio_s_per_s']}; per chip {last['audio_s_per_s_per_chip']} "
          f"(last, {devices or 1} device(s)); /health ms {', '.join(health_ms)} "
          f"[{card_line()}]")
    return bodies


def run_server_mesh(tmp: Path, config: Path, wav_a: Path, wav_b: Path) -> dict:
    """The HTTP server on a sharded model, bf16, over the voice-cloning
    checkpoint: first an unsharded server (no mesh), then this process as
    rank 0 of an NCCL group of one with the server's gloo control plane
    beside it (parallel/multihost.ControlPlane), the model on a 1 x 1 TP mesh
    behind the server (api/server.make_handler with the plane, what `serve`
    runs on rank 0): two requests each (mesh_requests), /health with the
    mesh's keys, the mesh server's audio held to the unsharded server's at
    the bf16 bar and its route checked as run_parallel checks it (decode
    stack 0, flash_decode L a step, gemv >= 4L a step). With two cards or
    more, also 2 ranks at TP=2 (run_server_tp2). Returns the 1 x 1 server's
    launches."""
    import torch
    import torch.distributed as dist

    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import ControlPlane
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    t0 = time.perf_counter()

    def load():
        return with_seed(TTSModel.load_model(config=config, param_dtype="bfloat16",
                                             eos_threshold=1e9), SERVER_SEED)

    with http_server(load(), wav_a) as (url, _):
        want = mesh_requests(url, wav_b, "server unsharded", None)
    mesh = make_mesh(1, 1)
    plane = ControlPlane()
    model = load()
    model.shard_for_mesh(mesh, tensor_parallel=True)
    L = model.specs.transformer.num_layers
    reset_counts()
    model.decode_steps = 0
    with http_server(model, wav_a, plane) as (url, serving):
        got = mesh_requests(url, wav_b, "server mesh TP 1x1", 1)
        if serving.error is not None:
            raise AssertionError(f"server mesh TP 1x1: degraded: {serving.error}")
    counts, steps = read_counts(), model.decode_steps
    check_route("server mesh TP 1x1", counts, steps, L, b1=False, skinny=True)
    hold_audio("server mesh TP 1x1 vs unsharded server", got, want)
    print(f"server mesh TP 1x1: {steps} decode steps, launches {counts}")
    dist.destroy_process_group()
    del model
    if torch.cuda.device_count() >= 2:
        hold_audio("server mesh TP=2 vs TP 1x1", run_server_tp2(tmp, config, wav_a, wav_b), got)
    print(f"server mesh: phase {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.device_count()} card(s) [{card_line()}]")
    return counts


def server_rank(argv: list[str]) -> int:
    """`chip_smoke.py --server-rank RANK WORLD PORT CONFIG WAV_A WAV_B OUT
    [FOLLOWER_PID]`: one rank of a 1 x WORLD TP job behind one server on
    cuda:RANK. A follower (RANK > 0) runs api/server.follow; rank 0 serves
    mesh_requests, then starts a long request and, once its first chunk has
    come, kills FOLLOWER_PID: rank 0's request thread is then in an NCCL
    all-reduce that will not end by itself. It checks that /health answers
    503 naming the lost heartbeat within HEALTH_TIMEOUT_S + 5 s, that the
    request's stream ends cut within HEALTH_TIMEOUT_S + 15 s (the watch
    aborted the mesh's NCCL communicators), that POST /tts answers 503 at
    once and /health 503 after another HEALTH_TIMEOUT_S; it saves the two
    requests' PCM and those times to OUT (.npz) and leaves without tearing
    the broken groups down. Stages are printed as they pass, and every
    thread's stack is dumped if the loss is not handled in time."""
    import faulthandler
    import http.client
    import logging
    import os
    import signal
    import traceback
    import urllib.request

    import numpy as np
    import torch

    from pocket_tts_tpu_torch.api.server import follow
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import (
        HEALTH_TIMEOUT_S,
        ControlPlane,
        initialize_multihost,
    )
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    rank, world, port = map(int, argv[:3])
    config, wav_a, wav_b, out = argv[3:7]
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{port}", world, rank, device=f"cuda:{rank}")
    mesh = make_mesh(1, world)
    model = with_seed(TTSModel.load_model(config=config, param_dtype="bfloat16",
                                          eos_threshold=1e9, device=f"cuda:{rank}"), SERVER_SEED)
    model.shard_for_mesh(mesh, tensor_parallel=True)
    plane = ControlPlane()
    if rank:
        follow(model, plane)
        return 0
    logging.basicConfig(level=logging.WARNING, stream=sys.stdout,
                        format="%(asctime)s %(threadName)s %(name)s: %(message)s")

    def stage(msg):
        print(f"server rank 0, {time.perf_counter() - t_kill:.2f} s after the kill: {msg}",
              flush=True)

    try:
        with http_server(model, Path(wav_a), plane) as (url, serving):
            bodies = mesh_requests(url, Path(wav_b), f"server mesh TP={world}", world)
            req = urllib.request.Request(
                url + "/tts",
                data=b"text=" + b"+".join([b"a+long+request+to+lose+a+rank."] * 4),
                headers={"Content-Type": "application/x-www-form-urlencoded"})
            r = urllib.request.urlopen(req, timeout=HEALTH_TIMEOUT_S + 60)
            first = len(r.read(44 + 3840))
            os.kill(int(argv[7]), signal.SIGKILL)
            t_kill = t0 = time.perf_counter()
            faulthandler.dump_traceback_later(HEALTH_TIMEOUT_S + 25, file=sys.stdout)
            while True:
                status, body, _ = http_call(url, "/health", timeout=HEALTH_TIMEOUT_S + 30)
                health_ms = (time.perf_counter() - t0) * 1e3
                if (status == 503 and b"heartbeat" in body
                        or health_ms > (HEALTH_TIMEOUT_S + 30) * 1e3):
                    break
                time.sleep(0.1)
            stage(f"/health {status} {body[:120]!r}")
            try:
                rest, cut = len(r.read()), "no"
            except (http.client.IncompleteRead, ConnectionError, TimeoutError) as e:
                rest, cut = 0, type(e).__name__
            stream_ms = (time.perf_counter() - t0) * 1e3
            stage(f"the stream ended (cut: {cut})")
            faulthandler.cancel_dump_traceback_later()
            post = http_call(url, "/tts", b"text=after+the+loss",
                             "application/x-www-form-urlencoded", timeout=60)
            time.sleep(HEALTH_TIMEOUT_S)
            later = http_call(url, "/health", timeout=HEALTH_TIMEOUT_S + 30)
            print(f"server mesh TP={world}, follower killed after {first} bytes of a "
                  f"request: /health {status} after {health_ms:.1f} ms {body[:160]!r}; the "
                  f"stream ended after {stream_ms:.1f} ms (cut: {cut}, {rest} more bytes); "
                  f"POST /tts {post[0]} in {post[2]:.1f} ms; /health "
                  f"{HEALTH_TIMEOUT_S:.0f} s later {later[0]} in {later[2]:.1f} ms "
                  f"[{card_line()}]", flush=True)
            if not (status == 503 and health_ms <= (HEALTH_TIMEOUT_S + 5) * 1e3
                    and cut not in ("no", "TimeoutError")
                    and stream_ms <= (HEALTH_TIMEOUT_S + 15) * 1e3
                    and post[0] == 503 and post[2] < 2e3 and later[0] == 503):
                raise AssertionError("server mesh: a follower killed inside a generation did "
                                     "not turn the server degraded and end the request in time")
        np.savez(out, *bodies, health_ms=health_ms, stream_ms=stream_ms, post_ms=post[2])
    except BaseException:  # noqa: BLE001 — leave without the broken groups' teardown
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)  # the groups lost a rank: no teardown


def run_server_tp2(tmp: Path, config: Path, wav_a: Path, wav_b: Path) -> list:
    """server_rank on cuda:0 and cuda:1 (rank 1 a follower process, started
    first): rank 0's two requests' PCM."""
    import socket

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp / "server-tp2.npz"
    base = [sys.executable, str(Path(__file__).resolve()), "--server-rank"]
    args = ["2", str(port), str(config), str(wav_a), str(wav_b), str(out)]
    follower = subprocess.Popen([*base, "1", *args], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    leader = subprocess.Popen([*base, "0", *args, str(follower.pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    logs = []
    for p in (leader, follower):
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0] + "\n(killed at the time limit)")
    print(logs[0][-3000:])
    if leader.returncode != 0 or follower.returncode != -9:
        raise AssertionError(f"server mesh TP=2: rank 0 rc {leader.returncode}, the follower "
                             f"rc {follower.returncode}:\n" + "\n".join(logs))
    saved = np.load(out)
    return [saved["arr_0"], saved["arr_1"]]


# ------------------------------------------------------------------- sweep


def run_sweep(tmp: Path) -> dict:
    """The quantization sweep (pocket_tts_tpu_torch.tools.evaluate_quantization)
    on the english.yaml config with random weights: --random-init --voices 1
    --skip-wer, f32 then the four int8 configurations (each its own route:
    the decode stack for f32 and for int8 attention_ffn and all, the layer
    loop for the mixed ones). Its rows are printed by the tool; here the CSV
    is read back: five rows in the tool's order, finite SNR for the int8
    rows, audio and device memory on every row. Returns the launches."""
    import csv

    from pocket_tts_tpu_torch.tools import evaluate_quantization as evq

    t0 = time.perf_counter()
    out = tmp / "sweep"
    reset_counts()
    if evq.main(["--config", str(write_config(tmp)), "--random-init", "--voices", "1",
                 "--skip-wer", "--out", str(out)]) != 0:
        raise AssertionError("sweep: the tool failed")
    counts = read_counts()
    with open(f"{out}.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    if ([r["config"] for r in rows] != [c for c, _ in evq.CONFIGS]
            or rows[0]["snr_db"] != "inf"
            or not all(math.isfinite(float(r["snr_db"])) for r in rows[1:])
            or not all(float(r["audio_s"]) > 0 and r["hbm_mb"] for r in rows)):
        raise AssertionError(f"sweep: rows {rows}")
    print(f"sweep: {len(rows)} rows, launches {counts}; phase {time.perf_counter() - t0:.1f} s "
          f"[{card_line()}]")
    return counts


# ------------------------------------------------------------------ training


TRAIN_SHAPE = (8, 64, 16)  # batch rows, latent frames, text tokens
TRAIN_STEPS = 20
TRAIN_LR = 3e-4


def _named_leaves(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def run_training() -> dict:
    """The flow-matching training step on the english.yaml FlowLM in f32:
    step 0's loss and gradients on the card against the CPU (the same params,
    batch and injected t and noise) at REL_TOL["float32"] of each leaf's
    largest value, then TRAIN_STEPS Adam steps on the card (the loss finite
    and lower at the end, no hand kernel launched), with the ms per step
    between CUDA events and the peak memory allocated above what earlier
    phases still hold (params, gradients, Adam moments, activations)."""
    import torch

    from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
    from pocket_tts_tpu_torch.core.tree import tree_map
    from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs, init_flow_lm_params
    from pocket_tts_tpu_torch.parallel.training import flow_matching_loss, make_train_step

    t0 = time.perf_counter()
    specs = build_flow_lm_specs(load_config(CONFIGS_DIR / "english.yaml"))
    B, S, Tt = TRAIN_SHAPE
    g = torch.Generator().manual_seed(41)
    params = init_flow_lm_params(specs, g, torch.float32, "cpu")
    eos = torch.zeros((B, S))
    eos[:, -1] = 1.0
    batch = {"tokens": torch.randint(0, specs.n_bins, (B, Tt), generator=g),
             "latents": torch.randn((B, S, specs.ldim), generator=g), "eos_labels": eos}
    t = torch.rand((B, S, 1), generator=g)
    noise = torch.randn((B, S, specs.ldim), generator=g)

    cpu = tree_map(lambda x: x.clone().requires_grad_(), params)
    cpu_loss = flow_matching_loss(specs, cpu, batch, t=t, noise=noise)
    cpu_loss.backward()
    cpu_grads = {k: v.grad for k, v in _named_leaves(cpu).items()}
    cpu_s = time.perf_counter() - t0

    def card(x):
        return x.cuda()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    cbatch, ct, cnoise = tree_map(card, batch), card(t), card(noise)
    init, step = make_train_step(specs, TRAIN_LR)
    state = init(tree_map(card, params))
    reset_counts()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        (state, loss), ms = event_ms(lambda: step(state, cbatch, t=ct, noise=cnoise))
        losses.append(float(loss))
        times.append(ms)
        if i == 0:
            rel = abs(losses[0] - float(cpu_loss)) / abs(float(cpu_loss))
            worst, worst_rel = "", 0.0
            for name, leaf in _named_leaves(state.params).items():
                want, got = cpu_grads[name], leaf.grad
                if want is None or got is None:  # a leaf the loss does not reach
                    if want is not None or got is not None:
                        raise AssertionError(f"training: {name} has a gradient on one side")
                    continue
                r = float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                if r > worst_rel:
                    worst, worst_rel = name, r
            print(f"training step 0 card vs cpu: loss {losses[0]:.6f} vs {float(cpu_loss):.6f} "
                  f"(rel {rel:.3g}), gradients worst rel {worst_rel:.3g} ({worst}) over "
                  f"{len(cpu_grads)} leaves, rel_tol={REL_TOL['float32']}")
            if rel > REL_TOL["float32"] or worst_rel > REL_TOL["float32"]:
                raise AssertionError(f"training: step 0 card vs cpu loss rel {rel:.3g}, "
                                     f"gradient {worst} rel {worst_rel:.3g}")
    counts = read_counts()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    ms = sorted(times[2:])[len(times[2:]) // 2]
    print(f"training f32 english.yaml FlowLM (B={B}, S={S}, {Tt} tokens, Adam lr {TRAIN_LR}): "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f} in {TRAIN_STEPS} steps, {ms:.2f} ms per "
          f"step (median of {len(times) - 2} after 2 warm-up, CUDA events; first {times[0]:.1f}),"
          f" peak memory {peak:.2f} GiB, launches {counts}; the CPU's step 0 {cpu_s:.1f} s; "
          f"phase {time.perf_counter() - t0:.1f} s [{card_line()}]")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses {losses}")
    if any(counts.values()):
        raise AssertionError(f"training launched hand kernels: {counts}")
    del state
    return counts


# The probe's chain target: long enough that the slope's two walls dwarf the
# host's jitter, short enough for the smoke (the probe's own default is 2 s).
PROBE_TARGET_S = 0.15


def run_probe_phase() -> dict:
    """python -m pocket_tts_tpu_torch.tools.int8_gemv_probe's four variants
    at full size, rows 1 and 32, with the short chain target."""
    import numpy as np
    import torch

    from pocket_tts_tpu_torch.tools import int8_gemv_probe as probe

    reset_counts()
    for rows in (1, 32):
        for r in probe.run_probe(rows, torch.device("cuda"), np.random.default_rng(0),
                                 target_s=PROBE_TARGET_S):
            if not (math.isfinite(r["ms"]) and r["ms"] > 0):
                raise AssertionError(f"probe rows={rows} {r['label']}: time {r['ms']} ms")
    counts = read_counts()
    print(f"probe: launches {counts} [{card_line()}]")
    if counts["gemv_stack"] == 0 or any(n for k, n in counts.items() if k != "gemv_stack"):
        raise AssertionError(f"probe: launches {counts} (want gemv_stack only)")
    return counts


KERNEL_ROWS = {  # name -> (source, TPU kernel replaced, report key of the line's numbers)
    "decode_stack": ("pocket_tts_tpu_torch/csrc/decode_stack.cu",
                     "pocket_tts_tpu/ops/decode_stack.py:453",
                     ("decode_stack", "bfloat16", 256)),
    "codec_decode": ("pocket_tts_tpu_torch/csrc/codec_decode.cu",
                     "pocket_tts_tpu/ops/codec_decode.py:355",
                     ("codec_decode", "bfloat16", 1, 16)),
    "flash_decode": ("pocket_tts_tpu_torch/csrc/flash_decode.cu",
                     "pocket_tts_tpu/ops/flash_decode.py:239",
                     ("flash_decode", "bfloat16", 32, 256, "serving")),
    "gemv": ("pocket_tts_tpu_torch/csrc/gemv.cu", "pocket_tts_tpu/ops/gemv.py:73",
             ("gemv", "bfloat16", "w1", 32)),
    "gemv_stack": ("pocket_tts_tpu_torch/csrc/gemv_stack.cu", "tools/int8_gemv_probe.py:143",
                   ("gemv_stack", 1)),
}


def main() -> int:
    if sys.argv[1:2] == ["--tp-worker"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return tp_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--server-rank"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return server_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--mimi-attention-check"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        return mimi_attention_check()
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from pocket_tts_tpu_torch.ops import build
    except ImportError as e:
        return fail(f"the port is not importable here: {e}")

    try:
        secs, logs = build.build_all([m.KERNEL for m in kernel_modules().values()])
        print(f"build: {secs:.1f} s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                    print(f"  {name}: {line.strip()}")
        report: dict = {}
        check_decode_stack(report)
        check_codec(report)
        check_flash_decode(report)
        check_gemv(report)
        check_gemv_stack(report)
        # the kernel phases' tensors and CUDA graphs (the codec's B=128 block
        # alone takes gigabytes per call) are released from the allocator's
        # cache, so that the paths below start as a fresh server would
        reserved = torch.cuda.memory_reserved() / 2**30
        gc.collect()
        torch.cuda.empty_cache()
        print(f"kernel phases done at {time.perf_counter() - t_start:.1f} s (allocator "
              f"reserved {reserved:.1f} GiB, {torch.cuda.memory_reserved() / 2**30:.1f} after "
              "empty_cache)")
        with tempfile.TemporaryDirectory() as d:
            check_reference(Path(d))
            check_reference_batch(Path(d))
            print(f"reference done at {time.perf_counter() - t_start:.1f} s")
            model, voice, b1 = run_main_path(Path(d))
            print(f"main path done at {time.perf_counter() - t_start:.1f} s")
            paths = {"b1 bf16": b1, **run_batched_paths(Path(d), model, voice)}
            del model, voice
            print(f"6-layer paths done at {time.perf_counter() - t_start:.1f} s")
            paths["voice clone b1 bf16"], cloned = run_voice_cloning(Path(d))
            print(f"voice cloning done at {time.perf_counter() - t_start:.1f} s")
            paths["surfaces b1 bf16"] = run_surfaces(Path(d), **cloned)
            print(f"surfaces done at {time.perf_counter() - t_start:.1f} s")
            paths["parallel TP 1x1 bf16"] = run_parallel(Path(d), cloned["config"],
                                                         cloned["wav_a"])
            print(f"parallel done at {time.perf_counter() - t_start:.1f} s")
            paths["server mesh TP 1x1 bf16"] = run_server_mesh(
                Path(d), cloned["config"], cloned["wav_a"], cloned["wav_b"])
            del cloned
            print(f"server mesh done at {time.perf_counter() - t_start:.1f} s")
            paths["sweep f32 int8"] = run_sweep(Path(d))
            print(f"sweep done at {time.perf_counter() - t_start:.1f} s")
            paths["training f32"] = run_training()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"training done at {time.perf_counter() - t_start:.1f} s")
            paths.update(run_24l_paths(Path(d)))
            print(f"24-layer paths done at {time.perf_counter() - t_start:.1f} s")
        paths["probe"] = run_probe_phase()
        kernels = []
        for name, (source, replaces, key) in KERNEL_ROWS.items():
            by_path = {p: counts[name] for p, counts in paths.items()}
            if not sum(by_path.values()):
                raise AssertionError(f"{name} was launched on no path: {by_path}")
            kernels.append({"name": name, "route": "cuda", "source": source,
                            "replaces": replaces, "launches": sum(by_path.values()),
                            "library_ms": None, **report[key], "launches_by_path": by_path})
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all [{card_line()}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

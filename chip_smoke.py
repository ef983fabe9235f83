#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pocket_tts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel of the main path from pocket_tts_tpu_torch/csrc,
     one nvcc per source, in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 and f32, at the main path's shapes (decode_stack at the flagship
     FlowLM width, 6 layers, C in {256, 512}, on a mid-generation cache with
     dead and speculative slots; codec_decode on the english.yaml decoder at
     T = 16 and 16*8 with its states), with times;
  4. reference: a small f32 model's generate_audio on the card (kernels)
     against the same model and noise on the CPU (plain versions), over a
     whole request (EOS off: every frame up to the length limit, through
     the 1,1,8,...,32 block ramp; frames emitted and decoded are printed);
  5. main path: load_model(english.yaml, random init, bf16), a voice state by
     a prompt pass over seeded conditioning, round-tripped through
     export_model_state / import; 3 generate_audio requests and one streamed
     request, with every launch counter set to 0 before and read after.
The line before the last is one JSON object with the kernels' numbers; the
last is {"ok": true, "device": {...}}. Matmuls and convolutions run in full
f32 (TF32 off) wherever f32 is compared.

Kernel against plain, each output and each state tensor is held to
max |kernel - plain| <= REL_TOL x max |plain|. In f32 that is 1e-4 (the same
arithmetic summed in another order). In bf16 one rounding flipped by the
summation order moves a value by up to 2^-8 = 3.9e-3 of itself; the limit,
2e-2, allows about five such flips at the largest value (an H100 reads up to
8.7e-3 at these shapes) and fails an error of a few percent of the output.
"""

from __future__ import annotations

import json
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


def write_config(tmp: Path, small: bool = False) -> Path:
    """english.yaml with a local toy tokenizer (and, for `small`, the test
    suite's small geometry)."""
    import yaml

    from pocket_tts_tpu_torch.config import CONFIGS_DIR

    cfg = yaml.safe_load((CONFIGS_DIR / "english.yaml").read_text())
    n_bins = cfg["flow_lm"]["lookup_table"]["n_bins"]
    tok = tmp / "tokenizer.model"
    if not tok.exists():
        write_tokenizer(tok, n_bins)
    cfg["flow_lm"]["lookup_table"]["tokenizer_path"] = str(tok)
    if small:
        cfg["flow_lm"]["transformer"].update(d_model=64, num_heads=4, num_layers=2,
                                             hidden_scale=2)
        cfg["flow_lm"]["flow"].update(dim=48, depth=2)
        cfg["mimi"]["seanet"].update(dimension=64, n_filters=8)
        cfg["mimi"]["transformer"].update(d_model=64, num_heads=4, dim_feedforward=128,
                                          input_dimension=64, output_dimensions=[64],
                                          context=30)
        cfg["mimi"]["quantizer"].update(dimension=8, output_dimension=64)
        cfg["mimi"]["inner_dim"] = 8
        cfg["mimi"]["outer_dim"] = 64
    path = tmp / ("small.yaml" if small else "english.yaml")
    path.write_text(yaml.safe_dump(cfg))
    return path


# ------------------------------------------------------------ kernel checks


def check_decode_stack(report: dict) -> None:
    import torch

    from pocket_tts_tpu_torch.nn.transformer import StackState, TransformerConfig
    from pocket_tts_tpu_torch.nn.transformer import init_layer_params
    from pocket_tts_tpu_torch.ops import decode_stack as ds

    cfg = TransformerConfig(d_model=1024, num_heads=16, num_layers=6, dim_feedforward=4096)
    L, D, H, F = cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.dim_feedforward
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = REL_TOL[dtype_name]
        g.manual_seed(1)
        params = init_layer_params(cfg, g, dtype, dev)
        for C, offset in ((256, 100), (512, 300)):
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
                raise AssertionError(f"decode_stack {dtype_name} C={C}: non-finite output")
            if not untouched:
                raise AssertionError(f"decode_stack {dtype_name} C={C}: slots other than "
                                     "write_pos changed")
            ms = cuda_ms(lambda: ds._decode_stack_cuda(cfg, params, x, sk.k, sk.v, sk.pos,
                                                       sk.offset, n_filled))
            plain_ms = cuda_ms(lambda: ds.decode_stack_plain(cfg, params, x, sp.k, sp.v, sp.pos,
                                                             sp.offset, n_filled), iters=5)
            es = torch.finfo(dtype).bits // 8
            valid = int(((pos >= 0) & (pos <= offset)).sum().item())
            weights = L * (3 * D * D + D * D + 2 * F * D + 4 * D) * es
            nbytes = weights + L * valid * 2 * D * es + L * 2 * D * es + 2 * D * es + C * 4
            flops = L * (2 * (4 * D * D + 2 * F * D) + 4 * (valid + 1) * D)
            b_ms, b_by = bound(nbytes, flops, dtype_name)
            if dtype_name == "bfloat16" and C == 256:
                profile("decode_stack bf16 C=256 x20", lambda: [
                    ds._decode_stack_cuda(cfg, params, x, sk.k, sk.v, sk.pos, sk.offset,
                                          n_filled) for _ in range(20)], top=6)
            print(f"decode_stack {dtype_name} C={C}: max_abs_err={err:.3g} rel={rel:.3g} "
                  f"row_err={row_err:.3g} row_rel={row_rel:.3g} rel_tol={tol} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.1f} MB)")
            if rel > tol or row_rel > tol:
                raise AssertionError(f"decode_stack {dtype_name} C={C}: max |kernel - plain| "
                                     f"/ max |plain| {rel:.3g} (row {row_rel:.3g}) > {tol}")
            report[("decode_stack", dtype_name, C)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


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


def check_codec(report: dict) -> None:
    import torch

    from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
    from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
    from pocket_tts_tpu_torch.nn.seanet import init_seanet_params, seanet_apply
    from pocket_tts_tpu_torch.ops import codec_decode as cd

    specs = build_mimi_specs(load_config(CONFIGS_DIR / "english.yaml").mimi)
    spec = specs.decoder
    g = torch.Generator(device="cuda")
    for dtype_name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        tol = REL_TOL[dtype_name]
        g.manual_seed(2)
        params = init_seanet_params(spec, g, dtype, "cuda")
        for T in (16, 16 * 8):
            x = torch.randn((1, specs.arch.dimension, T), generator=g, device="cuda").to(dtype)
            state = _rand_seanet_state(spec, 1, dtype, g)
            y_k, s_k = cd._codec_decode_cuda(spec, params, x, state)
            y_p, s_p = seanet_apply(spec, params, x, state)
            torch.cuda.synchronize()
            if y_k.shape != y_p.shape or not torch.isfinite(y_k.float()).all():
                raise AssertionError(f"codec {dtype_name} T={T}: bad output {tuple(y_k.shape)}")
            err, rel = rel_err(y_k, y_p)
            states = [rel_err(a, b) for a, b in zip(_leaves(s_k), _leaves(s_p))
                      if a.is_floating_point() and a.numel()]
            st_err, st_rel = max(r[0] for r in states), max(r[1] for r in states)
            if not all(torch.equal(a, b) for a, b in zip(_leaves(s_k), _leaves(s_p))
                       if not a.is_floating_point()):
                raise AssertionError(f"codec {dtype_name} T={T}: integer states differ")
            ms = cuda_ms(lambda: cd._codec_decode_cuda(spec, params, x, state))
            plain_ms = cuda_ms(lambda: seanet_apply(spec, params, x, state), iters=10)
            es = torch.finfo(dtype).bits // 8
            w_elems = sum(t.numel() for t in _leaves(params) if t is not None)
            st_elems = sum(t.numel() for t in _leaves(state) if t.is_floating_point())
            nbytes = (w_elems + x.numel() + 2 * st_elems + y_k.numel()) * es
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
            b_ms, b_by = bound(nbytes, flops, dtype_name)
            if dtype_name == "bfloat16" and T == 16:
                profile("codec_decode bf16 T=16 x20", lambda: [
                    cd._codec_decode_cuda(spec, params, x, state) for _ in range(20)], top=12)
            print(f"codec_decode {dtype_name} T={T}: max_abs_err={err:.3g} rel={rel:.3g} "
                  f"state_err={st_err:.3g} state_rel={st_rel:.3g} rel_tol={tol} "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e6:.2f} MB, {flops / 1e6:.0f} MFLOP)")
            if rel > tol or st_rel > tol:
                raise AssertionError(f"codec {dtype_name} T={T}: max |kernel - plain| "
                                     f"/ max |plain| {rel:.3g} (states {st_rel:.3g}) > {tol}")
            report[("codec_decode", dtype_name, T)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


# ------------------------------------------------------------ pipeline phases


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

    def frames():
        served = 0

        def source(shape):
            nonlocal served
            k = 1 if len(shape) == 2 else shape[0]
            out = noise[served:served + k].reshape(shape) * card.gen.temp ** 0.5
            served += k
            return out
        return source

    text = "hello world this is a test of the tts."
    card.decode_steps = 0
    a_card = card.generate_audio(card.state_for_conditioning(cond), text,
                                 noise_source=frames())
    a_cpu = cpu.generate_audio(cpu.state_for_conditioning(cond), text, noise_source=frames())
    if a_card.shape != a_cpu.shape or a_card.size == 0:
        raise AssertionError(f"reference: lengths differ {a_card.shape} vs {a_cpu.shape}")
    err = float(np.abs(a_card - a_cpu).max())
    print(f"reference small f32 generate_audio card vs cpu: samples={a_card.size} "
          f"({a_card.size // card.samples_per_frame} frames emitted, {card.decode_steps} "
          f"decoded) max_abs_err={err:.3g} tol=1e-3")
    if not err <= 1e-3:
        raise AssertionError(f"reference: card vs cpu max error {err:.3g} > 1e-3")


def _device_us(evt) -> float:
    return float(evt.self_device_time_total)


def profile(label: str, fn, top: int = 8) -> None:
    """Run fn under torch.profiler: device busy share of the window and the
    kernels that take most device time. The profiler's own host cost makes
    the window longer, so the busy share is a lower bound."""
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


def run_main_path(tmp: Path) -> dict:
    import numpy as np
    import torch

    from pocket_tts_tpu_torch.ops import codec_decode, decode_stack
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    cfg = write_config(tmp)
    # Random weights put the EOS logit above the default threshold at the
    # first step; with EOS off every request runs to its length limit.
    model = TTSModel.load_model(config=cfg, allow_random_init=True, param_dtype="bfloat16",
                                eos_threshold=1e9)
    D = model.specs.transformer.d_model
    cond = torch.randn((1, 50, D), generator=torch.Generator(device="cuda").manual_seed(7),
                       device="cuda")
    made = model.state_for_conditioning(cond)
    voice_file = tmp / "voice.safetensors"
    model.export_model_state(made, voice_file)
    voice = model.import_state(voice_file)
    n = int(made.offset[0])
    if not (torch.equal(voice.offset, made.offset)
            and torch.equal(voice.k[:, :, :n], made.k[:, :, :n])
            and torch.equal(voice.v[:, :, :n], made.v[:, :, :n])):
        raise AssertionError("voice state changed in the export/import round trip")
    before = voice.clone()
    print(f"voice state: {n} positions, capacity {voice.k.shape[2]}, dtype {voice.k.dtype}")

    texts = ["hello world. this is a test of the tts.",
             "the card runs fast and small speech.",
             "this is a test. hello world, this is the speech of the card."]
    decode_stack.KERNEL.launches = 0
    codec_decode.KERNEL.launches = 0
    model.decode_steps = 0
    total_audio, total_wall = 0.0, 0.0
    for i, text in enumerate(texts):
        t0 = time.perf_counter()
        audio = model.generate_audio(voice, text, seed=i + 1)
        wall = time.perf_counter() - t0
        if audio.size == 0 or audio.size % model.samples_per_frame or not np.isfinite(audio).all():
            raise AssertionError(f"request {i}: bad audio ({audio.size} samples)")
        secs = audio.size / model.sample_rate
        total_audio += secs
        total_wall += wall
        print(f"request {i}: {secs:.2f} s of audio in {wall:.3f} s ({secs / wall:.2f} audio-s/s)")
    t0 = time.perf_counter()
    stream = model.generate_audio_stream(voice, texts[0], seed=9)
    first = next(stream)
    first_ms = (time.perf_counter() - t0) * 1e3
    rest = sum(c.size for c in stream) + first.size
    print(f"streamed request: first chunk {first.size} samples in {first_ms:.2f} ms, "
          f"{rest} samples in all")
    launches = {"decode_stack": decode_stack.KERNEL.launches,
                "codec_decode": codec_decode.KERNEL.launches}
    steps = model.decode_steps
    print(f"launches: {launches}, decode steps: {steps}")
    if launches["decode_stack"] != steps or steps == 0:
        raise AssertionError(f"decode_stack launched {launches['decode_stack']} times "
                             f"for {steps} decode steps")
    if launches["codec_decode"] == 0:
        raise AssertionError("codec_decode never launched on the main path")
    if not (torch.equal(voice.k, before.k) and torch.equal(voice.pos, before.pos)
            and torch.equal(voice.offset, before.offset)):
        raise AssertionError("a copy_state=True request changed the voice state")
    print(f"main path: {total_audio:.2f} s of audio in {total_wall:.3f} s: "
          f"{total_audio / total_wall:.2f} audio-s/s; first chunk {first_ms:.2f} ms")
    # enough rows for every decode-stack and codec kernel
    profile("one generate_audio request", lambda: model.generate_audio(voice, texts[1], seed=4),
            top=16)
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from pocket_tts_tpu_torch.ops import build, codec_decode, decode_stack
    except ImportError as e:
        return fail(f"the port is not importable here: {e}")

    try:
        secs, logs = build.build_all([decode_stack.KERNEL, codec_decode.KERNEL])
        print(f"build: {secs:.1f} s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line and "0 bytes spill" not in line:
                    print(f"  {name}: {line.strip()}")
        report: dict = {}
        check_decode_stack(report)
        check_codec(report)
        with tempfile.TemporaryDirectory() as d:
            check_reference(Path(d))
            launches = run_main_path(Path(d))
    except Exception as e:  # any failed phase fails the run
        import traceback

        traceback.print_exc()
        return fail(f"{type(e).__name__}: {e}")

    ds = report[("decode_stack", "bfloat16", 256)]
    cd = report[("codec_decode", "bfloat16", 16)]
    kernels = [
        {"name": "decode_stack", "route": "cuda",
         "source": "pocket_tts_tpu_torch/csrc/decode_stack.cu",
         "replaces": "pocket_tts_tpu/ops/decode_stack.py:453",
         "launches": launches["decode_stack"], **ds, "library_ms": None},
        {"name": "codec_decode", "route": "cuda",
         "source": "pocket_tts_tpu_torch/csrc/codec_decode.cu",
         "replaces": "pocket_tts_tpu/ops/codec_decode.py:355",
         "launches": launches["codec_decode"], **cd, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

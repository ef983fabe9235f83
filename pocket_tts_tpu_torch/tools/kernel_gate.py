"""On-card, serving-dtype gate for every CUDA kernel of the port.

The port of tools/kernel_gate.py. Each case builds its kernel from
pocket_tts_tpu_torch/csrc through ops/build.py (at its first launch), runs it
on the card at the flagship geometry (english.yaml: FlowLM D=1024, H=16,
Dh=64, F=4096; its SEANet decoder) in a dtype and batch the serving paths
send it, and holds it to its plain PyTorch version in the same module, on the
same inputs: max |kernel - plain| <= 2e-2 (bf16) or 1e-4 (f32) of max |plain|,
the decode stack's bf16 bar per 6 layers and x sqrt(L / 6) deeper (the bars
of chip_smoke.py). Before it launches anything, each case asserts that the
port's routing predicate takes it (`gemv_takes`, `flash_decode_takes`,
`stack_takes_rows`, `decoder_is_fusable`; the stacked int8 GEMV has no
serving route, so its cases take the int8 GEMV probe's weight): a case the
serving path cannot reach fails as mis-specified.

The cases start from the JAX gate's and follow what the port enables: the
codec in f32 too (the JAX package routes f32 to XLA; the port runs its
kernel), flash decode with the attended length in device memory, gemv with
f32 activations, the decode stack at C=4096, in f32 and at 24 layers, and
the probe's stacked int8 GEMV. `Case.key` names what a case covers:
(kernel, activation dtype, weight dtype, rows).

No fallback: without a CUDA device the gate exits non-zero, and a kernel that
fails to build or launch is a FAIL, never a skip.

Usage: python -m pocket_tts_tpu_torch.tools.kernel_gate   # exits non-zero on any failure
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Callable

import numpy as np
import torch

from pocket_tts_tpu_torch.tools import card_line

FAILURES: list[str] = []
REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
D, H, DH, F = 1024, 16, 64, 4096  # english.yaml's FlowLM
NAMES = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8"}


def check(name: str, fn):
    t0 = time.monotonic()
    try:
        fn()
        print(f"PASS {name} ({time.monotonic() - t0:.1f}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — report and continue to the next case
        FAILURES.append(name)
        msg = str(e).splitlines()
        head = msg[0] if msg else repr(e)
        print(f"FAIL {name}: {head}", flush=True)


def _takes(ok: bool, predicate: str) -> None:
    if not ok:
        raise AssertionError(f"mis-specified: {predicate} does not route this case to the kernel")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def hold(what: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype,
         layers: int = 6) -> None:
    """max |got - want| within the dtype's bar of max |want|."""
    tol = REL_TOL[dtype] * (math.sqrt(max(1.0, layers / 6)) if dtype == torch.bfloat16 else 1.0)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype}, plain "
                             f"{tuple(want.shape)} {want.dtype}")
    if not want.numel():  # a conv with no left context keeps an empty state
        return
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if err > tol * scale:
        raise AssertionError(f"{what}: max |kernel - plain| {err:.3g} > {tol:.3g} x "
                             f"max |plain| {scale:.3g}")


def codec(dtype: torch.dtype, batch: int, t0: int = 16, frames: int = 2):
    """The SEANet decoder kernel vs seanet_apply on the english.yaml decoder,
    `frames` chained calls so the streaming state round-trips through the
    kernel (bf16 over the weights packed as TTSModel packs them)."""
    from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
    from pocket_tts_tpu_torch.core.tree import tree_leaves
    from pocket_tts_tpu_torch.models.mimi import build_mimi_specs
    from pocket_tts_tpu_torch.nn.seanet import (
        init_seanet_params,
        init_seanet_state,
        seanet_apply,
    )
    from pocket_tts_tpu_torch.ops import codec_decode as cd

    specs = build_mimi_specs(load_config(CONFIGS_DIR / "english.yaml").mimi)
    dec = specs.decoder
    _takes(cd.decoder_is_fusable(dec), "decoder_is_fusable")
    g = _gen(batch)
    params = init_seanet_params(dec, g, dtype, "cuda")
    packed = cd.pack_decoder_params(dec, params) if dtype == torch.bfloat16 else None
    got_s = want_s = init_seanet_state(dec, batch, dtype, "cuda")
    for f in range(frames):
        x = (torch.randn((batch, specs.arch.dimension, t0), generator=g, device="cuda")
             * 0.5).to(dtype)
        got, got_s = cd.codec_decode(dec, params, x, got_s, packed)
        want, want_s = seanet_apply(dec, params, x, want_s)
        hold(f"frame {f} audio", got, want, dtype)
        for a, b in zip(tree_leaves(got_s), tree_leaves(want_s)):
            if a.is_floating_point():
                hold(f"frame {f} state", a, b, dtype)
            elif not torch.equal(a, b):
                raise AssertionError(f"frame {f}: integer states differ")


def flash_decode(dtype: torch.dtype, batch: int, capacity: int, att_len: int | None = None,
                 device_len: bool = False):
    """The flash-decode kernel vs flash_decode_plain. As the JAX gate: an
    append-ordered pos map with every 7th slot dead and rows filled to
    30-90% of the attended slots (heterogeneous offsets). `device_len`: the
    attended length as the step graphs hand it over, an int32 [1] tensor."""
    from pocket_tts_tpu_torch.ops import flash_decode as fd

    lim = att_len or capacity
    _takes(fd.flash_decode_takes(lim, DH), "flash_decode_takes")
    g = _gen(capacity + batch)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v, kn, vn = (rnd(batch, H, DH), rnd(batch, capacity, H, DH),
                       rnd(batch, capacity, H, DH), rnd(batch, H, DH), rnd(batch, H, DH))
    pos = np.full((batch, capacity), -1, np.int32)
    offset = np.zeros((batch,), np.int32)
    for b in range(batch):
        fill = int(lim * (0.3 + 0.6 * b / max(batch - 1, 1)))
        live = np.arange(fill) % 7 != 6
        pos[b, :fill][live] = np.arange(int(live.sum()))
        offset[b] = live.sum()
    pos_t, off_t = torch.from_numpy(pos).cuda(), torch.from_numpy(offset).cuda()
    att = torch.tensor([lim], dtype=torch.int32, device="cuda") if device_len else att_len
    got = fd.flash_decode(q, k, v, kn, vn, pos_t, off_t, att)
    want = fd.flash_decode_plain(q, k, v, kn, vn, pos_t, off_t, att_len)
    hold("out", got, want, dtype)


def gemv(x_dtype: torch.dtype, w_dtype: torch.dtype, rows: int, O: int = F, I: int = D):
    """The skinny GEMV kernel through nn/linear.matmul_t's route vs
    gemv_plain, on the FlowLM's w1 shape; int8 weights as the port quantizes
    a model in x's dtype (f32 row scales)."""
    from pocket_tts_tpu_torch.ops import gemv as gv
    from pocket_tts_tpu_torch.quant import quantize_weight

    g = _gen(3)
    x = torch.randn((rows, I), generator=g, device="cuda").to(x_dtype)
    W = torch.randn((O, I), generator=g, device="cuda") * 0.02
    w = quantize_weight(W.to(x_dtype)) if w_dtype == torch.int8 else W.to(w_dtype)
    _takes(gv.gemv_takes(x, w), "gemv_takes")
    hold("y", gv.matmul_t_decode(x, w), gv.gemv_plain(x, w), gv.out_dtype(x, w))


def decode_stack(dtype: torch.dtype, quant: bool, C: int, L: int = 6):
    """The decode-stack kernel through decode_stack_apply vs
    decode_stack_plain, on a mid-generation cache as the JAX gate builds it
    (half full plus five slots past the offset, slot 3 dead). Holds h and the
    appended row, and asserts that every other slot is untouched and that
    pos, offset and the device write pointer advanced as one step's."""
    from pocket_tts_tpu_torch.nn.transformer import (
        StackState,
        TransformerConfig,
        init_layer_params,
    )
    from pocket_tts_tpu_torch.ops import decode_stack as ds
    from pocket_tts_tpu_torch.quant import quantize_flow_lm_int8

    cfg = TransformerConfig(d_model=D, num_heads=H, num_layers=L, dim_feedforward=F)
    g = _gen(1)
    params = init_layer_params(cfg, g, dtype, "cuda")
    if quant:  # attention_ffn: all four products int8, f32 row scales
        params = quantize_flow_lm_int8({"transformer": params})["transformer"]
    _takes(ds.stack_takes_rows(cfg, params, 1, 1), "stack_takes_rows")
    offset = C // 2
    slot = offset + 5
    k = (torch.randn((L, 1, C, H, DH), generator=g, device="cuda") * 0.5).to(dtype)
    v = (torch.randn((L, 1, C, H, DH), generator=g, device="cuda") * 0.5).to(dtype)
    pos = torch.full((1, C), -1, dtype=torch.int32, device="cuda")
    pos[0, :slot] = torch.arange(slot, dtype=torch.int32, device="cuda")
    pos[0, 3] = -1
    off = torch.tensor([offset], dtype=torch.int32, device="cuda")
    x = (torch.randn((1, 1, D), generator=g, device="cuda") * 0.3).to(dtype)
    got = StackState(k.clone(), v.clone(), pos.clone(), off.clone(), slot)
    h_k, st = ds.decode_stack_apply(cfg, params, x, got)
    want = StackState(k.clone(), v.clone(), pos.clone(), off.clone(), slot)
    h_p = ds.decode_stack_plain(cfg, params, x, want.k, want.v, want.pos, want.offset, slot)
    hold("h", h_k, h_p, dtype, L)
    hold("appended k", st.k[:, :, slot], want.k[:, :, slot], dtype, L)
    hold("appended v", st.v[:, :, slot], want.v[:, :, slot], dtype, L)
    other = torch.arange(C, device="cuda") != slot
    if not (torch.equal(st.k[:, :, other], k[:, :, other])
            and torch.equal(st.v[:, :, other], v[:, :, other])):
        raise AssertionError("a cache slot other than the write pointer's changed")
    pos[0, slot] = offset
    if not (torch.equal(st.pos, pos) and st.offset.tolist() == [offset + 1]
            and st.write_ptr.tolist() == [slot + 1]):
        raise AssertionError(f"pos / offset {st.offset.tolist()} / write pointer "
                             f"{st.write_ptr.tolist()} not advanced as one step")


def gemv_stack(rows: int):
    """The stacked int8 GEMV vs gemv_stack_plain on the int8 GEMV probe's
    weight (48 stacked [4096, 1024] int8 halves, -128 and 127 included)."""
    from pocket_tts_tpu_torch.ops import gemv_stack as gs
    from pocket_tts_tpu_torch.tools.int8_gemv_probe import I, L, O

    g = _gen(8)
    Wq = torch.randint(-128, 128, (L, O, I), generator=g, device="cuda", dtype=torch.int8)
    s = torch.rand((L, O), generator=g, device="cuda")
    x = torch.randn((rows, I), generator=g, device="cuda").to(torch.bfloat16)
    _takes(Wq.shape == (L, O, I), "the int8 GEMV probe's stacked weight")
    hold("y", gs.gemv_stack(x, Wq, s), gs.gemv_stack_plain(x, Wq, s), torch.float32)


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    key: tuple  # (kernel, activation dtype, weight dtype, rows)
    run: Callable[[], None]


BF16, F32, INT8 = torch.bfloat16, torch.float32, torch.int8


def cases() -> list[Case]:
    out = []

    def add(kernel: str, label: str, dtype, weights, rows: int, run):
        out.append(Case(f"{kernel}[{label}]", (kernel, dtype, weights, rows), run))

    # the codec: bf16 at any batch (the JAX gate's four, one-frame blocks, and
    # b128's 32-frame block), and f32, which the port runs on its kernel too
    for b in (1, 4, 8, 32):
        add("codec_decode", f"bf16 b{b}", BF16, BF16, b, lambda b=b: codec(BF16, b))
    add("codec_decode", "bf16 b128 t512", BF16, BF16, 128, lambda: codec(BF16, 128, t0=512))
    for b in (1, 32, 128):
        add("codec_decode", f"f32 b{b}", F32, F32, b, lambda b=b: codec(F32, b))

    # flash decode: the JAX gate's four, the attended length in device memory,
    # b128's batch, and f32
    for dt, b, cap, att, dev in ((BF16, 1, 768, None, False), (BF16, 32, 768, None, False),
                                 (BF16, 1, 4096, None, False), (BF16, 32, 768, 384, False),
                                 (BF16, 32, 768, 384, True), (BF16, 128, 256, None, False),
                                 (F32, 1, 768, None, False), (F32, 32, 768, None, False),
                                 (F32, 128, 256, None, False)):
        label = (f"{NAMES[dt]} b{b} cap{cap}" + (f" att{att}" if att else "")
                 + (" on device" if dev else ""))
        add("flash_decode", label, dt, dt, b,
            lambda dt=dt, b=b, c=cap, a=att, d=dev: flash_decode(dt, b, c, a, d))

    # gemv: every (activation, weight) form the port routes (bf16 and int8
    # FlowLM products, the flow head's f32 activations over bf16 weights, f32
    # models plain and int8) at one row, a prompt's 8 and 16, and B=32
    for xd, wd in ((BF16, BF16), (BF16, INT8), (F32, BF16), (F32, F32), (F32, INT8)):
        form = NAMES[wd] if xd == BF16 or wd == F32 else f"f32 x {NAMES[wd]}"
        for r in (1, 8, 16, 32):
            add("gemv", f"b{r} {form}", xd, wd, r, lambda xd=xd, wd=wd, r=r: gemv(xd, wd, r))

    # the decode stack: the b1 route for both weight kinds, at growth buckets,
    # at the largest capacity, in f32, and at 24 layers
    for dt, quant, C, L in ((BF16, False, 256, 6), (BF16, True, 256, 6), (BF16, True, 512, 6),
                            (BF16, True, 1024, 6), (BF16, False, 4096, 6),
                            (F32, False, 256, 6), (F32, True, 256, 6),
                            (BF16, False, 256, 24), (BF16, True, 256, 24)):
        form = ("int8" if dt == BF16 else "f32 int8") if quant else NAMES[dt]
        label = ("24l " if L == 24 else "") + f"{form} C{C}"
        add("decode_stack", label, dt, INT8 if quant else dt, 1,
            lambda dt=dt, q=quant, C=C, L=L: decode_stack(dt, q, C, L))

    # the int8 GEMV probe's stacked weight at one row and at 32
    for r in (1, 32):
        add("gemv_stack", f"b{r}", BF16, INT8, r, lambda r=r: gemv_stack(r))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_gate: no CUDA device (the gate runs the kernels on the card)")
    print(f"{card_line()} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    FAILURES.clear()
    for case in cases():
        check(case.name, case.run)
    if FAILURES:
        print(f"\n{len(FAILURES)} kernel gate(s) FAILED: {FAILURES}", flush=True)
        sys.exit(1)
    print("\nall kernel gates passed", flush=True)


if __name__ == "__main__":
    main()

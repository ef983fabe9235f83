"""Fused SEANet decoder: the whole decoder op program in one call.

Replaces the Pallas kernel pocket_tts_tpu/ops/codec_decode.py
(`seanet_decoder_fused` / `_build_kernel`). It computes
`nn.seanet.seanet_apply(decoder_spec, ...)` on the streaming path: [B, C0, T0]
latents at the codec rate -> [B, 1, T0 * prod(ratios)] audio, with every
conv's left context and every transposed conv's overlap-add tail read in and
written out. Replicate padding (only the stem may use it, as in the JAX
package) is resolved here before the launch.

On a CUDA tensor the wrapper lays the program out as a table of ops and
makes one call into csrc/codec_decode.cu, which launches one kernel per conv
(ELU fused into the next conv's input staging, the residual add into the
block's last conv). bf16 runs each conv as a tensor-core implicit GEMM over
the weights `pack_decoder_params` lays out once per model (a bf16 CUDA call
without them raises); f32 runs the CUDA-core body on the torch-layout
weights and needs no packing. On a CPU tensor it runs `seanet_apply`, the
plain PyTorch version, and ignores the packed weights. There is no fallback
from one to the other. Every SEANet call of the decoder goes here, whatever
T0 (the JAX package sends only single-frame steps to its kernel), so the
card runs no plain convolution on the main path. Bound and design: see the
source note of csrc/codec_decode.cu.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pocket_tts_tpu_torch.nn.conv import ConvSpec, ConvState, ConvTrState
from pocket_tts_tpu_torch.nn.seanet import SEANetSpec, seanet_apply
from pocket_tts_tpu_torch.ops.build import CudaKernel, check

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    f = lib.codec_decode_run
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_void_p]


KERNEL = CudaKernel("codec_decode", _bind)
# The body each op of the last kernel call ran on, in program order (the C
# entry's Body codes): CUDA cores, or a tensor-core tile of BM x BN.
BODIES = {0: "cuda_cores", 1: "tc_64x128", 2: "tc_32x64", 3: "tc_16x16", 4: "tc_128x128",
          5: "tc_32x128"}
KERNEL.bodies = []

# The packing pads M (output channels, or S x Cout phase rows) to a multiple
# of 16 and Cin to a multiple of 32 with zeros: csrc/codec_decode.cu's
# kMAlign and kCinAlign.
M_ALIGN, CIN_ALIGN = 16, 32


def _pad_to(n: int, k: int) -> int:
    return -(-n // k) * k


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """conv [Cout, Cin, K] -> [K, M_pad, Cin_pad]: one [Cout, Cin] matrix per
    tap, Cin contiguous, zero-padded."""
    co, ci, k = w.shape
    out = w.new_zeros((k, _pad_to(co, M_ALIGN), _pad_to(ci, CIN_ALIGN)))
    out[:, :co, :ci] = w.permute(2, 0, 1)
    return out


def pack_convtr_weight(w: torch.Tensor) -> torch.Tensor:
    """transposed conv [Cin, Cout, 2S] -> [2, M_pad, Cin_pad] with row
    m = co * S + r: tap 0 (applied to x[t - 1]) is W[:, co, r + S], tap 1
    (applied to x[t]) is W[:, co, r]."""
    ci, co, k = w.shape
    S = k // 2
    taps = torch.stack([w[:, :, S:], w[:, :, :S]])  # [2, Cin, Cout, S]
    out = w.new_zeros((2, _pad_to(co * S, M_ALIGN), _pad_to(ci, CIN_ALIGN)))
    out[:, :co * S, :ci] = taps.permute(0, 2, 3, 1).reshape(2, co * S, ci)
    return out


def pack_decoder_params(spec: SEANetSpec, params: dict) -> dict:
    """The tensor-core layout of the decoder's weights, keyed as `params`,
    made once per model (the JAX package's `pack_decoder_params` for its
    kernel): a [K, M_pad, Cin_pad] tensor per conv and a [2, M_pad, Cin_pad]
    one per transposed conv. Biases stay in `params`."""
    packed: dict = {}
    for i, (kind, op) in enumerate(spec.ops):
        key = str(i)
        if kind == "conv":
            packed[key] = pack_conv_weight(params[key].weight)
        elif kind == "convtr":
            packed[key] = pack_convtr_weight(params[key].weight)
        elif kind == "resblock":
            packed[key] = [pack_conv_weight(p.weight) for p in params[key]]
    return packed


def _conv_ctx(op: ConvSpec) -> int:
    return op.effective_kernel_size - op.stride


def decoder_is_fusable(spec: SEANetSpec) -> bool:
    """The kernel covers stride-1 convs and K=2S transposed convs (all SEANet
    decoders); replicate padding only on the stem, whose first input sample
    is known before the launch."""
    for i, (kind, op) in enumerate(spec.ops):
        if kind == "conv":
            if op.stride != 1 or op.groups != 1:
                return False
            if op.pad_mode == "replicate" and i != 0 and _conv_ctx(op) > 0:
                return False
        if kind == "convtr" and (op.kernel_size != 2 * op.stride or op.groups != 1):
            return False
        if kind == "resblock":
            for cspec in op.convs:
                if cspec.stride != 1 or cspec.groups != 1:
                    return False
                if cspec.pad_mode == "replicate" and _conv_ctx(cspec) > 0:
                    return False
    return True


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


class _Program:
    """The op table the kernel walks, and the tensors it points into (held
    with the program, so that it can be launched again)."""

    def __init__(self, x: torch.Tensor):
        self.B = x.shape[0]
        self.dtype, self.device = x.dtype, x.device
        self.rows: list[list[int]] = []
        self.keep: list[torch.Tensor] = [x]

    def _tensor(self, *shape) -> torch.Tensor:
        t = torch.empty((self.B, *shape), dtype=self.dtype, device=self.device)
        self.keep.append(t)
        return t

    def _operand(self, name: str, t: torch.Tensor | None) -> torch.Tensor | None:
        if t is None:
            return None
        if t.dtype != self.dtype:
            raise NotImplementedError(
                f"codec_decode: mixed float dtypes ({name} {t.dtype}, input {self.dtype})")
        if t.device != self.device:
            raise ValueError(f"codec_decode: {name} is on {t.device}, input on {self.device}")
        t = t.contiguous()
        self.keep.append(t)
        return t

    def conv(self, op: ConvSpec, p, wp: torch.Tensor | None, s: ConvState, h: torch.Tensor,
             elu_in: bool, res: torch.Tensor | None = None, stem: bool = False):
        ctx = _conv_ctx(op)
        T = h.shape[-1]
        s_in = s_out = None
        new_state = s
        if ctx > 0:
            prev = s.previous
            if op.pad_mode == "replicate":
                if not stem or elu_in:
                    raise NotImplementedError("replicate padding inside the fused decoder")
                prev = torch.where(s.first[:, None, None], h[:, :, :1].expand(prev.shape), prev)
            s_in = self._operand("conv state", prev)
            s_out = self._tensor(op.in_channels, ctx)
            new_state = ConvState(previous=s_out, first=torch.zeros_like(s.first))
        y = self._tensor(op.out_channels, T)
        w, b = self._operand("weight", p.weight), self._operand("bias", p.bias)
        wp = self._operand("packed weight", wp)
        self.rows.append([0, op.in_channels, op.out_channels, op.kernel_size, 1, op.dilation,
                          ctx, int(elu_in), T, _ptr(h), _ptr(y), _ptr(w), _ptr(b),
                          _ptr(s_in), _ptr(s_out), _ptr(res), _ptr(wp)])
        return y, new_state

    def convtr(self, op, p, wp: torch.Tensor | None, s: ConvTrState, h: torch.Tensor, elu_in: bool):
        S, T = op.stride, h.shape[-1]
        s_in = self._operand("convtr state", s.partial)
        s_out = self._tensor(op.out_channels, S)
        y = self._tensor(op.out_channels, T * S)
        w, b = self._operand("weight", p.weight), self._operand("bias", p.bias)
        wp = self._operand("packed weight", wp)
        self.rows.append([1, op.in_channels, op.out_channels, op.kernel_size, S, 1, S,
                          int(elu_in), T, _ptr(h), _ptr(y), _ptr(w), _ptr(b),
                          _ptr(s_in), _ptr(s_out), 0, _ptr(wp)])
        return y, ConvTrState(partial=s_out)


def codec_program(spec: SEANetSpec, params: dict, packed: dict | None, x: torch.Tensor,
                  state: dict) -> tuple[_Program, torch.Tensor, dict]:
    """The op table of one decoder call on the card, not yet launched: the
    program, and the audio and state tensors it will write."""
    if not x.is_cuda:
        raise ValueError(f"codec_decode kernel: input on {x.device}")
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"codec_decode kernel: dtype {x.dtype}")
    tc = x.dtype == torch.bfloat16  # the tensor-core body reads the packed weights
    if tc and packed is None:
        raise ValueError("codec_decode kernel: no packed weights (pack_decoder_params, once "
                         "per model)")
    if not decoder_is_fusable(spec):
        raise NotImplementedError("codec_decode kernel: decoder program not fusable")
    x = x.contiguous()
    prog = _Program(x)
    new_state: dict = {}
    h, elu_pending = x, False
    for i, (kind, op) in enumerate(spec.ops):
        key = str(i)
        if kind == "elu":
            if elu_pending:
                raise NotImplementedError("codec_decode kernel: two ELUs in a row")
            elu_pending = True
            continue
        wp = packed[key] if tc else None
        if kind == "conv":
            h, new_state[key] = prog.conv(op, params[key], wp, state[key], h, elu_pending,
                                          stem=i == 0)
        elif kind == "convtr":
            h, new_state[key] = prog.convtr(op, params[key], wp, state[key], h, elu_pending)
        elif kind == "resblock":
            if elu_pending:
                raise NotImplementedError("codec_decode kernel: ELU before a residual block")
            v, ss = h, []
            for j, cspec in enumerate(op.convs):
                last = j == len(op.convs) - 1
                v, sj = prog.conv(cspec, params[key][j], wp[j] if tc else None, state[key][j],
                                  v, True, res=h if last else None)
                ss.append(sj)
            h, new_state[key] = v, ss
        elu_pending = False
    if elu_pending:
        raise NotImplementedError("codec_decode kernel: program ends with an ELU")
    return prog, h, new_state


def run_program(prog: _Program, rows: list[int] | None = None, skip: int = 0) -> list[str]:
    """Launch the program's ops (`rows` of its table alone, if given) in one
    kernel call, and return the body each ran on. `skip` is a bit mask of the
    tile codes (BODIES) the tile choice passes over: 0 on the serving path;
    chip_smoke.py times each op with and without the tile it chose."""
    lib = KERNEL.load()
    table = np.asarray(prog.rows, dtype=np.int64)
    table = np.ascontiguousarray(table if rows is None else table[rows])
    bodies = np.zeros(len(table), dtype=np.int32)
    err = lib.codec_decode_run(_DTYPES[prog.dtype], prog.B, len(table), table.ctypes.data,
                               bodies.ctypes.data, skip,
                               torch.cuda.current_stream(prog.device).cuda_stream)
    check(err, "codec_decode_run")
    KERNEL.launches += 1
    KERNEL.bodies = [BODIES[int(b)] for b in bodies]
    return KERNEL.bodies


def _codec_decode_cuda(spec: SEANetSpec, params: dict, packed: dict | None, x: torch.Tensor,
                       state: dict) -> tuple[torch.Tensor, dict]:
    KERNEL.load()  # no kernel built: raises before anything else
    prog, h, new_state = codec_program(spec, params, packed, x, state)
    run_program(prog)
    return h, new_state


def codec_decode(spec: SEANetSpec, params: dict, x: torch.Tensor, state: dict,
                 packed: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Streaming SEANet decode of x [B, C0, T0] -> (audio [B, 1, T_out], state):
    the kernel on a CUDA tensor (bf16 over `packed`, from
    `pack_decoder_params`), `seanet_apply` on a CPU tensor (which ignores
    `packed`)."""
    if x.device.type == "cpu":
        return seanet_apply(spec, params, x, state)
    return _codec_decode_cuda(spec, params, packed, x, state)

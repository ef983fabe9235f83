"""Fused SEANet decoder: the whole decoder op program in one call.

Replaces the Pallas kernel pocket_tts_tpu/ops/codec_decode.py
(`seanet_decoder_fused` / `_build_kernel`). It computes
`nn.seanet.seanet_apply(decoder_spec, ...)` on the streaming path: [B, C0, T0]
latents at the codec rate -> [B, 1, T0 * prod(ratios)] audio, with every
conv's left context and every transposed conv's overlap-add tail read in and
written out. Replicate padding (only the stem may use it, as in the JAX
package) is resolved here before the launch.

On a CUDA tensor the wrapper lays the program out as a table of ops and
makes one call into csrc/codec_decode.cu, which launches one direct
convolution per conv (ELU fused into the next conv's input load, the
residual add into the block's last conv). On a CPU tensor it runs
`seanet_apply`, the plain PyTorch version. There is no fallback from one to
the other. Every SEANet call of the decoder goes here, whatever T0 (the JAX
package sends only single-frame steps to its kernel), so the card runs no
plain convolution on the main path.

Bound on the H100 at the flagship decoder: ~330 MFLOP and ~8 MB of bf16
weights per frame (T0 = 16): bytes bind at one frame (~2.4 us at 3.35 TB/s),
operations from T0 of about 128 up. The first design computes on the CUDA
cores from shared-memory tiles (see the source); the 128-lane output padding
of the TPU kernel has no counterpart here.
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
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


KERNEL = CudaKernel("codec_decode", _bind)


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
    """The op table the kernel walks, and the tensors it points into (kept
    alive until the call has been enqueued)."""

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

    def conv(self, op: ConvSpec, p, s: ConvState, h: torch.Tensor, elu_in: bool,
             res: torch.Tensor | None = None, stem: bool = False):
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
        self.rows.append([0, op.in_channels, op.out_channels, op.kernel_size, 1, op.dilation,
                          ctx, int(elu_in), T, _ptr(h), _ptr(y), _ptr(w), _ptr(b),
                          _ptr(s_in), _ptr(s_out), _ptr(res)])
        return y, new_state

    def convtr(self, op, p, s: ConvTrState, h: torch.Tensor, elu_in: bool):
        S, T = op.stride, h.shape[-1]
        s_in = self._operand("convtr state", s.partial)
        s_out = self._tensor(op.out_channels, S)
        y = self._tensor(op.out_channels, T * S)
        w, b = self._operand("weight", p.weight), self._operand("bias", p.bias)
        self.rows.append([1, op.in_channels, op.out_channels, op.kernel_size, S, 1, S,
                          int(elu_in), T, _ptr(h), _ptr(y), _ptr(w), _ptr(b),
                          _ptr(s_in), _ptr(s_out), 0])
        return y, ConvTrState(partial=s_out)


def _codec_decode_cuda(spec: SEANetSpec, params: dict, x: torch.Tensor,
                       state: dict) -> tuple[torch.Tensor, dict]:
    lib = KERNEL.load()
    if not x.is_cuda:
        raise ValueError(f"codec_decode kernel: input on {x.device}")
    if x.dtype not in _DTYPES:
        raise NotImplementedError(f"codec_decode kernel: dtype {x.dtype}")
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
        if kind == "conv":
            h, new_state[key] = prog.conv(op, params[key], state[key], h, elu_pending,
                                          stem=i == 0)
        elif kind == "convtr":
            h, new_state[key] = prog.convtr(op, params[key], state[key], h, elu_pending)
        elif kind == "resblock":
            if elu_pending:
                raise NotImplementedError("codec_decode kernel: ELU before a residual block")
            v, ss = h, []
            for j, cspec in enumerate(op.convs):
                last = j == len(op.convs) - 1
                v, sj = prog.conv(cspec, params[key][j], state[key][j], v, True,
                                  res=h if last else None)
                ss.append(sj)
            h, new_state[key] = v, ss
        elu_pending = False
    if elu_pending:
        raise NotImplementedError("codec_decode kernel: program ends with an ELU")
    table = np.ascontiguousarray(np.asarray(prog.rows, dtype=np.int64))
    err = lib.codec_decode_run(_DTYPES[x.dtype], prog.B, len(prog.rows),
                               table.ctypes.data,
                               torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "codec_decode_run")
    KERNEL.launches += 1
    return h, new_state


def codec_decode(spec: SEANetSpec, params: dict, x: torch.Tensor,
                 state: dict) -> tuple[torch.Tensor, dict]:
    """Streaming SEANet decode of x [B, C0, T0] -> (audio [B, 1, T_out], state):
    the kernel on a CUDA tensor, `seanet_apply` on a CPU tensor."""
    if x.device.type == "cpu":
        return seanet_apply(spec, params, x, state)
    return _codec_decode_cuda(spec, params, x, state)

"""The port's flash-decode op (pocket_tts_tpu_torch/ops/flash_decode.py) against
the JAX package: its plain version on the CPU against `flash_decode_ref` (the
XLA twin) and against the Pallas kernel in interpret mode, f32, held to JAX's
own bar for the kernel, 2e-5 (tests/test_flash_decode.py: the same softmax
summed in another order). The CUDA kernel is held against the plain version
on the card in tests/test_torch_kernels_cuda.py.

Caches carry dead slots (pos = -1) inside the prefix, slots written past the
row's offset (speculative: never attended), never-written tails, per-row
offsets, and one row whose slots are all dead."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocket_tts_tpu.ops.flash_decode import flash_decode_ref, flash_decode_tpu
from pocket_tts_tpu_torch.nn.transformer import TransformerConfig
from pocket_tts_tpu_torch.nn.transformer import init_stack_state
from pocket_tts_tpu_torch.nn.transformer import transformer_apply as port_transformer_apply
from pocket_tts_tpu_torch.ops import flash_decode as fd
from pocket_tts_tpu_torch.ops.build import CSRC
from torch_port import host

TOL = 2e-5


def make_case(B, C, H, Dh, seed=0, past=3):
    """(q, k, v, k_new, v_new, pos, offset) as numpy; row 0 all dead; every
    other row fills a prefix in write order with every 7th slot dead and its
    last `past` slots past the offset."""
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.standard_normal((B, H, Dh)).astype(np.float32) for _ in range(3))
    k, v = (rng.standard_normal((B, C, H, Dh)).astype(np.float32) for _ in range(2))
    pos = np.full((B, C), -1, np.int32)
    offset = np.zeros((B,), np.int32)
    for b in range(1, B):
        fill = int(C * (0.3 + 0.6 * b / max(B - 1, 1)))
        p = np.arange(fill, dtype=np.int32)
        p[6::7] = -1
        pos[b, :fill] = p
        offset[b] = max(fill - 1 - past, 0)
    return q, k, v, kn, vn, pos, offset


def run_plain(args, att_len=None):
    return fd.flash_decode(*(torch.from_numpy(a) for a in args), att_len=att_len)


@pytest.mark.parametrize("B,C,H,Dh", [(3, 128, 4, 64), (4, 384, 2, 64), (2, 64, 4, 16)])
def test_plain_matches_flash_decode_ref(B, C, H, Dh):
    args = make_case(B, C, H, Dh, seed=B)
    want = flash_decode_ref(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(host(run_plain(args)), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,C,H,Dh", [(1, 128, 2, 64), (3, 384, 4, 64), (2, 768, 16, 64)])
def test_plain_matches_pallas_kernel_interpret(B, C, H, Dh):
    args = make_case(B, C, H, Dh, seed=10 + B)
    want = flash_decode_tpu(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_allclose(host(run_plain(args)), np.asarray(want), rtol=TOL, atol=TOL)


def test_all_dead_row_attends_only_the_new_value():
    args = make_case(3, 128, 4, 64, seed=7)
    out = run_plain(args)
    np.testing.assert_allclose(host(out[0]), args[4][0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("att_len", [96, 128])
def test_att_len_stops_at_the_valid_prefix(att_len):
    """Every valid slot lies below att_len: the same answer as the full
    cache, and slots at or above it are never read (NaN there stays out)."""
    args = list(make_case(3, 256, 4, 64, seed=8))
    args[5][:, 90:] = -1  # nothing valid from slot 90 on
    # copies (jnp.array), read back before the NaN writes below: jnp.asarray
    # may alias the numpy buffers, and the reference may still be running
    want = np.asarray(flash_decode_ref(*(jnp.array(a) for a in args)))
    args[1][:, att_len:] = np.nan
    args[2][:, att_len:] = np.nan
    got = run_plain(args, att_len=att_len)
    np.testing.assert_allclose(host(got), want, rtol=TOL, atol=TOL)


def test_bf16_rounds_weights_like_the_ref():
    """bf16: the normalised weights are rounded to the cache dtype before the
    value sum, as flash_decode_ref does; one bf16 rounding of the output."""
    args = make_case(2, 128, 4, 64, seed=9)
    want = flash_decode_ref(*(jnp.asarray(a, jnp.bfloat16) for a in args[:5]),
                            jnp.asarray(args[5]), jnp.asarray(args[6]))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in args[:5]]
    got = fd.flash_decode(*bf, torch.from_numpy(args[5]), torch.from_numpy(args[6]))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(host(got), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


def test_takes_predicate():
    assert fd.flash_decode_takes(4096, 64) and fd.flash_decode_takes(100, 16)
    assert fd.flash_decode_takes(0, 128)
    assert not fd.flash_decode_takes(4097, 64)  # the op's contract
    assert not fd.flash_decode_takes(256, 15)  # odd head dim
    assert not fd.flash_decode_takes(256, 256)


def test_batched_decode_routes_to_flash_decode(monkeypatch):
    """A T=1 step at B>1 over the linear cache attends through the op, with
    att_len = the write pointer; a prompt pass (T>1) does not."""
    calls = []
    orig = fd.flash_decode_plain

    def spy(*a, **kw):
        calls.append(a[-1] if len(a) == 8 else kw.get("att_len"))
        return orig(*a, **kw)

    monkeypatch.setattr(fd, "flash_decode_plain", spy)
    cfg = TransformerConfig(d_model=32, num_heads=2, num_layers=2, dim_feedforward=64)
    g = torch.Generator().manual_seed(0)
    from pocket_tts_tpu_torch.nn.transformer import init_layer_params

    params = init_layer_params(cfg, g, torch.float32, "cpu")
    state = init_stack_state(cfg, 3, 64, torch.float32, "cpu")
    _, state = port_transformer_apply(cfg, params, torch.randn((3, 5, 32), generator=g), state)
    assert calls == []
    port_transformer_apply(cfg, params, torch.randn((3, 1, 32), generator=g), state)
    assert calls == [5, 5]  # once per layer, over the 5 written slots


@pytest.fixture(scope="module")
def splits_lib(tmp_path_factory):
    """csrc/flash_splits.cuh, the kernel's own split rule, compiled here by the
    host C++ compiler (the header is plain C++ outside nvcc)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "a host C++ compiler is needed to build csrc/flash_splits.cuh"
    d = tmp_path_factory.mktemp("flash_splits")
    (d / "splits.cpp").write_text(
        '#include "flash_splits.cuh"\n'
        'extern "C" int splits(int rows, int att, int sms) {\n'
        '  return pt::fd_splits(rows, att, sms);\n}\n'
        'extern "C" int split_start(int att, int S, int r) {\n'
        '  return pt::fd_split_start(att, S, r);\n}\n'
        'extern "C" int limit(int i) {\n'
        '  const int v[4] = {pt::kFdMaxSplits, pt::kFdBlocksPerSm, pt::kFdMaxSlots,\n'
        '                    pt::kFdMinSlots};\n  return v[i];\n}\n')
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(CSRC), "-o",
                    str(d / "libsplits.so"), str(d / "splits.cpp")], check=True)
    return ctypes.CDLL(str(d / "libsplits.so"))


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("B,H", [(1, 16), (2, 16), (8, 16), (32, 16), (128, 16), (4, 4)])
def test_splits_cover_every_attended_slot_once(splits_lib, sms, B, H):
    """The kernel's split of a row (block r of the row's cluster attends
    slots fd_split_start(att, S, r) .. fd_split_start(att, S, r + 1) - 1),
    at every att_len the op takes: S is a power of two up to the portable
    cluster size; the ranges are consecutive, cover [0, att) once and differ
    in size by at most one slot; a split holds at least the minimum unless
    the row is not split; and a row stops being cut only at the cap, at the
    minimum, or once the grid has the blocks per SM it aims for and no split
    is too long."""
    max_s, per_sm, max_slots, min_slots = (splits_lib.limit(i) for i in range(4))
    rows = B * H
    for att in range(fd.MAX_ATT + 1):
        S = splits_lib.splits(rows, att, sms)
        assert S in (1, 2, 4, 8) and S <= max_s
        starts = [splits_lib.split_start(att, S, r) for r in range(S + 1)]
        assert starts[0] == 0 and starts[-1] == att
        sizes = [b - a for a, b in zip(starts, starts[1:])]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        if S > 1:
            assert min(sizes) >= min_slots
        if S < max_s and att >= 2 * S * min_slots:
            assert rows * S >= per_sm * sms and max(sizes) <= max_slots

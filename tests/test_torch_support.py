"""The port's support modules on the CPU: core/logging_utils.py and
core/debugging.py (the counterparts of tests/test_debugging.py), the native
tokenizer binding text/native.py against the port's Python tokenizer and the
JAX package's native one (tests/test_native_tokenizer.py's toy models; those
cases skip when native/libsptok.so does not load here), the tokenizer that
load_model chooses, and POCKET_TTS_SAVE_WEIGHTS."""

import json
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from pocket_tts_tpu.core.weights import load_safetensors as jax_load_safetensors
from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu.text import native as jnative
from pocket_tts_tpu_torch.core.bridge import to_numpy
from pocket_tts_tpu_torch.core.debugging import intermediate_dump, print_ops, profile_trace, tag
from pocket_tts_tpu_torch.core.logging_utils import (
    PocketTTSFilter,
    display_execution_time,
    enable_logging,
)
from pocket_tts_tpu_torch.core.tree import tree_map
from pocket_tts_tpu_torch.pipeline import tts as ptts
from pocket_tts_tpu_torch.text import native as pnative
from pocket_tts_tpu_torch.text.sentencepiece import SentencePieceTokenizer
from test_native_tokenizer import TEXTS
from test_tokenizer import PIECES, build_model
from torch_port import write_small_checkpoint, write_small_config

# ---------------------------------------------------------------- debugging


def test_tag_collects_inside_context():
    def f(x):
        y = x * 2
        tag("doubled", y)
        tag("half", (y / 4).to(torch.bfloat16))
        return y + 1

    with intermediate_dump() as dump:
        f(torch.arange(4.0))
        f(torch.ones(4))
    np.testing.assert_allclose(dump["doubled"][0], [0, 2, 4, 6])
    np.testing.assert_allclose(dump["doubled"][1], [2, 2, 2, 2])
    assert dump["half"][0].dtype == np.float32  # bf16 recorded as f32


def test_tag_is_noop_outside_context():
    x = torch.ones(2)
    tag("unused", x)
    with intermediate_dump() as dump:
        pass
    assert dump == {}


def test_tag_copies_the_value():
    x = torch.zeros(3)
    with intermediate_dump() as dump:
        tag("x", x)
        x += 1  # an in-place op after the tag does not reach the record
    np.testing.assert_array_equal(dump["x"][0], [0, 0, 0])


def test_print_ops():
    text = print_ops(lambda x: x * 2 + 1, torch.ones(3))
    assert "aten.mul" in text and "aten.add" in text
    assert "float32[3]" in text


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(tmp_path / "trace") as out:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((out / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# ---------------------------------------------------------------- logging


def test_enable_logging_scoped():
    logger = logging.getLogger("pocket_tts_tpu_torch.test")
    with enable_logging(logging.INFO) as pkg:
        assert pkg.name == "pocket_tts_tpu_torch" and pkg.handlers
        logger.info("inside")
    assert not logging.getLogger("pocket_tts_tpu_torch").handlers


def test_filter_names_the_port():
    f = PocketTTSFilter()

    def rec(name):
        return logging.LogRecord(name, logging.INFO, __file__, 0, "m", None, None)

    assert f.filter(rec("pocket_tts_tpu_torch.pipeline.tts"))
    assert not f.filter(rec("pocket_tts_tpu.pipeline.tts"))


def test_display_execution_time_records():
    with display_execution_time("task", print_output=False) as timer:
        pass
    assert timer.elapsed_time_ms is not None and timer.elapsed_time_ms >= 0


# ---------------------------------------------------------------- tokenizer


@pytest.fixture
def native():
    if not pnative.native_available():
        pytest.skip("native tokenizer library does not load here (make -C native)")


def test_native_matches_python_and_jax(native, tmp_path):
    path = build_model(tmp_path, PIECES, with_bytes=True)
    n_bins = 1 + len(PIECES) + 256
    py = SentencePieceTokenizer(n_bins, path)
    nat = pnative.NativeSentencePieceTokenizer(n_bins, path)
    jnat = jnative.NativeSentencePieceTokenizer(n_bins, path)
    for text in TEXTS:
        ids = nat.encode(text)
        assert ids == py.encode(text) == jnat.encode(text), text
        assert nat.decode(ids) == py.decode(ids) == jnat.decode(ids), text


def test_native_vocab_check(native, tmp_path):
    path = build_model(tmp_path, PIECES)
    with pytest.raises(ValueError):
        pnative.NativeSentencePieceTokenizer(7, path)


@pytest.mark.parametrize("loads", [True, False], ids=["native", "python-fallback"])
def test_best_tokenizer_chooses_as_jax(tmp_path, monkeypatch, loads):
    """The same kind of tokenizer as the JAX package's best_tokenizer, with
    the library loading and with it missing, and the same tokens."""
    if loads and not pnative.native_available():
        pytest.skip("native tokenizer library does not load here (make -C native)")
    if not loads:
        monkeypatch.setattr(pnative, "native_available", lambda: False)
        monkeypatch.setattr(jnative, "_LIB", None)
    path = build_model(tmp_path, PIECES, with_bytes=True)
    n_bins = 1 + len(PIECES) + 256
    got, ref = pnative.best_tokenizer(n_bins, path), jnative.best_tokenizer(n_bins, path)
    assert type(got).__name__ == type(ref).__name__
    assert type(got).__name__ == ("NativeSentencePieceTokenizer" if loads
                                  else "SentencePieceTokenizer")
    for text in TEXTS:
        assert got.encode(text) == ref.encode(text)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_support")
    ckpt, tok = write_small_checkpoint(tmp, seed=2)
    return tmp, write_small_config(tmp, "support", tok, weights_path=ckpt)


def test_load_model_takes_best_tokenizer(checkpoint):
    _, config = checkpoint
    pm = ptts.TTSModel.load_model(config=config, device="cpu")
    jm = jtts.TTSModel.load_model(config=config)
    assert type(pm.tokenizer).__name__ == type(jm.tokenizer).__name__
    assert pm.tokenizer.encode("hello world, this is a test.") == \
        jm.tokenizer.encode("hello world, this is a test.")


# ---------------------------------------------------------------- save weights


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_weights_env(checkpoint, tmp_path, monkeypatch, dtype):
    """POCKET_TTS_SAVE_WEIGHTS=1: load_model writes ./model.safetensors with
    the JAX package's key names and the loaded model's values (cast to the
    dtype, before int8 quantization); it loads back to the same params."""
    _, config = checkpoint
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("POCKET_TTS_SAVE_WEIGHTS", "1")
    pm = ptts.TTSModel.load_model(config=config, device="cpu", param_dtype=dtype,
                                  quantize=True)
    saved = tmp_path / "model.safetensors"
    assert saved.exists()
    assert set(jax_load_safetensors(saved)) == set(jax_load_safetensors(
        Path(pm.config.weights_path)))
    monkeypatch.delenv("POCKET_TTS_SAVE_WEIGHTS")
    cfg = write_small_config(tmp_path, "saved", tmp_path / "tok.model", weights_path=saved)
    back = ptts.TTSModel.load_model(config=cfg, device="cpu", param_dtype=dtype)
    plain = ptts.TTSModel.load_model(config=config, device="cpu", param_dtype=dtype)
    for a, b in ((back.params, plain.params), (back.mimi_params, plain.mimi_params)):
        got, want = leaves(a), leaves(b)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(to_numpy(x), to_numpy(y))
    assert isinstance(pm.params["transformer"]["w1"], dict)  # quantized after the save

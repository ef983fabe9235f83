"""The port's tools that drive the kernels and the model, CPU:
pocket_tts_tpu_torch.tools.generate_default_voices against the JAX
package's scripts/generate_default_voices.py (loaded by file, as
test_torch_evaluate_quantization loads its script), and the parts of
tools.kernel_gate and tools.profile_step that run without a card.

- The exporter: both scripts' `main` over one small checkpoint and a
  catalog of two local wavs and a missing one; every exported state equal
  at 1e-5 (f32: the same arithmetic summed in another order), the missing
  voice skipped with no file, an existing file left as it is.
- The gate's cases cover the routes: the port's frame step (FlowLM decode
  step, the Mimi decoder over the block ramp's 1, 8 and 32 frames) and text
  prompts of 8-32 positions run on the meta device (shapes only) at the
  6- and 24-layer configs' full width, in bf16 and f32 under every named
  quantization config, at B = 1, 32 and 128, with each kernel wrapper
  replaced by a spy that records (kernel, activation dtype, weight dtype,
  rows) and runs the plain version: every record is a gate case's key.
- The gate fails when it should: a failing case gives its FAIL line and
  exit code 1; no CUDA device, a non-zero exit.
- The profile's components compute the model step: bit-equal to the
  port's decode_step / decoder_step / lsd_decode / seanet_apply called
  directly on the same inputs (small model, CPU).
- Without a card each tool exits non-zero and writes nothing.
"""

import importlib.util
import subprocess
import sys
import wave
from contextlib import redirect_stdout
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu_torch.config import CONFIGS_DIR, load_config
from pocket_tts_tpu_torch.core.tree import tree_leaves, tree_map
from pocket_tts_tpu_torch.models import mimi as pmimi
from pocket_tts_tpu_torch.models.flow_lm import (
    build_flow_lm_specs,
    decode_step,
    init_flow_lm_params,
    init_flow_lm_state,
    prompt_step,
)
from pocket_tts_tpu_torch.nn import attention as patt
from pocket_tts_tpu_torch.nn.flow_mlp import lsd_decode
from pocket_tts_tpu_torch.nn.seanet import seanet_apply
from pocket_tts_tpu_torch.nn.transformer import StackState
from pocket_tts_tpu_torch.ops import decode_stack as ds
from pocket_tts_tpu_torch.ops import flash_decode as fd
from pocket_tts_tpu_torch.ops import gemv as gv
from pocket_tts_tpu_torch.pipeline import tts as ptts
from pocket_tts_tpu_torch.pipeline.tts import PROMPT_BUCKETS
from pocket_tts_tpu_torch.quant import NAMED_CONFIGS, quantize_flow_lm_int8
from pocket_tts_tpu_torch.tools import generate_default_voices as pgen
from pocket_tts_tpu_torch.tools import kernel_gate as kg
from pocket_tts_tpu_torch.tools import profile_step as ps
from torch_port import write_small_config, write_small_port_checkpoint

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location(
    "generate_default_voices_jax", REPO / "scripts" / "generate_default_voices.py")
jgen = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jgen)

TOL = 1e-5


def write_wav16(path, seconds, rate, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    audio = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Both exporters over one checkpoint and the catalog {alpha: a 24 kHz
    wav, beta: a 16 kHz wav (resampled), gamma: no file}, language
    "english" loaded from the local config; their stdout."""
    tmp = tmp_path_factory.mktemp("voices")
    ckpt, tok = write_small_port_checkpoint(tmp, seed=19)
    cfg = write_small_config(tmp, "voices", tok, weights_path=ckpt)
    write_wav16(tmp / "alpha.wav", 1.3, 24000, seed=1)
    write_wav16(tmp / "beta.wav", 1.1, 16000, seed=2)
    catalog = {"alpha": str(tmp / "alpha.wav"), "beta": str(tmp / "beta.wav"),
               "gamma": str(tmp / "missing.wav")}
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.setattr(pgen, "PREDEFINED_VOICE_ORIGINS", catalog)
        mp.setattr(pgen, "TTSModel", SimpleNamespace(
            load_model=lambda language: ptts.TTSModel.load_model(config=cfg, device="cpu")))
        mp.setattr(jgen, "PREDEFINED_VOICE_ORIGINS", catalog)
        jax_load = jtts.TTSModel.load_model
        mp.setattr(jtts.TTSModel, "load_model",
                   staticmethod(lambda language: jax_load(config=cfg)))
        for side in ("port", "jax"):
            argv = ["--out", str(tmp / side), "--languages", "english"]
            log = tmp / f"{side}.log"
            with open(log, "w") as f, redirect_stdout(f):
                if side == "port":
                    assert pgen.main(argv) == 0
                else:
                    mp.setattr(sys, "argv", ["generate_default_voices.py", *argv])
                    assert jgen.main() == 0
            out[side] = log.read_text()
    finally:
        mp.undo()
    return tmp, catalog, cfg, out


def test_exported_states_equal_the_scripts(exports):
    tmp, _, _, out = exports
    for name in ("alpha", "beta"):
        got = load_file(tmp / "port" / "english" / "embeddings" / f"{name}.safetensors")
        want = load_file(tmp / "jax" / "english" / "embeddings" / f"{name}.safetensors")
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
            np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)
    for side in ("port", "jax"):
        lines = out[side].splitlines()
        wrote = [ln for ln in lines if ln.startswith("wrote ")]
        assert [Path(ln.split()[1]).name for ln in wrote] == ["alpha.safetensors",
                                                               "beta.safetensors"], side
        skips = [ln for ln in lines if ln.startswith("skip ")]
        assert len(skips) == 1 and skips[0].startswith("skip english/gamma: "), side


def test_missing_voice_leaves_no_file_and_existing_files_are_kept(exports):
    tmp, catalog, cfg, _ = exports
    emb = tmp / "port" / "english" / "embeddings"
    assert sorted(p.name for p in emb.iterdir()) == ["alpha.safetensors", "beta.safetensors"]
    (emb / "alpha.safetensors").write_bytes(b"kept as it is")
    before = (emb / "beta.safetensors").read_bytes()
    mp = pytest.MonkeyPatch()
    log = tmp / "again.log"
    try:
        mp.setattr(pgen, "PREDEFINED_VOICE_ORIGINS", catalog)
        mp.setattr(pgen, "TTSModel", SimpleNamespace(
            load_model=lambda language: ptts.TTSModel.load_model(config=cfg, device="cpu")))
        with open(log, "w") as f, redirect_stdout(f):
            assert pgen.main(["--out", str(tmp / "port"), "--languages", "english"]) == 0
    finally:
        mp.undo()
    lines = log.read_text().splitlines()
    assert not [ln for ln in lines if ln.startswith("wrote ")]
    assert len(lines) == 1 and lines[0].startswith("skip english/gamma: ")
    assert (emb / "alpha.safetensors").read_bytes() == b"kept as it is"
    assert (emb / "beta.safetensors").read_bytes() == before
    assert not (emb / "gamma.safetensors").exists()


# ------------------------------------------------------------ the gate's coverage


def _meta_tree(tree, dtype):
    return tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32 else t, tree)


@pytest.fixture
def spies(monkeypatch):
    """Each kernel wrapper on the frame step's routes replaced by a recorder
    of (kernel, activation dtype, weight dtype, rows) that runs the plain
    version (on the meta device: shapes only)."""
    seen = set()

    def gemv(x, w):
        W = w["q"] if isinstance(w, dict) else w
        seen.add(("gemv", x.dtype, W.dtype, x.shape[0]))
        return gv.gemv_plain(x, w)

    def decode_stack(cfg, params, x, *args):
        seen.add(("decode_stack", x.dtype, torch.int8 if ds._quantized(params) else x.dtype, 1))
        return ds.decode_stack_plain(cfg, params, x, *args)

    def flash(q, *args, **kw):
        seen.add(("flash_decode", q.dtype, q.dtype, q.shape[0]))
        return fd.flash_decode_plain(q, *args, **kw)

    def codec(spec, params, x, state, packed=None):
        seen.add(("codec_decode", x.dtype, x.dtype, x.shape[0]))
        return seanet_apply(spec, params, x, state)

    monkeypatch.setattr(gv, "gemv", gemv)
    monkeypatch.setattr(ds, "decode_stack", decode_stack)
    monkeypatch.setattr(patt, "flash_decode", flash)
    monkeypatch.setattr(pmimi, "codec_decode", codec)
    return seen


@pytest.mark.parametrize("config", ["english", "italian_24l"])
def test_gate_cases_cover_every_route(config, spies):
    cfg = load_config(CONFIGS_DIR / f"{config}.yaml")
    specs, ms = build_flow_lm_specs(cfg), pmimi.build_mimi_specs(cfg.mimi)
    meta = "meta"
    base = init_flow_lm_params(specs, None, torch.float32, meta)
    mimi0 = pmimi.init_mimi_params(ms, None, torch.float32, meta)
    for dtype in (torch.bfloat16, torch.float32):
        mimi = _meta_tree(mimi0, dtype)
        for B in (1, 32, 128):
            for K in (1, 8, 32):  # the block ramp
                pmimi.decoder_step(ms, mimi, torch.zeros((B, ms.quantizer_out_dim, K),
                                                         dtype=dtype, device=meta),
                                   pmimi.init_decoder_state(ms, B, dtype, meta))
        for quant in NAMED_CONFIGS:
            params = quantize_flow_lm_int8(_meta_tree(base, dtype), quant)
            for B in (1, 32, 128):
                st = init_flow_lm_state(specs, B, 256, dtype, meta)
                zeros = torch.zeros((B, specs.ldim), device=meta)
                decode_step(specs, params, st, zeros, torch.zeros(B, dtype=torch.bool, device=meta),
                            zeros, lsd_steps=1, eos_threshold=-4.0)
            for pad_to in PROMPT_BUCKETS[:3]:  # the prompts of at most 32 positions
                prompt_step(specs, params, init_flow_lm_state(specs, 1, 256, dtype, meta),
                            torch.zeros((1, pad_to, specs.transformer.d_model), dtype=dtype,
                                        device=meta))
    kernels = {key[0] for key in spies}
    assert kernels == {"gemv", "decode_stack", "flash_decode", "codec_decode"}
    covered = {case.key for case in kg.cases()}
    assert not spies - covered, sorted(spies - covered, key=str)


def test_gate_cases_are_distinct_and_cover_five_kernels():
    cases = kg.cases()
    assert len({c.name for c in cases}) == len(cases)
    assert {c.key[0] for c in cases} == {"codec_decode", "flash_decode", "gemv",
                                         "decode_stack", "gemv_stack"}


# ------------------------------------------------------------ the gate's failures


def test_gate_holds_at_the_bars():
    """hold: the bf16 bar 2e-2 and the f32 bar 1e-4 of max |plain|, the bf16
    one x sqrt(L / 6) past 6 layers; empty states pass; a shape, dtype or
    non-finite output fails."""
    want = torch.linspace(-1, 1, 64)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        w = want.to(dtype)
        kg.hold("x", (want + 0.9 * tol).to(dtype) if dtype == torch.float32 else w, w, dtype)
        with pytest.raises(AssertionError, match="max \\|kernel - plain\\|"):
            kg.hold("x", (want + 3 * tol).to(dtype), w, dtype)
    off = torch.zeros(64)
    off[0] = 0.03  # past 2e-2, within 2e-2 x sqrt(24 / 6)
    with pytest.raises(AssertionError):
        kg.hold("h", want + off, want, torch.bfloat16)
    kg.hold("h", want + off, want, torch.bfloat16, layers=24)
    kg.hold("state", torch.empty(2, 3, 0), torch.empty(2, 3, 0), torch.float32)
    for bad in (want[:3], want.double(), want.clone().index_fill_(0, torch.tensor([1]), np.nan)):
        with pytest.raises(AssertionError):
            kg.hold("x", bad, want, torch.float32)


def test_gate_fails_on_a_failing_case(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kg, "card_line", lambda: "test card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    for name in ("codec", "flash_decode", "decode_stack", "gemv_stack"):
        monkeypatch.setattr(kg, name, lambda *a, **kw: None)

    def gemv(x_dtype, w_dtype, rows):
        if (x_dtype, w_dtype, rows) == (torch.bfloat16, torch.int8, 8):
            raise RuntimeError("gemv_run: CUDA error 700\nsecond line")

    monkeypatch.setattr(kg, "gemv", gemv)
    with pytest.raises(SystemExit) as exc:
        kg.main()
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL gemv[b8 int8]: gemv_run: CUDA error 700\n" in out
    assert "second line" not in out
    assert out.count("\nPASS ") == len(kg.cases()) - 1
    assert "1 kernel gate(s) FAILED: ['gemv[b8 int8]']" in out
    assert "all kernel gates passed" not in out


def test_gate_without_a_card_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(kg, "cases", lambda: ran.append(1) or [])
    with pytest.raises(SystemExit) as exc:
        kg.main()
    assert exc.value.code not in (0, None) and not ran


# ------------------------------------------------------------ the profile


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("profile")
    from test_cli_generate import build_tokenizer_model

    tok = tmp / "tok.model"
    build_tokenizer_model(tok)
    return ps.build("cpu", config=write_small_config(tmp, "profile", tok), dtype=torch.float32)


def _copy(x):
    if isinstance(x, StackState):
        return x.clone()
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return tree_map(torch.clone, x)
    return x


def _reference(model, name, args):
    """The component's work through the model's functions called directly."""
    specs, params, ms, mp = model.specs, model.params, model.mimi_specs, model.mimi_params
    steps = dict(lsd_steps=model.gen.lsd_decode_steps, eos_threshold=model.gen.eos_threshold)
    if name.startswith(("full_", "lm_")):
        lm, prev, noise = (args[1], args[3], args[4]) if name.startswith("full_") else args[1:]
        bos = torch.zeros(prev.shape[0], dtype=torch.bool)
        latents, flags = [], []
        for n in noise:
            prev, eos, lm = decode_step(specs, params, lm, prev, bos, n, **steps)
            latents.append(prev)
            flags.append(eos)
        if name.startswith("lm_"):
            return prev, lm
        stacked = torch.stack(latents)
        q = pmimi.project_latent(ms, mp, (stacked * params["emb_std"]
                                          + params["emb_mean"]).permute(1, 2, 0))
        audio, mimi = pmimi.decoder_step(ms, mp, q, args[2])
        K, B = noise.shape[:2]
        return stacked, torch.stack(flags), audio.reshape(B, 1, K, -1).permute(2, 0, 1, 3), lm, mimi
    if name == "flow_mlp":
        x = args[2]
        for _ in range(ps.BLOCK):
            x = lsd_decode(specs.flow, params["flow_net"], args[1], x, steps["lsd_steps"])
        return x
    if name.startswith("mimi_step"):
        return pmimi.decoder_step(*args)
    return seanet_apply(*args[:4])


def _leaves(tree):
    if isinstance(tree, StackState):
        return [tree.k, tree.v, tree.pos, tree.offset, tree.write_pos]
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return [leaf for t in tree for leaf in _leaves(t)]
    return tree_leaves(tree)


@pytest.mark.parametrize("batch", [1, 3])
def test_profile_components_compute_the_model_step(small_model, batch):
    comps = ps.components(small_model, batch, "cpu")
    assert list(comps) == ["full_cap768", "full_att256", "lm_cap768", "lm_att256", "flow_mlp",
                           "mimi_step", "mimi_step_plain", "seanet_kernel", "seanet_plain"]
    for name, (fn, args) in comps.items():
        got = _leaves(fn(*map(_copy, args)))
        want = _leaves(_reference(small_model, name, [_copy(a) for a in args]))
        assert len(got) == len(want), name
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert a.shape == b.shape and torch.equal(a, b), name
            else:
                assert a == b, name


def test_profile_states_attend_their_fill(small_model):
    """cap768 and att256: the write pointer where the block's steps start."""
    for tag, fill in ps.FILLS.items():
        st = ps.lm_state(small_model, 2, fill, "cpu")
        assert st.write_pos == fill and st.write_ptr.tolist() == [fill]
        assert st.offset.tolist() == [fill, fill] and st.k.shape[2] == ps.CAPACITY
        assert (st.pos[:, :fill] >= 0).all() and (st.pos[:, fill:] == -1).all()
        assert fill + ps.BLOCK <= ps.CAPACITY


def test_profile_without_a_card_exits_non_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ps, "build", lambda *a, **kw: pytest.fail("built a model on the CPU"))
    with pytest.raises(SystemExit) as exc:
        ps.main(["1"])
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("tool,args", [
    ("kernel_gate", []),
    ("profile_step", ["1"]),
    ("generate_default_voices", ["--languages", "english", "--out", "OUT"]),
])
def test_tools_exit_non_zero_without_a_card(tool, args, tmp_path):
    """`python -m` each tool in a fresh process here (no CUDA device): a
    non-zero exit, and the exporter makes no directory."""
    args = [str(tmp_path / "out") if a == "OUT" else a for a in args]
    proc = subprocess.run([sys.executable, "-m", f"pocket_tts_tpu_torch.tools.{tool}", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "CUDA" in proc.stderr or "CUDA" in proc.stdout
    assert not (tmp_path / "out").exists()

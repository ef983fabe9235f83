"""The port's CLI (pocket_tts_tpu_torch.api.cli) against the JAX package's, on
the CPU: one small checkpoint (tests/torch_port.write_small_checkpoint) that
both packages load, a local voice wav, EOS off (--eos-threshold 1e9) and the
same frame-indexed flow noise on both sides (each package's
TTSModel.generate_audio_stream is patched to take frame_noise). Also the
port's counterparts of tests/test_cli_generate.py.

Tolerances: the waveform at the repo's 1e-3 bar; in a 16-bit WAV that is
|a - b| / 32767 <= 1e-3 + 2 / 32767 (pcm16 truncates, so a difference below
one step can still flip a sample by one). Voice states at 1e-5 (f32, the
same arithmetic summed in another order)."""

import wave

import numpy as np
import pytest
import torch

from pocket_tts_tpu.api import cli as jcli
from pocket_tts_tpu.pipeline import tts as jtts
from pocket_tts_tpu.pipeline.states import import_model_state as jax_import
from pocket_tts_tpu_torch.api import cli as pcli
from pocket_tts_tpu_torch.default_parameters import MAX_TOKEN_PER_CHUNK
from pocket_tts_tpu_torch.pipeline import tts as ptts
from pocket_tts_tpu_torch.pipeline.states import import_model_state as port_import
from pocket_tts_tpu_torch.text.splitter import split_into_best_sentences
from test_cli_generate import write_voice_wav
from torch_port import frame_noise, host, write_small_checkpoint, write_small_config

WAV_ATOL = 1e-3 + 2 / 32767
STATE_TOL = 1e-5
TEXT = "hello world this is a test"
HEADER = 44


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_cli")
    ckpt, tok = write_small_checkpoint(tmp, seed=3)
    config = write_small_config(tmp, "cli", tok, weights_path=ckpt)
    voice = tmp / "voice.wav"
    write_voice_wav(voice)
    return tmp, config, voice


@pytest.fixture
def same_noise(monkeypatch):
    """Every generate_audio_stream of either package draws frame_noise."""
    for mod in (jtts, ptts):
        real = mod.TTSModel.generate_audio_stream

        def stream(self, *args, real=real, **kw):
            kw["noise_source"] = frame_noise(400, self.specs.ldim, self.gen.temp)
            return real(self, *args, **kw)

        monkeypatch.setattr(mod.TTSModel, "generate_audio_stream", stream)


def read_wav(path):
    """(the 44-byte header, the PCM as int16)."""
    data = path.read_bytes()
    return data[:HEADER], np.frombuffer(data[HEADER:], "<i2")


def assert_pcm_close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got / 32767, ref / 32767, rtol=0, atol=WAV_ATOL)


def assert_states_close(got, ref):
    for name in ("k", "v"):
        np.testing.assert_allclose(host(getattr(got, name)), np.asarray(getattr(ref, name)),
                                   rtol=STATE_TOL, atol=STATE_TOL, err_msg=name)
    np.testing.assert_array_equal(host(got.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(host(got.offset), np.asarray(ref.offset))
    assert got.write_pos == int(ref.write_pos)


def test_generate_matches_jax_cli(env, same_noise):
    """`generate` through both CLIs: equal headers, PCM at the waveform bar,
    and as many samples as the frames decoded (EOS off: every frame up to
    the length limit) plus the 0.2 s tail."""
    tmp, config, voice = env
    args = ["-q", "generate", TEXT, "--config", str(config), "--voice", str(voice),
            "--seed", "0", "--eos-threshold", "1e9"]
    assert jcli.main(args + ["--out", str(tmp / "jax.wav")]) == 0
    assert pcli.main(args + ["--out", str(tmp / "port.wav"), "--device", "cpu"]) == 0
    j_head, j_pcm = read_wav(tmp / "jax.wav")
    p_head, p_pcm = read_wav(tmp / "port.wav")
    assert p_head == j_head
    assert_pcm_close(p_pcm, j_pcm)
    model = ptts.TTSModel.load_model(config=config, device="cpu")
    (chunk,) = split_into_best_sentences(model.tokenizer, TEXT, MAX_TOKEN_PER_CHUNK,
                                         model.pad_with_spaces_for_short_inputs,
                                         model.remove_semicolons)
    frames = model._estimate_max_gen_len(len(model._encode_text(chunk)))
    assert p_pcm.size == frames * model.samples_per_frame + int(0.2 * model.sample_rate)


def test_export_voice_matches_jax_cli(env):
    """`export-voice` through both CLIs: states within 1e-5, and each
    package imports the other's export to the same state."""
    tmp, config, voice = env
    jax_file, port_file = tmp / "jax-voice.safetensors", tmp / "port-voice.safetensors"
    assert jcli.main(["-q", "export-voice", str(voice), str(jax_file),
                      "--config", str(config)]) == 0
    assert pcli.main(["-q", "export-voice", str(voice), str(port_file),
                      "--config", str(config), "--device", "cpu"]) == 0
    j_state = jax_import(jax_file)
    assert_states_close(port_import(port_file, device="cpu"), j_state)
    assert_states_close(port_import(jax_file, device="cpu"), j_state)
    assert_states_close(port_import(port_file, device="cpu"), jax_import(port_file))


def test_cli_generate_writes_valid_wav(env):
    tmp, config, voice = env
    out = tmp / "out.wav"
    rc = pcli.main(["-q", "generate", TEXT, "--config", str(config), "--voice", str(voice),
                    "--out", str(out), "--seed", "0", "--device", "cpu"])
    assert rc == 0
    with wave.open(str(out)) as w:
        assert w.getframerate() == 24000
        assert w.getnchannels() == 1
        assert w.getsampwidth() == 2
    _, pcm = read_wav(out)
    assert pcm.size > 24000 // 10


def test_cli_generate_custom_sampling(env):
    tmp, config, voice = env
    out = tmp / "out2.wav"
    rc = pcli.main(["-q", "generate", "hello world", "--config", str(config),
                    "--voice", str(voice), "--out", str(out), "--temp", "0.2",
                    "--lsd-decode-steps", "2", "--noise-clamp", "2.0",
                    "--eos-threshold", "-2.0", "--seed", "1", "--device", "cpu"])
    assert rc == 0
    _, pcm = read_wav(out)
    assert pcm.size > 0 and out.stat().st_size == HEADER + 2 * pcm.size


def test_cli_export_voice_roundtrip(env):
    """A voice exported by the port's CLI generates through it, and gives
    the audio of the wav it came from (the same state and seed; the export
    drops the prompt's padding slots, so attention sums over another slot
    layout: at the waveform bar, not bit for bit)."""
    tmp, config, voice = env
    dest = tmp / "roundtrip.safetensors"
    common = ["--config", str(config), "--device", "cpu"]
    assert pcli.main(["-q", "export-voice", str(voice), str(dest), *common]) == 0
    outs = []
    for name, source in (("from-state", dest), ("from-wav", voice)):
        outs.append(tmp / f"{name}.wav")
        assert pcli.main(["-q", "generate", "hello world", "--voice", str(source),
                          "--out", str(outs[-1]), "--seed", "2", *common]) == 0
    (head, pcm), (wav_head, wav_pcm) = map(read_wav, outs)
    assert head == wav_head and pcm.size > 0
    assert_pcm_close(pcm, wav_pcm)


def _options(parser):
    """{subcommand: {option string: (default, choices, nargs)}}."""
    sub = next(a for a in parser._actions if a.dest == "command")
    return {name: {s: (a.default, a.choices, a.nargs) for a in p._actions
                   for s in (a.option_strings or [a.dest])}
            for name, p in sub.choices.items()}


def test_parser_accepts_every_jax_flag():
    """The same subcommands, and each flag with the JAX CLI's default,
    choices and arity; the port adds --device alone."""
    jax_opts, port_opts = _options(jcli.build_parser()), _options(pcli.build_parser())
    assert set(port_opts) == set(jax_opts) == {"generate", "serve", "export-voice"}
    for cmd, opts in jax_opts.items():
        assert set(port_opts[cmd]) - set(opts) == {"--device"}, cmd
        for flag, spec in opts.items():
            assert port_opts[cmd][flag] == spec, (cmd, flag)
        assert port_opts[cmd]["--device"][0] is None  # the card unless asked
    args = pcli.build_parser().parse_args(["serve", "--port", "1234", "--device", "cpu"])
    assert args.port == 1234 and args.device == "cpu"


def test_cli_without_card_raises(env, monkeypatch):
    """No card and no --device cpu: the CLI fails with load_model's error;
    it does not carry on on the CPU."""
    tmp, config, voice = env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp / "never.wav"
    with pytest.raises(RuntimeError, match="No CUDA device"):
        pcli.main(["-q", "generate", "hello", "--config", str(config), "--voice", str(voice),
                   "--out", str(out)])
    assert not out.exists()

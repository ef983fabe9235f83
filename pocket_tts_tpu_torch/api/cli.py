"""Command-line interface: generate / serve / export-voice.
Port of pocket_tts_tpu/api/cli.py: the same subcommands, flags, defaults and
help, plus `--device`. The model runs on the CUDA card unless `--device cpu`
is given; without a card the command fails (load_model's error), it does not
carry on on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys

from pocket_tts_tpu_torch.default_parameters import (
    DEFAULT_EOS_THRESHOLD,
    DEFAULT_LSD_DECODE_STEPS,
    DEFAULT_NOISE_CLAMP,
    DEFAULT_TEMPERATURE,
    MAX_TOKEN_PER_CHUNK,
    get_default_text_for_language,
    get_default_voice_for_language,
)

logger = logging.getLogger(__name__)


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--language", default=None, help="language config name (e.g. english)")
    p.add_argument("--config", default=None, help="path to a custom YAML config")
    p.add_argument("--quantize", action="store_true", help="int8-quantize the FlowLM")
    p.add_argument("--quantize-config", default=None,
                   choices=["baseline", "attention", "ffn", "attention_ffn",
                            "flow_net", "all"],
                   help="layer groups to quantize (implies --quantize; "
                        "default attention_ffn, 'all' adds the flow head)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="weight dtype (bfloat16 recommended for serving)")
    p.add_argument("--allow-random-init", action="store_true",
                   help="build with random weights when checkpoints are unreachable")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")


def _add_sampling_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--temp", type=float, default=DEFAULT_TEMPERATURE)
    p.add_argument("--lsd-decode-steps", type=int, default=DEFAULT_LSD_DECODE_STEPS)
    p.add_argument("--noise-clamp", type=float, default=DEFAULT_NOISE_CLAMP)
    p.add_argument("--eos-threshold", type=float, default=DEFAULT_EOS_THRESHOLD)


def _load_model(args):
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    return TTSModel.load_model(
        language=args.language,
        config=args.config,
        temp=args.temp,
        lsd_decode_steps=args.lsd_decode_steps,
        noise_clamp=args.noise_clamp,
        eos_threshold=args.eos_threshold,
        quantize=args.quantize,
        quantize_config=args.quantize_config,
        allow_random_init=args.allow_random_init,
        param_dtype=args.dtype,
        device=args.device,
    )


def cmd_generate(args) -> int:
    from pocket_tts_tpu_torch.io.audio import stream_audio_chunks

    model = _load_model(args)
    text = args.text
    if text == "-":
        text = sys.stdin.read()
    if text is None:
        text = get_default_text_for_language(args.language)
    voice = args.voice or get_default_voice_for_language(args.language)

    state = model.get_state_for_audio_prompt(voice, truncate=True)
    chunks = model.generate_audio_stream(
        state, text, max_tokens=args.max_tokens,
        frames_after_eos=args.frames_after_eos, seed=args.seed,
    )
    out = args.out
    stream_audio_chunks(out, chunks, model.sample_rate)
    if out not in (None, "-"):
        logger.info("Wrote %s", out)
    return 0


def cmd_serve(args) -> int:
    from pocket_tts_tpu_torch.api.server import serve

    model = _load_model(args)
    serve(model, host=args.host, port=args.port,
          default_voice=args.voice or get_default_voice_for_language(args.language))
    return 0


def cmd_export_voice(args) -> int:
    model = _load_model(args)
    state = model.get_state_for_audio_prompt(args.audio, truncate=True)
    model.export_model_state(state, args.out)
    logger.info("Exported voice state to %s", args.out)
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pocket-tts-tpu-torch",
                                     description="Streaming TTS on PyTorch and CUDA")
    parser.add_argument("-q", "--quiet", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="generate speech for a text prompt")
    g.add_argument("text", nargs="?", default=None,
                   help="text to speak ('-' reads stdin; default: language sample)")
    g.add_argument("--voice", default=None,
                   help="catalog name, wav/mp3 path/url, or .safetensors voice state")
    g.add_argument("--out", default="output.wav", help="output wav ('-' for stdout)")
    g.add_argument("--max-tokens", type=int, default=MAX_TOKEN_PER_CHUNK)
    g.add_argument("--frames-after-eos", type=int, default=None)
    g.add_argument("--seed", type=int, default=None)
    _add_model_args(g)
    _add_sampling_args(g)
    g.set_defaults(func=cmd_generate)

    s = sub.add_parser("serve", help="run the streaming HTTP server")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--voice", default=None)
    _add_model_args(s)
    _add_sampling_args(s)
    s.set_defaults(func=cmd_serve)

    e = sub.add_parser("export-voice", help="precompute a voice state safetensors")
    e.add_argument("audio", help="voice audio file / url")
    e.add_argument("out", help="destination .safetensors")
    _add_model_args(e)
    _add_sampling_args(e)
    e.set_defaults(func=cmd_export_voice)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.ERROR if args.quiet else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())

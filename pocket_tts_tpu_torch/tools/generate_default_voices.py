"""Precompute voice-state safetensors for the whole voice catalog x configs.

The port of scripts/generate_default_voices.py: for each language config
(every YAML of the port's configs, or `--languages`), the model is loaded
with `TTSModel.load_model(language=...)` (on the CUDA card), each catalog
voice cloned with `get_state_for_audio_prompt(origin, truncate=True)` (the
Mimi encoder and voice-prompt graphs) and written with `export_model_state`
to <out>/<language>/embeddings/<name>.safetensors. An existing file is
skipped; a voice that cannot be cloned prints `skip` and leaves no file.

The catalog (`PREDEFINED_VOICE_ORIGINS`), the configs' directory and the
loader are module-level names, so a caller can point them at local files.
The catalog's origins are hf:// URLs and each config's weights_path too: a
run reads them through the hub (core/hub.py) and needs them cached or
reachable.

Usage: python -m pocket_tts_tpu_torch.tools.generate_default_voices [--out voices]
[--languages english ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from pocket_tts_tpu_torch.config import CONFIGS_DIR
from pocket_tts_tpu_torch.core.hub import PREDEFINED_VOICE_ORIGINS
from pocket_tts_tpu_torch.pipeline.tts import TTSModel


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="voices")
    parser.add_argument("--languages", nargs="*", default=None)
    args = parser.parse_args(argv)

    languages = args.languages or [p.stem for p in sorted(CONFIGS_DIR.glob("*.yaml"))]
    out_root = Path(args.out)
    for language in languages:
        model = TTSModel.load_model(language=language)
        lang_dir = out_root / language / "embeddings"
        lang_dir.mkdir(parents=True, exist_ok=True)
        for name, origin in PREDEFINED_VOICE_ORIGINS.items():
            dest = lang_dir / f"{name}.safetensors"
            if dest.exists():
                continue
            try:
                state = model.get_state_for_audio_prompt(origin, truncate=True)
            except Exception as e:  # noqa: BLE001 — report the voice and go on, as the script
                print(f"skip {language}/{name}: {e}")
                continue
            model.export_model_state(state, dest)
            print(f"wrote {dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

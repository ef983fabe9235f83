"""Artifact resolution: local paths, http(s) URLs, and hf:// references.
Port of pocket_tts_tpu/core/hub.py (the port keeps its own copy: the JAX
package's __init__ imports JAX).

Local paths pass through. http(s) files are cached by URL hash under
~/.cache/pocket_tts_tpu (the JAX package's cache directory, so both packages
share a download); hf://repo/path[@rev] goes through a lazily imported
huggingface_hub. Callers decide whether a resolution failure is fatal.
"""

from __future__ import annotations

import hashlib
import logging
from pathlib import Path

logger = logging.getLogger(__name__)


def cache_directory() -> Path:
    d = Path.home() / ".cache" / "pocket_tts_tpu"
    d.mkdir(parents=True, exist_ok=True)
    return d


def download_if_necessary(file_path: str | Path) -> Path:
    file_path = str(file_path)
    if file_path.startswith(("http://", "https://")):
        cached = cache_directory() / (
            hashlib.sha256(file_path.encode()).hexdigest() + "." + file_path.split(".")[-1]
        )
        if not cached.exists():
            import requests

            response = requests.get(file_path, timeout=60)
            response.raise_for_status()
            cached.write_bytes(response.content)
        return cached
    if file_path.startswith("hf://"):
        rest = file_path.removeprefix("hf://")
        parts = rest.split("/")
        repo_id = "/".join(parts[:2])
        filename = "/".join(parts[2:])
        revision = None
        if "@" in filename:
            filename, revision = filename.split("@")
        from huggingface_hub import hf_hub_download

        return Path(hf_hub_download(repo_id=repo_id, filename=filename, revision=revision))
    return Path(file_path)


# Named voice catalog (same voices/origins as the reference, utils/utils.py:15-46)
PREDEFINED_VOICE_ORIGINS = {
    "cosette": "hf://kyutai/tts-voices/expresso/ex04-ex02_confused_001_channel1_499s.wav",
    "marius": "hf://kyutai/tts-voices/voice-donations/Selfie.wav",
    "javert": "hf://kyutai/tts-voices/voice-donations/Butter.wav",
    "alba": "hf://kyutai/tts-voices/alba-mackenna/casual.wav",
    "jean": "hf://kyutai/tts-voices/ears/p010/freeform_speech_01_enhanced.wav",
    "anna": "hf://kyutai/tts-voices/vctk/p228_023_enhanced.wav",
    "vera": "hf://kyutai/tts-voices/vctk/p229_023_enhanced.wav",
    "fantine": "hf://kyutai/tts-voices/vctk/p244_023_enhanced.wav",
    "charles": "hf://kyutai/tts-voices/vctk/p254_023_enhanced.wav",
    "paul": "hf://kyutai/tts-voices/vctk/p259_023_enhanced.wav",
    "eponine": "hf://kyutai/tts-voices/vctk/p262_023_enhanced.wav",
    "azelma": "hf://kyutai/tts-voices/vctk/p303_023_enhanced.wav",
    "george": "hf://kyutai/tts-voices/vctk/p315_023_enhanced.wav",
    "mary": "hf://kyutai/tts-voices/vctk/p333_023_enhanced.wav",
    "jane": "hf://kyutai/tts-voices/vctk/p339_023_enhanced.wav",
    "michael": "hf://kyutai/tts-voices/vctk/p360_023_enhanced.wav",
    "eve": "hf://kyutai/tts-voices/vctk/p361_023_enhanced.wav",
    "bill_boerst": "hf://kyutai/tts-voices/voice-zero/bill_boerst.wav",
    "peter_yearsley": "hf://kyutai/tts-voices/voice-zero/peter_yearsley.wav",
    "stuart_bell": "hf://kyutai/tts-voices/voice-zero/stuart_bell.wav",
    "caro_davy": "hf://kyutai/tts-voices/voice-zero/caro_davy.wav",
    "giovanni": "hf://kyutai/pocket-tts/common_voice_it_36520747-enhanced-v2.mp3@64ab7d24c479d736a83b8cc666c4a776fca30fda",
    "lola": "hf://kyutai/pocket-tts/common_voice_es_19762977-enhanced-v2.mp3@64ab7d24c479d736a83b8cc666c4a776fca30fda",
    "juergen": "hf://kyutai/pocket-tts/de-DE-juergen.mp3@64ab7d24c479d736a83b8cc666c4a776fca30fda",
    "rafael": "hf://kyutai/pocket-tts/g-Vi8PgmSY0-enhanced-v2.wav@64ab7d24c479d736a83b8cc666c4a776fca30fda",
    "estelle": "hf://kyutai/tts-voices/unmute-prod-website/developpeuse-3.wav@1fc7395b7e012e2bbebfca14b942a4ef62ccc899",
}

_PRECOMPUTED_EMBEDDINGS_REV = "e041936c75475d350b405bc870bcf7c22da4e9e6"


def get_predefined_voice(language: str, name: str) -> str:
    """hf:// address of the precomputed per-language voice embedding."""
    return (
        f"hf://kyutai/pocket-tts-without-voice-cloning/languages/{language}/"
        f"embeddings/{name}.safetensors@{_PRECOMPUTED_EMBEDDINGS_REV}"
    )

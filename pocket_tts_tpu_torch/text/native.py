"""ctypes binding for the repo's native C++ tokenizer (native/sp_tokenizer.cpp).
Port of pocket_tts_tpu/text/native.py.

Loads native/libsptok.so beside the package (built with `make -C native`),
at first use; `best_tokenizer` falls back to the pure-Python
text/sentencepiece.SentencePieceTokenizer when the library is absent or does
not load on this machine. Interface matches SentencePieceTokenizer. A host
tokenizer: no device or kernel path.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from pathlib import Path

logger = logging.getLogger(__name__)

LIB_PATH = Path(__file__).resolve().parent.parent.parent / "native" / "libsptok.so"


@functools.cache
def _lib() -> ctypes.CDLL | None:
    if not LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError as e:  # built for another machine
        logger.info("native tokenizer %s does not load (%s)", LIB_PATH, e)
        return None
    lib.sp_load.restype = ctypes.c_void_p
    lib.sp_load.argtypes = [ctypes.c_char_p]
    lib.sp_vocab_size.restype = ctypes.c_int
    lib.sp_vocab_size.argtypes = [ctypes.c_void_p]
    lib.sp_encode.restype = ctypes.c_int
    lib.sp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.sp_decode.restype = ctypes.c_int
    lib.sp_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.sp_free.restype = None
    lib.sp_free.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return _lib() is not None


class NativeSentencePieceTokenizer:
    """Native-backed tokenizer; raises RuntimeError if the library is absent."""

    def __init__(self, n_bins: int, model_path: str | Path):
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"native tokenizer library not loadable: {LIB_PATH} "
                               "(make -C native)")
        self._lib = lib
        self._model = lib.sp_load(str(model_path).encode())
        if not self._model:
            raise ValueError(f"failed to load sentencepiece model: {model_path}")
        vocab = lib.sp_vocab_size(self._model)
        if vocab != n_bins:
            raise ValueError(f"tokenizer has vocab size={vocab} but n_bins={n_bins}")

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        buf_len = max(4 * len(text) + 16, 256)
        buf = (ctypes.c_int * buf_len)()
        n = self._lib.sp_encode(self._model, data, buf, buf_len)
        if n > buf_len:  # extremely long input: retry with the exact size
            buf = (ctypes.c_int * n)()
            n = self._lib.sp_encode(self._model, data, buf, n)
        return list(buf[:n])

    def decode(self, ids: list[int]) -> str:
        arr = (ctypes.c_int * len(ids))(*ids)
        buf_len = 16 * len(ids) + 16
        buf = ctypes.create_string_buffer(buf_len)
        n = self._lib.sp_decode(self._model, arr, len(ids), buf, buf_len)
        return buf.raw[: min(n, buf_len)].decode("utf-8", "replace")

    def __del__(self):
        if getattr(self, "_model", None):
            self._lib.sp_free(self._model)
            self._model = None


def best_tokenizer(n_bins: int, model_path):
    """Native when it loads, pure-Python otherwise."""
    if native_available():
        try:
            return NativeSentencePieceTokenizer(n_bins, model_path)
        except (ValueError, RuntimeError):
            pass
    from pocket_tts_tpu_torch.text.sentencepiece import SentencePieceTokenizer

    return SentencePieceTokenizer(n_bins, model_path)

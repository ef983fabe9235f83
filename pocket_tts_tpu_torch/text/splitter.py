"""Text preparation and sentence-split chunking — the infinite-text mechanism.

Behavior-equivalent to the reference host logic (models/tts_model.py:913-1044):
text is normalized, split at sentence boundaries (runs of .!?… tokens), oversized
sentences are re-split on ,;: fallbacks, and segments are greedily re-packed into
chunks of at most `max_tokens` tokens. Each chunk is generated independently
against a copy of the voice state, which bounds KV-cache growth structurally —
the port clones the voice state at chunk start for the same reason.

A copy of pocket_tts_tpu/text/splitter.py; tests hold the two to the same splits.

The tokenizer here is any object with `encode(str) -> list[int]` and
`decode(list[int]) -> str`.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def prepare_text_prompt(
    text: str, pad_with_spaces_for_short_inputs: bool, remove_semicolons: bool
) -> tuple[str, int]:
    """Normalize a prompt; returns (text, frames_after_eos_guess)."""
    text = text.strip()
    if text == "":
        raise ValueError("Text prompt cannot be empty")
    text = text.replace("\n", " ").replace("\r", " ").replace("  ", " ")
    if remove_semicolons:
        text = text.replace(";", ",")
    frames_after_eos_guess = 3 if len(text.split()) <= 4 else 1
    if not text[0].isupper():
        text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text = text + "."
    if pad_with_spaces_for_short_inputs and len(text.split()) < 5:
        text = " " * 8 + text
    return text, frames_after_eos_guess


def _boundary_indices(tokens: list[int], boundary_tokens: list[int]) -> list[int]:
    """Split positions: index after each maximal run of boundary tokens."""
    indices = [0]
    in_run = False
    for idx, token in enumerate(tokens):
        if token in boundary_tokens:
            in_run = True
        else:
            if in_run:
                indices.append(idx)
            in_run = False
    indices.append(len(tokens))
    return indices


def _segments(tokens: list[int], boundaries: list[int], tokenizer) -> list[tuple[int, str]]:
    return [
        (end - start, tokenizer.decode(tokens[start:end]))
        for start, end in zip(boundaries, boundaries[1:])
    ]


def split_into_best_sentences(
    tokenizer,
    text_to_generate: str,
    max_tokens: int,
    pad_with_spaces_for_short_inputs: bool,
    remove_semicolons: bool,
) -> list[str]:
    text, _ = prepare_text_prompt(
        text_to_generate, pad_with_spaces_for_short_inputs, remove_semicolons
    )
    text = text.strip()
    tokens = tokenizer.encode(text)

    # drop the leading dummy-prefix token the tokenizer emits for the probe string
    eos_boundary_tokens = tokenizer.encode(".!...?")[1:]
    segments = _segments(tokens, _boundary_indices(tokens, eos_boundary_tokens), tokenizer)

    # re-split oversized sentences on , ; : so long sentences don't blow the budget
    fallback_tokens = tokenizer.encode(",;:")[1:]
    refined: list[tuple[int, str]] = []
    for nb, seg_text in segments:
        if nb <= max_tokens:
            refined.append((nb, seg_text))
            continue
        sub_tokens = tokenizer.encode(seg_text.strip())
        subs = _segments(sub_tokens, _boundary_indices(sub_tokens, fallback_tokens), tokenizer)
        if len(subs) > 1:
            refined.extend(subs)
        else:
            refined.append((nb, seg_text))

    # greedy repack into chunks of <= max_tokens
    chunks: list[str] = []
    current, current_nb = "", 0
    for nb, sentence in refined:
        if current == "":
            current, current_nb = sentence, nb
        elif current_nb + nb > max_tokens:
            chunks.append(current.strip())
            current, current_nb = sentence, nb
        else:
            current += " " + sentence
            current_nb += nb
    if current != "":
        chunks.append(current.strip())

    for chunk in chunks:
        n = len(tokenizer.encode(chunk.strip()))
        if n > max_tokens:
            logger.warning(
                "Chunk has %d tokens (max %d), generation may skip words: '%.50s...'",
                n, max_tokens, chunk,
            )
    return chunks

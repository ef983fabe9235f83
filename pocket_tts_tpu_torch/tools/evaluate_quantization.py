"""Quantization sweep: int8 configurations x synthetic voices on the card.
Port of scripts/evaluate_quantization.py, with its own copies of the metric
functions (no JAX, nothing of the JAX package).

For each of the five configurations (CONFIGS: f32, then the int8 groups)
and each synthetic voice it generates one b1 utterance and measures
  - speed: RTS = generated audio seconds / wall-clock seconds;
  - quality against the f32 run on the same voice and noise stream: SNR,
    the frequency-weighted segmental SNR (always computed), wideband PESQ
    and Whisper word-error rates (baseline and quantized);
  - memory: the weights' MB per configuration and the device's allocated
    MB (None on the CPU);
then writes PREFIX.csv (one row per configuration and voice),
PREFIX_summary.csv (one per configuration) and PREFIX.md, in the JAX
script's columns and row order. PESQ and WER are import-guarded: without
the `pesq`, `jiwer` or `whisper` packages their columns read "n/a" and the
sweep completes.

With --random-init the model may run on random weights (when the config
names no readable checkpoint) and every voice reads 20 random token ids from
the seeded numpy generator in place of a sentence, as the JAX script draws
them; SNR then still measures the quantization error of the same
computation. PESQ and WER need real weights and the optional packages.

Usage:
  python -m pocket_tts_tpu_torch.tools.evaluate_quantization \
      [--language english | --config my.yaml] [--random-init] [--voices 4] \
      [--out quantization_report] [--seed 0] [--whisper-model base] \
      [--skip-wer] [--device cpu]
The model runs on the CUDA card unless --device cpu is given; without a
card and without --device cpu it fails.
"""

from __future__ import annotations

import argparse
import csv
import statistics
import time
from pathlib import Path

import numpy as np


def compute_snr(reference: np.ndarray, test: np.ndarray) -> float:
    n = min(len(reference), len(test))
    if n == 0:
        return float("nan")
    ref, t = reference[:n], test[:n]
    noise = ref - t
    p_sig = float(np.mean(ref**2))
    p_noise = float(np.mean(noise**2))
    if p_noise == 0:
        return float("inf")
    return 10.0 * np.log10(p_sig / max(p_noise, 1e-12))


def compute_fwsnrseg(reference: np.ndarray, test: np.ndarray,
                     sample_rate: int, n_bands: int = 23) -> float:
    """Frequency-weighted segmental SNR (Hu & Loizou 2008): the perceptual
    proxy that always runs offline, reported beside (never instead of) real
    PESQ. Frames of 25 ms / 10 ms hop; per-frame mel-band SNRs weighted
    by band energy^0.2, clipped to [-10, 35] dB, averaged."""
    n = min(len(reference), len(test))
    if n == 0:
        return float("nan")
    ref, t = reference[:n].astype(np.float64), test[:n].astype(np.float64)
    frame, hop = int(0.025 * sample_rate), int(0.010 * sample_rate)
    if n < frame:
        return float("nan")
    nfft = 1 << (frame - 1).bit_length()
    # mel filterbank up to Nyquist
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = mel_to_hz(np.linspace(0.0, hz_to_mel(sample_rate / 2), n_bands + 2))
    bins = np.floor((nfft + 1) * mel_pts / sample_rate).astype(int)
    fb = np.zeros((n_bands, nfft // 2 + 1))
    for b in range(n_bands):
        lo, mid, hi = bins[b], bins[b + 1], bins[b + 2]
        if mid > lo:
            fb[b, lo:mid] = (np.arange(lo, mid) - lo) / max(mid - lo, 1)
        if hi > mid:
            fb[b, mid:hi] = (hi - np.arange(mid, hi)) / max(hi - mid, 1)
    win = np.hanning(frame)
    scores = []
    for start in range(0, n - frame + 1, hop):
        rf = ref[start:start + frame] * win
        tf = t[start:start + frame] * win
        rs = np.abs(np.fft.rfft(rf, nfft)) ** 2
        es = np.abs(np.fft.rfft(rf - tf, nfft)) ** 2
        rb = fb @ rs + 1e-12
        eb = fb @ es + 1e-12
        snr = np.clip(10.0 * np.log10(rb / eb), -10.0, 35.0)
        w = rb ** 0.2
        scores.append(float(np.sum(w * snr) / np.sum(w)))
    return float(np.mean(scores)) if scores else float("nan")


def compute_pesq(baseline: np.ndarray, test: np.ndarray,
                 sample_rate: int) -> float | None:
    """Wideband PESQ of quantized vs baseline audio. None when the `pesq`
    package is absent (an optional dependency)."""
    try:
        from pesq import pesq  # noqa: PLC0415
    except ImportError:
        return None
    import scipy.signal

    target_sr = 16000  # wideband PESQ operates at 16 kHz
    n = min(len(baseline), len(test))
    if n == 0:
        return None
    b, t = baseline[:n], test[:n]
    if sample_rate != target_sr:
        from math import gcd

        g = gcd(target_sr, sample_rate)
        b = scipy.signal.resample_poly(b, target_sr // g, sample_rate // g)
        t = scipy.signal.resample_poly(t, target_sr // g, sample_rate // g)
    try:
        return float(pesq(target_sr, b, t, "wb"))
    except Exception:
        return None


class WhisperASR:
    """Lazy Whisper transcriber for WER measurement. Construction returns a
    no-op shell when whisper or jiwer is unavailable."""

    def __init__(self, model_name: str = "base"):
        self.model = None
        self.wer = None
        try:
            import whisper  # noqa: PLC0415
            from jiwer import wer  # noqa: PLC0415
        except ImportError:
            return
        self.model = whisper.load_model(model_name)
        self.wer = wer

    @property
    def available(self) -> bool:
        return self.model is not None

    def word_error_rate(self, audio: np.ndarray, sample_rate: int,
                        reference_text: str) -> float | None:
        if not self.available:
            return None
        import tempfile
        import wave

        with tempfile.NamedTemporaryFile(suffix=".wav") as tmp:
            pcm = np.clip(audio, -1.0, 1.0)
            with wave.open(tmp.name, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sample_rate)
                w.writeframes((pcm * 32767).astype(np.int16).tobytes())
            transcript = self.model.transcribe(tmp.name, language="en")["text"]
        return float(self.wer(reference_text.lower().strip(),
                              transcript.lower().strip()))


CONFIGS = [
    ("f32", frozenset()),
    ("int8_attention", frozenset({"attention"})),
    ("int8_ffn", frozenset({"ffn"})),
    ("int8_attention_ffn", frozenset({"attention", "ffn"})),
    ("int8_all", frozenset({"attention", "ffn", "flow_net"})),
]

# diverse sentences exercising phoneme coverage, used for WER stress when real
# weights and whisper are available
WER_SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "She sells seashells by the seashore on sunny days.",
    "A journey of a thousand miles begins with a single step.",
    "The weather forecast predicts heavy rain this weekend.",
]


def fmt(v) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, float):
        return f"{v:.3f}" if np.isfinite(v) else "inf"
    return str(v)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pocket_tts_tpu_torch.tools.evaluate_quantization")
    parser.add_argument("--language", default="english")
    parser.add_argument("--config", default=None,
                        help="custom YAML config (overrides --language)")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--voices", type=int, default=4, help="number of synthetic voices")
    parser.add_argument("--out", default="quantization_report")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--whisper-model", default="base")
    parser.add_argument("--skip-wer", action="store_true")
    parser.add_argument("--device", default=None,
                        help="the device to run on: the CUDA card unless 'cpu'")
    args = parser.parse_args(argv)

    from pocket_tts_tpu_torch.pipeline.tts import NoiseSource, TTSModel
    from pocket_tts_tpu_torch.quant import (
        device_memory_mb,
        model_memory_mb,
        quantize_flow_lm_int8,
    )

    model = TTSModel.load_model(
        language=None if args.config else args.language, config=args.config,
        allow_random_init=args.random_init, device=args.device)
    f32_params = model.params
    asr = WhisperASR(args.whisper_model) if not args.skip_wer else None
    if asr is not None and not asr.available:
        print("whisper/jiwer not installed — WER columns will be n/a")
        asr = None

    rng = np.random.default_rng(args.seed)
    voices = [
        model.state_for_audio_array(
            (rng.standard_normal((1, 1, 24000 * 3)) * 0.1).astype(np.float32)
        )
        for _ in range(args.voices)
    ]
    if args.random_init:
        # random tokenizer-free runs: fixed token ids stand in for sentences
        token_sets = [[int(t) for t in rng.integers(1, 100, size=20)]
                      for _ in range(args.voices)]
        sentences = [None] * args.voices
    else:
        sentences = [WER_SENTENCES[i % len(WER_SENTENCES)] for i in range(args.voices)]
        token_sets = [model._encode_text(s) for s in sentences]

    rows = []
    baselines: dict[int, np.ndarray] = {}
    wer_baseline: dict[int, float | None] = {}
    for name, qconfig in CONFIGS:
        model.params = (
            quantize_flow_lm_int8(f32_params, qconfig) if qconfig else f32_params
        )
        # memory columns: the weights' bytes per configuration, and what the
        # card's allocator holds (None on the CPU)
        weights_mb = model_memory_mb(model.params, model.mimi_params)
        hbm_mb = device_memory_mb(model.device)
        for v, (state, tokens) in enumerate(zip(voices, token_sets)):
            noise = NoiseSource(model.gen, seed=1000 + v)
            t0 = time.monotonic()
            audio = np.concatenate(
                list(
                    model.generate_audio_stream_from_tokens(state, tokens, 2, noise)
                )
                or [np.zeros(1, np.float32)]
            )
            wall = time.monotonic() - t0
            rts = (len(audio) / model.sample_rate) / max(wall, 1e-9)
            pesq_score = fwsnrseg = None
            wer_b = wer_q = None
            if name == "f32":
                baselines[v] = audio
                snr = float("inf")
                if asr is not None and sentences[v]:
                    wer_b = asr.word_error_rate(audio, model.sample_rate, sentences[v])
                wer_baseline[v] = wer_b
            else:
                snr = compute_snr(baselines[v], audio)
                pesq_score = compute_pesq(baselines[v], audio, model.sample_rate)
                fwsnrseg = compute_fwsnrseg(baselines[v], audio, model.sample_rate)
                wer_b = wer_baseline.get(v)
                if asr is not None and sentences[v]:
                    wer_q = asr.word_error_rate(audio, model.sample_rate, sentences[v])
            rows.append({
                "config": name, "voice": v, "rts": round(rts, 2),
                "snr_db": round(snr, 2) if np.isfinite(snr) else "inf",
                "pesq": None if pesq_score is None else round(pesq_score, 3),
                "fwsnrseg_db": (None if fwsnrseg is None or not np.isfinite(fwsnrseg)
                                else round(fwsnrseg, 2)),
                "wer_baseline": wer_b, "wer_quantized": wer_q,
                "audio_s": round(len(audio) / model.sample_rate, 2),
                "weights_mb": round(weights_mb, 1),
                "hbm_mb": None if hbm_mb is None else round(hbm_mb, 1),
            })
            print(rows[-1])
    model.params = f32_params

    # per-config summary: mean RTS, SNR, PESQ and WER delta
    summaries = []
    for name, _ in CONFIGS:
        sub = [r for r in rows if r["config"] == name]
        snrs = [r["snr_db"] for r in sub if isinstance(r["snr_db"], (int, float))]
        pesqs = [r["pesq"] for r in sub if r["pesq"] is not None]
        deltas = [r["wer_quantized"] - r["wer_baseline"] for r in sub
                  if r["wer_quantized"] is not None and r["wer_baseline"] is not None]
        summaries.append({
            "config": name,
            "mean_rts": round(statistics.mean(r["rts"] for r in sub), 2),
            "mean_snr_db": round(statistics.mean(snrs), 2) if snrs else None,
            "mean_pesq": round(statistics.mean(pesqs), 3) if pesqs else None,
            "mean_wer_delta": round(statistics.mean(deltas), 4) if deltas else None,
            "weights_mb": sub[0]["weights_mb"] if sub else None,
        })
        print(summaries[-1])

    out = Path(args.out)
    with open(out.with_suffix(".csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    with open(str(out) + "_summary.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(summaries[0]))
        writer.writeheader()
        writer.writerows(summaries)
    with open(out.with_suffix(".md"), "w") as f:
        f.write("# Quantization evaluation\n\n")
        f.write("| config | voice | RTS | SNR (dB) | PESQ | WER base | WER quant "
                "| audio (s) |\n|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['config']} | {r['voice']} | {r['rts']} | {r['snr_db']} "
                    f"| {fmt(r['pesq'])} | {fmt(r['wer_baseline'])} "
                    f"| {fmt(r['wer_quantized'])} | {r['audio_s']} |\n")
        f.write("\n## Summary\n\n")
        f.write("| config | mean RTS | mean SNR (dB) | mean PESQ | mean WER delta "
                "| weights (MB) |\n|---|---|---|---|---|---|\n")
        for s in summaries:
            f.write(f"| {s['config']} | {s['mean_rts']} | {fmt(s['mean_snr_db'])} "
                    f"| {fmt(s['mean_pesq'])} | {fmt(s['mean_wer_delta'])} "
                    f"| {fmt(s['weights_mb'])} |\n")
    print(f"wrote {out.with_suffix('.csv')}, {out}_summary.csv and "
          f"{out.with_suffix('.md')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

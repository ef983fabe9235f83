"""The port's quantization sweep (pocket_tts_tpu_torch.tools.evaluate_quantization)
against the JAX package's script (scripts/evaluate_quantization.py, loaded by
file as tests/test_eval_metrics.py loads it), CPU.

The metric functions are pure numpy copies: equal on seeded inputs. The two
sweeps run on one small checkpoint (torch_port.write_small_port_checkpoint:
the same weights on both sides) with --random-init --voices 1 --skip-wer:
the same CSV columns, rows and order, the same markdown rows, and SNR
within 0.1 dB (the quantized runs' error against each side's own f32 run;
the f32 paths agree at 1e-3)."""

import csv
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from pocket_tts_tpu_torch.tools import evaluate_quantization as pq
from torch_port import write_small_config, write_small_port_checkpoint

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location(
    "evalq_jax", REPO / "scripts" / "evaluate_quantization.py")
jq = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jq)

SR = 24000
SNR_DB = 0.1


def _signals(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    x = sum(np.sin(2 * np.pi * f * t) / (i + 1) for i, f in enumerate((220, 880, 3500)))
    x = (x * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    return x, (x + 0.05 * rng.standard_normal(x.size)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metric_copies_equal_the_scripts(seed):
    ref, test = _signals(seed)
    short = test[: SR // 3 + seed * 17]
    for a, b in ((ref, test), (ref, short), (ref, ref), (ref, ref[:100])):
        assert pq.compute_snr(a, b) == jq.compute_snr(a, b)
        np.testing.assert_array_equal(pq.compute_fwsnrseg(a, b, SR),
                                      jq.compute_fwsnrseg(a, b, SR))
    assert pq.compute_pesq(ref, test, SR) == jq.compute_pesq(ref, test, SR)
    assert [pq.fmt(v) for v in (None, 1.23456, float("inf"), 3)] == [
        jq.fmt(v) for v in (None, 1.23456, float("inf"), 3)]
    assert pq.CONFIGS == jq.CONFIGS and pq.WER_SENTENCES == jq.WER_SENTENCES


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evalq")
    ckpt, tok = write_small_port_checkpoint(tmp, seed=12)
    config = write_small_config(tmp, "evalq", tok, weights_path=ckpt)
    common = ["--config", str(config), "--random-init", "--voices", "1", "--skip-wer"]
    assert pq.main([*common, "--device", "cpu", "--out", str(tmp / "port")]) == 0
    argv = sys.argv
    sys.argv = ["evaluate_quantization.py", *common, "--out", str(tmp / "jax")]
    try:
        assert jq.main() == 0
    finally:
        sys.argv = argv
    return tmp


def test_sweep_schema_and_snr_match_the_script(sweeps):
    """Both sweeps' CSVs: the same columns and (config, voice) rows in the
    same order; SNR within 0.1 dB; the same audio lengths; PESQ n/a (absent)
    or equal; the markdown tables' rows in one order (their first column:
    the timings differ)."""
    for suffix in (".csv", "_summary.csv"):
        port, jax = (_read(str(sweeps / side) + suffix) for side in ("port", "jax"))
        assert list(port[0]) == list(jax[0])
        assert [r["config"] for r in port] == [r["config"] for r in jax] == [
            c for c, _ in pq.CONFIGS]
    port, jax = _read(sweeps / "port.csv"), _read(sweeps / "jax.csv")
    for p, j in zip(port, jax):
        assert p["voice"] == j["voice"] and p["audio_s"] == j["audio_s"], (p, j)
        assert (p["pesq"], p["wer_baseline"], p["wer_quantized"]) == (
            j["pesq"], j["wer_baseline"], j["wer_quantized"])
        if p["snr_db"] == "inf" or j["snr_db"] == "inf":
            assert p["snr_db"] == j["snr_db"], (p, j)
        else:
            assert abs(float(p["snr_db"]) - float(j["snr_db"])) <= SNR_DB, (p, j)
    md = [(sweeps / f"{side}.md").read_text().splitlines() for side in ("port", "jax")]
    assert [ln.split("|")[1] for ln in md[0] if ln.startswith("| ")] == [
        ln.split("|")[1] for ln in md[1] if ln.startswith("| ")]

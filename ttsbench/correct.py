"""Whether what the timed path produced is correct.

A seeded sample of the window's finished requests (rows of a job count
one by one), with the longest among them: `Keeper` holds a reservoir of
`k` in each stratum an entry names (a job's two halves of rows) and the
longest as they finish. Once the window has closed and the program's
state is freed, the plain float32 reference (reference/model.py) decodes
each sampled request again from the same inputs: the voice's wav (cloned
by the reference itself), the token ids, the frame count, the weights
regenerated from the run's seed, and the flow noise. The program draws
that noise on the device from the request's seed, as a server does:
N(0, temp), one (K, rows, ldim) draw of a generator seeded with it per
block of K frames, in the block sizes of `counts.blocks`. The reference
draws it again the same way (`flow_noise`), with torch's generator on the
same device.

Numbers, each compared where the cell's file (cells/<cell>.json) gives it
a limit:
- `frame_err_max`: over the sampled requests and their frames, the widest
  |served - reference| of a frame (its L2 norm) over the request's RMS
  frame norm in the reference;
- `audio_err_max`: over the sampled requests, |served - reference| of the
  whole request over |reference| (L2 norms): steadier from seed to seed
  than the widest frame, which one frame's rounding can set;
- `frames_off`: requests (rows of a job count one by one) of the window
  whose served frames differ from the frames the benchmark asked for or,
  for a job, expects by the published length rule (exact: limit 0; the
  result line counts them as failed). With EOS off this holds the EOS
  head's decision (no stop before the length); its logit is not compared.

The control (`precision` other than float32) puts the reference, computed
at that precision, in the program's place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ttsbench.counts import blocks
from ttsbench.reference.audio import read_wav
from ttsbench.reference.model import Reference
from ttsbench.weights import make_state_dict, views


class Keeper:
    """A seeded reservoir of `k` finished requests in each stratum, and the
    longest."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng([int(seed), 4])
        self.k = k
        self.n: dict[int, int] = {}
        self.sample: dict[int, list[dict]] = {}
        self.longest: dict | None = None

    def offer(self, item: dict, stratum: int = 0) -> None:
        """item: voice (wav bytes), tokens, seed (of its noise), rows and row
        (its row of the draw), frames, audio (the served samples)."""
        if self.longest is None or item["frames"] > self.longest["frames"]:
            self.longest = item
        n = self.n[stratum] = self.n.get(stratum, 0) + 1
        sample = self.sample.setdefault(stratum, [])
        if len(sample) < self.k:
            sample.append(item)
        else:
            j = int(self.rng.integers(n))
            if j < self.k:
                sample[j] = item

    def items(self) -> list[dict]:
        out = [it for _, sample in sorted(self.sample.items()) for it in sample]
        if self.longest is not None and not any(it is self.longest for it in out):
            out.append(self.longest)
        return out


def flow_noise(item: dict, ldim: int, temp: float, device) -> torch.Tensor:
    """The flow noise of `item`'s frames [frames, ldim], drawn as the program
    draws it from the request's seed: a generator seeded with it, then per
    block of K frames N(0, 1) of shape (K, rows, ldim) times sqrt(temp)."""
    g = torch.Generator(device=device)
    g.manual_seed(item["seed"])
    draws = [torch.randn((k, item["rows"], ldim), generator=g, device=device)
             for k in blocks(item["frames"])]
    return (torch.cat(draws)[:item["frames"], item["row"]] * temp ** 0.5)


MISMATCH = 1e30  # a served length other than the reference's (JSON has no inf)


def frame_err(served: np.ndarray, ref: np.ndarray, frame: int) -> float:
    n = min(len(served), len(ref)) // frame
    if n == 0 or len(served) != len(ref):
        return MISMATCH
    d = np.linalg.norm((served[:n * frame] - ref[:n * frame]).reshape(n, frame), axis=1)
    rms = float(np.sqrt(np.mean(np.square(ref[:n * frame].reshape(n, frame)).sum(axis=1))))
    return float(d.max() / max(rms, 1e-30))


def audio_err(served: np.ndarray, ref: np.ndarray) -> float:
    if len(served) != len(ref) or len(ref) == 0:
        return MISMATCH
    return float(np.linalg.norm(served - ref) / max(np.linalg.norm(ref), 1e-30))


def check(run, precision: str = "float32") -> tuple[dict, bool]:
    """(compared numbers with their limits, whether all hold)."""
    cfg, limits = run.cfg, run.spec["limits"]
    dev = run.device
    t0 = time.perf_counter()
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        flat, layout = make_state_dict(cfg, run.seed, dev, getattr(torch, cfg["dtype"]),
                                       cfg["init"])
        sd = views(flat, layout)
        ref = Reference(cfg, sd)
        low = Reference(cfg, sd, precision) if precision != "float32" else None
        rate = cfg["mimi"]["sample_rate"]
        frame = int(rate / cfg["mimi"]["frame_rate"])
        conds: dict = {}
        worst = {"frame_err_max": 0.0, "audio_err_max": 0.0}
        frames = 0
        ldim = cfg["mimi"]["quantizer"]["dimension"]
        run.item_errors = []
        with torch.no_grad():
            for item in run.keeper.items():
                key = id(item["voice"])
                if key not in conds:
                    wav = torch.from_numpy(read_wav(item["voice"], rate)).to(dev)
                    conds[key] = (ref.voice_conditioning(wav),
                                  None if low is None else low.voice_conditioning(wav))
                noise = flow_noise(item, ldim, run.gen["temp"], dev)
                audio = ref.generate(conds[key][0], item["tokens"], noise, item["frames"],
                                     run.gen["lsd_decode_steps"])
                served = item["audio"]
                if low is not None:
                    served = low.generate(conds[key][1], item["tokens"], noise, item["frames"],
                                          run.gen["lsd_decode_steps"]).cpu().numpy()
                ref_audio = audio.cpu().numpy()
                errs = {"frame_err_max": frame_err(served, ref_audio, frame),
                        "audio_err_max": audio_err(served, ref_audio)}
                run.item_errors.append((item["frames"], errs["frame_err_max"],
                                        errs["audio_err_max"]))
                worst = {k: max(v, errs[k]) for k, v in worst.items()}
                frames += item["frames"]
        del flat, sd
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    off = sum(1 for r in run.records for row in r.rows if row["frames"] != row["requested"])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in worst.items() if k in limits}
    checks["frames_off"] = {"value": off, "limit": 0}
    run.reference_s = time.perf_counter() - t0
    run.reference_frames = frames
    run.worst = worst
    ok = all(c["value"] <= c["limit"] for c in checks.values()) and frames > 0
    return checks, ok

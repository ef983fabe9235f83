"""Multi-process data-parallel serving driver.
Port of pocket_tts_tpu/parallel/launch.py.

N coordinated processes (one per device) serve ONE utterance batch:

  1. every process joins the job's `torch.distributed` group
     (multihost.initialize_multihost: NCCL on cuda:{rank % device count},
     or gloo on the CPU with --cpu);
  2. process 0 owns the utterance batch and broadcasts it;
  3. each process decodes its contiguous slice of rows on its device (no
     collective in the decode loop: the model is not sharded, each process
     holds all of it);
  4. the audio is all-gathered to every process, and process 0 reports;
  5. a heartbeat over the mesh (multihost.assert_mesh_healthy) checks every
     process before and after the batch.

Row-level recovery: with --results-dir every decoded global row is saved as
row_{g}.npy; a relaunch after a worker failure loads the saved rows and
decodes only the missing ones (per-global-row noise streams make a saved row
and a re-decoded one equal). The spawning mode supervises the workers: the
moment one dies it ends the others, which would wait in a collective, and
relaunches the job up to --retries times.

Run as a module:

  # one worker per process of a job (the coordinator is process 0's host:port):
  python -m pocket_tts_tpu_torch.parallel.launch --worker --processes 2 \\
      --process-id 0 --coordinator host:port --language english ...

  # spawn N local workers, one per card (cuda:{rank % device count}):
  python -m pocket_tts_tpu_torch.parallel.launch --processes 2 --utterances 4 ...

  # bring-up and tests: N gloo workers on the CPU with the toy model
  python -m pocket_tts_tpu_torch.parallel.launch --processes 2 --cpu --tiny

Differences from the JAX driver: `global_devices` is the number of
processes (one device each; the JAX driver counts processes x virtual
devices), `--cpu` takes no device count, and `--tiny` uses the port's own
seeded random init, whose bits differ from the JAX package's PRNGKey(0).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

MULTIHOST_TAG = "MULTIHOST_RESULT "
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tiny_config():
    """Flagship-shaped model at toy dims (as the JAX driver's)."""
    from pocket_tts_tpu_torch.config import CONFIGS_DIR, Config, load_config

    d = load_config(CONFIGS_DIR / "english.yaml").model_dump()
    d["flow_lm"]["transformer"].update(d_model=64, num_heads=4, num_layers=2,
                                       hidden_scale=2)
    d["flow_lm"]["flow"].update(dim=48, depth=2)
    d["flow_lm"]["lookup_table"].update(n_bins=31)
    d["mimi"]["seanet"].update(dimension=64, n_filters=8)
    d["mimi"]["transformer"].update(d_model=64, num_heads=4, dim_feedforward=128,
                                    input_dimension=64, output_dimensions=(64,),
                                    context=30)
    d["mimi"]["quantizer"].update(dimension=8, output_dimension=64)
    d["mimi"]["inner_dim"] = 8
    d["mimi"]["outer_dim"] = 64
    d["weights_path"] = None
    return Config(**d)


def _build_model(args, device):
    import torch

    from pocket_tts_tpu_torch.pipeline.tts import GenerationParams, TTSModel

    if args.tiny:
        from pocket_tts_tpu_torch.models.flow_lm import build_flow_lm_specs, init_flow_lm_params
        from pocket_tts_tpu_torch.models.mimi import build_mimi_specs, init_mimi_params

        cfg = _tiny_config()
        specs = build_flow_lm_specs(cfg)
        mimi_specs = build_mimi_specs(cfg.mimi)
        g = torch.Generator(device=device).manual_seed(0)
        params = init_flow_lm_params(specs, g, torch.float32, device)
        mimi_params = init_mimi_params(mimi_specs, g, torch.float32, device)
        return TTSModel(specs, mimi_specs, params, mimi_params, tokenizer=None, config=cfg,
                        gen_params=GenerationParams(), device=device)
    return TTSModel.load_model(language=args.language, config=args.config,
                               allow_random_init=args.allow_random_init,
                               param_dtype=args.dtype, device=device)


def _worker_device(args):
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device found; pass --cpu for gloo workers on the CPU")
    rank = args.process_id if args.process_id is not None else int(os.environ.get("RANK", 0))
    return torch.device("cuda", rank % torch.cuda.device_count())


def run_worker(args) -> dict:
    """One process of the DP serving job. Returns the report dict (the same
    on every process; only process 0 prints it)."""

    # fault injection for the recovery tests: worker 1 dies once, leaving a
    # marker so the retry attempt proceeds. fail_point "init" dies before
    # joining the job; "after_decode" dies after every worker has decoded AND
    # saved its rows (after the barrier), deleting its own saved rows first,
    # so that the relaunch re-decodes ONLY those rows.
    def _maybe_crash(point: str, cleanup=None):
        if (args.fail_once_marker and args.process_id == 1
                and args.fail_point == point
                and not os.path.exists(args.fail_once_marker)):
            if cleanup is not None:
                cleanup()
            with open(args.fail_once_marker, "w") as f:
                f.write("crashed")
            raise RuntimeError(f"injected worker failure ({point})")

    _maybe_crash("init")

    import numpy as np
    import torch
    import torch.distributed as dist

    from pocket_tts_tpu_torch.parallel.mesh import gather_rows, make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import (
        assert_mesh_healthy,
        initialize_multihost,
    )
    from pocket_tts_tpu_torch.pipeline.tts import NoiseSource

    device = _worker_device(args)
    if device.type == "cpu":  # the processes share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.processes))
    info = initialize_multihost(
        coordinator_address=args.coordinator,
        num_processes=args.processes,
        process_id=args.process_id,
        device=device,
    )
    n_proc = info["process_count"]
    pid = info["process_index"]
    mesh = make_mesh(n_data=n_proc, n_model=1)
    if not assert_mesh_healthy(mesh):
        raise RuntimeError("mesh heartbeat failed before serving")

    model = _build_model(args, device)

    # ---- ingest: process 0 owns the batch and broadcasts it ----
    B = args.utterances
    if B % n_proc:
        raise ValueError(f"--utterances {B} must divide over {n_proc} processes")
    tok_len = args.prompt_tokens
    if pid == 0:
        rng = np.random.default_rng(args.seed)
        token_batch = torch.from_numpy(rng.integers(1, 30, size=(B, tok_len), dtype=np.int64))
    else:
        token_batch = torch.zeros((B, tok_len), dtype=torch.int64)
    token_batch = token_batch.to(device)
    dist.broadcast(token_batch, src=0)
    token_batch = token_batch.cpu().numpy()

    # ---- local slice: rows [pid*local : (pid+1)*local] decode here ----
    local = B // n_proc
    rows = slice(pid * local, (pid + 1) * local)
    rng = np.random.default_rng(1000 + args.seed)  # the same voices everywhere
    voice_wavs = (rng.standard_normal((B, 1, 1, 3000)) * 0.1).astype(np.float32)

    def _row_path(g: int) -> str:
        return os.path.join(args.results_dir, f"row_{g}.npy")

    audio_rows: dict[int, np.ndarray] = {}
    missing = list(range(local))
    if args.results_dir:
        os.makedirs(args.results_dir, exist_ok=True)
        missing = []
        for i in range(local):
            try:
                audio_rows[i] = np.load(_row_path(rows.start + i))
            except (OSError, ValueError):
                missing.append(i)

    t0 = time.monotonic()
    if missing:
        states = [model.state_for_audio_array(voice_wavs[rows.start + i]) for i in missing]
        token_lists = [token_batch[rows.start + i].tolist() for i in missing]

        # per-GLOBAL-row noise streams: the audio does not depend on how many
        # processes the batch is split over (1 process == N processes)
        row_noise = [NoiseSource(model.gen, seed=args.seed + 7919 * (rows.start + i))
                     for i in missing]

        def batch_noise(shape):
            if len(shape) == 3:  # a block [K, B, L]: each row's stream advances per step
                K, Bl, L = shape
                return np.stack([np.stack([row_noise[b]((L,)) for b in range(Bl)])
                                 for _ in range(K)])
            Bl, L = shape
            return np.stack([row_noise[b]((L,)) for b in range(Bl)])

        decoded = model.generate_audio_batch(states, token_lists, frames_after_eos=2,
                                             noise_source=batch_noise)
        for i, a in zip(missing, decoded):
            audio_rows[i] = a
            if args.results_dir:
                np.save(_row_path(rows.start + i), a)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    decode_s = time.monotonic() - t0
    audio = [audio_rows[i] for i in range(local)]

    # barrier: every worker's rows are decoded AND saved before anyone goes
    # on to the gather (and where the fault injection of the row-recovery
    # test lands, see _maybe_crash)
    dist.barrier()
    _maybe_crash("after_decode", cleanup=lambda: [
        os.remove(_row_path(rows.start + i))
        for i in range(local)
        if args.results_dir and os.path.exists(_row_path(rows.start + i))
    ])

    # ---- egress: gather every process's rows ----
    max_len = model._estimate_max_gen_len(tok_len) * model.samples_per_frame
    all_audio = gather_rows([a[:max_len] for a in audio], mesh, device)
    all_lengths = [len(a) for a in all_audio]

    healthy = assert_mesh_healthy(mesh)
    decoded_rows = torch.tensor([len(missing)], dtype=torch.int64, device=device)
    dist.all_reduce(decoded_rows)
    report = {
        "processes": n_proc,
        "audio_rows": int(B),
        "rows_per_process": int(local),
        "rows_decoded": int(decoded_rows.item()),  # this attempt (the rest from saved rows)
        "global_devices": info["global_devices"],
        "row_samples": all_lengths,
        "audio_checksum": round(float(sum(np.abs(a).sum() for a in all_audio)), 4),
        "mesh_healthy": bool(healthy),
        "decode_s": round(decode_s, 3),
        "graph_replays": model.step_graphs.replays,  # this process's (0 op by op, on the CPU)
        "device": str(device) if device.type == "cpu" else torch.cuda.get_device_name(device),
    }
    if pid == 0:
        print(MULTIHOST_TAG + json.dumps(report), flush=True)
        if args.out:
            from pocket_tts_tpu_torch.io.audio import StreamingWAVWriter

            with open(args.out, "wb") as f:
                w = StreamingWAVWriter(f, model.sample_rate)
                w.write_header(model.sample_rate)
                for a in all_audio:
                    w.write_pcm_data(a)
                w.finalize()
    dist.destroy_process_group()
    return report


def _spawn_once(args) -> dict:
    import socket

    with socket.socket() as s:  # a free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    cmd_base = [
        sys.executable, "-m", "pocket_tts_tpu_torch.parallel.launch", "--worker",
        "--coordinator", f"127.0.0.1:{port}",
        "--processes", str(args.processes),
        "--utterances", str(args.utterances),
        "--prompt-tokens", str(args.prompt_tokens),
        "--seed", str(args.seed),
        "--dtype", args.dtype,
        "--device", args.device,
    ]
    if args.tiny:
        cmd_base.append("--tiny")
    else:
        if args.language:
            cmd_base += ["--language", args.language]
        if args.config:
            cmd_base += ["--config", str(args.config)]
        if args.allow_random_init:
            cmd_base.append("--allow-random-init")
    if args.out:
        cmd_base += ["--out", args.out]
    if args.results_dir:
        cmd_base += ["--results-dir", args.results_dir]
    if args.fail_once_marker:
        cmd_base += ["--fail-once-marker", args.fail_once_marker,
                     "--fail-point", args.fail_point]

    procs = [subprocess.Popen(cmd_base + ["--process-id", str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=REPO_ROOT)
             for pid in range(args.processes)]
    # supervise: the moment any worker dies, end the rest (they would
    # otherwise wait in the group's rendezvous or a collective)
    deadline = time.monotonic() + args.timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("launch workers", args.timeout)
            for pid, p in enumerate(procs):
                rc = p.poll()
                if rc is not None and rc != 0 and failed is None:
                    failed = (pid, rc)
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    report = None
    outs = []
    for pid, p in enumerate(procs):
        out, _ = p.communicate()
        outs.append(out or "")
        if p.returncode != 0 and failed is None:
            failed = (pid, p.returncode)
        for line in (out or "").splitlines():
            if line.startswith(MULTIHOST_TAG):
                report = json.loads(line[len(MULTIHOST_TAG):])
    if failed is not None:
        for o in outs:
            sys.stderr.write(o)
        raise RuntimeError(f"worker {failed[0]} exited with {failed[1]}")
    if report is None:
        for o in outs:
            sys.stderr.write(o)
        raise RuntimeError("no worker reported a result")
    return report


def spawn_local(args) -> dict:
    """Spawn --processes workers of this module on this machine and return
    process 0's report. A failed attempt is relaunched up to --retries times;
    each attempt saves every decoded row to a shared results dir (a temporary
    one, removed at the end, when retries are on and none is given), so a
    relaunch decodes only the rows the failed attempt did not finish."""
    if args.results_dir is not None or args.retries == 0:
        return _spawn_attempts(args)
    import shutil
    import tempfile

    args.results_dir = tempfile.mkdtemp(prefix="ptts_rows_")
    try:
        return _spawn_attempts(args)
    finally:
        shutil.rmtree(args.results_dir, ignore_errors=True)
        args.results_dir = None


def _spawn_attempts(args) -> dict:
    last = None
    for attempt in range(args.retries + 1):
        try:
            report = _spawn_once(args)
            report["attempts"] = attempt + 1
            print(MULTIHOST_TAG + json.dumps(report), flush=True)
            return report
        except (RuntimeError, subprocess.TimeoutExpired) as e:
            last = e
            if attempt < args.retries:
                print(f"job attempt {attempt + 1} failed ({e}); relaunching",
                      file=sys.stderr, flush=True)
    raise last


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pocket-tts-tpu-torch-launch",
        description="multi-process data-parallel TTS serving driver",
    )
    p.add_argument("--worker", action="store_true",
                   help="run as one worker process (else: spawn local workers)")
    p.add_argument("--processes", type=int, default=2)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (else MASTER_ADDR / MASTER_PORT)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda: NCCL, process r on cuda:{r %% device count}; cpu: gloo")
    p.add_argument("--cpu", action="store_const", dest="device", const="cpu",
                   help="the JAX driver's flag: --device cpu")
    p.add_argument("--tiny", action="store_true",
                   help="toy flagship-shaped model (bring-up / CI)")
    p.add_argument("--language", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--allow-random-init", action="store_true")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--utterances", type=int, default=4,
                   help="global batch size (must divide across processes)")
    p.add_argument("--prompt-tokens", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="concatenated WAV (process 0)")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--retries", type=int, default=1,
                   help="job relaunches after a worker failure (row-level: "
                        "completed rows are cached in --results-dir)")
    p.add_argument("--results-dir", default=None,
                   help="shared dir persisting per-row audio across attempts "
                        "(a temporary one in spawn mode when retries > 0)")
    p.add_argument("--fail-once-marker", default=None,
                   help=argparse.SUPPRESS)  # fault injection (tests)
    p.add_argument("--fail-point", default="init",
                   choices=("init", "after_decode"),
                   help=argparse.SUPPRESS)  # fault injection (tests)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        run_worker(args)
        return 0
    spawn_local(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

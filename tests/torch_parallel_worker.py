"""Worker processes for the port's multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_training.py,
tests/test_torch_server_mesh.py, tests/test_torch_mesh_graph.py): one gloo
process per rank of a `torch.distributed` job on this machine. Also the
step graphs' CPU stand-ins (DirectGraph, DirectPass), which the
single-process graph tests import from here.

    python tests/torch_parallel_worker.py SCENARIO DIR

runs one rank (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT from the
environment, as `run_ranks` sets them); inputs come from DIR/inputs.npz and
DIR/inputs.json, and each rank writes DIR/rank{r}.npz. This module imports
neither JAX nor the JAX package, so a worker starts in a couple of seconds.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def frame_noise(n_frames: int, ldim: int, temp: float, seed: int = 0):
    """One pre-drawn [frames, 1, ldim] stream served K frames at a time,
    whatever shape each side asks for."""
    noise = np.random.default_rng(seed).standard_normal((n_frames, 1, ldim)).astype(np.float32)
    noise *= temp ** 0.5
    served = 0

    def source(shape):
        nonlocal served
        k = 1 if len(shape) == 2 else shape[0]
        out = noise[served:served + k].reshape(shape)
        served += k
        return out

    return source


class DirectGraph:
    """A step graph's stand-in on the CPU: the capture's warm-up runs (it
    must change nothing the chunk reads), then each replay calls the body
    the graph would hold (Lane.block) on the lane's buffers, into `out`.
    Under a mesh it runs the card's collectives: the warm-up's once, then
    the body's on each replay (a capture records them without running
    them)."""

    pool_bytes = 0  # what a capture's pool grows by

    def __init__(self, lane, K, injected):
        import torch

        self.lane, self.K = lane, K
        self.noise = torch.zeros((K, lane.B, lane.model.specs.ldim)) if injected else None
        self.warmup_s, self.capture_s, self.launches, self.replays = 0.0, 0.0, {}, 0
        lane.warm_up(K, self.noise)

    def replay(self):
        self.replays += 1
        self.out = self.lane.block(self.K, self.noise)


class DirectPass:
    """A prompt or encoder graph's stand-in on the CPU (in place of
    step_graphs._PassGraph): the warm-up runs, then each replay calls the
    body the graph would hold, into `out`."""

    pool_bytes = 0

    def __init__(self, stream, holder, warm_up, body, generator=None):
        self.body = body
        self.warmup_s, self.capture_s, self.launches, self.replays = 0.0, 0.0, {}, 0
        warm_up()

    def replay(self):
        self.replays += 1
        self.out = self.body()


class RowNoise:
    """tests/test_sharded_inference.RowNoise without its JAX imports: one
    numpy stream per row, L normals per row per frame."""

    def __init__(self, seeds):
        self.rngs = [np.random.default_rng(s) for s in seeds]

    def __call__(self, shape):
        if len(shape) == 2:
            _, L = shape
            return np.stack([r.standard_normal(L) for r in self.rngs]).astype(np.float32)
        K, _, L = shape
        return np.stack([np.stack([r.standard_normal(L) for r in self.rngs])
                         for _ in range(K)]).astype(np.float32)


def start_ranks(n: int, scenario: str, workdir: Path) -> list[subprocess.Popen]:
    """Start `n` ranks of `scenario`, each with a share of the host's cores."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threads = str(max(1, (os.cpu_count() or 1) // n))
    procs = []
    for rank in range(n):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS=threads)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), scenario, str(workdir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def wait_ranks(procs: list[subprocess.Popen], timeout: float) -> list[str]:
    """Every rank's output once all have ended; a rank still running after
    `timeout` seconds in all is killed. Raises with every rank's output when
    a rank failed or was killed."""
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(killed at the time limit)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise AssertionError("\n".join(f"--- rank {r} (rc {p.returncode}):\n{o}"
                                       for r, (p, o) in enumerate(zip(procs, outs))))
    return outs


def run_ranks(n: int, scenario: str, workdir: Path, timeout: float = 120.0) -> list[dict]:
    """Run `n` ranks of `scenario` and return every rank's saved arrays.
    A rank that fails or runs past `timeout` fails the call with every
    rank's output."""
    wait_ranks(start_ranks(n, scenario, workdir), timeout)
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(n)]


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict of arrays or tensors as {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


# --------------------------------------------------------------- scenarios


def _load(cfg, **kw):
    from pocket_tts_tpu_torch.pipeline.tts import TTSModel

    return TTSModel.load_model(config=cfg, device="cpu", **kw)


def serve4(inp: dict, meta: dict) -> dict:
    """World 4: DP 4x1 on a batch of 4 (and a batch that does not split),
    then TP+DP 2x2 on a ragged batch of 2 with EOS off."""
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import assert_mesh_healthy

    out = {}
    model = _load(meta["config"])
    mesh = make_mesh(4, 1)
    out["healthy_4x1"] = np.asarray(assert_mesh_healthy(mesh))
    model.shard_for_mesh(mesh)
    wavs = inp["dp_wavs"]
    voices = [model.state_for_audio_array(w) for w in wavs]
    audio = model.generate_audio_batch(voices, meta["dp_tokens"], frames_after_eos=2,
                                       noise_source=RowNoise(meta["dp_seeds"]))
    out.update({f"dp_{b}": a for b, a in enumerate(audio)})
    try:
        model.generate_audio_batch(voices[:2], meta["dp_tokens"][:2], frames_after_eos=2,
                                   noise_source=RowNoise(meta["dp_seeds"][:2]))
        out["split_raised"] = np.asarray(False)
    except ValueError as e:
        out["split_raised"] = np.asarray("does not split" in str(e))

    model = _load(meta["config"], eos_threshold=1e9)
    mesh = make_mesh(2, 2)
    out["healthy_2x2"] = np.asarray(assert_mesh_healthy(mesh))
    model.shard_for_mesh(mesh, tensor_parallel=True)
    voices = [model.state_for_audio_array(w) for w in inp["tpdp_wavs"]]
    audio = model.generate_audio_batch(voices, meta["tpdp_tokens"], frames_after_eos=2,
                                       noise_source=RowNoise(meta["tpdp_seeds"]))
    out.update({f"tpdp_{b}": a for b, a in enumerate(audio)})
    out["tpdp_steps"] = np.asarray(model.decode_steps)
    written_back(model, inp, meta, f"tpdp_written_back_{mesh.get_local_rank('data')}")
    return out


def written_back(model, inp: dict, meta: dict, name: str) -> None:
    """The TP test stream with write_back (copy_state=False): the voice state
    then holds every decode step's k/v, which the backbone's heads wrote.
    Exported (heads gathered) as DIR/{name}.safetensors."""
    voice = model.state_for_audio_array(inp["tp_wav"])
    for _ in model.generate_audio_stream_from_tokens(voice, meta["tp_tokens"], 2, RowNoise([42]),
                                                     max_gen_len=8, write_back=True):
        pass
    model.export_model_state(voice, Path(meta["dir"]) / f"{name}.safetensors")


def tp2(inp: dict, meta: dict) -> dict:
    """World 2: TP 1x2, a b1 stream from a cloned voice, the voice's export
    and import, and the stream with neither a seed nor a noise_source (each
    rank's fresh seed made different), held on rank 0 against an unsharded
    model with the first rank's seed; then the stream with int8 weights,
    held on rank 0 against an unsharded int8 model."""
    import torch

    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import assert_mesh_healthy

    rank = int(os.environ["RANK"])
    out = {}
    mesh = make_mesh(1, 2)
    out["healthy_1x2"] = np.asarray(assert_mesh_healthy(mesh))

    def stream(model, voice):
        return np.concatenate(list(model.generate_audio_stream_from_tokens(
            voice, meta["tp_tokens"], 2, RowNoise([42]), max_gen_len=8)))

    model = _load(meta["config"])
    model.shard_for_mesh(mesh, tensor_parallel=True)
    voice = model.state_for_audio_array(inp["tp_wav"])
    out["heads"] = np.asarray(voice.k.shape[3])
    out["tp_stream"] = stream(model, voice)
    export = Path(meta["dir"]) / "tp_export.safetensors"
    model.export_model_state(voice, export)
    back = model.import_state(export)
    n = int(voice.offset[0])
    out["import_equal"] = np.asarray(bool(
        torch.equal(back.k[:, :, :n], voice.k[:, :, :n])
        and torch.equal(back.v[:, :, :n], voice.v[:, :, :n])))
    written_back(model, inp, meta, "tp_written_back")

    from pocket_tts_tpu_torch.pipeline import tts

    tts._fresh_seed = lambda: 1000 + rank

    def seeded(model, voice, seed):
        return np.concatenate(list(model.generate_audio_stream_from_tokens(
            voice, meta["tp_tokens"], 2, max_gen_len=8, seed=seed)))

    out["seedless_stream"] = seeded(model, voice, None)
    if rank == 0:  # the unsharded model on this rank alone: no collective
        m1 = _load(meta["config"])
        out["seeded_unsharded"] = seeded(m1, m1.state_for_audio_array(inp["tp_wav"]), 1000)

    q = _load(meta["config"], quantize=True)
    q.shard_for_mesh(mesh, tensor_parallel=True)
    out["int8_stream"] = stream(q, q.state_for_audio_array(inp["tp_wav"]))
    if rank == 0:  # the unsharded int8 model on this rank alone: no collective
        q1 = _load(meta["config"], quantize=True)
        out["int8_unsharded"] = stream(q1, q1.state_for_audio_array(inp["tp_wav"]))
    return out


def train4(inp: dict, meta: dict) -> dict:
    """World 4: the training step on a 2x2 mesh, 12 Adam steps on one batch
    with the same injected t and noise each step; every rank's losses and its
    step-0 gradients (its slice of them)."""
    import torch

    from pocket_tts_tpu_torch.models.flow_lm import FlowLMSpecs
    from pocket_tts_tpu_torch.nn.flow_mlp import FlowMLPConfig
    from pocket_tts_tpu_torch.nn.transformer import TransformerConfig
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.training import make_train_step

    s = meta["specs"]
    specs = FlowLMSpecs(transformer=TransformerConfig(**s["transformer"]),
                        flow=FlowMLPConfig(**s["flow"]), ldim=s["ldim"], n_bins=s["n_bins"],
                        insert_bos_before_voice=s["insert_bos_before_voice"])
    params = unflatten({k[len("p/"):]: torch.from_numpy(v) for k, v in inp.items()
                        if k.startswith("p/")})
    batch = {k: torch.from_numpy(inp[k]) for k in ("tokens", "latents", "eos_labels")}
    t, noise = torch.from_numpy(inp["t"]), torch.from_numpy(inp["noise"])
    mesh = make_mesh(2, 2)
    init, step = make_train_step(specs, meta["lr"], mesh)
    state = init(params)
    out, losses = {}, []
    for i in range(meta["steps"]):
        state, loss = step(state, batch, t=t, noise=noise)
        losses.append(float(loss))
        if i == 0:
            out.update({f"g/{k}": v.grad.numpy().copy()
                        for k, v in flatten(state.params).items() if v.grad is not None})
    out["losses"] = np.asarray(losses)
    out["model_rank"] = np.asarray(mesh.get_local_rank("model"))
    return out


def server_mesh(inp: dict, meta: dict) -> dict:
    """World 2: a 1x2 mesh with tensor_parallel=True (or the mesh
    meta["mesh"], with TP when it has a model axis > 1) behind one HTTP
    server (`api.server.serve`, every rank calling it): rank 0 listens on
    127.0.0.1:meta["port"], rank 1 follows. The control plane's health
    timeout is meta["health_timeout"].
    EOS off; every stream on every rank draws a fresh frame_noise. Rank 0
    yields the chunks of a text with "slowly" in it 20 ms apart (a window in
    which a generation holds the lock); rank 0's client write of the second
    chunk of a text with "pause" in it blocks for meta["pause_s"] (a client
    that stops reading); rank 1 fails to tokenise a text with "fault" in it
    (a failure on one rank); every rank's first stream of a text with
    "retry" in it fails before its first step (a transient fault on every
    rank); once a text with "deaf" in it is done, rank 1's main thread
    stops receiving (it sleeps before its next receive; its heartbeat goes
    on); after its stream of a text with "lag" in it, rank 1 sleeps for
    meta["pause_s"] before the attempt's agreement (a follower behind rank
    0, its heartbeat on). Ends when `serve` returns: rank 0's on SIGINT, a
    follower's on `stop`."""
    import signal

    from pocket_tts_tpu_torch.api import server
    from pocket_tts_tpu_torch.parallel import multihost
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh

    rank = int(os.environ["RANK"])
    multihost.HEALTH_TIMEOUT_S = meta["health_timeout"]
    n_data, n_model = meta.get("mesh", (1, 2))
    model = _load(meta["config"], eos_threshold=1e9)
    model.shard_for_mesh(make_mesh(n_data, n_model), tensor_parallel=n_model > 1)
    real_stream, real_encode = model.generate_audio_stream, model._encode_text
    real_write = server._QueueWriter.write
    failed_once = set()
    pause = {"armed": False}
    deaf = {"armed": False}
    real_receive = multihost.ControlPlane.receive

    def receive(self):
        if deaf["armed"]:
            time.sleep(3600)
        return real_receive(self)

    def stream(state, text, **kw):
        if "retry" in text and text not in failed_once:
            failed_once.add(text)
            raise RuntimeError("a transient fault on every rank")
        kw["noise_source"] = frame_noise(400, model.specs.ldim, model.gen.temp)
        for i, chunk in enumerate(real_stream(state, text, **kw)):
            if rank == 0 and "slowly" in text:
                time.sleep(0.02)
            if rank == 0 and "pause" in text and i == 1:
                pause["armed"] = True
            yield chunk
        if rank == 1 and "deaf" in text:
            deaf["armed"] = True
        if rank == 1 and "lag" in text:
            time.sleep(meta["pause_s"])

    def write(self, data):
        if pause["armed"] and data:
            pause["armed"] = False
            time.sleep(meta["pause_s"])
        return real_write(self, data)

    def encode(text):
        if rank == 1 and "fault" in text:
            raise ValueError("a tokeniser fault on rank 1")
        return real_encode(text)

    model.generate_audio_stream, model._encode_text = stream, encode
    server._QueueWriter.write = write
    multihost.ControlPlane.receive = receive
    signal.signal(signal.SIGINT, signal.default_int_handler)
    server.serve(model, "127.0.0.1", meta["port"], meta["voice"])
    return {"decode_steps": np.asarray(model.decode_steps)}


def lose_rank(inp: dict, meta: dict) -> dict:
    """World 2: rank 1 joins the group, then stays silent for
    meta["silent_s"] seconds and exits without a word; rank 0 times its mesh
    heartbeat with a `timeout` while rank 1 is silent and again once it has
    gone."""
    from pocket_tts_tpu_torch.parallel.mesh import make_mesh
    from pocket_tts_tpu_torch.parallel.multihost import assert_mesh_healthy

    mesh = make_mesh(2, 1)
    if int(os.environ["RANK"]) == 1:
        time.sleep(meta["silent_s"])
        os._exit(0)
    out = {}
    for case in ("silent", "gone"):
        if case == "gone":
            time.sleep(meta["silent_s"] + 0.5)
        t0 = time.monotonic()
        out[f"{case}_healthy"] = np.asarray(assert_mesh_healthy(mesh, timeout=meta["timeout"]))
        out[f"{case}_s"] = np.asarray(time.monotonic() - t0)
    np.savez(Path(meta["dir"]) / "rank0.npz", **out)
    os._exit(0)  # the group lost a rank: no teardown


def _stand_ins(rank: int, pool_bytes: int = 0):
    """Every step graph of the process replaced by its direct call
    (DirectGraph, DirectPass), each capture's pool growing by `pool_bytes`
    times rank + 1: what each rank measures differs, as
    torch.cuda.memory_reserved's growth may differ between the ranks of a
    job."""
    from pocket_tts_tpu_torch.pipeline import step_graphs

    class Graph(DirectGraph):
        pass

    class Pass(DirectPass):
        pass

    Graph.pool_bytes = Pass.pool_bytes = pool_bytes * (rank + 1)
    step_graphs._BlockGraph, step_graphs._PassGraph = Graph, Pass


def _graph_modes(model):
    """Set `model`'s step graphs on (the stand-ins) or off (op by op)."""
    def mode(graphed: bool):
        model._graphed = lambda: graphed
    return mode


def _kept(model) -> np.ndarray:
    """What the step graphs keep, as sortable rows: each block graph's
    (B, K, C) and each prompt or encoder graph's kind and key."""
    sg = model.step_graphs
    rows = [f"block B={st['B']} K={st['K']} C={st['C']}" for st in sg.stats()]
    rows += [f"{st['kind']} {st['key']}" for st in sg.pass_stats()]
    return np.asarray(sorted(rows) or [""])


def mesh_graph_tp(inp: dict, meta: dict) -> dict:
    """World 2: TP 1x2 with EOS off, every graph a direct call of its body
    (the stand-ins) against the same calls op by op, on one seed: a b1
    stream with device noise and a seed that grows from 256 to 384 slots,
    then a second chunk in the same lane, and one with injected noise, all
    with copy_state False (the audio and the post-chunk state kept); the
    voice prompt and the encoder (state_for_audio_array); what each rank
    keeps when rank 1's budget is 0 and rank 0's unbounded (two requests
    across 256 -> 384); then, with each capture's pool growing by a
    different amount on each rank, what each keeps under a budget one byte
    short of rank 0's holdings; and the block and the text prompt with
    every host read of a tensor made to raise."""
    import torch

    from pocket_tts_tpu_torch.parallel.mesh import make_mesh

    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)  # tiny ops: a pool of threads per op costs more than its work
    _stand_ins(rank, pool_bytes=10**9)
    model = _load(meta["config"], eos_threshold=1e9)
    model.shard_for_mesh(make_mesh(1, 2), tensor_parallel=True)
    mode = _graph_modes(model)
    D = model.specs.transformer.d_model
    cond = torch.from_numpy(inp["cond"])  # [1, 180, D]: a long voice, 256 -> 384 slots
    tokens = meta["tokens"]
    out: dict = {}

    def stream(voice, frames, **kw):
        audio = np.concatenate(list(model.generate_audio_stream_from_tokens(
            voice, tokens, 2, max_gen_len=frames, write_back=True, **kw)))
        return audio, voice

    def save(prefix, audio, state):
        out[f"{prefix}_audio"] = audio
        for name in ("k", "v", "pos", "offset"):
            out[f"{prefix}_{name}"] = getattr(state, name).numpy()
        out[f"{prefix}_write_pos"] = np.asarray(state.write_pos)

    for graphed in (False, True):
        mode(graphed)
        tag = "graphed" if graphed else "eager"
        voice = model.state_for_conditioning(cond)
        for name in ("k", "v", "pos", "offset"):
            out[f"{tag}_voice_{name}"] = getattr(voice, name).numpy().copy()
        cloned = model.state_for_audio_array(inp["wav"])
        out[f"{tag}_clone_k"], out[f"{tag}_clone_offset"] = cloned.k.numpy(), cloned.offset.numpy()
        st = voice.clone()
        save(f"{tag}_seeded", *stream(st, 66, seed=1))
        save(f"{tag}_second", *stream(st, 10, seed=2))
        out[f"{tag}_fresh10_audio"] = stream(voice.clone(), 10, seed=2)[0]
        save(f"{tag}_injected", *stream(voice.clone(), 20,
                                       noise_source=frame_noise(40, model.specs.ldim, 1.0, 3)))
    out["kept_unbounded"] = _kept(model)

    # rank budgets that differ: the group keeps by the least
    sg = model.step_graphs
    sg.release()
    sg.budget = 0 if rank == 1 else None
    for i, (frames, seed) in enumerate(((66, 1), (10, 2))):
        out[f"budget_audio_{i}"] = stream(voice.clone(), frames, seed=seed)[0]
        out[f"budget_kept_{i}"] = _kept(model)
        out[f"budget_held_{i}"] = np.asarray(sg.held())

    # pool growth that differs by rank: the group counts the largest
    sg.release()
    sg.budget = None
    out["bytes_audio_0"] = stream(voice.clone(), 66, seed=1)[0]
    held = torch.tensor([sg.held()])
    torch.distributed.broadcast(held, src=0)
    sg.budget = int(held) - 1
    for i, (frames, seed) in enumerate(((10, 2), (66, 1)), start=1):
        out[f"bytes_audio_{i}"] = stream(voice.clone(), frames, seed=seed)[0]
        out[f"bytes_kept_{i}"] = _kept(model)
        out[f"bytes_held_{i}"] = np.asarray(sg.held())
    sg.budget = None
    sg.release()

    # no host read inside a block or a text prompt of the mesh
    lane = sg.acquire(1)
    lane.start(4, None)
    lane.load(voice.clone(), 256)
    lane.prompt([tokens], 8)
    lane.begin()
    host = torch.tensor(tokens[:8] + [0] * (8 - len(tokens[:8])) + [len(tokens[:8])])[None]
    noise = torch.from_numpy(frame_noise(8, model.specs.ldim, 1.0, 5)((8, 1, model.specs.ldim)))
    real = {name: getattr(torch.Tensor, name) for name in ("__bool__", "item", "tolist", "cpu")}

    def host_read(*args, **kwargs):
        raise AssertionError("host read inside a graph's body")

    for name in real:
        setattr(torch.Tensor, name, host_read)
    try:
        try:
            bool(torch.ones(1))
            guarded = False
        except AssertionError:
            guarded = True
        shapes = [tuple(lane.block(1, None).shape), tuple(lane.block(8, noise).shape)]
        lane._prompt_body(host, lane.slab.offset.clone(), lane.slab.wp.clone())
    finally:
        for name, fn in real.items():
            setattr(torch.Tensor, name, fn)
    lane.close()
    out["host_read_guarded"] = np.asarray(guarded)
    out["host_read_shapes"] = np.asarray(shapes)
    return out


def mesh_graph_dp(inp: dict, meta: dict) -> dict:
    """World 2: DP 2x1 with EOS off: a ragged batch of 4 (voices and
    prompts of different lengths) with injected per-row noise and with
    device noise on a seed, every graph a direct call of its body against
    the same calls op by op; each block's noise as this rank's lane
    received it; and an unsharded model's noise for the whole batch on the
    same seeds (this rank alone: no collective)."""
    import torch

    from pocket_tts_tpu_torch.parallel.mesh import captures_collectives, make_mesh
    from pocket_tts_tpu_torch.pipeline import step_graphs

    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)  # tiny ops: a pool of threads per op costs more than its work
    _stand_ins(rank)
    one = _load(meta["config"], eos_threshold=1e9)
    model = _load(meta["config"], eos_threshold=1e9)
    model.shard_for_mesh(make_mesh(2, 1))
    token_lists = meta["batch_tokens"]
    conds = [torch.from_numpy(inp[f"batch_cond_{b}"]) for b in range(4)]
    seeds = meta["batch_seeds"]
    warm = [False]
    real_warm = step_graphs.Lane.warm_up

    def warm_up(self, K, noise):
        warm[0] = True
        try:
            real_warm(self, K, noise)
        finally:
            warm[0] = False

    step_graphs.Lane.warm_up = warm_up

    def recording(m, noises):
        real = m._decode_block

        def decode_block(lm, mimi, prev, is_bos, noise):
            if not warm[0]:
                noises.append(noise.clone())
            return real(lm, mimi, prev, is_bos, noise)

        m._decode_block = decode_block

    out: dict = {}
    for m, name in ((one, "unsharded"), (model, "mesh")):
        noises: list = []
        recording(m, noises)
        mode = _graph_modes(m)
        for graphed in ((False,) if m is one else (False, True)):
            mode(graphed)
            tag = f"{name}_{'graphed' if graphed else 'eager'}"
            voices = [m.state_for_conditioning(c) for c in conds]
            for kind, kw in (("injected", dict(noise_source=RowNoise(seeds))),
                             ("device", dict(seed=5))):
                noises.clear()
                audio = m.generate_audio_batch(voices, token_lists, frames_after_eos=2, **kw)
                out.update({f"{tag}_{kind}_{b}": a for b, a in enumerate(audio)})
                out[f"{tag}_{kind}_noise"] = torch.cat(noises).numpy()
    out["rows"] = np.asarray([model.step_graphs.stats()[0]["rows"]])
    out["captures"] = np.asarray(captures_collectives(model.mesh))
    return out


SCENARIOS = {"serve4": serve4, "tp2": tp2, "train4": train4, "server_mesh": server_mesh,
             "lose_rank": lose_rank, "mesh_graph_tp": mesh_graph_tp,
             "mesh_graph_dp": mesh_graph_dp}


def main() -> int:
    scenario, workdir = sys.argv[1], Path(sys.argv[2])
    import torch
    import torch.distributed as dist

    from pocket_tts_tpu_torch.parallel.multihost import initialize_multihost

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "1")))
    initialize_multihost(device="cpu")
    inp = dict(np.load(workdir / "inputs.npz"))
    meta = json.loads((workdir / "inputs.json").read_text())
    out = SCENARIOS[scenario](inp, meta)
    np.savez(workdir / f"rank{dist.get_rank()}.npz", **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())

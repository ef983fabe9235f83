"""The block loop of a chunk, and on the card each block of K frames as one
CUDA graph replay: the port's counterpart of the JAX package's compiled
decode step (`_fused_step_fn` for K=1 and `_multi_step_fn` for K>1, under
`jax.jit` in pocket_tts_tpu/pipeline/tts.py). The passes ahead of the blocks
replay as graphs too: a chunk's text prompt (`Lane.prompt`, the JAX
package's `_text_prompt_fn`), and, outside any lane, the voice prompt and
the Mimi encoder of a voice clone (`StepGraphs.run_pass`, its
`_audio_prompt_fn` and `_encode_fn`).

A block is K FlowLM decode steps (each with its flow head), `project_latent`
and the Mimi decoder over the block's latents (`TTSModel._decode_block`),
with the flow noise drawn on the device (`TTSModel._noise`, a fixed amount
of work) or copied in from a `noise_source`. Every chunk (`_generate_chunk`,
`generate_audio_batch`) decodes in a `Lane`: the buffers of its B rows. On
the card a model captures each block once per key and replays it, unsharded
or sharded over a mesh whose collectives are NCCL's (see "Under a mesh").
On the CPU, and on a gloo mesh, the lane calls the same body op by op.

Dispatch and fetch. `Lane.dispatch(K)` queues one block and returns a
`Ticket`; `Lane.fetch(ticket)` waits for it and returns the block's EOS
flags and audio on the host. Graphed, a dispatch is the replay, then a
non-blocking copy of the block's audio and flags (packed into one f32
tensor) into a pinned host slot, then an event; injected noise goes the
other way through a pinned slot of its own, so no copy from pageable
memory stalls the stream. The slots are the model's (`StepGraphs.slots`, a
ring that grows while every slot is held): a slot is reused only once its
ticket is fetched, or abandoned and done on the device. Op by op, the
dispatch runs the block to its end and the ticket holds its host output:
the fetch finds the work done, and the caller's schedule is the same on
every path (pipeline/tts.py keeps PIPELINE_DEPTH blocks in flight).

Buffers. A graph reads and writes fixed addresses, so a lane holds the
FlowLM caches of a capacity bucket (a `_Slab`: k, v, pos, offset and the
device write pointer), the Mimi decoder state, the previous latent, the
rows' BOS flags, each row's first EOS step and the chunk's frame count
(both updated inside the block, so the post-chunk trim, `Lane.trim`, needs
no host read), and the flow-noise generator. A chunk copies its voice state
into a slab (the working copy) and sets the device write pointer from the
host's; crossing a capacity bucket copies the caches into the next slab
(`states.place_states` lays out both). Every KV append over the FlowLM
cache, a step's and a prompt's T>1 block alike, writes at the device write
pointer by index and advances it there (nn/transformer.append_kv), and the
decode-stack and flash-decode kernels read it from the device, so one graph
serves every position of its capacity; the host keeps its own copy of the
pointer, advances it by K per dispatch (pad_to per prompt) and checks the
capacity before each. Inside a block the new offset, pointer, latent and
Mimi state are copied back into the lane's buffers (a few KB a row); the
text prompt advances the slab's offset and pointer in place. Its input, the
rows' token ids and true lengths (int64 [B, pad_to + 1]), is a buffer of its
graph, copied in from a pinned slot of the ring (`StepGraphs.upload`) as
injected noise is. A lane is held by one stream at a time (every chunk of
it, one after the other: the next chunk's load, prompt and first blocks
queue behind the last one's blocks on the same stream, with no host read
between them): a second live stream of the same B takes a lane of its own.

A pass outside the lanes (`run_pass`: a voice prompt, the encoder) keeps its
own fixed buffers: the voice prompt a conditioning buffer [B, pad_to, D]
(f32, the BOS row first where the config inserts it, zeros past the true
length), its true length and a blank cache that the body makes blank again
(positions -1, offset and pointer 0) before the pass; the encoder a wav
buffer [B, 1, frames * 1920] zero-padded to the frame bucket. A call fills
the buffers, replays, and copies the result into tensors of the caller's
(the voice state the LRU keeps, the latents cut back to the voice's frames),
all under the model's lock: the server's threads share the passes, and no
later replay writes what a caller holds.

Memory. The block and text-prompt graphs of one slab share one memory
pool, and each pass outside the lanes has a pool of its own. A graphed lane
keeps the slabs it reached, with their graphs, for the chunks after it, and
the model keeps its passes, within `StepGraphs.budget` bytes (caches,
pools, the lanes' and the passes' own buffers) over all of a model's lanes
and passes: before a slab or a pass is made, after a chunk leaves a slab
for the next bucket, after a pass runs and when a stream ends, the idle
slabs and passes go, least recently used first, with their graphs and
pools, and a lane left with none goes too. The slab a running chunk
decodes in and a running pass are never dropped, and a slab or pass goes
only once the device has finished with it (`Lane.settle`, `_Pass.settle`).
The budget is KEEP_FRACTION of the card's memory unless set; 0 keeps
nothing between calls. Op by op nothing is kept.

Keys: a block graph's (K, C) within a lane of B rows, and what it bakes in:
lsd steps, the EOS threshold, and the noise (drawn on the device with its
temperature and clamp, or injected); a text prompt's (pad_to, C) within a
lane of B rows, pad_to from PROMPT_BUCKETS; a voice prompt's (B, pad_to, C);
the encoder's (B, frame bucket), the JAX package's frame buckets
(pipeline/tts.py ENCODER_FRAME_BUCKETS). Every graph also bakes in the
weights' addresses: the graphs belong to the model's `params` and
`mimi_params` as they were at capture, and a model given other ones (the
quantization sweep swaps int8 configurations into one model) drops every
lane and pass first.

Capture. Before a key's capture the pass runs once op by op on the
capture's stream as its warm-up (the libraries' lazy set-up, such as a
thread's first cuDNN handle or a cuBLAS workspace for the stream, cannot
be captured). A block's or a text prompt's warm-up reads the lane's caches
and writes only the slots the replay is about to write (it writes them
again before anything attends them); the offset, pointer, Mimi state,
latent and BOS flags it runs on are copies, and the device noise comes from
a throwaway generator, so the warm-up changes no state the chunk reads. A
pass outside the lanes warms up on its own buffers.

Launch counts: a kernel wrapper counts its Python calls. The warm-up's
calls launch their kernels and stay counted (`warm_ups` counts its decode
steps); a capture's calls launch nothing and are taken back, and are kept
as the graph's launches per replay, which each replay adds
(ops/build.add_launches).

A capture, replay or copy that fails raises: there is no op-by-op or
unpipelined carry-on on the card. On the CPU and on a gloo mesh every pass
runs the same body op by op.

Under a mesh (TTSModel.shard_for_mesh, NCCL on the card) the graphs hold
the step's collectives: each layer's two tensor-parallel all-reduces and
the EOS agreement of the model group (parallel/mesh.reduce_from_model,
any_over_model), in the blocks, the text prompts and the voice prompts (the
encoder and the speaker projection are whole on every rank and hold none).
The seed's broadcast, the gather of the data ranks' rows and the mesh
heartbeat stay host work between replays, on the same communicators. A
capture's warm-up runs the body's collectives once (creating the group's
communicator lazily before any capture) and the capture records them
without running them, so every rank of a model group runs the same
collectives in the same order only if every rank keeps, drops and captures
the same graphs at the same points. So what the ranks of a model group keep
is decided on agreed numbers (`StepGraphs.agree`, an all-reduce over the
group at a capture, at a new slab or pass and wherever room is made; never
per block): each capture's pool growth is the group's largest, and the
budget the group's least. Under data parallelism a lane holds this rank's
`rows` of a batch of `B_noise`: the device noise is drawn for the whole
batch inside the graph and the rank's rows kept, injected noise is this
rank's rows of the host's whole-batch draw, so the audio does not depend on
the sharding; lanes are keyed by (B, rows, B_noise). When the server aborts
the mesh's NCCL communicators (a lost follower), `StepGraphs.abandon` makes
every later replay raise and drops the lanes and passes once the device is
done with them: a graph that holds an aborted communicator is never
replayed.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from pocket_tts_tpu_torch.core.tree import tree_leaves, tree_map
from pocket_tts_tpu_torch.models.mimi import init_decoder_state
from pocket_tts_tpu_torch.nn.transformer import StackState, local_heads
from pocket_tts_tpu_torch.ops.build import add_launches, launch_counts
from pocket_tts_tpu_torch.ops.decode_stack import stack_takes_rows
from pocket_tts_tpu_torch.ops.flash_decode import MAX_ATT
from pocket_tts_tpu_torch.parallel.mesh import max_over_model
from pocket_tts_tpu_torch.pipeline.states import place_states

KEEP_FRACTION = 0.25  # of the card's memory: the default budget of idle slabs
NO_EOS = 2**30  # a row's first EOS step until it shows one
warm_ups = {"steps": 0}  # decode steps run by the captures' warm-ups (every model)


def pack_block(flags: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """A block's EOS flags [K, B] and audio [K, B, 1, S] as one f32 tensor
    [K, B, S + 1] (the flags last), so one copy brings both to the host."""
    K, B = flags.shape
    return torch.cat([audio.reshape(K, B, -1).float(), flags.float()[..., None]], dim=-1)


def unpack_block(out: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """pack_block's host copy -> (flags [K, B] bool, audio [K, B, S] f32)."""
    return out[..., -1] > 0.5, out[..., :-1]


class _Slot:
    """Host memory of one dispatched block or upload: a block's packed
    output is copied into `out`, its injected noise copied from `noise`, a
    pass's host input from `in` (pinned on the card, each grown to the
    largest it has served). Held by one ticket."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.bufs: dict[str, torch.Tensor] = {}
        self.ticket: Ticket | None = None

    def free(self) -> bool:
        t = self.ticket
        return t is None or (t.abandoned and t.done())

    def view(self, name: str, shape: tuple, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        n = int(np.prod(shape))
        buf = self.bufs.get(name)
        if buf is None or buf.numel() < n or buf.dtype != dtype:
            buf = self.bufs[name] = torch.empty(n, dtype=dtype, pin_memory=self.pinned)
        return buf[:n].view(shape)


@dataclasses.dataclass(eq=False)
class Ticket:
    """One dispatched block of K frames: graphed, the slot its output is
    copied into and the event after that copy; op by op, its host output."""

    K: int
    shape: tuple = ()
    slot: _Slot | None = None
    event: torch.cuda.Event | None = None
    out: np.ndarray | None = None
    abandoned: bool = False
    fetched: bool = False

    def done(self) -> bool:
        """Whether the device has finished the block and its copy."""
        return self.event is None or self.event.query()


@dataclasses.dataclass
class _Slab:
    """The FlowLM caches of one capacity C, the memory pool of the graphs
    captured on them (block and text-prompt graphs), and when a chunk last
    took them."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    offset: torch.Tensor
    wp: torch.Tensor  # the device write pointer, int32 [1]
    pool: tuple | None = None  # made at the first capture
    pool_bytes: int = 0  # the pool's growth over its captures, and the prompts' inputs
    used: int = 0

    def state(self, write_pos: int) -> StackState:
        return StackState(self.k, self.v, self.pos, self.offset, write_pos, self.wp)

    @property
    def nbytes(self) -> int:
        return self.pool_bytes + sum(t.numel() * t.element_size()
                                     for t in (self.k, self.v, self.pos, self.offset, self.wp))


class _PassGraph:
    """One captured pass over fixed buffers: `warm_up()` once op by op on
    the capture's stream, then `body()` captured into `holder`'s memory
    pool (a `_Slab` or a `_Pass`: made at its first capture; its growth
    here, `pool_bytes`, is this process's: StepGraphs.keep adds the model
    group's largest to `holder.pool_bytes`). `out` is what the body
    returned (the graph's output tensors); `launches` the kernel launches
    one replay makes. `generator`: a generator each replay advances."""

    def __init__(self, stream, holder, warm_up, body, generator=None):
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        if holder.pool is None:
            holder.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            warm_up()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        self.warmup_s = time.perf_counter() - t0
        dev = torch.cuda.current_device()
        torch.cuda.empty_cache()  # as the capture does: what the pool adds is its growth
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        before = launch_counts()
        try:
            with torch.cuda.graph(graph, pool=holder.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = body()
        finally:  # a capture launches nothing
            after = launch_counts()
            add_launches({k: before[k] - after[k] for k in after})
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = max(0, torch.cuda.memory_reserved(dev) - reserved)
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.graph = graph
        self.replays = 0

    def replay(self) -> None:
        """Queue one replay on the current stream (self.out is its output)."""
        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1


class _BlockGraph(_PassGraph):
    """One captured block of K frames: its graph, its injected-noise input
    (or None), its output, and the kernel launches one replay makes."""

    def __init__(self, lane: "Lane", K: int, injected: bool):
        model = lane.model
        self.noise = (torch.zeros((K, lane.B, model.specs.ldim), dtype=torch.float32,
                                  device=model.device) if injected else None)
        super().__init__(lane.owner.stream, lane.slab, lambda: lane.warm_up(K, self.noise),
                         lambda: lane.block(K, self.noise),
                         generator=None if injected else lane.gen)  # replays advance it
        warm_ups["steps"] += K


class Lane:
    """The buffers a stream's chunks of B rows decode in, and the block
    graphs captured on them (see the module docstring). `graphed`: replay
    each block, else call its body op by op. Under data parallelism the
    lane holds this rank's `rows` of a batch of `B_noise` rows, whose noise
    is drawn whole and sliced, graphed or not."""

    def __init__(self, owner: "StepGraphs", B: int, graphed: bool,
                 rows: slice = slice(None), B_noise: int | None = None):
        model = owner.model
        dev = model.device
        self.owner, self.model, self.B, self.graphed = owner, model, B, graphed
        self.rows, self.B_noise = rows, B if B_noise is None else B_noise
        self.busy = False
        self.noise_source = None
        self.slabs: dict[int, _Slab] = {}
        self.slab: _Slab | None = None
        self.write_pos = 0  # the host's copy of the device write pointer
        self.mimi = init_decoder_state(model.mimi_specs, B, model._dtype, dev)
        self.prev = torch.zeros((B, model.specs.ldim), dtype=torch.float32, device=dev)
        self.is_bos = torch.ones((B,), dtype=torch.bool, device=dev)
        self.first_eos = torch.full((B,), NO_EOS, dtype=torch.int32, device=dev)
        self.frames = torch.zeros((1,), dtype=torch.int32, device=dev)  # decoded this chunk
        self.gen = torch.Generator(device=dev)
        self.graphs: dict[tuple, _BlockGraph] = {}
        self.prompts: dict[tuple, _PassGraph] = {}  # text-prompt graphs by (pad_to, C)
        self.tickets: list[Ticket] = []  # dispatched, not yet fetched or done and abandoned
        # a T=1 step of these rows takes the flash-decode kernel (not the
        # decode stack): its attended length must stay within MAX_ATT
        self.flash = graphed and not stack_takes_rows(model.specs.transformer,
                                                      model.params["transformer"], B, 1)

    @property
    def nbytes(self) -> int:
        """Bytes of the lane's slabs and of its own buffers."""
        own = tree_leaves(self.mimi) + [self.prev, self.is_bos, self.first_eos, self.frames]
        return (sum(s.nbytes for s in self.slabs.values())
                + sum(t.numel() * t.element_size() for t in own))

    def start(self, seed: int | None, noise_source) -> None:
        """A chunk's noise: `noise_source`, or the generator seeded with `seed`.
        The blocks already dispatched keep theirs (a replay reads the
        generator's seed and offset as it is queued)."""
        self.noise_source = noise_source
        if noise_source is None:
            self.gen.manual_seed(seed)

    def _slab(self, C: int) -> _Slab:
        """The slab of C slots, made (after room is made for it) if new."""
        slab = self.slabs.get(C)
        if slab is None:
            cfg, m = self.model.specs.transformer, self.model
            shape = (cfg.num_layers, self.B, C, local_heads(cfg), cfg.d_model // cfg.num_heads)

            def make() -> _Slab:
                return _Slab(k=torch.empty(shape, dtype=m._dtype, device=m.device),
                             v=torch.empty(shape, dtype=m._dtype, device=m.device),
                             pos=torch.empty((self.B, C), dtype=torch.int32, device=m.device),
                             offset=torch.empty((self.B,), dtype=torch.int32, device=m.device),
                             wp=torch.zeros((1,), dtype=torch.int32, device=m.device))

            if self.graphed:
                self.owner.make_room(2 * int(np.prod(shape)) * m._dtype.itemsize
                                     + 4 * self.B * C)
            try:
                slab = make()
            except torch.cuda.OutOfMemoryError:
                slab = None
            # every idle slab and pass goes first where a rank of the group ran out
            if (self.owner.agree(slab is None)[0] if self.graphed else slab is None):
                self.owner.make_room(0, budget=0)
                slab = slab or make()
            self.slabs[C] = slab
        slab.used = self.owner.tick()
        return slab

    def load(self, states: list[StackState] | StackState, capacity: int) -> None:
        """The working copy: each row's voice state into the slab of
        `capacity` slots (at least each state's own), in the model's dtype
        (states.place_states), and the write pointers set from the host's."""
        rows = states if isinstance(states, list) else [states]
        C = max([capacity] + [s.k.shape[2] for s in rows])
        with self.owner.lock:
            self.slab = None  # nothing of the last chunk is held for this one
            self.slab = self._slab(C)
            if not self.graphed:
                self.slabs = {C: self.slab}
        self.write_pos = place_states(self.slab.state(0), rows)
        self.slab.wp.fill_(self.write_pos)

    def state(self) -> StackState:
        """The lane's FlowLM state (views of its buffers)."""
        return self.slab.state(self.write_pos)

    def prompt(self, token_lists: list[list[int]], pad_to: int) -> None:
        """The text prompt over the slab (the JAX package's `_text_prompt_fn`):
        the rows' tokens right-padded to `pad_to`, then one prompt pass that
        appends pad_to slots at the device write pointer and advances each
        row's offset by its true length, all on the device. Graphed, one
        replay per call (captured once per (pad_to, C)), its input copied in
        from a pinned slot; op by op, the same body."""
        C = self.slab.k.shape[2]
        if not 0 <= self.write_pos <= C - pad_to:
            raise ValueError(f"a prompt of {pad_to} slots at write_pos {self.write_pos} "
                             f"overflows capacity {C}")
        host = np.zeros((self.B, pad_to + 1), np.int64)  # the tokens, then the true length
        for i, tokens in enumerate(token_lists):
            host[i, :len(tokens)] = tokens
            host[i, pad_to] = len(tokens)
        s = self.slab
        if not self.graphed:
            self._prompt_body(torch.from_numpy(host).to(self.model.device), s.offset, s.wp)
        else:
            graph = self._prompt_graph(pad_to)
            self.tickets.append(self.owner.upload(graph.tokens, host))
            self.owner.check()
            graph.replay()
            self.owner.replays += 1
        self.write_pos += pad_to

    def _prompt_body(self, tokens: torch.Tensor, offset: torch.Tensor,
                     wp: torch.Tensor) -> None:
        """The body a text-prompt graph holds: the pass over the slab's caches
        from `offset` and `wp`, both then advanced in place."""
        s = self.slab
        lm = self.model._text_prompt(StackState(s.k, s.v, s.pos, offset, self.write_pos, wp),
                                     tokens)
        offset.copy_(lm.offset)
        wp.copy_(lm.write_ptr)

    def _prompt_graph(self, pad_to: int) -> _PassGraph:
        """The text-prompt graph of `pad_to` tokens at this lane's capacity,
        captured if new, after a warm-up that writes only the pad_to slots
        the replay writes again (its offset and pointer are copies)."""
        s = self.slab
        key = (pad_to, s.k.shape[2])
        graph = self.prompts.get(key)
        if graph is None:
            tokens = torch.zeros((self.B, pad_to + 1), dtype=torch.int64, device=self.model.device)
            graph = _PassGraph(self.owner.stream, s,
                               lambda: self._prompt_body(tokens, s.offset.clone(), s.wp.clone()),
                               lambda: self._prompt_body(tokens, s.offset, s.wp))
            graph.tokens = tokens
            s.pool_bytes += tokens.numel() * tokens.element_size()
            with self.owner.lock:
                self.owner.keep(s, graph)
                self.prompts[key] = graph
        return graph

    def begin(self) -> None:
        """Start the blocks after the prompt: a fresh Mimi state, BOS on
        every row, no EOS yet and no frame decoded."""
        fresh = init_decoder_state(self.model.mimi_specs, self.B, self.model._dtype,
                                   self.model.device)
        for dst, src in zip(tree_leaves(self.mimi), tree_leaves(fresh)):
            dst.copy_(src)
        self.prev.zero_()
        self.is_bos.fill_(True)
        self.first_eos.fill_(NO_EOS)
        self.frames.zero_()

    def grow(self, capacity: int) -> None:
        """Move the caches to the slab of `capacity` slots (a larger bucket):
        expand_state's layout, into the lane's own buffers. The old slab goes
        at once op by op, and graphed when the budget has no room for it."""
        old = self.slab
        if capacity <= old.k.shape[2]:
            return
        with self.owner.lock:
            new = self._slab(capacity)
            place_states(new.state(0), [old.state(self.write_pos)])
            new.wp.copy_(old.wp)
            self.slab = new
            if not self.graphed:
                self.slabs = {capacity: new}
            else:
                self.owner.make_room(0)

    def warm_up(self, K: int, noise: torch.Tensor | None) -> None:
        """The block once, op by op, before its capture (see the module
        docstring): on the lane's caches, whose K slots from the write
        pointer it writes, and on copies of everything else it would change."""
        m = self.model
        s = self.slab
        if noise is None:
            noise = self._draw(torch.Generator(device=m.device).manual_seed(0), K)
        lm = StackState(s.k, s.v, s.pos, s.offset.clone(), self.write_pos, s.wp.clone())
        mimi = tree_map(torch.clone, self.mimi)
        m._decode_block(lm, mimi, self.prev.clone(), self.is_bos.clone(), noise)

    def _draw(self, gen: torch.Generator, K: int) -> torch.Tensor:
        """Device noise of one block for this lane's rows: [K, B_noise, ldim]
        drawn whole, this rank's rows kept."""
        return self.model._noise(gen, (K, self.B_noise, self.model.specs.ldim))[:, self.rows]

    def block(self, K: int, noise: torch.Tensor | None) -> torch.Tensor:
        """The body a graph holds: noise (drawn here when None), the block,
        the new state copied back into the lane's buffers, each row's first
        EOS step and the frame count advanced; returns pack_block's output."""
        m = self.model
        if noise is None:
            noise = self._draw(self.gen, K)
        latents, flags, audio, lm, mimi = m._decode_block(self.state(), self.mimi, self.prev,
                                                          self.is_bos, noise)
        self.slab.offset.copy_(lm.offset)
        self.slab.wp.copy_(lm.write_ptr)
        self.prev.copy_(latents[-1])
        self.is_bos.zero_()
        for dst, src in zip(tree_leaves(self.mimi), tree_leaves(mimi)):
            if dst is not src:
                dst.copy_(src)
        steps = self.frames + torch.arange(K, dtype=torch.int32, device=m.device)  # [K]
        first = torch.where(flags, steps[:, None], NO_EOS).amin(dim=0)
        torch.minimum(self.first_eos, first, out=self.first_eos)
        self.frames.add_(K)
        return pack_block(flags, audio)

    def _graph(self, K: int) -> _BlockGraph:
        """The graph of a block of K frames at this lane's capacity and the
        model's generation settings, captured if new."""
        g = self.model.gen
        injected = self.noise_source is not None
        key = (K, self.slab.k.shape[2], g.lsd_decode_steps, g.eos_threshold,
               "injected" if injected else ("device", g.temp, g.noise_clamp))
        graph = self.graphs.get(key)
        if graph is None:
            graph = _BlockGraph(self, K, injected)
            with self.owner.lock:
                self.owner.keep(self.slab, graph)
                self.graphs[key] = graph
        return graph

    def dispatch(self, K: int) -> Ticket:
        """Queue one block of K frames (captured first if its key is new
        when graphed) and return its ticket; op by op the block runs here."""
        m = self.model
        C = self.slab.k.shape[2]
        if not 0 <= self.write_pos <= C - K:
            raise ValueError(f"a block of {K} frames at write_pos {self.write_pos} overflows "
                             f"capacity {C}")
        self.tickets = [t for t in self.tickets if not (t.fetched or t.abandoned and t.done())]
        if not self.graphed:
            noise = (None if self.noise_source is None else torch.from_numpy(
                m._host_noise(self.noise_source, K, self.B_noise)[:, self.rows]).to(m.device))
            ticket = Ticket(K, out=self.block(K, noise).cpu().numpy())
        else:
            if self.flash and self.write_pos + K - 1 > MAX_ATT:
                raise NotImplementedError(f"flash_decode attends at most {MAX_ATT} slots "
                                          f"(write_pos {self.write_pos}, a block of {K})")
            graph = self._graph(K)
            ticket = Ticket(K)
            ticket.slot = self.owner.take_slot(ticket)
            if graph.noise is not None:
                host = ticket.slot.view("noise", tuple(graph.noise.shape))
                host.copy_(torch.from_numpy(
                    m._host_noise(self.noise_source, K, self.B_noise)[:, self.rows]))
                graph.noise.copy_(host, non_blocking=True)
            self.owner.check()
            graph.replay()
            self.owner.replays += 1
            ticket.shape = tuple(graph.out.shape)
            ticket.slot.view("out", ticket.shape).copy_(graph.out, non_blocking=True)
            if m.device.type == "cuda":
                ticket.event = torch.cuda.Event()
                ticket.event.record()
        self.tickets.append(ticket)
        self.write_pos += K
        m.decode_steps += K
        return ticket

    def fetch(self, ticket: Ticket) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched block: its EOS flags [K, B] and audio
        [K, B, S] on the host (the ticket's slot is then free)."""
        if ticket.event is not None:
            ticket.event.synchronize()
        out = ticket.out
        if ticket.slot is not None:
            out = ticket.slot.view("out", ticket.shape).numpy().copy()
            ticket.slot.ticket = None
        ticket.fetched = True
        return unpack_block(out)

    def abandon(self, ticket: Ticket) -> None:
        """A dispatched block whose output nobody reads (past the stop, or
        a stream closed early): its slot is free once the device is done."""
        ticket.abandoned = True

    def settle(self) -> None:
        """Wait until the device has finished every block dispatched in
        this lane (before a slab or graph of it may go)."""
        for t in self.tickets:
            if t.event is not None:
                t.event.synchronize()

    def trim(self, offset: torch.Tensor, token_count: int, frames_after_eos: int,
             max_gen_len: int) -> StackState:
        """The post-chunk state for copy_state=False, on the device (the JAX
        package's `_finalize_fn`): the caches in tensors of their own, the
        offset advanced from the chunk's starting `offset` by the prompt and
        every step the reference loop ran (each row's first EOS +
        frames_after_eos + the break step, at most max_gen_len; max_gen_len
        without an EOS before it), the slots at or past it masked
        (pos = -1); the write pointer the host's (every dispatched frame)."""
        s = self.state()
        first = self.first_eos
        stop = torch.where(first < max_gen_len,
                           torch.clamp(first + frames_after_eos + 1, max=max_gen_len),
                           max_gen_len)
        final_offset = (offset + token_count + stop).to(torch.int32)
        pos = torch.where(s.pos < final_offset[:, None], s.pos, -1)
        return StackState(s.k.clone(), s.v.clone(), pos, final_offset, s.write_pos)

    def drop(self, C: int) -> int:
        """Drop the slab of C slots and the graphs captured on it, once the
        device is done with them; its bytes."""
        self.settle()
        slab = self.slabs.pop(C)
        for graphs in (self.graphs, self.prompts):
            for key in [key for key in graphs if key[1] == C]:
                del graphs[key]
        if slab is self.slab:
            self.slab = None
        return slab.nbytes

    def close(self) -> None:
        """The stream is over (its tickets fetched or abandoned): the lane
        is free, and the idle slabs over the budget go."""
        with self.owner.lock:
            self.busy = False
            if self.graphed:
                self.owner.make_room(0)


@dataclasses.dataclass(eq=False)
class _Pass:
    """A pass the model keeps between requests, outside any lane (a voice
    prompt or the Mimi encoder): its fixed input and state buffers, its
    graph and the graph's own memory pool, and when a request last used it."""

    bufs: dict
    pool: tuple | None = None
    pool_bytes: int = 0
    graph: _PassGraph | None = None
    used: int = 0
    busy: bool = False
    event: torch.cuda.Event | None = None  # after the last replay's use

    @property
    def nbytes(self) -> int:
        return self.pool_bytes + sum(t.numel() * t.element_size()
                                     for t in tree_leaves(self.bufs))

    def settle(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class StepGraphs:
    """A model's lanes, by batch size, its pass graphs (voice prompt and
    encoder, by key), what they may keep (see the module docstring), and the
    host slots of the blocks and uploads in flight."""

    def __init__(self, model):
        self.model = model
        self.lanes: dict[int, list[Lane]] = {}
        self.passes: dict[tuple, _Pass] = {}
        self.stream = None  # the side stream every capture and warm-up runs on
        self.weights: tuple = ()  # the (params, mimi_params) the graphs were made for
        self.budget: int | None = None  # bytes kept; None: KEEP_FRACTION of the card
        self.replays = 0  # every replay of this model's graphs
        self.slots: list[_Slot] = []
        self._next_slot = 0
        self.lock = threading.RLock()
        self._tick = 0
        self.lost: str | None = None  # why the mesh's communicators were aborted
        self.abandoned: list = []  # the lanes and passes kept, not destroyed, since the abort

    def agree(self, *values) -> list[int]:
        """Each int (or bool), the largest any rank of the model's tensor-
        parallel group holds (parallel/mesh.max_over_model): the ranks whose
        graphs share collectives keep, drop and capture alike. Itself a host
        read, so it is called at captures and where room is made, never per
        block. Without such a group, the values. Raises once the mesh was
        lost (`check`): a collective on it would wait for the lost rank."""
        self.check()
        tp = self.model._tp
        return max_over_model([int(v) for v in values], tp, self.model.device)

    def keep(self, holder, graph) -> None:
        """Count a new capture's pool growth in `holder` (its slab or pass):
        the model group's largest, so every rank holds the same bytes."""
        graph.pool_bytes = self.agree(graph.pool_bytes)[0]
        holder.pool_bytes += graph.pool_bytes

    def check(self) -> None:
        """Raise once the mesh's communicators were aborted: no graph that
        holds them is replayed or captured again."""
        if self.lost is not None:
            raise RuntimeError(f"the mesh's communicators were aborted ({self.lost}): "
                               "its graphs are not replayed again")

    def abandon(self, reason: str) -> None:
        """The mesh's NCCL communicators were aborted (the server lost a
        follower, and set `lost` before the abort): every later replay,
        capture or agreement raises (`check`), and the lanes and passes go
        once the device is done with them (the abort ends a collective that
        waits on the lost peer). Their graphs are
        parked in `abandoned`, not destroyed: destroying a graph releases
        the NCCL work it holds against a communicator the abort tore down,
        and a degraded process serves nothing more with them."""
        self.lost = reason
        with self.lock:
            self.abandoned += [ln for lanes in self.lanes.values() for ln in lanes]
            self.abandoned += list(self.passes.values())
            self.release()

    def _graphing(self) -> None:
        """Before a graphed lane or pass is taken (under the lock): raises
        once the mesh's communicators were aborted (`abandon`); every graph
        is dropped when the model's weights are not the ones they were
        captured on; the capture stream and the default budget are made."""
        self.check()
        m = self.model
        weights = (m.params, m.mimi_params)
        if len(self.weights) != 2 or any(a is not b for a, b in zip(weights, self.weights)):
            self.release()
            self.weights = weights
        if self.stream is None and m.device.type == "cuda":
            self.stream = torch.cuda.Stream(m.device)
        if self.budget is None and m.device.type == "cuda":
            self.budget = int(KEEP_FRACTION
                              * torch.cuda.get_device_properties(m.device).total_memory)

    def acquire(self, B: int, rows: slice = slice(None), B_noise: int | None = None) -> Lane:
        """A lane for a stream of B rows, this rank's `rows` of a batch of
        `B_noise` (its noise is set per chunk, Lane.start). Graphed
        (model._graphed()): a free lane of the model's for (B, rows,
        B_noise) (a new one when every such lane is held; every lane is
        dropped first when the model's weights are not the ones the graphs
        were captured on). Else a lane of its own, kept by nobody."""
        m = self.model
        if not m._graphed():
            lane = Lane(self, B, False, rows, B_noise)
            lane.busy = True
            return lane
        with self.lock:
            self._graphing()
            B_noise = B if B_noise is None else B_noise
            lanes = self.lanes.setdefault((B, rows.start, rows.stop, B_noise), [])
            lane = next((ln for ln in lanes if not ln.busy), None)
            if lane is None:
                lane = Lane(self, B, True, rows, B_noise)
                lanes.append(lane)
            lane.busy = True
            return lane

    def run_pass(self, key: tuple, make, fill, body, take):
        """One pass outside the lanes (a voice prompt or the Mimi encoder):
        `make()` gives its fixed buffers (a dict of tensors), `fill(bufs)`
        copies the call's input into them, `body(bufs)` is the pass (no
        host read), and `take(out)` copies its result into tensors of the
        caller's. Graphed: the buffers and the graph of `key` are kept
        (captured after one op-by-op warm-up of the body, in a pool of their
        own, within the budget) and every call is a fill, one replay and the
        take, under the lock (the server's threads share them). Op by op:
        fresh buffers and the body, each call."""
        if not self.model._graphed():
            bufs = make()
            fill(bufs)
            return take(body(bufs))
        with self.lock:
            self._graphing()
            entry = self.passes.get(key)
            if entry is None:
                entry = _Pass(make())
                self.make_room(entry.nbytes)
                entry.graph = _PassGraph(self.stream, entry, lambda: body(entry.bufs),
                                         lambda: body(entry.bufs))
                self.keep(entry, entry.graph)
                self.passes[key] = entry
            entry.used = self.tick()
            entry.busy = True
            try:
                fill(entry.bufs)
                self.check()
                entry.graph.replay()
                self.replays += 1
                out = take(entry.graph.out)
                if self.model.device.type == "cuda":
                    entry.event = torch.cuda.Event()
                    entry.event.record()
            finally:
                entry.busy = False
            self.make_room(0)
            return out

    def upload(self, dst: torch.Tensor, host: np.ndarray) -> Ticket:
        """Copy `host` into the device buffer `dst` through a pinned slot of
        the ring (non-blocking, on the current stream); returns the copy's
        ticket, abandoned: its slot is free once the copy is done."""
        ticket = Ticket(0, abandoned=True)
        slot = ticket.slot = self.take_slot(ticket)
        src = slot.view("in", tuple(host.shape), dst.dtype)
        src.copy_(torch.from_numpy(np.ascontiguousarray(host)))
        dst.copy_(src, non_blocking=True)
        if self.model.device.type == "cuda":
            ticket.event = torch.cuda.Event()
            ticket.event.record()
        return ticket

    def take_slot(self, ticket: Ticket) -> _Slot:
        """The next free slot of the ring (a new one when every slot is
        held), now held by `ticket`."""
        with self.lock:
            n = len(self.slots)
            i = next((j % n for j in range(self._next_slot, self._next_slot + n)
                      if self.slots[j % n].free()), None)
            if i is None:
                i = n
                self.slots.append(_Slot(pinned=self.model.device.type == "cuda"))
            self._next_slot = (i + 1) % len(self.slots)
            self.slots[i].ticket = ticket
            return self.slots[i]

    def tick(self) -> int:
        self._tick += 1
        return self._tick

    def held(self) -> int:
        """Bytes kept: the lanes' caches, graph pools and own buffers, and
        the passes' buffers and pools."""
        return (sum(lane.nbytes for lanes in self.lanes.values() for lane in lanes)
                + sum(p.nbytes for p in self.passes.values()))

    def _drop_pass(self, key: tuple) -> int:
        entry = self.passes.pop(key)
        entry.settle()
        return entry.nbytes

    def make_room(self, nbytes: int, budget: int | None = None) -> None:
        """Drop idle slabs and passes, least recently used first, until what
        is held and `nbytes` more fit `budget` (default: self.budget; under
        tensor parallelism the least budget of the model group, `agree`);
        then the idle lanes left with no slab. A slab is idle unless it is
        the current slab of a lane a stream holds; a pass unless it is
        running. Nothing is made room for once the mesh was lost."""
        if self.lost is not None:
            return
        budget = self.budget if budget is None else budget
        unbounded = 2**62
        budget = -self.agree(-(unbounded if budget is None else budget))[0]
        if budget >= unbounded:
            return
        with self.lock:
            held = self.held()
            idle = ([(s.used, lambda lane=lane, C=C: lane.drop(C))
                     for lanes in self.lanes.values() for lane in lanes
                     for C, s in lane.slabs.items() if not (lane.busy and s is lane.slab)]
                    + [(p.used, lambda key=key: self._drop_pass(key))
                       for key, p in self.passes.items() if not p.busy])
            for _, drop in sorted(idle, key=lambda t: t[0]):
                if held + nbytes <= budget:
                    break
                held -= drop()
            for B in list(self.lanes):
                self.lanes[B] = [ln for ln in self.lanes[B] if ln.busy or ln.slabs]
                if not self.lanes[B]:
                    del self.lanes[B]

    def release(self) -> None:
        """Drop every lane and pass: the graphs, their pools and the buffers."""
        with self.lock:
            for lanes in self.lanes.values():
                for lane in lanes:
                    lane.settle()
            self.lanes.clear()
            for key in list(self.passes):
                self._drop_pass(key)

    def stats(self) -> list[dict]:
        """Per kept block graph: B, its lane's rows and B_noise, K, C, the
        noise kind, its warm-up's and its capture's seconds, replays and the
        kernel launches of one replay."""
        with self.lock:
            return [dict(B=lane.B, rows=(lane.rows.start, lane.rows.stop), B_noise=lane.B_noise,
                         K=key[0], C=key[1], noise=key[4] if key[4] == "injected"
                         else "device", warmup_s=g.warmup_s, capture_s=g.capture_s,
                         replays=g.replays, launches=dict(g.launches))
                    for lanes in self.lanes.values() for lane in lanes
                    for key, g in lane.graphs.items()]

    def pass_stats(self) -> list[dict]:
        """Per kept prompt or encoder graph: its kind ("text", a lane's
        text prompt by pad_to and C; "voice", a voice prompt by B, pad_to and
        C; "encode", the Mimi encoder by B and frame bucket), its key, its
        warm-up's and capture's seconds, replays, the kernel launches of one
        replay, and the bytes it keeps (a text prompt's: its pool's growth in
        its slab's pool and its input buffer)."""
        with self.lock:
            out = [dict(kind="text", key=(lane.B,) + key, warmup_s=g.warmup_s,
                        capture_s=g.capture_s, replays=g.replays, launches=dict(g.launches),
                        nbytes=g.pool_bytes + g.tokens.numel() * g.tokens.element_size())
                   for lanes in self.lanes.values() for lane in lanes
                   for key, g in lane.prompts.items()]
            return out + [dict(kind=key[0], key=key[1:], warmup_s=p.graph.warmup_s,
                               capture_s=p.graph.capture_s, replays=p.graph.replays,
                               launches=dict(p.graph.launches), nbytes=p.nbytes)
                          for key, p in self.passes.items()]

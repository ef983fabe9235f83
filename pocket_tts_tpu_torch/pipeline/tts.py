"""TTS pipeline orchestrator: the public TTSModel.
Port of pocket_tts_tpu/pipeline/tts.py (`load_model`, the voice states,
`generate_audio`, `generate_audio_stream(_from_tokens)`,
`generate_audio_batch(_from_texts)` and the pieces they run).

`load_model` reads the config's safetensors checkpoint (core/weights.py, the
JAX package's key names, so one file loads in both packages), falling back
to the checkpoint without the voice-cloning weights. A voice state is the
FlowLM KV cache after one prompt pass over the speaker conditioning: from a
wav (read, truncated, downmixed, resampled to 24 kHz), through the Mimi
encoder (plain PyTorch, models/mimi.encode_to_latent) and the speaker
projection, or imported from a `.safetensors` export.

Per sentence chunk: the text prompt fills the KV cache (a T>1 pass), then
frames are decoded in blocks of K (the `_block_size` ramp: single frames
first for first-chunk latency, then 8, then 32). Each frame runs the FlowLM
decode step (the decode-stack kernel on the card) and the flow head; each
block's latents then go through the Mimi decoder in one call (the codec
kernel on the card), and the block's EOS flags and audio come to the host
with one copy. Emission follows the JAX package exactly (`_ChunkEmit`): the
frames after the first EOS, the frames-after-EOS allowance and the break
step. The JAX package overlaps those copies with later dispatches on a
background thread (`_FetchPipe`); here each block is copied when it is done.

A deliberate difference follows: with EOS on, the JAX package keeps
dispatching speculative blocks until its fetch thread resolves the EOS
block, so how many frames it asks of a `noise_source` depends on when its
fetches complete; the port stops at the first block that shows EOS. A
shared sequential source therefore feeds a later chunk other noise on the
two sides. The emitted frames and offsets agree wherever the noise is keyed
by (chunk, frame); the speculative slots (masked) move the JAX package's
slot watermark past the port's.

Batched generation (`generate_audio_batch`) runs B utterances as the rows of
one state: one prompt pass over right-padded token rows with per-row true
lengths, then the same block ramp for all rows (the FlowLM step on the
flash-decode and gemv kernels on the card), with per-row EOS latching; each
row's audio is cut at its own frame. `load_model(quantize=...)` makes the
FlowLM's weights int8 (quant.py): the decode stack's int8 rows at B=1, the
gemv kernel's at B>1.

State: the KV append is in place (nn/transformer.py), so every chunk starts
from a copy of the voice state, in the model's dtype: with copy_state=True
(the default) the caller's state is left bit-unchanged; with
copy_state=False it receives the post-chunk state, trimmed to the steps the
reference loop would have run.

Entry points run on CUDA unless the caller passes device="cpu"; there is no
silent move to the CPU.

Sharded serving (`shard_for_mesh`, parallel/mesh.py): one process per device
on a ('data', 'model') mesh. `generate_audio_batch` splits the batch's rows
over `data` in contiguous blocks; each data rank takes its rows of the
full-batch noise (so the audio does not depend on the sharding), decodes
them, and every process returns every row (an all-gather). With
`tensor_parallel=True` the FlowLM backbone and its KV heads split over
`model` and each layer's two all-reduces join the ranks of a model group at
every step; the flow head and Mimi are replicated. All ranks of a model
group must then stop at the same step: the EOS flags are reduced over the
group before any host decision reads them. They must also draw the same
noise (the replicated flow head's latent is the next step's input): without
a seed or a noise_source, the mesh's first rank picks the seed and sends it
to the others. Under any mesh the decode stack is refused, as in the JAX
package: a b1 step takes the layer loop (flash decode and the gemv op at the
rank's shapes).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from pocket_tts_tpu_torch.config import CONFIGS_DIR, Config, load_config
from pocket_tts_tpu_torch.core.bridge import to_numpy, to_torch
from pocket_tts_tpu_torch.core.hub import (
    PREDEFINED_VOICE_ORIGINS,
    download_if_necessary,
    get_predefined_voice,
)
from pocket_tts_tpu_torch.core.tree import tree_map
from pocket_tts_tpu_torch.core.typecheck import typechecked
from pocket_tts_tpu_torch.core.weights import (
    flow_lm_params_from_sd,
    load_safetensors,
    mimi_params_from_sd,
    save_combined_checkpoint,
)
from pocket_tts_tpu_torch.default_parameters import (
    DEFAULT_EOS_THRESHOLD,
    DEFAULT_LANGUAGE,
    DEFAULT_LSD_DECODE_STEPS,
    DEFAULT_NOISE_CLAMP,
    DEFAULT_TEMPERATURE,
    MAX_TOKEN_PER_CHUNK,
)
from pocket_tts_tpu_torch.io.audio import audio_read, convert_audio
from pocket_tts_tpu_torch.models.flow_lm import (
    FlowLMSpecs,
    build_flow_lm_specs,
    decode_step,
    embed_text_tokens,
    init_flow_lm_params,
    init_flow_lm_state,
    prompt_step,
)
from pocket_tts_tpu_torch.models.mimi import (
    MimiSpecs,
    build_mimi_specs,
    decoder_step,
    encode_to_latent,
    init_decoder_state,
    init_mimi_params,
    project_latent,
)
from pocket_tts_tpu_torch.nn.transformer import StackState
from pocket_tts_tpu_torch.ops.codec_decode import pack_decoder_params
from pocket_tts_tpu_torch.parallel.mesh import (
    any_over_model,
    broadcast_seed,
    data_rows,
    gather_rows,
    gather_state,
    mesh_groups,
    model_group,
    shard_state,
    shard_transformer_params,
)
from pocket_tts_tpu_torch.pipeline.states import (
    batch_states,
    expand_state,
    export_model_state,
    import_model_state,
)
from pocket_tts_tpu_torch.quant import (
    RECOMMENDED_CONFIG,
    quantize_flow_lm_int8,
    resolve_config,
)
from pocket_tts_tpu_torch.text.native import best_tokenizer
from pocket_tts_tpu_torch.text.splitter import prepare_text_prompt, split_into_best_sentences

logger = logging.getLogger(__name__)

VOICE_CLONING_UNSUPPORTED = (
    "Could not load the voice-cloning weights, but voice cloning was requested. "
    f"Without them you can use the predefined voice catalog: "
    f"{list(PREDEFINED_VOICE_ORIGINS)}."
)

# KV-capacity and prompt-length buckets, as in the JAX package
CAPACITY_BUCKETS = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)
PROMPT_BUCKETS = (8, 16, 32, 64, 128, 192, 256, 384, 512)
FIRST_BLOCK_FRAMES = 2  # single-frame blocks up front (first-chunk latency)
SCAN_BLOCK_FRAMES = 8  # frames per block while the stream ramps up
MAX_BLOCK_FRAMES = 32  # steady-state frames per block (2.56 s of audio)
RAMP_FRAMES = FIRST_BLOCK_FRAMES + 4 * SCAN_BLOCK_FRAMES


def _block_size(frames_started: int, warm: bool = False) -> int:
    """Block ramp: single frames for first-chunk latency, 8-frame blocks while
    the stream builds its buffer, then 32-frame blocks. `warm`: the stream
    already has buffered audio (chunks after the first), so start at 32."""
    if warm:
        return MAX_BLOCK_FRAMES
    if frames_started < FIRST_BLOCK_FRAMES:
        return 1
    if frames_started < RAMP_FRAMES:
        return SCAN_BLOCK_FRAMES
    return MAX_BLOCK_FRAMES


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


def _fresh_seed() -> int:
    return int(np.random.SeedSequence().entropy % (2**31))


@dataclasses.dataclass
class GenerationParams:
    temp: float = DEFAULT_TEMPERATURE
    lsd_decode_steps: int = DEFAULT_LSD_DECODE_STEPS
    noise_clamp: float | None = DEFAULT_NOISE_CLAMP
    eos_threshold: float = DEFAULT_EOS_THRESHOLD


class NoiseSource:
    """Host flow-noise stream: N(0, temp) with optional truncation (the JAX
    package's NoiseSource). Tests inject recorded streams in its place."""

    def __init__(self, params: GenerationParams, seed: int | None):
        self.params = params
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape) -> np.ndarray:
        std = self.params.temp**0.5
        if self.params.noise_clamp is None:
            return (self.rng.standard_normal(shape) * std).astype(np.float32)
        from scipy.stats import truncnorm

        a = -self.params.noise_clamp / std
        b = self.params.noise_clamp / std
        return truncnorm.rvs(a, b, scale=std, size=shape,
                             random_state=self.rng).astype(np.float32)


class _ChunkEmit:
    """Per-chunk emission accounting (the JAX package's rule): blocks resolve
    through `emit` in order; `finish` applies the no-EOS contract."""

    def __init__(self, max_gen_len: int, frames_after_eos: int):
        self.max_gen_len = max_gen_len
        self.frames_after_eos = frames_after_eos
        self.eos_step: int | None = None
        self.emitted = 0
        self.stop = False
        self.frames_started = 0

    def emit(self, block_start: int, flags, audio, out: list) -> None:
        if self.stop:
            return
        flags = np.asarray(flags)  # [K, B] or [B]
        audio = np.asarray(audio)
        K = flags.shape[0] if flags.ndim == 2 else 1
        for i in range(K):
            s = block_start + i
            if s >= self.max_gen_len:
                break
            flag = bool(flags[i, 0] if flags.ndim == 2 else flags[0])
            if flag and self.eos_step is None:
                self.eos_step = s
            if self.eos_step is not None and s >= self.eos_step + self.frames_after_eos:
                self.stop = True  # the break step s is still executed
                return
            self.emitted += 1
            out.append(audio[i, 0, 0] if audio.ndim == 4 else audio[0, 0])

    def finish(self) -> None:
        if self.eos_step is None and self.frames_started >= self.max_gen_len:
            if os.environ.get("POCKET_TTS_ERROR_WITHOUT_EOS", "0") == "1":
                raise RuntimeError("Generation reached maximum length without EOS!")
            logger.warning("Maximum generation length reached without EOS; "
                           "this very often indicates an error.")


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("No CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


class TTSModel:
    """End-to-end streaming TTS: text -> 24 kHz waveform chunks."""

    _TOKENS_PER_SECOND_ESTIMATE = 3.0
    _GEN_SECONDS_PADDING = 2.0

    def __init__(
        self,
        specs: FlowLMSpecs,
        mimi_specs: MimiSpecs,
        params: dict,
        mimi_params: dict,
        tokenizer,
        config: Config,
        gen_params: GenerationParams,
        device: torch.device,
        origin: Path | None = None,
    ):
        self.specs = specs
        self.mimi_specs = mimi_specs
        self.params = params
        # the bf16 codec kernel's weight layout, packed once per model from
        # the final decoder weights (never taken from the caller's dict); the
        # f32 kernel reads the torch layout
        self.mimi_params = dict(mimi_params)
        if mimi_params["decoder"]["0"].weight.dtype == torch.bfloat16:
            self.mimi_params["decoder_packed"] = pack_decoder_params(mimi_specs.decoder,
                                                                     mimi_params["decoder"])
        self.tokenizer = tokenizer
        self.config = config
        self.gen = gen_params
        self._device = torch.device(device)
        self.origin = origin
        self.has_voice_cloning = True
        self._voice_state_cache: dict[str, StackState] = {}
        self.pad_with_spaces_for_short_inputs = config.pad_with_spaces_for_short_inputs
        self.remove_semicolons = config.remove_semicolons
        self.model_recommended_frames_after_eos = config.model_recommended_frames_after_eos
        self.decode_steps = 0  # FlowLM decode steps run by this model (all requests)
        self.mesh = None  # set by shard_for_mesh for sharded serving

    @property
    def _dtype(self) -> torch.dtype:
        """The activation and cache dtype (int8 weights keep it)."""
        return self.params["input_linear"].dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def sample_rate(self) -> int:
        return self.config.mimi.sample_rate

    @property
    def frame_rate(self) -> float:
        return self.config.mimi.frame_rate

    @property
    def samples_per_frame(self) -> int:
        return self.mimi_specs.frame_size

    # ------------------------------------------------------------------ load

    @classmethod
    @typechecked(
        language=(str, None), config=(str, Path, None),
        temp=(float, int), lsd_decode_steps=int,
        noise_clamp=(float, int, None), eos_threshold=(float, int),
        quantize=bool, quantize_config=(str, frozenset, set, None),
        allow_random_init=bool, param_dtype=str, device=(str, torch.device, None),
    )
    def load_model(
        cls,
        language: str | None = None,
        config: str | Path | None = None,
        temp: float = DEFAULT_TEMPERATURE,
        lsd_decode_steps: int = DEFAULT_LSD_DECODE_STEPS,
        noise_clamp: float | None = DEFAULT_NOISE_CLAMP,
        eos_threshold: float = DEFAULT_EOS_THRESHOLD,
        quantize: bool = False,
        quantize_config: str | frozenset | set | None = None,
        allow_random_init: bool = False,
        param_dtype: str = "float32",
        device: str | torch.device | None = None,
    ) -> "TTSModel":
        """Load a model from a language or a YAML config.

        The weights come from the config's `weights_path`, a safetensors
        checkpoint (a local path, http(s) or hf://); when it cannot be read,
        from `weights_path_without_voice_cloning`, and the model then cannot
        clone a voice from audio (`has_voice_cloning` is False).
        `allow_random_init=True` builds the model with random weights when
        neither is reachable (or the config names none): a torch generator
        seeded with 0, the JAX package's shapes and distributions, not its
        bits. Without it a missing checkpoint raises.
        `param_dtype`: "float32" or "bfloat16" (serving); the flow head and
        all norm/softmax math stay f32 either way. `quantize_config`: which
        groups to make int8 (a named config such as "attention_ffn", the
        default, or "all", or a set of groups); setting it implies
        `quantize=True`. `device`: CUDA unless "cpu" is asked for.
        With POCKET_TTS_SAVE_WEIGHTS=1 in the environment the weights, cast to
        `param_dtype` and before int8 quantization, are written to
        ./model.safetensors (as f32 values, the JAX package's key names)."""
        if config is not None and language is not None:
            raise ValueError("Cannot specify both config and language.")
        if config is None:
            language = language or DEFAULT_LANGUAGE
            if language == "french":
                raise ValueError("Only a larger 24-layer model is available for French; "
                                 "use the 'french_24l' language instead.")
            config = CONFIGS_DIR / f"{language}.yaml"
        config_path = Path(config)
        if config_path.suffix not in (".yaml", ".yml"):
            raise ValueError("Config should be a path to a YAML file ending with .yaml")
        cfg = load_config(config_path)
        dev = _default_device() if device is None else torch.device(device)
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]

        specs = build_flow_lm_specs(cfg)
        mimi_specs = build_mimi_specs(cfg.mimi)
        gen = GenerationParams(temp, lsd_decode_steps, noise_clamp, eos_threshold)

        tokenizer = None
        try:
            tok_path = download_if_necessary(cfg.flow_lm.lookup_table.tokenizer_path)
            tokenizer = best_tokenizer(cfg.flow_lm.lookup_table.n_bins, tok_path)
        except Exception as e:  # offline or missing
            logger.warning("Tokenizer unavailable (%s); text APIs need token ids.", e)

        sd = None
        has_voice_cloning = True
        if cfg.weights_path is not None:
            try:
                sd = load_safetensors(download_if_necessary(cfg.weights_path))
            except Exception:
                try:
                    sd = load_safetensors(
                        download_if_necessary(cfg.weights_path_without_voice_cloning))
                    has_voice_cloning = False
                except Exception as e:
                    if not allow_random_init:
                        raise
                    logger.warning("Weights unavailable (%s); using random init.", e)
        if sd is not None:
            params = to_torch(flow_lm_params_from_sd(specs.transformer, specs.flow, sd,
                                                     prefix="flow_lm."), dev)
            mimi_params = to_torch(mimi_params_from_sd(mimi_specs, sd, prefix="mimi."), dev)
        elif allow_random_init:
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            params = init_flow_lm_params(specs, g, torch.float32, dev)
            mimi_params = init_mimi_params(mimi_specs, g, torch.float32, dev)
        else:
            raise ValueError(f"{config_path} names no checkpoint (weights_path is null); "
                             "pass allow_random_init=True for random weights")
        if dtype != torch.float32:  # every f32 leaf, as the JAX package casts

            def cast(t):
                return t.to(dtype) if t.dtype == torch.float32 else t

            params, mimi_params = tree_map(cast, params), tree_map(cast, mimi_params)
        if os.environ.get("POCKET_TTS_SAVE_WEIGHTS", "0") == "1":
            save_combined_checkpoint("./model.safetensors", to_numpy(params), mimi_specs,
                                     to_numpy(mimi_params))
            logger.info("Saved model weights to ./model.safetensors")
        if quantize or quantize_config is not None:
            groups = (RECOMMENDED_CONFIG if quantize_config is None
                      else resolve_config(quantize_config))
            params = quantize_flow_lm_int8(params, groups)
        model = cls(specs, mimi_specs, params, mimi_params, tokenizer, cfg, gen, dev,
                    origin=config_path)
        model.has_voice_cloning = has_voice_cloning
        return model

    # ------------------------------------------------------------- voice state

    def init_blank_state(self, batch_size: int = 1, capacity: int = 256) -> StackState:
        return init_flow_lm_state(self.specs, batch_size, capacity, self._dtype, self.device)

    @typechecked(audio_conditioning=(str, Path, np.ndarray), truncate=bool)
    def get_state_for_audio_prompt(self, audio_conditioning: str | Path | np.ndarray,
                                   truncate: bool = False) -> StackState:
        """The voice state from a `.safetensors` export, a predefined voice's
        name, a wav (path or URL: the first 30 s when `truncate`, downmixed,
        resampled to the model's rate) or an audio array (see
        state_for_audio_array)."""
        if isinstance(audio_conditioning, np.ndarray):
            return self.state_for_audio_array(audio_conditioning)
        kind, value = self.resolve_voice(audio_conditioning, truncate)
        return self.import_state(value) if kind == "state" else self.state_for_audio_array(value)

    def resolve_voice(self, audio_conditioning: str | Path,
                      truncate: bool = False) -> tuple[str, object]:
        """The host half of get_state_for_audio_prompt: reads (or fetches)
        what a voice names and does no device work. Returns ("state", path
        of a `.safetensors` export: a file or a predefined voice) or
        ("audio", float32 [1, T] at the model's sample rate: a wav, the
        first 30 s when `truncate`, downmixed and resampled)."""
        if str(audio_conditioning).endswith(".safetensors"):
            return "state", download_if_necessary(str(audio_conditioning))
        if isinstance(audio_conditioning, str) and audio_conditioning in PREDEFINED_VOICE_ORIGINS:
            if self.origin is None or not Path(self.origin).is_relative_to(CONFIGS_DIR):
                raise ValueError("Predefined voices need a model loaded from a language "
                                 f"config; origin is {self.origin}")
            return "state", download_if_necessary(get_predefined_voice(
                language=Path(self.origin).stem, name=audio_conditioning))
        if not self.has_voice_cloning:
            raise ValueError(VOICE_CLONING_UNSUPPORTED)
        audio, sr = audio_read(download_if_necessary(str(audio_conditioning)))
        if truncate:
            max_samples = int(30 * sr)
            if audio.shape[-1] > max_samples:
                audio = audio[..., :max_samples]
        return "audio", convert_audio(audio, sr, self.sample_rate, 1)

    def state_for_audio_array(self, audio: np.ndarray) -> StackState:
        """audio: [1, T] or [B, 1, T] float32 at the model's sample rate:
        voice_conditioning, then the prompt pass of state_for_conditioning."""
        return self.state_for_conditioning(self.voice_conditioning(audio))

    def voice_conditioning(self, audio: np.ndarray) -> torch.Tensor:
        """The Mimi encoder's latents of audio [1, T] or [B, 1, T] (in the
        Mimi weights' dtype), projected into backbone space in f32 by the
        speaker projection: [B, frames, D]. Mimi and the projection are
        whole on every rank of a mesh, so this runs no collective."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 2:
            audio = audio[None]
        x = torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)
        latent = encode_to_latent(self.mimi_specs, self.mimi_params, x)  # [B, C, frames]
        return torch.einsum("bct,dc->btd", latent.float(),
                            self.params["speaker_proj_weight"].float())

    def cached_get_state_for_audio_prompt(self, audio_conditioning: str,
                                          truncate: bool = False) -> StackState:
        """get_state_for_audio_prompt behind a true LRU(2) (cached_state)."""
        return self.cached_state(f"{audio_conditioning}|{truncate}",
                                 lambda: self.get_state_for_audio_prompt(audio_conditioning,
                                                                         truncate))

    def cached_state(self, key: str, build: Callable[[], StackState]) -> StackState:
        """The LRU(2) of voice states: a hit moves `key` to most recently
        used, so alternating between two voices never evicts the hot one; a
        miss evicts the least recently used entry, then stores `build()`.
        Requests copy the state they are given, so an entry stays as it was
        built. The sharded server keeps every rank's keys in one order by
        calling this in the same sequence on each."""
        cache = self._voice_state_cache
        if key in cache:
            cache[key] = cache.pop(key)  # move to the end: most recently used
        else:
            if len(cache) >= 2:
                cache.pop(next(iter(cache)))  # evict the least recently used
            cache[key] = build()
        return cache[key]

    def state_for_conditioning(self, cond: torch.Tensor) -> StackState:
        """Voice state from conditioning already in backbone space [B, T, D]
        (the speaker projection of an encoded voice): one prompt pass into a
        fresh cache. As in the JAX package the conditioning stays f32 through
        the prompt pass (the cache takes the model dtype)."""
        cond = cond.to(self.device, torch.float32)
        B, prompt_len, D = cond.shape
        if self.specs.insert_bos_before_voice:
            bos = self.params["bos_before_voice"].expand(B, 1, D)
            cond = torch.cat([bos.to(cond.dtype), cond], dim=1)
            prompt_len += 1
        pad_to = _bucket(prompt_len, PROMPT_BUCKETS)
        padded = torch.zeros((B, pad_to, D), dtype=cond.dtype, device=self.device)
        padded[:, :prompt_len] = cond
        state = self.init_blank_state(B, _bucket(pad_to, CAPACITY_BUCKETS))
        return prompt_step(self.specs, self.params, state, padded, true_len=prompt_len)

    def import_state(self, source: str | Path) -> StackState:
        """A state file (all heads), cut to this rank's heads under tensor
        parallelism."""
        state = import_model_state(source, dtype=self._dtype, device=self.device)
        return state if self._tp is None else shard_state(state, self._tp)

    def export_model_state(self, state: StackState, dest: str | Path) -> None:
        """Write `state` in the file format. Under tensor parallelism every
        rank of the model group calls it: the heads are gathered, so the file
        is the same whatever the mesh, and the group's first rank writes it
        before any rank returns."""
        tp = self._tp
        if tp is None or tp.size == 1:
            export_model_state(state, dest)
            return
        full = gather_state(state, tp)
        if tp.rank == 0:
            export_model_state(full, dest)
        dist.barrier(group=tp.group)

    # ----------------------------------------------------------------- sharding

    @property
    def _tp(self):
        return self.specs.transformer.tp

    def _seed(self, seed: int | None, groups: list) -> int:
        """`seed`, or a fresh one that every rank of `groups` shares."""
        if seed is not None:
            return seed
        return broadcast_seed(_fresh_seed(), groups, self.device)

    def shard_for_mesh(self, mesh, tensor_parallel: bool = False) -> None:
        """Prepare this process for sharded serving on `mesh`
        (parallel/mesh.make_mesh). DP always: generate_audio_batch splits
        its rows over `data`. TP (`tensor_parallel=True`): this rank keeps
        its heads of the FlowLM backbone (and of the KV cache) and its share
        of the feed-forward features, over `model`; the flow head and Mimi
        stay whole. Voice states made before the call do not fit a TP model:
        build or import them after it."""
        if self.mesh is not None:
            raise ValueError("the model is already sharded")
        tp = model_group(mesh, tensor_parallel)
        cfg = self.specs.transformer
        self.params = {**self.params, "transformer": shard_transformer_params(
            self.params["transformer"], cfg.num_heads, tp)}
        self.specs = dataclasses.replace(self.specs, transformer=cfg._replace(tp=tp))
        self.mesh = mesh
        self._voice_state_cache.clear()

    # -------------------------------------------------------------- generation

    def _estimate_max_gen_len(self, token_count: int) -> int:
        gen_len_sec = token_count / self._TOKENS_PER_SECOND_ESTIMATE + self._GEN_SECONDS_PADDING
        return math.ceil(gen_len_sec * self.frame_rate)

    def _encode_text(self, text: str) -> list[int]:
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer available: the config's tokenizer_path "
                               "must be a local file.")
        return self.tokenizer.encode(text)

    def _ensure_capacity(self, lm_state: StackState, slots_needed: int) -> StackState:
        """Progressive capacity growth: pad the cache up to the smallest bucket
        covering `slots_needed`; never shrinks. Under a mesh the cache is
        this rank's own (its rows and heads) and grows in place of a
        re-shard."""
        cap = _bucket(slots_needed, CAPACITY_BUCKETS)
        return expand_state(lm_state, cap) if cap > lm_state.k.shape[2] else lm_state

    def _working_state(self, state: StackState, capacity: int,
                       fresh: bool = False) -> StackState:
        """`state` grown to `capacity` slots, in the model's dtype, in tensors
        of its own: the in-place KV append must not reach the caller's state.
        `fresh`: `state` is already a copy (batch_states' output)."""
        st = expand_state(state, capacity)
        if (st is state and not fresh) or st.k.dtype != self._dtype:
            st = StackState(st.k.to(self._dtype, copy=True), st.v.to(self._dtype, copy=True),
                            st.pos.clone(), st.offset.clone(), st.write_pos)
        return st

    def _block_noise(self, gen: torch.Generator | None, noise_source: Callable | None,
                     K: int, B: int) -> torch.Tensor:
        """[K, B, ldim] flow noise for one block: drawn on the device, or asked
        of `noise_source` as (B, ldim) when K=1 and (K, B, ldim) otherwise."""
        ldim = self.specs.ldim
        if noise_source is None:
            return self._noise(gen, (K, B, ldim))
        noise = noise_source((B, ldim) if K == 1 else (K, B, ldim))
        return torch.as_tensor(noise, dtype=torch.float32).reshape(K, B, ldim).to(self.device)

    def _decode_block(self, lm_state: StackState, mimi_state: dict, prev_latent: torch.Tensor,
                      is_bos: torch.Tensor, noise: torch.Tensor):
        """K frames for every row: K FlowLM decode steps (is_bos applies to the
        first), then the block's latents through the Mimi decoder in one call.
        Returns (last latent [B, ldim], EOS flags [K, B], audio [K, B, 1, 1920],
        lm_state, mimi_state)."""
        K, B = noise.shape[0], noise.shape[1]
        latents, flags = [], []
        for i in range(K):
            latent, eos, lm_state = decode_step(
                self.specs, self.params, lm_state, prev_latent, is_bos, noise[i],
                lsd_steps=self.gen.lsd_decode_steps, eos_threshold=self.gen.eos_threshold)
            latents.append(latent)
            flags.append(eos)
            prev_latent = latent
            is_bos = torch.zeros_like(is_bos)
        self.decode_steps += K
        flags = any_over_model(torch.stack(flags), self._tp)  # one stop decision per group
        stacked = torch.stack(latents)  # [K, B, ldim]
        denorm = stacked * self.params["emb_std"] + self.params["emb_mean"]
        quantized = project_latent(self.mimi_specs, self.mimi_params,
                                   denorm.permute(1, 2, 0))  # [B, 512, K]
        audio, mimi_state = decoder_step(self.mimi_specs, self.mimi_params, quantized,
                                         mimi_state)  # [B, 1, K*1920]
        audio = audio.reshape(B, 1, K, -1).permute(2, 0, 1, 3)  # [K, B, 1, 1920]
        return prev_latent, flags, audio, lm_state, mimi_state

    def _noise(self, gen: torch.Generator, shape) -> torch.Tensor:
        """Flow noise on the device: N(0, temp), truncated to ±noise_clamp by
        resampling (the JAX package's device noise has the same law)."""
        std = self.gen.temp ** 0.5
        z = torch.randn(shape, generator=gen, device=self.device)
        if self.gen.noise_clamp is not None:
            c = self.gen.noise_clamp / std
            bad = z.abs() > c
            while bool(bad.any()):
                z = torch.where(bad, torch.randn(shape, generator=gen, device=self.device), z)
                bad = z.abs() > c
        return z * std

    @typechecked(
        model_state=StackState, text_to_generate=str, max_tokens=int,
        frames_after_eos=(int, None), copy_state=bool, seed=(int, None),
    )
    def generate_audio_stream(
        self,
        model_state: StackState,
        text_to_generate: str,
        max_tokens: int = MAX_TOKEN_PER_CHUNK,
        frames_after_eos: int | None = None,
        copy_state: bool = True,
        seed: int | None = None,
        noise_source: Callable | None = None,
    ) -> Iterator[np.ndarray]:
        """Yield [samples] float32 chunks (80 ms each) as they are decoded.

        Long text is split into sentence chunks. `noise_source=None` draws the
        flow noise on the device from a generator seeded per chunk from
        SeedSequence([seed, i]); a callable (tests, recorded streams) is
        asked for (B, ldim) when K=1 and (K, B, ldim) otherwise."""
        if frames_after_eos is None:
            frames_after_eos = self.model_recommended_frames_after_eos
        chunks = split_into_best_sentences(
            self.tokenizer, text_to_generate, max_tokens,
            self.pad_with_spaces_for_short_inputs, self.remove_semicolons,
        )
        for i, chunk in enumerate(chunks):
            _, guess = prepare_text_prompt(chunk, self.pad_with_spaces_for_short_inputs,
                                           self.remove_semicolons)
            spec = dict(
                tokens=self._encode_text(chunk),
                frames_after_eos=frames_after_eos if frames_after_eos is not None else guess + 2,
                warm_start=i > 0,
                seed=None if seed is None else
                int(np.random.SeedSequence([seed, i]).generate_state(1)[0]),
            )
            yield from self._generate_chunk(model_state, spec, noise_source,
                                            write_back=not copy_state)

    def generate_audio_stream_from_tokens(
        self,
        model_state: StackState,
        tokens: list[int],
        frames_after_eos: int,
        noise_source: Callable | None = None,
        max_gen_len: int | None = None,
        write_back: bool = False,
        warm_start: bool = False,
        seed: int | None = None,
    ) -> Iterator[np.ndarray]:
        """Single-chunk generation from token ids (B=1), with the emission of
        generate_audio_stream. `write_back=True` is copy_state=False: the
        caller's state receives the post-chunk state. `warm_start`: start
        at 32-frame blocks (a chunk after the first of a long text)."""
        spec = dict(tokens=tokens, frames_after_eos=frames_after_eos, warm_start=warm_start,
                    seed=seed, max_gen_len=max_gen_len)
        yield from self._generate_chunk(model_state, spec, noise_source, write_back=write_back)

    def _generate_chunk(self, model_state: StackState, spec: dict,
                        noise_source: Callable | None, write_back: bool) -> Iterator[np.ndarray]:
        t_start = time.monotonic()
        tokens = spec["tokens"]
        token_count = len(tokens)
        max_gen_len = spec.get("max_gen_len") or self._estimate_max_gen_len(token_count)
        slots_used = model_state.write_pos
        pad_to = _bucket(token_count, PROMPT_BUCKETS)

        lm_state = self._working_state(model_state,
                                       _bucket(slots_used + pad_to, CAPACITY_BUCKETS))
        mimi_state = init_decoder_state(self.mimi_specs, 1, self._dtype, self.device)
        lm_state = self._prompt_text_tokens(lm_state, [tokens])

        prev_latent = torch.zeros((1, self.specs.ldim), dtype=torch.float32, device=self.device)
        is_bos = torch.ones((1,), dtype=torch.bool, device=self.device)
        gen = None
        if noise_source is None:
            gen = torch.Generator(device=self.device)
            tp = self._tp
            gen.manual_seed(self._seed(spec.get("seed"),
                                       [tp.group] if tp is not None and tp.size > 1 else []))

        run = _ChunkEmit(max_gen_len, spec["frames_after_eos"])
        out: list[np.ndarray] = []
        start_slots = slots_used + pad_to
        frames_started = 0
        while frames_started < max_gen_len and not run.stop:
            K = _block_size(frames_started, warm=spec.get("warm_start", False))
            lm_state = self._ensure_capacity(lm_state, start_slots + frames_started + K)
            noise = self._block_noise(gen, noise_source, K, 1)
            prev_latent, flags, audio, lm_state, mimi_state = self._decode_block(
                lm_state, mimi_state, prev_latent, is_bos, noise)
            is_bos = torch.zeros_like(is_bos)
            host_flags = flags.cpu().numpy()
            host_audio = audio.float().cpu().numpy()
            run.emit(frames_started, host_flags, host_audio, out)
            frames_started += K
            while out:
                yield out.pop(0)
        run.frames_started = frames_started
        run.finish()
        if write_back:
            self._write_back(model_state, lm_state, run, token_count)
        dur_ms = run.emitted * self.samples_per_frame * 1000 / self.sample_rate
        wall_ms = (time.monotonic() - t_start) * 1000
        logger.info("Generated %d ms of audio in %d ms (%.2fx real-time)",
                    int(dur_ms), int(wall_ms), dur_ms / max(wall_ms, 1e-6))

    def _write_back(self, model_state: StackState, lm_state: StackState, run: _ChunkEmit,
                    token_count: int) -> None:
        """copy_state=False: hand the caller the post-chunk state, offset
        advanced by the prompt and every step the reference loop ran (the
        first EOS + frames_after_eos + the break step, capped at
        max_gen_len); later speculative slots are masked out."""
        if run.eos_step is not None:
            stop = min(run.eos_step + run.frames_after_eos + 1, run.max_gen_len)
        else:
            stop = run.max_gen_len
        final_offset = (model_state.offset + token_count + stop).to(torch.int32)
        model_state.k, model_state.v = lm_state.k, lm_state.v
        model_state.pos = torch.where(lm_state.pos < final_offset[:, None], lm_state.pos, -1)
        model_state.offset = final_offset
        model_state.write_pos = lm_state.write_pos

    def _prompt_text_tokens(self, lm_state: StackState, token_lists: list[list[int]],
                            pad_to: int | None = None) -> StackState:
        """One prompt pass over the rows' tokens, right-padded to `pad_to`
        (default: the rows' PROMPT_BUCKETS bucket); each row's offset
        advances by its true length."""
        counts = [len(t) for t in token_lists]
        tok = torch.zeros((len(token_lists), pad_to or _bucket(max(counts), PROMPT_BUCKETS)),
                          dtype=torch.long)
        for i, tokens in enumerate(token_lists):
            tok[i, : len(tokens)] = torch.as_tensor(tokens, dtype=torch.long)
        emb = embed_text_tokens(self.params, tok.to(self.device))
        true_len = torch.tensor(counts, dtype=torch.int32, device=self.device)
        return prompt_step(self.specs, self.params, lm_state, emb, true_len=true_len)

    @typechecked(
        model_state=StackState, text_to_generate=str, max_tokens=int,
        frames_after_eos=(int, None), copy_state=bool, seed=(int, None),
    )
    def generate_audio(
        self,
        model_state: StackState,
        text_to_generate: str,
        max_tokens: int = MAX_TOKEN_PER_CHUNK,
        frames_after_eos: int | None = None,
        copy_state: bool = True,
        seed: int | None = None,
        noise_source: Callable | None = None,
    ) -> np.ndarray:
        """Generate the full waveform [samples] for a text prompt."""
        chunks = list(self.generate_audio_stream(
            model_state, text_to_generate, max_tokens=max_tokens,
            frames_after_eos=frames_after_eos, copy_state=copy_state, seed=seed,
            noise_source=noise_source,
        ))
        return np.concatenate(chunks, axis=0) if chunks else np.zeros((0,), np.float32)

    # --------------------------------------------------------------- batched

    def generate_audio_batch(
        self,
        model_states: list[StackState] | StackState,
        token_lists: list[list[int]],
        frames_after_eos: int = 3,
        seed: int | None = None,
        noise_source: Callable | None = None,
    ) -> list[np.ndarray]:
        """Batched decode of B utterances, one per row: `model_states` is a
        list of B voice states (B=1 each) or one state with B rows; neither
        is written. Per-row EOS latching and ragged emission: rows finish
        independently and each row's audio is cut at its own frame.
        `noise_source` as in generate_audio_stream, asked for (B, ldim) when
        K=1 and (K, B, ldim) otherwise.

        Under a mesh every process passes the whole batch and gets every row
        back; it decodes only its data rank's block of rows (`data_rows`: a
        batch that does not split raises), with the lengths, padding and
        noise of the whole batch."""
        token_counts = [len(t) for t in token_lists]
        B = len(token_lists)
        max_gen_len = self._estimate_max_gen_len(max(token_counts))
        pad_to = _bucket(max(token_counts), PROMPT_BUCKETS)
        batched = not isinstance(model_states, list)
        n_states = model_states.offset.shape[0] if batched else len(model_states)
        if n_states != B:
            raise ValueError(f"{n_states} voice rows for {B} token lists")
        slots_used = (model_states.write_pos if batched
                      else max(s.write_pos for s in model_states))
        rows = slice(0, B) if self.mesh is None else data_rows(B, self.mesh)
        token_lists = token_lists[rows]
        # start small; _ensure_capacity grows the cache per block
        capacity = _bucket(slots_used + pad_to, CAPACITY_BUCKETS)
        if batched:  # this rank's rows, as views: _working_state copies them
            lm_state = self._working_state(
                StackState(model_states.k[:, rows], model_states.v[:, rows],
                           model_states.pos[rows], model_states.offset[rows],
                           model_states.write_pos), capacity)
        else:
            lm_state = self._working_state(batch_states(model_states[rows], capacity), capacity,
                                           fresh=True)
        Bl = len(token_lists)
        mimi_state = init_decoder_state(self.mimi_specs, Bl, self._dtype, self.device)
        lm_state = self._prompt_text_tokens(lm_state, token_lists, pad_to)

        gen = None
        if noise_source is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._seed(seed, [] if self.mesh is None else mesh_groups(self.mesh)))
        prev_latent = torch.zeros((Bl, self.specs.ldim), dtype=torch.float32, device=self.device)
        eos_step = np.full((Bl,), -1, np.int64)
        end_step = np.full((Bl,), max_gen_len, np.int64)
        blocks: list[np.ndarray] = []  # [K, B, 1920] each
        start_slots = slots_used + pad_to
        step = 0
        done = False
        while step < max_gen_len and not done:
            K = _block_size(step)
            lm_state = self._ensure_capacity(lm_state, start_slots + step + K)
            is_bos = torch.full((Bl,), step == 0, dtype=torch.bool, device=self.device)
            noise = self._block_noise(gen, noise_source, K, B)[:, rows]
            prev_latent, flags, audio, lm_state, mimi_state = self._decode_block(
                lm_state, mimi_state, prev_latent, is_bos, noise)
            host_flags = flags.cpu().numpy()
            blocks.append(audio[:, :, 0].float().cpu().numpy())
            for i in range(K):
                s = step + i
                if s >= max_gen_len:
                    break
                self._update_row_cuts(host_flags[i], s, eos_step, end_step, frames_after_eos)
                if (end_step <= s).all():
                    done = True
                    break
            step += K

        if (eos_step < 0).any():
            no_eos = (rows.start + np.nonzero(eos_step < 0)[0]).tolist()
            if os.environ.get("POCKET_TTS_ERROR_WITHOUT_EOS", "0") == "1":
                raise RuntimeError(
                    f"Generation reached maximum length without EOS (rows {no_eos})!")
            logger.warning("Maximum generation length reached without EOS on rows %s; "
                           "this very often indicates an error.", no_eos)
        stacked = np.concatenate(blocks, axis=0)  # [S, Bl, 1920]
        audio = [stacked[:min(int(end_step[b]), stacked.shape[0]), b].reshape(-1)
                 for b in range(Bl)]
        if self.mesh is not None and self.mesh.size(0) > 1:
            audio = gather_rows(audio, self.mesh, self.device)
        return audio

    def generate_audio_batch_from_texts(
        self,
        model_states: list[StackState] | StackState,
        texts: list[str],
        frames_after_eos: int | None = None,
        seed: int | None = None,
    ) -> list[np.ndarray]:
        """Batched generation from raw texts (each text must fit one chunk;
        long texts go through generate_audio_stream per utterance)."""
        token_lists = []
        guesses = []
        for text in texts:
            prepared, guess = prepare_text_prompt(
                text, self.pad_with_spaces_for_short_inputs, self.remove_semicolons)
            token_lists.append(self._encode_text(prepared))
            guesses.append(guess + 2)
        if frames_after_eos is None:
            frames_after_eos = self.model_recommended_frames_after_eos
        if frames_after_eos is None:
            frames_after_eos = max(guesses)
        return self.generate_audio_batch(model_states, token_lists,
                                         frames_after_eos=frames_after_eos, seed=seed)

    @staticmethod
    def _update_row_cuts(step_flags, s, eos_step, end_step, frames_after_eos):
        """Fold one step's per-row EOS flags into the rows' first-EOS steps
        and cut frames (first EOS + frames_after_eos, at most the limit)."""
        flags = np.asarray(step_flags)
        newly = (flags > 0) & (eos_step < 0)
        eos_step[newly] = s
        has = eos_step >= 0
        end_step[has] = np.minimum(end_step[has], eos_step[has] + frames_after_eos)

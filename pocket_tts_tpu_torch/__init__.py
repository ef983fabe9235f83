"""pocket-tts-tpu on PyTorch and CUDA: the port of the JAX package
`pocket_tts_tpu` to an NVIDIA H100.

Plain tensor code is PyTorch; every Pallas kernel of the repo (the fused
FlowLM decode stack, the fused SEANet decoder, flash decode, the skinny GEMV
and the int8 GEMV probe's stacked GEMV) is a hand-written CUDA kernel under
`csrc/`, built with `nvcc` at first use. The package imports neither `jax`
nor `pocket_tts_tpu`.

Public API mirrors the JAX package: `TTSModel` and `export_model_state`.
"""

from pocket_tts_tpu_torch.pipeline.states import export_model_state
from pocket_tts_tpu_torch.pipeline.tts import TTSModel

__all__ = ["TTSModel", "export_model_state"]

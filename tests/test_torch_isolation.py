"""The port stands alone: it imports neither JAX nor the JAX package, its
copies of the JAX package's pure-Python modules behave the same, and a CUDA
tensor goes to a kernel or raises, never to a plain version."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pocket_tts_tpu.config import CONFIGS_DIR as JAX_CONFIGS
from pocket_tts_tpu.config import load_config as jax_load_config
from pocket_tts_tpu.text import sentencepiece as jsp
from pocket_tts_tpu.text import splitter as jsplit
from pocket_tts_tpu_torch.config import CONFIGS_DIR as PORT_CONFIGS
from pocket_tts_tpu_torch.config import load_config as port_load_config
from pocket_tts_tpu_torch.nn.transformer import TransformerConfig, init_stack_state
from pocket_tts_tpu_torch.ops import codec_decode as cd
from pocket_tts_tpu_torch.ops import decode_stack as ds
from pocket_tts_tpu_torch.text import sentencepiece as psp
from pocket_tts_tpu_torch.text import splitter as psplit
from test_cli_generate import build_tokenizer_model

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "pocket_tts_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "pocket_tts_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where `import jax`
    and `import pocket_tts_tpu` fail."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'pocket_tts_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pocket_tts_tpu_torch as p\n"
        "for info in pkgutil.walk_packages(p.__path__, 'pocket_tts_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("name", sorted(p.name for p in JAX_CONFIGS.glob("*.yaml")))
def test_configs_are_byte_equal_copies(name):
    assert (PORT_CONFIGS / name).read_bytes() == (JAX_CONFIGS / name).read_bytes()
    assert (port_load_config(PORT_CONFIGS / name).model_dump()
            == jax_load_config(JAX_CONFIGS / name).model_dump())


TEXTS = [
    "hello world.",
    "Hello world! this is a test, of the tts? this is a test; hello.",
    "zebra qué 123 world...   this is   a test\nof the tts",
]


def test_tokenizer_and_splitter_copies_agree(tmp_path):
    model = tmp_path / "tok.model"
    n_bins = build_tokenizer_model(model)
    jt = jsp.SentencePieceTokenizer(n_bins, model)
    pt = psp.SentencePieceTokenizer(n_bins, model)
    for text in TEXTS:
        ids = jt.encode(text)
        assert pt.encode(text) == ids
        assert pt.decode(ids) == jt.decode(ids)
        for max_tokens in (4, 50):
            assert (psplit.split_into_best_sentences(pt, text, max_tokens, True, True)
                    == jsplit.split_into_best_sentences(jt, text, max_tokens, True, True))
        assert (psplit.prepare_text_prompt(text, False, False)
                == jsplit.prepare_text_prompt(text, False, False))


def _refuse_build():
    raise RuntimeError("no CUDA kernel built here")


def _plain_must_not_run(*a, **kw):
    raise AssertionError("a non-CPU tensor reached a plain version")


def test_device_tensor_goes_to_the_kernel_or_raises(monkeypatch):
    """A tensor that is not on the CPU (here on the meta device, standing in
    for CUDA, which this build of torch lacks) is handed to the kernel path:
    with no kernel library the call raises, and the plain versions never run."""
    monkeypatch.setattr(ds.KERNEL, "load", _refuse_build)
    monkeypatch.setattr(cd.KERNEL, "load", _refuse_build)
    monkeypatch.setattr(ds, "decode_stack_plain", _plain_must_not_run)
    monkeypatch.setattr(cd, "seanet_apply", _plain_must_not_run)
    cfg = TransformerConfig(d_model=64, num_heads=4, num_layers=2, dim_feedforward=128)
    st = init_stack_state(cfg, 1, 16, torch.float32, "meta")
    x = torch.empty((1, 1, 64), device="meta")
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        ds.decode_stack(cfg, {}, x, st.k, st.v, st.pos, st.offset, 0)
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        cd.codec_decode(None, {}, torch.empty((1, 64, 16), device="meta"), {})
    launches = (ds.KERNEL.launches, cd.KERNEL.launches)
    assert launches == (0, 0)

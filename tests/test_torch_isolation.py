"""The port stands alone: no module of ``opensora_torch/``, and not
``chip_smoke.py``, imports JAX, flax, optax or anything of the JAX package
(an AST scan of every import statement, at any depth); nor ``safetensors``,
``transformers`` or the tokenizer packages (``tokenizers``,
``sentencepiece``, ``regex``, ``ftfy``, protobuf's ``google``), which the
card's machine lacks: checkpoints and tokenizer files are read by the
port's own readers."""

import ast
import os

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "opensora_tpu")
CHECKPOINT_PACKAGES = ("safetensors", "transformers", "huggingface_hub", "tokenizers", "sentencepiece", "regex", "ftfy",
                       "google")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "opensora_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_checkpoint_package(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in CHECKPOINT_PACKAGES]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_covers_every_module_of_the_port():
    """The scan finds each slice's modules, the VAE training slice's, the
    sequence-parallel slice's and the dataset and checkpoint tools among
    them, so a new module cannot slip past it."""
    scanned = {os.path.relpath(p, REPO) for p in _port_files()}
    for module in ("inference.py", "train.py", "train_vae.py", "training/vae.py", "models/cast_layers.py",
                   "models/dc_ae/model.py", "models/dc_ae/ops.py", "models/vae2d/losses.py",
                   "models/vae2d/discriminator.py", "models/vae2d/lpips.py", "ops/int8_flash.py",
                   "parallel/mesh.py", "parallel/context.py", "parallel/comm.py", "ops/ring_flash.py", "ops/sp.py",
                   "utils/ckpt.py", "utils/safetensors_io.py", "vae_inference.py", "vae_stats.py",
                   "models/text/clip_tokenizer.py", "models/text/t5_tokenizer.py", "eval/metrics.py", "eval/vbench.py",
                   "eval/aesthetic.py", "eval/clip_scorer.py", "eval/suites.py", "evaluate.py",
                   "parallel/pipeline.py", "training/pp.py", "parallel/vae_sharding.py", "parallel/distributed.py",
                   "cnv/meta.py", "cnv/export.py", "cnv/cache.py", "cnv/verify_pretrained.py"):
        assert os.path.join("opensora_torch", module) in scanned, module

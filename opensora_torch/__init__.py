"""PyTorch/CUDA port of opensora_tpu (see ROADMAP.md)."""

__version__ = "0.1.0"

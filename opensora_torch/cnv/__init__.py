"""The port's dataset and checkpoint tools (counterparts of scripts/cnv/):
``meta`` (a dataset table's height, width, frame count and fps),
``export`` (a training checkpoint to published weights), ``cache``
(latents and text embeddings for the cached training path) and
``verify_pretrained`` (a published checkpoint's structure and a fixed-input
forward). Each runs as ``python -m opensora_torch.cnv.<name>``."""

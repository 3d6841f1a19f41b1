"""Runnable examples, the twins of the repository's ``examples/``: each
runs as ``python -m repro_torch.examples.<name>`` (on the GPU unless
``--device cpu`` is given; ``occam_cnn_pipeline`` only plans, so it takes
no device) and exposes ``main(argv=None) -> dict``."""

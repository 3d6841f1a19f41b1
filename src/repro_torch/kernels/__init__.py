"""Hand-written CUDA kernels for Hopper (``sm_90a``), the counterparts of
the reference's Pallas kernels: ``fused_span``, ``flash_attention`` and
``ssd_scan``. Each has its CUDA source under ``csrc/``, a ``kernel.py``
wrapper that builds it on its first call (``_build.py``, nvcc) and counts
its launches, a ``ref.py`` plain PyTorch version and an ``ops.py`` that
routes a CUDA tensor to the kernel and a CPU tensor to the plain
version."""

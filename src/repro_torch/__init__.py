"""OCCAM on PyTorch and CUDA: the port of the ``repro`` package.

Occam's main path on one GPU — NetSpec -> DP partition for a capacity ->
per-span engine routes -> each span streamed row by row through
closure-sized rings by a hand-written CUDA fused-span kernel -> final
feature map + TrafficReport (measured == predicted). ``repro_torch``
imports neither JAX nor the ``repro`` package: the pure-Python planning
modules (``core``, ``models.zoo``, ``occam.registry``, ``occam.fleet``,
``occam.quant``) are kept as copies, held equal to the originals by the
tests. Layouts are the reference's: NHWC activations, HWIO weights.

Entry point: ``repro_torch.occam`` (``plan -> place -> compile -> run``).
"""

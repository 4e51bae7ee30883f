"""PyTorch + CUDA port of the NVLLM reproduction.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``models/``, ``serving/``, ``store/``, ``launch/``) so each module's
counterpart is easy to find, but imports only ``torch`` and ``numpy``. It
holds the dense serving path (``serving.engine.Engine`` over a
``models.dense`` decoder, resident or streamed from a host page store) and
the dense model's offline ``prefill`` / ``decode_step``, with the flash
tier read through the hand-written ECDP kernels and attention through the
paged- and decode-attention kernels (``kernels/csrc``). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version.
"""

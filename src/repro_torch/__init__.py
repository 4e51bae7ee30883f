"""PyTorch + CUDA port of the NVLLM reproduction.

Mirrors the layout of the JAX package ``repro`` (``core/``, ``kernels/``,
``models/``, ``serving/``) so each module's counterpart is easy to find,
but imports only ``torch`` and ``numpy``. The first slice is the resident
dense serving path: ``serving.engine.Engine`` over a ``models.dense``
decoder, with the flash tier read through the hand-written ECDP kernel and
attention over the paged KV pool through the paged-attention kernel
(``kernels/csrc``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""

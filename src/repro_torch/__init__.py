"""PyTorch/CUDA port of :mod:`repro` (Goldschmidt division with hardware
reduction), for one NVIDIA H100.

The layout mirrors ``repro`` module for module (``core/``, ``kernels/``,
``configs/``, ``layers/``, ``models/``, ``optim/``, ``data/``,
``checkpoint/``, ``runtime/``, ``launch/``, ``serving/``), so each module's
counterpart is found by name; ``tree`` holds the few tree helpers that
``jax.tree`` gives the reference.  This package imports ``torch`` and
``numpy`` only: never ``jax`` and never a module of ``repro``.

Entry points (model init, ``serving.Engine``, ``serving.generate_sequential``,
``launch.serve``, ``launch.train``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU they raise instead of moving to the CPU.  On a
CUDA tensor every kernel op launches its hand-written CUDA kernel
(``kernels/csrc``) or raises; on a CPU tensor it runs the plain PyTorch
version (``kernels/ref.py``).
"""

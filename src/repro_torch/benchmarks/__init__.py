"""The port's benchmarks (counterpart of the repository's ``benchmarks/``).

``bench_kernels`` is the kernel sweep behind ``python -m
repro_torch.benchmarks.run --smoke --check``; the other sections of the
reference's ``benchmarks/run.py`` (cycles, accuracy, divider, roofline,
``--serve``) and its tuned-vs-default rows are not ported yet.  Nothing
here imports ``jax``, ``repro`` or the top-level ``benchmarks`` package.
"""

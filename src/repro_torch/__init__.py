"""Reshape on PyTorch and CUDA: the port of the JAX package ``repro``.

Layout mirrors ``repro`` module for module:
  core/       the Reshape controller, routing table and routing primitives
  kernels/    hand-written CUDA kernels (csrc/) with their plain PyTorch
              versions; a CUDA tensor runs the kernel, a CPU tensor the
              plain version
  dataflow/   the pipelined engine, operators and the per-chunk exchange
  devices.py  device resolution shared by every entry point

Entry points take ``device`` and default to ``"cuda"``; without a card they
raise and ask for ``device="cpu"``.
"""

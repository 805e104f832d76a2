"""fwumious_wabbit_tpu_torch — the PyTorch + CUDA port of fwumious_wabbit_tpu.

The JAX package ``fwumious_wabbit_tpu`` stays the reference. This package
re-implements it in PyTorch for an NVIDIA Hopper card (H100), with every
Pallas kernel on the ported path re-written by hand in CUDA C++ (``csrc/``).
It is a package of its own: it imports nothing of the JAX package and never
imports ``jax``. The host half that never touched JAX — VW parsing, feature
translation, batching, the namespace map and model configuration, the
model-file header, the TCP line protocol, the prediction writer and the
embedded C++ engine (``native/``, built by ``g++`` on first use) — is the
port's own copy of the JAX package's, so both parse, translate, and write
files and replies alike.

Ported so far: the serving path (``--daemon`` and ``-t -i`` predict) and
training from VW text, with or without a dense tower (``--nn``), through
the input record cache (``-c``) as well.
"""

__version__ = "0.1.0"

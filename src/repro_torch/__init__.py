"""PyTorch + CUDA port of LABOR: the GCN serving and training paths.

The JAX package ``repro`` is the reference; this package mirrors its
module paths (``repro_torch.core.labor`` is the twin of
``repro.core.labor``) and imports neither ``jax`` nor ``repro``.

Integer tensors of a sampled block stay ``int32`` as in the reference.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version, on a CUDA tensor it launches the hand-written Hopper
kernel (``repro_torch/csrc``) or raises.
"""

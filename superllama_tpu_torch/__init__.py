"""superllama_tpu_torch: the PyTorch / CUDA port of superllama_tpu.

Serves GGUF llama-family models on an NVIDIA GPU through hand-written CUDA
kernels (``ops/``); the JAX package ``superllama_tpu`` is its reference.
Importing the package loads no kernels and touches no device."""

__version__ = "0.1.0"

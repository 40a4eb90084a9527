"""Ops: repacked quantized weights, the plain reference ops, and the
hand-written CUDA kernels with their plain PyTorch versions."""

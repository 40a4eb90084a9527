"""Architecture registry: GGUF ``general.architecture`` → forward function.

Counterpart of the JAX package's ``models/registry.py``, holding the dense
llama-family architectures that the port's ``llama_forward`` serves."""

from __future__ import annotations

from typing import Callable

from .llama import llama_forward

ForwardFn = Callable  # (params, hp, tokens, pos, cache, **kw) -> (logits, cache)

_REGISTRY: dict[str, ForwardFn] = {
    arch: llama_forward for arch in ("llama", "mistral", "qwen2", "qwen3")}


def get_forward(arch: str) -> ForwardFn:
    fn = _REGISTRY.get(arch)
    if fn is None:
        raise NotImplementedError(
            f"architecture {arch!r} not ported yet; known: {sorted(_REGISTRY)}")
    return fn


"""GGUF shard/merge tool, the port's copy of the JAX package's
``tools/gguf_split.py`` (llama-gguf-split's counterpart): split one GGUF into
N ecosystem-named shards (`-00001-of-0000N.gguf`) carrying split.* metadata,
and merge shards back into a single file. ``models/loader.py`` reads sharded
models transparently (llama_model_loader multi-shard semantics)."""

from __future__ import annotations

import re

from ..gguf import GGUFReader, GGUFWriter

SPLIT_RE = re.compile(r"-(\d{5})-of-(\d{5})\.gguf$")


def shard_name(prefix: str, i: int, n: int) -> str:
    return f"{prefix}-{i + 1:05d}-of-{n:05d}.gguf"


def shard_paths(first_path: str) -> list[str]:
    """All shard paths given any shard's path (or [path] if unsharded)."""
    m = SPLIT_RE.search(first_path)
    if not m:
        return [first_path]
    n = int(m.group(2))
    prefix = first_path[: m.start()]
    return [shard_name(prefix, i, n) for i in range(n)]


def split_gguf(in_path: str, out_prefix: str, n_split: int | None = None,
               max_tensors: int = 128) -> list[str]:
    """Split tensors across shards; shard 0 carries the full metadata."""
    r = GGUFReader(in_path)
    names = list(r.tensors)
    if n_split is None:
        n_split = max(1, (len(names) + max_tensors - 1) // max_tensors)
    per = (len(names) + n_split - 1) // n_split
    arch = r.metadata["general.architecture"]
    out_paths = []
    for i in range(n_split):
        path = shard_name(out_prefix, i, n_split)
        w = GGUFWriter(path, arch=arch)
        if i == 0:
            for k, v in r.metadata.items():
                if k != "general.architecture":
                    w.add(k, v)
        w.add("split.no", i)
        w.add("split.count", n_split)
        w.add("split.tensors.count", len(names))
        for name in names[i * per:(i + 1) * per]:
            ti = r.tensors[name]
            w.add_tensor(name, ti.raw().copy(), ti.ggml_type, raw_ne=ti.ne)
        w.write()
        out_paths.append(path)
    r.close()
    return out_paths


def merge_gguf(first_shard: str, out_path: str) -> None:
    paths = shard_paths(first_shard)
    readers = [GGUFReader(p) for p in paths]
    md = readers[0].metadata
    w = GGUFWriter(out_path, arch=md["general.architecture"])
    for k, v in md.items():
        if k != "general.architecture" and not k.startswith("split."):
            w.add(k, v)
    for r in readers:
        for name, ti in r.tensors.items():
            w.add_tensor(name, ti.raw().copy(), ti.ggml_type, raw_ne=ti.ne)
    w.write()
    for r in readers:
        r.close()

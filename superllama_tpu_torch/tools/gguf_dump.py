"""Inspect a GGUF file (gguf-py gguf_dump counterpart): metadata KVs and
the tensor table, as the JAX package's ``tools/gguf_dump.py`` prints them.

    python -m superllama_tpu_torch gguf-dump model.gguf [--no-tensors]
"""

from __future__ import annotations

from ..gguf import GGMLType, GGUFReader


def dump(path: str, show_tensors: bool = True, max_list: int = 8) -> str:
    r = GGUFReader(path)
    out = [f"# {path}", f"architecture: {r.arch()}",
           f"{len(r.metadata)} metadata keys, {len(r.tensors)} tensors", ""]
    for k in sorted(r.metadata):
        v = r.metadata[k]
        if isinstance(v, (list, tuple)) and len(v) > max_list:
            v = f"[{len(v)} items: {list(v[:3])!r}...]"
        out.append(f"  {k} = {v!r}")
    if show_tensors:
        out.append("")
        out.append(f"  {'tensor':<40} {'type':<8} {'shape':<20} bytes")
        for name, ti in r.tensors.items():
            out.append(f"  {name:<40} {GGMLType(ti.ggml_type).name:<8} "
                       f"{str(tuple(ti.shape)):<20} {ti.n_bytes}")
    r.close()
    return "\n".join(out)


def main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="gguf-dump", description=__doc__)
    ap.add_argument("model")
    ap.add_argument("--no-tensors", action="store_true")
    args = ap.parse_args(argv)
    print(dump(args.model, show_tensors=not args.no_tensors))
    return 0

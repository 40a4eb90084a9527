"""Named configuration presets, the port's copy of the JAX package's
``presets.py`` (common/preset.{h,cpp} + docs/preset.md counterpart):
bundles of sampling/serving parameters selectable by name or loaded from a
JSON file, merged under explicit flags (``run --preset``)."""

from __future__ import annotations

import json

BUILTIN_PRESETS: dict[str, dict] = {
    "greedy": {"temp": 0.0},
    "precise": {"temp": 0.3, "top_k": 20, "top_p": 0.8, "min_p": 0.1},
    "balanced": {"temp": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05},
    "creative": {"temp": 1.2, "top_k": 100, "top_p": 0.98, "min_p": 0.02,
                 "penalty_repeat": 1.15},
    "deterministic-server": {"temp": 0.0, "slots": 8, "ctx_size": 4096},
    "chat-server": {"temp": 0.7, "top_p": 0.9, "slots": 4, "ctx_size": 8192},
}


def load_preset(name_or_path: str) -> dict:
    """Resolve a preset by built-in name or JSON file path."""
    if name_or_path in BUILTIN_PRESETS:
        return dict(BUILTIN_PRESETS[name_or_path])
    with open(name_or_path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError("preset file must contain a JSON object")
    return data


def apply_preset(args_dict: dict, preset: dict,
                 explicit: set[str] | None = None) -> dict:
    """Merge: explicit flags beat preset values beat defaults."""
    out = dict(args_dict)
    for k, v in preset.items():
        if explicit and k in explicit:
            continue
        out[k] = v
    return out

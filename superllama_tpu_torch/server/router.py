"""Multi-model router: the port's counterpart of the JAX package's
``server/router.py`` (the reference server's router mode,
tools/server/server.cpp + server-models.cpp). One front door hosts several
models, routes each request by its ``model`` field (the default model
without one) and loads or unloads models at runtime through
``/models/load`` and ``/models/unload``.

Each model is an in-process ``ServerApp`` with an engine of its own on the
router's device (default CUDA), warmed up as ``serve`` warms one before it
takes requests. ``unload`` stops the engine and destroys its CUDA graphs,
so the model's weights, KV cache and graph pool go back to the device.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Any

import torch

from ..models.loader import LoadedModel, load_model
from .enterprise import ApiKeyManager, AuditLogger


class ModelRouter:
    """``api_keys`` and ``rate_limit_rpm`` apply to every model's app, and
    the keys also to ``/models/load`` and ``/models/unload`` (audited);
    ``warmup`` (default on) warms each engine up when it loads."""

    def __init__(self, default_model: str | None = None, n_slots: int = 2,
                 n_ctx: int = 2048, kv_dtype=None, api_keys=None, device=None,
                 warmup: bool = True, rate_limit_rpm: int = 0):
        self._apps: dict[str, Any] = {}
        self._lock = threading.Lock()
        self.n_slots = n_slots
        self.n_ctx = n_ctx
        self.kv_dtype = kv_dtype
        self.api_keys = api_keys
        self.device = device
        self.warmup = warmup
        self.rate_limit_rpm = rate_limit_rpm
        self.default = default_model
        self.keys = ApiKeyManager()
        for key, user in (api_keys or {}).items():
            self.keys.create(key, user)
        self.audit = AuditLogger()

    def auth(self, headers) -> tuple[str | None, str | None]:
        from .http import check_key

        return check_key(headers, self.keys, bool(self.api_keys))

    def load(self, name: str, path: str | LoadedModel, **kw) -> dict:
        """Load a GGUF (or take a model already loaded on the router's
        device) as ``name``, warm its engine up and start it."""
        from .http import ServerApp

        with self._lock:
            if name in self._apps:
                return {"success": True, "model": name, "already_loaded": True}
        t0 = time.perf_counter()
        model = path if isinstance(path, LoadedModel) else load_model(
            path, keep_quantized=kw.pop("keep_quantized", False), device=self.device)
        app = ServerApp(model, n_slots=kw.pop("n_slots", self.n_slots),
                        n_ctx=kw.pop("n_ctx", self.n_ctx), kv_dtype=self.kv_dtype,
                        api_keys=self.api_keys, rate_limit_rpm=self.rate_limit_rpm,
                        model_name=name, device=self.device,
                        warmup=kw.pop("warmup", self.warmup), **kw)
        if app.warmup:
            app.warmup_info = app.engine.warmup()
        app.engine.start()
        with self._lock:
            self._apps[name] = app
            if self.default is None:
                self.default = name
        return {"success": True, "model": name,
                "load_s": round(time.perf_counter() - t0, 2)}

    def unload(self, name: str) -> dict:
        """Stop the model's engine and free its device memory (weights, KV
        cache, graph pool) once nothing else holds the model."""
        with self._lock:
            app = self._apps.pop(name, None)
            if self.default == name:
                self.default = next(iter(self._apps), None)
        if app is None:
            raise KeyError(f"model {name!r} not loaded")
        app.close()
        del app
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return {"success": True, "model": name}

    def app_for(self, body: dict):
        name = body.get("model") or self.default
        with self._lock:
            app = self._apps.get(name)
        if app is None:
            raise KeyError(f"model {name!r} not loaded; available: {sorted(self._apps)}")
        return app

    def models(self) -> list[dict]:
        with self._lock:
            items = list(self._apps.items())
        return [{"id": name, "object": "model", "arch": app.model.hparams.arch,
                 "n_ctx": app.engine.n_ctx, "default": name == self.default}
                for name, app in items]

    def stop(self) -> None:
        """Stop every model's engine (``Server.stop``)."""
        with self._lock:
            apps = list(self._apps.values())
        for app in apps:
            app.engine.stop()

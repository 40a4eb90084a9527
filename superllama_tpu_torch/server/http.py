"""OpenAI-compatible HTTP server over the port's Engine.

Counterpart of the JAX package's ``server/http.py`` (``ServerApp`` +
``Server``) for the routes of this slice: ``GET /health``, ``/props``,
``/v1/models``; ``POST /v1/completions`` (plain and SSE stream, prompt as
text or a token-id list) and ``/v1/chat/completions`` (plain and SSE).
Host layer only: all token work happens on the engine's thread. API keys,
rate limits, metrics and the other routes wait for a later slice.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import torch

from ..models.loader import LoadedModel
from ..runtime.engine import Engine, GenRequest
from .chat import template_for_model

REQUEST_TIMEOUT_S = 600


class ServerApp:
    """Wires model + engine; transport-agnostic request handlers.

    ``warmup`` (the default, as ``serve --warmup``) runs ``Engine.warmup``
    before ``Server.start`` serves: every graph key is captured before the
    first request, which then pays no capture. ``warmup_info`` keeps what
    it returned."""

    def __init__(self, model: LoadedModel, n_slots: int = 4, n_ctx: int = 2048,
                 kv_dtype: torch.dtype | str | None = None, model_name: str | None = None,
                 device=None, paged: bool = False, page_size: int = 256,
                 n_pages: int | None = None, warmup: bool = True):
        self.model = model
        self.model_name = model_name or model.name or "model"
        self.engine = Engine(model, n_slots=n_slots, n_ctx=n_ctx,
                             kv_dtype=kv_dtype or torch.bfloat16, device=device,
                             paged=paged, page_size=page_size, n_pages=n_pages)
        self.chat_template = template_for_model(model)
        self.warmup = bool(warmup)
        self.warmup_info: dict | None = None
        self.t_start = time.time()

    @staticmethod
    def _sampling_from(body: dict) -> dict:
        s: dict[str, Any] = {}
        for key, name, cast in (("temperature", "temp", float), ("top_p", "top_p", float),
                                ("top_k", "top_k", int), ("min_p", "min_p", float),
                                ("repeat_penalty", "penalty_repeat", float),
                                ("frequency_penalty", "penalty_freq", float),
                                ("presence_penalty", "penalty_present", float)):
            if key in body:
                s[name] = cast(body[key])
        if body.get("seed") is not None:
            s["seed"] = int(body["seed"])
        if body.get("temperature", 1.0) == 0.0:
            s["greedy"] = True
        return s

    @staticmethod
    def _stops(body) -> list[str]:
        stop = body.get("stop") or []
        return [stop] if isinstance(stop, str) else list(stop)

    def handle_completion(self, body: dict, stream_cb=None) -> dict:
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            ids = [int(t) for t in prompt]
        else:
            tok = self.model.tokenizer
            if tok is None:
                raise ValueError("this model has no tokenizer: send the prompt "
                                 "as a list of token ids")
            ids = tok.encode(prompt, add_special=True, parse_special=True)
        req = GenRequest(
            prompt_ids=ids,
            max_tokens=int(body.get("max_tokens") or body.get("n_predict") or 128),
            stop_strings=self._stops(body), sampling=self._sampling_from(body),
            stream=stream_cb)
        self.engine.submit(req)
        out = req.result(timeout=REQUEST_TIMEOUT_S)
        choice = {"index": 0, "text": out["text"],
                  "finish_reason": out["finish_reason"], "logprobs": None}
        if body.get("return_tokens"):
            choice["tokens"] = out["tokens"]
        return {
            "id": "cmpl-" + uuid.uuid4().hex[:24],
            "object": "text_completion",
            "created": int(time.time()),
            "model": self.model_name,
            "choices": [choice],
            "usage": {"prompt_tokens": out["n_prompt"],
                      "completion_tokens": out["n_generated"],
                      "total_tokens": out["n_prompt"] + out["n_generated"]},
            "timings": {"ttft_s": out["ttft_s"], "total_s": out["total_s"]},
        }

    def handle_chat(self, body: dict, stream_cb=None) -> dict:
        prompt = self.chat_template.apply(body["messages"], add_generation_prompt=True)
        inner = {**body, "prompt": prompt}
        inner.setdefault("max_tokens", body.get("max_tokens") or 512)
        out = self.handle_completion(inner, stream_cb)
        choice = out["choices"][0]
        return {
            "id": "chatcmpl-" + uuid.uuid4().hex[:24],
            "object": "chat.completion",
            "created": out["created"],
            "model": self.model_name,
            "choices": [{"index": 0,
                         "message": {"role": "assistant", "content": choice["text"]},
                         "finish_reason": choice["finish_reason"]}],
            "usage": out["usage"],
        }

    def props(self) -> dict:
        hp = self.model.hparams
        return {"model": self.model_name, "arch": hp.arch,
                "n_ctx": self.engine.n_ctx, "n_slots": self.engine.n_slots,
                "n_vocab": hp.n_vocab, "n_layer": hp.n_layer,
                "device": str(self.engine.device),
                "uptime_s": time.time() - self.t_start}


def _completion_chunk(rid: str, token, piece: str) -> dict:
    return {"id": rid, "object": "text_completion",
            "choices": [{"index": 0, "text": piece, "token": token,
                         "finish_reason": None}]}


def _chat_chunk(rid: str, token, piece: str) -> dict:
    return {"id": rid, "object": "chat.completion.chunk",
            "choices": [{"index": 0, "delta": {"content": piece},
                         "finish_reason": None}]}


def make_handler(app: ServerApp):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send_json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _err(self, code, msg, etype="invalid_request_error"):
            self._send_json({"error": {"message": msg, "type": etype}}, code)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/health":
                self._send_json({"status": "ok"})
            elif path == "/v1/models":
                self._send_json({"object": "list", "data": [{
                    "id": app.model_name, "object": "model",
                    "created": int(app.t_start), "owned_by": "superllama_tpu_torch"}]})
            elif path == "/props":
                self._send_json(app.props())
            else:
                self._err(404, f"unknown path {path}")

        def do_POST(self):
            path = self.path.split("?")[0]
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else {}
            except (json.JSONDecodeError, ValueError) as e:
                return self._err(400, f"invalid JSON: {e}")
            try:
                if path == "/v1/completions":
                    self._dispatch(body, app.handle_completion, _completion_chunk)
                elif path == "/v1/chat/completions":
                    self._dispatch(body, app.handle_chat, _chat_chunk)
                else:
                    self._err(404, f"unknown path {path}")
            except (KeyError, TypeError, ValueError, RuntimeError) as e:
                self._err(400, f"bad request: {e}")
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._err(500, f"internal error: {e}", "api_error")

        def _dispatch(self, body, handler, chunk_fn):
            if not body.get("stream"):
                return self._send_json(handler(body))
            q: "queue.Queue" = queue.Queue()
            done = object()
            holder: dict = {}

            def run():
                try:
                    holder["result"] = handler(body, stream_cb=lambda t, p: q.put((t, p)))
                except Exception as e:  # noqa: BLE001 — reported in the stream
                    holder["error"] = str(e)
                q.put(done)

            worker = threading.Thread(target=run, daemon=True)
            worker.start()
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send_event(data: str):
                b = f"data: {data}\n\n".encode()
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")

            rid = uuid.uuid4().hex[:24]
            while (item := q.get()) is not done:
                send_event(json.dumps(chunk_fn(rid, *item)))
            worker.join()
            final = holder.get("result") or {}
            last = chunk_fn(rid, None, "")
            last["choices"][0]["finish_reason"] = (
                final["choices"][0]["finish_reason"] if final else "error")
            if "error" in holder:
                last["error"] = {"message": holder["error"]}
            last["usage"] = final.get("usage")
            send_event(json.dumps(last))
            send_event("[DONE]")
            self.wfile.write(b"0\r\n\r\n")

    return Handler


class Server:
    """ThreadingHTTPServer around a ServerApp; ``start`` also starts the
    engine thread, ``stop`` ends both."""

    def __init__(self, app: ServerApp, host: str = "127.0.0.1", port: int = 8080):
        self.app = app
        self.httpd = ThreadingHTTPServer((host, port), make_handler(app))
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        if self.app.warmup and self.app.warmup_info is None:
            self.app.warmup_info = self.app.engine.warmup()
        self.app.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.app.engine.stop()
        if self._thread:
            self._thread.join(timeout=30)

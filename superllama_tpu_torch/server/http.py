"""OpenAI-compatible HTTP server over the port's Engine.

Counterpart of the JAX package's ``server/http.py`` (``ServerApp`` +
``Server``) for these routes, with the JAX payloads and status codes:

 - GET ``/health`` (``/v1/health``), ``/props``, ``/v1/models``
   (``/models``), ``/slots`` (each slot's state, n_past, n_generated and
   request; ``n_pages`` on a paged cache) and ``/metrics`` (Prometheus
   text, namespace ``sllm``: memory, slots, queue, token and request
   counts, latency percentiles, error rate, the page pool's counters);
 - POST ``/v1/completions`` (``/completion``, ``/completions``; plain and
   SSE stream, prompt as text or a token-id list), ``/v1/chat/completions``
   (``/chat/completions``; plain and SSE), ``/tokenize``, ``/detokenize``,
   ``/apply-template`` and ``/slots/:id?action=save|restore|erase`` (files
   in a temporary directory of the server's own).

Structured output: a completion's ``grammar`` (GBNF), ``json_schema`` or
``response_format`` (``json_schema`` / ``json_object``) constrains its
tokens (``grammar_lazy`` and ``grammar_triggers`` pass through). A chat
request's ``tools`` and ``tool_choice`` give a tool plan
(``toolcall.plan_tools`` over the chat template's source): its grammar,
triggers and extra stops reach the engine, and the reply carries
``tool_calls`` with ``finish_reason: "tool_calls"``. ``reasoning_format``
(default "auto"; "none" keeps the raw text) splits ``<think>`` spans into
``reasoning_content``. A streamed chat sends typed deltas: content,
reasoning, and a tool call's start and argument fragments. A grammar or
schema that does not parse gives 400.

Every POST is recorded in the latency monitor, the request histogram and
the request counter. Host layer only: all token work happens on the
engine's thread. API keys, rate limits and the other routes wait for a
later slice.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np
import torch

from ..grammar import json_schema_to_gbnf
from ..models.loader import LoadedModel
from ..runtime.engine import Engine, GenRequest
from .chat import template_for_model
from .enterprise import CostTracker, SLAMonitor
from .metrics import MetricsRegistry
from .telemetry import MemTelemetry
from .toolcall import (ReasoningStream, StreamingToolCallParser, parse_tool_calls,
                       plan_tools, split_reasoning)

REQUEST_TIMEOUT_S = 600


class ServerApp:
    """Wires model + engine; transport-agnostic request handlers.

    ``warmup`` (the default, as ``serve --warmup``) runs ``Engine.warmup``
    before ``Server.start`` serves: every graph key is captured before the
    first request, which then pays no capture. ``warmup_info`` keeps what
    it returned. ``draft_model`` / ``n_draft`` serve with speculative
    decoding (the draft on the target's device)."""

    def __init__(self, model: LoadedModel, n_slots: int = 4, n_ctx: int = 2048,
                 kv_dtype: torch.dtype | str | None = None, model_name: str | None = None,
                 device=None, paged: bool = False, page_size: int = 256,
                 n_pages: int | None = None, warmup: bool = True,
                 draft_model: LoadedModel | None = None, n_draft: int = 8):
        self.model = model
        self.model_name = model_name or model.name or "model"
        self.engine = Engine(model, n_slots=n_slots, n_ctx=n_ctx,
                             kv_dtype=kv_dtype or torch.bfloat16, device=device,
                             paged=paged, page_size=page_size, n_pages=n_pages,
                             draft_model=draft_model, n_draft=n_draft)
        self.chat_template = template_for_model(model)
        self.warmup = bool(warmup)
        self.warmup_info: dict | None = None
        self.metrics = MetricsRegistry()
        self.metrics.histogram_declare("request_duration_seconds",
                                       [0.01, 0.05, 0.1, 0.5, 1, 2, 5, 10, 30, 60])
        self.sla = SLAMonitor()
        self.cost = CostTracker()
        self.slot_save_path = tempfile.mkdtemp(prefix="slt_slots_")
        self.telemetry = MemTelemetry(self.engine.device)
        self.t_start = time.time()

    @staticmethod
    def _sampling_from(body: dict) -> dict:
        """The request's sampler config, field by field as the JAX server
        reads it."""
        s: dict[str, Any] = {}
        for key, name, cast in (("temperature", "temp", float), ("top_p", "top_p", float),
                                ("top_k", "top_k", int), ("min_p", "min_p", float),
                                ("repeat_penalty", "penalty_repeat", float),
                                ("frequency_penalty", "penalty_freq", float),
                                ("presence_penalty", "penalty_present", float),
                                ("typical_p", "typical_p", float),
                                ("dry_multiplier", "dry_multiplier", float)):
            if key in body:
                s[name] = cast(body[key])
        if body.get("seed") is not None:
            s["seed"] = int(body["seed"])
        if body.get("logit_bias"):
            lb = body["logit_bias"]
            pairs = lb.items() if isinstance(lb, dict) else lb   # or [[id, bias], ...]
            s["logit_bias"] = {int(k): float(v) for k, v in pairs}
        if "mirostat" in body:
            s["mirostat"] = int(body["mirostat"])
            s["mirostat_tau"] = float(body.get("mirostat_tau", 5.0))
            s["mirostat_eta"] = float(body.get("mirostat_eta", 0.1))
        if body.get("temperature", 1.0) == 0.0:
            s["greedy"] = True
        return s

    @staticmethod
    def _grammar_from(body: dict) -> str | None:
        """The request's GBNF: ``grammar``, else ``json_schema``, else an
        OpenAI ``response_format`` of type ``json_schema`` or
        ``json_object``."""
        if body.get("grammar"):
            return body["grammar"]
        if body.get("json_schema") is not None:
            return json_schema_to_gbnf(body["json_schema"])
        rf = body.get("response_format") or {}
        if rf.get("type") == "json_schema":
            return json_schema_to_gbnf(rf["json_schema"].get("schema", {}))
        if rf.get("type") == "json_object":
            return json_schema_to_gbnf(rf.get("schema", {}))
        return None

    @staticmethod
    def _stops(body) -> list[str]:
        stop = body.get("stop") or body.get("stop_sequences") or []
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
            grammar=self._grammar_from(body),
            grammar_lazy=bool(body.get("grammar_lazy", False)),
            grammar_triggers=list(body.get("grammar_triggers", [])),
            stream=stream_cb)
        self.engine.submit(req)
        out = req.result(timeout=REQUEST_TIMEOUT_S)
        self.cost.record("anonymous", self.model_name, out["n_prompt"], out["n_generated"])
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
        """The chat template over the messages (and ``tools``), the tool
        plan's grammar, triggers and stops, then the reply split into
        reasoning, content and tool calls."""
        plan = plan_tools(body, self.chat_template.source)
        prompt = self.chat_template.apply(body["messages"], add_generation_prompt=True,
                                          tools=body.get("tools"))
        inner = {**body, "prompt": prompt}
        inner.setdefault("max_tokens", body.get("max_tokens") or 512)
        if plan is not None and plan.grammar:
            inner["grammar"] = plan.grammar
            inner["grammar_lazy"] = plan.grammar_lazy
            inner["grammar_triggers"] = plan.triggers
        reason_fmt = body.get("reasoning_format", "auto")
        # deepseek-r1-style templates end the prompt inside an open <think>
        forced_open = prompt.rstrip().endswith("<think>")
        if plan is not None and plan.extra_stops:
            inner["stop"] = self._stops(body) + plan.extra_stops
        stream_cb, flush = self._tool_stream(plan, stream_cb, reasoning=reason_fmt != "none",
                                             forced_open=forced_open)
        out = self.handle_completion(inner, stream_cb)
        flush()
        content = out["choices"][0]["text"]
        finish = out["choices"][0]["finish_reason"]
        reasoning = ""
        if reason_fmt != "none":
            reasoning, content = split_reasoning(content, forced_open=forced_open)
        message: dict = {"role": "assistant", "content": content}
        if plan is not None:
            content, tool_calls = parse_tool_calls(plan, content)
            if tool_calls:
                message = {"role": "assistant", "content": content or None,
                           "tool_calls": tool_calls}
                finish = "tool_calls"
        if reasoning:
            message["reasoning_content"] = reasoning
        return {
            "id": "chatcmpl-" + uuid.uuid4().hex[:24],
            "object": "chat.completion",
            "created": out["created"],
            "model": self.model_name,
            "choices": [{"index": 0, "message": message, "finish_reason": finish}],
            "usage": out["usage"],
        }

    @staticmethod
    def _tool_stream(plan, stream_cb, reasoning: bool = False, forced_open: bool = False):
        """Wrap a raw-piece stream callback with the incremental reasoning
        and tool-call splitters: downstream then receives typed events
        (``{"ev": "content" | "reasoning" | "tc_start" | "tc_args", ...}``)
        in place of raw text. Returns the callback and a ``flush`` that
        sends what the splitters still hold once generation ends."""
        if stream_cb is None or (plan is None and not reasoning):
            return stream_cb, lambda: None
        parser = StreamingToolCallParser(plan) if plan is not None else None
        rstream = ReasoningStream(forced_open=forced_open) if reasoning else None

        def after_reasoning(token, text):
            if parser is not None:
                for ev in parser.feed(text):
                    stream_cb(token, ev)
            else:
                stream_cb(token, {"ev": "content", "text": text})

        def wrapped(token, piece):
            if rstream is None:
                after_reasoning(token, piece)
                return
            for kind, text in rstream.feed(piece):
                if kind == "reasoning":
                    stream_cb(token, {"ev": "reasoning", "text": text})
                else:
                    after_reasoning(token, text)

        def flush():
            if rstream is not None:
                for kind, text in rstream.finish():
                    if kind == "reasoning":
                        stream_cb(None, {"ev": "reasoning", "text": text})
                    else:
                        after_reasoning(None, text)
            if parser is not None:
                for ev in parser.finish():
                    stream_cb(None, ev)

        return wrapped, flush

    def props(self) -> dict:
        hp = self.model.hparams
        return {"model": self.model_name, "arch": hp.arch,
                "n_ctx": self.engine.n_ctx, "n_slots": self.engine.n_slots,
                "n_vocab": hp.n_vocab, "n_layer": hp.n_layer,
                "device": str(self.engine.device),
                "uptime_s": time.time() - self.t_start}

    def tokenize(self, body: dict) -> dict:
        ids = self.model.tokenizer.encode(
            body.get("content", ""), add_special=bool(body.get("add_special", False)),
            parse_special=bool(body.get("parse_special", True)))
        return {"tokens": ids}

    def detokenize(self, body: dict) -> dict:
        return {"content": self.model.tokenizer.decode(body.get("tokens", []))}

    def apply_template(self, body: dict) -> dict:
        """POST /apply-template: the chat template rendered, nothing generated."""
        return {"prompt": self.chat_template.apply(body.get("messages", []),
                                                   add_generation_prompt=True)}

    def handle_slot_action(self, slot_id: int, action: str, body: dict) -> dict:
        """/slots/:id?action=save|restore|erase (llama-server's slot tasks):
        save and restore go through ``np.savez`` files in the server's slot
        directory, named by the body's ``filename`` (no "/", no leading
        ".")."""
        eng = self.engine
        if action == "erase":
            eng.slot_erase(slot_id)
            return {"id_slot": slot_id, "success": True}
        fname = body.get("filename")
        if not fname or "/" in fname or fname.startswith("."):
            raise ValueError("invalid or missing filename")
        path = os.path.join(self.slot_save_path, fname)
        if action == "save":
            data = eng.slot_save(slot_id)
            t0 = time.perf_counter()
            np.savez(path, **data)
            return {"id_slot": slot_id, "filename": fname,
                    "n_saved": len(data["cache_tokens"]),
                    "n_written": int(data["k"].nbytes + data["v"].nbytes),
                    "timings": {"save_ms": (time.perf_counter() - t0) * 1e3}}
        if action == "restore":
            t0 = time.perf_counter()
            with np.load(path) as z:
                n = eng.slot_restore(slot_id, dict(z))
            return {"id_slot": slot_id, "filename": fname, "n_restored": n,
                    "timings": {"restore_ms": (time.perf_counter() - t0) * 1e3}}
        raise ValueError(f"unknown slot action {action!r}")

    def slots(self) -> list[dict]:
        out = [{"id": s.idx, "state": s.state.name, "n_past": s.n_past,
                "n_generated": len(s.generated),
                "request_id": s.req.request_id if s.req else None}
               for s in self.engine.slots]
        if self.engine.paged:
            for d in out:
                d["n_pages"] = self.engine.pkv.seq_pages(d["id"])
        return out

    def prometheus_text(self) -> str:
        m, g = self.engine.metrics, self.metrics.gauge_set
        mem = self.telemetry.snapshot()
        g("device_memory_used_bytes", mem["device_used_bytes"])
        g("device_memory_frac", mem["device_frac"])
        g("host_memory_frac", mem["host_frac"])
        g("memory_pressure", int(mem["pressure"]))
        g("slots_busy", sum(s.state.value != 0 for s in self.engine.slots))
        g("queue_depth", self.engine._queue.qsize())
        g("tokens_generated_total", m["n_tokens_generated"])
        g("prompt_tokens_total", m["n_prompt_tokens"])
        g("requests_total", m["n_requests"])
        sla = self.sla.snapshot()
        g("latency_p50_seconds", sla["p50_s"])
        g("latency_p95_seconds", sla["p95_s"])
        g("error_rate", sla["error_rate"])
        if self.engine.paged:
            pstats = self.engine.pkv.stats
            for key in ("allocs", "evictions", "restores", "spill_bytes", "restore_bytes"):
                g(f"kv_pages_{key}", pstats[key])
            g("kv_pages_free", len(self.engine.pkv.free))
        return self.metrics.expose()


def _completion_chunk(rid: str, token, piece: str) -> dict:
    return {"id": rid, "object": "text_completion",
            "choices": [{"index": 0, "text": piece, "token": token,
                         "finish_reason": None}]}


def _chat_chunk(rid: str, token, piece) -> dict | None:
    """A chat SSE chunk of a raw piece or of a typed event of
    ``ServerApp._tool_stream``; None for an event with no text."""
    if isinstance(piece, dict):
        ev = piece["ev"]
        if ev in ("content", "reasoning"):
            if not piece["text"]:
                return None
            delta = {"content" if ev == "content" else "reasoning_content": piece["text"]}
        elif ev == "tc_start":
            delta = {"tool_calls": [{"index": piece["index"], "id": piece["id"],
                                     "type": "function",
                                     "function": {"name": piece["name"], "arguments": ""}}]}
        else:   # tc_args
            delta = {"tool_calls": [{"index": piece["index"],
                                     "function": {"arguments": piece["delta"]}}]}
    else:
        delta = {"content": piece}
    return {"id": rid, "object": "chat.completion.chunk",
            "choices": [{"index": 0, "delta": delta, "finish_reason": None}]}


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
            if path in ("/health", "/v1/health"):
                self._send_json({"status": "ok"})
            elif path in ("/v1/models", "/models"):
                self._send_json({"object": "list", "data": [{
                    "id": app.model_name, "object": "model",
                    "created": int(app.t_start), "owned_by": "superllama_tpu_torch"}]})
            elif path == "/props":
                self._send_json(app.props())
            elif path == "/slots":
                self._send_json(app.slots())
            elif path == "/metrics":
                text = app.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(text)))
                self.end_headers()
                self.wfile.write(text)
            else:
                self._err(404, f"unknown path {path}")

        def do_POST(self):
            path = self.path.split("?")[0]
            t0 = time.perf_counter()
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n)) if n else {}
            except (json.JSONDecodeError, ValueError) as e:
                return self._err(400, f"invalid JSON: {e}")
            ok = True
            try:
                if path in ("/completion", "/completions", "/v1/completions"):
                    self._dispatch(body, app.handle_completion, _completion_chunk)
                elif path in ("/v1/chat/completions", "/chat/completions"):
                    self._dispatch(body, app.handle_chat, _chat_chunk)
                elif path == "/tokenize":
                    self._send_json(app.tokenize(body))
                elif path == "/detokenize":
                    self._send_json(app.detokenize(body))
                elif path == "/apply-template":
                    self._send_json(app.apply_template(body))
                elif path.startswith("/slots/"):
                    qs = self.path.split("?", 1)[1] if "?" in self.path else ""
                    action = dict(p.split("=", 1) for p in qs.split("&") if "=" in p
                                  ).get("action", "")
                    self._send_json(app.handle_slot_action(int(path.split("/")[2]), action,
                                                           body))
                else:
                    ok = False
                    self._err(404, f"unknown path {path}")
            except (KeyError, TypeError, ValueError, RuntimeError) as e:
                ok = False
                self._err(400, f"bad request: {e}")
            except Exception as e:  # noqa: BLE001 — report, keep serving
                ok = False
                self._err(500, f"internal error: {e}", "api_error")
            finally:
                dt = time.perf_counter() - t0
                app.sla.record(dt, ok)
                app.metrics.histogram_observe("request_duration_seconds", dt, {"path": path})
                app.metrics.counter_inc("http_requests_total",
                                        labels={"path": path, "ok": str(ok).lower()})

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
                if (chunk := chunk_fn(rid, *item)) is not None:
                    send_event(json.dumps(chunk))
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

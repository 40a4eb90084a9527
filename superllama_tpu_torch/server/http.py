"""OpenAI-, Anthropic- and Ollama-compatible HTTP server over the port's
Engine.

Counterpart of the JAX package's ``server/http.py`` (``ServerApp`` +
``Server``), with its payloads and status codes:

 - GET ``/`` (the bundled web UI), ``/health`` (``/v1/health``; the
   HealthMonitor's status, ``"healthy"``), ``/props``, ``/v1/models``
   (``/models``), ``/api/tags`` (Ollama's model list), ``/lora-adapters``,
   ``/slots`` (each slot's state, n_past, n_generated and request;
   ``n_pages`` on a paged cache) and ``/metrics`` (Prometheus text,
   namespace ``sllm``);
 - POST ``/v1/completions`` (``/completion``, ``/completions``; plain and
   SSE stream, prompt as text or a token-id list), ``/v1/chat/completions``
   (``/chat/completions``, Ollama's ``/api/chat``; plain and SSE),
   ``/v1/messages`` (the Anthropic Messages API: system text or blocks,
   ``tool_result`` / ``tool_use`` blocks, ``tools`` and ``tool_choice``,
   ``thinking`` blocks, ``stop_reason``; plain and SSE with the Messages
   API's events), ``/v1/messages/count_tokens``, ``/v1/responses`` (the
   OpenAI Responses API, not streamed), ``/api/show``, ``/infill``
   (fill-in-the-middle from the vocab's FIM pieces; 501 without them),
   ``/tokenize``, ``/detokenize``, ``/apply-template``,
   ``/slots/:id?action=save|restore|erase`` (files in a temporary
   directory of the server's own), ``/lora-adapters`` (no adapter is
   loaded until LoRA is ported: any id gives 400), ``/embeddings``
   (``/embedding``, ``/v1/embeddings``; OpenAI's list of embeddings) and
   ``/rerank`` (``/v1/rerank``, ``/reranking``, ``/v1/reranking``;
   Jina / Cohere-style results) through the ``embed_model``'s ``Embedder``
   (501 without one), and
   ``/profile/start`` / ``/profile/stop`` (a torch.profiler trace of live
   traffic, written as a Chrome trace; 409 for a second start or a stop
   without a trace).

The front door of every POST: the API key (``Authorization: Bearer`` or
``x-api-key``; 401 ``authentication_error`` when keys are set and it is
missing or unknown), then the client's rate (429 ``rate_limit_error``),
then the audit log; failures are audited too. The client the key names
is billed in the CostTracker. Every POST past the front door is recorded in
the latency monitor, the request histogram, the request counter and the
JSONL metrics log (``metrics_path``). ``Server(tls_cert=, tls_key=)``
serves HTTPS.

Structured output: a completion's ``grammar`` (GBNF), ``json_schema`` or
``response_format`` (``json_schema`` / ``json_object``) constrains its
tokens (``grammar_lazy`` and ``grammar_triggers`` pass through). A chat or
messages request's ``tools`` and ``tool_choice`` give a tool plan
(``toolcall.plan_tools`` over the chat template's source): its grammar,
triggers and extra stops reach the engine, and the reply carries the tool
calls. ``reasoning_format`` (default "auto"; "none" keeps the raw text)
splits ``<think>`` spans off. A grammar or schema that does not parse
gives 400.

A ``ModelRouter`` (``server/router.py``) in place of the app serves several
models behind one door: requests go to the app their ``model`` field
names (404 ``model_not_found``), and ``/models/load`` / ``/models/unload``
manage them (behind the router's keys, which the JAX server does not
check there). Host layer only: all token work happens on the engines'
threads.
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
from ..utils import profiler
from .chat import template_for_model
from .enterprise import (ApiKeyManager, AuditLogger, CostTracker, HealthMonitor,
                         RateLimiter, SLAMonitor)
from .metrics import JsonlMetricsLogger, MetricsRegistry
from .telemetry import MemTelemetry
from .toolcall import (ReasoningStream, StreamingToolCallParser, parse_tool_calls,
                       plan_tools, split_reasoning)

REQUEST_TIMEOUT_S = 600
# /profile/start without "dir": the JAX server's directory, under TMPDIR
DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "superllama_trace")
WEBUI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "webui.html")
# the vocab pieces /infill looks for when the vocab names no FIM ids
FIM_NAMES = {
    "pre": ("<|fim_prefix|>", "<fim_prefix>", "<|fim_begin|>", "<PRE>"),
    "suf": ("<|fim_suffix|>", "<fim_suffix>", "<|fim_hole|>", "<SUF>"),
    "mid": ("<|fim_middle|>", "<fim_middle>", "<|fim_end|>", "<MID>"),
}


def check_key(headers, keys: ApiKeyManager, required: bool) -> tuple[str | None, str | None]:
    """(client, error) of a request's headers: the client its key names
    (``Authorization: Bearer <key>``, else ``x-api-key``); where no key is
    required, that client or "anonymous"."""
    key = None
    bearer = headers.get("Authorization", "")
    if bearer.startswith("Bearer "):
        key = bearer[7:]
    key = key or headers.get("x-api-key")
    if not required:
        return (key and keys.validate(key)) or "anonymous", None
    if not key:
        return None, "missing API key"
    user = keys.validate(key)
    if user is None:
        return None, "invalid API key"
    return user, None


class ServerApp:
    """Wires model + engine + the front door; transport-agnostic request
    handlers, each billing the ``client`` that ``auth`` returned.

    ``api_keys`` ({key: client name}) turns the key check on;
    ``rate_limit_rpm`` (0: off) limits each client's requests a minute
    (with RateLimiter's burst of 10); ``metrics_path`` appends a JSONL
    metrics line after every request. ``warmup`` (the default, as ``serve
    --warmup``) runs ``Engine.warmup`` before ``Server.start`` serves:
    every graph key is captured before the first request, which then pays
    no capture. ``warmup_info`` keeps what it returned. ``draft_model`` /
    ``n_draft`` serve with speculative decoding (the draft on the target's
    device). ``embed_model`` (an encoder, on the target's device) serves
    ``/embeddings`` and ``/rerank``."""

    def __init__(self, model: LoadedModel, n_slots: int = 4, n_ctx: int = 2048,
                 kv_dtype: torch.dtype | str | None = None, model_name: str | None = None,
                 device=None, paged: bool = False, page_size: int = 256,
                 n_pages: int | None = None, warmup: bool = True,
                 draft_model: LoadedModel | None = None, n_draft: int = 8,
                 api_keys: dict[str, str] | None = None, rate_limit_rpm: int = 0,
                 metrics_path: str | None = None, embed_model: LoadedModel | None = None):
        self.model = model
        self.model_name = model_name or model.name or "model"
        self.engine = Engine(model, n_slots=n_slots, n_ctx=n_ctx,
                             kv_dtype=kv_dtype or torch.bfloat16, device=device,
                             paged=paged, page_size=page_size, n_pages=n_pages,
                             draft_model=draft_model, n_draft=n_draft)
        self.embedder = None
        if embed_model is not None:
            from ..runtime.embedder import Embedder

            self.embedder = Embedder(embed_model)
        self.chat_template = template_for_model(model)
        self.warmup = bool(warmup)
        self.warmup_info: dict | None = None
        self.metrics = MetricsRegistry()
        self.metrics.histogram_declare("request_duration_seconds",
                                       [0.01, 0.05, 0.1, 0.5, 1, 2, 5, 10, 30, 60])
        self.keys = ApiKeyManager()
        self.require_auth = bool(api_keys)
        for key, user in (api_keys or {}).items():
            self.keys.create(key, user)
        self.rate = RateLimiter(rate_limit_rpm or 10**9)
        self.audit = AuditLogger()
        self.sla = SLAMonitor()
        self.cost = CostTracker()
        self.health = HealthMonitor()
        self.health.register("engine", lambda: True)
        self.jsonl = JsonlMetricsLogger(metrics_path)
        self.loras: list[dict] = []        # LoRA adapters: none until LoRA is ported
        self.slot_save_path = tempfile.mkdtemp(prefix="slt_slots_")
        self.telemetry = MemTelemetry(self.engine.device)
        self.t_start = time.time()

    def auth(self, headers) -> tuple[str | None, str | None]:
        return check_key(headers, self.keys, self.require_auth)

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

    def handle_completion(self, body: dict, client: str = "anonymous",
                          stream_cb=None) -> dict:
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
        self.cost.record(client, self.model_name, out["n_prompt"], out["n_generated"])
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

    def handle_chat(self, body: dict, client: str = "anonymous", stream_cb=None) -> dict:
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
        out = self.handle_completion(inner, client, stream_cb)
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

    def handle_anthropic_messages(self, body: dict, client: str = "anonymous",
                                  stream_cb=None) -> dict:
        """The Anthropic Messages API (/v1/messages): the system text (a
        string or text blocks) as a system turn, content blocks flattened
        (``tool_result`` wrapped in ``<tool_response>``, ``tool_use`` as its
        JSON), the tools and ``tool_choice`` (auto / any / none / tool)
        planned as the chat route's, and the reply as ``thinking``, ``text``
        and ``tool_use`` blocks with a ``stop_reason``."""
        messages = [dict(m) for m in body.get("messages", [])]
        if body.get("system"):
            system = body["system"]
            if isinstance(system, list):
                system = "".join(b.get("text", "") for b in system)
            messages = [{"role": "system", "content": system}] + messages
        for m in messages:
            if isinstance(m.get("content"), list):
                parts = []
                for b in m["content"]:
                    if b.get("type") == "text":
                        parts.append(b.get("text", ""))
                    elif b.get("type") == "tool_result":
                        c = b.get("content", "")
                        if isinstance(c, list):
                            c = "".join(x.get("text", "") for x in c)
                        parts.append(f"<tool_response>{c}</tool_response>")
                    elif b.get("type") == "tool_use":
                        parts.append(json.dumps({"name": b.get("name"),
                                                 "arguments": b.get("input", {})}))
                m["content"] = "".join(parts)
        plan = oai_tools = None
        if body.get("tools"):     # Anthropic tools in the OpenAI shape of the planner
            oai_tools = [{"type": "function",
                          "function": {"name": t["name"],
                                       "description": t.get("description", ""),
                                       "parameters": t.get("input_schema", {"type": "object"})}}
                         for t in body["tools"]]
            tc = body.get("tool_choice") or {"type": "auto"}
            choice = {"auto": "auto", "any": "required", "none": "none"}.get(
                tc.get("type"), "auto")
            if tc.get("type") == "tool":
                choice = {"type": "function", "function": {"name": tc["name"]}}
            plan = plan_tools({"tools": oai_tools, "tool_choice": choice},
                              self.chat_template.source)
        prompt = self.chat_template.apply(messages, add_generation_prompt=True,
                                          tools=oai_tools)
        inner = {"prompt": prompt, "max_tokens": body.get("max_tokens", 512),
                 "temperature": body.get("temperature", 1.0),
                 "top_p": body.get("top_p", 1.0), "top_k": body.get("top_k", 0),
                 "stop": body.get("stop_sequences", [])}
        if plan is not None and plan.grammar:
            inner["grammar"] = plan.grammar
            inner["grammar_lazy"] = plan.grammar_lazy
            inner["grammar_triggers"] = plan.triggers
        stream_cb, flush = self._tool_stream(plan, stream_cb)
        out = self.handle_completion(inner, client, stream_cb)
        flush()
        text = out["choices"][0]["text"]
        blocks: list[dict] = []
        stop_reason = {"stop": "end_turn", "length": "max_tokens"}.get(
            out["choices"][0]["finish_reason"], "end_turn")
        if body.get("reasoning_format", "auto") != "none":
            reasoning, text = split_reasoning(
                text, forced_open=prompt.rstrip().endswith("<think>"))
            if reasoning:
                blocks.append({"type": "thinking", "thinking": reasoning, "signature": ""})
        if plan is not None:
            rest, calls = parse_tool_calls(plan, text)
            if calls:
                if rest:
                    blocks.append({"type": "text", "text": rest})
                for c in calls:
                    blocks.append({"type": "tool_use", "id": "toolu_" + c["id"][5:],
                                   "name": c["function"]["name"],
                                   "input": json.loads(c["function"]["arguments"] or "{}")})
                stop_reason = "tool_use"
        if all(b["type"] == "thinking" for b in blocks):
            blocks.append({"type": "text", "text": text})
        return {
            "id": "msg_" + uuid.uuid4().hex[:24],
            "type": "message",
            "role": "assistant",
            "model": body.get("model", self.model_name),
            "content": blocks,
            "stop_reason": stop_reason,
            "stop_sequence": None,
            "usage": {"input_tokens": out["usage"]["prompt_tokens"],
                      "output_tokens": out["usage"]["completion_tokens"]},
        }

    def count_tokens(self, body: dict) -> dict:
        """POST /v1/messages/count_tokens: the rendered prompt's tokens."""
        text = lambda c: c if isinstance(c, str) else "".join(b.get("text", "") for b in c or [])
        msgs = [{"role": m.get("role", "user"), "content": text(m.get("content"))}
                for m in body.get("messages", [])]
        if body.get("system"):
            msgs.insert(0, {"role": "system", "content": text(body["system"])})
        prompt = self.chat_template.apply(msgs, add_generation_prompt=True)
        return {"input_tokens": len(self.model.tokenizer.encode(
            prompt, add_special=True, parse_special=True))}

    def handle_responses(self, body: dict, client: str = "anonymous") -> dict:
        """The OpenAI Responses API (/v1/responses), not streamed: ``input``
        (text or messages) and ``instructions`` through the chat route, the
        reply as ``message`` and ``function_call`` output items."""
        inp = body.get("input", "")
        if isinstance(inp, str):
            messages = [{"role": "user", "content": inp}]
        else:
            messages = [{"role": m.get("role", "user"), "content": m.get("content", "")}
                        for m in inp]
        if body.get("instructions"):
            messages = [{"role": "system", "content": body["instructions"]}] + messages
        tools = body.get("tools", [])
        inner = {"messages": messages, "max_tokens": body.get("max_output_tokens", 512),
                 "temperature": body.get("temperature", 1.0),
                 "top_p": body.get("top_p", 1.0),
                 "tools": [{"type": "function", "function": t} for t in tools
                           if t.get("type") == "function"] or body.get("tools"),
                 "tool_choice": body.get("tool_choice", "auto")}
        out = self.handle_chat(inner, client)
        msg = out["choices"][0]["message"]
        output = []
        if msg.get("content"):
            output.append({"type": "message", "id": "msg_" + uuid.uuid4().hex[:16],
                           "role": "assistant", "status": "completed",
                           "content": [{"type": "output_text", "text": msg["content"],
                                        "annotations": []}]})
        for tc in msg.get("tool_calls", []):
            output.append({"type": "function_call", "id": "fc_" + uuid.uuid4().hex[:16],
                           "call_id": tc["id"], "name": tc["function"]["name"],
                           "arguments": tc["function"]["arguments"], "status": "completed"})
        usage = out["usage"]
        return {"id": "resp_" + uuid.uuid4().hex[:24], "object": "response",
                "created_at": int(time.time()), "status": "completed",
                "model": body.get("model", self.model_name), "output": output,
                "usage": {"input_tokens": usage["prompt_tokens"],
                          "output_tokens": usage["completion_tokens"],
                          "total_tokens": usage["total_tokens"]}}

    def infill_ids(self, body: dict) -> list[int]:
        """The FIM prompt of /infill: prefix piece, ``input_prefix`` (or
        ``prefix``), suffix piece, ``input_suffix`` (or ``suffix``), middle
        piece. NotImplementedError (501) when the vocab has no FIM pieces."""
        tok = self.model.tokenizer
        v = tok.vocab
        fim = {}
        for kind, names in FIM_NAMES.items():
            tid = getattr(v, f"fim_{kind}_id", -1)
            if tid is None or tid < 0:
                tid = next((v.token_to_id[n] for n in names if n in v.token_to_id), -1)
            if tid < 0:
                raise NotImplementedError("model has no FIM tokens")
            fim[kind] = tid
        prefix = tok.encode(body.get("input_prefix", body.get("prefix", "")), add_special=False)
        suffix = tok.encode(body.get("input_suffix", body.get("suffix", "")), add_special=False)
        return [fim["pre"], *prefix, fim["suf"], *suffix, fim["mid"]]

    def handle_infill(self, body: dict, client: str = "anonymous", stream_cb=None) -> dict:
        """Fill-in-the-middle completion (/infill) of ``infill_ids``."""
        inner = {**body, "prompt": self.infill_ids(body)}
        inner.setdefault("max_tokens", body.get("n_predict") or 128)
        return self.handle_completion(inner, client, stream_cb)

    def handle_embeddings(self, body: dict, client: str = "anonymous") -> dict:
        """OpenAI /v1/embeddings and the native /embeddings: ``input`` (or
        ``content``), a text or a list of them."""
        if self.embedder is None:
            raise NotImplementedError("no embedding model loaded")
        inputs = body.get("input", body.get("content", ""))
        texts = [inputs] if isinstance(inputs, str) else [str(x) for x in inputs]
        embs, n_tok = self.embedder.embed(texts)
        self.cost.record(client, self.model_name, n_tok, 0)
        return {"object": "list", "model": body.get("model", self.model_name),
                "data": [{"object": "embedding", "index": i, "embedding": e.tolist()}
                         for i, e in enumerate(embs)],
                "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}}

    def handle_rerank(self, body: dict, client: str = "anonymous") -> dict:
        """Jina / Cohere-style /rerank: the documents by score, ``top_n``
        of them, with their text under ``return_documents``."""
        if self.embedder is None:
            raise NotImplementedError("no embedding model loaded")
        docs = body.get("documents", [])
        texts = [d.get("text", "") if isinstance(d, dict) else str(d) for d in docs]
        scores, n_tok = self.embedder.rerank(body["query"], texts)
        order = sorted(range(len(scores)), key=lambda i: -scores[i])
        top_n = int(body.get("top_n", len(order)))
        results = [{"index": i, "relevance_score": scores[i]} for i in order[:top_n]]
        if body.get("return_documents"):
            for r in results:
                r["document"] = {"text": texts[r["index"]]}
        self.cost.record(client, self.model_name, n_tok, 0)
        return {"model": body.get("model", self.model_name), "results": results,
                "usage": {"prompt_tokens": n_tok, "total_tokens": n_tok}}

    def lora_list(self) -> list[dict]:
        return [{"id": i, "path": a["path"], "scale": a["scale"]}
                for i, a in enumerate(self.loras)]

    def lora_set(self, entries: list[dict]) -> list[dict]:
        """POST /lora-adapters: rescale loaded adapters by id. No adapter is
        loaded until LoRA is ported, so every id is out of range (400)."""
        for e in entries:
            if not 0 <= int(e["id"]) < len(self.loras):
                raise IndexError(f"no adapter with id {e['id']}")
        return self.lora_list()

    def ollama_tags(self) -> dict:
        """GET /api/tags: the Ollama model list (and the OpenAI one)."""
        arch = self.model.hparams.arch
        detail = {"parent_model": "", "format": "gguf", "family": arch, "families": [arch],
                  "parameter_size": "", "quantization_level": ""}
        return {"models": [{
            "name": self.model_name, "model": self.model_name, "modified_at": "",
            "size": "", "digest": "", "type": "model", "description": "", "tags": [""],
            "capabilities": ["completion"], "parameters": "", "details": detail,
        }], "object": "list", "data": [{
            "id": self.model_name, "object": "model", "created": int(self.t_start),
            "owned_by": "superllama_tpu_torch",
        }]}

    def ollama_show(self) -> dict:
        """POST /api/show: the model's context length, template and family."""
        arch = self.model.hparams.arch
        return {"model_info": {"llama.context_length": self.engine.n_ctx},
                "modelfile": "", "parameters": "", "template": self.chat_template.source,
                "details": {"parent_model": "", "format": "gguf", "family": arch,
                            "families": [arch], "parameter_size": "",
                            "quantization_level": ""},
                "capabilities": ["completion"]}

    def profile_start(self, trace_dir: str) -> bool:
        """Start a trace on the engine's thread (its spans are recorded
        there); False when one is active. A CUDA engine's trace has the
        device's activity or raises."""
        cuda = self.engine.device.type == "cuda"
        return self.engine.on_engine_thread(lambda: profiler.start(trace_dir, cuda=cuda))

    def profile_stop(self) -> str | None:
        """End the trace on the engine's thread and write it; its directory,
        or None when none is active."""
        return self.engine.on_engine_thread(profiler.stop)

    def close(self) -> None:
        """Stop the engine and drop its captured graphs, so that their pool
        goes back to the device once the app is dropped."""
        self.engine.stop()
        if self.engine._graphs is not None:
            self.engine._graphs.clear()

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


def _sse(data: str, event: str | None = None) -> bytes:
    """One SSE event as an HTTP chunk."""
    b = ((f"event: {event}\n" if event else "") + f"data: {data}\n\n").encode()
    return f"{len(b):x}\r\n".encode() + b + b"\r\n"


class _AnthropicBlockStream:
    """The Messages API's streamed content blocks: text rides the open text
    block (block 0 opens with ``message_start``); a tool call closes the
    open block and opens a ``tool_use`` block, whose arguments arrive as
    ``input_json_delta`` fragments; text after a tool call opens a new text
    block. ``events`` gives (data, event name) pairs."""

    def __init__(self):
        self.index = 0
        self.open = True
        self.block_type = "text"

    def _stop(self) -> tuple[str, str]:
        self.open = False
        return json.dumps({"type": "content_block_stop", "index": self.index}), \
            "content_block_stop"

    def _start(self, block: dict) -> tuple[str, str]:
        self.index += 1
        self.block_type = block["type"]
        self.open = True
        return json.dumps({"type": "content_block_start", "index": self.index,
                           "content_block": block}), "content_block_start"

    def events(self, item) -> list[tuple[str, str]]:
        out = []
        if isinstance(item, str) or item.get("ev") == "content":
            text = item if isinstance(item, str) else item["text"]
            if not text:
                return out
            if self.block_type != "text" or not self.open:
                if self.open:
                    out.append(self._stop())
                out.append(self._start({"type": "text", "text": ""}))
            out.append((json.dumps({"type": "content_block_delta", "index": self.index,
                                    "delta": {"type": "text_delta", "text": text}}),
                        "content_block_delta"))
        elif item["ev"] == "tc_start":
            if self.open:
                out.append(self._stop())
            out.append(self._start({"type": "tool_use", "id": "toolu_" + item["id"][5:],
                                    "name": item["name"], "input": {}}))
        elif item["ev"] == "tc_args":
            out.append((json.dumps({"type": "content_block_delta", "index": self.index,
                                    "delta": {"type": "input_json_delta",
                                              "partial_json": item["delta"]}}),
                        "content_block_delta"))
        return out

    def close(self) -> list[tuple[str, str]]:
        return [self._stop()] if self.open else []


def make_handler(app):
    """The request handler of a ServerApp, or of a ModelRouter (which has
    ``app_for``) serving several."""
    router = app if hasattr(app, "app_for") else None

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send_json(self, obj, code=200):
            self._send(json.dumps(obj).encode(), "application/json", code)

        def _send(self, data: bytes, ctype: str, code: int = 200):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _err(self, code, msg, etype="invalid_request_error"):
            self._send_json({"error": {"message": msg, "type": etype}}, code)

        def do_GET(self):
            path = self.path.split("?")[0]
            # a router's model-wide routes read its default model's app
            a = router.app_for({}) if router is not None and path in (
                "/props", "/api/tags", "/lora-adapters", "/slots", "/metrics") else app
            if path in ("/", "/index.html"):
                with open(WEBUI, "rb") as f:
                    self._send(f.read(), "text/html; charset=utf-8")
            elif path in ("/health", "/v1/health"):
                if router is not None:
                    self._send_json({"status": "ok",
                                     "models": [m["id"] for m in router.models()]})
                else:
                    self._send_json({"status": app.health.status()})
            elif path in ("/v1/models", "/models"):
                self._send_json({"object": "list", "data": router.models()
                                 if router is not None else [{
                                     "id": app.model_name, "object": "model",
                                     "created": int(app.t_start),
                                     "owned_by": "superllama_tpu_torch"}]})
            elif path == "/props":
                self._send_json(a.props())
            elif path == "/api/tags":
                self._send_json(a.ollama_tags())
            elif path == "/lora-adapters":
                self._send_json(a.lora_list())
            elif path == "/slots":
                self._send_json(a.slots())
            elif path == "/metrics":
                self._send(a.prometheus_text().encode(), "text/plain; version=0.0.4")
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
            a = app
            if router is not None:
                if path in ("/models/load", "/models/unload"):
                    client, err = router.auth(self.headers)
                    if err:
                        router.audit.log("auth_failure", detail={"path": path, "err": err})
                        return self._err(401, err, "authentication_error")
                    router.audit.log("model_load" if path.endswith("/load") else "model_unload",
                                     client, {"model": body.get("model")})
                if path == "/models/load":
                    try:
                        return self._send_json(router.load(body["model"], body["path"]))
                    except (KeyError, OSError, ValueError, RuntimeError) as e:
                        return self._err(400, f"load failed: {e}")
                if path == "/models/unload":
                    try:
                        return self._send_json(router.unload(body["model"]))
                    except KeyError as e:
                        return self._err(404, str(e))
                try:
                    a = router.app_for(body if isinstance(body, dict) else {})
                except KeyError as e:
                    return self._err(404, str(e), "model_not_found")
            client, err = a.auth(self.headers)
            if err:
                a.audit.log("auth_failure", detail={"path": path, "err": err})
                return self._err(401, err, "authentication_error")
            if not a.rate.allow_request(client):
                a.audit.log("rate_limited", client)
                return self._err(429, "rate limit exceeded", "rate_limit_error")
            a.audit.log("request", client, {"path": path})
            ok = True
            try:
                ok = self._route(a, path, body, client)
            except (KeyError, TypeError, ValueError) as e:
                ok = False
                self._err(400, f"bad request: {e}")
            except RuntimeError as e:
                ok = False
                self._err(400, str(e))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                ok = False
                self._err(500, f"internal error: {e}", "api_error")
            finally:
                dt = time.perf_counter() - t0
                a.sla.record(dt, ok)
                a.metrics.histogram_observe("request_duration_seconds", dt, {"path": path})
                a.metrics.counter_inc("http_requests_total",
                                      labels={"path": path, "ok": str(ok).lower()})
                a.jsonl.log(a.engine, force=False)

        def _route(self, a, path: str, body, client: str) -> bool:
            """Serve one POST past the front door; False when it answered
            with an error status."""
            if path in ("/infill", "/embedding", "/embeddings", "/v1/embeddings", "/rerank",
                        "/v1/rerank", "/reranking", "/v1/reranking"):
                try:           # no FIM pieces, no embedding model: 501
                    if path == "/infill":
                        a.infill_ids(body)       # before a stream opens
                        self._dispatch(body, client, a.handle_infill, _completion_chunk)
                    elif "rerank" in path:
                        self._send_json(a.handle_rerank(body, client))
                    else:
                        self._send_json(a.handle_embeddings(body, client))
                except NotImplementedError as e:
                    self._err(501, str(e))
                    return False
            elif path in ("/completion", "/completions", "/v1/completions"):
                self._dispatch(body, client, a.handle_completion, _completion_chunk)
            elif path in ("/v1/chat/completions", "/chat/completions", "/api/chat"):
                self._dispatch(body, client, a.handle_chat, _chat_chunk)
            elif path == "/v1/messages":
                self._dispatch(body, client, a.handle_anthropic_messages, None,
                               anthropic=True)
            elif path == "/v1/messages/count_tokens":
                self._send_json(a.count_tokens(body))
            elif path == "/v1/responses":
                self._send_json(a.handle_responses(body, client))
            elif path == "/tokenize":
                self._send_json(a.tokenize(body))
            elif path == "/detokenize":
                self._send_json(a.detokenize(body))
            elif path == "/apply-template":
                self._send_json(a.apply_template(body))
            elif path == "/api/show":
                self._send_json(a.ollama_show())
            elif path == "/lora-adapters":
                try:
                    self._send_json(a.lora_set(body))
                except (IndexError, KeyError) as e:
                    self._err(400, f"bad adapter ref: {e}")
                    return False
            elif path == "/profile/start":
                tdir = body.get("dir") or DEFAULT_TRACE_DIR
                try:
                    started = a.profile_start(tdir)
                except RuntimeError as e:       # the device cannot be traced
                    self._err(409, f"profiler unavailable: {e}")
                    return False
                if not started:
                    self._err(409, "profiler unavailable or already tracing")
                    return False
                self._send_json({"tracing": True, "dir": tdir})
            elif path == "/profile/stop":
                tdir = a.profile_stop()
                if tdir is None:
                    self._err(409, "no active trace")
                    return False
                self._send_json({"tracing": False, "dir": tdir})
            elif path.startswith("/slots/"):
                qs = self.path.split("?", 1)[1] if "?" in self.path else ""
                action = dict(p.split("=", 1) for p in qs.split("&") if "=" in p
                              ).get("action", "")
                self._send_json(a.handle_slot_action(int(path.split("/")[2]), action, body))
            else:
                self._err(404, f"unknown path {path}")
                return False
            return True

        def _dispatch(self, body, client, handler, chunk_fn, anthropic=False):
            if not body.get("stream"):
                return self._send_json(handler(body, client))
            q: "queue.Queue" = queue.Queue()
            done = object()
            holder: dict = {}

            def run():
                try:
                    holder["result"] = handler(body, client,
                                               stream_cb=lambda t, p: q.put((t, p)))
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
            if anthropic:
                self._anthropic_events(body, q, done, worker, holder)
            else:
                rid = uuid.uuid4().hex[:24]
                while (item := q.get()) is not done:
                    if (chunk := chunk_fn(rid, *item)) is not None:
                        self.wfile.write(_sse(json.dumps(chunk)))
                worker.join()
                final = holder.get("result") or {}
                last = chunk_fn(rid, None, "")
                last["choices"][0]["finish_reason"] = (
                    final["choices"][0]["finish_reason"] if final else "error")
                if "error" in holder:
                    last["error"] = {"message": holder["error"]}
                last["usage"] = final.get("usage")
                self.wfile.write(_sse(json.dumps(last)) + _sse("[DONE]"))
            self.wfile.write(b"0\r\n\r\n")

        def _anthropic_events(self, body, q, done, worker, holder):
            """The Messages API's stream: message_start, the content blocks'
            start / delta / stop events, message_delta with the stop_reason
            and the output tokens, message_stop (an ``error`` event before
            it when generation failed)."""
            w = self.wfile.write
            w(_sse(json.dumps({"type": "message_start", "message": {
                "id": "msg_" + uuid.uuid4().hex[:24], "type": "message", "role": "assistant",
                "model": body.get("model", app.model_name if router is None
                                  else router.default),
                "content": [], "usage": {"input_tokens": 0, "output_tokens": 0}}}),
                "message_start"))
            w(_sse(json.dumps({"type": "content_block_start", "index": 0,
                               "content_block": {"type": "text", "text": ""}}),
                   "content_block_start"))
            blocks = _AnthropicBlockStream()
            while (item := q.get()) is not done:
                for data, ev in blocks.events(item[1]):
                    w(_sse(data, ev))
            worker.join()
            for data, ev in blocks.close():
                w(_sse(data, ev))
            final = holder.get("result") or {}
            if "error" in holder:
                w(_sse(json.dumps({"type": "error", "error": {
                    "type": "api_error", "message": holder["error"]}}), "error"))
            else:
                w(_sse(json.dumps({"type": "message_delta",
                                   "delta": {"stop_reason": final["stop_reason"],
                                             "stop_sequence": None},
                                   "usage": {"output_tokens": final["usage"]["output_tokens"]}}),
                       "message_delta"))
            w(_sse(json.dumps({"type": "message_stop"}), "message_stop"))

    return Handler


class Server:
    """ThreadingHTTPServer around a ServerApp or a ModelRouter; ``start``
    also warms up and starts the engine, ``stop`` ends both (a router's
    every model). ``tls_cert`` (PEM; the key in ``tls_key`` or the same
    file) serves HTTPS."""

    def __init__(self, app, host: str = "127.0.0.1", port: int = 8080,
                 tls_cert: str | None = None, tls_key: str | None = None):
        self.app = app
        self.httpd = ThreadingHTTPServer((host, port), make_handler(app))
        if tls_cert:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key or tls_cert)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket, server_side=True)
        self.tls = bool(tls_cert)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self):
        if isinstance(self.app, ServerApp):
            if self.app.warmup and self.app.warmup_info is None:
                self.app.warmup_info = self.app.engine.warmup()
            self.app.engine.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if isinstance(self.app, ServerApp):
            self.app.engine.stop()
        else:
            self.app.stop()
        if self._thread:
            self._thread.join(timeout=30)

"""The port's server front door and its API routes against the JAX
package's ServerApp, over HTTP on the CPU, on the same tiny F32 llama (the
byte vocab plus three FIM pieces) and the same requests; ids and timestamps
are left out of the comparisons:

 - API keys (Bearer and ``x-api-key``; 401 without a key or with a bad
   one, the failures audited), a client over its rate (429), ``/health``;
 - ``/v1/messages`` plain (system as a string and as blocks, a
   ``tool_result`` turn) and streamed (the Messages API's event types in
   order, the text deltas joined equal to the plain reply), tools with
   ``tool_choice`` ``any`` and ``tool`` (the same ``tool_use`` blocks and
   ``stop_reason``, also streamed);
 - ``count_tokens`` (also against ``/tokenize`` of the rendered prompt),
   ``/v1/responses``, ``/api/chat``, ``/api/tags``, ``/api/show``;
 - ``/infill`` with the FIM pieces (the same text and tokens as a
   completion of the FIM ids) and without them (501);
 - ``/embeddings`` and ``/rerank`` (501), ``/lora-adapters``, the web UI,
   ``/profile/start`` and ``/profile/stop`` and their 409s;
 - HTTPS with a self-signed certificate from ``openssl``;
 - the router: load, route by ``model``, unload, and 404 for a model it
   does not hold.
"""

import json
import shutil
import ssl
import subprocess
import time
import urllib.error
import urllib.request

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import load_model as jax_load
from superllama_tpu.server.http import Server as JaxServer
from superllama_tpu.server.http import ServerApp as JaxServerApp
from superllama_tpu.server.router import ModelRouter as JaxRouter
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.server.http import Server, ServerApp
from superllama_tpu_torch.server.router import ModelRouter
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import FIM_PIECES, fim_vocab_fields, write_tiny_llama_np

pytestmark = pytest.mark.usefixtures("torch_one_thread")

KEYS = {"sk-alice": "alice", "sk-bob": "bob"}
ALICE = {"x-api-key": "sk-alice"}
SIZE = dict(n_slots=2, n_ctx=256)
TOOLS = [{"name": "get_weather", "description": "the weather in a city",
          "input_schema": {"type": "object",
                           "properties": {"city": {"enum": ["Oslo", "Lima"]},
                                          "days": {"type": "integer", "minimum": 1,
                                                   "maximum": 7}},
                           "required": ["city", "days"], "additionalProperties": False}},
         {"name": "toggle", "input_schema": {
             "type": "object", "properties": {"on": {"type": "boolean"}},
             "required": ["on"], "additionalProperties": False}}]
MSG = {"model": "tiny", "max_tokens": 8, "temperature": 0,
       "messages": [{"role": "user", "content": "Say hi."}]}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama_np(tmp_path_factory.mktemp("api"), fim_vocab_fields())


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load(path)


@pytest.fixture(scope="module")
def servers(model, jax_model, tmp_path_factory):
    """The port's server and the JAX one, with the same keys; each writes
    its JSONL metrics log."""
    logs = tmp_path_factory.mktemp("logs")
    port = Server(ServerApp(model, kv_dtype=torch.float32, device="cpu", warmup=False,
                            api_keys=KEYS, metrics_path=str(logs / "port.jsonl"), **SIZE),
                  port=0)
    ref = JaxServer(JaxServerApp(jax_model, kv_dtype=jnp.float32, api_keys=KEYS,
                                 metrics_path=str(logs / "jax.jsonl"), **SIZE), port=0)
    for s in (port, ref):
        s.start()
    yield port, ref
    for s in (port, ref):
        s.stop()


def request(port, path, body=None, headers=None, scheme="http", context=None):
    """(status, Content-Type, body bytes) of one request, errors included."""
    r = urllib.request.Request(
        f"{scheme}://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method="POST" if body is not None else "GET",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(r, timeout=120, context=context) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def fresh(*servers) -> None:
    """Empty every slot, so both servers prefill the next prompt whole."""
    for s in servers:
        for slot in s.app.engine.slots:
            s.app.engine.slot_erase(slot.idx)


def both(servers, path, body=None, headers=ALICE):
    """The same request to the port's server and the JAX one:
    ((status, json), (status, json)), or the raw bytes of a stream."""
    out = []
    for s in servers:
        fresh(s)
        st, ctype, data = request(s.port, path, body, headers)
        out.append((st, json.loads(data) if "json" in ctype else data.decode()))
    return out


def strip(x, keys=("id", "created", "created_at", "call_id", "timings")):
    if isinstance(x, dict):
        return {k: strip(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, list):
        return [strip(v, keys) for v in x]
    return x


def sse(raw: str) -> list[tuple[str | None, dict | str]]:
    """(event name, data) of each SSE event."""
    out = []
    for block in raw.strip().split("\n\n"):
        ev, data = None, None
        for ln in block.split("\n"):
            if ln.startswith("event: "):
                ev = ln[7:]
            elif ln.startswith("data: "):
                data = ln[6:]
        out.append((ev, data if data == "[DONE]" else json.loads(data)))
    return out


# ------------------------------------------------------------------ front door


@pytest.mark.parametrize("headers,code", [({}, 401), ({"x-api-key": "sk-eve"}, 401),
                                          ({"Authorization": "Bearer sk-bob"}, 200),
                                          ({"x-api-key": "sk-alice"}, 200)],
                         ids=["no-key", "bad-key", "bearer", "x-api-key"])
def test_api_keys(servers, headers, code):
    (st, got), (jst, ref) = both(servers, "/tokenize", {"content": "hi"}, headers)
    assert st == jst == code and got == ref
    if code == 401:
        assert got["error"]["type"] == "authentication_error"
        for s in servers:
            fails = s.app.audit.query("auth_failure")
            assert fails and fails[-1]["path"] == "/tokenize"


def test_rate_limit_and_health(model, jax_model):
    """A client past its rate (rpm 1 plus RateLimiter's burst of 10) gets
    429, audited; another client still gets through; /health says
    "healthy" on both."""
    apps = (ServerApp(model, kv_dtype=torch.float32, device="cpu", warmup=False,
                      api_keys=KEYS, rate_limit_rpm=1, **SIZE),
            JaxServerApp(jax_model, kv_dtype=jnp.float32, api_keys=KEYS, rate_limit_rpm=1,
                         **SIZE))
    servers = (Server(apps[0], port=0), JaxServer(apps[1], port=0))
    for s in servers:
        s.start()
    try:
        codes = [[request(s.port, "/tokenize", {"content": "x"}, ALICE)[0] for _ in range(12)]
                 for s in servers]
        assert codes[0] == codes[1] == [200] * 11 + [429]
        (st, got), (jst, ref) = both(servers, "/tokenize", {"content": "x"}, ALICE)
        assert st == jst == 429 and got == ref and got["error"]["type"] == "rate_limit_error"
        assert [a.audit.query("rate_limited")[-1]["client"] for a in apps] == ["alice"] * 2
        assert both(servers, "/tokenize", {"content": "x"}, {"x-api-key": "sk-bob"})[0][0] == 200
        health = [json.loads(request(s.port, "/health")[2]) for s in servers]
        assert health[0] == health[1] == {"status": "healthy"}
    finally:
        for s in servers:
            s.stop()


def test_billing_and_metrics_log(servers):
    """The key's client is billed; every request past the front door adds
    one JSONL line, on both servers."""
    lines = []
    for s in servers:
        with open(s.app.jsonl.path) as f:
            lines.append(len(f.readlines()))
    both(servers, "/v1/completions", {"prompt": "ab", "max_tokens": 2, "temperature": 0},
         {"Authorization": "Bearer sk-bob"})
    for s, n in zip(servers, lines):
        # both servers write the line in the request's `finally`, after the
        # response has gone out: wait (a bounded time) for the handler to end
        deadline = time.monotonic() + 10
        while True:
            with open(s.app.jsonl.path) as f:
                rows = [json.loads(ln) for ln in f]
            if len(rows) > n or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        assert len(rows) == n + 1 and {"slots_busy", "queue_depth"} <= set(rows[-1])
        assert s.app.cost.bill("bob")["output_tokens"] >= 2


# ------------------------------------------------------------------ /v1/messages


MESSAGES = {
    "system-string": {**MSG, "system": "You are terse."},
    "system-blocks": {**MSG, "system": [{"type": "text", "text": "You are "},
                                        {"type": "text", "text": "terse."}]},
    "tool-result": {**MSG, "messages": [
        {"role": "user", "content": "Weather?"},
        {"role": "assistant", "content": [{"type": "tool_use", "id": "toolu_1",
                                           "name": "get_weather",
                                           "input": {"city": "Oslo", "days": 2}}]},
        {"role": "user", "content": [{"type": "tool_result", "tool_use_id": "toolu_1",
                                      "content": [{"type": "text", "text": "sunny"}]},
                                     {"type": "text", "text": "Thanks."}]}]},
}


@pytest.mark.parametrize("case", list(MESSAGES))
def test_messages_plain(servers, case):
    (st, got), (jst, ref) = both(servers, "/v1/messages", MESSAGES[case])
    assert st == jst == 200
    assert strip(got) == strip(ref)
    assert got["type"] == "message" and got["id"].startswith("msg_")
    assert got["stop_reason"] in ("end_turn", "max_tokens")


TOOL_CHOICES = {"any": {"type": "any"}, "tool": {"type": "tool", "name": "toggle"}}


def tools_body(choice: str) -> dict:
    return {**MSG, "max_tokens": 120, "temperature": 0, "tools": TOOLS,
            "tool_choice": TOOL_CHOICES[choice],
            "messages": [{"role": "user", "content": "Weather in Oslo?"}]}


@pytest.mark.parametrize("choice", list(TOOL_CHOICES))
def test_messages_tools(servers, choice):
    (st, got), (jst, ref) = both(servers, "/v1/messages", tools_body(choice))
    assert st == jst == 200
    assert strip(got) == strip(ref)
    assert got["stop_reason"] == "tool_use"
    use = [b for b in got["content"] if b["type"] == "tool_use"]
    assert use and use[0]["id"].startswith("toolu_")
    if choice == "tool":
        assert use[0]["name"] == "toggle" and isinstance(use[0]["input"]["on"], bool)


@pytest.mark.parametrize("kind", ["text", "tools"])
def test_messages_stream(servers, kind):
    """The Messages API's events in the JAX server's order, the text deltas
    joined equal to the plain reply's text (tools: the tool_use block's
    input rebuilt from its JSON fragments)."""
    body = MESSAGES["system-string"] if kind == "text" else tools_body("any")
    (st, raw), (jst, jraw) = both(servers, "/v1/messages", {**body, "stream": True})
    assert st == jst == 200
    events, jevents = sse(raw), sse(jraw)
    names = [e for e, _ in events]
    assert names == [e for e, _ in jevents]
    assert names[:2] == ["message_start", "content_block_start"]
    assert names[-2:] == ["message_delta", "message_stop"]
    assert all(e == d["type"] for e, d in events)
    deltas = [d["delta"] for _, d in events if d["type"] == "content_block_delta"]
    assert deltas == [d["delta"] for _, d in jevents if d["type"] == "content_block_delta"]
    (_, plain), _ = both(servers, "/v1/messages", body)
    stop = [d for _, d in events if d["type"] == "message_delta"][0]
    assert stop["delta"]["stop_reason"] == plain["stop_reason"]
    assert stop["usage"]["output_tokens"] == plain["usage"]["output_tokens"]
    if kind == "text":
        text = "".join(d["text"] for d in deltas if d["type"] == "text_delta")
        assert text == plain["content"][0]["text"]
    else:
        start = [d["content_block"] for _, d in events if d["type"] == "content_block_start"
                 and d["content_block"]["type"] == "tool_use"]
        args = "".join(d["partial_json"] for d in deltas if d["type"] == "input_json_delta")
        use = [b for b in plain["content"] if b["type"] == "tool_use"][0]
        assert start[0]["name"] == use["name"] and json.loads(args) == use["input"]


def test_count_tokens(servers):
    body = {"system": [{"type": "text", "text": "Be brief."}],
            "messages": [{"role": "user", "content": [{"type": "text", "text": "Hello"}]},
                         {"role": "assistant", "content": "Hi"},
                         {"role": "user", "content": "Bye"}]}
    (st, got), (jst, ref) = both(servers, "/v1/messages/count_tokens", body)
    assert st == jst == 200 and got == ref
    msgs = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "Hello"}, {"role": "assistant", "content": "Hi"},
            {"role": "user", "content": "Bye"}]
    port = servers[0].port
    rendered = json.loads(request(port, "/apply-template", {"messages": msgs}, ALICE)[2])
    ids = json.loads(request(port, "/tokenize", {"content": rendered["prompt"],
                                                 "add_special": True}, ALICE)[2])
    assert got["input_tokens"] == len(ids["tokens"])


# ------------------------------------------------------------------ other routes


def test_responses_and_ollama_chat(servers):
    msgs = [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi"}]
    chat_body = {"messages": msgs, "max_tokens": 6, "temperature": 0}
    (st, got), (jst, ref) = both(servers, "/v1/responses",
                                 {"input": [msgs[1]], "instructions": "Be brief.",
                                  "max_output_tokens": 6, "temperature": 0})
    assert st == jst == 200 and strip(got) == strip(ref)
    (cst, chat), _ = both(servers, "/v1/chat/completions", chat_body)
    text = chat["choices"][0]["message"]["content"]
    assert got["output"][0]["content"][0]["text"] == text
    (ost, ollama), (jost, jollama) = both(servers, "/api/chat", chat_body)
    assert ost == jost == 200 and strip(ollama) == strip(jollama)
    assert ollama["choices"][0]["message"]["content"] == text


def test_ollama_tags_and_show(servers):
    got = [json.loads(request(s.port, "/api/tags")[2]) for s in servers]
    # owned_by names the server software of each package
    assert strip(got[0], ("created", "owned_by")) == strip(got[1], ("created", "owned_by"))
    assert got[0]["models"][0]["details"]["family"] == "llama"
    (st, show), (jst, jshow) = both(servers, "/api/show", {"model": "tiny"})
    assert st == jst == 200 and show == jshow
    assert show["model_info"]["llama.context_length"] == SIZE["n_ctx"]


def test_infill(servers, model):
    body = {"input_prefix": "def f(", "input_suffix": "):\n    pass", "max_tokens": 6,
            "temperature": 0}
    (st, got), (jst, ref) = both(servers, "/infill", body)
    assert st == jst == 200 and strip(got) == strip(ref)
    tok = model.tokenizer
    fim = [tok.vocab.token_to_id[p] for p in FIM_PIECES]
    ids = ([fim[0], *tok.encode("def f(", add_special=False), fim[1],
            *tok.encode("):\n    pass", add_special=False), fim[2]])
    (_, direct), _ = both(servers, "/v1/completions", {"prompt": ids, "max_tokens": 6,
                                                       "temperature": 0})
    assert got["choices"][0]["text"] == direct["choices"][0]["text"]
    assert got["usage"] == direct["usage"]


def test_infill_without_fim_pieces(servers, monkeypatch):
    for s in servers:
        for piece in FIM_PIECES:
            monkeypatch.delitem(s.app.model.tokenizer.vocab.token_to_id, piece)
    (st, got), (jst, ref) = both(servers, "/infill", {"input_prefix": "a", "max_tokens": 2})
    assert st == jst == 501 and got == ref


@pytest.mark.parametrize("route,body,code", [
    ("/embeddings", {"input": "hi"}, 501), ("/v1/embeddings", {"input": ["a", "b"]}, 501),
    ("/rerank", {"query": "q", "documents": ["a"]}, 501),
    ("/lora-adapters", [{"id": 0, "scale": 0.5}], 400), ("/lora-adapters", [], 200)],
    ids=["embeddings", "v1-embeddings", "rerank", "lora-unknown", "lora-empty"])
def test_unserved_routes(servers, route, body, code):
    (st, got), (jst, ref) = both(servers, route, body)
    assert st == jst == code
    assert got == ref if code != 400 else got["error"]["message"].startswith("bad adapter ref")


def test_lora_list_and_web_ui(servers):
    for s in servers:
        assert json.loads(request(s.port, "/lora-adapters")[2]) == []
    pages = [request(s.port, "/") for s in servers]
    for st, ctype, page in pages:
        assert st == 200 and ctype.startswith("text/html") and b"/v1/chat/completions" in page


def test_profile_routes(servers, tmp_path):
    """start, a second start (409), a request, stop, a second stop (409) on
    both; the port's trace names the engine's spans."""
    codes = []
    for s, name in zip(servers, ("port", "jax")):
        tdir = str(tmp_path / name)
        run = [request(s.port, "/profile/start", {"dir": tdir}, ALICE)[0],
               request(s.port, "/profile/start", {"dir": tdir}, ALICE)[0]]
        fresh(s)
        request(s.port, "/v1/completions", {"prompt": "ab", "max_tokens": 3,
                                            "temperature": 0}, ALICE)
        st, _, data = request(s.port, "/profile/stop", {}, ALICE)
        run += [st, request(s.port, "/profile/stop", {}, ALICE)[0]]
        assert json.loads(data) == {"tracing": False, "dir": tdir}
        codes.append(run)
    assert codes[0] == codes[1] == [200, 409, 200, 409]
    with open(tmp_path / "port" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine.prefill", "engine.decode"} <= names


@pytest.mark.skipif(shutil.which("openssl") is None, reason="needs the openssl binary")
def test_tls(model, jax_model, tmp_path):
    cert, key = str(tmp_path / "cert.pem"), str(tmp_path / "key.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                    "-keyout", key, "-out", cert, "-days", "1", "-subj", "/CN=127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    ctx = ssl.create_default_context(cafile=cert)
    ctx.check_hostname = False
    servers = (Server(ServerApp(model, kv_dtype=torch.float32, device="cpu", warmup=False,
                                **SIZE), port=0, tls_cert=cert, tls_key=key),
               JaxServer(JaxServerApp(jax_model, kv_dtype=jnp.float32, **SIZE), port=0,
                         tls_cert=cert, tls_key=key))
    for s in servers:
        s.start()
    try:
        got = [request(s.port, "/tokenize", {"content": "hi"}, scheme="https", context=ctx)
               for s in servers]
        assert got[0][0] == 200 and got[0][2] == got[1][2] and servers[0].tls
        with pytest.raises(OSError):                       # plain HTTP is refused
            request(servers[0].port, "/health")
    finally:
        for s in servers:
            s.stop()


# ------------------------------------------------------------------ router


def test_router_load_route_unload(path):
    routers = (ModelRouter(kv_dtype=torch.float32, device="cpu", warmup=False, **SIZE),
               JaxRouter(kv_dtype=jnp.float32, **SIZE))
    servers = (Server(routers[0], port=0), JaxServer(routers[1], port=0))
    for s in servers:
        s.start()
    try:
        def each(path_, body=None):
            return [(st, json.loads(data)) for st, _, data in
                    (request(s.port, path_, body) for s in servers)]

        (st, got), (jst, ref) = each("/models/load", {"model": "tiny", "path": path})
        assert st == jst == 200 and got["success"] and got["model"] == ref["model"] == "tiny"
        assert routers[0].app_for({}).engine.device.type == "cpu"
        (_, got), (_, ref) = each("/v1/models")
        assert strip(got) == strip(ref)
        (_, got), (_, ref) = each("/health")
        assert got == ref == {"status": "ok", "models": ["tiny"]}
        body = {"model": "tiny", "prompt": "ab", "max_tokens": 4, "temperature": 0}
        (st, got), (jst, ref) = each("/v1/completions", body)
        assert st == jst == 200 and got["choices"][0]["text"] == ref["choices"][0]["text"]
        (st, got), (jst, ref) = each("/v1/completions", {**body, "model": "other"})
        assert st == jst == 404 and got["error"]["type"] == ref["error"]["type"] == \
            "model_not_found"
        (st, got), (jst, ref) = each("/models/unload", {"model": "tiny"})
        assert st == jst == 200 and got == ref
        (st, _), (jst, _) = each("/models/unload", {"model": "tiny"})
        assert st == jst == 404
        (st, _), (jst, _) = each("/v1/completions", body)
        assert st == jst == 404 and routers[0].models() == []
    finally:
        for s in servers:
            s.stop()


def test_router_management_needs_a_key(path):
    """The port checks the router's keys on /models/load and /models/unload
    (the JAX router serves them to anyone), and audits both."""
    router = ModelRouter(kv_dtype=torch.float32, device="cpu", warmup=False, api_keys=KEYS,
                         **SIZE)
    srv = Server(router, port=0)
    srv.start()
    try:
        body = {"model": "tiny", "path": path}
        assert request(srv.port, "/models/load", body)[0] == 401
        assert request(srv.port, "/models/load", body, ALICE)[0] == 200
        st, _, data = request(srv.port, "/v1/completions",
                              {"model": "tiny", "prompt": "ab", "max_tokens": 2}, ALICE)
        assert st == 200 and json.loads(data)["usage"]["completion_tokens"] == 2
        assert request(srv.port, "/models/unload", {"model": "tiny"})[0] == 401
        assert request(srv.port, "/models/unload", {"model": "tiny"}, ALICE)[0] == 200
        assert [e["type"] for e in router.audit.query()] == [
            "auth_failure", "model_load", "auth_failure", "model_unload"]
    finally:
        srv.stop()

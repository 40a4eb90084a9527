"""Structured output through the port's Engine, server and CLI, on the CPU
(tiny F32 llama with a byte-level vocab), against the JAX package on the
same GGUF and requests:

 - a JSON-schema grammar, greedy and seeded sampled, on f32, bf16 and Q8_0
   dense caches and a paged cache of 16-token pages: tokens equal the JAX
   Engine's, and the text parses and satisfies the schema;
 - a greedy grammar request's first token obeys the grammar (a grammar
   whose only legal first byte is not the unconstrained argmax);
 - a grammar slot keeps its wave off the device block: no block runs while
   it generates, and the plain request beside it returns to blocks after;
 - the port's ``ServerApp`` against the JAX one: ``/v1/completions`` with
   ``grammar``, ``json_schema`` and ``response_format``;
   ``/v1/chat/completions`` with ``tools`` and ``tool_choice: "required"``,
   plain and streamed (typed events, and SSE ``tool_calls`` deltas), tool
   call ids excluded; a bad grammar or schema gives 400 and the engine
   keeps serving; the request fields the JAX server reads (``logit_bias``
   in both shapes, ``typical_p``, ``mirostat``, ``dry_multiplier``,
   ``stop_sequences``);
 - ``run --json-schema`` greedy goes through the Engine, and its text
   parses.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.server.http import ServerApp as JaxServerApp
from superllama_tpu_torch.grammar import json_schema_to_gbnf
from superllama_tpu_torch.grammar.gbnf import GrammarState, parse_gbnf
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from superllama_tpu_torch.server.http import Server, ServerApp
from test_torch_fixtures import prompt, write_tiny_llama

# bounded: every string and number has a finite set of spellings, so a
# constrained request ends by EOS well inside max_tokens
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "n": {"type": "integer", "minimum": 0, "maximum": 99},
                         "c": {"enum": ["red", "green", "blue"]}},
          "required": ["ok", "n", "c"], "additionalProperties": False}
GBNF = json_schema_to_gbnf(SCHEMA)
SAMPLED = {"temp": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05, "seed": 7}
SIZE = dict(n_slots=2, n_ctx=128, prefill_buckets=(32,))
CACHES = {"f32": dict(kv_dtype=(torch.float32, jnp.float32)),
          "bf16": dict(kv_dtype=(torch.bfloat16, jnp.bfloat16)),
          "q8_0": dict(kv_dtype=("q8_0", "q8_0")),
          "paged": dict(kv_dtype=(torch.float32, jnp.float32), paged=True, page_size=16)}
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "the weather in a city",
    "parameters": {"type": "object",
                   "properties": {"city": {"enum": ["Oslo", "Lima"]},
                                  "days": {"type": "integer", "minimum": 1, "maximum": 7}},
                   "required": ["city", "days"], "additionalProperties": False}}},
    {"type": "function", "function": {
        "name": "add", "parameters": {
            "type": "object", "properties": {"a": {"type": "boolean"}},
            "required": ["a"], "additionalProperties": False}}}]


def satisfies(obj) -> bool:
    return (set(obj) == {"ok", "n", "c"} and isinstance(obj["ok"], bool)
            and isinstance(obj["n"], int) and 0 <= obj["n"] <= 99
            and obj["c"] in ("red", "green", "blue"))


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("gram"), (GGMLType.F32,))[GGMLType.F32]


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load(path)


@pytest.fixture(scope="module")
def engines(model, jax_model):
    """The port's and the JAX engine of a cache, shared by the tests of this
    file (each JAX engine compiles its steps once), every slot erased
    between uses."""
    made = {}

    def get(cache: str):
        if cache not in made:
            kw = dict(CACHES[cache])
            tdt, jdt = kw.pop("kv_dtype")
            made[cache] = (Engine(model, kv_dtype=tdt, device="cpu", **SIZE, **kw),
                           JaxEngine(jax_model, kv_dtype=jdt, **SIZE, **kw))
        for e in made[cache]:
            for s in e.slots:
                e.slot_erase(s.idx)
        return made[cache]
    return get


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_grammar_tokens_match_jax(engines, cache, mode):
    eng, jeng = engines(cache)
    sm = {"greedy": True} if mode == "greedy" else SAMPLED
    p = prompt(12, 5)
    got = eng.generate(p, max_tokens=96, sampling=sm, grammar=GBNF)
    ref = jeng.generate(p, max_tokens=96, sampling=sm, grammar=GBNF)
    assert got["tokens"] == ref["tokens"]
    assert got["finish_reason"] == ref["finish_reason"] == "stop"
    assert satisfies(json.loads(got["text"]))
    st = GrammarState(parse_gbnf(GBNF))
    assert st.accept_text(got["text"]) and st.can_terminate


@pytest.mark.parametrize("cache", ["f32", "paged"])
def test_greedy_first_token_obeys_grammar(engines, cache):
    """The only legal first byte is not the unconstrained argmax: an argmax
    first token would break the grammar."""
    eng, jeng = engines(cache)
    p = prompt(10, 11)
    free = eng.generate(p, max_tokens=1, sampling={"greedy": True})["tokens"][0]
    for s in eng.slots:
        eng.slot_erase(s.idx)
    ch = next(c for c in "xyz" if ord(c) != free)
    grammar = f'root ::= "{ch}" [a-z]{{2}}'
    got = eng.generate(p, max_tokens=8, sampling={"greedy": True}, grammar=grammar)
    ref = jeng.generate(p, max_tokens=8, sampling={"greedy": True}, grammar=grammar)
    assert got["tokens"][0] == ord(ch) != free
    assert got["tokens"] == ref["tokens"]
    assert got["text"][0] == ch and got["finish_reason"] == "stop"


@pytest.mark.parametrize("cache", ["f32", "paged"])
def test_grammar_slot_keeps_wave_off_the_block(model, cache):
    """A plain greedy request beside a grammar request: no decode block runs
    while the grammar slot generates; the plain request goes back to blocks
    once it ends, and its tokens are its lone tokens."""
    kw = dict(CACHES[cache])
    kw["kv_dtype"] = kw["kv_dtype"][0]
    eng = Engine(model, device="cpu", **SIZE, **kw)
    run_block = eng._run_block
    during = []

    def spy(*a, **k):
        during.append(any(s.req is not None and s.req.grammar for s in eng.slots))
        return run_block(*a, **k)

    eng._run_block = spy
    p_plain, p_gram = prompt(9, 1), prompt(14, 2)
    plain = eng.submit(GenRequest(prompt_ids=p_plain, max_tokens=60, stop_eog=False,
                                  sampling={"greedy": True}))
    gram = eng.submit(GenRequest(prompt_ids=p_gram, max_tokens=96, grammar=GBNF,
                                 sampling={"greedy": True}))
    eng.run_until_drained()
    n_gram = len(gram.result()["tokens"])
    assert n_gram < 60 and gram.result()["finish_reason"] == "stop"
    assert during and not any(during)          # blocks only after the grammar slot ended
    lone = Engine(model, device="cpu", **SIZE, **kw)
    assert plain.result()["tokens"] == lone.generate(
        p_plain, max_tokens=60, stop_eog=False, sampling={"greedy": True})["tokens"]


# ------------------------------------------------------------------ server


@pytest.fixture(scope="module")
def jax_app(jax_model):
    app = JaxServerApp(jax_model, n_slots=2, n_ctx=256, kv_dtype=jnp.float32)
    app.engine.start()
    yield app
    app.engine.stop()


@pytest.fixture(scope="module")
def server(model):
    app = ServerApp(model, n_slots=2, n_ctx=256, kv_dtype=torch.float32, device="cpu",
                    warmup=False)
    srv = Server(app, port=0)
    srv.start()
    yield srv
    srv.stop()


def call(port, path, body, raw=False):
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                               method="POST", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=120) as resp:
        assert resp.status == 200
        data = resp.read()
    return data.decode() if raw else json.loads(data)


def fresh(*engines) -> None:
    """Empty every slot, so both servers prefill the next prompt whole."""
    for e in engines:
        for s in e.slots:
            e.slot_erase(s.idx)


def completion(server, jax_app, body):
    fresh(server.app.engine, jax_app.engine)
    got = call(server.port, "/v1/completions", body)
    fresh(server.app.engine, jax_app.engine)
    ref = jax_app.handle_completion(body, "anonymous")
    return got, ref


STRUCTURED = {
    "grammar": {"grammar": 'root ::= "alpha" | "beta"'},
    "json_schema": {"json_schema": SCHEMA},
    "response_format": {"response_format": {"type": "json_schema",
                                            "json_schema": {"name": "s", "schema": SCHEMA}}},
}


@pytest.mark.parametrize("field", list(STRUCTURED))
def test_structured_completion_matches_jax(server, jax_app, field):
    body = {"prompt": "Answer:", "max_tokens": 96, "temperature": 0.8, "seed": 3,
            **STRUCTURED[field]}
    got, ref = completion(server, jax_app, body)
    g, r = got["choices"][0], ref["choices"][0]
    assert (g["text"], g["finish_reason"]) == (r["text"], r["finish_reason"])
    assert got["usage"] == ref["usage"]
    if field == "grammar":
        assert g["text"] in ("alpha", "beta")
    else:
        assert satisfies(json.loads(g["text"]))


def _strip_ids(message: dict) -> dict:
    out = dict(message)
    if "tool_calls" in out:
        out["tool_calls"] = [{k: v for k, v in c.items() if k != "id"}
                             for c in out["tool_calls"]]
    return out


CHAT = {"messages": [{"role": "user", "content": "Weather in Oslo?"}], "tools": TOOLS,
        "tool_choice": "required", "max_tokens": 120, "temperature": 0.8, "seed": 5}


def test_chat_tool_call_matches_jax(server, jax_app):
    fresh(server.app.engine, jax_app.engine)
    got = call(server.port, "/v1/chat/completions", CHAT)
    fresh(server.app.engine, jax_app.engine)
    ref = jax_app.handle_chat(CHAT, "anonymous")
    g, r = got["choices"][0], ref["choices"][0]
    assert g["finish_reason"] == r["finish_reason"] == "tool_calls"
    assert _strip_ids(g["message"]) == _strip_ids(r["message"])
    call0 = g["message"]["tool_calls"][0]
    assert call0["id"].startswith("call_")
    assert call0["function"]["name"] in ("get_weather", "add")
    json.loads(call0["function"]["arguments"])


def test_chat_tool_call_stream_matches_jax(server, jax_app):
    """The typed events of both handlers (ids excluded), and the port's SSE
    deltas rebuilt into the JAX reply's tool call."""
    events, jevents = [], []
    fresh(server.app.engine, jax_app.engine)
    server.app.handle_chat(CHAT, stream_cb=lambda t, ev: events.append((t, ev)))
    fresh(server.app.engine, jax_app.engine)
    jax_app.handle_chat(CHAT, "anonymous", stream_cb=lambda t, ev: jevents.append((t, ev)))
    strip = lambda evs: [(t, {k: v for k, v in ev.items() if k != "id"}) for t, ev in evs]
    assert strip(events) == strip(jevents)
    assert [ev["ev"] for _, ev in events if ev["ev"].startswith("tc_")][0] == "tc_start"

    fresh(server.app.engine, jax_app.engine)
    raw = call(server.port, "/v1/chat/completions", {**CHAT, "stream": True}, raw=True)
    chunks = [json.loads(ln[6:]) for ln in raw.split("\n")
              if ln.startswith("data: ") and ln != "data: [DONE]"]
    names, args = [], ""
    for c in chunks[:-1]:
        for tc in c["choices"][0]["delta"].get("tool_calls", []):
            if "name" in tc["function"]:
                names.append(tc["function"]["name"])
            args += tc["function"]["arguments"]
    assert chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"
    fresh(server.app.engine, jax_app.engine)
    plain = jax_app.handle_chat(CHAT, "anonymous")["choices"][0]["message"]["tool_calls"]
    assert names == [c["function"]["name"] for c in plain]
    # the stream sends the raw spans, the reply their re-serialization
    assert json.loads(args) == json.loads(plain[0]["function"]["arguments"])


@pytest.mark.parametrize("body", [
    {"prompt": "x", "max_tokens": 4, "grammar": "root ::= (("},
    {"prompt": "x", "max_tokens": 4, "json_schema": False},
    {"prompt": "x", "max_tokens": 4, "grammar": 'root ::= "a"', "grammar_lazy": True,
     "grammar_triggers": ["("]},
], ids=["gbnf", "schema", "trigger"])
def test_bad_grammar_is_400_and_serving_goes_on(server, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        call(server.port, "/v1/completions", body)
    assert e.value.code == 400
    out = call(server.port, "/v1/completions",
               {"prompt": "x", "max_tokens": 3, "temperature": 0})
    assert out["choices"][0]["finish_reason"] in ("stop", "length")
    assert 1 <= out["usage"]["completion_tokens"] <= 3


SAMPLING_FIELDS = {
    "logit_bias_dict": {"temperature": 0, "logit_bias": {"101": 4.0, "32": 2.5}},
    "logit_bias_pairs": {"temperature": 0, "logit_bias": [[101, 4.0], [32, 2.5]]},
    "typical_p": {"temperature": 0.9, "seed": 2, "typical_p": 0.5},
    "mirostat": {"temperature": 0.9, "seed": 2, "mirostat": 2, "mirostat_tau": 4.0},
    "dry_multiplier": {"temperature": 0.9, "seed": 2, "dry_multiplier": 0.8},
    "stop_sequences": {"temperature": 0, "stop_sequences": ["e"]},
}


@pytest.mark.parametrize("field", list(SAMPLING_FIELDS))
def test_request_fields_match_jax(server, jax_app, field):
    body = {"prompt": "hello there", "max_tokens": 24, **SAMPLING_FIELDS[field]}
    assert ServerApp._sampling_from(body) == jax_app._sampling_from(body)
    assert ServerApp._stops(body) == jax_app._stops(body)
    got, ref = completion(server, jax_app, body)
    g, r = got["choices"][0], ref["choices"][0]
    assert (g["text"], g["finish_reason"]) == (r["text"], r["finish_reason"])
    assert got["usage"] == ref["usage"]


# -------------------------------------------------------------------- CLI


def test_cli_run_json_schema_goes_through_engine(path, capsys, monkeypatch):
    from superllama_tpu_torch.cli import main
    from superllama_tpu_torch.runtime import decode_loop

    def refuse(*a, **k):
        raise AssertionError("a grammar run reached DecodeLoop")

    monkeypatch.setattr(decode_loop, "DecodeLoop", refuse)
    rc = main(["run", "-m", path, "-p", "Answer:", "-n", "96", "--temp", "0",
               "--device", "cpu", "--kv-dtype", "float32", "-c", "128",
               "-j", json.dumps(SCHEMA)])
    out = capsys.readouterr()
    assert rc == 0
    assert satisfies(json.loads(out.out))

"""The port's server routes that read the Engine's state, on the CPU (tiny
F32 llama), against the JAX ServerApp on the same GGUF where the payload is
the JAX one:

 - GET ``/slots`` (``n_pages`` on a paged cache) and ``/metrics``
   (Prometheus text whose gauge names are the JAX server's, counts that
   follow the requests sent);
 - POST ``/tokenize``, ``/detokenize`` and ``/apply-template`` equal to the
   JAX ServerApp's;
 - the aliases ``/v1/health``, ``/models``, ``/completion``,
   ``/completions`` and ``/chat/completions``;
 - ``/slots/0?action=save|erase|restore`` reproduces a continuation; a bad
   filename or action and a paged save are refused with 400, an unknown
   path with 404.
"""

import json
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.server.http import ServerApp as JaxServerApp
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.server.http import Server, ServerApp
from test_torch_fixtures import prompt, write_tiny_llama

# the gauges the JAX server's /metrics sets on every read (paged: and the pool's)
GAUGES = {"device_memory_used_bytes", "device_memory_frac", "host_memory_frac",
          "memory_pressure", "slots_busy", "queue_depth", "tokens_generated_total",
          "prompt_tokens_total", "requests_total", "latency_p50_seconds",
          "latency_p95_seconds", "error_rate"}
PAGED_GAUGES = {f"kv_pages_{k}" for k in ("allocs", "evictions", "restores", "spill_bytes",
                                          "restore_bytes", "free")}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("srv"), (GGMLType.F32,))[GGMLType.F32]


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_app(path):
    return JaxServerApp(jax_load(path), n_slots=2, n_ctx=128, kv_dtype=jnp.float32)


@pytest.fixture(scope="module", params=["dense", "paged"])
def server(model, request):
    kw = {"paged": True, "page_size": 16} if request.param == "paged" else {}
    app = ServerApp(model, n_slots=2, n_ctx=128, kv_dtype=torch.float32, device="cpu",
                    warmup=False, **kw)
    srv = Server(app, port=0)
    srv.start()
    yield srv
    srv.stop()


def call(port, path, body=None, raw=False):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method="POST" if body is not None else "GET",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=120) as resp:
        assert resp.status == 200
        data = resp.read()
        ctype = resp.headers["Content-Type"]
    return (data.decode(), ctype) if raw else json.loads(data)


def status(port, path, body=None) -> int:
    try:
        call(port, path, body)
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def gauges(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        m = re.fullmatch(r"sllm_(\w+)(\{[^}]*\})? (\S+)", line)
        if m and m.group(2) is None:
            out[m.group(1)] = float(m.group(3))
    return out


def complete(port, p, n=4, path="/v1/completions"):
    return call(port, path, {"prompt": p, "max_tokens": n, "temperature": 0,
                             "return_tokens": True})


def test_slots_route(server):
    p = prompt(20, 40)
    complete(server.port, p)
    slots = call(server.port, "/slots")
    eng = server.app.engine
    assert [s["id"] for s in slots] == [0, 1]
    assert all(s["state"] == "IDLE" and s["request_id"] is None for s in slots)
    held = next(s for s in slots if s["n_past"] == 23)
    assert held["n_generated"] == 4
    assert eng.slots[held["id"]].cache_tokens[:20] == p
    if eng.paged:
        assert held["n_pages"] == eng.pkv.seq_pages(held["id"]) == 2
    else:
        assert all("n_pages" not in s for s in slots)


def test_metrics_route(server):
    m0 = server.app.engine.metrics["n_requests"]
    for i in range(2):
        complete(server.port, prompt(10 + i, 41 + i))
    text, ctype = call(server.port, "/metrics", raw=True)
    assert ctype == "text/plain; version=0.0.4"
    g = gauges(text)
    want = GAUGES | (PAGED_GAUGES if server.app.engine.paged else set())
    assert want <= set(g)
    assert g["requests_total"] == m0 + 2 == server.app.engine.metrics["n_requests"]
    assert g["tokens_generated_total"] == server.app.engine.metrics["n_tokens_generated"]
    assert g["device_memory_used_bytes"] == 0 and g["host_memory_frac"] > 0
    assert "# TYPE sllm_request_duration_seconds histogram" in text
    assert re.search(r'sllm_http_requests_total\{ok="true",path="/v1/completions"\} \d', text)


@pytest.mark.parametrize("text", ["hello world", "<|bos|>a b\nc", ""])
def test_tokenize_detokenize_match_jax(server, jax_app, text):
    body = {"content": text, "add_special": True}
    got = call(server.port, "/tokenize", body)
    ref = {"tokens": jax_app.model.tokenizer.encode(text, add_special=True,
                                                    parse_special=True)}
    assert got == ref
    back = call(server.port, "/detokenize", {"tokens": got["tokens"]})
    assert back == {"content": jax_app.model.tokenizer.decode(got["tokens"])}


def test_apply_template_matches_jax(server, jax_app):
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}]
    assert call(server.port, "/apply-template", {"messages": msgs}) == \
        jax_app.apply_template({"messages": msgs})


@pytest.mark.parametrize("route", ["/v1/health", "/models", "/completion", "/completions",
                                   "/chat/completions"])
def test_route_aliases(server, route):
    p = prompt(9, 43)
    if route == "/v1/health":
        # the JAX server's answer: its HealthMonitor's status
        assert call(server.port, route) == call(server.port, "/health") == {"status": "healthy"}
    elif route == "/models":
        assert call(server.port, route) == call(server.port, "/v1/models")
    elif route == "/chat/completions":
        body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                "temperature": 0}
        out = call(server.port, route, body)
        assert out["object"] == "chat.completion"
        assert out["choices"][0]["message"] == call(server.port, "/v1/chat/completions",
                                                    body)["choices"][0]["message"]
    else:
        assert (complete(server.port, p, path=route)["choices"][0]["tokens"]
                == complete(server.port, p)["choices"][0]["tokens"])


def test_slot_actions_roundtrip(server):
    """save, a continuation, erase, restore, the continuation again: equal
    tokens, and the restore reports the saved count. On a paged cache save
    is refused (400: NotImplementedError is a RuntimeError, which the JAX
    server answers with 400 too) and erase frees the pages."""
    port, eng = server.port, server.app.engine
    p = prompt(30, 44)
    out = complete(port, p)["choices"][0]["tokens"]
    idx = next(s.idx for s in eng.slots if s.cache_tokens[:30] == p)
    if eng.paged:
        assert status(port, f"/slots/{idx}?action=save", {"filename": "s.npz"}) == 400
        assert call(port, f"/slots/{idx}?action=erase", {}) == {"id_slot": idx, "success": True}
        assert eng.pkv.seq_pages(idx) == 0
        return
    saved = call(port, f"/slots/{idx}?action=save", {"filename": "s.npz"})
    assert saved["n_saved"] == 33 and saved["filename"] == "s.npz"
    p2 = p + out + prompt(5, 45)[1:]
    a = complete(port, p2, 6)["choices"][0]["tokens"]
    assert call(port, f"/slots/{idx}?action=erase", {}) == {"id_slot": idx, "success": True}
    assert eng.slots[idx].cache_tokens == []
    restored = call(port, f"/slots/{idx}?action=restore", {"filename": "s.npz"})
    assert restored["n_restored"] == 33 and restored["id_slot"] == idx
    cached = eng.metrics["n_prompt_cached"]
    assert complete(port, p2, 6)["choices"][0]["tokens"] == a
    assert eng.metrics["n_prompt_cached"] == cached + 33
    with np.load(f"{server.app.slot_save_path}/s.npz") as z:
        assert set(z.files) >= {"k", "v", "pos", "n_past", "cache_tokens"}


@pytest.mark.parametrize("case", ["slash", "dot", "missing", "action"])
def test_slot_action_refusals(server, case):
    body = {"slash": {"filename": "a/b.npz"}, "dot": {"filename": ".hidden"},
            "missing": {}, "action": {"filename": "x.npz"}}[case]
    action = "bogus" if case == "action" else "save"
    assert status(server.port, f"/slots/0?action={action}", body) == 400


def test_unknown_paths_are_404(server):
    assert status(server.port, "/nope") == 404
    assert status(server.port, "/nope", {}) == 404

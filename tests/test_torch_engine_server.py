"""Port Engine, HTTP server and entry points on the CPU.

 - the port Engine's greedy output equals the JAX Engine's on the same GGUF
   (f32, so both sides compute the same logits to float rounding);
 - block decode equals step decode, and batched prefill waves equal lone
   requests;
 - the HTTP server answers /health, /props, /v1/models, /v1/completions
   (plain and SSE) and /v1/chat/completions;
 - entry points default to CUDA and raise without a GPU;
 - importing the port loads no jax and no superllama_tpu module.
"""

import json
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.gguf import GGMLType
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from superllama_tpu_torch.server.http import Server, ServerApp
from test_torch_fixtures import EOS, prompt, write_tiny_llama

GREEDY = {"greedy": True}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("eng"), (GGMLType.F32,))[GGMLType.F32]


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


def _engine(model, **kw):
    kw = {"n_slots": 3, "n_ctx": 256, "kv_dtype": torch.float32, "device": "cpu", **kw}
    return Engine(model, **kw)


@pytest.mark.parametrize("n_prompt", [5, 40, 150], ids=lambda n: f"p{n}")
def test_engine_greedy_matches_jax(path, model, n_prompt):
    """150 tokens prefill in two chunks (128 + 22)."""
    p = prompt(n_prompt, n_prompt)
    ref = JaxEngine(jax_load(path), n_slots=3, n_ctx=256,
                    kv_dtype=jnp.float32).generate(p, max_tokens=12, sampling=GREEDY,
                                                   stop_eog=False)
    got = _engine(model).generate(p, max_tokens=12, sampling=GREEDY, stop_eog=False)
    assert got["tokens"] == ref["tokens"]
    assert got["finish_reason"] == ref["finish_reason"] == "length"


@pytest.mark.parametrize("max_tokens", [11, 16], ids=lambda n: f"n{n}")
def test_block_decode_equals_step_decode(model, max_tokens):
    """11 tokens stop mid-block: the overshoot rolls back."""
    p = prompt(9, 7)
    block = _engine(model, block_size=8)
    step = _engine(model, block_size=1)
    a = [block.generate(p, max_tokens=max_tokens, sampling=GREEDY, stop_eog=False)
         for _ in range(2)]
    b = step.generate(p, max_tokens=max_tokens, sampling=GREEDY, stop_eog=False)
    assert a[0]["tokens"] == a[1]["tokens"] == b["tokens"]
    assert len(b["tokens"]) == max_tokens


def test_wave_prefill_equals_lone_requests(model):
    prompts = [prompt(n, n) for n in (6, 33, 70)]
    lone = [_engine(model).generate(p, max_tokens=10, sampling=GREEDY,
                                    stop_eog=False)["tokens"] for p in prompts]
    eng = _engine(model)
    reqs = [eng.submit(GenRequest(prompt_ids=p, max_tokens=10, sampling=GREEDY,
                                  stop_eog=False)) for p in prompts]
    eng.run_until_drained()
    assert [r.result()["tokens"] for r in reqs] == lone


def test_more_requests_than_slots_and_stops(model):
    eng = _engine(model, n_slots=2)
    reqs = [eng.submit(GenRequest(prompt_ids=prompt(4 + i, i), max_tokens=3 + i,
                                  sampling=GREEDY, stop_eog=False)) for i in range(5)]
    eng.run_until_drained()
    assert [len(r.result()["tokens"]) for r in reqs] == [3, 4, 5, 6, 7]


def test_seeded_sampling_reproducible(model):
    sm = {"temp": 0.9, "top_k": 20, "seed": 5}
    a = _engine(model).generate(prompt(6, 1), max_tokens=10, sampling=sm, stop_eog=False)
    b = _engine(model).generate(prompt(6, 1), max_tokens=10, sampling=sm, stop_eog=False)
    assert a["tokens"] == b["tokens"] and len(a["tokens"]) == 10


def test_engine_rejects_bad_requests(model):
    eng = _engine(model)
    with pytest.raises(RuntimeError):
        eng.generate([], max_tokens=4)
    with pytest.raises(RuntimeError):
        eng.generate(prompt(200), max_tokens=100)      # exceeds n_ctx
    with pytest.raises(RuntimeError):
        eng.generate([9999], max_tokens=4)


# ------------------------------------------------------------ HTTP server


@pytest.fixture(scope="module")
def server(model):
    app = ServerApp(model, n_slots=2, n_ctx=256, kv_dtype=torch.float32,
                    model_name="tiny-test", device="cpu")
    srv = Server(app, port=0)
    srv.start()
    yield srv
    srv.stop()


def _req(port, path, body=None, raw=False):
    r = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method="POST" if body is not None else "GET",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=120) as resp:
        assert resp.status == 200
        data = resp.read()
    return data if raw else json.loads(data)


def test_server_health_models_props(server):
    # the JAX server's answer: its HealthMonitor's status
    assert _req(server.port, "/health")["status"] == "healthy"
    assert _req(server.port, "/v1/models")["data"][0]["id"] == "tiny-test"
    props = _req(server.port, "/props")
    assert props["arch"] == "llama" and props["n_slots"] == 2


def test_server_completion_token_ids(server, model):
    p = prompt(12, 3)
    out = _req(server.port, "/v1/completions",
               {"prompt": p, "max_tokens": 8, "temperature": 0,
                "return_tokens": True})
    ch = out["choices"][0]
    assert ch["finish_reason"] in ("length", "stop")
    assert out["usage"]["prompt_tokens"] == 12
    assert out["usage"]["completion_tokens"] == len(ch["tokens"])
    ref = _engine(model).generate(p, max_tokens=8, sampling=GREEDY)
    assert ch["tokens"] == ref["tokens"]


def test_server_completion_text_prompt(server):
    out = _req(server.port, "/v1/completions",
               {"prompt": "hello", "max_tokens": 5, "temperature": 0})
    assert out["usage"]["prompt_tokens"] == 6          # BOS + 5 bytes
    assert isinstance(out["choices"][0]["text"], str)


def test_server_completion_stream(server):
    raw = _req(server.port, "/v1/completions",
               {"prompt": prompt(7, 2), "max_tokens": 6, "temperature": 0,
                "stream": True}, raw=True).decode()
    events = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    final = chunks[-1]
    assert final["choices"][0]["finish_reason"] in ("length", "stop")
    tokens = [c["choices"][0]["token"] for c in chunks[:-1]]
    assert len(tokens) == final["usage"]["completion_tokens"]
    assert all(t is not None and t != EOS for t in tokens[:-1])


def test_server_chat_completion(server):
    out = _req(server.port, "/v1/chat/completions",
               {"messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4, "temperature": 0})
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    assert out["usage"]["completion_tokens"] <= 4


def test_server_bad_request(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _req(server.port, "/v1/completions", {"prompt": [], "max_tokens": 2})
    assert e.value.code == 400


# ------------------------------------------------------------ device policy


@pytest.mark.parametrize("entry", ["resolve_device", "load_model", "Context",
                                   "Engine", "ServerApp", "synthetic", "DecodeLoop"])
def test_entry_points_default_to_cuda(entry, path, model):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from superllama_tpu_torch.device import resolve_device
    from superllama_tpu_torch.models.synthetic import (synthetic_qparams_device,
                                                       tiny_test_hparams)
    from superllama_tpu_torch.runtime.context import Context
    from superllama_tpu_torch.runtime.decode_loop import DecodeLoop

    calls = {
        "resolve_device": lambda: resolve_device(),
        "load_model": lambda: load_model(path),
        "Context": lambda: Context(model),
        "Engine": lambda: Engine(model),
        "ServerApp": lambda: ServerApp(model),
        "synthetic": lambda: synthetic_qparams_device(tiny_test_hparams()),
        "DecodeLoop": lambda: DecodeLoop(model),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import superllama_tpu_torch, superllama_tpu_torch.cli, superllama_tpu_torch.convert\n"
        "import superllama_tpu_torch.server.http, superllama_tpu_torch.runtime.context\n"
        "import superllama_tpu_torch.models.synthetic, superllama_tpu_torch.tokenizer\n"
        "import superllama_tpu_torch.ops.paged_attention, superllama_tpu_torch.runtime.paged_kv\n"
        "import superllama_tpu_torch.tools.ops_bench, superllama_tpu_torch.tools.qmv_probe\n"
        "import superllama_tpu_torch.tools.flash_decode_probe, superllama_tpu_torch.tools.llama_bench\n"
        "import superllama_tpu_torch.runtime.decode_loop, superllama_tpu_torch.runtime.graphs\n"
        "import superllama_tpu_torch.ops.device_sampling, superllama_tpu_torch.tools.batched_bench\n"
        "import superllama_tpu_torch.server.metrics, superllama_tpu_torch.server.telemetry\n"
        "import superllama_tpu_torch.server.enterprise\n"
        "import superllama_tpu_torch.grammar, superllama_tpu_torch.grammar.gbnf\n"
        "import superllama_tpu_torch.grammar.json_schema, superllama_tpu_torch.runtime.sampling\n"
        "import superllama_tpu_torch.server.toolcall, superllama_tpu_torch.server.json_partial\n"
        "import superllama_tpu_torch.runtime.speculative, superllama_tpu_torch.runtime.ngram\n"
        "import superllama_tpu_torch.runtime.lookahead, superllama_tpu_torch.runtime.self_extend\n"
        "import superllama_tpu_torch.utils.profiler, superllama_tpu_torch.args\n"
        "import superllama_tpu_torch.presets, superllama_tpu_torch.server.router\n"
        "import superllama_tpu_torch.server.security, superllama_tpu_torch.tools.gguf_dump\n"
        "import superllama_tpu_torch.gguf.writer, superllama_tpu_torch.tools.gguf_split\n"
        "import superllama_tpu_torch.native, superllama_tpu_torch.gguf.kquant_search\n"
        "import superllama_tpu_torch.tools.quantize, superllama_tpu_torch.tools.imatrix\n"
        "import superllama_tpu_torch.tools.perplexity\n"
        "import superllama_tpu_torch.models.qwen2vl, superllama_tpu_torch.models.cvector\n"
        "import superllama_tpu_torch.ops.grouped_matmul\n"
        "import superllama_tpu_torch.models.deepseek2, superllama_tpu_torch.runtime.cache_policy\n"
        "import superllama_tpu_torch.runtime.recurrent, superllama_tpu_torch.ops.ssm_scan\n"
        "import superllama_tpu_torch.models.mamba, superllama_tpu_torch.models.jamba\n"
        "import superllama_tpu_torch.models.hybrid, superllama_tpu_torch.models.plamo2\n"
        "import superllama_tpu_torch.ops.wkv, superllama_tpu_torch.models.rwkv\n"
        "import superllama_tpu_torch.models.lfm2, superllama_tpu_torch.models.qwen3next\n"
        "import superllama_tpu_torch.models.gemma3n\n"
        "import superllama_tpu_torch.models.bert, superllama_tpu_torch.models.t5\n"
        "import superllama_tpu_torch.models.llada, superllama_tpu_torch.models.wavtokenizer\n"
        "import superllama_tpu_torch.runtime.embedder, superllama_tpu_torch.runtime.diffusion\n"
        "import superllama_tpu_torch.tools.tts\n"
        "from superllama_tpu_torch import native\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'superllama_tpu')]\n"
        "bad += [f'built at import: {n}' for n in native._libs]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_run_on_cpu(path, capsys):
    from superllama_tpu_torch.cli import main

    rc = main(["run", "-m", path, "-p", "hello", "-n", "4", "--temp", "0",
               "--device", "cpu", "--kv-dtype", "float32"])
    assert rc == 0
    assert "4 tokens" in capsys.readouterr().err

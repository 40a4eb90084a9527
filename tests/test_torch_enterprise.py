"""The port's serving operations against the JAX package's, on the CPU:

 - every enterprise class (PriorityRequestQueue, RateLimiter, RBAC,
   ApiKeyManager, ContentFilter, AuditLogger, CostTracker, SLAMonitor,
   HealthMonitor, CheckpointManager, RecoveryManager), ``Tracer`` and
   ``JsonlMetricsLogger`` run through the same call sequence as the JAX
   class, with the same results (timestamps excluded); the JSONL logger
   reads the port's Engine (tiny F32 llama, one request served) as the
   JAX logger reads it;
 - a GGUF encrypted by the JAX ``ModelEncryptor`` decrypts in the port and
   the other way round; the port's loader opens an encrypted GGUF with
   ``SLT_MODEL_KEY``, refuses it without the key or with a wrong one, and
   leaves no decrypted file behind;
 - the profiler: one trace at a time, the Chrome trace written with the
   engine's spans, a CUDA trace refused where torch cannot trace the card,
   and ``annotate`` passing an exception through unchanged.
"""

import json
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from superllama_tpu.server import enterprise as jent
from superllama_tpu.server import metrics as jmet
from superllama_tpu.server import security as jsec
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime.engine import Engine
from superllama_tpu_torch.server import enterprise as tent
from superllama_tpu_torch.server import metrics as tmet
from superllama_tpu_torch.server import security as tsec
from superllama_tpu_torch.utils import profiler
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import fim_vocab_fields, prompt, write_tiny_llama_np

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama_np(tmp_path_factory.mktemp("ent"), fim_vocab_fields())


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


def both(fn):
    """fn(module) for the JAX module and the port's: (port, jax)."""
    return fn(tent), fn(jent)


def no_ts(x):
    if isinstance(x, dict):
        return {k: no_ts(v) for k, v in x.items() if k not in ("ts", "t_start", "t_end")}
    if isinstance(x, list):
        return [no_ts(v) for v in x]
    return x


# ------------------------------------------------------------------ enterprise


def run_queue(m):
    q = m.PriorityRequestQueue(max_size=5, default_timeout_s=60)
    out = [q.enqueue("a1", m.Priority.LOW, "a"), q.enqueue("b1", m.Priority.HIGH, "b"),
           q.enqueue("a2", m.Priority.HIGH, "a"), q.enqueue("c1", m.Priority.CRITICAL, "c"),
           q.enqueue("b2", m.Priority.HIGH, "b"), q.enqueue("x", m.Priority.LOW, "x")]
    out.append(len(q))
    out += [q.dequeue(timeout=0) for _ in range(6)]
    q.enqueue("late", m.Priority.NORMAL, "d", timeout_s=1e-4)
    time.sleep(0.01)
    out += [q.dequeue(timeout=0), dict(q.stats)]
    return out


def run_rate(m):
    r = m.RateLimiter(requests_per_minute=3, tokens_per_minute=100, burst=2)
    out = [r.allow_request("a") for _ in range(7)] + [r.allow_request("b")]
    out += [r.allow_tokens("a", 60), r.allow_tokens("a", 50), r.allow_tokens("a", 40)]
    return out + [r.usage("a"), r.usage("b"), r.usage("nobody")]


def run_rbac(m):
    rb = m.RBAC()
    rb.add_role(m.Role("ops", {m.Permission.MODEL_LOAD}, allowed_models={"m1"}))
    rb.assign("ann", "user")
    rb.assign("bob", "ops")
    rb.assign("root", "admin")
    out = [rb.check(u, p, model) for u in ("ann", "bob", "root", "eve")
           for p in m.Permission for model in (None, "m1", "m2")]
    try:
        rb.assign("eve", "wizard")
    except KeyError as e:
        out.append(str(e))
    return out


def run_keys(m):
    k = m.ApiKeyManager()
    k.create("sk-1", "alice")
    k.create("sk-2", "bob", scopes={"admin"})
    k.create("sk-3", "carol", expires_at=time.time() - 1)
    out = [k.validate("sk-1"), k.validate("sk-2"), k.validate("sk-2", "admin"),
           k.validate("sk-3"), k.validate("nope")]
    k.revoke("sk-1")
    return out + [k.validate("sk-1")]


def run_filter(m):
    f = m.ContentFilter()
    f.add_word("Secret")
    f.add_pattern(r"\d{3}-\d{4}")
    return [f.check(t) for t in ("all clear", "a SECRET plan", "call 555-1234")]


def run_audit(m, tmp):
    path = os.path.join(tmp, m.__name__.split(".")[0] + ".jsonl")
    a = m.AuditLogger(path, buffer_size=4, rotate_bytes=200)
    for i in range(6):
        a.log("request" if i % 2 else "auth_failure", f"c{i % 3}", {"path": f"/p{i}"})
    try:
        a.log("not-an-event")
    except AssertionError as e:
        bad = str(e)
    out = [no_ts(a.query()), no_ts(a.query("request")), no_ts(a.query(client_id="c1")), bad]
    with open(path) as f:
        tail = [no_ts(json.loads(ln)) for ln in f]
    return out + [tail, os.path.exists(path + ".1")]


def run_cost_sla(m):
    c = m.CostTracker()
    c.set_pricing("m", 2.0, 6.0)
    costs = [c.record("a", "m", 1000, 500), c.record("a", "other", 10, 10),
             c.record("b", "m", 5, 0)]
    alerts = []
    s = m.SLAMonitor(latency_p95_target_s=0.5, error_rate_target=0.2,
                     alert=lambda kind, snap: alerts.append(kind), window=4)
    for lat, ok in ((0.1, True), (0.2, True), (0.9, False), (0.3, True), (0.05, False)):
        s.record(lat, ok)
    return costs + [c.bill("a"), c.bill("b"), c.bill("z"), s.snapshot(), alerts]


def run_health(m):
    h = m.HealthMonitor()
    out = [h.status()]
    h.register("engine", lambda: True)
    out.append(h.run_checks())
    h.register("disk", lambda: False)
    out.append(h.run_checks())
    h.register("engine", lambda: 1 / 0)
    return out + [h.run_checks(), h.status()]


def run_checkpoints(m, tmp):
    d = os.path.join(tmp, m.__name__.split(".")[0] + "_ckpt")
    c = m.CheckpointManager(d, every_n_tokens=10, max_per_request=2)
    snap = lambda: {"k": np.arange(4, dtype=np.float32)}
    written = [c.maybe_checkpoint("r", n, snap) for n in (5, 10, 15, 20, 30, 31)]
    out = [None if w is None else os.path.basename(w) for w in written]
    out += [os.path.basename(c.latest("r")), sorted(os.listdir(d)), c.latest("other")]
    c.cleanup("r")
    return out + [sorted(os.listdir(d)), c.latest("r")]


def run_recovery(m):
    r = m.RecoveryManager(max_retries=3, backoff_s=1e-4)
    errs = [RuntimeError("CUDA out of memory"), RuntimeError("deadline passed"),
            ValueError("bad"), RuntimeError("device lost")]
    out = [r.classify(e).name for e in errs]
    calls, ooms = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("out of memory")
        return "done"

    out.append(r.run(flaky, on_oom=lambda: ooms.append(1)))
    try:
        r.run(lambda: (_ for _ in ()).throw(ValueError("always")))
    except ValueError as e:
        out.append(str(e))
    return out + [len(calls), len(ooms), dict(r.stats)]


@pytest.mark.parametrize("case", ["queue", "rate", "rbac", "keys", "filter", "audit",
                                  "cost_sla", "health", "checkpoints", "recovery"])
def test_enterprise_class_matches_jax(case, tmp_path):
    runs = {"queue": run_queue, "rate": run_rate, "rbac": run_rbac, "keys": run_keys,
            "filter": run_filter, "audit": lambda m: run_audit(m, str(tmp_path)),
            "cost_sla": run_cost_sla, "health": run_health,
            "checkpoints": lambda m: run_checkpoints(m, str(tmp_path)),
            "recovery": run_recovery}
    got, ref = both(runs[case])
    assert got == ref


def test_tracer_matches_jax():
    def run(m):
        sunk = []
        tr = m.Tracer(sink=lambda s: sunk.append(s.name))
        with tr.span("outer", model="tiny") as s:
            s.add_event("tick", {"n": 1})
            with tr.span("inner"):
                pass
        try:
            with tr.span("failing"):
                raise ValueError("x")
        except ValueError:
            pass
        return [(s.name, s.attributes, [no_ts(e) for e in s.events], s.status,
                 s.t_end is not None and s.duration_s >= 0) for s in tr.spans] + [sunk]

    got, ref = run(tmet), run(jmet)
    assert got == ref


def test_jsonl_logger_reads_the_port_engine(model, tmp_path):
    """Both packages' loggers over the port's Engine after one request: the
    fields the JAX logger reads exist on the port's engine, and the two
    snapshots agree; the file gets one line a call (per interval when
    one is set)."""
    eng = Engine(model, n_slots=2, n_ctx=64, kv_dtype=torch.float32, device="cpu")
    eng.generate(prompt(6, 1), max_tokens=3, sampling={"greedy": True}, stop_eog=False)
    snaps = []
    for m, name in ((tmet, "port"), (jmet, "jax")):
        log = m.JsonlMetricsLogger(str(tmp_path / f"{name}.jsonl"))
        snaps.append(no_ts(log.log(eng, extra={"path": "/x"})))
        log.log(eng)
        with open(tmp_path / f"{name}.jsonl") as f:
            assert len(f.readlines()) == 2
    assert snaps[0] == snaps[1]
    assert snaps[0]["n_requests"] == 1 and snaps[0]["n_tokens_generated"] == 3
    assert snaps[0]["slots_busy"] == 0 and snaps[0]["queue_depth"] == 0
    paced = tmet.JsonlMetricsLogger(None, interval_s=60)
    assert paced.log(eng) is not None and paced.log(eng) is None
    assert paced.log(eng, force=True) is not None


# ------------------------------------------------------------------ encryption


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_encrypted_files_cross_packages(path, tmp_path, direction):
    enc, dec = (jsec, tsec) if direction == "jax_to_port" else (tsec, jsec)
    key = "a passphrase"
    enc.ModelEncryptor(key).encrypt_file(path, str(tmp_path / "m.enc"))
    assert dec.ModelEncryptor.is_encrypted(str(tmp_path / "m.enc"))
    dec.ModelEncryptor(key).decrypt_file(str(tmp_path / "m.enc"), str(tmp_path / "m.gguf"))
    with open(path, "rb") as a, open(tmp_path / "m.gguf", "rb") as b:
        assert a.read() == b.read()
    hexkey = "00112233445566778899aabbccddeeff" * 2
    assert tsec.ModelEncryptor(hexkey).key == jsec.ModelEncryptor(hexkey).key == bytes.fromhex(hexkey)
    assert tsec.ModelEncryptor(key).key == jsec.ModelEncryptor(key).key


def test_loader_opens_encrypted_gguf(path, model, tmp_path, monkeypatch):
    enc = str(tmp_path / "m.enc")
    tsec.ModelEncryptor("k1").encrypt_file(path, enc)
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    monkeypatch.delenv("SLT_MODEL_KEY", raising=False)
    with pytest.raises(ValueError, match="SLT_MODEL_KEY"):
        load_model(enc, device="cpu")
    monkeypatch.setenv("SLT_MODEL_KEY", "wrong")
    with pytest.raises(ValueError, match="authentication failed"):
        load_model(enc, device="cpu")
    assert os.listdir(scratch) == []
    monkeypatch.setenv("SLT_MODEL_KEY", "k1")
    got = load_model(enc, device="cpu")
    assert os.listdir(scratch) == []              # the decrypted copy is removed
    assert got.hparams == model.hparams
    assert got.tokenizer.vocab.tokens == model.tokenizer.vocab.tokens
    for a, b in zip(got.params["layers"], model.params["layers"]):
        assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------------ profiler


def test_profiler_trace_and_spans(model, tmp_path):
    eng = Engine(model, n_slots=2, n_ctx=64, kv_dtype=torch.float32, device="cpu")
    eng.start()
    try:
        assert eng.on_engine_thread(lambda: profiler.start(str(tmp_path), cuda=False))
        assert profiler.active() == str(tmp_path)
        assert profiler.start(str(tmp_path / "other"), cuda=False) is False
        eng.generate(prompt(6, 2), max_tokens=4, sampling={"greedy": True}, stop_eog=False)
        assert eng.on_engine_thread(profiler.stop) == str(tmp_path)
    finally:
        eng.stop()
    assert profiler.stop() is None and profiler.active() is None
    with open(tmp_path / profiler.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine.prefill", "engine.decode"} <= names


def test_profiler_refuses_a_cpu_only_cuda_trace(monkeypatch):
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot trace the CUDA device"):
        profiler.start(tempfile.gettempdir(), cuda=True)
    assert profiler.active() is None


def test_annotate_passes_exceptions_through():
    err = ValueError("inside the span")
    with pytest.raises(ValueError) as got:
        with profiler.annotate("engine.decode"):
            raise err
    assert got.value is err

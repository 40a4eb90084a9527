"""Slot save / restore / erase and the metrics dict of the port's Engine,
on the CPU (tiny F32 llama):

 - the JAX package's ``test_slot_save_restore_roundtrip``
   (tests/test_engine.py) on the port's f32, bf16, Q8_0 and Q4_0 caches:
   save after a request, continue it through prefix reuse, erase, restore,
   and the continuation repeats;
 - the same with another request on the slot between the erase and the
   restore: the snapshot carries a quantized cache's scales (the JAX
   snapshot omits them), and one without them is refused;
 - the snapshot has the JAX keys and shapes, and an f32 cache's ``.npz``
   written by either package restores in the other with equal
   continuations;
 - a paged cache refuses save and restore and frees the pages on erase; a
   busy slot refuses every action;
 - after the same requests the metrics dict has the JAX keys and counts
   (the seconds excluded), and ``warmup`` leaves it as it was.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from test_torch_fixtures import prompt, torch_one_thread, write_tiny_llama_np  # noqa: F401

# torch on one thread: engine runs of several test workers oversubscribe the
# cores
pytestmark = pytest.mark.usefixtures("torch_one_thread")

GREEDY = {"greedy": True}
KV = {"f32": torch.float32, "bf16": torch.bfloat16, "q8_0": "q8_0", "q4_0": "q4_0"}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama_np(tmp_path_factory.mktemp("slots"))


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load(path)


@pytest.fixture(scope="module")
def jax_engine(jax_model):
    """The JAX engines of one slot by cache type, shared by the tests of
    this file (each compiles its steps once), the slot erased between uses."""
    made = {}

    def get(kv: str):
        if kv not in made:
            made[kv] = JaxEngine(jax_model, n_slots=1, n_ctx=128, prefill_buckets=(16, 64),
                                 kv_dtype=jnp.float32 if kv == "f32" else kv)
        made[kv].slot_erase(0)
        return made[kv]

    return get


def engine(model, kv="f32", **kw):
    kw = {"n_slots": 1, "n_ctx": 128, "prefill_buckets": (16, 64), **kw}
    return Engine(model, kv_dtype=KV[kv], device="cpu", **kw)


def gen(eng, p, n=5):
    return eng.generate(p, max_tokens=n, sampling=GREEDY, stop_eog=False)


def roundtrip(eng, between=None) -> tuple:
    """tests/test_engine.py::test_slot_save_restore_roundtrip on ``eng``
    (``between``: a prompt served on the slot after the erase)."""
    p1 = prompt(34, 20)
    gen(eng, p1, 4)
    snap = eng.slot_save(0)
    assert len(snap["cache_tokens"]) == snap["n_past"] == 37
    p2 = [int(t) for t in snap["cache_tokens"]] + prompt(6, 21)[1:]
    a = gen(eng, p2)
    cached_a = eng.metrics["n_prompt_cached"]
    assert cached_a == 37
    eng.slot_erase(0)
    assert eng.slots[0].cache_tokens == [] and eng.slots[0].n_past == 0
    if between is not None:
        gen(eng, between, 6)
        assert eng.slots[0].cache_tokens[:len(between)] == between
    assert eng.slot_restore(0, snap) == 37
    b = gen(eng, p2)
    assert eng.metrics["n_prompt_cached"] == 2 * cached_a
    return a["tokens"], b["tokens"], snap


@pytest.mark.parametrize("kv", list(KV))
def test_slot_save_restore_roundtrip(model, kv):
    a, b, snap = roundtrip(engine(model, kv))
    assert a == b


@pytest.mark.parametrize("kv", list(KV))
def test_restore_after_another_request_on_the_slot(model, kv):
    """A 60-token request on the erased slot writes its own K/V (and, on a
    quantized cache, scales) over the saved cells; the restore brings the
    saved ones back."""
    a, b, snap = roundtrip(engine(model, kv), between=prompt(60, 22))
    assert a == b
    assert ("k_scale" in snap) == (kv in ("q8_0", "q4_0"))


@pytest.mark.parametrize("kv", ["q8_0", "q4_0"])
def test_quantized_restore_needs_the_scales(model, kv):
    eng = engine(model, kv)
    gen(eng, prompt(20, 23), 3)
    snap = eng.slot_save(0)
    before = (eng.cache.k.clone(), eng.cache.pos.clone())
    with pytest.raises(ValueError, match="scales"):
        eng.slot_restore(0, {k: v for k, v in snap.items() if not k.endswith("_scale")})
    assert torch.equal(eng.cache.k, before[0]) and torch.equal(eng.cache.pos, before[1])


@pytest.mark.parametrize("kv", ["f32", "q8_0"])
def test_snapshot_has_the_jax_keys_and_shapes(model, jax_engine, kv):
    p = prompt(25, 24)
    te, je = engine(model, kv), jax_engine(kv)
    assert gen(te, p)["tokens"] == je.generate(p, max_tokens=5, sampling=GREEDY,
                                               stop_eog=False)["tokens"]
    got, ref = te.slot_save(0), je.slot_save(0)
    assert set(ref) <= set(got)
    for key in ref:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape and g.dtype == r.dtype, key
    assert np.array_equal(got["pos"], ref["pos"]) and got["n_past"] == ref["n_past"] == 29
    assert np.array_equal(got["cache_tokens"], ref["cache_tokens"])
    n = got["n_past"]
    if kv == "f32":
        np.testing.assert_allclose(got["k"][:, :, :n], ref["k"][:, :, :n], rtol=1e-4, atol=1e-4)
    else:
        assert got["k_scale"].shape == got["k"].shape[:-1]


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_npz_files_cross_load(model, jax_engine, tmp_path, direction):
    """An f32 slot saved by one package to ``.npz`` (as the server's save
    action writes it) restores in the other; the continuations through
    prefix reuse are equal."""
    p1 = prompt(30, 25)
    te, je = engine(model), jax_engine("f32")
    cached = je.metrics["n_prompt_cached"]
    src, dst = (je, te) if direction == "jax-to-port" else (te, je)
    src.generate(p1, max_tokens=4, sampling=GREEDY, stop_eog=False)
    np.savez(tmp_path / "slot.npz", **src.slot_save(0))
    with np.load(tmp_path / "slot.npz") as z:
        assert dst.slot_restore(0, dict(z)) == 33
    p2 = [int(t) for t in np.load(tmp_path / "slot.npz")["cache_tokens"]] + prompt(5, 26)[1:]
    outs = [e.generate(p2, max_tokens=6, sampling=GREEDY, stop_eog=False)["tokens"]
            for e in (src, dst)]
    assert outs[0] == outs[1]
    assert te.metrics["n_prompt_cached"] == je.metrics["n_prompt_cached"] - cached == 33


def test_paged_slots_refuse_save_and_erase_frees_pages(model):
    eng = engine(model, paged=True, page_size=16, n_slots=2)
    gen(eng, prompt(40, 27), 4)
    assert eng.pkv.seq_pages(0) == 3
    with pytest.raises(NotImplementedError):
        eng.slot_save(0)
    with pytest.raises(NotImplementedError):
        eng.slot_restore(0, {})
    free = len(eng.pkv.free)
    eng.slot_erase(0)
    assert eng.pkv.seq_pages(0) == 0 and len(eng.pkv.free) == free + 3
    assert eng.slots[0].cache_tokens == [] and eng.slots[0].n_past == 0


@pytest.mark.parametrize("action", ["save", "restore", "erase"])
def test_busy_slot_refuses(model, action):
    eng = engine(model)
    snap = (gen(eng, prompt(20, 28), 2), eng.slot_save(0))[1]
    eng.submit(GenRequest(prompt_ids=prompt(20, 29), max_tokens=30, sampling=GREEDY,
                          stop_eog=False))
    eng.step()
    call = {"save": lambda: eng.slot_save(0), "restore": lambda: eng.slot_restore(0, snap),
            "erase": lambda: eng.slot_erase(0)}[action]
    with pytest.raises(RuntimeError, match="busy"):
        call()
    eng.run_until_drained()


def _metric_run(eng, request, sampled: dict):
    """A lone prompt, a prefix-reusing one, a two-prompt wave and a sampled
    request that runs host-sampled steps (penalties are on the device chain;
    DRY is not)."""
    eng.generate(prompt(30, 30), max_tokens=9, sampling=GREEDY, stop_eog=False)
    first = eng.slots[0].cache_tokens[:38]
    eng.generate(first + prompt(4, 31)[1:], max_tokens=6, sampling=GREEDY, stop_eog=False)
    reqs = [eng.submit(request(prompt_ids=prompt(n, n), max_tokens=7, sampling=GREEDY,
                               stop_eog=False)) for n in (12, 21)]
    eng.run_until_drained()
    [r.result() for r in reqs]
    eng.generate(prompt(10, 32), max_tokens=4, sampling=sampled, stop_eog=False)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_metrics_match_jax(model, jax_model, paged):
    kw = dict(n_slots=2, n_ctx=128, prefill_buckets=(16, 64),
              **({"paged": True, "page_size": 16} if paged else {}))
    sampled = {"temp": 0.7, "seed": 3, "dry_multiplier": 0.8}
    te = Engine(model, kv_dtype=torch.float32, device="cpu", **kw)
    je = JaxEngine(jax_model, kv_dtype=jnp.float32, **kw)
    _metric_run(te, GenRequest, sampled)
    _metric_run(je, JaxRequest, sampled)
    assert set(te.metrics) == set(je.metrics)
    counts = lambda m: {k: v for k, v in m.items() if not k.endswith("_s")}  # noqa: E731
    assert counts(te.metrics) == counts(je.metrics)
    assert te.metrics["n_requests"] == 5 and te.metrics["n_prompt_cached"] == 38
    assert te.metrics["prefill_s"] > 0 and te.metrics["decode_s"] > 0
    assert ("paged" in te.metrics) == paged


def test_warmup_leaves_the_metrics(model):
    eng = engine(model, n_slots=2)
    gen(eng, prompt(20, 33), 3)
    before = dict(eng.metrics)
    eng.warmup()
    assert eng.metrics == before


def test_concurrent_submits_count_every_request(model):
    """Server threads submit at once: 16 threads (more than cores) of 50
    submits each, the interpreter switching threads every microsecond. No
    count is lost and every request is queued once, in arrival order within
    its priority."""
    import sys
    import threading

    eng = engine(model)
    reqs = [GenRequest(prompt_ids=[1, 2], priority=i % 3) for i in range(800)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [eng.submit(r) for r in reqs[k::16]])
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert eng.metrics["n_requests"] == 800
    queued = [eng._queue.get_nowait() for _ in range(eng._queue.qsize())]
    assert sorted(id(r) for *_, r in queued) == sorted(id(r) for r in reqs)
    assert len({seq for _, seq, _ in queued}) == 800
    assert [-p for p, *_ in queued] == sorted((r.priority for r in reqs), reverse=True)

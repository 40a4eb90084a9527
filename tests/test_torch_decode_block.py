"""The port's decode block, its pipeline, DecodeLoop and batched-bench on
the CPU (tiny F32 llama, so both packages compute the same logits to float
rounding):

 - a seeded sampled request that the device chain accepts runs through the
   block path and gives the JAX Engine's tokens, on the dense cache and on
   the paged cache;
 - pipeline depths 1 and 2 serve equal tokens with a stop string, an EOG
   and max_tokens landing inside blocks, and the rollbacks leave every
   cache row holding exactly its accepted tokens (dense and paged);
 - a spilling paged pool gives the ample pool's tokens;
 - DecodeLoop equals the JAX DecodeLoop (greedy and sampled);
 - batched-bench runs (API and CLI);
 - the block and DecodeLoop's steps reach no host sync
   (``aten._local_scalar_dense``, ``aten.nonzero``), so a CUDA graph can
   capture them;
 - a graph replay adds the launches its capture saw, and graphs on the CPU
   raise.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.decode_loop import DecodeLoop as JaxDecodeLoop
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime.decode_loop import DecodeLoop
from superllama_tpu_torch.runtime.engine import Engine, GenRequest, SlotState
from test_torch_fixtures import EOS, prompt, torch_one_thread, write_tiny_llama_np  # noqa: F401

# torch on one thread: engine runs of several test workers oversubscribe the
# cores
pytestmark = pytest.mark.usefixtures("torch_one_thread")

SAMPLED = {"temp": 0.8, "top_k": 40, "top_p": 0.95, "min_p": 0.05, "seed": 7}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama_np(tmp_path_factory.mktemp("blk"))


@pytest.fixture(scope="module")
def model(path):
    return load_model(path, device="cpu")


@pytest.fixture(scope="module")
def jax_model(path):
    return jax_load(path)


def _engine(model, **kw):
    kw = {"n_slots": 3, "n_ctx": 256, "kv_dtype": torch.float32, "device": "cpu", **kw}
    return Engine(model, **kw)


ENGINE_CASES = {
    "dense": ({}, SAMPLED),
    "dense-penalties": ({}, {**SAMPLED, "seed": 123456789012, "penalty_repeat": 1.3,
                             "penalty_present": 0.2, "typical_p": 0.9}),
    "paged": ({"paged": True, "page_size": 16}, {**SAMPLED, "seed": 11}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_seeded_sampled_request_matches_jax(path, model, jax_model, case):
    kw, sm = ENGINE_CASES[case]
    p = prompt(9, 3)
    ref = JaxEngine(jax_model, n_slots=3, n_ctx=256, kv_dtype=jnp.float32, **kw).generate(
        p, max_tokens=21, sampling=sm, stop_eog=False)
    eng = _engine(model, **kw)
    got = eng.generate(p, max_tokens=21, sampling=sm, stop_eog=False)
    assert got["tokens"] == ref["tokens"]
    assert eng.stats["blocks"] >= 2      # the request ran through decode blocks


def _wave(model, specs, **kw):
    eng = _engine(model, **kw)
    reqs = [eng.submit(GenRequest(prompt_ids=p, **r)) for p, r in specs]
    eng.run_until_drained()
    return eng, [r.result() for r in reqs]


def _stop_specs(model, **kw):
    """Three requests: max_tokens inside a block, an EOG drawn inside a
    block (a bias toward EOS), a stop string inside a block (taken from an
    unstopped run of the same request)."""
    biased = {**SAMPLED, "seed": 4, "logit_bias": {EOS: 1.0}}
    text_req = dict(max_tokens=30, sampling={**SAMPLED, "seed": 5}, stop_eog=False)
    p3 = prompt(16, 4)
    _, (free,) = _wave(model, [(p3, text_req)], **kw)
    tok = model.tokenizer
    stop = b"".join(tok.token_to_piece(t) for t in free["tokens"][11:13]).decode(
        "utf-8", errors="replace")
    return [(prompt(8, 1), dict(max_tokens=13, sampling={**SAMPLED, "seed": 1},
                                stop_eog=False)),
            (prompt(24, 2), dict(max_tokens=60, sampling=biased)),
            (p3, dict(text_req, stop_strings=[stop]))]


def _rows_hold_accepted_tokens(eng) -> None:
    """Every slot's cache row holds positions 0..n_past-1 and nothing else."""
    for s in eng.slots:
        if eng.paged:
            _, _, pos = eng.pkv.export_row(s.idx)
            pos = pos.numpy()
            assert np.array_equal(np.sort(pos[pos >= 0]), np.arange(s.n_past))
        else:
            row = eng.cache.pos[s.idx].numpy()
            assert np.array_equal(row[: s.n_past], np.arange(s.n_past))
            assert (row[s.n_past:] == -1).all()
            assert int(eng.cache.cursor[s.idx]) == s.n_past


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_pipeline_depths_serve_equal_tokens(model, kind):
    kw = {"paged": True, "page_size": 32} if kind == "paged" else {}
    specs = _stop_specs(model, **kw)
    outs = []
    for depth in (1, 2):
        eng, res = _wave(model, specs, pipeline_depth=depth, **kw)
        outs.append(res)
        _rows_hold_accepted_tokens(eng)
        assert all(s.state == SlotState.IDLE for s in eng.slots)
        if kind == "dense":
            assert (eng.stats["chained"] > 0) == (depth == 2)
    for a, b in zip(*outs):
        assert a["tokens"] == b["tokens"] and a["finish_reason"] == b["finish_reason"]
    a = outs[0]
    assert len(a[0]["tokens"]) == 13 and a[0]["finish_reason"] == "length"
    assert a[1]["tokens"][-1] == EOS and a[1]["finish_reason"] == "stop"
    # blocks of 8 follow the host-sampled first token: the EOG landed inside one
    assert (len(a[1]["tokens"]) - 1) % 8 != 0
    assert a[2]["finish_reason"] == "stop" and len(a[2]["tokens"]) < 30


def test_spilling_paged_pool_gives_the_ample_pools_tokens(model):
    specs = [(prompt(n, n), dict(max_tokens=40, sampling={**SAMPLED, "seed": n},
                                 stop_eog=False)) for n in (16, 24, 32)]
    _, ample = _wave(model, specs, paged=True, page_size=16)
    eng, spill = _wave(model, specs, paged=True, page_size=16, n_pages=6)
    assert [r["tokens"] for r in spill] == [r["tokens"] for r in ample]
    assert eng.pkv.stats["evictions"] > 0 and eng.pkv.stats["restores"] > 0


@pytest.mark.parametrize("cfg", [{}, {"temp": 0.8, "top_k": 20, "top_p": 0.9}],
                         ids=["greedy", "sampled"])
def test_decode_loop_matches_jax(jax_model, model, cfg):
    p = prompt(11, 6)
    ref = JaxDecodeLoop(jax_model, n_ctx=128, kv_dtype=jnp.float32, **cfg).generate(
        p, 12, seed=3, stop_eog=False)
    loop = DecodeLoop(model, n_ctx=128, kv_dtype=torch.float32, device="cpu", **cfg)
    assert loop.generate(p, 12, seed=3, stop_eog=False) == ref
    assert loop.generate(p, 12, seed=3, stop_eog=False) == ref   # the cache resets
    with pytest.raises(ValueError):
        loop.generate(p, 128)


def test_batched_bench_runs_on_cpu(model):
    from superllama_tpu_torch.tools.batched_bench import format_table, run_batched_bench

    rows = run_batched_bench(model, [(8, 6, 1), (8, 6, 2)], kv_dtype=torch.float32)
    assert [(r.pp, r.tg, r.batch) for r in rows] == [(8, 6, 1), (8, 6, 2)]
    assert all(r.s_pp > 0 and r.s_tg > 0 and r.s_total > 0 for r in rows)
    assert format_table(rows).count("\n") == 3


def test_cli_batched_bench_on_cpu(path, capsys):
    from superllama_tpu_torch.cli import main

    rc = main(["batched-bench", "-m", path, "--pp", "8", "--tg", "5", "--batch", "1", "2",
               "--device", "cpu", "--kv-dtype", "float32"])
    assert rc == 0
    assert "S_TG t/s" in capsys.readouterr().out


class _HostSyncs(TorchDispatchMode):
    FORBIDDEN = ("_local_scalar_dense", "nonzero", "is_nonzero")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.FORBIDDEN:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "chain"])
def test_block_has_no_host_sync(model, kind, greedy):
    kw = {"paged": True, "page_size": 16} if kind == "paged" else {}
    eng = _engine(model, **kw)
    for i in range(2):
        eng.submit(GenRequest(prompt_ids=prompt(9 + i, i), max_tokens=20,
                              sampling={"greedy": True} if greedy else SAMPLED))
    while any(s.state == SlotState.PREFILL or s.req is None for s in eng.slots[:2]):
        eng.step()
    active = [s for s in eng.slots if s.state == SlotState.GENERATING]
    assert eng._stage_block(active) == greedy
    nb = eng.block_size
    eng._io["toks"][nb] = torch.zeros((eng.n_slots, nb), dtype=torch.int64)
    if kind == "paged":
        eng.pkv.plan_step({s.idx: nb for s in active})
    cache = eng.pkv.cache if kind == "paged" else eng.cache
    with torch.no_grad(), _HostSyncs() as mode:
        eng._block(cache, eng._io, nb, None if kind == "paged" else 256, greedy)
    assert mode.seen == []


def test_decode_loop_steps_have_no_host_sync(model):
    loop = DecodeLoop(model, n_ctx=64, kv_dtype=torch.float32, device="cpu", temp=0.8,
                      top_k=20, top_p=0.9, min_p=0.05)
    loop._io["pos"].fill_(0)
    with torch.no_grad(), _HostSyncs() as mode:
        loop._steps(loop._io, 3)
    assert mode.seen == []


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return (0, 1)


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_graph_replays_add_the_captured_launches(monkeypatch):
    """The accounting of runtime/graphs.py with stand-ins for torch's graph
    API: a capture's counter increases are taken back (nothing launched)
    and added on every replay; the warm-up's real launches count once."""
    from superllama_tpu_torch.ops import flash_attention as fa_mod
    from superllama_tpu_torch.ops import qmatmul as qm_mod
    from superllama_tpu_torch.runtime import graphs as graphs_mod

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    qmv, fd = qm_mod.qmv, fa_mod.flash_decode_attention
    monkeypatch.setattr(qmv, "launches", 100)
    monkeypatch.setattr(fd, "launches", 7)

    def block():                     # what a block's wrappers count
        qmv.launches += 5
        fd.launches += 2

    cache = graphs_mod.GraphCache("cuda")
    cache.run("a", block, block)     # warm-up (counted), capture, replay
    assert (qmv.launches, fd.launches) == (100 + 5 + 5, 7 + 2 + 2)
    cache.run("a", block, block)     # replay only
    cache.run("a", block, block)
    assert (qmv.launches, fd.launches) == (100 + 5 + 15, 7 + 2 + 6)
    assert cache.graphs["a"].replays == 3 and cache.stats["block"]["captures"] == 1
    cache.capture("b", lambda: setattr(qmv, "launches", qmv.launches + 1), lambda: None,
                  kind="chunk")
    assert qmv.launches == 120
    cache.replay("b")
    assert qmv.launches == 121 and cache.stats["block"]["replays"] == 3
    assert cache.stats["chunk"]["captures"] == 1 and cache.stats["chunk"]["replays"] == 1
    assert cache.keys() == ["a", "b"] and set(cache.capture_s) == {"a", "b"}


def test_graphs_need_a_cuda_device(model):
    with pytest.raises(ValueError, match="CUDA graphs"):
        _engine(model, graphs=True)

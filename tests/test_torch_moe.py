"""The port's sparse mixture of experts against the JAX package on the CPU:

 - ``_moe_route`` in every variant (softmax / sigmoid gating, the
   renormalisation, DeepSeek-V3's ``exp_probs_b``, grouped selection, the
   routed scale, llama4's top-k on raw logits, a router bias) and with tied
   logits, where both must pick the lower index first;
 - ``_experts_apply`` with and without a gate, with biases, with the router
   weight on the expert input (``expert_weights_before_ffn``), with an
   expert that gets no row and one that gets every row;
 - ``grove_moe`` with duplicate chunk ids, the shared expert with a 1-D and
   a 2-D gate, the port's sparse form against the JAX package's dense
   (conformance) form and its sparse one;
 - the grouped matmul's plain version against ``jax.lax.ragged_dot``, its
   wrapper's launch on CUDA tensors (a recording stand-in for the library),
   its refusals, and a failed build raising;
 - the MoE FFN with no host sync (no count read on the host), so a CUDA
   graph can capture it;
 - ``params_from_jax`` on MoE layers (banks, their biases, chunk banks, a
   1-D shared-expert gate) equal to the port's own loader, MXFP4 banks
   decoded expert by expert bit-equal to the JAX loader's whole-bank decode;
 - a tiny mixtral through the Engine and through ``serve``'s HTTP route,
   token for token against the JAX Engine.

Tolerances: ids exact; router weights and probabilities rtol = atol = 1e-6
(the same f32 softmax / sigmoid); the expert outputs 1e-5 (f32: the
combine adds a token's K rows in top-k order, JAX's scatter-add in sorted
order, so the f32 sums round differently); the plain grouped matmul 1e-5
(f32 sums of exact products); loaded tensors bit-equal; tokens equal.
"""

import json
import types
import urllib.request

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu.models import llama as jllama
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models.hparams import HParams as JHParams
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch.convert import params_from_jax
from superllama_tpu_torch.models import llama as tllama
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models.hparams import HParams as THParams
from superllama_tpu_torch.ops import _build
from superllama_tpu_torch.ops import grouped_matmul as gm
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from superllama_tpu_torch.server.http import Server, ServerApp
from test_torch_fixtures import (MOE_SPECS, N_VOCAB, arch_models, byte_vocab_fields,
                                 cuda_typed, dense_spec, failing_build, prompt,
                                 torch_one_thread, write_arch_gguf)  # noqa: F401

W_TOL = dict(rtol=1e-6, atol=1e-6)
Y_TOL = dict(rtol=1e-5, atol=1e-5)
D, F, NE, K = 32, 24, 16, 4


def _hps(**kw):
    """The same hyperparameters in both packages."""
    base = dict(arch="mixtral", n_vocab=64, n_ctx_train=64, n_embd=D, n_layer=1, n_head=4,
                n_head_kv=2, n_ff=F, n_rot=8, head_dim=8, head_dim_v=8, n_expert=NE,
                n_expert_used=K, expert_weights_norm=True)
    extra = kw.pop("extra", {})
    base.update(kw)
    j, t = JHParams(**base), THParams(**base)
    j.extra.update(extra)
    t.extra.update(extra)
    return j, t


def _r(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _layers(arrs: dict):
    """(JAX layer, port layer) of the same numpy arrays."""
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


def _banks(seed=0, bias=False, gate=True, bank="exps", n=NE):
    out = {f"ffn_up_{bank}": _r(n, D, F, seed=seed + 1, scale=D ** -0.5),
           f"ffn_down_{bank}": _r(n, F, D, seed=seed + 2, scale=F ** -0.5)}
    if gate:
        out[f"ffn_gate_{bank}"] = _r(n, D, F, seed=seed + 3, scale=D ** -0.5)
    if bias:
        out.update({f"ffn_up_{bank}_b": _r(n, F, seed=seed + 4, scale=0.1),
                    f"ffn_down_{bank}_b": _r(n, D, seed=seed + 5, scale=0.1)})
        if gate:
            out[f"ffn_gate_{bank}_b"] = _r(n, F, seed=seed + 6, scale=0.1)
    return out


# ------------------------------------------------------------------ the router

ROUTES = {
    "softmax_norm": dict(),
    "softmax_raw": dict(expert_weights_norm=False),
    "sigmoid": dict(expert_gating_softmax=False, expert_weights_norm=False),
    "sigmoid_probs_b_groups_scale": dict(expert_gating_softmax=False, n_expert_groups=4,
                                         n_group_used=2, expert_weights_scale=2.5),
    "softmax_groups": dict(n_expert_groups=8, n_group_used=3),
    "topk_raw": dict(expert_weights_norm=False, extra={"moe_topk_raw": True}),
    "router_bias": dict(),
}


def _route_layer(case: str, tied: bool):
    w = _r(D, NE, seed=7, scale=1.5 * D ** -0.5)
    if tied:      # equal logits: experts 0 = 1 = 2, 5 = 6, 9 = 12 = 14
        for a, b in ((0, 1), (0, 2), (5, 6), (9, 12), (9, 14)):
            w[:, b] = w[:, a]
    arrs = {"ffn_gate_inp": w}
    if case == "router_bias":
        arrs["ffn_gate_inp_b"] = _r(NE, seed=8, scale=0.5)
    if case.startswith("sigmoid_probs_b"):
        arrs["exp_probs_b"] = _r(NE, seed=9, scale=0.1)
        if tied:
            arrs["exp_probs_b"][[1, 2, 6, 12, 14]] = arrs["exp_probs_b"][[0, 0, 5, 9, 9]]
    return arrs


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("case", list(ROUTES))
def test_moe_route_matches_jax(case, tied):
    jhp, thp = _hps(**dict(ROUTES[case]))
    jl, tl = _layers(_route_layer(case, tied))
    x = _r(2, 5, D, seed=3)
    if tied:
        x[0, 0] = 0.0          # every logit of this row equal: the ids are 0..K-1
    jp, jw, ji = jllama._moe_route(jnp.asarray(x), jl, jhp)
    tp, tw, ti = tllama._moe_route(torch.from_numpy(x), tl, thp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **W_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **W_TOL)
    if tied and case in ("softmax_norm", "softmax_raw", "sigmoid", "topk_raw"):
        assert ti[0, 0].tolist() == list(range(K))


def test_topk_puts_the_lower_index_first_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    v, i = tllama._topk(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 2, 4], [0, 1, 2]]
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ------------------------------------------------------------------ the experts

APPLY = {
    "gate": dict(),
    "no_gate": dict(gate=False),
    "biases": dict(bias=True),
    "weights_before_ffn": dict(extra={"expert_weights_before_ffn": True}),
    "empty_expert": dict(),
    "one_expert_every_row": dict(),
}


def _selection(case: str, S: int, seed=11):
    rng = np.random.default_rng(seed)
    if case == "one_expert_every_row":
        ids = np.full((S, 1), 5)
    else:
        pool = np.arange(1, NE) if case == "empty_expert" else np.arange(NE)
        ids = np.stack([rng.choice(pool, K, replace=False) for _ in range(S)])
    w = rng.uniform(0.05, 1.0, ids.shape).astype(np.float32)
    return w, ids


@pytest.mark.parametrize("case", list(APPLY))
def test_experts_apply_matches_jax(case):
    opts = dict(APPLY[case])
    jhp, thp = _hps(extra=opts.pop("extra", {}))
    jl, tl = _layers(_banks(bias=opts.get("bias", False), gate=opts.get("gate", True)))
    x = _r(2, 6, D, seed=4)
    w, ids = _selection(case, 12)
    if case == "empty_expert":
        assert 0 not in ids
    ref = jllama._experts_apply(jnp.asarray(x), jnp.asarray(w.reshape(2, 6, -1)),
                                jnp.asarray(ids.reshape(2, 6, -1)), jl, jhp)
    got = tllama._experts_apply(torch.from_numpy(x), torch.from_numpy(w.reshape(2, 6, -1)),
                                torch.from_numpy(ids.reshape(2, 6, -1)), tl, thp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **Y_TOL)


def test_grove_moe_with_duplicate_chunk_ids_matches_jax():
    n, ng = 8, 4                      # two chunk experts: ids 0-3 -> 0, 4-7 -> 1
    grove = {"grove": {"n_group_experts": ng, "scale": 0.05}}
    jhp, thp = _hps(n_expert=n, extra=grove)
    arrs = {"ffn_gate_inp": _r(D, n, seed=12, scale=1.5 * D ** -0.5),
            **_banks(seed=20, n=n), **_banks(seed=30, bank="chexps", n=n // ng)}
    jl, tl = _layers(arrs)
    x = _r(3, 4, D, seed=5)
    sel = 1.0 / (1.0 + np.exp(-(x @ arrs["ffn_gate_inp"])))
    chunk = np.argsort(-sel, axis=-1, kind="stable")[..., :2] // ng
    assert (chunk[..., 0] == chunk[..., 1]).any()       # a token's two ids on one chunk
    ref = jllama.grove_moe(jnp.asarray(x), jl, jhp)
    got = tllama.grove_moe(torch.from_numpy(x), tl, thp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **Y_TOL)
    assert tllama.moe_ffn(torch.from_numpy(x), tl, thp).numpy().tolist() == got.numpy().tolist()


@pytest.mark.parametrize("gate", [None, "1d", "2d"])
def test_shared_expert_matches_jax(gate):
    jhp, thp = _hps()
    arrs = {"ffn_gate_shexp": _r(D, 40, seed=13, scale=D ** -0.5),
            "ffn_up_shexp": _r(D, 40, seed=14, scale=D ** -0.5),
            "ffn_down_shexp": _r(40, D, seed=15, scale=40 ** -0.5)}
    if gate == "1d":
        arrs["ffn_gate_inp_shexp"] = _r(D, seed=16)
    elif gate == "2d":
        arrs["ffn_gate_inp_shexp"] = _r(D, 1, seed=16)
    jl, tl = _layers(arrs)
    x, out = _r(2, 3, D, seed=6), _r(2, 3, D, seed=7)
    ref = jllama._moe_shared_expert(jnp.asarray(x), jl, jhp, jnp.asarray(out))
    got = tllama._moe_shared_expert(torch.from_numpy(x), tl, thp, torch.from_numpy(out))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **Y_TOL)


@pytest.mark.parametrize("case", ["plain", "biases_shared", "weights_before_ffn"])
def test_moe_ffn_dense_equals_the_sparse_form(case):
    extra = {"expert_weights_before_ffn": True} if case == "weights_before_ffn" else {}
    jhp, thp = _hps(extra=extra)
    arrs = {"ffn_gate_inp": _r(D, NE, seed=17, scale=1.5 * D ** -0.5),
            **_banks(seed=40, bias=case == "biases_shared")}
    if case == "biases_shared":
        arrs.update(ffn_up_shexp=_r(D, 40, seed=18, scale=D ** -0.5),
                    ffn_down_shexp=_r(40, D, seed=19, scale=40 ** -0.5))
    jl, tl = _layers(arrs)
    x = _r(2, 5, D, seed=8)
    sparse = tllama.moe_ffn(torch.from_numpy(x), tl, thp)
    ref = jllama.moe_ffn_dense(jnp.asarray(x), jl, jhp)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(ref), **Y_TOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jllama.moe_ffn_sparse(
        jnp.asarray(x), jl, jhp)), **Y_TOL)


def test_moe_mesh_waits_for_item_9():
    _, thp = _hps(extra={"moe_mesh": object()})
    with pytest.raises(NotImplementedError, match="item 9"):
        tllama._check_supported(thp)


# ------------------------------------------------------------------ the grouped matmul


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sizes", [(3, 0, 5, 1, 0, 7), (0, 16, 0, 0, 0, 0)],
                         ids=["ragged", "one_group"])
def test_grouped_matmul_plain_matches_ragged_dot(sizes, dtype):
    G, Kin, N = len(sizes), 48, 40
    xs, w = _r(sum(sizes), Kin, seed=21), _r(G, Kin, N, seed=22)
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ref = jax.lax.ragged_dot(jnp.asarray(xs, jt), jnp.asarray(w, jt),
                             jnp.asarray(sizes, jnp.int32), preferred_element_type=jnp.float32)
    off = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    got = gm.grouped_matmul(torch.from_numpy(xs).to(tt), torch.from_numpy(w).to(tt), off)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **Y_TOL)


@pytest.fixture
def fake_gmm(monkeypatch):
    """CUDA-typed tensors reach a recording stand-in for gmm's C entry;
    torch.empty keeps them CUDA-typed; the plain version raises."""
    calls = []

    def slt_gmm(*args):
        calls.append(args)
        return 0
    slt_gmm.argtypes = None
    lib = types.SimpleNamespace(slt_gmm=slt_gmm)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 7)
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: cuda_typed(
        empty(*a, **{k: v for k, v in kw.items() if k != "device"})))

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(gm, "grouped_matmul_plain", plain)
    return calls


@pytest.mark.parametrize("dtype,Kin,N,vec", [(torch.bfloat16, 64, 48, 1),
                                             (torch.float32, 64, 48, 1),
                                             (torch.bfloat16, 100, 50, 0)],
                         ids=["bf16", "f32", "unaligned"])
def test_grouped_matmul_launches_the_kernel_on_cuda(fake_gmm, dtype, Kin, N, vec):
    """One launch a call with the shapes, the type, the copy path, the
    pointers and the stream, counted once; nothing read on the host."""
    xs = cuda_typed(torch.zeros((10, Kin), dtype=dtype))
    w = cuda_typed(torch.zeros((4, Kin, N), dtype=dtype))
    off = cuda_typed(torch.tensor([0, 3, 3, 9, 10], dtype=torch.int32))
    before = gm.grouped_matmul.launches
    out = gm.grouped_matmul(xs, w, off)
    assert out.shape == (10, N) and out.dtype == torch.float32
    assert gm.grouped_matmul.launches == before + 1
    (a,) = fake_gmm
    assert a[:6] == (10, Kin, N, 4, int(dtype == torch.bfloat16), vec)
    assert a[6:] == (xs.data_ptr(), w.data_ptr(), off.data_ptr(), out.data_ptr(), 7)


def test_grouped_matmul_refuses_what_the_kernel_does_not_take(fake_gmm):
    xs = cuda_typed(torch.zeros((4, 16), dtype=torch.bfloat16))
    off = cuda_typed(torch.tensor([0, 2, 4], dtype=torch.int32))
    with pytest.raises(TypeError):
        gm.grouped_matmul(xs, cuda_typed(torch.zeros((2, 16, 8))), off)
    with pytest.raises(ValueError):
        gm.grouped_matmul(xs, cuda_typed(torch.zeros((2, 8, 16), dtype=torch.bfloat16)
                                         .transpose(1, 2)), off)
    with pytest.raises(ValueError):
        gm.grouped_matmul(xs, cuda_typed(torch.zeros((3, 16, 8), dtype=torch.bfloat16)), off)
    assert not fake_gmm


def test_grouped_matmul_raises_when_the_build_fails(monkeypatch):
    build_failed = failing_build(monkeypatch)
    xs = cuda_typed(torch.zeros((4, 16), dtype=torch.bfloat16))
    w = cuda_typed(torch.zeros((2, 16, 8), dtype=torch.bfloat16))
    with pytest.raises(build_failed):
        gm.grouped_matmul(xs, w, cuda_typed(torch.tensor([0, 2, 4], dtype=torch.int32)))


class _HostSyncs(TorchDispatchMode):
    """Records the ops that would make a CUDA tensor sync with the host."""
    FORBIDDEN = ("_local_scalar_dense", "nonzero", "is_nonzero", "bincount")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.FORBIDDEN:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["sparse", "grove", "groups_shared"])
def test_moe_ffn_reads_no_count_on_the_host(monkeypatch, case):
    """The route, the sort, the group bounds and the combine run without a
    host sync; the grouped matmuls get the bounds as a tensor."""
    n = 8
    extra = {"grove": {"n_group_experts": 4, "scale": 0.05}} if case == "grove" else {}
    kw = dict(n_expert_groups=2, n_group_used=1) if case == "groups_shared" else {}
    _, thp = _hps(n_expert=n, extra=extra, **kw)
    arrs = {"ffn_gate_inp": _r(D, n, seed=23), **_banks(seed=50, n=n)}
    if case == "grove":
        arrs.update(_banks(seed=60, bank="chexps", n=2))
    if case == "groups_shared":
        arrs.update(exp_probs_b=_r(n, seed=24), ffn_up_shexp=_r(D, 40, seed=25),
                    ffn_down_shexp=_r(40, D, seed=26), ffn_gate_inp_shexp=_r(D, seed=27))
    _, tl = _layers(arrs)
    seen_offsets = []

    def stand_in(xs, w, offsets):        # a product with no host read
        assert isinstance(offsets, torch.Tensor) and offsets.shape == (w.shape[0] + 1,)
        seen_offsets.append(offsets)
        return xs.float() @ w[0].float()

    monkeypatch.setattr(tllama, "grouped_matmul", stand_in)
    with _HostSyncs() as mode:
        tllama.moe_ffn(torch.from_numpy(_r(2, 3, D, seed=9)), tl, thp)
    assert mode.seen == []
    assert len(seen_offsets) == (6 if case == "grove" else 3)


# ------------------------------------------------------------------ loading and conversion


@pytest.fixture(scope="module")
def moe_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_models")
    return {arch: arch_models(d, arch) for arch in ("qwen2moe", "grovemoe", "gpt-oss")}


@pytest.mark.parametrize("arch", ["qwen2moe", "grovemoe", "gpt-oss"])
def test_params_from_jax_carries_moe_layers(moe_models, arch):
    """Banks (E, in, out), their biases, chunk banks and the shared expert's
    1-D gate cross from the JAX tree to the port's bit for bit, equal to the
    port's own load of the file (gpt-oss: MXFP4 banks, decoded expert by
    expert, equal to the JAX loader's whole-bank decode)."""
    jm, tm = moe_models[arch]
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), tm.hparams,
                           device="cpu")
    keys = {"exps", "chexps", "shexp", "gate_inp"}
    for jl, cl, tl in zip(jm.params["layers"], conv["layers"], tm.params["layers"]):
        moe = {k for k, v in jl.items() if v is not None and any(s in k for s in keys)}
        assert moe and moe == {k for k in tl if any(s in k for s in keys)}
        for k in moe:
            assert torch.equal(cl[k], tl[k]), k
            assert cl[k].shape == tuple(np.asarray(jl[k]).shape)
    if arch == "grovemoe":
        assert conv["layers"][0]["ffn_up_chexps"].dim() == 3
    if arch == "gpt-oss":
        assert tm.hparams.n_expert == 4 and conv["layers"][0]["ffn_down_exps_b"].dim() == 2


BANK_TYPES = ("F16", "Q4_0", "Q8_0", "Q4_K", "Q6_K", "MXFP4")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ttype", BANK_TYPES)
def test_bank_decodes_expert_by_expert_like_jax(tmp_path, ttype, dtype):
    """An (E, out, in) bank of each type, decoded one expert at a time into
    (E, in, out), bit-equal to the JAX loader's decode of the whole bank
    (and to its rounding to bf16)."""
    from superllama_tpu.gguf import GGMLType, GGUFReader, GGUFWriter
    from superllama_tpu.models import loader as jloader
    from superllama_tpu_torch.gguf import GGUFReader as TReader
    from superllama_tpu_torch.models import loader as tloader

    path = str(tmp_path / f"bank_{ttype}.gguf")
    w = GGUFWriter(path, arch="mixtral")
    w.add_tensor("blk.0.ffn_up_exps.weight", _r(3, 40, 256, seed=31), GGMLType[ttype])
    w.write()
    jt, tt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    ref = jloader._get(GGUFReader(path), "blk.0.ffn_up_exps.weight", jt)
    got = tloader._get_bank(TReader(path), "blk.0.ffn_up_exps.weight", tt, "cpu")
    assert got.shape == (3, 256, 40) and got.dtype == tt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def mixtral_path(tmp_path_factory):
    name, md, tensors = dense_spec("mixtral", **{**MOE_SPECS["mixtral"], "V": N_VOCAB})
    return write_arch_gguf(tmp_path_factory.mktemp("mixtral") / "mixtral.gguf", name, md,
                           tensors, vocab_fields=byte_vocab_fields())


def _gen(eng, prompts, max_tokens, request):
    reqs = [eng.submit(request(prompt_ids=p, max_tokens=max_tokens, sampling={"greedy": True},
                               stop_eog=False)) for p in prompts]
    eng.run_until_drained()
    return [r.result()["tokens"] for r in reqs]


WAVE = [prompt(18, 2), prompt(9, 3), prompt(13, 4)]


def test_mixtral_engine_and_server_match_jax(mixtral_path, torch_one_thread):
    """A wave of three through the port's Engine and, one by one, through
    serve's /v1/completions route, against the JAX Engine's tokens."""
    je = JaxEngine(jax_load(mixtral_path), kv_dtype=jnp.float32, iswa=False, n_slots=3,
                   n_ctx=64)
    ref = _gen(je, WAVE, 10, JaxRequest)
    model = load_model(mixtral_path, device="cpu")
    te = Engine(model, kv_dtype=torch.float32, device="cpu", n_slots=3, n_ctx=64, iswa=False)
    assert _gen(te, WAVE, 10, GenRequest) == ref
    app = ServerApp(model, n_slots=2, n_ctx=64, kv_dtype=torch.float32, device="cpu",
                    warmup=False)
    srv = Server(app, port=0)
    srv.start()
    try:
        for p, want in zip(WAVE, ref):
            body = {"prompt": p, "max_tokens": 10, "temperature": 0, "return_tokens": True}
            r = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/completions",
                                       data=json.dumps(body).encode(), method="POST",
                                       headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(r, timeout=120) as resp:
                assert json.loads(resp.read())["choices"][0]["tokens"] == want
    finally:
        srv.stop()

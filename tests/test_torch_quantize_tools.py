"""The port's model-file tools against the JAX package's, on the CPU, with
``write_tiny_llama_np``'s F32 GGUF (2 layers, hidden 256, byte vocab):

 - ``quantize_model`` writes the JAX tool's tensors and bytes (names,
   types, raw blocks, metadata) for Q4_0, Q4_K_M, Q5_K_M, IQ4_XS and an
   i-quant mixture (IQ2_XS), with and without an imatrix (the JAX tool on
   its numpy encoders: its own native build plays no part);
 - ``collect_imatrix`` equals the JAX collector to rtol 1e-5, a save /
   load round trip returns the same values, and a forward with
   ``imatrix=None`` gives the logits of a collecting forward bit for bit
   and runs only the collecting forward's other operations;
 - ``compute_perplexity`` and ``compute_kl_divergence`` within 1e-4
   relative of the JAX results, and the hellaswag, winogrande and
   multiple-choice scorers give the JAX accuracies;
 - the ``quantize``, ``imatrix`` and ``perplexity`` subcommands parse the
   JAX flags to the JAX ``Namespace`` (the port adds ``--device``), and
   run end to end on the CPU; ``perplexity --lora`` exits 2.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from superllama_tpu import cli as jcli
from superllama_tpu import native as jnative
from superllama_tpu.gguf import GGUFReader as JReader
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.tools import imatrix as jimx
from superllama_tpu.tools import perplexity as jppl
from superllama_tpu.tools import quantize as jquant
from superllama_tpu_torch import cli
from superllama_tpu_torch.gguf import GGUFReader
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models.llama import llama_forward
from superllama_tpu_torch.runtime.kv_cache import kv_cache_init
from superllama_tpu_torch.tools import imatrix as timx
from superllama_tpu_torch.tools import perplexity as tppl
from superllama_tpu_torch.tools import quantize as tquant
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import prompt, write_tiny_llama_np

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TEXT = ("Perplexity measures how well a model predicts a text; quantization trades "
        "bits for error. ") * 4
FTYPES = ["Q4_0", "Q4_K_M", "Q5_K_M", "IQ4_XS", "IQ2_XS"]


@pytest.fixture(autouse=True)
def jax_numpy_codecs(monkeypatch):
    """The JAX tools encode on their numpy codecs (its native library's
    build races under xdist; the bytes are the same either way)."""
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama_np(tmp_path_factory.mktemp("qtools"))


@pytest.fixture(scope="module")
def imx(path):
    """A seeded imatrix over every matmul weight of the tiny model."""
    r = GGUFReader(path)
    rng = np.random.default_rng(5)
    out = {n: rng.uniform(0.01, 4.0, ti.ne[0]).astype(np.float32)
           for n, ti in r.tensors.items() if len(ti.ne) == 2}
    r.close()
    return out


def tensors(reader_cls, p) -> dict:
    r = reader_cls(p)
    try:
        return {n: (ti.ggml_type, tuple(ti.ne), ti.raw().tobytes())
                for n, ti in r.tensors.items()}, dict(r.metadata)
    finally:
        r.close()


@pytest.mark.parametrize("with_imatrix", [False, True], ids=["plain", "imatrix"])
@pytest.mark.parametrize("ftype", FTYPES)
def test_quantize_model_matches_jax(path, imx, tmp_path, ftype, with_imatrix):
    m = imx if with_imatrix else None
    got = tquant.quantize_model(path, str(tmp_path / "t.gguf"), ftype, imatrix=m)
    ref = jquant.quantize_model(path, str(tmp_path / "j.gguf"), ftype, imatrix=m)
    assert got == ref
    (tt, tmd), (jt, jmd) = tensors(GGUFReader, str(tmp_path / "t.gguf")), \
        tensors(JReader, str(tmp_path / "j.gguf"))
    assert list(tt) == list(jt) and tt == jt
    assert tmd.keys() == jmd.keys()
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


@pytest.fixture(scope="module")
def models(path):
    return jax_load(path), load_model(path, device="cpu")


def test_collect_imatrix_matches_jax(models, tmp_path):
    jm, tm = models
    batches = [prompt(40, seed=s) for s in range(2)]
    ref = jimx.collect_imatrix(jm, batches, n_ctx=64)
    got = timx.collect_imatrix(tm, batches, n_ctx=64, device="cpu")
    assert sorted(got) == sorted(ref) and len(got) == 2 * 7
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=0)
    timx.save_imatrix(str(tmp_path / "imx.gguf"), got)
    back = timx.load_imatrix(str(tmp_path / "imx.gguf"))
    assert sorted(back) == sorted(got)
    for k in got:
        np.testing.assert_array_equal(back[k], got[k])
    # the JAX loader reads the port's file the same way
    jback = jimx.load_imatrix(str(tmp_path / "imx.gguf"))
    assert all(np.array_equal(jback[k], back[k]) for k in back)


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_forward_without_imatrix_unchanged(models):
    """imatrix=None runs no extra operation: its ops are the collecting
    forward's with the hook's removed, in order, and its logits equal the
    collecting forward's bit for bit."""
    _, tm = models
    hp = tm.hparams
    toks = torch.tensor([prompt(12, seed=3)])
    pos = torch.arange(12, dtype=torch.int32)[None]
    runs = {}
    for key, imatrix in (("none", None), ("dict", {})):
        cache = kv_cache_init(hp.n_layer, 1, 32, hp.n_head_kv, hp.head_dim, dtype=torch.float32)
        with OpLog() as log, torch.no_grad():
            logits, _ = llama_forward(tm.params, hp, toks, pos, cache, imatrix=imatrix)
        runs[key] = logits, log.ops, imatrix
    (a, ops_none, _), (b, ops_dict, d) = runs["none"], runs["dict"]
    assert torch.equal(a, b)
    assert len(d) == 2 * 4 * hp.n_layer       # four hooks a layer, sum and count
    it = iter(ops_dict)
    assert all(op in it for op in ops_none)   # a subsequence, in order
    assert len(ops_dict) > len(ops_none)


@pytest.fixture(scope="module")
def q_paths(path, tmp_path_factory):
    d = tmp_path_factory.mktemp("qfile")
    # a coarse mixture: KL is a sum of differences of f32 log-probabilities
    # (about 5e-7 of rounding each), so the pair compared has a KL far above it
    tquant.quantize_model(path, str(d / "q.gguf"), "IQ2_XS")
    return str(d / "q.gguf")


def test_perplexity_and_kl_match_jax(models, q_paths):
    jm, tm = models
    ids = tm.tokenizer.encode(TEXT, add_special=False)
    assert ids == list(jm.tokenizer.encode(TEXT, add_special=False))
    jsink, tsink = [], []
    ref = jppl.compute_perplexity(jm, ids, n_ctx=64, logits_sink=jsink)
    got = tppl.compute_perplexity(tm, ids, n_ctx=64, logits_sink=tsink, device="cpu")
    assert got.n_tokens == ref.n_tokens == (len(ids) // 64) * 31
    np.testing.assert_allclose([got.ppl, got.nll_sum, *got.per_chunk_ppl],
                               [ref.ppl, ref.nll_sum, *ref.per_chunk_ppl], rtol=1e-4)
    jq, tq = jax_load(q_paths), load_model(q_paths, device="cpu")
    kref = jppl.compute_kl_divergence(jq, ids, jsink, n_ctx=64)
    kgot = tppl.compute_kl_divergence(tq, ids, tsink, n_ctx=64, device="cpu")
    assert kgot.keys() == kref.keys()
    for k in kref:
        np.testing.assert_allclose(kgot[k], kref[k], rtol=1e-4, atol=1e-7)
    assert kgot["kl_mean"] > 0


# every context, ending, sentence and choice of a task has the same length in
# bytes (the byte vocab's tokens), so the JAX scorer compiles its step once
HELLASWAG = "\n".join([
    "The cat sat on the", "2", " rug ball", " big lamp", " warm mat", " old tree",
    "She drank a cup of", "0", " hot milk", " red song", " tall rug", " slow jog",
])
WINOGRANDE = ("index,sentence,option1,option2,answer\n"
              '1,"The box did not fit the case as the _ was big.",box,bag,1\n'
              '2,"Ann gave Mary the small book since _ was kind.",Ann,Bob,1\n')
MULTIPLE_CHOICE = "\n".join(json.dumps(t) for t in (
    {"question": "Two plus two is", "choices": ["four", "five", "nine"], "answer": 0},
    {"question": "The sky is very", "choices": ["pink", "blue", "loud"], "answer": 1}))


@pytest.mark.parametrize("task,text", [("hellaswag", HELLASWAG), ("winogrande", WINOGRANDE),
                                       ("multiple_choice", MULTIPLE_CHOICE)])
def test_task_scores_match_jax(models, task, text):
    jm, tm = models
    ref = getattr(jppl, f"score_{task}")(jm, text, n_ctx=128)
    got = getattr(tppl, f"score_{task}")(tm, text, n_ctx=128, device="cpu")
    assert got == ref and got["n"] == 2


def parsed(main, mod, name, argv, monkeypatch) -> dict:
    """The Namespace ``main(argv)`` hands to ``mod.cmd_<name>``."""
    seen = {}
    monkeypatch.setattr(mod, f"cmd_{name}", lambda a: seen.update(vars(a)) or 0)
    assert main(argv) == 0
    return {k: v for k, v in seen.items() if k not in ("fn", "device")}


ARGVS = [
    ["quantize", "in.gguf", "out.gguf"],
    ["quantize", "in.gguf", "out.gguf", "IQ4_XS", "--imatrix", "m.gguf", "-v"],
    ["imatrix", "-m", "x.gguf", "-f", "c.txt"],
    ["imatrix", "-m", "x.gguf", "-f", "c.txt", "-o", "o.gguf", "-c", "256", "--chunks", "4"],
    ["perplexity", "-m", "x.gguf", "-f", "t.txt"],
    ["perplexity", "-m", "x.gguf", "-f", "t.txt", "-c", "128", "--chunks", "3",
     "--keep-quantized", "--kv-dtype", "float32"],
    ["perplexity", "-m", "x.gguf", "-f", "t.txt", "--hellaswag", "--tasks", "5"],
    ["perplexity", "-m", "x.gguf", "-f", "t.txt", "--winogrande", "--lora", "a.gguf"],
    ["perplexity", "-m", "x.gguf", "-f", "t.txt", "--multiple-choice", "--control-vector",
     "v.gguf:0.5"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[f"{a[0]}{i}" for i, a in enumerate(ARGVS)])
def test_cli_namespace_matches_jax(argv, monkeypatch):
    name = argv[0]
    assert (parsed(cli.main, cli, name, argv, monkeypatch)
            == parsed(jcli.main, jcli, name, argv, monkeypatch))


def test_cli_tools_end_to_end(path, tmp_path, capsys):
    """imatrix → quantize --imatrix → perplexity --keep-quantized on the
    CPU; perplexity refuses an adapter flag with exit code 2."""
    corpus = tmp_path / "c.txt"
    corpus.write_text(TEXT)
    m = str(tmp_path / "imx.gguf")
    assert cli.main(["imatrix", "-m", path, "-f", str(corpus), "-o", m, "-c", "64",
                     "--chunks", "2", "--device", "cpu"]) == 0
    assert "(14 tensors, 2 chunks)" in capsys.readouterr().out
    q = str(tmp_path / "q.gguf")
    assert cli.main(["quantize", path, q, "Q4_K_M", "--imatrix", m]) == 0
    assert json.loads(capsys.readouterr().out.strip()) == {"F32": 5, "Q4_K": 11, "Q6_K": 5}
    assert cli.main(["perplexity", "-m", q, "-f", str(corpus), "-c", "64", "--device", "cpu",
                     "--keep-quantized"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("PPL = ") and "over 155 tokens" in out
    assert cli.main(["perplexity", "-m", q, "-f", str(corpus), "--device", "cpu",
                     "--lora", "a.gguf"]) == 2

"""The port's diffusion LMs (``models/llada.py``, ``runtime/diffusion.py``)
against the JAX package's:

 - the demasking loop apart from any model: both loops driven by one
   deterministic logits function of the window (integer arithmetic, exact
   in f32 on both sides, written once in jnp and once in torch) give equal
   tokens for every schedule × algorithm, and with guidance, gumbel noise,
   Dream's shifted logits, top-k / top-p / temperature sampling and a
   stochastic transfer (``alg_temp``), the same ``default_rng(seed)`` draws
   in the same order;
 - ``llada_forward`` of the four names (llada; dream with q/k/v biases and
   per-head q/k norms; llada-moe and rnd1 with experts) on tiny GGUFs
   loaded by both loaders, logits within 2e-5, and bidirectional (a later
   token moves an earlier position's logits);
 - the registry's forward for the four names;
 - the ``diffusion`` CLI on a tiny llada file with a byte vocab, its text
   equal to the JAX CLI's, and the mask-token refusal.
Torch runs on one thread (``torch_one_thread``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superllama_tpu import cli as jcli
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.models import registry as jregistry
from superllama_tpu.models.llada import llada_forward as jax_llada
from superllama_tpu.runtime import diffusion as jdiff
from superllama_tpu_torch import cli
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.models import registry as tregistry
from superllama_tpu_torch.models.llada import llada_forward
from superllama_tpu_torch.runtime import diffusion as tdiff
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import byte_vocab_fields, dense_spec, write_arch_gguf

MASK, V = 3, 64


def _jax_logits(params, hp, t, pos, cache):
    """(1, L, V) logits, integers / 8: a function of each position's token,
    the window's token sum and the position."""
    L = t.shape[1]
    s = jnp.sum(t, axis=1, keepdims=True)
    v = jnp.arange(V, dtype=jnp.int32)
    p = jnp.arange(L, dtype=jnp.int32)[None, :, None]
    z = (t[..., None] * 31 + v * 17 + s[..., None] * 7 + p * 13) % 97
    return z.astype(jnp.float32) / 8.0, None


def _torch_logits(params, hp, t, pos, cache):
    L = t.shape[1]
    s = torch.sum(t, dim=1, keepdim=True)
    v = torch.arange(V)
    p = torch.arange(L)[None, :, None]
    z = (t[..., None] * 31 + v * 17 + s[..., None] * 7 + p * 13) % 97
    return z.to(torch.float32) / 8.0, None


SCHEDULES = [dict(), dict(schedule="block", block_length=8, steps=6)]
ALGORITHMS = ["confidence", "entropy", "margin", "random", "origin"]
EXTRAS = {
    "cfg": dict(cfg_scale=1.5),
    "gumbel": dict(add_gumbel_noise=True, temperature=0.5, seed=3),
    "shift": dict(shift_logits=True),
    "sampled": dict(temperature=0.8, top_k=8, top_p=0.9, alg_temp=0.5, seed=7),
    "eps": dict(eps=0.1, steps=5),
    "block-sampled": dict(schedule="block", block_length=8, steps=9, temperature=1.2, seed=11),
}


def _loops(kw: dict, prompt=(10, 11, 12, 13), max_length: int = 24):
    kw = {"steps": 8, **kw}
    params = {"token_embd": torch.zeros(1)}
    ref = jdiff.diffusion_generate(_jax_logits, None, None, list(prompt), jdiff.DiffusionParams(
        max_length=max_length, mask_token_id=MASK, **kw))
    got = tdiff.diffusion_generate(_torch_logits, params, None, list(prompt),
                                   tdiff.DiffusionParams(max_length=max_length,
                                                         mask_token_id=MASK, **kw))
    return got, ref


@pytest.mark.parametrize("schedule", [0, 1], ids=["timestep", "block"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_demasking_tokens_equal_jax(schedule, algorithm):
    got, ref = _loops({**SCHEDULES[schedule], "algorithm": algorithm})
    assert got == ref and len(got) == 24 and got[:4] == [10, 11, 12, 13]
    if algorithm != "origin":
        assert MASK not in got[4:]


@pytest.mark.parametrize("extra", sorted(EXTRAS))
def test_demasking_extras_equal_jax(extra):
    got, ref = _loops(EXTRAS[extra])
    assert got == ref


def test_step_callback_sees_the_jax_steps():
    seen = {"jax": [], "port": []}
    kw = dict(steps=6, max_length=12, mask_token_id=MASK)
    jdiff.diffusion_generate(_jax_logits, None, None, [1, 2], jdiff.DiffusionParams(**kw),
                             step_callback=lambda s, n, t: seen["jax"].append((s, n)))
    tdiff.diffusion_generate(_torch_logits, {"token_embd": torch.zeros(1)}, None, [1, 2],
                             tdiff.DiffusionParams(**kw),
                             step_callback=lambda s, n, t: seen["port"].append((s, n)))
    assert seen["port"] == seen["jax"] and seen["port"][0] == (0, 6)


def _spec(arch: str):
    if arch == "llada":
        return dense_spec("llada", V=V)
    if arch == "dream":
        return dense_spec("dream", V=V, qkv_bias=True, qk_norm="head")
    return dense_spec(arch, V=V, qk_norm="head", experts=dict(n=4, k=2, f=48))


DIFFUSION = ("llada", "dream", "llada-moe", "rnd1")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("diffusion")
    out = {}
    for arch in DIFFUSION:
        name, md, tensors = _spec(arch)
        path = write_arch_gguf(d / f"{arch}.gguf", name, md, tensors)
        out[arch] = (jax_load(path), load_model(path, device="cpu"))
    return out


@pytest.mark.parametrize("arch", DIFFUSION)
def test_llada_forward_matches_jax(models, arch, torch_one_thread):
    jm, tm = models[arch]
    assert ("ffn_gate_exps" in tm.params["layers"][0]) == arch.endswith(("moe", "rnd1"))
    toks = np.random.default_rng(0).integers(0, V, (2, 12))
    ref = np.asarray(jax_llada(jm.params, jm.hparams, jnp.asarray(toks, jnp.int32))[0])
    with torch.no_grad():
        got, cache = llada_forward(tm.params, tm.hparams, torch.from_numpy(toks))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    toks2 = toks.copy()
    toks2[:, -1] = (toks2[:, -1] + 1) % V
    with torch.no_grad():
        moved = llada_forward(tm.params, tm.hparams, torch.from_numpy(toks2))[0]
    assert not np.allclose(moved[:, 0].numpy(), got[:, 0].numpy())


@pytest.mark.parametrize("arch", DIFFUSION)
def test_registry_sends_diffusion_names_to_llada_forward(arch):
    assert tregistry.get_forward(arch) is llada_forward
    assert jregistry.get_forward(arch) is jax_llada


@pytest.mark.parametrize("arch,kw", [("llada", dict(steps=4)),
                                     ("dream", dict(shift_logits=True, steps=4)),
                                     ("rnd1", dict(schedule="block", block_length=8, steps=4))])
def test_generate_on_a_model_equals_jax(models, arch, kw, torch_one_thread):
    """The whole loop over the models' own forwards; the tiny f32 models'
    logits agree within 2e-5 and hold no ties among the tokens picked."""
    jm, tm = models[arch]
    dp = dict(max_length=16, mask_token_id=MASK, **kw)
    ref = jdiff.diffusion_generate(jax_llada, jm.params, jm.hparams, [5, 6, 7],
                                   jdiff.DiffusionParams(**dp))
    got = tdiff.diffusion_generate(llada_forward, tm.params, tm.hparams, [5, 6, 7],
                                   tdiff.DiffusionParams(**dp))
    assert got == ref and MASK not in got


@pytest.fixture(scope="module")
def llada_file(tmp_path_factory):
    fields = {**byte_vocab_fields(), "tokenizer.ggml.mask_token_id": 258}
    name, md, tensors = dense_spec("llada", V=len(fields["tokenizer.ggml.tokens"]))
    return write_arch_gguf(tmp_path_factory.mktemp("cli") / "llada.gguf", name, md, tensors,
                           vocab_fields=fields)


def test_diffusion_cli_prints_what_jax_prints(llada_file, capsys, torch_one_thread):
    argv = ["diffusion", "-m", llada_file, "-p", "hi", "--steps", "4", "--max-length", "12",
            "--kv-dtype", "float32"]
    assert cli.main(argv + ["--device", "cpu", "--progress"]) == 0
    out = capsys.readouterr()
    assert "step 3/4" in out.err
    assert jcli.main(argv) == 0
    assert out.out == capsys.readouterr().out and out.out.strip()


def test_diffusion_cli_needs_a_mask_token(tmp_path, capsys):
    name, md, tensors = dense_spec("llada", V=260)
    path = write_arch_gguf(tmp_path / "nomask.gguf", name, md, tensors,
                           vocab_fields=byte_vocab_fields())
    assert cli.main(["diffusion", "-m", path, "-p", "hi", "--device", "cpu"]) == 1
    assert "no mask token" in capsys.readouterr().err
    assert cli.main(["diffusion", "-m", path, "-p", "hi", "--device", "cpu",
                     "--lora", "a.gguf"]) == 2

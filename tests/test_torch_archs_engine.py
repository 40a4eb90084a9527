"""The new architectures in the Engine, and control vectors, against the JAX
package on the CPU:

 - greedy Engine tokens of a LayerNorm model (gptneox: parallel residual,
   fused qkv, gate-less FFN), an ALiBi model (bloom) and a sliding-window
   model (gemma2: window 5, softcaps) equal the JAX Engine's on its flat
   dense cache (``iswa=False``), one request alone and a wave of three,
   and again after ``Engine.warmup`` (an ALiBi and a deci engine);
 - control vectors: ``load_control_vector`` and ``save_control_vector``
   equal the JAX functions; ``generate_control_vector`` gives the JAX
   directions (its ``hidden_sink`` taps); ``run --control-vector
   FILE[:SCALE]`` (repeatable) prints the JAX CLI's text, ``serve`` hands
   the server the summed vectors, and ``cvector-generator`` writes the JAX
   command's directions.

Tolerances: tokens and text equal; a loaded vector bit-equal; generated
directions to atol 1e-4 (unit vectors from f32 hidden states).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from superllama_tpu import cli as jcli
from superllama_tpu.models import cvector as jcv
from superllama_tpu.models import load_model as jax_load
from superllama_tpu.runtime.engine import Engine as JaxEngine
from superllama_tpu.runtime.engine import GenRequest as JaxRequest
from superllama_tpu_torch import cli
from superllama_tpu_torch.models import cvector as tcv
from superllama_tpu_torch.models import load_model
from superllama_tpu_torch.runtime.engine import Engine, GenRequest
from test_torch_fixtures import (DENSE_SPECS, N_VOCAB, arch_spec, byte_vocab_fields,
                                 dense_spec, prompt, torch_one_thread,  # noqa: F401
                                 write_arch_gguf)

GREEDY = {"greedy": True}
ENGINE_ARCHS = ("gptneox", "bloom", "gemma2")


def _write(d, arch) -> str:
    """The arch's tiny spec over the byte vocab (a tokenizer for the CLI)."""
    if arch in DENSE_SPECS:
        name, md, tensors = dense_spec(arch, **{**DENSE_SPECS[arch], "V": N_VOCAB})
    else:
        name, md, tensors = arch_spec(arch)
        tensors["token_embd.weight"] = tensors["token_embd.weight"][:N_VOCAB]
        if "output.weight" in tensors:
            tensors["output.weight"] = tensors["output.weight"][:N_VOCAB]
        md = {**md, "vocab_size": N_VOCAB}
    return write_arch_gguf(d / f"{arch}_vocab.gguf", name, md, tensors,
                           vocab_fields=byte_vocab_fields())


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("arch_engine")
    return {arch: _write(d, arch) for arch in (*ENGINE_ARCHS, "deci", "llama")}


def _gen(eng, prompts, max_tokens, request):
    reqs = [eng.submit(request(prompt_ids=p, max_tokens=max_tokens, sampling=GREEDY,
                               stop_eog=False)) for p in prompts]
    eng.run_until_drained()
    return [r.result()["tokens"] for r in reqs]


PROMPTS = {"alone": [prompt(18, 1)], "wave": [prompt(18, 2), prompt(9, 3), prompt(13, 4)]}


@pytest.mark.parametrize("case", list(PROMPTS))
@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_engine_greedy_matches_jax(paths, arch, case, torch_one_thread):
    kw = dict(n_slots=3, n_ctx=64)
    je = JaxEngine(jax_load(paths[arch]), kv_dtype=jnp.float32, iswa=False, **kw)
    te = Engine(load_model(paths[arch], device="cpu"), kv_dtype=torch.float32,
                device="cpu", iswa=False, **kw)
    assert _gen(te, PROMPTS[case], 10, GenRequest) == _gen(je, PROMPTS[case], 10, JaxRequest)


@pytest.mark.parametrize("arch", ["bloom", "deci"])
def test_engine_after_warmup_matches_jax(paths, arch, torch_one_thread):
    kw = dict(n_slots=2, n_ctx=64)
    je = JaxEngine(jax_load(paths[arch]), kv_dtype=jnp.float32, iswa=False, **kw)
    te = Engine(load_model(paths[arch], device="cpu"), kv_dtype=torch.float32,
                device="cpu", iswa=False, **kw)
    te.warmup()
    p = PROMPTS["wave"][:2]
    assert _gen(te, p, 8, GenRequest) == _gen(je, p, 8, JaxRequest)


# ------------------------------------------------------------------ control vectors


@pytest.fixture(scope="module")
def cv_files(tmp_path_factory):
    """Two control vectors of a 2-layer, 64-wide model, written by the JAX
    package (the first with a layer past the model's, which is ignored)."""
    d = tmp_path_factory.mktemp("cvec")
    rng = np.random.default_rng(5)
    out = []
    for i, n in enumerate((3, 2)):
        path = str(d / f"cv{i}.gguf")
        jcv.save_control_vector(path, rng.normal(0, 0.3, (n, 64)).astype(np.float32))
        out.append(path)
    return out


@pytest.mark.parametrize("scale", [1.0, 0.5, -2.0])
def test_load_control_vector_matches_jax(cv_files, scale):
    for path in cv_files:
        ref = np.asarray(jcv.load_control_vector(path, 2, 64, scale))
        np.testing.assert_array_equal(tcv.load_control_vector(path, 2, 64, scale).numpy(), ref)


def test_save_control_vector_bytes_match_jax(tmp_path):
    dirs = np.random.default_rng(6).normal(0, 1, (3, 64)).astype(np.float32)
    jcv.save_control_vector(str(tmp_path / "j.gguf"), dirs)
    tcv.save_control_vector(str(tmp_path / "t.gguf"), dirs)
    assert (tmp_path / "t.gguf").read_bytes() == (tmp_path / "j.gguf").read_bytes()


# prompts of one length: the JAX generator runs its forward eagerly, and each
# new length compiles every op again
POS = ["I love it", "we adore"]
NEG = ["I hate it", "we abhor"]


def test_generate_control_vector_matches_jax(paths):
    ref = jcv.generate_control_vector(jax_load(paths["llama"]), POS, NEG)
    got = tcv.generate_control_vector(load_model(paths["llama"], device="cpu"), POS, NEG)
    assert got.shape == ref.shape == (2, 64)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_run_with_control_vectors_prints_jax_text(paths, cv_files, capsys):
    argv = ["run", "-m", paths["llama"], "-p", "hello", "-n", "6", "--temp", "0",
            "--kv-dtype", "float32", "--control-vector", cv_files[0] + ":0.5",
            "--control-vector", cv_files[1]]
    assert jcli.main(argv) == 0
    ref = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert out.out == ref and "applied control vector" in out.err
    assert cli.main(argv[:-4] + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out != ref            # the vectors steer the text


def test_serve_hands_the_server_the_summed_vectors(paths, cv_files, monkeypatch):
    from superllama_tpu_torch.server import http

    seen = {}

    class App:
        def __init__(self, model, **kw):
            seen["cvec"] = model.params["cvec"]
            self.warmup_info = None

    class Srv:
        def __init__(self, app, **kw):
            raise SystemExit(0)

    monkeypatch.setattr(http, "ServerApp", App)
    monkeypatch.setattr(http, "Server", Srv)
    with pytest.raises(SystemExit):
        cli.main(["serve", "-m", paths["llama"], "--device", "cpu", "--control-vector",
                  cv_files[0], "--control-vector", cv_files[1] + ":-1"])
    want = (np.asarray(jcv.load_control_vector(cv_files[0], 2, 64))
            + np.asarray(jcv.load_control_vector(cv_files[1], 2, 64, -1.0)))
    np.testing.assert_array_equal(seen["cvec"].numpy(), want)


def test_cvector_generator_cli_matches_jax(paths, tmp_path):
    (tmp_path / "pos.txt").write_text("\n".join(POS) + "\n")
    (tmp_path / "neg.txt").write_text("\n".join(NEG) + "\n\n")
    files = ["--positive-file", str(tmp_path / "pos.txt"), "--negative-file",
             str(tmp_path / "neg.txt")]
    assert jcli.main(["cvector-generator", "-m", paths["llama"], *files,
                      "-o", str(tmp_path / "j.gguf")]) == 0
    assert cli.main(["cvector-generator", "-m", paths["llama"], *files,
                     "-o", str(tmp_path / "t.gguf"), "--device", "cpu"]) == 0
    np.testing.assert_allclose(tcv.load_control_vector(str(tmp_path / "t.gguf"), 2, 64).numpy(),
                               np.asarray(jcv.load_control_vector(str(tmp_path / "j.gguf"), 2,
                                                                  64)), atol=1e-4)

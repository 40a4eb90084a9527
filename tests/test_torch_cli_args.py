"""The port's CLI against the JAX package's, on the CPU:

 - the option table: the port's ``add_options`` gives the JAX ``Namespace``
   for ``run`` and ``serve`` for every option of the JAX table, set by flag,
   by its LLAMA_ARG_* environment mirror, or left at its default (flag
   beats environment beats default); ``--device`` alone differs by
   default (``cuda``, the torch device; JAX: no device list);
 - the port's ``run`` and ``serve`` keep their own flags' defaults
   (``--device cuda``, ``--kv-dtype bfloat16``, the warm-up on, no draft,
   no grammar, no profile); ``serve`` passes ``--api-key``,
   ``--rate-limit``, ``--metrics-file`` and the TLS files to the server;
 - each flag of a feature the port lacks (``cli.UNPORTED``), by flag or by
   environment, makes ``run`` and ``serve`` exit with code 2 before any
   model loads;
 - ``tokenize`` and ``gguf-dump`` print what the JAX commands print, and
   ``encrypt-model`` makes a round trip; ``run --profile-dir`` writes a
   trace; ``sampling_from_args`` and the presets equal the JAX ones.
"""

import argparse
import os

import pytest
import torch

from superllama_tpu import args as jargs
from superllama_tpu import cli as jcli
from superllama_tpu import presets as jpresets
from superllama_tpu_torch import args as targs
from superllama_tpu_torch import cli
from superllama_tpu_torch import presets as tpresets
from test_torch_fixtures import torch_one_thread  # noqa: F401 (a fixture)
from test_torch_fixtures import fim_vocab_fields, write_tiny_llama_np

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TOOLS = ("run", "serve")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama_np(tmp_path_factory.mktemp("cli"), fim_vocab_fields())


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No LLAMA_ARG_* (or other mirrored) variable of the caller leaks in."""
    for o in jargs.OPTIONS:
        monkeypatch.delenv(o.env_name, raising=False)


def namespace(mod, tool: str, argv: list[str]) -> dict:
    p = argparse.ArgumentParser()
    mod.add_options(p, tool)
    return vars(p.parse_args(argv))


def value(o, i: int) -> list[str]:
    """A non-default value of option o as argv strings."""
    if o.choices:
        return [o.choices[-1]]
    if o.type is int:
        return [str(7 + i)]
    if o.type is float:
        return [str(0.25 + i)]
    return [f"v{i}"]      # add_options passes no nargs: one value a flag


def every_flag(tool: str) -> list[str]:
    argv = []
    for i, o in enumerate(jargs.OPTIONS):
        if tool not in o.tools:
            continue
        if o.action:
            argv.append(o.flags[-1])
        else:
            argv += [o.flags[0], *value(o, i)]
            if o.repeatable:
                argv += [o.flags[-1], *value(o, i + 1)]
    return argv


def test_tables_hold_the_same_options():
    assert len(targs.OPTIONS) == len(jargs.OPTIONS) > 250
    for t, j in zip(targs.OPTIONS, jargs.OPTIONS):
        assert (t.flags, t.env_name, t.dest_name, t.tools, t.type, t.action, t.choices,
                t.nargs, t.repeatable) == (j.flags, j.env_name, j.dest_name, j.tools,
                                           j.type, j.action, j.choices, j.nargs, j.repeatable)
        if t.dest_name != "device":
            assert t.default == j.default


@pytest.mark.parametrize("tool", TOOLS)
def test_defaults_match_jax(tool):
    got, ref = namespace(targs, tool, []), namespace(jargs, tool, [])
    assert got.pop("device") == "cuda" and ref.pop("device") is None
    assert got == ref


@pytest.mark.parametrize("tool", TOOLS)
def test_every_flag_matches_jax(tool):
    argv = every_flag(tool)
    got, ref = namespace(targs, tool, argv), namespace(jargs, tool, argv)
    assert got == ref
    assert got["device"] == ref["device"] != "cuda"


@pytest.mark.parametrize("tool", TOOLS)
def test_environment_mirrors_match_jax(tool, monkeypatch):
    """Each option's LLAMA_ARG_* variable becomes its default in both
    tables; a flag still beats it."""
    for i, o in enumerate(jargs.OPTIONS):
        if tool in o.tools:
            monkeypatch.setenv(o.env_name, "1" if o.action else value(o, i)[0])
    got, ref = namespace(targs, tool, []), namespace(jargs, tool, [])
    assert got == ref
    assert got["ctx_size"] == 7 + [o.dest_name for o in jargs.OPTIONS].index("ctx_size")
    flagged = namespace(targs, tool, ["-c", "99"])
    assert flagged["ctx_size"] == namespace(jargs, tool, ["-c", "99"])["ctx_size"] == 99


def test_sampling_and_presets_match_jax():
    argv = ["--temp", "0.5", "--top-k", "12", "--mirostat", "2", "-l", "15+2.5",
            "-l", "16-1", "--dry-multiplier", "0.8"]
    ns = [argparse.ArgumentParser() for _ in range(2)]
    targs.add_options(ns[0], "run")
    jargs.add_options(ns[1], "run")
    got, ref = (targs.sampling_from_args(p.parse_args(argv)) for p in ns)
    assert got == ref and got["logit_bias"] == {15: 2.5, 16: -1.0}
    assert tpresets.BUILTIN_PRESETS == jpresets.BUILTIN_PRESETS
    for name in tpresets.BUILTIN_PRESETS:
        args = {"temp": 0.8, "top_k": 40}
        assert (tpresets.apply_preset(args, tpresets.load_preset(name), {"top_k"})
                == jpresets.apply_preset(args, jpresets.load_preset(name), {"top_k"}))


# ------------------------------------------------------------------ the port's CLI


def parsed(monkeypatch, argv: list[str]) -> argparse.Namespace:
    """The Namespace cli.main hands to run or serve."""
    seen = {}
    for name in ("cmd_run", "cmd_serve"):
        monkeypatch.setattr(cli, name, lambda a: seen.setdefault("args", a) and 0)
    cli.main(argv)
    return seen["args"]


@pytest.mark.parametrize("cmd", TOOLS)
def test_port_flags_keep_their_defaults(monkeypatch, cmd):
    argv = [cmd, "-m", "m.gguf"] + (["-p", "hi"] if cmd == "run" else [])
    a = parsed(monkeypatch, argv)
    assert (a.device, a.kv_dtype, a.ctx_size, a.keep_quantized) == ("cuda", "bfloat16", 2048,
                                                                     False)
    assert (a.draft_model, a.draft_n, a.grammar, a.grammar_file, a.json_schema) == \
        (None, 8, None, None, None)
    if cmd == "run":
        assert (a.n_predict, a.temp, a.seed, a.stream, a.profile_dir) == (128, 0.8, 0, False,
                                                                          None)
    else:
        assert (a.parallel, a.paged_kv, a.kv_page_size, a.kv_pages, a.no_warmup) == \
            (4, False, 256, None, False)
        assert (a.api_key, a.rate_limit, a.metrics_file, a.ssl_cert_file) == (None, 0, None,
                                                                               None)


def test_serve_passes_the_front_door(monkeypatch, tmp_path):
    from superllama_tpu_torch.server import http

    seen = {}

    class App:
        def __init__(self, model, **kw):
            seen["app"] = kw
            self.warmup_info = None

    class Srv:
        def __init__(self, app, **kw):
            seen["server"] = kw
            raise SystemExit(0)

    monkeypatch.setattr(cli, "_load", lambda args: (None, torch.float32))
    monkeypatch.setattr(http, "ServerApp", App)
    monkeypatch.setattr(http, "Server", Srv)
    monkeypatch.setenv("LLAMA_API_KEY", "sk-env")
    with pytest.raises(SystemExit):
        cli.main(["serve", "-m", "m.gguf", "--device", "cpu", "--api-key", "alice=sk-a",
                  "--api-key", "bob=sk=b", "--rate-limit", "30", "--metrics-file",
                  str(tmp_path / "m.jsonl"), "--ssl-cert-file", "c.pem", "--ssl-key-file",
                  "k.pem", "-np", "3", "--no-warmup"])
    # a repeatable option's flags append to its environment value, as in JAX
    assert seen["app"]["api_keys"] == {"sk-env": "default", "sk-a": "alice", "sk=b": "bob"}
    assert seen["app"]["rate_limit_rpm"] == 30 and seen["app"]["n_slots"] == 3
    assert seen["app"]["metrics_path"] == str(tmp_path / "m.jsonl")
    assert seen["app"]["warmup"] is False
    assert (seen["server"]["tls_cert"], seen["server"]["tls_key"]) == ("c.pem", "k.pem")
    assert cli.api_keys_from(["sk-bare"]) == {"sk-bare": "default"}


UNPORTED = [("--lora", "a.gguf"), ("--mmproj", "p.gguf"),
            ("-hf", "user/model"), ("-mu", "http://host/m.gguf")]


REFUSALS = [(cmd, flag, val) for cmd in TOOLS for flag, val in UNPORTED]


@pytest.mark.parametrize("cmd,flag,val", REFUSALS, ids=[f"{c}{f}" for c, f, _ in REFUSALS])
def test_unported_flags_exit_2(monkeypatch, capsys, cmd, flag, val):
    def refuse(args):
        raise AssertionError("a model was loaded")

    monkeypatch.setattr(cli, "_load", refuse)
    head = [cmd, "-m", "m.gguf", "--device", "cpu"] + (["-p", "hi"] if cmd == "run" else [])
    assert cli.main(head + [flag, val]) == 2
    assert "not ported yet" in capsys.readouterr().err
    env = next(o.env_name for o in targs.OPTIONS if flag in o.flags)
    monkeypatch.setenv(env, val)
    assert cli.main(head) == 2


def test_tokenize_prints_what_jax_prints(path, capsys):
    assert cli.main(["tokenize", "-m", path, "Hi <|fim_prefix|>x"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["tokenize", "-m", path, "Hi <|fim_prefix|>x"]) == 0
    assert got == capsys.readouterr().out and got.count("\n") == 6


@pytest.mark.parametrize("flags", [[], ["--no-tensors"]], ids=["tensors", "no-tensors"])
def test_gguf_dump_prints_what_jax_prints(path, capsys, flags):
    assert cli.main(["gguf-dump", path, *flags]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["gguf-dump", path, *flags]) == 0
    assert got == capsys.readouterr().out and "llama.block_count = 2" in got


def test_encrypt_model_round_trip(path, tmp_path, capsys):
    enc, dec = str(tmp_path / "m.enc"), str(tmp_path / "m.gguf")
    assert cli.main(["encrypt-model", path, enc, "--key", "pass"]) == 0
    assert cli.main(["encrypt-model", enc, dec, "--key", "pass", "--decrypt"]) == 0
    with open(path, "rb") as a, open(dec, "rb") as b:
        assert a.read() == b.read()
    assert capsys.readouterr().out.splitlines() == [f"encrypted -> {enc}",
                                                    f"decrypted -> {dec}"]


def test_run_profile_dir_writes_a_trace(path, tmp_path, capsys):
    rc = cli.main(["run", "-m", path, "-p", "hi", "-n", "3", "--temp", "0.7", "--device",
                   "cpu", "--kv-dtype", "float32", "-c", "64", "--profile-dir",
                   str(tmp_path)])
    assert rc == 0 and "3 tokens" in capsys.readouterr().err
    assert os.path.getsize(tmp_path / "trace.json") > 0

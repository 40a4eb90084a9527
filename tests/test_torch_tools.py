"""The port's measurement tools run end to end on the CPU at tiny shapes:
ops_bench, the qmv probe, the decode-attention probe and the llama-bench
subcommand (the counterpart of tests/test_cli.py::test_cli_llama_bench).
On the CPU every kernel wrapper runs its plain version, so the numbers they
print are host timings of the plain versions, labelled with device "cpu"."""

import json
import subprocess
import sys

import pytest
import torch
from test_torch_fixtures import write_tiny_llama

from superllama_tpu.gguf import GGMLType
from superllama_tpu_torch.cli import main as cli_main
from superllama_tpu_torch.tools import flash_decode_probe, ops_bench, qmv_probe

OPS_ENTRIES = ["qmv_q4k_gemv", "qmm_q4k_prefill", "flash_attn_prefill",
               "flash_attn_decode_q8", "flash_attn_decode_q4", "flash_attn_decode_bf16",
               "paged_attn_decode"]


def _json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return write_tiny_llama(tmp_path_factory.mktemp("bench"), (GGMLType.F32,))[GGMLType.F32]


def test_ops_bench_tiny(tmp_path, capsys):
    out = tmp_path / "ops_perf.json"
    assert ops_bench.main(["--tiny", "--device", "cpu", "--out", str(out)]) == 0
    lines = _json_lines(capsys.readouterr().out)
    full = lines[-1]
    assert full["device"] == "cpu" and set(OPS_ENTRIES) <= set(full)
    for name in OPS_ENTRIES:
        entry = full[name]
        assert entry["us_per_call"] > 0 and entry["device"] == "cpu"
        assert entry.get("GBps", entry.get("TFLOPs", 0)) > 0
    assert [next(iter(ln)) for ln in lines[:-1]] == OPS_ENTRIES
    assert json.loads(out.read_text()) == full


def test_qmv_probe_tiny(capsys):
    assert qmv_probe.main(["--tiny", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    res = _json_lines(out)[-1]["qmv_probe"]
    assert [r["variant"] for r in res["rows"]] == ["v0", "v1", "v2", "v3", "v4"]
    for r in res["rows"]:
        assert r["nmse"] <= 1e-4 and r["us_per_call"] > 0
        assert f"{r['variant']}: " in out
    assert res["device"] == "cpu" and res["weight_bytes"] > 0


def test_flash_decode_probe_tiny(capsys):
    assert flash_decode_probe.main(["--tiny", "--device", "cpu"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    cells, rec = lines[:-1], lines[-1]
    assert [c["cell"] for c in cells] == ["B1_T1_S64", "B1_T1_S128", "B2_T1_S64", "B2_T1_S128"]
    for c in cells:
        assert all(c[f"{n}_ms"] > 0 for n in ("plain", "flash", "fdec", "fdq8"))
        assert c["fdec_vs_plain"] == pytest.approx(c["fdec_ms"] / c["plain_ms"])
    assert rec["recommendation"] and rec["cells_fdec_faster"].endswith("/4")


def test_tools_default_to_cuda():
    """Without --device cpu the tools ask for the GPU and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        qmv_probe.run(256, 1024, M=1, R=1, reps=1)
    with pytest.raises(RuntimeError):
        ops_bench.bench_qmv(N=64, K=256, R=1, reps=1)


def test_llama_bench_md(path):
    """python -m superllama_tpu_torch llama-bench, markdown table."""
    r = subprocess.run(
        [sys.executable, "-m", "superllama_tpu_torch", "llama-bench", "-m", path, "-p", "8",
         "-n", "4", "-d", "0,8", "-r", "2", "-c", "64", "--kv-dtype", "float32",
         "--device", "cpu", "-o", "md"], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "| pp8 |" in r.stdout and "| tg4 |" in r.stdout
    assert "pp8@d8" in r.stdout and "tg4@d8" in r.stdout
    assert "| cpu |" in r.stdout


@pytest.mark.parametrize("fmt", ["json", "jsonl", "csv"])
def test_llama_bench_formats(path, capsys, fmt):
    rc = cli_main(["llama-bench", "-m", path, "-p", "8", "-n", "2", "-r", "2", "-c", "64",
                   "--kv-dtype", "float32", "--device", "cpu", "-o", fmt])
    assert rc == 0
    out = capsys.readouterr().out
    if fmt == "json":
        rows = json.loads(out)
    elif fmt == "jsonl":
        rows = [json.loads(ln) for ln in out.strip().splitlines()]
    else:
        lines = out.strip().splitlines()
        assert lines[0] == "model,n_params,test,n_tokens,avg_ts,stddev_ts"
        rows = [dict(zip(("test", "avg_ts"), (ln.split(",")[2], float(ln.split(",")[4]))))
                for ln in lines[1:]]
    assert [r["test"] for r in rows] == ["pp8", "tg2"]
    assert all(float(r["avg_ts"]) > 0 for r in rows)

"""The dry run's cells on the 16x16 mesh at one layer: ``train_4k`` (one
microbatch) and ``prefill_32k`` for the three families the mesh repairs
touched, ``nemotron-4-340b``'s ``train_4k`` (8 KV heads on 16), and the
CLI (``python -m repro_torch.launch.dryrun``) and its sweep. Before the
repairs every one of these cells failed: the attention projection's
product could not be unflattened where tp does not divide the KV heads,
its gradient neither, and MoE's ``bincount`` has no fixed output shape
(``docs/PORT.md``, slice 20). The 2x16x16 cells are in
``tests/test_torch_dryrun_multipod*.py``."""

import json
import os
import subprocess
import sys

import pytest

from _torch_dryrun_cells import ARCHS, run
from repro_torch.launch import dryrun

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_repaired_cells_run_on_16x16(arch, shape, tmp_path):
    run(arch, shape, False, tmp_path)


def test_nemotron_trains_on_16x16(tmp_path):
    rec = run("nemotron-4-340b", "train_4k", False, tmp_path)
    assert rec["attn_policy"] == "head_tp"


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args],
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_the_cli_writes_a_record(tmp_path):
    proc = _cli("--arch", "whisper-tiny", "--shape", "decode_32k", "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1].startswith("OK whisper-tiny__decode_32k__16x16:")
    with open(tmp_path / "whisper-tiny__decode_32k__16x16.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and "n_layers" not in rec
    assert rec["model_flops"] == 2 * rec["active_params"] * 128


def test_the_cli_has_the_references_options_only(tmp_path):
    proc = _cli("--arch", "whisper-tiny", "--shape", "decode_32k", "--layers", "1", "--out",
                str(tmp_path))
    assert proc.returncode == 2 and "unrecognized arguments: --layers" in proc.stderr
    assert not list(tmp_path.iterdir())


def test_the_sweep_never_takes_a_cut_record_for_the_cell(tmp_path, monkeypatch, capsys):
    cut = tmp_path / "qwen2-1.5b__long_500k__2x16x16__1L.json"
    cut.write_text(json.dumps({"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "2x16x16",
                               "n_layers": 1, "status": "ok"}))
    runs = []
    real = subprocess.run

    def counted(cmd, **kw):
        runs.append(cmd[cmd.index("--arch") + 1])
        kw["env"] = dict(os.environ, PYTHONPATH=SRC)
        return real(cmd, **kw)

    monkeypatch.setattr(dryrun.subprocess, "run", counted)
    recs = dryrun.sweep(str(tmp_path), multipod_only=True, cells=[("qwen2-1.5b", "long_500k")])
    assert runs == ["qwen2-1.5b"] and "n_layers" not in recs[0]
    assert "CACHED" not in capsys.readouterr().out


def test_the_cli_fails_on_an_unknown_arch(tmp_path):
    proc = _cli("--arch", "nope", "--shape", "decode_32k", "--out", str(tmp_path))
    assert proc.returncode == 1 and "unknown arch 'nope'" in proc.stderr


def test_the_sweep_caches_and_records_errors(tmp_path, monkeypatch, capsys):
    runs = []
    real = subprocess.run

    def counted(cmd, **kw):
        runs.append(cmd[cmd.index("--arch") + 1])
        kw["env"] = dict(os.environ, PYTHONPATH=SRC)
        return real(cmd, **kw)

    monkeypatch.setattr(dryrun.subprocess, "run", counted)
    cells = [("qwen2-1.5b", "long_500k"), ("nope", "decode_32k")]
    recs = dryrun.sweep(str(tmp_path), multipod_only=True, cells=cells)
    assert [r["status"] for r in recs] == ["skipped", "error"]
    assert "unknown arch" in recs[1]["stderr"]
    assert runs == ["qwen2-1.5b", "nope"]
    recs = dryrun.sweep(str(tmp_path), multipod_only=True, cells=cells)
    assert runs == ["qwen2-1.5b", "nope", "nope"]  # the skipped cell's record is kept
    assert "CACHED qwen2-1.5b__long_500k__2x16x16" in capsys.readouterr().out
    dryrun.sweep(str(tmp_path), force=True, multipod_only=True, cells=cells[:1])
    assert runs[-1] == "qwen2-1.5b"

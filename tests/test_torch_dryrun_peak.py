"""``scripts/dryrun_layers.py sites --peak``: one device's live local bytes
at the dry run's peak, grouped by the call site that allocated them, on a
small cell (``mamba2-2.7b decode_32k`` at one layer, 16x16):

* the groups sum to the record's ``peak_bytes_est`` exactly, and that is
  the peak ``run_cell`` records for the same cell without the watch;
* a large temporary planted in the SSM's decode step (a 1 GiB fp32 tensor
  kept alive across ``_gated_norm``) is the heaviest group, at the planted
  shape, on ``apply_ssm_decode``'s line, and the peak holds its bytes.
"""

import importlib.util
import os

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
CELL = ("mamba2-2.7b", "decode_32k")
#: The planted temporary's elements (fp32): 1 GiB, far above the cell's peak.
PLANTED = 2 ** 28


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "dryrun_layers", os.path.join(ROOT, "scripts", "dryrun_layers.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _peak(script, capsys) -> dict:
    got = script.sites(SRC, *CELL, 1, 0.0, peak=True)
    capsys.readouterr()
    assert not dist.is_initialized()
    return got


def test_the_groups_sum_to_run_cells_peak(script, capsys, tmp_path):
    got = _peak(script, capsys)
    rec = dryrun.run_cell(*CELL, False, str(tmp_path), layers=1)
    assert got["live_bytes_at_peak"] == got["peak_bytes_est"] == rec["memory"]["peak_bytes_est"]
    assert sum(n for _, n in got["rows"].values()) == got["peak_bytes_est"]
    # the state and inputs are among the live bytes, as the step's arguments
    assert any(where == script._PeakWatch.ARGUMENT for _, where, _ in got["rows"])


def test_a_planted_temporary_is_the_top_site(script, capsys, monkeypatch):
    import torch

    from repro_torch.models import ssm

    before = _peak(script, capsys)
    own = ssm._gated_norm

    def planted(*args, **kwargs):
        big = torch.zeros(PLANTED)
        out = own(*args, **kwargs)
        del big
        return out

    monkeypatch.setattr(ssm, "_gated_norm", planted)
    got = _peak(script, capsys)
    (kind, where, shapes), (count, nbytes) = next(iter(got["rows"].items()))
    assert (kind, shapes, count, nbytes) == ("live", f"({PLANTED},) float32", 1, 4 * PLANTED)
    assert where.startswith("forward models/ssm.py:") and "apply_ssm_decode" in where.split(
        " < ")[0]
    assert got["live_bytes_at_peak"] == got["peak_bytes_est"]
    assert got["peak_bytes_est"] >= 4 * PLANTED > before["peak_bytes_est"]

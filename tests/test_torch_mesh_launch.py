"""The launcher's ``--mesh debug``: one run on 8 gloo ranks of the smoke
config for a few steps (the launcher starts the ranks itself), exit 0,
its losses against ``--mesh none``'s, and its refusal on a host with
fewer than 8 cards.

The smoke config trains in bf16, where the sharded contractions add their
partial products in bf16 across ranks: the port's ``debug`` and ``none``
losses differ by 9.4e-6, 2.3e-5 and 2.1e-5 relative over the three steps,
and the reference's own (``python -m repro.launch.train`` on 8 host
devices) by up to 4.1e-5. So the losses are held to 2e-4 relative, a
small multiple of the reference's own gap; the fp32 steps to 1e-5 in
``tests/test_torch_mesh_train.py``.
"""

import pytest
import torch
import torch.distributed as dist

LOSS_TOL = 2e-4


def test_the_launcher_trains_on_the_debug_mesh(tmp_path):
    from repro_torch.launch import train

    common = ["--smoke", "--steps", "3", "--batch", "4", "--seq", "16", "--device", "cpu"]
    plain = train.main(common + ["--ckpt-dir", str(tmp_path / "none")])
    meshed = train.main(common + ["--mesh", "debug", "--ckpt-dir", str(tmp_path / "debug")])
    assert len(meshed.losses) == len(plain.losses) == 3
    for a, b in zip(meshed.losses, plain.losses):
        assert abs(a - b) <= LOSS_TOL * abs(b), (meshed.losses, plain.losses)
    assert sorted(p.name for p in (tmp_path / "debug").iterdir()) == ["step_3"]
    assert not dist.is_initialized()


def test_the_launcher_refuses_the_debug_mesh_on_too_few_cards(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 8 cards, one a rank; this host has 1"):
        train.main(["--mesh", "debug", "--smoke", "--steps", "1"])

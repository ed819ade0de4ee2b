"""CPU smokes of the port's serving tools at a tiny size (the kernels' plain
versions): tools/torch_serving_breakdown.py and
tools/torch_vision_serving_soak.py each end in one JSON line whose figures
hang together."""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import torch_serving_breakdown as sb  # noqa: E402
import torch_vision_serving_soak as soak  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_serving_breakdown_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["torch_serving_breakdown.py", "--device", "cpu",
                                      "--slots", "8", "--depths", "2", "--inner", "8",
                                      "--req-tokens", "16", "--warm-tokens", "8"])
    assert sb.main() == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu" and len(report["configs"]) == 2
    for row in report["configs"]:
        e2e, bd = row["e2e"], row["e2e"]["breakdown"]
        assert row["device"]["tick"] == "scan" and row["device"]["timer"] == "perf_counter"
        assert e2e["tokens"] > 0 and e2e["ticks"] > 0 and row["e2e_fraction_of_device"] > 0
        parts = bd["refill_s"] + bd["dispatch_s"] + bd["readback_wait_s"] + bd["distribute_s"]
        assert parts <= bd["wall_s"] + 1e-3
    assert [row["fetch_async"] for row in report["configs"]] == [False, True]


def test_vision_soak_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "torch_vision_serving_soak.py", "--device", "cpu", "--weights",
        os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml"), "--image-size", "64",
        "--images", "40", "--ladder", "4,8", "--cancels", "4"])
    assert soak.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["transport"] == "u8" and out["ladder"] == [4, 8] and out["device"] == "cpu"
    assert out["completed"] + out["canceled"] == out["images"] == 40
    assert out["offline_img_s"] > 0 and out["e2e_img_s"] > 0
    assert out["breakdown"]["batches"] > 0

"""chip_smoke.py's [pipelined] and [observe] on the CPU.

Pipelined submission with work stealing, and the observability planes
(task events and the timeline, deadlines, metrics, sanitizers), rehearsed
at a small size on a CPU cluster of their own (two CPUs and one GPU as a
resource, no card): through `observe_phases`, as `main` runs them on the
card, and one test for a check that must fail. They sit in a file of their
own: xdist deals whole files, and this one's clusters then run beside the
other smoke files'.
"""

import importlib.util
import json
import pathlib
import re
from dataclasses import replace

import pytest
import torch

from ray_tpu_torch.models import gpt2

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def small_serve_answers(smoke):
    """[main]'s kept answers at a CPU size: a TorchPredictor of a 1-layer
    gpt2_tiny at S 32 (weights seeded 0) on 2 requests of 2 rows."""
    from ray_tpu_torch.train.batch_predictor import TorchPredictor
    from ray_tpu_torch.train.train_step import synthetic_batch

    serve_cfg = replace(gpt2.gpt2_tiny(), n_layer=1, seq_len=32)
    params = gpt2.init(serve_cfg, torch.Generator().manual_seed(0), device="cpu")
    predictor = TorchPredictor(params, smoke.serve_apply_fn(gpt2, serve_cfg),
                               device="cpu")
    answers = [predictor.predict({"tokens": synthetic_batch(serve_cfg, 2, seed=i)
                                  ["tokens"]}) for i in range(2)]
    return {"serve": {"answers": answers, "request_ms": 1.0},
            "serve_cfg": serve_cfg, "requests": 2, "request_batch": 2}


def _row(text: str, tag: str) -> dict:
    line = next(ln for ln in text.splitlines() if ln.startswith(f"[{tag}] {{"))
    return json.loads(line[len(tag) + 3:])


def test_observe_phases_on_the_cpu(smoke, capsys):
    """Every answer equals [main]'s; the burst rode leases of 2 to 10 specs,
    the depth-1 contrast one; the requests behind the blocker were stolen;
    a request past its deadline was shed before dispatch and one under a
    30 s deadline saw its budget; the timeline (written under build/) has
    one FINISHED row per request and each forward span inside its task's
    RUNNING span; summarize_tasks and task_e2e_ms count the requests; no
    lock-order or affinity violation; no launch (the plain versions)."""
    out = smoke.observe_phases("card", small_serve_answers(smoke), device="cpu")
    for tag in smoke.OBSERVE_TAGS:
        assert out[tag]["launches"] == {"flash_fwd": 0, "flash_bwd": 0}, tag
    text = capsys.readouterr().out
    pipelined, observe = _row(text, "pipelined"), _row(text, "observe")
    assert 2 <= pipelined["max_specs_on_one_lease"] <= 10
    assert pipelined["depth_1_max_specs_on_one_lease"] == 1
    assert pipelined["stolen_s"] < smoke.OBSERVE_STOLEN_MAX_S
    assert pipelined["stolen_by_owner"] >= 1
    assert sum(pipelined["steals_by_worker"].values()) >= 1
    assert len(pipelined["pids"]) == 2 and pipelined["cards"] == ["0"]
    assert "DeadlineExceeded" in observe["shed_error"] or "deadline" in observe["shed_error"]
    assert 0 < observe["remaining_time_s"] <= smoke.OBSERVE_DEADLINE_S
    assert observe["spans_outside_running"] == []
    assert observe["summarize_tasks"] == {"FINISHED": observe["requests_run"],
                                          "FAILED": 1}
    assert observe["task_e2e_ms_count"] >= observe["submitted"]
    assert not observe["daemon_violations"].get("lock_order")
    assert not observe["daemon_violations"].get("affinity")
    trace = json.loads((REPO / observe["timeline"]).read_text())
    assert len(trace) == observe["timeline_events"]
    for tag in smoke.OBSERVE_TAGS:
        assert re.search(rf"\[{tag}\] took \d", text)
    assert "processes left []" in text


def test_observe_phases_fail_when_stealing_is_off(smoke, monkeypatch):
    """With the owner's work stealing off, the requests queued behind the
    blocker wait for it (the requeue bound is pinned at 5 s): the stolen
    requests' check fails."""
    from ray_tpu_torch.core.config import _config

    monkeypatch.setattr(_config, "worker_stealing_enabled", False)
    with pytest.raises(SystemExit, match="behind the blocker"):
        smoke.observe_phases("card", small_serve_answers(smoke), device="cpu")

"""``scripts/torch_run_report.py`` (the counterpart of
``scripts/run_report.py``) with ``run_folds`` stubbed: it loops over every
registered config in order, writes the report to ``--out``, refuses the
reference's ``docs/RESULTS.json`` and, by default, runs on the card."""

import importlib.util
import json
import os

import pytest
import torch

from ggnn_tpu_torch.train import CONFIGS, folds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    path = os.path.join(REPO, "scripts", "torch_run_report.py")
    spec = importlib.util.spec_from_file_location("torch_run_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def calls(monkeypatch):
    seen = []

    def fake_run_folds(name, n_folds=10, device="cuda", **kw):
        seen.append((name, n_folds, device, kw))
        return {"config": name, "folds": n_folds, "accuracies": [1.0],
                "mean_accuracy": 1.0, "std_accuracy": 0.0}
    monkeypatch.setattr(folds, "run_folds", fake_run_folds)
    return seen


def test_report_loops_every_config(tmp_path, calls, capsys):
    out = str(tmp_path / "report.json")
    assert _script().main(["--device", "cpu", "--folds", "3",
                           "--out", out]) == 0
    assert [c[0] for c in calls] == sorted(CONFIGS)
    assert all(c[1] == 3 and c[2] == "cpu" for c in calls)
    assert all(c[3]["data_root"] == os.path.join(REPO, "babi_data")
               for c in calls)
    with open(out) as f:
        report = json.load(f)
    assert sorted(report) == sorted(CONFIGS)
    assert report["babi4"]["folds"] == 3
    assert capsys.readouterr().out.strip().endswith(f"wrote {out}")


def test_report_defaults(tmp_path, calls, monkeypatch):
    """``--out`` defaults to docs/RESULTS_torch.json (relative to the
    working directory) and never takes docs/RESULTS.json; the default
    device is the card, which raises without one before any fold."""
    mod = _script()
    with pytest.raises(ValueError, match="reference"):
        mod.main(["--device", "cpu", "--out",
                  os.path.join(REPO, "docs", "RESULTS.json")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--out", str(tmp_path / "x.json")])
    assert calls == []
    monkeypatch.chdir(tmp_path)
    os.mkdir("docs")
    assert mod.main(["--device", "cpu", "--folds", "1"]) == 0
    assert os.path.exists(os.path.join("docs", "RESULTS_torch.json"))

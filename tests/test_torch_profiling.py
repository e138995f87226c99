"""The port's profiling hooks (``ggnn_tpu_torch/profiling.py``, the
counterpart of ``ggnn_tpu/profiling.py``) and the train CLI's
``--profile`` on the CPU: ``trace(None)`` records nothing, a CPU trace is a
Chrome trace holding the block's operators and the ``annotate`` spans,
and ``python -m ggnn_tpu_torch.train ... --profile DIR`` writes one around
the training run.  On the card ``chip_smoke.py``'s ``[profile]`` phase
reads the kernels' launches in the trace."""

import glob
import json
import os

import pytest
import torch

from ggnn_tpu_torch import profiling
from ggnn_tpu_torch.train.__main__ import main as train_main

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(out_dir):
    files = glob.glob(os.path.join(out_dir, "trace_*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def test_trace_none_records_nothing(tmp_path):
    """``trace(None)`` (and an empty path) runs the block and starts no
    profiler: a profiler started inside still works, and no file is
    written."""
    for out in (None, ""):
        with profiling.trace(out, "cpu"):
            with torch.profiler.profile() as prof:
                torch.ones(4).sum()
        assert prof.key_averages() is not None
    assert os.listdir(tmp_path) == []


def test_cpu_trace_holds_ops_and_spans(tmp_path):
    """A CPU trace: the block's operators and the ``annotate`` spans, used
    as a context manager and as a decorator, in one Chrome trace under the
    directory (made if missing)."""
    out = str(tmp_path / "prof")

    @profiling.annotate("ggnn/decorated")
    def work(x):
        return x @ x

    with profiling.trace(out, "cpu"):
        with profiling.annotate("ggnn/span"):
            work(torch.ones(8, 8))
    names = {e.get("name") for e in _events(out)}
    assert {"ggnn/span", "ggnn/decorated", "aten::mm"} <= names


def test_trace_is_written_when_the_block_raises(tmp_path):
    out = str(tmp_path)
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(out, "cpu"):
            torch.ones(2).sum()
            1 / 0
    assert any(e.get("name") == "aten::sum" for e in _events(out))


def test_train_cli_profile_on_cpu(tmp_path, capsys):
    """``--profile DIR`` on the CPU: the run trains and prints its result
    record, and DIR holds one trace of the training run's operators."""
    out = str(tmp_path / "trace")
    assert train_main(["--config", "babi4", "--device", "cpu", "--epochs",
                       "1", "--data_root", os.path.join(REPO, "babi_data"),
                       "--profile", out]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["config"] == "babi4" and result["epochs"] == 1
    names = {e.get("name") for e in _events(out)}
    assert "aten::addmm" in names or "aten::mm" in names

"""``python -m oversim_tpu_torch.service`` on the CPU (24 slots under
lifetime churn): windows, checkpoints, a Perfetto trace, ``--resume``
continuing a run bit-identically, and the flags whose modules are not
ported yet.  Kept apart from test_torch_service.py so that each test
file stays small (ROADMAP: xdist's ``loadfile`` queue is ordered by
tests per file).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_engine import TESTS_DIR

# tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the host
torch.set_num_threads(1)

CLI = ["--device", "cpu", "--n", "12", "--churn", "lifetime", "--lifetime",
       "8", "--engine-window", "0.1", "--window-sim-s", "0.5", "--chunk",
       "5", "--interval", "0.5", "--init-interval", "0.2",
       "--init-deviation", "0"]


def _cli(args, cwd):
    out = subprocess.run(
        [sys.executable, "-m", "oversim_tpu_torch.service", *args],
        check=True, capture_output=True, text=True, timeout=600,
        cwd=str(cwd), env=dict(os.environ, PYTHONPATH=str(TESTS_DIR.parent),
                               OMP_NUM_THREADS="1"))
    return [json.loads(line) for line in out.stdout.splitlines()]


def test_cli_serves_checkpoints_and_resumes(tmp_path):
    """``python -m oversim_tpu_torch.service`` on the CPU: 4 windows with
    a checkpoint every 2 and a Perfetto trace, then ``--resume`` for 2
    more from the checkpoint at window 4, equal to 6 windows run in one
    go; flags whose modules are not ported raise naming ROADMAP."""
    ck = ["--checkpoint", "ck.npz", "--checkpoint-every", "2"]
    recs = _cli([*CLI, "--windows", "4", *ck, "--trace", "t.json"], tmp_path)
    assert recs[-1]["windows_done"] == 4 and recs[-1]["last_checkpoint"] == 4
    spans = {e["name"] for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"window_dispatch", "window_fetch", "checkpoint_write"} <= spans
    resumed = _cli([*CLI, "--windows", "2", *ck, "--resume"], tmp_path)
    assert resumed[1] == {"phase": "resume", "windows_done": 4,
                          "start_sim_t": 0.0, "override_cadence": False}
    whole = _cli([*CLI, "--windows", "6"], tmp_path)
    def same(rec):
        return json.dumps({k: v for k, v in rec.items() if k != "wall_s"})

    assert resumed[-2]["window"] == whole[-2]["window"] == 5
    assert resumed[-2]["_ticks"] > recs[-2]["_ticks"] > 0
    assert same(resumed[-2]) == same(whole[-2])

    from oversim_tpu_torch.service.__main__ import main
    ini = tmp_path / "x.ini"
    # a tier app the port lacks (I3) over an overlay it has
    ini.write_text('**.overlayType = "oversim.overlay.nice.NiceModules"\n'
                   '**.tier1Type = "oversim.applications.i3.OverlayI3"\n')
    for flag in (["--ini", str(ini)], ["--metrics-port", "0"], ["--reshard"],
                 ["--daemon"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main([*CLI, *flag])

"""The port's smoke scripts — scripts/smoke_vo_torch.py,
smoke_slam_torch.py and smoke_rgbd_torch.py — == their JAX twins
(scripts/smoke_*.py), on the CPU.

Each script runs as ``__main__`` with ``--device cpu`` and its twin through
``runpy``; their printouts agree line for line (tests/torch_printout.py:
counts exactly, floats within one printed unit, so the printed poses
and errors too; the wall-time line left out) and both print PASS.
"""
import os

import pytest
import torch

torch.set_num_threads(1)

from torch_printout import printout_diff, run_as_main  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")


@pytest.mark.parametrize("name", ["smoke_vo", "smoke_slam", "smoke_rgbd"])
def test_smoke_script_matches_jax(name):
    code_t, out_t = run_as_main(os.path.join(SCRIPTS, f"{name}_torch.py"), ["--device", "cpu"])
    code_j, out_j = run_as_main(os.path.join(SCRIPTS, f"{name}.py"), [])
    assert code_t == code_j == 0
    assert out_t[-1] == out_j[-1] == "PASS"
    diff = printout_diff(out_t, out_j, skip=("wall:",))
    assert not diff, "\n".join(diff)

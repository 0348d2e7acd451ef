"""Patches for comparing the port's rendered-sequence scripts with their
JAX twins on the CPU (tests/test_torch_tools*.py).

* ``share_renderer``: the port's ``make_room`` and ``render_stereo`` give
  the JAX package's planes and images, so both packages see the same
  pixels.  Each renderer alone is held to the other in
  tests/test_torch_slam.py, where an ulp in the in-quad test may pick the
  other plane on a seam (<= 0.5 % of pixels); one such pixel can move a
  FAST keypoint and a frame's match count by one, which would hide the
  equality of everything downstream.
* ``cut_loops``: both packages' ``loop_trajectory`` cut to its first poses.
* ``record_slam_args``: a loaded script's ``GraphSLAM`` keeps the camera
  and config it is built with; ``config_fields`` spells a config out as
  nested dicts, the same for either package's dataclasses.
* ``app_twins``: an app of the port (``--device cpu``) and its JAX twin
  in apps/, run on the same flags.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import torch

from torch_printout import run_as_main

import srrg2_proslam_tpu.io.synthetic as jsyn
import srrg2_proslam_tpu_torch.io.synthetic as tsyn
from srrg2_proslam_tpu.ops.pinhole import Camera as JaxCamera


def share_renderer(monkeypatch):
    def make_room(*args, device=None, **kw):
        return jsyn.make_room(*args, **kw)

    def render_stereo(cam, T_wc, planes, supersample: int = 2):
        images = jsyn.render_stereo(JaxCamera(**cam._asdict()),
                                    jnp.asarray(T_wc.cpu().numpy()), planes, supersample)
        return tuple(torch.from_numpy(np.array(x)) for x in images)

    monkeypatch.setattr(tsyn, "make_room", make_room)
    monkeypatch.setattr(tsyn, "render_stereo", render_stereo)


def cut_loops(monkeypatch, frames: int):
    for mod in (jsyn, tsyn):
        full = mod.loop_trajectory
        monkeypatch.setattr(mod, "loop_trajectory",
                            lambda *a, _full=full, **k: _full(*a, **k)[:frames])


def record_slam_args(monkeypatch, script_globals) -> list:
    """[(camera, config)] of every GraphSLAM the script's functions build."""
    built, real = [], script_globals["GraphSLAM"]

    def wrapped(cam, config, *args, **kw):
        built.append((cam, config))
        return real(cam, config, *args, **kw)

    monkeypatch.setitem(script_globals, "GraphSLAM", wrapped)
    return built


def config_fields(config) -> dict:
    return {f.name: (config_fields(v) if dataclasses.is_dataclass(v) else v)
            for f in dataclasses.fields(config) for v in [getattr(config, f.name)]}


def app_twins(name: str, argv, out_dir=None):
    """(port's printout, JAX's printout) of app ``name``, both exiting 0.
    ``{out}`` in ``argv`` becomes a folder of each app's own under
    ``out_dir``, and JAX's lines name the port's folder."""
    repo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    dirs = {tag: os.path.join(str(out_dir), tag) for tag in "tj"} if out_dir else {}
    for d in dirs.values():
        os.makedirs(d)
    code_t, out_t = run_as_main(f"srrg2_proslam_tpu_torch.apps.{name}",
                                [a.format(out=dirs.get("t")) for a in argv]
                                + ["--device", "cpu"])
    code_j, out_j = run_as_main(os.path.join(repo, "apps", f"{name}.py"),
                                [a.format(out=dirs.get("j")) for a in argv])
    assert code_t == code_j == 0
    if dirs:
        out_j = [ln.replace(dirs["j"], dirs["t"]) for ln in out_j]
    return out_t, out_j

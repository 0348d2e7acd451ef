"""Each example and tool of the port stands alone: it imports with
``jax``, the JAX package and the repo's root ``apps`` and ``scripts`` blocked
(``sys.modules[name] = None``), and with no ``--device`` it runs on the
card: on this CPU-only build of torch its first tensor on the default
device raises, so no module falls back to the CPU.  ``export_viewer``
holds no tensor code and only imports.  One fresh interpreter per module.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

APPS = ["example_tracking", "example_triangulate_stereo", "example_feature_matching",
        "example_feature_extractor", "example_loop_closure", "example_unproject_rgbd",
        "example_search_patterns", "export_viewer"]
SCRIPTS = ["smoke_vo", "smoke_slam", "smoke_rgbd", "rendered_e2e", "ab_local_ba",
           "ab_seeded_detection", "ab_motion_envelopes", "diag_rendered", "diag_turn"]
# flags that reach the first tensor quickly and write nothing
ARGV = {"example_search_patterns": ["--out", "{tmp}/p.pgm"], "ab_motion_envelopes": ["--fast"],
        "diag_rendered": ["--part", "1"], "diag_turn": ["--cache", "{tmp}/missing.npz"]}

CHILD = r"""
import runpy, sys
for name in ("jax", "jaxlib", "srrg2_proslam_tpu", "apps", "scripts"):
    sys.modules[name] = None
kind, name, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
if kind == "app":
    import importlib
    main = importlib.import_module("srrg2_proslam_tpu_torch.apps." + name).main
else:
    main = runpy.run_path("scripts/" + name + "_torch.py")["main"]
if name == "export_viewer":
    print("imported")
    sys.exit(0)
try:
    main(argv)
except (AssertionError, RuntimeError) as e:
    print("raised:", e)
    sys.exit(0)
print("ran without the card")
sys.exit(1)
"""


@pytest.mark.parametrize("kind,name", [("app", a) for a in APPS]
                         + [("script", s) for s in SCRIPTS])
def test_module_stands_alone_and_needs_the_card(tmp_path, kind, name):
    argv = [a.format(tmp=tmp_path) for a in ARGV.get(name, [])]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", CHILD, kind, name] + argv, cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    if name == "export_viewer":
        assert last == "imported"
    else:
        assert last.startswith("raised:") and "CUDA" in last, last
    assert list(tmp_path.iterdir()) == []

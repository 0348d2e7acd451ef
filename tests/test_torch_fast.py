"""K3's scheme (csrc/fast.cu) == the plain FAST score == the JAX Pallas kernel.

The CUDA kernel tests each pixel's 4 compass differences first, lists the
pixels that pass for each polarity, and scores only those polarities: the
best 9-arc of the raw ring values by van Herk blocks, then one subtraction
of the centre.  ``scheme_scores`` below follows those steps in torch on the
CPU and is held bit-exact (min, max and comparison are exact, and rounding
is monotone, so min(fl(r - c)) = fl(min(r) - c)) against:

* ``kernels/fast.py::fast_scores_plain`` on the whole input;
* JAX ``fast_scores_pallas(..., interpret=True)`` on a crop (each crop is
  scored as an image of its own, zero ring outside it).

Inputs, made from seeds: KITTI frame 0's pair, uniform noise 0..255, an
image of bright squares (many corners and ties), a flat image, and
non-integer N(0, 50^2) values, at thresholds 0, 15 and 40.  Every pixel
the plain version scores above 0 must pass the compass test.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

from srrg2_proslam_tpu.ops.fast_pallas import fast_scores_pallas  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_plain  # noqa: E402
from srrg2_proslam_tpu_torch.ops.features import _FAST_OFFSETS  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "test_data")
COMPASS = (0, 4, 8, 12)     # ring indices of (-3, 0), (0, 3), (3, 0), (0, -3)
CROP = (slice(150, 198), slice(500, 580))


def _compass(images: torch.Tensor):
    """The 4 compass samples (n, e, s, w) of every pixel, zeros outside."""
    H, W = images.shape[-2:]
    padded = F.pad(images, (3, 3, 3, 3))
    return [padded[..., 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
            for dy, dx in _FAST_OFFSETS[list(COMPASS)]]


def compass_test(images: torch.Tensor, t: float):
    """Phase A as the kernel does it: (bright, dark) bool maps from the max
    and the min of each opposite compass pair, one subtraction each."""
    n, e, s, w = _compass(images)
    c = images
    bright = (torch.maximum(n, s) - c > t) & (torch.maximum(e, w) - c > t)
    dark = (torch.minimum(n, s) - c < -t) & (torch.minimum(e, w) - c < -t)
    return bright, dark


def compass_test_by_differences(images: torch.Tensor, t: float):
    """The same test as stated: two adjacent compass differences ring -
    centre > t (bright) or < -t (dark)."""
    d = [r - images for r in _compass(images)]
    bright = ((d[0] > t) & (d[1] > t)) | ((d[1] > t) & (d[2] > t)) \
        | ((d[2] > t) & (d[3] > t)) | ((d[3] > t) & (d[0] > t))
    dark = ((d[0] < -t) & (d[1] < -t)) | ((d[1] < -t) & (d[2] < -t)) \
        | ((d[2] < -t) & (d[3] < -t)) | ((d[3] < -t) & (d[0] < -t))
    return bright, dark


def best_arc(v: torch.Tensor, arc, pick) -> torch.Tensor:
    """[n, 16] ring values -> [n]: ``pick`` over the 16 cyclic 9-arcs of the
    ``arc`` (min or max) of each, by the kernel's van Herk blocks: the
    doubled ring e[0..23] cut at 9 and 18, an arc = a suffix of one block
    joined to a prefix of the next."""
    e = [v[:, i % 16] for i in range(24)]
    s0 = {8: e[8]}
    for i in range(7, -1, -1):
        s0[i] = arc(e[i], s0[i + 1])            # e[i..8]
    p1 = {9: e[9]}
    for i in range(10, 17):
        p1[i] = arc(p1[i - 1], e[i])            # e[9..i]
    s1 = {17: e[17]}
    for i in range(16, 8, -1):
        s1[i] = arc(e[i], s1[i + 1])            # e[i..17]
    p2 = {18: e[18]}
    for i in range(19, 24):
        p2[i] = arc(p2[i - 1], e[i])            # e[18..i]
    w = [s0[0]] + [arc(s0[k], p1[k + 8]) for k in range(1, 9)] + [s1[9]] \
        + [arc(s1[k], p2[k + 8]) for k in range(10, 16)]
    h = 8
    while h:
        w = [pick(w[k], w[k + h]) for k in range(h)]
        h //= 2
    return w[0]


def scheme_scores(images: torch.Tensor, t: float):
    """The kernel's steps: compass test; the bright and the dark candidates
    listed apart; each listed polarity's best arc of the raw ring values,
    then one subtraction (fl is monotone, so this equals the arcs of the
    rounded differences); the larger set polarity above t, zeros elsewhere."""
    B, H, W = images.shape
    bright, dark = compass_test(images, t)
    padded = F.pad(images, (3, 3, 3, 3))

    def ring_and_centre(mask):
        b, y, x = torch.nonzero(mask, as_tuple=True)               # phase B
        ring = torch.stack([padded[b, y + 3 + int(dy), x + 3 + int(dx)]
                            for dy, dx in _FAST_OFFSETS], dim=1)   # [n, 16]
        return (b, y, x), ring, images[b, y, x]

    best = torch.full_like(images, -float("inf"))
    idx, ring, c = ring_and_centre(bright)
    best[idx] = best_arc(ring, torch.minimum, torch.maximum) - c
    idx, ring, c = ring_and_centre(dark)
    best[idx] = torch.maximum(best[idx], c - best_arc(ring, torch.maximum, torch.minimum))
    out = torch.where(best > t, best, 0.0)
    return out, bright, dark


def _kitti(rng):
    frame = next(iter(datasets.iter_bundled_kitti(DATA, "city")))
    return np.stack([frame.left, frame.right]).astype(np.float32)


def _noise(rng):
    return rng.randint(0, 256, (2, 96, 160)).astype(np.float32)


def _squares(rng):
    """Bright squares on a dark ground, as tests/test_torch_features._blobs."""
    img = np.full((2, 96, 160), 40.0, np.float32)
    for _ in range(60):
        y, x = rng.randint(0, 90), rng.randint(0, 154)
        img[:, y:y + rng.randint(3, 7), x:x + rng.randint(3, 7)] = rng.randint(100, 255)
    return img + rng.randint(0, 3, img.shape).astype(np.float32)


def _flat(rng):
    return np.full((1, 64, 96), 128.0, np.float32)


def _gaussian(rng):
    return rng.normal(0.0, 50.0, (2, 96, 160)).astype(np.float32)


INPUTS = {"kitti": _kitti, "noise": _noise, "squares": _squares, "flat": _flat,
          "gaussian": _gaussian}


@pytest.mark.parametrize("thr", [0.0, 15.0, 40.0])
@pytest.mark.parametrize("name", list(INPUTS))
def test_scheme_matches_plain_and_pallas(rng, name, thr):
    images = torch.from_numpy(INPUTS[name](rng))
    got, bright, dark = scheme_scores(images, thr)
    plain = fast_scores_plain(images, thr)
    assert torch.equal(got, plain)
    # the kernel's compass test is the stated one, and the early reject is
    # exact: every corner passes it
    by_differences = compass_test_by_differences(images, thr)
    assert torch.equal(bright, by_differences[0]) and torch.equal(dark, by_differences[1])
    assert not bool(((plain > 0) & ~(bright | dark)).any())
    if name == "flat":
        # zeros around a flat image: only the 3-px frame can be a corner
        assert not bool(plain[:, 3:-3, 3:-3].any())
    else:
        assert int((plain > 0).sum()) > 0

    crop = images[0][CROP] if name == "kitti" else images[0]
    pallas = np.asarray(fast_scores_pallas(jnp.asarray(crop.numpy()), thr, interpret=True))
    np.testing.assert_array_equal(scheme_scores(crop[None], thr)[0][0].numpy(), pallas)


def test_kitti_candidates_are_a_minority(rng):
    """The design's premise on camera images: most pixels are rejected by
    the compass test (about a fifth pass on frame 0's pair at threshold 15)."""
    images = torch.from_numpy(_kitti(rng))
    bright, dark = compass_test(images, 15.0)
    share = float((bright | dark).float().mean())
    corners = float((fast_scores_plain(images, 15.0) > 0).float().mean())
    assert corners < share < 0.3

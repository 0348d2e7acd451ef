"""Port feature frontend and the plain versions of K1/K3 == the JAX package.

* FAST: port ``fast_scores`` equals JAX ``fast_scores`` everywhere (both
  wrap around the edge); K3's plain version, JAX ``fast_scores_pallas``
  (interpret mode) and ``fast_scores`` agree on the interior (8-px margin).
* BRIEF: the dense plain bitplanes equal JAX ``brief_bitplanes`` (interpret
  mode) bit for bit inside BORDER, and their words unpack to the gather
  path's descriptors; K1's per-keypoint plain version equals both JAX forms
  (bitplanes gathered at the keypoints, ``compute_descriptors``), with
  invalid rows, keypoints at the BORDER clip, and frame 0 of a KITTI pair.
* NMS, box filter, detection, descriptors and the batched frontend are
  bit-exact on integer-valued (0..255) images.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from srrg2_proslam_tpu.ops import features as JF  # noqa: E402
from srrg2_proslam_tpu.ops.brief_pallas import (  # noqa: E402
    brief_bitplanes as j_brief, descriptors_from_planes as j_from_planes)
from srrg2_proslam_tpu.ops.fast_pallas import fast_scores_pallas  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.kernels import brief as KB, fast as KF  # noqa: E402
from srrg2_proslam_tpu_torch.ops import features as TF  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "test_data")


def _image(rng, shape):
    return rng.randint(0, 256, shape).astype(np.float32)


def _blobs(rng, shape, n=60):
    """Integer-valued image with corner-rich squares (many FAST ties)."""
    img = np.full(shape, 40.0, np.float32)
    H, W = shape[-2:]
    for _ in range(n):
        y, x = rng.randint(0, H - 6), rng.randint(0, W - 6)
        img[..., y:y + rng.randint(3, 7), x:x + rng.randint(3, 7)] = rng.randint(100, 255)
    return img + rng.randint(0, 3, shape).astype(np.float32)


@pytest.mark.parametrize("thr", [15.0, 40.0])
def test_fast_scores_match_jax(rng, thr):
    img = _image(rng, (2, 60, 90))
    got = TF.fast_scores(torch.from_numpy(img), thr).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.fast_scores(jnp.asarray(img), thr)))
    assert (got > 0).sum() > 100


def test_fast_plain_matches_pallas_interior(rng):
    img = _image(rng, (120, 200))
    plain = KF.fast_scores_plain(torch.from_numpy(img)[None], 15.0)[0].numpy()
    wrap = TF.fast_scores(torch.from_numpy(img), 15.0).numpy()
    pallas = np.asarray(fast_scores_pallas(jnp.asarray(img), 15.0, interpret=True))
    inner = (slice(8, -8), slice(8, -8))
    np.testing.assert_array_equal(plain[inner], pallas[inner])
    np.testing.assert_array_equal(plain[inner], wrap[inner])
    assert (plain[inner] > 0).sum() > 50
    # the plain version follows the kernel's zero padding at the edge too
    np.testing.assert_array_equal(plain, pallas)
    # CPU tensors take the plain version through the wrapper
    np.testing.assert_array_equal(
        KF.fast_scores_kernel(torch.from_numpy(img)[None], 15.0)[0].numpy(), plain)


def test_maxpool_and_boxfilter_match_jax(rng):
    x = rng.uniform(0, 50, (2, 33, 47)).astype(np.float32)
    for w in (3, 4, 5):
        np.testing.assert_array_equal(
            TF._maxpool2d(torch.from_numpy(x), w).numpy(),
            np.asarray(JF._maxpool2d(jnp.asarray(x), w)))
    img = _image(rng, (2, 33, 47))
    for w in (3, 5):
        np.testing.assert_array_equal(
            TF._boxfilter(torch.from_numpy(img), w).numpy(),
            np.asarray(JF._boxfilter(jnp.asarray(img), w)))


def test_brief_plain_matches_pallas_bitplanes(rng):
    H, W = 96, 160
    image = rng.uniform(0, 255, (H, W)).astype(np.float32)
    smooth = np.array(JF._boxfilter(jnp.asarray(image), 5))
    ref = np.asarray(j_brief(jnp.asarray(smooth), interpret=True))
    got = KB.brief_bitplanes_plain(torch.from_numpy(smooth)[None])[0].numpy()
    assert got.dtype == np.int32 and got.shape == (8, H, W)
    b = JF.BORDER
    np.testing.assert_array_equal(got[:, b:H - b, b:W - b], ref[:, b:H - b, b:W - b])
    # unpacking the words gives the JAX unpacking and the gather path
    n = 40
    y = rng.randint(b, H - b, n)
    x = rng.randint(b, W - b, n)
    unpacked = KB.descriptors_from_planes(torch.from_numpy(got), torch.from_numpy(y),
                                          torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        unpacked, np.asarray(j_from_planes(jnp.asarray(ref), jnp.asarray(y), jnp.asarray(x))))
    cfg = JF.FeatureExtractorConfig(dense_brief=False)
    uv = np.stack([x, y], 1).astype(np.float32)
    gather = np.asarray(JF.compute_descriptors(jnp.asarray(image), jnp.asarray(uv),
                                               jnp.ones(n, bool), cfg))
    np.testing.assert_array_equal(unpacked, gather)


def test_brief_descriptors_plain_match_jax(rng):
    """The 96x160 case above, B = 2, through the K1 wrapper on CPU tensors."""
    B, H, W, n = 2, 96, 160, 40
    images = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    smooth = np.array(JF._boxfilter(jnp.asarray(images), 5))
    b = JF.BORDER
    y = rng.randint(b, H - b, (B, n))
    x = rng.randint(b, W - b, (B, n))
    y[:, :4] = [b, b, H - b - 1, H - b - 1]        # the corners of the BORDER clip
    x[:, :4] = [b, W - b - 1, b, W - b - 1]
    valid = rng.uniform(size=(B, n)) < 0.75
    valid[:, :2] = [False, True]
    got = KB.brief_descriptors(torch.from_numpy(smooth), torch.from_numpy(y).long(),
                               torch.from_numpy(x).long(), torch.from_numpy(valid)).numpy()
    assert got.dtype == np.int8 and got.shape == (B, n, 256)
    assert np.all(got[~valid] == -1) and np.all(np.abs(got) == 1)
    assert 0.3 < (got[valid] == 1).mean() < 0.7
    planes = j_brief(jnp.asarray(smooth), interpret=True)
    cfg = JF.FeatureExtractorConfig(dense_brief=False)
    for i in range(B):
        dense = np.asarray(j_from_planes(planes[i], jnp.asarray(y[i]), jnp.asarray(x[i])))
        np.testing.assert_array_equal(got[i], np.where(valid[i][:, None], dense, -1))
        uv = np.stack([x[i], y[i]], 1).astype(np.float32)
        gather = JF.compute_descriptors(jnp.asarray(images[i]), jnp.asarray(uv),
                                        jnp.asarray(valid[i]), cfg)
        np.testing.assert_array_equal(got[i], np.asarray(gather))


def test_brief_descriptors_plain_match_jax_on_kitti_keypoints():
    """Frame 0's real keypoints of the bundled KITTI pair, B = 2."""
    frame = next(iter(datasets.iter_bundled_kitti(DATA, "city")))
    images = torch.from_numpy(np.stack([frame.left, frame.right]))
    cfg = TF.FeatureExtractorConfig()
    uv, _, valid = TF.detect_keypoints_batch(images, cfg)
    smooth = TF._boxfilter(images, cfg.smoothing_window)
    y, x = TF._keypoint_rows_cols(uv, images.shape[1], images.shape[2])
    got = KB.brief_descriptors(smooth, y, x, valid).numpy()
    assert int(valid.sum()) > 1500
    j_cfg = JF.FeatureExtractorConfig(dense_brief=False)
    for i in range(2):
        ref = JF.compute_descriptors(jnp.asarray(images[i].numpy()), jnp.asarray(uv[i].numpy()),
                                     jnp.asarray(valid[i].numpy()), j_cfg)
        np.testing.assert_array_equal(got[i], np.asarray(ref))


def test_brief_descriptors_input_checks():
    smooth = torch.zeros(2, 40, 50)
    y = torch.full((2, 3), 20, dtype=torch.int64)
    ok = torch.ones(2, 3, dtype=torch.bool)
    for args in [(smooth.double(), y, y, ok), (smooth, y.int(), y, ok),
                 (smooth, y, y[:, :2], ok), (smooth[:1], y, y, ok), (smooth, y, y, ok.int())]:
        with pytest.raises(ValueError):
            KB.brief_descriptors(*args)


@pytest.mark.parametrize("kind,nms", [("noise", True), ("blobs", True), ("blobs", False)])
def test_detect_and_describe_match_jax(rng, kind, nms):
    imgs = _image(rng, (2, 80, 130)) if kind == "noise" else _blobs(rng, (2, 80, 130))
    kw = dict(max_keypoints=90, grid_rows=3, grid_cols=3, enable_nms=nms)
    got = TF.extract_features_batch(torch.from_numpy(imgs), TF.FeatureExtractorConfig(**kw))
    ref = JF.extract_features_batch(jnp.asarray(imgs), JF.FeatureExtractorConfig(**kw))
    for name in ("uv", "response", "desc", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert int(got.valid.sum()) > 20


def test_detect_padding_matches_jax(rng):
    imgs = _image(rng, (1, 70, 100))
    kw = dict(max_keypoints=100, grid_rows=2, grid_cols=3)   # 100 % 6 != 0: padding
    got = TF.detect_keypoints_batch(torch.from_numpy(imgs), TF.FeatureExtractorConfig(**kw))
    ref = JF.detect_keypoints_batch(jnp.asarray(imgs), JF.FeatureExtractorConfig(**kw))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fast_wrapper_path_keeps_valid_keypoints(rng):
    """use_pallas_fast routes a CPU batch through K3's wrapper (zero-padded
    ring): valid keypoints and descriptors equal JAX's default path."""
    imgs = _blobs(rng, (2, 80, 130))
    kw = dict(max_keypoints=90, grid_rows=3, grid_cols=3)
    got = TF.extract_features_batch(torch.from_numpy(imgs),
                                    TF.FeatureExtractorConfig(use_pallas_fast=True, **kw))
    ref = JF.extract_features_batch(jnp.asarray(imgs), JF.FeatureExtractorConfig(**kw))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.uv.numpy()[valid], np.asarray(ref.uv)[valid])
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(ref.response))
    np.testing.assert_array_equal(got.desc.numpy(), np.asarray(ref.desc))


def test_oriented_is_not_ported(rng):
    cfg = TF.FeatureExtractorConfig(oriented=True)
    with pytest.raises(NotImplementedError):
        TF.extract_features_batch(torch.zeros(1, 40, 40), cfg)

"""BOSS-JSON message logs: reader and writer.

Port of srrg2_proslam_tpu/io/boss.py (host code; plain Python and numpy).
A log is a sequence of BOSS blocks, ``"ClassName" { json with //-comments }``,
one per message: ``ImageMessage`` (topic, frame_id, seq, timestamp, image
payload), ``CameraInfoMessage`` (3x3 camera matrix, depth scale) and
``TransformEventsMessage`` (the stereo extrinsic camera_right-in-
camera_left, and the ground truth camera_left-in-world).  The reader
reassembles synchronized stereo or RGB-D frames and the camera model.
Image payloads, in order of preference:

  * binary BLOBs in the log's ``<log>.d/`` directory, referenced by a
    ``{"#pointer": id}`` resolved through a ``...BLOBReference`` block (or
    directly by a file-name string).  The pixels are taken by geometry:
    the message's ``image_rows``/``image_cols`` give the trailing
    ``rows*cols*bpp`` block (bpp 4 float, 3 RGB8, 2 uint16 depth, 1 uint8)
    whatever header precedes it; the writer's own (u64 rows, u64 cols,
    u32 type) header is recognised first;
  * ``image_file`` indirection (image files next to the log);
  * inline ``image_data`` nested rows.
"""
from __future__ import annotations

import json
import os
import re
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .datasets import StereoFrame, RGBDFrame, load_gray
from ..ops.pinhole import Camera


# ---------------------------------------------------------------------------
# block-level parsing (shared syntax with the reference .conf files)
# ---------------------------------------------------------------------------

def _strip_comments(text: str) -> str:
    """Remove //-comments outside of string literals."""
    out = []
    in_str = False
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if in_str:
            out.append(c)
            if c == "\\" and i + 1 < n:
                out.append(text[i + 1])
                i += 2
                continue
            if c == '"':
                in_str = False
            i += 1
            continue
        if c == '"':
            in_str = True
            out.append(c)
            i += 1
            continue
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                i += 1
            continue
        out.append(c)
        i += 1
    return "".join(out)


_BLOCK_HEAD = re.compile(r'"([A-Za-z_][A-Za-z0-9_]*)"\s*\{')


def parse_boss(text: str) -> List[Tuple[str, dict]]:
    """Parse BOSS block text -> [(class_name, payload_dict), ...]."""
    text = _strip_comments(text)
    objects = []
    pos = 0
    while True:
        m = _BLOCK_HEAD.search(text, pos)
        if m is None:
            break
        depth = 0
        i = m.end() - 1  # at the '{'
        in_str = False
        while i < len(text):
            c = text[i]
            if in_str:
                if c == "\\":
                    i += 1
                elif c == '"':
                    in_str = False
            elif c == '"':
                in_str = True
            elif c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        body = text[m.end() - 1:i + 1]
        objects.append((m.group(1), json.loads(body)))
        pos = i + 1
    return objects


def parse_boss_file(path: str) -> List[Tuple[str, dict]]:
    with open(path) as f:
        return parse_boss(f.read())


# ---------------------------------------------------------------------------
# message-level reassembly
# ---------------------------------------------------------------------------

#: keys under which an ImageMessage may reference its pixel payload
_IMAGE_KEYS = ("image_data", "image", "data")


def _blob_registry(objects) -> dict:
    """Map ``#id`` -> payload dict for BLOB-reference resolution.

    srrg2_core serializes a BLOB as an inline ``{"#pointer": id}`` in the
    owning message plus a separate ``*BLOBReference`` block (same id)
    naming the binary file inside the log's ``<log>.d/`` directory.
    """
    reg = {}
    for _name, obj in objects:
        if isinstance(obj, dict) and "#id" in obj:
            reg[obj["#id"]] = obj
    return reg


def _blob_file_name(obj: dict):
    """Binary payload file name from a BLOB-reference block (any key that
    names a file; srrg2_core uses ``file_name``)."""
    for key in ("file_name", "filename", "name", "path"):
        v = obj.get(key)
        if isinstance(v, str) and v:
            return v
    return None


#: candidate payload layouts, widest first: bpp -> (dtype, channels).
#: bpp 3 is the reference's RGB8 color payload — its RGB-D converter writes
#: the rgb ImageMessage alongside depth (convert_rgbd_to_srrg2.cpp:60-120)
#: and TUM logs are RGB8, so ``rows*cols*3`` blobs must decode (to grayscale,
#: matching load_gray / native.to_gray_f32 ITU-R 601 luma).
_BLOB_LAYOUTS = (
    (4, np.float32, 1),
    (3, np.uint8, 3),
    (2, np.uint16, 1),
    (1, np.uint8, 1),
)


def _blob_pixels(buf: bytes, rows: int, cols: int, dtype,
                 channels: int) -> np.ndarray:
    arr = np.frombuffer(buf, dtype)
    if channels > 1:
        arr = arr.reshape(rows, cols, channels).astype(np.float32)
        return np.ascontiguousarray(
            0.299 * arr[:, :, 0] + 0.587 * arr[:, :, 1]
            + 0.114 * arr[:, :, 2]).astype(np.float32)
    return arr.reshape(rows, cols).astype(np.float32)


def _decode_image_blob(raw: bytes, rows: int, cols: int) -> np.ndarray:
    """Pixels from an srrg2 binary image BLOB.

    Decode preference order:
      1. the (u64 rows, u64 cols, u32 type) header ``write_boss_stereo``
         emits — when it matches the message geometry AND the remaining
         bytes are a whole payload, it disambiguates exactly (a headered
         uint8 blob whose total length coincides with ``rows*cols*2`` no
         longer misreads as uint16);
      2. an exact-size headerless payload, widest dtype first (bpp 4 =
         ImageFloat, 3 = RGB8 color, 2 = ImageUInt16 depth, 1 = ImageUInt8);
      3. the trailing ``rows*cols*bpp`` block behind an unknown header
         (geometry fallback — robust to srrg2_core header variations).
    """
    if rows <= 0 or cols <= 0:
        raise ValueError("BLOB decode needs image_rows/image_cols > 0")
    n = rows * cols
    if len(raw) >= 20:
        hr, hc = np.frombuffer(raw[:16], np.uint64)
        if int(hr) == rows and int(hc) == cols:
            body = raw[20:]
            for bpp, dtype, ch in _BLOB_LAYOUTS:
                if len(body) == n * bpp:
                    return _blob_pixels(body, rows, cols, dtype, ch)
    for bpp, dtype, ch in _BLOB_LAYOUTS:
        if len(raw) == n * bpp:
            return _blob_pixels(raw, rows, cols, dtype, ch)
    for bpp, dtype, ch in _BLOB_LAYOUTS:
        if len(raw) >= n * bpp:
            return _blob_pixels(raw[len(raw) - n * bpp:], rows, cols,
                                dtype, ch)
    raise ValueError(
        f"BLOB of {len(raw)} bytes cannot hold a {rows}x{cols} image")


def _load_image(payload: dict, base_dir: str, blobs: dict = None,
                blob_dir: str = "") -> np.ndarray:
    if "image_file" in payload:
        return load_gray(os.path.join(base_dir, payload["image_file"]))
    rows = int(payload.get("image_rows", 0))
    cols = int(payload.get("image_cols", 0))
    for key in _IMAGE_KEYS:
        v = payload.get(key)
        if v is None:
            continue
        if isinstance(v, list):
            return np.asarray(v, np.float32)           # inline rows
        name = None
        if isinstance(v, dict) and "#pointer" in v and blobs is not None:
            ref = blobs.get(v["#pointer"])
            if ref is not None:
                name = _blob_file_name(ref)
        elif isinstance(v, str):
            name = v                                    # direct file name
        if name is not None:
            for cand in (os.path.join(base_dir, blob_dir, name),
                         os.path.join(base_dir, name)):
                if os.path.exists(cand):
                    with open(cand, "rb") as f:
                        return _decode_image_blob(f.read(), rows, cols)
            raise FileNotFoundError(
                f"BLOB payload '{name}' not found next to the log "
                f"(looked in '{blob_dir or '.'}')")
    raise ValueError(
        "ImageMessage carries no supported payload (expected a binary "
        "BLOB reference, 'image_file', or inline 'image_data')")


def boss_camera(path: str, topic_hint: str = "") -> Optional[Camera]:
    """Camera model from the log's CameraInfoMessage + TF stereo baseline.

    The reference initializers consume exactly these messages
    (InitializerStereoCamera3D, apps/app_benchmark.cpp:56-74).
    """
    K = None
    rows = cols = None
    baseline_m = 0.0
    depth_scale = 1.0
    for name, obj in parse_boss_file(path):
        if name == "CameraInfoMessage" and K is None:
            if topic_hint and topic_hint not in obj.get("topic", ""):
                continue
            K = np.asarray(obj["camera_matrix"], np.float64).reshape(3, 3)
            depth_scale = float(obj.get("depth_scale", 1.0))
            rows = obj.get("rows")
            cols = obj.get("cols")
        elif name == "ImageMessage" and rows is None:
            rows = obj.get("image_rows")
            cols = obj.get("image_cols")
        elif name == "TransformEventsMessage":
            for ev in obj.get("events", []):
                if (ev.get("child_frame") == "camera_right"
                        and ev.get("parent_frame") == "camera_left"):
                    T = np.asarray(ev["transform"], np.float64).reshape(4, 4)
                    baseline_m = abs(float(T[0, 3]))
        if K is not None and rows is not None and baseline_m:
            break
    if K is None:
        return None
    return Camera(
        fx=float(K[0, 0]), fy=float(K[1, 1]),
        cx=float(K[0, 2]), cy=float(K[1, 2]),
        rows=int(rows or 0), cols=int(cols or 0),
        baseline_px=float(K[0, 0]) * baseline_m,
        range_min=0.1, range_max=300.0,
    )


def _classify_topics(messages, left_topic, right_topic):
    """Resolve the left/right ImageMessage topics.

    Explicit arguments win; otherwise the 'left'/'right' substring
    heuristic runs over frame_id and topic; as a last resort the first two
    distinct topics map to (left, right) in first-appearance order — so
    reference-converted logs with other naming still pair one-to-one
    instead of misparsing (every unmatched message used to be classified
    "right").
    """
    topics = []
    for obj in messages:
        t = obj.get("topic", "") or obj.get("frame_id", "")
        if t not in topics:
            topics.append(t)
    if left_topic is None:
        cands = [t for t in topics
                 if "left" in t or "left" in _frame_of(t, messages)]
        left_topic = cands[0] if cands else (topics[0] if topics else "")
    if right_topic is None:
        others = [t for t in topics if t != left_topic]
        cands = ([t for t in others if "right" in t
                  or "right" in _frame_of(t, messages)] or others)
        right_topic = cands[0] if cands else ""
    return left_topic, right_topic


def _frame_of(topic, messages):
    for obj in messages:
        if (obj.get("topic", "") or obj.get("frame_id", "")) == topic:
            return obj.get("frame_id", "")
    return ""


def iter_boss_stereo(path: str, count: Optional[int] = None,
                     sync_threshold_s: float = 0.01,
                     left_topic: Optional[str] = None,
                     right_topic: Optional[str] = None
                     ) -> Iterator[StereoFrame]:
    """Synchronized stereo frames from a BOSS message log.

    MessageSynchronizedSource analog (kitti.conf:144-162): left/right
    ImageMessages pair ONE-TO-ONE when their timestamps agree within
    ``sync_threshold_s`` (each right image pairs with at most one left);
    ground-truth camera_left-in-world TF events attach to the paired
    frame.  Topics are selected explicitly via ``left_topic`` /
    ``right_topic`` or inferred (see :func:`_classify_topics`); messages
    are kept in arrival order, so duplicate timestamps do not collapse.
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    blob_dir = os.path.basename(path) + ".d"
    objects = parse_boss_file(path)
    blobs = _blob_registry(objects)
    images = [obj for name, obj in objects if name == "ImageMessage"]
    gts = {}
    for name, obj in objects:
        if name == "TransformEventsMessage":
            for ev in obj.get("events", []):
                if (ev.get("child_frame") == "camera_left"
                        and ev.get("parent_frame") == "world"):
                    gts[float(obj["timestamp"])] = np.asarray(
                        ev["transform"], np.float32).reshape(4, 4)
    lt, rt = _classify_topics(images, left_topic, right_topic)
    lefts, rights = [], []
    for obj in images:
        t = obj.get("topic", "") or obj.get("frame_id", "")
        if t == lt:
            lefts.append(obj)
        elif t == rt:
            rights.append(obj)
    # stable-sort rights by timestamp (preserving arrival order among
    # duplicates): searchsorted needs a sorted array, and a log whose right
    # messages arrive out of timestamp order would otherwise silently
    # mispair since only idx-1/idx/idx+1 are probed
    rights.sort(key=lambda o: float(o["timestamp"]))
    right_ts = [float(o["timestamp"]) for o in rights]
    used = [False] * len(rights)
    emitted = 0
    for obj in lefts:
        ts = float(obj["timestamp"])
        # nearest UNUSED right timestamp within the sync threshold
        idx = int(np.searchsorted(right_ts, ts))
        best, best_dt = None, sync_threshold_s
        for k in (idx - 1, idx, idx + 1):
            if 0 <= k < len(rights) and not used[k]:
                dt = abs(right_ts[k] - ts)
                if dt <= best_dt:
                    best, best_dt = k, dt
        if best is None:
            continue
        used[best] = True
        yield StereoFrame(
            timestamp=ts,
            left=_load_image(obj, base_dir, blobs, blob_dir),
            right=_load_image(rights[best], base_dir, blobs, blob_dir),
            gt_pose=gts.get(ts),
        )
        emitted += 1
        if count is not None and emitted >= count:
            return


def iter_boss_rgbd(path: str, count: Optional[int] = None,
                   sync_threshold_s: float = 0.02,
                   rgb_topic: Optional[str] = None,
                   depth_topic: Optional[str] = None
                   ) -> Iterator[RGBDFrame]:
    """Synchronized RGB-D frames from a BOSS message log.

    The reference's RGB-D converter writes an rgb ImageMessage alongside
    each depth ImageMessage (convert_rgbd_to_srrg2.cpp:60-120); here the
    depth topic is identified by a 'depth' substring (or given explicitly)
    and pairs with the intensity topic by timestamp, mirroring
    :func:`iter_boss_stereo`'s one-to-one pairing.  Color payloads decode
    to grayscale intensity (bpp=3 BLOBs); depth stays in raw units (the
    adaptor applies ``depth_scale``).
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    blob_dir = os.path.basename(path) + ".d"
    objects = parse_boss_file(path)
    blobs = _blob_registry(objects)
    images = [obj for name, obj in objects if name == "ImageMessage"]
    topics = []
    for obj in images:
        t = obj.get("topic", "") or obj.get("frame_id", "")
        if t not in topics:
            topics.append(t)
    if depth_topic is None:
        cands = [t for t in topics
                 if "depth" in t or "depth" in _frame_of(t, images)]
        depth_topic = cands[0] if cands else (topics[-1] if topics else "")
    if rgb_topic is None:
        others = [t for t in topics if t != depth_topic]
        rgb_topic = others[0] if others else ""
    rgbs = [o for o in images
            if (o.get("topic", "") or o.get("frame_id", "")) == rgb_topic]
    depths = [o for o in images
              if (o.get("topic", "") or o.get("frame_id", "")) == depth_topic]
    depths.sort(key=lambda o: float(o["timestamp"]))
    depth_ts = [float(o["timestamp"]) for o in depths]
    used = [False] * len(depths)
    emitted = 0
    for obj in rgbs:
        ts = float(obj["timestamp"])
        idx = int(np.searchsorted(depth_ts, ts))
        best, best_dt = None, sync_threshold_s
        for k in (idx - 1, idx, idx + 1):
            if 0 <= k < len(depths) and not used[k]:
                dt = abs(depth_ts[k] - ts)
                if dt <= best_dt:
                    best, best_dt = k, dt
        if best is None:
            continue
        used[best] = True
        yield RGBDFrame(
            timestamp=ts,
            intensity=_load_image(obj, base_dir, blobs, blob_dir),
            depth=_load_image(depths[best], base_dir, blobs, blob_dir),
            gt_pose=None,
        )
        emitted += 1
        if count is not None and emitted >= count:
            return


# ---------------------------------------------------------------------------
# writer (the converter's output format, A4 parity)
# ---------------------------------------------------------------------------

def _block(name: str, payload: dict) -> str:
    return f'"{name}" {json.dumps(payload, indent=1)}\n\n'


def write_boss_stereo(path: str, frames, camera: Camera,
                      baseline_m: Optional[float] = None,
                      image_format: str = "png") -> int:
    """Write stereo frames as a BOSS message log + image payload files.

    Emits per frame the same message triplet as the reference converter
    (convert_stereo_to_srrg2.cpp:113-180): two ImageMessages, a
    CameraInfoMessage per camera image, and a TransformEventsMessage with
    the stereo extrinsic (+ ground truth when present).  Payload pixels go
    to ``<log>.d/``: as ordinary image files referenced by ``image_file``
    (``image_format`` "png", "pgm", "jpg" or "bmp"), or —
    ``image_format="blob"`` — as srrg2-style binary BLOBs: raw row-major
    uint8 bytes behind a (rows, cols, type) header, referenced from the message through a
    ``{"#pointer": id}`` plus an ``ImageUInt8BLOBReference`` block naming
    the binary file (the layout the reference converter's Serializer
    produces, convert_stereo_to_srrg2.cpp:129-135).  The reader's
    geometry-based decoder round-trips both.
    """
    from .datasets import save_gray

    base_dir = os.path.dirname(os.path.abspath(path))
    payload_dir = os.path.basename(path) + ".d"
    os.makedirs(os.path.join(base_dir, payload_dir), exist_ok=True)
    if baseline_m is None:
        baseline_m = camera.baseline_px / camera.fx
    K = [[camera.fx, 0.0, camera.cx],
         [0.0, camera.fy, camera.cy],
         [0.0, 0.0, 1.0]]
    T_right_in_left = np.eye(4)
    T_right_in_left[0, 3] = -baseline_m
    n = 0
    next_id = 1
    with open(path, "w") as f:
        for seq, fr in enumerate(frames):
            for side, img in (("left", fr.left), ("right", fr.right)):
                arr = np.asarray(img)
                msg = {
                    "topic": f"/camera_{side}/image_raw",
                    "frame_id": f"camera_{side}",
                    "seq": seq,
                    "timestamp": fr.timestamp,
                    "image_rows": int(arr.shape[0]),
                    "image_cols": int(arr.shape[1]),
                }
                if image_format == "blob":
                    name = f"imageuint8.{2 * seq + (side == 'right'):06d}.srrg"
                    raw = (np.uint64([arr.shape[0], arr.shape[1]]).tobytes()
                           + np.uint32([0]).tobytes()
                           + np.clip(arr, 0, 255).astype(np.uint8).tobytes())
                    with open(os.path.join(base_dir, payload_dir, name),
                              "wb") as bf:
                        bf.write(raw)
                    msg["image_data"] = {"#pointer": next_id}
                    f.write(_block("ImageUInt8BLOBReference", {
                        "#id": next_id, "file_name": name,
                        "name_attribute": "image_data",
                    }))
                    next_id += 1
                else:
                    rel = f"{payload_dir}/{side}_{seq:06d}.{image_format}"
                    save_gray(os.path.join(base_dir, rel), img)
                    msg["image_file"] = rel
                f.write(_block("ImageMessage", msg))
                f.write(_block("CameraInfoMessage", {
                    "topic": f"/camera_{side}/image_raw/info",
                    "frame_id": f"camera_{side}",
                    "seq": seq,
                    "timestamp": fr.timestamp,
                    "depth_scale": 1.0,
                    "projection_model": "pinhole",
                    "distortion_model": "undistorted",
                    "camera_matrix": [x for row in K for x in row],
                }))
            events = [dict(child_frame="camera_right",
                           parent_frame="camera_left",
                           transform=[x for row in T_right_in_left
                                      for x in row])]
            if fr.gt_pose is not None:
                events.append(dict(
                    child_frame="camera_left", parent_frame="world",
                    transform=[float(x) for x in
                               np.asarray(fr.gt_pose).ravel()]))
            f.write(_block("TransformEventsMessage", {
                "topic": "/tf",
                "frame_id": "camera_left",
                "seq": seq,
                "timestamp": fr.timestamp,
                "events": events,
            }))
            n += 1
    return n


def write_boss_rgbd(path: str, frames, camera: Camera,
                    depth_scale: float = 1.0e-3) -> int:
    """Write RGB-D frames as a BOSS log with binary BLOB payloads.

    Mirrors the reference RGB-D converter's message surface
    (convert_rgbd_to_srrg2.cpp:60-120): per frame a COLOR rgb ImageMessage
    (3-channel uint8 BLOB — the payload shape TUM logs carry) and a uint16
    depth ImageMessage, plus a CameraInfoMessage with the depth scale.
    ``frames`` yield RGBDFrame with intensity in 0..255 and depth in raw
    units (raw * depth_scale = meters).
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    payload_dir = os.path.basename(path) + ".d"
    os.makedirs(os.path.join(base_dir, payload_dir), exist_ok=True)
    K = [[camera.fx, 0.0, camera.cx],
         [0.0, camera.fy, camera.cy],
         [0.0, 0.0, 1.0]]
    n = 0
    next_id = 1
    with open(path, "w") as f:
        for seq, fr in enumerate(frames):
            gray = np.clip(np.asarray(fr.intensity), 0, 255).astype(np.uint8)
            # replicated-channel color image: decodes back to the same gray
            rgb = np.repeat(gray[:, :, None], 3, axis=2)
            depth = np.asarray(fr.depth).astype(np.uint16)
            for topic, arr, blk in (
                    ("/camera/rgb/image_color", rgb, "ImageUInt8"),
                    ("/camera/depth/image_raw", depth, "ImageUInt16")):
                name = f"{blk.lower()}.{2 * seq + (blk != 'ImageUInt8'):06d}.srrg"
                raw = (np.uint64([arr.shape[0], arr.shape[1]]).tobytes()
                       + np.uint32([0]).tobytes() + arr.tobytes())
                with open(os.path.join(base_dir, payload_dir, name),
                          "wb") as bf:
                    bf.write(raw)
                f.write(_block(f"{blk}BLOBReference", {
                    "#id": next_id, "file_name": name,
                    "name_attribute": "image_data",
                }))
                f.write(_block("ImageMessage", {
                    "topic": topic,
                    "frame_id": topic.split("/")[2],
                    "seq": seq,
                    "timestamp": fr.timestamp,
                    "image_rows": int(arr.shape[0]),
                    "image_cols": int(arr.shape[1]),
                    "image_data": {"#pointer": next_id},
                }))
                next_id += 1
            f.write(_block("CameraInfoMessage", {
                "topic": "/camera/rgb/image_color/info",
                "frame_id": "rgb",
                "seq": seq,
                "timestamp": fr.timestamp,
                "depth_scale": depth_scale,
                "projection_model": "pinhole",
                "distortion_model": "undistorted",
                "camera_matrix": [x for row in K for x in row],
            }))
            n += 1
    return n

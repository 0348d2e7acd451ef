#!/usr/bin/env python3
"""Time the FAST kernel (K3) at several tile shapes, beside another version.

Usage (one CUDA card; builds the kernel library once per tile from csrc/):

    python3 scripts/fast_tiles_torch.py [--tiles 128x16/256,...]
        [--other NAME=DIR[:FLAG,...]] ... [--reps 20] [--rounds 2] [--out DIR]

Builds csrc/ once for each tile shape in TILES (-DFAST_TILE_W, -DFAST_TILE_H,
-DFAST_THREADS) and, for each --other, the csrc/ directory of another tree
(another K3 behind the same C entry point, e.g. the parent commit's) with
the nvcc flags given, checks each against fast_scores_plain bit for bit (a
mismatch of csrc/ fails the run; another tree's is reported), and times
them in turns (the list forward,
then backward, per round) as device time per call (torch.profiler, as
chip_smoke.py times kernels) on frame 0's KITTI pair [2, 376, 1241] and on
uniform noise of the same shape, both at the detector's threshold.  It also
prints each build's ptxas report for the kernel, the kernel's SASS
instruction mix (cuobjdump), and measures the issue rate of FMNMX and FADD
(lanes per SM and clock) with a small probe kernel.  The last line is one
JSON object with every number.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (tile width, tile height, threads per CTA); the first is csrc/fast.cu's default
TILES = [(32, 16, 128), (32, 32, 256), (32, 32, 128), (32, 16, 256), (32, 8, 128),
         (32, 8, 64), (64, 16, 256), (64, 16, 128), (64, 8, 128), (64, 32, 256),
         (128, 16, 256), (128, 8, 256), (256, 8, 256)]

PROBE = r"""
// Issue rate of f32 min/max and add: 8 chains per thread, each step reads
// two other chains, so nothing folds; the loop count is a runtime value.
extern "C" __global__ void probe_minmax(float* out, int iters) {
  float a[8];
  for (int j = 0; j < 8; ++j) a[j] = threadIdx.x * 0.25f + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = fmaxf(a[j], a[(j + 1) & 7]);
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = fminf(a[j], a[(j + 3) & 7]);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" __global__ void probe_add(float* out, int iters) {
  float a[8];
  for (int j = 0; j < 8; ++j) a[j] = threadIdx.x * 0.25f + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = a[j] + a[(j + 1) & 7];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = a[j] - a[(j + 3) & 7];
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_launch(int which, float* out, int blocks, int threads, int iters) {
  if (which == 0) probe_minmax<<<blocks, threads>>>(out, iters);
  else probe_add<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def ptxas_report(log: str) -> list:
    """The lines of a ptxas -v log that describe fast_scores_kernel."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "fast_scores_kernel" in line
        if keep and ("registers" in line or "spill" in line or "smem" in line):
            lines.append(line.strip())
    return lines


def sass_mix(so: Path) -> dict:
    """Opcode counts of fast_scores_kernel's SASS in a built library."""
    from srrg2_proslam_tpu_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True).stdout
    counts, inside = Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "fast_scores_kernel" in line
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            counts[m.group(1).split(".")[0]] += 1
    return dict(counts.most_common())


def probe_rates(build_dir: Path, sm_clocks: float) -> dict:
    """Lanes per SM and clock of FMNMX and FADD at full occupancy (CUDA
    events around one long launch each; the clock is the card's maximum)."""
    import torch

    from srrg2_proslam_tpu_torch.kernels import _build

    src = build_dir / "probe_pipes.cu"
    so = build_dir / "libprobe_pipes.so"
    src.write_text(PROBE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
    props = torch.cuda.get_device_properties(0)
    blocks, threads, iters = props.multi_processor_count * 8, 256, 1 << 14
    out = torch.empty(blocks * threads, device="cuda")
    rates = {}
    for which, name in ((0, "FMNMX"), (1, "FADD")):
        for _ in range(2):
            assert lib.probe_launch(which, out.data_ptr(), blocks, threads, 64) == 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        assert lib.probe_launch(which, out.data_ptr(), blocks, threads, iters) == 0
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        ops = blocks * threads * iters * 16
        rates[name] = {"ms": ms, "lanes_per_sm_clk": ops / (ms / 1e3) / sm_clocks}
    mix = Counter()
    dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    for op in ("FMNMX", "FADD", "FFMA"):
        mix[op] = len(re.findall(rf"\b{op}\b", dump))
    rates["probe_sass"] = dict(mix)
    return rates


def main():
    import torch

    from chip_smoke import device_ms, fast_bound, sm_clocks_per_s
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.kernels import _build
    from srrg2_proslam_tpu_torch.kernels.fast import fast_scores_kernel, fast_scores_plain
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR[:FLAG,...]: another tree's csrc/ directory")
    ap.add_argument("--tiles", default=None,
                    help="W x H / threads to build, e.g. 128x16/256,32x32/256 (default: TILES)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None, help="directory for the JSON summary")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    tiles = TILES if args.tiles is None else [
        tuple(int(v) for v in re.split(r"[x/]", spec)) for spec in args.tiles.split(",")]
    libs, result = {}, {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                        "builds": {}, "cases": {}}
    builds = [(f"{w}x{h}/{n}", (f"-DFAST_TILE_W={w}", f"-DFAST_TILE_H={h}",
                                f"-DFAST_THREADS={n}"), _build.CSRC) for w, h, n in tiles]
    for spec in args.other:
        name, _, rest = spec.partition("=")
        path, _, flags = rest.partition(":")
        builds.append((name, tuple(f for f in flags.split(",") if f), Path(path)))
    for name, flags, csrc in builds:
        t0 = time.perf_counter()
        _build.build_log = ""
        libs[name] = _build.build(flags, csrc)
        so = Path(libs[name]._name)
        info = {"build_s": time.perf_counter() - t0, "ptxas": ptxas_report(_build.build_log),
                "sass": sass_mix(so)}
        result["builds"][name] = info
        print(f"{name}: built in {info['build_s']:.2f} s; ptxas {info['ptxas']}; "
              f"SASS {info['sass']}", flush=True)

    sm_clocks = sm_clocks_per_s(torch.device("cuda:0"))
    result["sm_clocks_per_s"] = sm_clocks
    result["pipe_probe"] = probe_rates(_build.BUILD_DIR, sm_clocks)
    print(f"pipe probe: {result['pipe_probe']} [{smi}]", flush=True)

    dev = torch.device("cuda:0")
    frame = next(iter(datasets.iter_bundled_kitti(os.path.join(ROOT, "test_data"), "city")))
    kitti = torch.stack([torch.from_numpy(frame.left), torch.from_numpy(frame.right)]).to(dev)
    noise = torch.randint(0, 256, kitti.shape, generator=torch.Generator().manual_seed(0),
                          dtype=torch.int32).to(dev, torch.float32)
    thr = StereoAdaptorConfig().extractor.detector_threshold
    order = list(libs)
    own = [f"{w}x{h}/{n}" for w, h, n in tiles]
    for case, img in (("kitti_frame0", kitti), ("uniform_noise", noise)):
        ref = fast_scores_plain(img, thr)
        exact = {}
        for name in order:
            _build._lib = libs[name]
            exact[name] = torch.equal(fast_scores_kernel(img, thr), ref)
            if not exact[name] and name in own:
                raise SystemExit(f"{case}: {name} disagrees with fast_scores_plain")
        times = {name: [] for name in order}
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                _build._lib = libs[name]
                times[name].append(device_ms(lambda: fast_scores_kernel(img, thr),
                                             reps=args.reps, kernel="fast_scores_kernel"))
        bound = fast_bound(img, thr)
        result["cases"][case] = {**bound, "exact": exact, "ms_per_call": times}
        print(f"{case}: candidates {bound['candidate_share']:.4f}, bound "
              f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}) [{smi}]", flush=True)
        for name in order:
            print(f"  {name}: device ms/call {[round(t, 5) for t in times[name]]}"
                  f"{'' if exact[name] else ' (NOT exact)'}", flush=True)
    _build._lib = None
    line = json.dumps(result)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "fast_tiles.json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()

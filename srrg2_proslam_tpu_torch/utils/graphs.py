"""CUDA graphs of the port's device programs: captured once, replayed per call.

A ``CapturedProgram`` holds one ``torch.cuda.CUDAGraph`` of a function of
tensors (nested tuples and NamedTuples of tensors, ``None`` allowed), with
static input buffers, its own memory pool, and static outputs.  Capture
follows PyTorch's recipe: one eager warm-up call on a side stream (lazy
initialisation, cached constants and first-launch attributes happen there,
outside the capture), then the capture, then an explicit instantiation.  A
call copies its inputs into the static buffers, replays the graph and
returns fresh copies of the outputs, so a caller may keep them while the
graph runs again: the function's semantics, at the cost of one device copy
of each input and output.

The kernel wrappers count a launch when they launch; a replay runs the
launches recorded at capture without calling them, so each replay adds the
capture's launches to the counts (kernels.add_launches), and the counts the
capture itself made (no kernel ran) are taken back.  A capture or replay
that fails raises: nothing here falls back to the eager function.

``captured(key, fn, args)`` keeps one program per key (model, batch size,
configuration, capacities, device: whatever fixes the captured shapes);
``clear()`` frees them all.
"""
from __future__ import annotations

import ctypes
import time

import torch

from .. import kernels

_LEAF = "tensor"


def flatten(tree):
    """(leaves, spec): the tensors of a nest of tuples / NamedTuples / None
    in order, and the structure to rebuild it with ``unflatten``."""
    leaves = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            leaves.append(x)
            return _LEAF
        if isinstance(x, tuple):
            return (type(x), tuple(walk(v) for v in x))
        raise TypeError(f"graph arguments are tensors, tuples or None, not {type(x)}")

    return leaves, walk(tree)


def unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == _LEAF:
            return next(it)
        cls, parts = s
        vals = [build(p) for p in parts]
        return cls(*vals) if hasattr(cls, "_fields") else cls(vals)

    return build(spec)


def tree_map(fn, tree):
    """``fn`` on every tensor of the nest; the structure is kept."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(t) for t in leaves])


def _count_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of the captured graph (cuGraphGetNodes, libcuda)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return int(n.value)


class CapturedProgram:
    """``fn(*args)`` as a CUDA graph; ``args`` are the first call's inputs."""

    def __init__(self, fn, args: tuple):
        leaves, self._in_spec = flatten(args)
        self._in_meta = [(t.shape, t.dtype, t.device) for t in leaves]
        dev = leaves[0].device
        self._static_in = [t.clone() for t in leaves]
        static_args = unflatten(self._in_spec, self._static_in)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static_args)          # the warm-up: real launches, counted
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        before = kernels.launch_counts()
        # kept after capture: counted, then instantiated explicitly
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            out = fn(*static_args)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        after = kernels.launch_counts()
        kernels.set_launch_counts(before)
        self.launches = {k: after[k] - before[k] for k in after}
        self.num_nodes = _count_nodes(self.graph)
        t0 = time.perf_counter()
        self.graph.instantiate()
        torch.cuda.synchronize(dev)
        self.instantiate_ms = (time.perf_counter() - t0) * 1e3
        self._static_out, self._out_spec = flatten(out)
        self.replays = 0

    def __call__(self, *args):
        leaves, spec = flatten(args)
        if spec != self._in_spec or [(t.shape, t.dtype, t.device)
                                     for t in leaves] != self._in_meta:
            raise ValueError("arguments differ from the captured program's")
        for s, t in zip(self._static_in, leaves):
            s.copy_(t)
        self.graph.replay()
        self.replays += 1
        kernels.add_launches(self.launches)
        return unflatten(self._out_spec, [t.clone() for t in self._static_out])


_PROGRAMS: dict = {}


def captured(key, fn, args: tuple) -> CapturedProgram:
    """The program cached under ``key``, captured from ``fn(*args)`` on
    first use."""
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = CapturedProgram(fn, args)
    return prog


def programs() -> dict:
    """The captured programs by key."""
    return dict(_PROGRAMS)


def clear() -> None:
    _PROGRAMS.clear()

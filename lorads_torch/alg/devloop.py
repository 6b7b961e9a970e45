"""Device-resident loops: masked steps run in chunks, replayed from CUDA
graphs, with one packed host read per chunk.

The counterpart of lorads_tpu's ``lax.while_loop`` loops (alg/cg.py
``cg_solve``, alg/alm.py ``_inner_loop``).  A ``Loop`` is a masked
step, ``step(inputs, state, kind) -> state``, that leaves the state
unchanged, bit for bit, once the loop's exit test holds (the test is
evaluated on the device in every step, as a mask), and a ``pack(inputs,
state)`` that gives the 1-D float64 vector the host reads: element 0 is
nonzero while the loop runs.  ``kind(pos)`` names what a step at
position ``pos`` does that is fixed when the step is traced (CG's
true-residual restart, the ALM's cache refresh); a chunk's graph is
keyed by the kinds of its positions, so a period that K divides or that
divides K gives at most period / K graphs.

On CUDA tensors ``run`` takes chunks of ``K`` steps:

* the first chunk of a new key runs eagerly (real work; it also builds
  the kernels and sets their launch attributes before any capture);
* a chunk is then captured once per kind pattern into a
  ``torch.cuda.CUDAGraph`` (capture executes nothing) over static input
  and state buffers, the step's results copied back into the state
  buffers at the graph's end, and replayed: the inputs and the initial
  state are copied into the buffers, each replay advances the state in
  place, and the host reads the chunk's pack;
* a capture that fails raises (a host read inside it, for one: see
  ``device.host_read``); nothing falls back to an eager loop.

Graphs live until ``drop``: the solver's phases run inside ``phase()``,
which drops them at its entry and its end, and all graphs of a phase
share one memory pool (the buffers they communicate through are
allocated outside it, so any replay order is safe).  A key names what
the step closes over besides its inputs (``ident`` wraps an object by
identity and keeps it alive); the leaves' shapes, dtypes and device,
and the trees' layout, are added to it here.

On CPU tensors the same masked step runs eagerly, ``CPU_CHUNK`` steps
between two reads (1, so that a loop stops after the step where its
exit test first holds; ``None`` runs the loop's own K, as the tests of
the chunked schedule do).  A kernel launched inside a capture is
counted in ``kernels.LAUNCHES`` at each replay, not at the capture.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from lorads_torch import device as dev
from lorads_torch.ops import kernels

# steps between two host reads on CPU tensors (None: the loop's own K)
CPU_CHUNK = 1

_LOOPS = {}        # full key -> _Buffers
_POOL = None       # the phase's graph memory pool
_STREAM = None     # the capture stream


class ident:
    """A key part that compares by identity and holds its object."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, ident) and other.obj is self.obj


def _no_kind(pos):
    return None


def scalar(v, dtype, device) -> torch.Tensor:
    """A loop's scalar input as a 0-d tensor: a number becomes a fill on
    ``device`` (no host sync), a tensor is cast.  A Python float left in
    a step would be frozen into its graph."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype)
    return torch.full((), v, dtype=dtype, device=device)


@dataclasses.dataclass
class Loop:
    """One run of a masked loop: its key, step, pack, inputs (read, not
    changed), initial state, chunk length K, host-read label and kind;
    ``on_read(out, positions)``, if given, is called after each host
    read with the pack read and the positions of the steps it covers."""

    key: Any
    step: Callable
    pack: Callable
    inputs: Any
    state: Any
    K: int
    label: str
    kind: Callable = _no_kind
    on_read: Callable = None


# ---------------------------------------------------------------------------
# Trees of tensors: tuples, lists, dataclasses, None.
# ---------------------------------------------------------------------------

def flatten(tree, leaves=None):
    """(tensors in order, layout) of a tree."""
    if leaves is None:
        leaves = []
        return leaves, flatten(tree, leaves)
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "T"
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(flatten(t, leaves) for t in tree))
    if dataclasses.is_dataclass(tree):
        return (type(tree), tuple((f.name, flatten(getattr(tree, f.name),
                                                   leaves))
                                  for f in dataclasses.fields(tree)))
    raise TypeError(f"devloop: {type(tree).__name__} in a loop's tensors")


def unflatten(layout, leaves):
    it = iter(leaves)

    def build(s):
        if s == "T":
            return next(it)
        if s is None:
            return None
        typ, kids = s
        if typ in (tuple, list):
            return typ(build(k) for k in kids)
        return typ(**{name: build(k) for name, k in kids})
    return build(layout)


# ---------------------------------------------------------------------------
# Graph cache.
# ---------------------------------------------------------------------------

def drop() -> None:
    """Release every captured graph, its buffers and the pool."""
    global _POOL
    _LOOPS.clear()
    _POOL = None


@contextlib.contextmanager
def phase():
    """A solver phase: graphs captured inside are dropped at its end."""
    drop()
    try:
        yield
    finally:
        drop()


class _Buffers:
    """A key's static input and state buffers and its graphs by kinds."""

    def __init__(self, in_layout, st_layout, inputs, state):
        self.in_layout, self.st_layout = in_layout, st_layout
        self.inputs = [t.clone() for t in inputs]
        self.state = [t.clone() for t in state]
        self.graphs = {}

    def load(self, inputs, state):
        for b, t in zip(self.inputs + self.state, inputs + state):
            b.copy_(t)

    def tree(self, which):
        if which == "inputs":
            return unflatten(self.in_layout, self.inputs)
        return unflatten(self.st_layout, self.state)


class _Graph:
    __slots__ = ("graph", "pack", "launches")

    def __init__(self, graph, pack, launches):
        self.graph, self.pack, self.launches = graph, pack, launches

    def replay(self):
        self.graph.replay()
        kernels.replayed(self.launches)


def _capture(bufs: _Buffers, loop: Loop, kinds) -> _Graph:
    """The chunk of ``kinds`` captured over the buffers; the step's
    results are copied into the state buffers inside the graph."""
    global _POOL, _STREAM
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream()
    _STREAM.wait_stream(cur)
    with torch.cuda.stream(_STREAM), kernels.recording() as launches:
        graph.capture_begin(pool=_POOL)
        try:
            inputs = bufs.tree("inputs")
            state = bufs.tree("state")
            for kd in kinds:
                state = loop.step(inputs, state, kd)
            new, _ = flatten(state)
            ptrs = {b.data_ptr() for b in bufs.state}
            # a result that aliases another buffer is read before any
            # buffer is written
            new = [t if t is b or t.data_ptr() not in ptrs else t.clone()
                   for t, b in zip(new, bufs.state)]
            for b, t in zip(bufs.state, new):
                if t is not b:
                    b.copy_(t)
            pack = loop.pack(inputs, bufs.tree("state"))
        except BaseException:
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        graph.capture_end()
    cur.wait_stream(_STREAM)
    kernels.GRAPHS["captured"] += 1
    return _Graph(graph, pack, launches)


def _kinds(loop: Loop, start: int):
    return tuple(loop.kind(p) for p in range(start, start + loop.K))


def _full_key(loop: Loop, in_leaves, in_layout, st_leaves, st_layout):
    return (loop.key, loop.K, in_layout, st_layout,
            tuple((tuple(t.shape), t.dtype, t.device)
                  for t in in_leaves + st_leaves))


def eager_chunk(loop: Loop, start: int = 0, steps=None):
    """``steps`` (default K) masked steps from ``loop.state``, eagerly."""
    state = loop.state
    for p in range(start, start + (loop.K if steps is None else steps)):
        state = loop.step(loop.inputs, state, loop.kind(p))
    return state


def graph_chunk(loop: Loop, start: int = 0):
    """(graph, load, buffers) of the chunk at ``start`` for this loop's
    key: the graph captured here if absent (the key's buffers made from
    this loop's tensors if absent) and a function that loads the loop's
    inputs and state into the buffers.  ``graph.replay()`` then advances
    the state buffers by one chunk; ``buffers.tree("state")`` reads
    them."""
    in_leaves, in_layout = flatten(loop.inputs)
    st_leaves, st_layout = flatten(loop.state)
    key = _full_key(loop, in_leaves, in_layout, st_leaves, st_layout)
    bufs = _LOOPS.get(key)
    if bufs is None:
        bufs = _LOOPS[key] = _Buffers(in_layout, st_layout, in_leaves,
                                      st_leaves)
    kinds = _kinds(loop, start)
    g = bufs.graphs.get(kinds)
    if g is None:
        g = bufs.graphs[kinds] = _capture(bufs, loop, kinds)
    return g, lambda: bufs.load(in_leaves, st_leaves), bufs


def _read(loop: Loop, out, start: int, end: int) -> None:
    if loop.on_read is not None:
        loop.on_read(out, range(start, end))


def run(loop: Loop):
    """Run the loop to its exit -> (final state, the last pack read to
    the host as a list)."""
    in_leaves, in_layout = flatten(loop.inputs)
    st_leaves, st_layout = flatten(loop.state)
    if not st_leaves[0].is_cuda:
        n = loop.K if CPU_CHUNK is None else CPU_CHUNK
        state, pos = loop.state, 0
        while True:
            for p in range(pos, pos + n):
                state = loop.step(loop.inputs, state, loop.kind(p))
            out = dev.host_read(loop.pack(loop.inputs, state), loop.label)
            _read(loop, out, pos, pos + n)
            pos += n
            if not out[0]:
                return state, out
    key = _full_key(loop, in_leaves, in_layout, st_leaves, st_layout)
    bufs = _LOOPS.get(key)
    pos = 0
    if bufs is None:
        state = eager_chunk(loop)
        out = dev.host_read(loop.pack(loop.inputs, state), loop.label)
        _read(loop, out, 0, loop.K)
        st_leaves, _ = flatten(state)
        bufs = _LOOPS[key] = _Buffers(in_layout, st_layout, in_leaves,
                                      st_leaves)
        if not out[0]:
            return state, out
        pos = loop.K
    else:
        bufs.load(in_leaves, st_leaves)
    while True:
        kinds = _kinds(loop, pos)
        g = bufs.graphs.get(kinds)
        if g is None:
            g = bufs.graphs[kinds] = _capture(bufs, loop, kinds)
        g.replay()
        out = dev.host_read(g.pack, loop.label)
        _read(loop, out, pos, pos + loop.K)
        pos += loop.K
        if not out[0]:
            return unflatten(st_layout, [t.clone() for t in bufs.state]), out

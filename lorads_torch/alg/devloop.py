"""Device-resident loops: masked steps run in chunks, replayed from CUDA
graphs, with one packed host read per chunk.

The counterpart of lorads_tpu's ``lax.while_loop`` loops (alg/alm.py
``_inner_loop``; alg/cg.py and alg/admm.py below).  A ``Loop`` is a masked
step, ``step(inputs, state, kind) -> state``, that leaves the state
unchanged, bit for bit, once the loop's exit test holds (the test is
evaluated on the device in every step, as a mask), and a ``pack(inputs,
state)`` that gives the 1-D float64 vector the host reads: element 0 is
nonzero while the loop runs.  ``kind(pos)`` names what a step at
position ``pos`` does that is fixed when the step is traced (the ALM's
cache refresh); a chunk's graph is keyed by the kinds of its positions,
so a period that K divides or that divides K gives at most period / K
graphs.

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
and the trees' layout, are added to it here.  A graph reads a tensor
at the address it had at the capture: a step reads its inputs (the
graph's buffers) and tensors the key keeps alive, never a tensor of
one run's making.

On CPU tensors the same masked step runs eagerly, ``CPU_CHUNK`` steps
between two reads (1, so that a loop stops after the step where its
exit test first holds; ``None`` runs the loop's own K, as the tests of
the chunked schedule do).  A kernel launched inside a capture is
counted in ``kernels.LAUNCHES`` at each replay, not at the capture.

Device-decided loops (``K`` None; lorads_tpu's ``while_loop``s whose
length only the device knows: the ADMM chunk, the CG solves and
refinement passes nested in its iterations).  Such a loop also has ``running(inputs, state)``, its
exit test as a 0-d bool tensor, and its step runs only while the test
holds (it need not be masked).  Inside another loop's step it runs
through ``nest``; at the top through ``run``:

* eagerly (CPU tensors; ``eager_chunk`` on CUDA tensors), the host
  reads the test before every step (label ``loop.label``) and the step
  is given ``kind(pos)``;
* on CUDA tensors every run replays a graph, captured at a key's first
  run after a warm-up (``init`` and one step on a copy of the state,
  each nested loop one step, no host read, the results dropped: the
  kernels are built and their attributes set outside the capture);
* under capture it becomes a WHILE node of the graph (csrc/graph_cond.cu):
  its body, the step given the kind None (decide on the device; a branch
  of the step takes ``branch``, an IF node), is captured on a stream of
  its own nesting depth, its allocations routed to that depth's pool,
  and the device re-evaluates the test after each run of the body.  A
  body's launches are counted once per run of the body: each body adds
  one to a device counter, and the counters ride at the end of the
  top-level graph's pack.  At the top, one replay runs the loop to its
  exit (``init(inputs, state)``, if given, first) and the host reads the
  pack once.
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
_BODIES = []       # per nesting depth of a body: [stream, pool of phase]
_BODY_USES = []    # the body pools begun in this phase (released at drop)
_COUNTERS = None   # the capture's body counters: [tensor, {key: slot}, []]
_DEPTH = 0         # conditional bodies being captured, one inside another
MAX_BODIES = 64    # distinct body launch tallies in one graph
MAX_DEPTH = 4      # nesting depth of conditional nodes
_IN_STEP = 0       # >0 while a device-decided loop's step runs
_WARM = 0          # >0 during a device-decided key's warm-up
_TIMES = None      # while ``timed`` runs: event pairs of the replays


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
    read with the pack read and the positions of the steps it covers.
    K None: a device-decided loop, with ``running`` its exit test and
    ``init`` (optional) what a run does to the state before the loop."""

    key: Any
    step: Callable
    pack: Callable
    inputs: Any
    state: Any
    K: int
    label: str
    kind: Callable = _no_kind
    on_read: Callable = None
    running: Callable = None
    init: Callable = None


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
    """Release every captured graph, its buffers and the pools."""
    global _POOL
    _LOOPS.clear()
    _POOL = None
    for pool in _BODY_USES:
        torch._C._cuda_releasePool(torch.cuda.current_device(), pool)
    _BODY_USES.clear()
    for depth in _BODIES:
        depth[1] = None


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
    """A captured chunk: its graph, pack and launches; ``bodies``: the
    launch tallies of its conditional nodes' bodies, in the order of the
    counters at the end of the pack (``n_pack`` elements before them)."""

    __slots__ = ("graph", "pack", "launches", "bodies", "n_pack")

    def __init__(self, graph, pack, launches, bodies=(), n_pack=None):
        self.graph, self.pack, self.launches = graph, pack, launches
        self.bodies, self.n_pack = tuple(bodies), n_pack

    def replay(self):
        if self.n_pack is None:
            self.graph.replay()
        else:
            with _untraced("replay"):
                times = None
                if _TIMES is not None:
                    times = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
                    times[0].record()
                self.graph.replay()
                if times is not None:
                    times[1].record()
                    _TIMES.append(times)
        kernels.replayed(self.launches)

    def read(self, label):
        """The pack after a replay, read to the host once; the bodies'
        runs counted from its counters and cut from what is returned."""
        out = dev.host_read(self.pack, label)
        if self.n_pack is None:
            return out
        for tally, n in zip(self.bodies, out[self.n_pack:]):
            kernels.replayed(tally, int(n), replay=False)
        return out[:self.n_pack]


# ---------------------------------------------------------------------------
# Conditional nodes: device-decided loops and branches inside a capture.
# ---------------------------------------------------------------------------

def in_step() -> bool:
    """Whether a device-decided loop's step is running (eagerly or under
    capture): loops called there nest (``nest``)."""
    return _IN_STEP > 0


@contextlib.contextmanager
def _stepping():
    global _IN_STEP
    _IN_STEP += 1
    try:
        yield
    finally:
        _IN_STEP -= 1


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class _Body:
    """A conditional node's body being captured; a WHILE body sets
    ``pred`` (its loop's exit test on the new state) before it ends."""

    pred = None


@contextlib.contextmanager
def _body(is_while: bool, pred: torch.Tensor):
    """Capture a WHILE (IF) node's body: opened after what the current
    stream has captured, its condition from the 0-d bool ``pred``; the
    body's work is issued on this depth's stream, allocated from this
    depth's pool, and its launches tallied under one counter."""
    global _DEPTH
    if _COUNTERS is None:
        raise RuntimeError("devloop: a conditional node outside a "
                           "device-decided loop's capture")
    if _DEPTH >= len(_BODIES):
        raise RuntimeError(f"devloop: conditional nodes nested deeper than "
                           f"{MAX_DEPTH}")
    slot = _BODIES[_DEPTH]
    if slot[1] is None:
        slot[1] = torch.cuda.graph_pool_handle()
    stream, pool = slot
    if pred.dtype != torch.bool:
        raise TypeError(f"devloop: a condition of dtype {pred.dtype}")
    body = _Body()
    handle = kernels.cond_begin(is_while, pred.contiguous(), stream)
    device = torch.cuda.current_device()
    _DEPTH += 1
    try:
        with torch.cuda.stream(stream), kernels.recording() as tally:
            torch._C._cuda_beginAllocateCurrentStreamToPool(device, pool)
            _BODY_USES.append(pool)
            try:
                yield body
                if is_while and body.pred is None:
                    raise RuntimeError("devloop: a WHILE body without "
                                       "its exit test")
                pred_end = None if not is_while else body.pred.contiguous()
                ctr = _counter(tally)
                kernels.cond_end(is_while, handle, pred_end, ctr, stream)
            finally:
                torch._C._cuda_endAllocateToPool(device, pool)
    finally:
        _DEPTH -= 1


def _counter(tally: dict) -> torch.Tensor:
    """The counter element of a body whose launches are ``tally`` (the
    closing kernel included): bodies of equal tallies share one."""
    ctr, slots, tallies = _COUNTERS
    closed = dict(tally)
    closed[("launches", "loop_cond")] = closed.get(
        ("launches", "loop_cond"), 0) + 1
    key = tuple(sorted(closed.items()))
    i = slots.get(key)
    if i is None:
        if len(tallies) == MAX_BODIES:
            raise RuntimeError(f"devloop: more than {MAX_BODIES} distinct "
                               "conditional bodies in one graph")
        i = slots[key] = len(tallies)
        tallies.append(closed)
    return ctr[i]


def _assign(bufs, new) -> None:
    """Copy the leaves ``new`` into the buffers ``bufs`` (a result that
    aliases another buffer is read before any buffer is written)."""
    ptrs = {b.data_ptr() for b in bufs}
    new = [t if t is b or t.data_ptr() not in ptrs else t.clone()
           for t, b in zip(new, bufs)]
    for b, t in zip(bufs, new):
        if t is not b:
            b.copy_(t)


def _eager_loop(loop: Loop, state):
    """A device-decided loop run eagerly: the host reads the exit test
    before each step (in a warm-up, one step and no read)."""
    if _WARM:
        with _stepping():
            return loop.step(loop.inputs, state, loop.kind(0))
    pos = 0
    while dev.host_read(loop.running(loop.inputs, state), loop.label):
        with _stepping():
            state = loop.step(loop.inputs, state, loop.kind(pos))
        pos += 1
    return state


def _while_node(loop: Loop, inputs, state):
    """The loop from ``state`` as a WHILE node of the graph being
    captured, reading ``inputs`` (tensors the graph holds: its input
    buffers, or what the enclosing step computed) -> the loop-carried
    buffers, which hold its final state after the node."""
    leaves, layout = flatten(state)
    bufs = [t.clone() for t in leaves]
    st = unflatten(layout, bufs)
    with _body(True, loop.running(inputs, st)) as body:
        with _stepping():
            new = loop.step(inputs, st, None)
        _assign(bufs, flatten(new)[0])
        body.pred = loop.running(inputs, st)
    return st


def nest(loop: Loop):
    """Run a device-decided loop (K None) to its exit inside another
    loop's step -> its final state: a WHILE node under capture, else
    eagerly with a host read of the exit test before each step."""
    leaves, _ = flatten(loop.state)
    if _capturing(leaves[0]):
        return _while_node(loop, loop.inputs, loop.state)
    return _eager_loop(loop, loop.state)


def branch(pred: torch.Tensor, fn: Callable, other: torch.Tensor):
    """fn() where the 0-d bool ``pred`` holds, else ``other``, inside a
    step captured with the kind None: an IF node whose body computes
    fn() into a copy of ``other`` (lorads_tpu's ``lax.cond``)."""
    out = other.clone()
    with _body(False, pred):
        out.copy_(fn())
    return out


def _capture(bufs: _Buffers, loop: Loop, kinds) -> _Graph:
    """The chunk of ``kinds`` (a device-decided loop: its whole run)
    captured over the buffers; the step's results are copied into the
    state buffers inside the graph."""
    global _POOL, _STREAM, _COUNTERS
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    # the bodies' streams exist before the capture starts
    while loop.K is None and len(_BODIES) < MAX_DEPTH:
        _BODIES.append([torch.cuda.Stream(), None])
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream()
    _STREAM.wait_stream(cur)
    tallies, n_pack = [], None
    with _untraced("capture") if loop.K is None else \
            contextlib.nullcontext(), \
            torch.cuda.stream(_STREAM), kernels.recording() as launches:
        graph.capture_begin(pool=_POOL)
        try:
            inputs = bufs.tree("inputs")
            state = bufs.tree("state")
            if loop.K is None:
                _COUNTERS = [torch.zeros(MAX_BODIES, dtype=torch.int64,
                                         device=bufs.state[0].device),
                             {}, tallies]
                if loop.init is not None:
                    state = loop.init(inputs, state)
                state = _while_node(loop, inputs, state)
            else:
                for kd in kinds:
                    state = loop.step(inputs, state, kd)
            _assign(bufs.state, flatten(state)[0])
            pack = loop.pack(inputs, bufs.tree("state"))
            if loop.K is None:
                n_pack = pack.numel()
                pack = torch.cat([pack, _COUNTERS[0][:len(tallies)]
                                  .to(pack.dtype)])
        except BaseException:
            with contextlib.suppress(Exception):
                graph.capture_end()
            raise
        finally:
            _COUNTERS = None
        graph.capture_end()
    cur.wait_stream(_STREAM)
    kernels.GRAPHS["captured"] += 1
    return _Graph(graph, pack, launches, tallies, n_pack)


@contextlib.contextmanager
def _untraced(what: str):
    """Around the capture and each replay of a device-decided loop's
    graph: while torch.profiler runs, its CUDA activity collection is
    paused (CPU activity goes on; the graph shows as one range named
    ``devloop.<what>``).  On an H100 (torch 2.11, CUDA 12.8, the CUPTI
    torch ships) a graph of WHILE nodes whose bodies run some 10^4 times
    a replay hit an illegal address when it was captured after CUPTI
    attached to the process and replayed under a CUDA trace: with
    bodies of torch's own kernels too (ROADMAP §3 F4)."""
    if torch._C._autograd._profiler_type() != \
            torch._C._profiler.ActiveProfilerType.KINETO:
        yield
        return
    from torch.profiler import ProfilerActivity, record_function
    cuda = {ProfilerActivity.CUDA}
    torch.cuda.synchronize()
    torch._C._autograd._toggle_collection_dynamic(False, cuda)
    try:
        with record_function(f"devloop.{what}"):
            yield
            torch.cuda.synchronize()
    finally:
        torch._C._autograd._toggle_collection_dynamic(True, cuda)


@contextlib.contextmanager
def timed():
    """CUDA events around every replay of a device-decided loop's graph
    made inside -> the list of (start, end) event pairs, one a replay."""
    global _TIMES
    prev, _TIMES = _TIMES, []
    try:
        yield _TIMES
    finally:
        _TIMES = prev


def _kinds(loop: Loop, start: int):
    if loop.K is None:
        return None
    return tuple(loop.kind(p) for p in range(start, start + loop.K))


def _full_key(loop: Loop, in_leaves, in_layout, st_leaves, st_layout):
    return (loop.key, loop.K, in_layout, st_layout,
            tuple((tuple(t.shape), t.dtype, t.device)
                  for t in in_leaves + st_leaves))


def _eager_run(loop: Loop):
    """A device-decided loop's run, eagerly: init, then the loop."""
    state = loop.state
    if loop.init is not None:
        state = loop.init(loop.inputs, state)
    return _eager_loop(loop, state)


def eager_chunk(loop: Loop, start: int = 0, steps=None):
    """``steps`` (default K) masked steps from ``loop.state``, eagerly; a
    device-decided loop's whole run."""
    if loop.K is None:
        return _eager_run(loop)
    state = loop.state
    for p in range(start, start + (loop.K if steps is None else steps)):
        state = loop.step(loop.inputs, state, loop.kind(p))
    return state


def graph_chunk(loop: Loop, start: int = 0):
    """(graph, load, buffers) of the chunk at ``start`` for this loop's
    key: the graph captured here if absent (the key's buffers made from
    this loop's tensors if absent) and a function that loads the loop's
    inputs and state into the buffers.  ``graph.replay()`` then advances
    the state buffers by one chunk (a device-decided loop: runs it to its
    exit; ``graph.read(label)`` reads its pack and counts its bodies);
    ``buffers.tree("state")`` reads them."""
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


def _warm_up(loop: Loop, st_leaves, st_layout) -> None:
    """Before a key's first capture: init and one step of the loop on a
    copy of its state, every loop nested in the step run for one step
    (kind(0)), no host read, the results dropped: every kernel of the
    graph is built and its launch attributes set outside the capture."""
    global _WARM
    state = unflatten(st_layout, [t.clone() for t in st_leaves])
    _WARM += 1
    try:
        if loop.init is not None:
            state = loop.init(loop.inputs, state)
        with _stepping():
            loop.step(loop.inputs, state, loop.kind(0))
    finally:
        _WARM -= 1


def _run_device_decided(loop: Loop, in_leaves, in_layout, st_leaves,
                        st_layout):
    if not st_leaves[0].is_cuda:
        state = _eager_run(loop)
        return state, dev.host_read(loop.pack(loop.inputs, state),
                                    loop.label)
    key = _full_key(loop, in_leaves, in_layout, st_leaves, st_layout)
    bufs = _LOOPS.get(key)
    if bufs is None:
        _warm_up(loop, st_leaves, st_layout)
        bufs = _LOOPS[key] = _Buffers(in_layout, st_layout, in_leaves,
                                      st_leaves)
    bufs.load(in_leaves, st_leaves)
    g = bufs.graphs.get(None)
    if g is None:
        g = bufs.graphs[None] = _capture(bufs, loop, None)
    g.replay()
    out = g.read(loop.label)
    return unflatten(st_layout, [t.clone() for t in bufs.state]), out


def run(loop: Loop):
    """Run the loop to its exit -> (final state, the last pack read to
    the host as a list)."""
    in_leaves, in_layout = flatten(loop.inputs)
    st_leaves, st_layout = flatten(loop.state)
    if loop.K is None:
        return _run_device_decided(loop, in_leaves, in_layout, st_leaves,
                                   st_layout)
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
        out = g.read(loop.label)
        _read(loop, out, pos, pos + loop.K)
        pos += loop.K
        if not out[0]:
            return unflatten(st_layout, [t.clone() for t in bufs.state]), out

"""Device-decided loops, replayed from CUDA graphs, with one packed host
read a run.

The counterpart of lorads_tpu's ``lax.while_loop`` loops: the ALM phase
(alg/alm.py: the outer loop, the middle passes, the inner L-BFGS loop and
the rho do-while), the ADMM chunk, the CG solves and refinement passes
nested in its iterations, the CGNR, the certificate's restarted Lanczos
with its sweeps nested (alg/lanczos.py) and the spectral repair's active
set (alg/spectral_repair.py).  A ``Loop`` has a
``step(inputs, state, kind) -> state``, ``running(inputs, state)``, its
exit test as a 0-d bool tensor (the step runs only while it holds), a
``pack(inputs, state)`` that gives the 1-D float64 vector the host reads
after the run, and optionally ``init(inputs, state)``, what a run does to
the state before the loop.  ``kind(pos)`` tells an eager step at
position ``pos`` what the device decides under capture (a branch of the
step: the CG restart, the ALM's cache refresh).  Inside another loop's
step a loop runs through ``nest``; at the top through ``run``:

* eagerly (CPU tensors, and CUDA tensors while torch.profiler runs; also
  ``eager_chunk``), one ``kernels.loop_cond`` launch evaluates the exit
  test before every step (the plain version on CPU tensors) and the host
  reads its decision (label ``loop.label``); the step is given
  ``kind(pos)``;
* on CUDA tensors every run replays a graph, captured at a key's first
  run after a warm-up (``init`` and one step on a copy of the state,
  each nested loop one step, and the pack, no host read, the results
  dropped: the
  kernels are built and their attributes set outside the capture); the
  inputs and the initial state are copied into static buffers, the
  replay runs the loop to its exit, and the host reads the pack once;
* under capture a loop becomes a WHILE node of the graph: its body, the
  step given the kind None (decide on the device; a branch of the step
  takes ``branch``, an IF node), is captured on a stream of its own
  nesting depth, its allocations routed to that depth's pool.  Each node
  has one loop_cond launch at its head and one at its tail
  (csrc/graph_cond.cu): the head copies the entry state into the
  loop-carried buffers and evaluates the exit test; the tail copies the
  step's new leaves into them, evaluates the test on those leaves and
  adds one to the body's run counter.  The test is ``running`` recorded
  once as a program (``alg/looptest.py``); an operation it cannot
  evaluate raises at capture, and so does a body whose copies exceed a
  launch's table or a step that returns a leaf of another dtype, shape
  or layout than its buffer (the copies move bytes; the eager path
  raises on the same leaves).  A body's launches are counted once per
  run of the body: the counters ride at the end of the top-level graph's
  pack.  ``BODY_NODES`` keeps each body's node count by loop name.

A sharded solve's steps issue NCCL collectives (parallel/comm.py); they
are captured with the rest of a step, WHILE bodies included (an
all_reduce's replay is bit for bit its eager run on one rank: chip_smoke's
``shard capture`` line).  A capture that fails raises (a host read inside it, for one: see
``device.host_read``); nothing falls back to an eager loop.  A step's
scalars must be device tensors: a Python float would be frozen into the
graph.  Graphs live until ``drop``: the solver's phases run inside
``phase()``, which drops them at its entry and its end, and all graphs of
a phase share one memory pool (the buffers they communicate through are
allocated outside it, so any replay order is safe).  A key names what
the step closes over besides its inputs (``ident`` wraps an object by
identity and keeps it alive); the leaves' shapes, dtypes and device,
and the trees' layout, are added to it here.  A graph reads a tensor at
the address it had at the capture: a step reads its inputs (the graph's
buffers) and tensors the key keeps alive, never a tensor of one run's
making.  A kernel launched inside a capture is counted in
``kernels.LAUNCHES`` at each replay, not at the capture.

Under torch.profiler (``tracing()``) a top-level run on CUDA tensors is
eager, as on the CPU: the same steps, kernels and device, the exit test
read before each step.  CUPTI's records of a graph of WHILE nodes whose
bodies run some 10^4 times a replay hit an illegal address on an H100
(ROADMAP §3 F4, ``f4_repro.py``); run eagerly, every kernel of the loop
is in the trace.  The eager run is held bit for bit against the graph
(chip_smoke's ``admm chunk`` and ``alm outer`` lines).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import torch

from lorads_torch import device as dev
from lorads_torch.alg import looptest
from lorads_torch.ops import kernels

_LOOPS = {}        # full key -> _Buffers
_POOL = None       # the phase's graph memory pool
_STREAM = None     # the capture stream
_BODIES = []       # per nesting depth of a body: [stream, pool of phase]
_BODY_USES = []    # the body pools begun in this phase (released at drop)
_COUNTERS = None   # the capture's body counters: [tensor, {key: slot}, []]
_DEPTH = 0         # conditional bodies being captured, one inside another
MAX_BODIES = 64    # distinct body launch tallies in one graph
MAX_DEPTH = 4      # nesting depth of conditional nodes
BODY_NODES = {}    # loop name -> the node count of each body captured
_IN_STEP = 0       # >0 while a device-decided loop's step runs
_WARM = 0          # >0 during a device-decided key's warm-up
_TIMES = None      # while ``timed`` runs: event pairs of the replays
_CAPS = None       # while ``captures`` runs: its warm-ups and captures


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
    """One run of a device-decided loop: its key, step, pack, inputs
    (read, not changed), initial state, host-read label, exit test
    ``running``, kind and ``init`` (optional: what a run does to the
    state before the loop).  ``K`` is None: the device decides the
    loop's length."""

    key: Any
    step: Callable
    pack: Callable
    inputs: Any
    state: Any
    K: None = None
    label: str = "other"
    kind: Callable = _no_kind
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
    """A key's static input and state buffers and its graph."""

    def __init__(self, in_layout, st_layout, inputs, state):
        self.in_layout, self.st_layout = in_layout, st_layout
        self.inputs = [t.clone() for t in inputs]
        self.state = [t.clone(memory_format=torch.contiguous_format)
                      for t in state]
        self.graph = None

    def load(self, inputs, state):
        for b, t in zip(self.inputs + self.state, inputs + state):
            b.copy_(t)

    def tree(self, which):
        if which == "inputs":
            return unflatten(self.in_layout, self.inputs)
        return unflatten(self.st_layout, self.state)


class _Graph:
    """A captured loop: its graph, pack and launches; ``bodies``: the
    launch tallies of its conditional nodes' bodies, in the order of the
    counters at the end of the pack (``n_pack`` elements before them)."""

    __slots__ = ("graph", "pack", "launches", "bodies", "n_pack")

    def __init__(self, graph, pack, launches, bodies, n_pack):
        self.graph, self.pack, self.launches = graph, pack, launches
        self.bodies, self.n_pack = tuple(bodies), n_pack

    def replay(self):
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


def tracing() -> bool:
    """Whether torch.profiler runs: top-level loops on CUDA tensors then
    run eagerly, so that the trace holds their kernels."""
    return (torch._C._autograd._profiler_type()
            == torch._C._profiler.ActiveProfilerType.KINETO)


def _name(loop: Loop) -> str:
    """A loop's name in BODY_NODES and in errors: its key's first part
    where that is a string, else its label."""
    k = loop.key
    return k[0] if isinstance(k, tuple) and k and isinstance(k[0], str) \
        else loop.label


class _Body:
    """A conditional node's body being captured; it ends with ``tail``:
    (the test's slot tensors, the copies [(source, destination)])."""

    tail = None


@contextlib.contextmanager
def _node(is_while: bool, name: str, prog, leaves, copies):
    """Capture a WHILE (IF) node's body: opened after what the current
    stream has captured by its head launch (``kernels.cond_begin``: the
    ``copies``, then the condition from the test ``prog`` on ``leaves``);
    the body's work is issued on this depth's stream, allocated from this
    depth's pool, its launches tallied under one counter, and closed by
    its tail launch (``kernels.cond_end``: the body's ``tail`` copies,
    the counter and, for a WHILE node, the test again on the tail's
    leaves).  The body's node count goes to BODY_NODES[name]."""
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
    body = _Body()
    handle = kernels.cond_begin(is_while, stream, prog, leaves, copies)
    device = torch.cuda.current_device()
    _DEPTH += 1
    try:
        with torch.cuda.stream(stream), kernels.recording() as tally:
            torch._C._cuda_beginAllocateCurrentStreamToPool(device, pool)
            _BODY_USES.append(pool)
            try:
                yield body
                if body.tail is None:
                    raise RuntimeError(f"devloop: the body of {name!r} "
                                       "without its tail")
                t_leaves, t_copies = body.tail
                ctr = _counter(tally)
                nodes = kernels.cond_end(handle if is_while else 0, stream,
                                         prog if is_while else None,
                                         t_leaves, t_copies, ctr)
                BODY_NODES.setdefault(name, []).append(nodes)
            except BaseException:
                # end the body's capture (the graph is dropped), so that
                # the capture of the whole graph can end and the thread
                # leave capture mode
                with contextlib.suppress(Exception):
                    kernels.cond_abort(stream)
                raise
            finally:
                torch._C._cuda_endAllocateToPool(device, pool)
    finally:
        _DEPTH -= 1


def _counter(tally: dict) -> torch.Tensor:
    """The counter element of a body whose launches are ``tally`` (the
    closing launch included): bodies of equal tallies share one."""
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


def _copies(bufs, new):
    """(the copies [(source, destination)] that put the leaves ``new`` into
    the buffers ``bufs``, the sources a launch reads: one a leaf): none
    where a leaf is its buffer; a leaf that aliases another buffer is
    cloned first, and the launch's test reads the clone too (the copies
    run beside the test, so neither may read a buffer some copy
    writes)."""
    ptrs = {b.data_ptr() for b in bufs}
    out, srcs = [], []
    for b, t in zip(bufs, new):
        if t is not b:
            if t.data_ptr() in ptrs:
                t = t.clone()
            out.append((t, b))
        srcs.append(t)
    return out, srcs


def _check_leaves(what: str, bufs, new, layout=None, new_layout=None):
    """``new`` can replace ``bufs`` (the same layout; each leaf that is not
    its buffer of its dtype and shape, and contiguous): a launch copies
    bytes, so a step must return its state's leaves as they were made
    (the eager path checks the same)."""
    if new_layout != layout:
        raise TypeError(f"devloop: {what} changed the state's layout")
    for i, (b, t) in enumerate(zip(bufs, new)):
        if t is not b and (t.dtype != b.dtype or t.shape != b.shape
                           or not t.is_contiguous()):
            raise TypeError(
                f"devloop: {what}: leaf {i} is {t.dtype} {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ' strided'}, its buffer "
                f"{b.dtype} {tuple(b.shape)}")


def _test(loop: Loop, inputs, state):
    """The loop's exit test as a program (alg/looptest.py) whose state
    slots are the leaves of ``state``."""
    return looptest.record(loop.running, _name(loop), (inputs, state),
                           state=1)


def _eager_loop(loop: Loop, state):
    """A device-decided loop run eagerly: before each step one loop_cond
    launch evaluates the exit test (the plain version on CPU tensors) and
    the host reads its decision (in a warm-up, one step and no read)."""
    if _WARM:
        with _stepping():
            return loop.step(loop.inputs, state, loop.kind(0))
    leaves, layout = flatten(state)
    name = _name(loop)
    for i, t in enumerate(leaves):
        if not t.is_contiguous():
            raise TypeError(f"devloop: the state of {name!r}: leaf {i} "
                            f"{tuple(t.shape)} strided")
    prog = _test(loop, loop.inputs, state)
    pos = 0
    while dev.host_read(kernels.loop_cond(prog, prog.leaves(leaves)),
                        loop.label):
        with _stepping():
            state = loop.step(loop.inputs, state, loop.kind(pos))
        new, new_layout = flatten(state)
        _check_leaves(f"the step of {name!r}", leaves, new, layout,
                      new_layout)
        leaves = new
        pos += 1
    return state


def _while_node(loop: Loop, inputs, state, into=None):
    """The loop from ``state`` as a WHILE node of the graph being
    captured, reading ``inputs`` (tensors the graph holds: its input
    buffers, or what the enclosing step computed) -> the loop-carried
    buffers (``into``, or new ones), which hold its final state after the
    node.  The head launch copies the state into them and tests it; the
    tail launch copies the step's new leaves and tests them."""
    leaves, layout = flatten(state)
    name = _name(loop)
    prog = _test(loop, inputs, state)
    bufs = into if into is not None else [
        torch.empty_like(t, memory_format=torch.contiguous_format)
        for t in leaves]
    st = unflatten(layout, bufs)
    _check_leaves(f"the entry state of {name!r}", bufs, leaves)
    head, srcs = _copies(bufs, leaves)
    with _node(True, name, prog, prog.leaves(srcs), head) as body:
        with _stepping():
            new = loop.step(inputs, st, None)
        new, new_layout = flatten(new)
        _check_leaves(f"the step of {name!r}", bufs, new, layout, new_layout)
        tail, srcs = _copies(bufs, new)
        body.tail = (prog.leaves(srcs), tail)
    return st


def nest(loop: Loop):
    """Run a device-decided loop to its exit inside another loop's step
    -> its final state: a WHILE node under capture, else eagerly with a
    host read of the exit test before each step."""
    leaves, _ = flatten(loop.state)
    if _capturing(leaves[0]):
        return _while_node(loop, loop.inputs, loop.state)
    return _eager_loop(loop, loop.state)


def count_test(count: int) -> Callable:
    """``repeat``'s exit test: the counter st[0] below ``count``."""
    return lambda inp, st: st[0] < count


def repeat(step: Callable, inputs, state, count: int):
    """``state = step(inputs, state, j)`` for j = 0 .. count - 1 inside a
    device-decided loop's step -> the final state; ``j`` is a 0-d int64
    tensor on the state's device and ``count`` is fixed by the enclosing
    loop's key.  Under capture a WHILE node whose counter runs on the
    device (the step captured once, not ``count`` times); else a host
    loop with no read (the host knows the count); in a warm-up one step."""
    leaves, _ = flatten(state)
    j = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
    if _capturing(leaves[0]):
        loop = Loop(key=("repeat",), pack=None, inputs=inputs,
                    state=(j, state),
                    step=lambda inp, st, kind: (st[0] + 1,
                                                step(inp, st[1], st[0])),
                    running=count_test(count))
        return _while_node(loop, inputs, loop.state)[1]
    for _ in range(min(count, 1) if _WARM else count):
        state = step(inputs, state, j)
        j = j + 1
    return state


def branch(test: Callable, args, fn: Callable, other, name: str = "branch"):
    """fn() where ``test(*args)`` holds (a 0-d bool over the tensors of
    ``args``, recorded as a loop_cond program), else ``other`` (a tree of
    tensors, as fn() gives), inside a step captured with the kind None:
    an IF node whose head copies ``other`` into the output buffers and
    decides, and whose body computes fn() into them (lorads_tpu's
    ``lax.cond``)."""
    leaves, layout = flatten(other)
    prog = looptest.record(test, name, args)
    out = [torch.empty_like(t, memory_format=torch.contiguous_format)
           for t in leaves]
    _check_leaves(f"the other branch of {name!r}", out, leaves)
    with _node(False, name, prog, prog.leaves(None),
               _copies(out, leaves)[0]) as body:
        res, res_layout = flatten(fn())
        _check_leaves(f"the branch {name!r}", out, res, layout, res_layout)
        body.tail = ([], _copies(out, res)[0])
    return unflatten(layout, out)


@contextlib.contextmanager
def captures():
    """[(kind, start, seconds), ...] of the keys' warm-ups (``warm_up``)
    and graph captures (``capture``) made inside, each timed between
    device synchronises (time.time() at its start)."""
    global _CAPS
    prev, _CAPS = _CAPS, []
    try:
        yield _CAPS
    finally:
        _CAPS = prev


def _logged(kind: str):
    """Time a warm-up or capture function into ``captures``' list."""
    def wrap(fn):
        def timed(*a, **k):
            out = _CAPS
            if out is None:
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                out.append((kind, t0, time.time() - t0))
        return timed
    return wrap


@_logged("capture")
def _capture(bufs: _Buffers, loop: Loop) -> _Graph:
    """The loop's whole run captured over the buffers: ``init``, then the
    loop as a WHILE node, its final state copied into the state buffers
    and the pack computed inside the graph."""
    global _POOL, _STREAM, _COUNTERS
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    if _STREAM is None:
        _STREAM = torch.cuda.Stream()
    # the bodies' streams exist before the capture starts
    while len(_BODIES) < MAX_DEPTH:
        _BODIES.append([torch.cuda.Stream(), None])
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream()
    _STREAM.wait_stream(cur)
    tallies = []
    with torch.cuda.stream(_STREAM), kernels.recording() as launches:
        graph.capture_begin(pool=_POOL)
        try:
            inputs = bufs.tree("inputs")
            state = bufs.tree("state")
            _COUNTERS = [torch.zeros(MAX_BODIES, dtype=torch.int64,
                                     device=bufs.state[0].device),
                         {}, tallies]
            if loop.init is not None:
                state = loop.init(inputs, state)
            _while_node(loop, inputs, state, into=bufs.state)
            pack = loop.pack(inputs, bufs.tree("state"))
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
def timed():
    """CUDA events around every replay of a device-decided loop's graph
    made inside -> the list of (start, end) event pairs, one a replay."""
    global _TIMES
    prev, _TIMES = _TIMES, []
    try:
        yield _TIMES
    finally:
        _TIMES = prev


def _full_key(loop: Loop, in_leaves, in_layout, st_leaves, st_layout):
    return (loop.key, in_layout, st_layout,
            tuple((tuple(t.shape), t.dtype, t.device)
                  for t in in_leaves + st_leaves))


def eager_chunk(loop: Loop):
    """The loop's whole run, eagerly: init, then the steps, the host
    reading the exit test before each -> the final state."""
    state = loop.state
    if loop.init is not None:
        state = loop.init(loop.inputs, state)
    return _eager_loop(loop, state)


def graph_chunk(loop: Loop):
    """(graph, load, buffers) of this loop's key: the graph captured here
    if absent (the key's buffers made from this loop's tensors if absent;
    no warm-up) and a function that loads the loop's inputs and state
    into the buffers.  ``graph.replay()`` then runs the loop to its exit
    in the buffers, ``graph.read(label)`` reads its pack and counts its
    bodies, and ``buffers.tree("state")`` reads the final state."""
    in_leaves, in_layout = flatten(loop.inputs)
    st_leaves, st_layout = flatten(loop.state)
    key = _full_key(loop, in_leaves, in_layout, st_leaves, st_layout)
    bufs = _LOOPS.get(key)
    if bufs is None:
        bufs = _LOOPS[key] = _Buffers(in_layout, st_layout, in_leaves,
                                      st_leaves)
    if bufs.graph is None:
        bufs.graph = _capture(bufs, loop)
    return bufs.graph, lambda: bufs.load(in_leaves, st_leaves), bufs


@_logged("warm_up")
def _warm_up(loop: Loop, st_leaves, st_layout) -> None:
    """Before a key's first capture: init and one step of the loop on a
    copy of its state, every loop nested in the step run for one step
    (kind(0)), then the pack, no host read, the results dropped: every
    kernel of the graph is built and its launch attributes set outside
    the capture."""
    global _WARM
    state = unflatten(st_layout, [t.clone() for t in st_leaves])
    _WARM += 1
    try:
        if loop.init is not None:
            state = loop.init(loop.inputs, state)
        with _stepping():
            state = loop.step(loop.inputs, state, loop.kind(0))
        loop.pack(loop.inputs, state)
    finally:
        _WARM -= 1


def run(loop: Loop):
    """Run the loop to its exit -> (final state, its pack read to the
    host as a list): eagerly on CPU tensors and under a trace, else one
    replay of the key's graph."""
    if loop.K is not None:
        raise ValueError("devloop: a loop's length is decided on the "
                         "device (K None)")
    in_leaves, in_layout = flatten(loop.inputs)
    st_leaves, st_layout = flatten(loop.state)
    if not st_leaves[0].is_cuda or tracing():
        state = eager_chunk(loop)
        return state, dev.host_read(loop.pack(loop.inputs, state),
                                    loop.label)
    key = _full_key(loop, in_leaves, in_layout, st_leaves, st_layout)
    bufs = _LOOPS.get(key)
    if bufs is None:
        _warm_up(loop, st_leaves, st_layout)
        bufs = _LOOPS[key] = _Buffers(in_layout, st_layout, in_leaves,
                                      st_leaves)
    bufs.load(in_leaves, st_leaves)
    if bufs.graph is None:
        bufs.graph = _capture(bufs, loop)
    bufs.graph.replay()
    out = bufs.graph.read(loop.label)
    return unflatten(st_layout, [t.clone() for t in bufs.state]), out

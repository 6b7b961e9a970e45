"""A device-decided loop's exit test, or a branch's predicate, as a
program that ``kernels.loop_cond`` evaluates (csrc/graph_cond.cu).

lorads_tpu's ``lax.while_loop`` evaluates its cond as one fused
computation (``lorads_tpu/alg/cg.py``, ``alm.py``, ``admm.py``,
``lanczos.py``, ``spectral_repair.py``, ``dualrefine.py``); here a
loop's ``running(inputs, state)`` is called once on its leaves wrapped
in ``Expr``, which records each operation (operators and
``__torch_function__``) into a ``Program``: a list of nodes over 0-d and
1-D tensors, each with its dtype fixed as torch fixes it.  The leaves of
the state are slots bound at each launch (the sources of the copies
that launch makes); the inputs, and any other tensor the test reads,
are bound at recording.  ``Program.plain`` runs the nodes with the torch
operations they were recorded from, so it equals ``running`` on the same
tensors bit for bit; ``Program.table`` encodes them for the kernel, with
a cast wherever torch promotes an operand and each Python number at the
dtype torch computes in.

The operations: ``+ - * /`` and their reflections, ``%``, ``< <= > >= ==
!=``, ``& | ~``, ``torch.abs``, ``torch.clamp``, ``torch.isnan``,
``torch.all``, ``torch.any``, on bool, int32, int64, float32 and float64.
Anything else, a host read (``bool(...)``) included, raises a TypeError
naming the operation and the loop: the test then cannot run on the
device, and nothing falls back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# dtype codes and operation codes shared with csrc/graph_cond.cu
DTYPES = (torch.bool, torch.int32, torch.int64, torch.float32,
          torch.float64)
_DT = {d: i for i, d in enumerate(DTYPES)}
(LEAF, CONST, CAST, ADD, SUB, MUL, DIV, REM, RECIP, ABS, ISNAN, CLAMP, LT,
 LE, GT, GE, EQ, NE, AND, OR, NOT, ALL, ANY) = range(23)
NONE = 0xFFFF        # no operand (a clamp without a bound)
# the kernel's value table (shared memory, 8 bytes a value) and its
# operation table (its parameters) hold at most this many
MAX_VALUES, MAX_OPS = 6144, 160
OP_DTYPE = np.dtype([("code", "u1"), ("dtype", "u1"), ("ctype", "u1"),
                     ("flags", "u1"), ("a", "<u2"), ("b", "<u2"),
                     ("c", "<u2"), ("len", "<u2"), ("off", "<u2"),
                     ("pad", "<u2"), ("k", "<u8")])

_BINARY = {"add": torch.add, "sub": torch.sub, "rsub": torch.rsub,
           "mul": torch.mul, "div": torch.div,
           "remainder": torch.remainder, "lt": torch.lt, "le": torch.le,
           "gt": torch.gt, "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
           "bitwise_and": torch.bitwise_and,
           "bitwise_or": torch.bitwise_or}
_UNARY = {"reciprocal": torch.reciprocal, "abs": torch.abs,
          "isnan": torch.isnan, "bitwise_not": torch.bitwise_not,
          "all": torch.all, "any": torch.any}
_COMPARE = {"lt": LT, "le": LE, "gt": GT, "ge": GE, "eq": EQ, "ne": NE}
_ARITH = {"add": ADD, "sub": SUB, "mul": MUL, "div": DIV,
          "remainder": REM, "bitwise_and": AND, "bitwise_or": OR}
# torch functions and Tensor methods -> the recorded operation
_TORCH_FUNCS = None


def _torch_funcs():
    global _TORCH_FUNCS
    if _TORCH_FUNCS is None:
        T = torch.Tensor
        # the functions the tests call, and a Tensor's operators where a
        # tensor the test closes over is the left operand
        _TORCH_FUNCS = {torch.all: "all", torch.any: "any",
                        torch.abs: "abs", torch.isnan: "isnan",
                        torch.clamp: "clamp", T.__invert__: "bitwise_not"}
        for name in ("lt", "le", "gt", "ge", "eq", "ne"):
            _TORCH_FUNCS[getattr(T, f"__{name}__")] = name
        for dunder, name in (("add", "add"), ("sub", "sub"), ("mul", "mul"),
                             ("truediv", "div"), ("mod", "remainder"),
                             ("and", "bitwise_and"), ("or", "bitwise_or")):
            _TORCH_FUNCS[getattr(T, f"__{dunder}__")] = name
    return _TORCH_FUNCS


class _Ref:
    """An operand that is a node of the program."""

    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


class _Node:
    __slots__ = ("op", "args", "dtype", "shape", "ctype")

    def __init__(self, op, args, dtype, shape, ctype=None):
        self.op, self.args, self.dtype, self.shape = op, args, dtype, shape
        self.ctype = dtype if ctype is None else ctype


_STANDIN = {}


def _standin(dtype, ndim):
    """A one-element tensor of ``dtype`` (0-d or 1-D): torch's promotion
    of an operand depends on its dtype and on whether it has dimensions."""
    key = (dtype, ndim)
    t = _STANDIN.get(key)
    if t is None:
        t = _STANDIN[key] = torch.ones((1,) * ndim, dtype=dtype)
    return t


class Program:
    """A recorded test: ``nodes`` in order, ``result`` the node of the
    0-d bool decision, ``slots`` the leaves (("state", i): the i-th
    state leaf, bound at each launch; ("fixed", tensor): bound at
    recording), ``name`` the loop it tests."""

    def __init__(self, name):
        self.name = name
        self.nodes, self.slots, self.result = [], [], None
        self._fixed, self._table = {}, None

    # -- recording ---------------------------------------------------------

    def _fail(self, what):
        raise TypeError(f"loop_cond: {what} in the exit test of "
                        f"{self.name!r}, which the device cannot evaluate")

    def _leaf(self, kind, key, t):
        if t.dtype not in _DT:
            self._fail(f"a {t.dtype} tensor")
        if t.dim() > 1:
            self._fail(f"a tensor of shape {tuple(t.shape)} (only 0-d and "
                       "1-D tensors)")
        self.slots.append((kind, key))
        self.nodes.append(_Node("leaf", (len(self.slots) - 1,), t.dtype,
                                tuple(t.shape)))
        return len(self.nodes) - 1

    def wrap(self, kind, key, t) -> "Expr":
        """A leaf as an Expr; it becomes a slot of the program only when
        an operation reads it (one slot a tensor)."""
        if kind == "fixed":
            e = self._fixed.get(id(t))
            if e is None:
                e = self._fixed[id(t)] = Expr(self, None, (kind, key, t))
            return e
        return Expr(self, None, (kind, key, t))

    def _operand(self, x, op):
        if isinstance(x, Expr):
            if x.prog is not self:
                self._fail(f"{op} of two tests")
            if x.i is None:
                x.i = self._leaf(*x.leaf)
            return _Ref(x.i)
        if isinstance(x, torch.Tensor):
            return self._operand(self.wrap("fixed", x, x), op)
        if isinstance(x, (bool, int, float)) and not isinstance(
                x, np.generic):
            return x
        self._fail(f"{op} of a {type(x).__name__}")

    def _standin(self, x):
        if isinstance(x, _Ref):
            n = self.nodes[x.i]
            return _standin(n.dtype, len(n.shape))
        return x

    def _shape(self, args, op):
        shapes = [self.nodes[a.i].shape for a in args if isinstance(a, _Ref)]
        try:
            shape = tuple(torch.broadcast_shapes(*shapes))
        except RuntimeError:
            self._fail(f"{op} of shapes {shapes}")
        if len(shape) > 1:
            self._fail(f"{op} over a tensor of shape {shape} (only 0-d and "
                       "1-D tensors)")
        return shape

    def record(self, op, args, kw=None) -> "Expr":
        """Append the operation ``op`` on ``args`` (Exprs, tensors or
        Python numbers; ``kw``: clamp's bounds) -> its Expr."""
        args = tuple(self._operand(a, op) for a in args)
        if op == "clamp":
            kw = kw or {}
            if set(kw) - {"min", "max"}:
                self._fail(f"clamp with {sorted(kw)}")
            args = args + tuple(
                None if kw.get(k) is None else self._operand(kw[k], op)
                for k in ("min", "max"))
        if op not in _BINARY and op not in _UNARY and op != "clamp":
            self._fail(f"the operation {op}")
        if op == "remainder" and isinstance(args[1], (bool, int)) and \
                not isinstance(args[1], float) and args[1] == 0:
            self._fail("an integer remainder by 0")
        si = [self._standin(a) for a in args]
        try:
            if op == "clamp":
                out = torch.clamp(si[0], min=si[1], max=si[2])
            elif op in _BINARY:
                out = _BINARY[op](si[0], si[1])
            else:
                out = _UNARY[op](si[0])
        except (RuntimeError, TypeError) as e:
            self._fail(f"{op} ({e})")
        if out.dtype not in _DT:
            self._fail(f"{op} giving {out.dtype}")
        shape = () if op in ("all", "any") else self._shape(
            [a for a in args if a is not None], op)
        ctype = None
        if op in _COMPARE:
            ctype = torch.result_type(si[0], si[1])
        elif op in ("isnan", "all", "any"):
            ctype = self.nodes[args[0].i].dtype
        if (ctype or out.dtype) == torch.bool and op in (
                "add", "sub", "rsub", "mul", "div", "remainder",
                "reciprocal", "abs", "clamp"):
            self._fail(f"{op} on bool")
        self.nodes.append(_Node(op, args, out.dtype, shape, ctype))
        return Expr(self, len(self.nodes) - 1)

    def finish(self, out) -> "Program":
        if isinstance(out, Expr) and out.i is None:
            self._operand(out, "result")
        if not isinstance(out, Expr) or out.prog is not self:
            self._fail(f"a result of type {type(out).__name__}")
        n = self.nodes[out.i]
        if n.dtype != torch.bool or math.prod(n.shape) != 1:
            self._fail(f"a result of {n.dtype} and shape {n.shape} (need "
                       "one bool)")
        self.result = out.i
        return self

    # -- binding and the plain evaluation ----------------------------------

    def leaves(self, state) -> list:
        """The tensors of the slots, the state's from ``state`` (a list of
        leaves, or None where the program reads none)."""
        return [key if kind == "fixed" else state[key]
                for kind, key in self.slots]

    def plain(self, leaves) -> torch.Tensor:
        """The decision (0-d bool) from the slots' tensors: each node by
        the torch operation it was recorded from."""
        vals = []
        for n in self.nodes:
            a = [vals[x.i] if isinstance(x, _Ref) else x for x in n.args]
            if n.op == "leaf":
                vals.append(leaves[n.args[0]])
            elif n.op == "clamp":
                vals.append(torch.clamp(a[0], min=a[1], max=a[2]))
            elif n.op in _BINARY:
                vals.append(_BINARY[n.op](a[0], a[1]))
            else:
                vals.append(_UNARY[n.op](a[0]))
        return vals[self.result].reshape(())

    # -- the kernel's table ------------------------------------------------

    def table(self):
        """(operations as an OP_DTYPE array, [(op index, slot)] whose
        ``k`` takes the slot tensor's address at launch, values the table
        holds, the result's op index)."""
        if self._table is None:
            self._table = _Encoder(self).run()
        return self._table


def _number_bits(v, dtype) -> int:
    """A Python number at ``dtype``, as torch casts a wrapped number, as
    the 8 bits of the kernel's value (little-endian, low bytes first)."""
    if dtype == torch.float64:
        return int(np.array([float(v)], np.float64).view(np.uint64)[0])
    if dtype == torch.float32:
        return int(np.array([float(v)], np.float32).view(np.uint32)[0])
    if dtype == torch.bool:
        return int(bool(v))
    return int(v) & 0xFFFFFFFFFFFFFFFF if dtype == torch.int64 else \
        int(np.array([int(v)], np.int64).astype(np.int32)
            .view(np.uint32)[0])


class _Encoder:
    """Program -> the kernel's operation table: a cast before each operand
    torch promotes, each number a CONST at the dtype torch computes in."""

    def __init__(self, prog):
        self.p, self.ops, self.memo, self.patch = prog, [], {}, []

    def emit(self, code, dtype, ctype, length, a=NONE, b=NONE, c=NONE,
             k=0, key=None):
        if key is not None and key in self.memo:
            return self.memo[key]
        self.ops.append((code, _DT[dtype], _DT[ctype], length, a, b, c, k))
        i = len(self.ops) - 1
        if key is not None:
            self.memo[key] = i
        return i

    def const(self, v, dtype):
        bits = _number_bits(v, dtype)
        return self.emit(CONST, dtype, dtype, 1, k=bits,
                         key=("k", _DT[dtype], bits))

    def operand(self, x, dtype, node_ops):
        """The op index of operand ``x`` at ``dtype``."""
        if not isinstance(x, _Ref):
            return self.const(x, dtype)
        i = node_ops[x.i]
        src = self.ops[i]
        if DTYPES[src[1]] == dtype:
            return i
        return self.emit(CAST, dtype, DTYPES[src[1]], src[3], a=i,
                         key=("cast", i, _DT[dtype]))

    def run(self):
        p, node_ops = self.p, []
        for n in p.nodes:
            length = math.prod(n.shape)
            if n.op == "leaf":
                i = self.emit(LEAF, n.dtype, n.dtype, length)
                self.patch.append((i, n.args[0]))
            elif n.op in ("isnan", "all", "any"):
                a = node_ops[n.args[0].i]
                code = {"isnan": ISNAN, "all": ALL, "any": ANY}[n.op]
                i = self.emit(code, n.dtype, n.ctype, length, a=a)
            elif n.op in _COMPARE:
                a, b = (self.operand(x, n.ctype, node_ops) for x in n.args)
                i = self.emit(_COMPARE[n.op], n.dtype, n.ctype, length, a=a,
                              b=b)
            elif n.op == "rsub":
                x, v = n.args
                i = self.emit(SUB, n.dtype, n.dtype, length,
                              a=self.operand(v, n.dtype, node_ops),
                              b=self.operand(x, n.dtype, node_ops))
            elif n.op == "div" and not isinstance(n.args[1], _Ref):
                # t / number on a CUDA tensor: t times the number's
                # reciprocal, computed in the dtype (BinaryDivTrueKernel)
                if n.dtype == torch.float32:
                    inv = float(np.float32(1.0) / np.float32(n.args[1]))
                else:
                    inv = 1.0 / float(n.args[1])
                i = self.emit(MUL, n.dtype, n.dtype, length,
                              a=self.operand(n.args[0], n.dtype, node_ops),
                              b=self.const(inv, n.dtype))
            elif n.op in _ARITH:
                a, b = (self.operand(x, n.dtype, node_ops) for x in n.args)
                i = self.emit(_ARITH[n.op], n.dtype, n.dtype, length, a=a,
                              b=b)
            elif n.op in ("reciprocal", "abs", "bitwise_not"):
                code = {"reciprocal": RECIP, "abs": ABS,
                        "bitwise_not": NOT}[n.op]
                i = self.emit(code, n.dtype, n.dtype, length,
                              a=self.operand(n.args[0], n.dtype, node_ops))
            else:                                   # clamp
                x, lo, hi = (NONE if v is None else
                             self.operand(v, n.dtype, node_ops)
                             for v in n.args)
                i = self.emit(CLAMP, n.dtype, n.dtype, length, a=x, b=lo,
                              c=hi)
            node_ops.append(i)
        if len(self.ops) > MAX_OPS:
            p._fail(f"{len(self.ops)} operations (at most {MAX_OPS})")
        table = np.zeros(len(self.ops), OP_DTYPE)
        off = 0
        for j, (code, dt, ct, length, a, b, c, k) in enumerate(self.ops):
            table[j] = (code, dt, ct, 0, a, b, c, length, off, 0, k)
            off += length
        if off > MAX_VALUES:
            p._fail(f"{off} values (at most {MAX_VALUES})")
        return table, self.patch, off, node_ops[p.result]


class Expr:
    """A tensor of a test being recorded: operators and the torch functions
    of the set record into its Program."""

    __slots__ = ("prog", "i", "leaf")

    def __init__(self, prog, i, leaf=None):
        self.prog, self.i, self.leaf = prog, i, leaf

    @property
    def dtype(self):
        return (self.leaf[2] if self.i is None
                else self.prog.nodes[self.i]).dtype

    @property
    def shape(self):
        return torch.Size(self.leaf[2].shape if self.i is None
                          else self.prog.nodes[self.i].shape)

    def __bool__(self):
        self.prog._fail("a host read (bool)")

    def __index__(self):
        self.prog._fail("a host read (index)")

    __float__ = __int__ = __index__

    def __neg__(self):
        self.prog._fail("the operation neg")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        self.prog._fail(f"the operation {name}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        prog = next(a.prog for a in list(args) + list(kwargs.values())
                    if isinstance(a, Expr))
        op = _torch_funcs().get(func)
        if op is None:
            prog._fail(f"the operation {getattr(func, '__name__', func)}")
        if op == "clamp":
            lo = args[1] if len(args) > 1 else kwargs.pop("min", None)
            hi = args[2] if len(args) > 2 else kwargs.pop("max", None)
            if kwargs:
                prog._fail(f"clamp with {sorted(kwargs)}")
            return prog.record("clamp", args[:1], {"min": lo, "max": hi})
        if kwargs:
            prog._fail(f"{op} with {sorted(kwargs)}")
        if op in ("all", "any") and len(args) != 1:
            prog._fail(f"{op} over a dimension")
        return prog.record(op, args)


def _binop(name):
    def f(self, other):
        return self.prog.record(name, (self, other))
    return f


for _op in ("lt", "le", "gt", "ge", "eq", "ne", "add", "sub", "mul"):
    setattr(Expr, f"__{_op}__", _binop(_op))
Expr.__radd__ = _binop("add")
Expr.__rmul__ = _binop("mul")
Expr.__truediv__ = _binop("div")
Expr.__mod__ = _binop("remainder")
Expr.__and__ = Expr.__rand__ = _binop("bitwise_and")
Expr.__or__ = Expr.__ror__ = _binop("bitwise_or")
Expr.__hash__ = None


def _rsub(self, other):
    # Tensor.__rsub__: torch.rsub(self, other) = other - self
    return self.prog.record("rsub", (self, other))


def _rtruediv(self, other):
    # Tensor.__rtruediv__ is self.reciprocal() * other
    return self.prog.record("mul", (self.prog.record("reciprocal", (self,)),
                                    other))


def _invert(self):
    return self.prog.record("bitwise_not", (self,))


Expr.__rsub__ = _rsub
Expr.__rtruediv__ = _rtruediv
Expr.__invert__ = _invert


def record(fn, name, args, state=None) -> Program:
    """The Program of ``fn(*args)``: ``args`` are trees of tensors (as
    devloop flattens them); the leaves of ``args[state]`` become the state
    slots, bound at each launch, the others fixed slots.  ``name``: the
    loop, for the errors."""
    from lorads_torch.alg import devloop
    prog = Program(name)
    wrapped = []
    for j, a in enumerate(args):
        leaves, layout = devloop.flatten(a)
        wrapped.append(devloop.unflatten(layout, [
            prog.wrap("state", i, t) if j == state else
            prog.wrap("fixed", t, t) for i, t in enumerate(leaves)]))
    return prog.finish(fn(*wrapped))

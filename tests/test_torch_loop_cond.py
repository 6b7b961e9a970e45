"""loop_cond's programs on the CPU (alg/looptest.py, kernels.loop_cond_plain).

Every exit test and branch predicate of the port (the sites of
``lorads_torch.probes.loop_sites``), at f64 and f32, on seeded states
whose elements come from the program's own numbers, their neighbours,
0, ±1, NaN and ±inf: the program's plain version equals the test run on
torch tensors bit for bit, and so does ``emulate``, a NumPy reading of
the kernel's operation table (graph_cond.cu's ``evaluate``, operation
for operation: its casts, its constants at the compute dtype, the
reciprocal and product of ``number / t``).  The kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py).  Then each op's
semantics against torch, the errors at recording (an op outside the set,
a host read, a tensor of two dimensions, tables past the kernel's
capacity) and the head and tail copies.
"""

import zlib

import numpy as np
import pytest
import torch

from lorads_torch.alg import devloop, looptest
from lorads_torch.alg.looptest import (ABS, ADD, ALL, AND, ANY, CAST, CLAMP,
                                       CONST, DIV, EQ, GE, GT, ISNAN, LE,
                                       LEAF, LT, MUL, NE, NOT, OR, RECIP,
                                       REM, SUB)
from lorads_torch.ops import kernels
from lorads_torch.probes import loop_sites


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_NP = (np.bool_, np.int32, np.int64, np.float32, np.float64)


def _const(k, dt):
    k = np.array([k], np.uint64)
    if dt == 4:
        return k.view(np.float64)
    if dt == 3:
        return (k & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    if dt == 2:
        return k.view(np.int64)
    if dt == 1:
        return (k & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return k != 0


def emulate(prog, leaves) -> bool:
    """The kernel's decision from its operation table, read by NumPy."""
    ops, patch, _, result = prog.table()
    slot = dict(patch)
    vals = []
    with np.errstate(all="ignore"):
        for j, o in enumerate(ops):
            code, dt, ct = int(o["code"]), int(o["dtype"]), int(o["ctype"])
            x = vals[o["a"]] if o["a"] != looptest.NONE else None
            y = vals[o["b"]] if o["b"] != looptest.NONE else None
            if code == LEAF:
                v = leaves[slot[j]].numpy().reshape(-1)
                v = v != 0 if dt == 0 else v.astype(_NP[dt])
            elif code == CONST:
                v = _const(int(o["k"]), dt)
            elif code == CAST:
                v = x != 0 if dt == 0 else x.astype(_NP[dt])
            elif code == ISNAN:
                v = np.isnan(x) if ct >= 3 else np.zeros(x.shape, bool)
            elif code in (ALL, ANY):
                v = np.array([(np.all if code == ALL else np.any)(x != 0)])
            elif code in (LT, LE, GT, GE, EQ, NE):
                v = {LT: np.less, LE: np.less_equal, GT: np.greater,
                     GE: np.greater_equal, EQ: np.equal,
                     NE: np.not_equal}[code](x, y)
            elif code == REM and ct >= 3:
                v = np.fmod(x, y)
                fix = (v != 0) & ((y < 0) != (v < 0))
                v = np.where(fix, v + y, v).astype(_NP[ct])
            elif code == RECIP:
                v = _NP[ct](1) / x
            elif code == CLAMP:
                v = x
                for bound, pick in ((o["b"], np.less), (o["c"], np.greater)):
                    if bound == looptest.NONE:
                        continue
                    w = vals[bound]
                    v = np.where(np.isnan(v) if ct >= 3 else False, v,
                                 np.where(np.isnan(w) if ct >= 3 else False,
                                          w, np.where(pick(v, w), w, v)))
                v = v.astype(_NP[ct])
            elif code == NOT:
                v = ~x
            else:
                v = {ADD: np.add, SUB: np.subtract, MUL: np.multiply,
                     DIV: np.divide, REM: np.remainder, ABS: None,
                     AND: np.bitwise_and, OR: np.bitwise_or}[code]
                v = np.abs(x) if code == ABS else v(x, y)
                v = v.astype(_NP[ct])
            vals.append(np.asarray(v).reshape(-1))
    return bool(vals[result][0])


SITES = ("cg", "cg_ir", "cg_restart", "alm_outer", "alm_inner",
         "alm_inner (reopt)", "alm_middle", "alm_rho", "alm_refresh", "admm",
         "cgnr", "lanczos B=1", "lanczos B=3", "active_set", "repeat")
_SITES = {}


def _site(name, dtype):
    if dtype not in _SITES:
        _SITES[dtype] = {s.name: s for s in loop_sites.sites("cpu", dtype)}
    return _SITES[dtype][name]


def test_the_sites_are_every_site():
    assert tuple(s.name for s in loop_sites.sites("cpu")) == SITES


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", SITES)
def test_site_program_equals_its_test(name, dtype):
    """Seeded states of the site: the plain version (loop_sites.check)
    and the kernel's table read by NumPy equal the test on torch tensors,
    bit for bit; both outcomes occur."""
    site = _site(name, dtype)
    rng = np.random.default_rng(zlib.crc32(f"{name} {dtype}".encode()))
    out = loop_sites.check(site, 48, rng)
    assert 0 < out["true"] < 48 or name in ("repeat",)
    for _ in range(48):
        s = loop_sites.seeded(site, rng)
        prog, leaves = loop_sites._tested(s)
        assert emulate(prog, leaves) == bool(s.fn(*s.args)), name


def _prog(fn, *tensors):
    return looptest.record(fn, "t", tensors)


def _both(fn, *tensors):
    """(torch's answer, the plain version's, the table's) of fn."""
    prog = _prog(fn, *tensors)
    leaves = prog.leaves(None)
    return (bool(fn(*tensors)), bool(prog.plain(leaves)),
            emulate(prog, leaves))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_number_over_tensor_is_a_reciprocal_times_the_number(dtype):
    """0.1 / t is Tensor.__rtruediv__: t.reciprocal() * 0.1, the number at
    the tensor's dtype; the table holds RECIP then MUL, not a DIV."""
    rng = np.random.default_rng(3)
    for v in rng.uniform(0.01, 100.0, 200):
        t = torch.tensor(v, dtype=dtype)
        c = torch.tensor(float(torch.tensor(0.1, dtype=dtype) / t),
                         dtype=dtype)
        for cert in (c, torch.nextafter(c, c + 1), torch.nextafter(c, c - 1)):
            w, g, e = _both(lambda r, q: 0.1 / r >= q, t, cert)
            assert w == g == e
    codes = _prog(lambda r: 0.1 / r >= 1.0, torch.tensor(3.0)).table()[0][
        "code"].tolist()
    assert RECIP in codes and MUL in codes and DIV not in codes


def test_tensor_over_number_as_on_the_card():
    """t / number: the plain version is torch's (a division on the CPU);
    the table multiplies by the number's reciprocal at the dtype, as
    torch's CUDA kernel does with a CPU scalar."""
    t = torch.tensor(3.0, dtype=torch.float32)
    table = _prog(lambda x: x / 10.0 > 0.3, t).table()[0]
    (k,) = [int(o["k"]) for o in table if o["code"] == CONST
            and np.uint32(int(o["k"])).view(np.float32) != np.float32(0.3)]
    assert np.uint32(k).view(np.float32) == np.float32(1) / np.float32(10.0)
    assert MUL in table["code"].tolist() and DIV not in table["code"].tolist()


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.float64,
                                   torch.float32])
def test_remainder_takes_the_sign_of_the_divisor(dtype):
    for a in range(-7, 8):
        for d in (-3, -2, 2, 3, 20):
            x = torch.tensor(a, dtype=dtype)
            for r in range(-3, 4):
                w, g, e = _both(lambda v: v % d == r, x)
                assert w == g == e, (a, d, r)


def test_int_compared_with_a_float_in_the_default_dtype():
    """int64 against a Python float compares at torch's default float
    dtype (float32): 2**24 + 1 rounds to 2**24."""
    k = torch.tensor(2 ** 24 + 1, dtype=torch.int64)
    w, g, e = _both(lambda v: v == float(2 ** 24), k)
    assert w and g and e
    prog = _prog(lambda v: v == float(2 ** 24), k)
    table = prog.table()[0]
    assert CAST in table["code"].tolist()
    assert prog.nodes[-1].ctype == torch.get_default_dtype()
    # against an int64 tensor the comparison stays integral
    w, g, e = _both(lambda v, u: v == u, k,
                    torch.tensor(2 ** 24, dtype=torch.int64))
    assert not (w or g or e)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_in_comparisons(dtype):
    nan = torch.tensor(float("nan"), dtype=dtype)
    one = torch.tensor(1.0, dtype=dtype)
    for fn, want in ((lambda a, b: a < b, False), (lambda a, b: a <= b, False),
                     (lambda a, b: a > b, False), (lambda a, b: a >= b, False),
                     (lambda a, b: a == b, False), (lambda a, b: a != b, True),
                     (lambda a, b: torch.isnan(a) & (b > 0), True),
                     (lambda a, b: torch.clamp(a, min=0.5) < b, False),
                     (lambda a, b: torch.clamp(b, max=0.5) < b, True),
                     (lambda a, b: torch.abs(a) == a, False),
                     (lambda a, b: torch.abs(b) == b, True)):
        assert _both(fn, nan, one) == (want,) * 3


def test_all_and_any_of_an_empty_vector():
    e = torch.zeros(0, dtype=torch.bool)
    assert _both(lambda v: torch.all(v), e) == (True,) * 3
    assert _both(lambda v: ~torch.any(v), e) == (True,) * 3
    x = torch.zeros(0, dtype=torch.float64)
    assert _both(lambda v: torch.all(v < 1.0), x) == (True,) * 3


def test_vectors_broadcast_against_scalars():
    v = torch.tensor([1.0, float("nan"), -2.0, 3.0])
    k = torch.tensor(2, dtype=torch.int64)
    for fn in (lambda a, b: torch.all((a < b) | torch.isnan(a)),
               lambda a, b: torch.any(torch.abs(a) >= b),
               lambda a, b: ~torch.all(torch.clamp(a, min=-1.0, max=2.5)
                                       < b)):
        w, g, e = _both(fn, v, k)
        assert w == g == e


def test_unsupported_operation_raises_and_names_it():
    x = torch.tensor(2.0)
    with pytest.raises(TypeError, match=r"sqrt.*'my_loop'"):
        looptest.record(lambda a: torch.sqrt(a) < 1.0, "my_loop", (x,))
    with pytest.raises(TypeError, match=r"host read.*'my_loop'"):
        looptest.record(lambda a: torch.tensor(bool(a < 1.0)), "my_loop",
                        (x,))
    with pytest.raises(TypeError, match=r"neg.*'my_loop'"):
        looptest.record(lambda a: -a < 1.0, "my_loop", (x,))
    with pytest.raises(TypeError, match="shape"):
        looptest.record(lambda a: torch.all(a < 1.0), "my_loop",
                        (torch.zeros(2, 2),))
    with pytest.raises(TypeError, match="one bool"):
        looptest.record(lambda a: a + 1.0, "my_loop", (x,))


def test_loop_with_an_unsupported_test_raises_at_its_first_run():
    loop = devloop.Loop(
        key=("bad",), step=lambda inp, st, kind: (st[0] + 1,),
        pack=lambda inp, st: st[0].to(torch.float64).reshape(1),
        inputs=(), state=(torch.zeros(()),), label="other",
        running=lambda inp, st: torch.exp(st[0]) < 3.0)
    with pytest.raises(TypeError, match=r"exp.*'bad'"):
        devloop.run(loop)


def test_tables_past_the_kernel_capacity_raise():
    x = torch.tensor(1.0)

    def long_test(a):
        for _ in range(looptest.MAX_OPS):
            a = a + 1.0
        return a > 0.0
    with pytest.raises(TypeError, match="operations"):
        _prog(long_test, x).table()
    with pytest.raises(TypeError, match="values"):
        _prog(lambda v: torch.all(torch.abs(v) < 1.0),
              torch.zeros(looptest.MAX_VALUES)).table()
    n = kernels.LOOP_COND_MAX_COPIES + 1
    copies = [(torch.zeros(1), torch.zeros(1)) for _ in range(n)]
    with pytest.raises(ValueError, match="copies"):
        kernels._loop_cond_desc(None, [], copies, None, None,
                                torch.device("cpu"))


def test_copy_table_units_and_mismatches():
    a = torch.arange(40, dtype=torch.float64)
    b = torch.empty(40, dtype=torch.float64)
    table, units, nbytes = kernels.copy_table([(a, b), (a[1:], b[:39]),
                                               (a[:3], b[5:8])])
    assert nbytes == 320 + 312 + 24
    # 320 aligned bytes: 20 units; 312 bytes from a source 8 bytes past
    # the destination's alignment: bytewise units; 24 bytes 8 bytes in
    assert table["first"].tolist() == [0, 20, 40]
    assert units == 40 + 2
    with pytest.raises(ValueError):
        kernels.copy_table([(a, torch.empty(40, dtype=torch.float32))])
    with pytest.raises(ValueError):
        kernels.copy_table([(a.reshape(8, 5).T, torch.empty(5, 8,
                                                            dtype=a.dtype))])


def test_plain_head_and_tail_copy_and_count_as_assign_did():
    """devloop._copies + loop_cond_plain: a leaf that is its buffer is not
    copied, one that aliases another buffer is read before any buffer is
    written, and the counter gains one a launch."""
    bufs = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]),
            torch.tensor(5, dtype=torch.int64)]
    new = [bufs[1], bufs[0], bufs[2]]          # a swap, and one kept
    want = [t.clone() for t in new]
    copies, srcs = devloop._copies(bufs, new)
    assert len(copies) == 2
    # the copies and the test read no buffer a copy writes
    assert all(src.data_ptr() not in {b.data_ptr() for b in bufs}
               for src, _ in copies)
    assert srcs[2] is bufs[2] and srcs[0] is copies[0][0]
    ctr = torch.zeros(3, dtype=torch.int64)
    prog = looptest.record(lambda st: torch.all(st[0] < 9.0) & (st[2] < 9),
                           "t", (bufs,), state=0)
    d = kernels.loop_cond(prog, prog.leaves(srcs), copies, ctr[1])
    assert bool(d) and ctr.tolist() == [0, 1, 0]
    assert all(torch.equal(b, w) for b, w in zip(bufs, want))
    with pytest.raises(TypeError, match="buffer"):
        devloop._check_leaves("test", bufs,
                              [bufs[0], bufs[1], torch.tensor(5.0)])
    with pytest.raises(TypeError, match="strided"):
        devloop._check_leaves("test", [torch.zeros(2, 2)],
                              [torch.zeros(2, 2).T])


def test_eager_step_that_changes_a_leaf_raises():
    loop = devloop.Loop(
        key=("cast",), step=lambda inp, st, kind: (st[0] + 1.5,),
        pack=lambda inp, st: st[0].to(torch.float64).reshape(1),
        inputs=(), state=(torch.zeros((), dtype=torch.int64),),
        label="other", running=lambda inp, st: st[0] < 3)
    with pytest.raises(TypeError, match="leaf 0"):
        devloop.run(loop)

// loop_cond: the head and the tail of a conditional node of a CUDA graph
// (CUDA >= 12.4), one launch each, for the loops whose exit the device
// decides (alg/devloop.py) and the branches inside them.
//
// Replaces lorads_tpu's `lax.while_loop` cond and carry and `lax.cond`
// predicate in lorads_tpu/alg/{cg,alm,admm,lanczos,spectral_repair,
// dualrefine}.py: XLA evaluates a cond as one fused computation and
// updates the carry in place.  One launch here does, in order of need:
//
//  (a) the copies of a table of (source, destination, bytes) entries: at
//      a WHILE head the entry state into the loop-carried buffers, at a
//      WHILE tail the step's new leaves into them, at an IF head the
//      other branch's leaves and at an IF tail the body's result into the
//      output buffers.  Every thread but block 0's first warp takes
//      16-byte units of the concatenated table, a grid-stride loop: one
//      16-byte vector copy where source and destination share their
//      alignment and the unit lies inside the entry, narrower words at
//      the ragged ends.  The wrapper sizes the grid by the units (one
//      block for scalar-only states, up to four a SM when the L-BFGS
//      history or the factors are carried);
//  (b) the test (a loop's exit test, a branch's predicate: a program
//      recorded by alg/looptest.py over 0-d and small 1-D tensors):
//      block 0's first warp evaluates it node by node into a table of
//      8-byte values in shared memory, elementwise across the lanes,
//      `torch.all` / `torch.any` by warp votes.  Each operation rounds as
//      torch's kernel does (the `_rn` intrinsics, no contraction into an
//      FMA; the program carries torch's casts and each number at the
//      dtype torch computes in).  It reads the SOURCES of the copies
//      (the caller clones a source that is another entry's destination),
//      so it waits for no other block;
//  (c) the count and the decision: lane 0 adds one to the body's run
//      counter, writes the decision byte and, in a graph, sets the node's
//      condition (cudaGraphSetConditional).
//
// The table and the program are the kernel's parameters, passed by value
// (`__grid_constant__`, at most 32764 bytes from CUDA 12.1 on sm_90): a
// graph's kernel node keeps them, so nothing is copied to the device
// during a capture.  Four capacities; the wrapper takes the smallest that
// fits and raises past the largest.
//
// Bound: the bytes the launch moves (each copy's bytes read and written,
// the test's leaves read) over 3.35 TB/s, a few ns for scalar states; in
// practice the conditional relaunch and the launch itself, which
// chip_smoke.py measures (`loop_cond floor:`).  The design's answer is
// to be the only launch at a node's head and at its tail: a body that
// ended in one copy kernel a carried leaf, a few torch kernels of its
// exit test and a one-thread set-condition kernel now ends in this one.
//
// lt_loop_cond launches it outside a capture (the eager loop: no
// condition set, the host reads the decision byte).  lt_cond_begin, on a
// stream being captured, creates a conditional handle, captures the head
// launch setting it, adds a WHILE (IF) node after it, moves the capture
// past the node and starts capturing `child` into the node's body;
// lt_cond_end captures the tail launch (a WHILE node's sets the
// condition for the next run), ends the body's capture and reports the
// body's node count; lt_cond_abort ends the body's capture alone.

#include <cuda_runtime.h>

namespace {

enum DType { B8 = 0, I32 = 1, I64 = 2, F32 = 3, F64 = 4 };
enum Code {
  LEAF, CONST, CAST, ADD, SUB, MUL, DIV, REM, RECIP, ABS, ISNAN, CLAMP, LT,
  LE, GT, GE, EQ, NE, AND, OR, NOT, ALL, ANY
};
constexpr unsigned short NONE = 0xFFFF;

// alg/looptest.py's OP_DTYPE and kernels.py's copy entries, byte for byte
struct Op {
  unsigned char code, dtype, ctype, flags;
  unsigned short a, b, c, len, off, pad;
  unsigned long long k;   // CONST: the value's bits; LEAF: its address
};
struct Copy {
  unsigned long long src, dst;
  unsigned int bytes, first;   // first: the entry's first 16-byte unit
};
static_assert(sizeof(Op) == 24 && sizeof(Copy) == 24, "table layout");

// what the wrapper passes (kernels.py's _Desc)
struct Desc {
  unsigned long long handle, decision, counter, copies, ops;
  unsigned int n_copies, units, n_ops, result, grid, block, smem, pad;
};

template <int NC, int NO>
struct Params {
  unsigned long long handle;      // 0: set no condition
  unsigned char* decision;        // or null
  unsigned long long* counter;    // or null
  unsigned int n_copies, units, n_ops, result;
  Copy copies[NC];
  Op ops[NO];
};

union Val {
  double d;
  float f;
  long long l;
  int i;
  unsigned char b;
  unsigned long long u;
};

__device__ __forceinline__ bool truthy(Val v, int t) {
  switch (t) {
    case B8: return v.b != 0;
    case I32: return v.i != 0;
    case I64: return v.l != 0;
    case F32: return v.f != 0.0f;     // NaN is nonzero
    default: return v.d != 0.0;
  }
}

__device__ __forceinline__ Val cast(Val x, int from, int to) {
  Val r;
  r.u = 0;
  if (to == B8) {
    r.b = truthy(x, from);
    return r;
  }
  switch (from) {
    case B8: {
      const int v = x.b != 0;
      if (to == I32) r.i = v;
      else if (to == I64) r.l = v;
      else if (to == F32) r.f = v ? 1.0f : 0.0f;
      else r.d = v ? 1.0 : 0.0;
      break;
    }
    case I32:
      if (to == I64) r.l = x.i;
      else if (to == F32) r.f = __int2float_rn(x.i);
      else if (to == F64) r.d = __int2double_rn(x.i);
      else r.i = x.i;
      break;
    case I64:
      if (to == I32) r.i = (int)x.l;
      else if (to == F32) r.f = __ll2float_rn(x.l);
      else if (to == F64) r.d = __ll2double_rn(x.l);
      else r.l = x.l;
      break;
    case F32:
      if (to == I32) r.i = (int)x.f;
      else if (to == I64) r.l = (long long)x.f;
      else if (to == F64) r.d = (double)x.f;
      else r.f = x.f;
      break;
    default:
      if (to == I32) r.i = (int)x.d;
      else if (to == I64) r.l = (long long)x.d;
      else if (to == F32) r.f = __double2float_rn(x.d);
      else r.d = x.d;
      break;
  }
  return r;
}

template <typename T>
__device__ __forceinline__ bool compare(int code, T a, T b) {
  switch (code) {
    case LT: return a < b;
    case LE: return a <= b;
    case GT: return a > b;
    case GE: return a >= b;
    case EQ: return a == b;
    default: return a != b;     // NE: true against a NaN
  }
}

// torch's remainder: the sign of the divisor
template <typename T>
__device__ __forceinline__ T int_rem(T a, T b) {
  T r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// op `code` on x (and y) at the type t
__device__ Val apply(int code, int t, Val x, Val y) {
  Val r;
  r.u = 0;
  if (code >= LT && code <= NE) {
    switch (t) {
      case B8: r.b = compare(code, x.b != 0, y.b != 0); break;
      case I32: r.b = compare(code, x.i, y.i); break;
      case I64: r.b = compare(code, x.l, y.l); break;
      case F32: r.b = compare(code, x.f, y.f); break;
      default: r.b = compare(code, x.d, y.d); break;
    }
    return r;
  }
  switch (t) {
    case F64:
      switch (code) {
        case ADD: r.d = __dadd_rn(x.d, y.d); break;
        case SUB: r.d = __dsub_rn(x.d, y.d); break;
        case MUL: r.d = __dmul_rn(x.d, y.d); break;
        case DIV: r.d = __ddiv_rn(x.d, y.d); break;
        case RECIP: r.d = __ddiv_rn(1.0, x.d); break;
        case ABS: r.d = fabs(x.d); break;
        case REM: {
          double m = fmod(x.d, y.d);
          if (m != 0.0 && ((y.d < 0.0) != (m < 0.0))) m = __dadd_rn(m, y.d);
          r.d = m;
          break;
        }
      }
      break;
    case F32:
      switch (code) {
        case ADD: r.f = __fadd_rn(x.f, y.f); break;
        case SUB: r.f = __fsub_rn(x.f, y.f); break;
        case MUL: r.f = __fmul_rn(x.f, y.f); break;
        case DIV: r.f = __fdiv_rn(x.f, y.f); break;
        case RECIP: r.f = __fdiv_rn(1.0f, x.f); break;
        case ABS: r.f = fabsf(x.f); break;
        case REM: {
          float m = fmodf(x.f, y.f);
          if (m != 0.0f && ((y.f < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, y.f);
          r.f = m;
          break;
        }
      }
      break;
    case I64: {
      const unsigned long long a = x.u, b = y.u;
      switch (code) {
        case ADD: r.u = a + b; break;
        case SUB: r.u = a - b; break;
        case MUL: r.u = a * b; break;
        case REM: r.l = int_rem(x.l, y.l); break;
        case ABS: r.l = x.l < 0 ? (long long)(0ull - a) : x.l; break;
        case AND: r.u = a & b; break;
        case OR: r.u = a | b; break;
        case NOT: r.u = ~a; break;
      }
      break;
    }
    case I32: {
      const unsigned a = (unsigned)x.i, b = (unsigned)y.i;
      switch (code) {
        case ADD: r.i = (int)(a + b); break;
        case SUB: r.i = (int)(a - b); break;
        case MUL: r.i = (int)(a * b); break;
        case REM: r.i = int_rem(x.i, y.i); break;
        case ABS: r.i = x.i < 0 ? (int)(0u - a) : x.i; break;
        case AND: r.i = (int)(a & b); break;
        case OR: r.i = (int)(a | b); break;
        case NOT: r.i = (int)~a; break;
      }
      break;
    }
    default:    // bool: the logical operations
      switch (code) {
        case AND: r.b = (x.b != 0) & (y.b != 0); break;
        case OR: r.b = (x.b != 0) | (y.b != 0); break;
        case NOT: r.b = x.b == 0; break;
      }
      break;
  }
  return r;
}

__device__ __forceinline__ bool is_nan(Val v, int t) {
  return (t == F32 && v.f != v.f) || (t == F64 && v.d != v.d);
}

__device__ __forceinline__ Val load(unsigned long long addr, int t, int i) {
  Val r;
  r.u = 0;
  switch (t) {
    case B8: r.b = reinterpret_cast<const unsigned char*>(addr)[i] != 0; break;
    case I32: r.i = reinterpret_cast<const int*>(addr)[i]; break;
    case I64: r.l = reinterpret_cast<const long long*>(addr)[i]; break;
    case F32: r.f = reinterpret_cast<const float*>(addr)[i]; break;
    default: r.d = reinterpret_cast<const double*>(addr)[i]; break;
  }
  return r;
}

// operand `j`'s element i (a length-1 operand broadcasts)
template <typename P>
__device__ __forceinline__ Val at(const P& p, const Val* vals, int j, int i) {
  const Op& o = p.ops[j];
  return vals[o.off + (o.len == 1 ? 0 : i)];
}

// the program, by warp 0 of block 0 -> the decision
template <typename P>
__device__ bool evaluate(const P& p, Val* vals, int lane) {
  for (unsigned k = 0; k < p.n_ops; ++k) {
    const Op& o = p.ops[k];
    if (o.code == ALL || o.code == ANY) {
      const Op& a = p.ops[o.a];
      bool acc = o.code == ALL;
      for (int i = lane; i < a.len; i += 32) {
        const bool t = truthy(vals[a.off + i], a.dtype);
        acc = o.code == ALL ? (acc && t) : (acc || t);
      }
      const bool r = o.code == ALL ? __all_sync(0xffffffffu, acc)
                                   : __any_sync(0xffffffffu, acc);
      if (lane == 0) {
        Val v;
        v.u = 0;
        v.b = r;
        vals[o.off] = v;
      }
    } else {
      for (int i = lane; i < o.len; i += 32) {
        Val r;
        switch (o.code) {
          case LEAF: r = load(o.k, o.dtype, i); break;
          case CONST: r.u = o.k; break;
          case CAST: r = cast(at(p, vals, o.a, i), o.ctype, o.dtype); break;
          case ISNAN:
            r.u = 0;
            r.b = is_nan(at(p, vals, o.a, i), o.ctype);
            break;
          case CLAMP: {
            r = at(p, vals, o.a, i);
            if (is_nan(r, o.ctype)) break;
            if (o.b != NONE) {
              const Val lo = at(p, vals, o.b, i);
              if (is_nan(lo, o.ctype)) { r = lo; break; }
              if (apply(LT, o.ctype, r, lo).b) r = lo;
            }
            if (o.c != NONE) {
              const Val hi = at(p, vals, o.c, i);
              if (is_nan(hi, o.ctype)) { r = hi; break; }
              if (apply(GT, o.ctype, r, hi).b) r = hi;
            }
            break;
          }
          case RECIP: case ABS: case NOT:
            r = apply(o.code, o.ctype, at(p, vals, o.a, i), Val{});
            break;
          default:
            r = apply(o.code, o.ctype, at(p, vals, o.a, i),
                      at(p, vals, o.b, i));
            break;
        }
        vals[o.off + i] = r;
      }
    }
    __syncwarp();
  }
  return vals[p.ops[p.result].off].b != 0;
}

// bytes [lo, hi) of one entry, in the widest words both sides allow
__device__ __forceinline__ void copy_bytes(const char* s, char* d, long long lo,
                                           long long hi) {
  while (lo < hi) {
    const unsigned long long a =
        reinterpret_cast<unsigned long long>(s + lo) |
        reinterpret_cast<unsigned long long>(d + lo);
    if ((a & 7) == 0 && lo + 8 <= hi) {
      *reinterpret_cast<unsigned long long*>(d + lo) =
          *reinterpret_cast<const unsigned long long*>(s + lo);
      lo += 8;
    } else if ((a & 3) == 0 && lo + 4 <= hi) {
      *reinterpret_cast<unsigned*>(d + lo) =
          *reinterpret_cast<const unsigned*>(s + lo);
      lo += 4;
    } else {
      d[lo] = s[lo];
      lo += 1;
    }
  }
}

// 16-byte unit u of the concatenated table
template <typename P>
__device__ __forceinline__ void copy_unit(const P& p, unsigned u) {
  unsigned lo = 0, hi = p.n_copies - 1;
  while (lo < hi) {               // the last entry starting at or before u
    const unsigned mid = (lo + hi + 1) >> 1;
    if (p.copies[mid].first <= u) lo = mid;
    else hi = mid - 1;
  }
  const Copy& c = p.copies[lo];
  const char* s = reinterpret_cast<const char*>(c.src);
  char* d = reinterpret_cast<char*>(c.dst);
  const bool vec = ((c.src ^ c.dst) & 15) == 0;
  const long long mis = vec ? (long long)(c.src & 15) : 0;
  const long long b0 = (long long)(u - c.first) * 16 - mis;
  const long long b1 = b0 + 16;
  if (vec && b0 >= 0 && b1 <= (long long)c.bytes) {
    *reinterpret_cast<int4*>(d + b0) = *reinterpret_cast<const int4*>(s + b0);
  } else {
    copy_bytes(s, d, b0 < 0 ? 0 : b0,
               b1 > (long long)c.bytes ? (long long)c.bytes : b1);
  }
}

template <int NC, int NO>
__global__ void __launch_bounds__(256)
    loop_cond_kernel(const __grid_constant__ Params<NC, NO> p) {
  extern __shared__ Val vals[];
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < 32) {
    bool r = false;
    if (p.n_ops) r = evaluate(p, vals, threadIdx.x);
    if (threadIdx.x == 0) {
      if (p.counter != nullptr) *p.counter += 1;
      if (p.n_ops) {
        if (p.decision != nullptr) *p.decision = r;
        if (p.handle != 0) cudaGraphSetConditional(p.handle, r ? 1u : 0u);
      }
    }
    return;
  }
  const unsigned stride = gridDim.x * blockDim.x - 32;
  for (unsigned u = tid - 32; u < p.units; u += stride) copy_unit(p, u);
}

template <int NC, int NO>
cudaError_t launch_as(const Desc& d, cudaStream_t s) {
  static Params<NC, NO> p;    // the host's copy; the launch takes its bytes
  p.handle = d.handle;
  p.decision = reinterpret_cast<unsigned char*>(d.decision);
  p.counter = reinterpret_cast<unsigned long long*>(d.counter);
  p.n_copies = d.n_copies;
  p.units = d.units;
  p.n_ops = d.n_ops;
  p.result = d.result;
  const Copy* c = reinterpret_cast<const Copy*>(d.copies);
  const Op* o = reinterpret_cast<const Op*>(d.ops);
  for (unsigned i = 0; i < d.n_copies; ++i) p.copies[i] = c[i];
  for (unsigned i = 0; i < d.n_ops; ++i) p.ops[i] = o[i];
  loop_cond_kernel<NC, NO><<<d.grid, d.block, d.smem, s>>>(p);
  return cudaGetLastError();
}

// the capacities (copies, operations); the largest fills 32672 bytes
constexpr int CAP_OPS = 160;
constexpr int CAP_COPIES = 1200;

// the error of a stream that is not being captured, and of a table past
// the largest capacity
constexpr int NOT_CAPTURING = 1000;
constexpr int TOO_LARGE = 1001;

cudaError_t launch(const Desc& d, cudaStream_t s) {
  if (d.n_ops > CAP_OPS) return (cudaError_t)TOO_LARGE;
  if (d.n_copies <= 8 && d.n_ops <= 32) return launch_as<8, 32>(d, s);
  if (d.n_copies <= 64 && d.n_ops <= 64) return launch_as<64, 64>(d, s);
  if (d.n_copies <= 256) return launch_as<256, CAP_OPS>(d, s);
  if (d.n_copies <= CAP_COPIES) return launch_as<CAP_COPIES, CAP_OPS>(d, s);
  return (cudaError_t)TOO_LARGE;
}

}  // namespace

// (a Desc is passed as void*: a C entry point whose parameter type lies
// in the unnamed namespace would not be exported)
extern "C" int lt_loop_cond(const void* desc, void* stream) {
  return (int)launch(*static_cast<const Desc*>(desc),
                     static_cast<cudaStream_t>(stream));
}

extern "C" int lt_cond_begin(int is_while, void* desc, void* child,
                             unsigned long long* handle_out, void* stream) {
  Desc* d = static_cast<Desc*>(desc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                           &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return NOT_CAPTURING;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  d->handle = handle;
  e = launch(*d, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child), body,
                                    nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle_out = handle;
  return 0;
}

extern "C" int lt_cond_end(const void* desc, void* child,
                           unsigned long long* nodes_out) {
  const Desc* d = static_cast<const Desc*>(desc);
  cudaStream_t c = static_cast<cudaStream_t>(child);
  const cudaError_t e = launch(*d, c);
  cudaGraph_t body;
  const cudaError_t e2 = cudaStreamEndCapture(c, &body);
  if (e != cudaSuccess) return (int)e;
  if (e2 != cudaSuccess) return (int)e2;
  size_t n = 0;
  const cudaError_t e3 = cudaGraphGetNodes(body, nullptr, &n);
  *nodes_out = n;
  return (int)e3;
}

extern "C" int lt_cond_abort(void* child) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

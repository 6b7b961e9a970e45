// K8c lp_gs_sweep: the Gauss-Seidel sweep over the LP columns.
//
// Replaces lorads_tpu/alg/admm.py:_update_lp_var_gs (a lax.scan over the
// columns; reference LORADSUpdateLPVarOne, lorads_admm.c:595-628, driven
// column by column by lorads_alg_common.c:229-247).  Column j, in order:
//
//   base  = sum_k val_k * (rho * (csum[con_k] - rhs[con_k]) - dual[con_k])
//   wsum  = (c_j + base) - ((rho * nrm2_j) * u_j) * v_j
//   m2    = (wsum * v_j) - rho * v_j        [+ s_j, with s]
//   new_j = ((-m2) / rho) / (1 + (nrm2_j * v_j) * v_j)
//   csum[con_k] += (val_k * (new_j - u_j)) * v_j      for every entry k
//
// over the padded per-column layout pc_con / pc_val [n, L] (padding ids
// equal m and are skipped).  Column j reads the csum that columns
// 0..j-1 updated, so the sweep is sequential by construction: one warp
// walks the columns in order.  Per column the lanes read the column's
// entries (lane l takes k = l, l+32, ...), sum their terms in order, and
// combine the 32 partial sums by shuffles (offsets 16, 8, 4, 2, 1), each
// lane forming new_j alike; the lanes then add their entries' deltas
// into csum.  A column whose ids do not strictly increase (so may
// repeat) has its deltas applied by lane 0 alone in order of k, as the
// plain version's index_add_ on the CPU does: bit for bit with repeated
// ids too.  Every operation is an explicitly rounded intrinsic
// (__dmul_rn, ...): no FMA contraction, so the plain version
// (kernels.lp_gs_sweep_plain), which sums in the same lane order, agrees
// bit for bit.
//
// What bounds it: the chain of n dependent column steps; the bytes (the
// [n, L] layout once, five [n] vectors, three [m] vectors) take far
// less.  One warp alone, reading everything from L2, spends 1.6-1.9 us a
// step on round trips in series (the column's ids and values, csum
// through __ldcg, four scalars, atomics and a fence).  Only csum depends
// on the chain, so here:
//
// * csum lives in shared memory (SMEM_CSUM: m up to the room beside the
//   ring, lt_lp_gs_smem_max_m: 23596 at f64, 51860 at f32), loaded at
//   the start and written back at the end; the chain reads and updates
//   it there with plain loads and stores (one warp, distinct slots,
//   __syncwarp between columns).  Larger m keeps csum in global memory
//   (SMEM_CSUM false), read and written by the same warp through L1 in
//   the same order.
// * PRODUCERS warps stream the columns ahead into a ring of RING pieces
//   in shared memory (a piece: up to 4 rounds of 32 entries, a whole
//   column at multiblock_lp's L = 74; the entries' ids and values and
//   the column's four scalars copied with cp.async, then, LAG steps
//   later, the rhs / dual at the ids gathered with cp.async and the
//   column's ids checked for increase), with full and empty mbarriers
//   per piece; cp.async.mbarrier.arrive signals the copies.  One
//   producer warp took about as long a column as the consumer's step, so
//   two warps take alternate columns.  A column of more than one piece
//   (L > 128) is released piece by piece after its sum, and its update
//   reads its ids and values again from global memory.
// * The consumer warp's step is shared memory and registers only: the
//   next column is read from the ring while this one is formed, the
//   parts of new_j that do not depend on csum ((rho nrm2) u v, rho v,
//   1 + nrm2 v^2) are computed ahead, an increasing column updates csum
//   from the values its sum read, and the outputs are stored 32 at a
//   time.  What is left per step is the exact arithmetic: the column's
//   terms, the five-level shuffle butterfly and two f64 divisions, about
//   1170 cycles (0.59 us) a step on an NVIDIA H100 80GB HBM3 at 700 W,
//   where one dependent shared-memory load takes 29.
//
// s, when given, is the DUAL_U_V variant's signed consensus term
// (lorads_tpu/alg/admm.py:253, lorads_admm.c:658-660): a fifth scalar of
// the column, copied into its piece with the other four, added to m2 as
// one rounded add.  A null s takes the kernel without the term (HAS_S
// false), today's code.
//
// Both csum instantiations give the same bits; lt_lp_gs_sweep picks one
// by m, the dtype and whether s is given.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SR = 4;        // rounds of 32 entries a piece holds
constexpr int PE = 32 * SR;  // entries a piece holds
constexpr int RING = 12;     // pieces in the ring
constexpr int LAG = 4;       // the producer's steps between copy and gather
constexpr int PRODUCERS = 2;  // producer warps (alternate short columns)
constexpr int THREADS = 32 * (1 + PRODUCERS);  // warp 0 runs the chain
constexpr int SMEM_MAX = 232448;

template <typename T>
struct Rn;

template <>
struct Rn<double> {
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double div(double a, double b) { return __ddiv_rn(a, b); }
};

template <>
struct Rn<float> {
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

// Up to SR rounds of a column (its entries PE q .. PE q + PE - 1, lane l
// of round i holding entry PE q + 32 i + l) in the ring.
template <typename T, bool HAS_S>
struct Piece {
  T val[PE], rhs[PE], dual[PE];
  // obj, nrm2, upd, fixed (and s) of the column (its first piece)
  T scal[HAS_S ? 5 : 4];
  int con[PE];
  int sorted;  // (the column's last piece) its ids strictly increase
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the arrival fires when this thread's earlier cp.async copies have
// landed (the pending count is raised first, so the phase waits for it)
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// has the barrier's phase of this parity completed? (no waiting)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the barrier's phase of this parity (try_wait suspends the
// thread in hardware between polls).  A wait that never ends would hold
// the card: after 2^24 polls (seconds, where a real wait takes
// microseconds) the kernel traps, so the launch fails and the caller's
// next synchronisation raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

template <typename V>
__device__ __forceinline__ void copy_async(V* dst, const V* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(sizeof(V))
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but this thread's LAG most recent groups of copies have landed
__device__ __forceinline__ void copies_wait_lag() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(LAG) : "memory");
}

__device__ __forceinline__ unsigned slot_of(unsigned q) { return q % RING; }
__device__ __forceinline__ unsigned parity_of(unsigned q) {
  return (q / RING) & 1u;
}

// A position in the ring: its slot and the parity of the slot's use.
struct RingPos {
  unsigned slot = 0, parity = 0;
  __device__ __forceinline__ void advance(unsigned by) {  // by <= RING
    slot += by;
    if (slot >= RING) {
      slot -= RING;
      parity ^= 1u;
    }
  }
};

// A producer warp: pieces into the ring, in order, with no load in its
// own path: piece s's ids, values and scalars are copied (cp.async) at
// its step s, and at step s + LAG, when they have landed, its ids are
// read back, checked (increasing along the column: a shuffle per round,
// one vote a piece) and its rhs / dual gathered; then it is published on
// its full barrier.  Rounds past the column's last entry are skipped.
// With short columns (np == 1) the PRODUCERS warps take alternate
// columns (first, first + stride, ...); longer columns take one warp.
template <typename T, bool HAS_S>
__device__ void produce(Piece<T, HAS_S>* ring, uint64_t* full,
                        uint64_t* empty, const int* __restrict__ pc_con,
                        const T* __restrict__ pc_val,
                        const T* __restrict__ obj, const T* __restrict__ nrm2,
                        const T* __restrict__ upd,
                        const T* __restrict__ fixed,
                        const T* __restrict__ rhs, const T* __restrict__ dual,
                        const T* __restrict__ sv, int n, int L, int m, int np,
                        int first, int stride) {
  const int lane = threadIdx.x & 31;
  RingPos fill, pub;       // the piece being copied, the piece published
  fill.advance(first);
  pub.advance(first);
  int fj = first, fq = 0;  // its column and part
  int pq = 0;              // the published piece's part
  int last = -1;           // the previous entry's id along the column
  bool sorted = true;
  // this warp's pieces: every stride-th column's (np == 1), or all
  const long own = np == 1 ? (n - first + stride - 1) / stride
                           : (long)n * np;
  for (long s = 0; s < own + LAG; ++s) {
    if (s < own) {
      Piece<T, HAS_S>& P = ring[fill.slot];
      if (!mbar_test(&empty[fill.slot], fill.parity ^ 1u))
        mbar_wait(&empty[fill.slot], fill.parity ^ 1u);
      const long col = (long)fj * L;
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int e = 32 * i + lane, k = PE * fq + e;
        if (PE * fq + 32 * i >= L) break;
        if (k < L) {
          copy_async(&P.con[e], pc_con + col + k);
          copy_async(&P.val[e], pc_val + col + k);
        } else {
          P.con[e] = m;
        }
      }
      if (fq == 0 && lane < (HAS_S ? 5 : 4)) {
        const T* src = lane == 0 ? obj : lane == 1 ? nrm2 : lane == 2 ? upd
                       : lane == 3 ? fixed : sv;
        copy_async(&P.scal[lane], src + fj);
      }
      fill.advance(stride);
      if (np == 1) {
        fj += stride;
      } else if (++fq == np) {
        fq = 0;
        ++fj;
      }
    }
    copies_commit();
    if (s < LAG) continue;
    Piece<T, HAS_S>& P = ring[pub.slot];
    copies_wait_lag();
    bool up = true;  // this lane's entries follow their predecessors
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      if (PE * pq + 32 * i >= L) break;
      const int e = 32 * i + lane;
      const int c = P.con[e];
      int prev = __shfl_up_sync(FULL, c, 1);
      if (lane == 0) prev = pq == 0 && i == 0 ? -1 : last;
      up = up && (c >= m || prev < c);
      last = __shfl_sync(FULL, c, 31);
      if (c < m) {
        copy_async(&P.rhs[e], rhs + c);
        copy_async(&P.dual[e], dual + c);
      }
    }
    sorted = (pq == 0 || sorted) && __all_sync(FULL, up);
    if (lane == 0 && pq == np - 1) P.sorted = sorted;
    mbar_arrive_copies(&full[pub.slot]);
    mbar_arrive(&full[pub.slot]);
    pub.advance(stride);
    if (++pq == np) pq = 0;
  }
}

// the column's scalars and the parts of its update that do not depend on
// the chain: q = ((rho nrm2) u) v, rv = rho v, den = 1 + (nrm2 v) v
template <typename T, bool HAS_S>
struct Scalars {
  T obj, u, v, q, rv, den, s;
  __device__ __forceinline__ void load(const T* scal, T rho) {
    using R = Rn<T>;
    const T nr2 = scal[1];
    obj = scal[0];
    u = scal[2];
    v = scal[3];
    if (HAS_S) s = scal[HAS_S ? 4 : 0];
    q = R::mul(R::mul(R::mul(rho, nr2), u), v);
    rv = R::mul(rho, v);
    den = R::add(T(1), R::mul(R::mul(nr2, v), v));
  }
};

// new_j from the lanes' sums of the column's terms, on every lane.  The
// butterfly adds, at each level, the same two values on both partner
// lanes (in either order: addition commutes exactly), so every lane ends
// with the sum lane 0 forms in the shuffle-down tree of the plain
// version (offsets 16, 8, 4, 2, 1), and computes new_j from it alike.
template <typename T, bool HAS_S>
__device__ __forceinline__ T column_value(T acc, const Scalars<T, HAS_S>& S,
                                          T rho) {
  using R = Rn<T>;
  for (int off = 16; off > 0; off >>= 1)
    acc = R::add(acc, __shfl_xor_sync(FULL, acc, off));
  const T wsum = R::sub(R::add(S.obj, acc), S.q);
  T m2 = R::sub(R::mul(wsum, S.v), S.rv);
  if (HAS_S) m2 = R::add(m2, S.s);
  return R::div(R::div(-m2, rho), S.den);
}

// csum[c] += d for a round's 32 (id, delta) pairs held by the lanes, by
// lane 0 alone in lane order: a column whose ids may repeat takes its
// deltas in order of k, as index_add_ on the CPU does
template <typename T>
__device__ __forceinline__ void add_in_order(T* cs, int c, T d, int m,
                                             int lane) {
  using R = Rn<T>;
  for (int l = 0; l < 32; ++l) {
    const int cl = __shfl_sync(FULL, c, l);
    const T dl = __shfl_sync(FULL, d, l);
    if (lane == 0 && cl < m) cs[cl] = R::add(cs[cl], dl);
  }
  __syncwarp(FULL);
}

// A column of at most SR rounds (one piece), in registers.
template <typename T, bool HAS_S>
struct Col {
  int c[SR];
  T val[SR], rhs[SR], dual[SR];
  bool sorted;
  Scalars<T, HAS_S> S;
};

// Read a piece into registers as column C (its first nr rounds).
template <typename T, bool HAS_S>
__device__ __forceinline__ void read_col(Col<T, HAS_S>& C,
                                         const Piece<T, HAS_S>& P,
                                         int nr, int m, T rho, int lane) {
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    C.c[i] = i < nr ? P.con[32 * i + lane] : m;
    C.val[i] = P.val[32 * i + lane];
    C.rhs[i] = P.rhs[32 * i + lane];
    C.dual[i] = P.dual[32 * i + lane];
  }
  C.sorted = P.sorted != 0;
  C.S.load(P.scal, rho);
}

// Warp 0, columns of at most SR rounds (L <= PE): the chain.  Column
// j + 1 is read from the ring while column j is formed, before its piece
// is known to have arrived (it is read again if it had not); a column
// whose ids increase (so are distinct) updates csum from the values its
// sum read, with no second read; new_j is kept by lane j % 32 and the
// outputs are stored 32 at a time.
template <typename T, bool HAS_S>
__device__ void consume_short(Piece<T, HAS_S>* ring, uint64_t* full,
                              uint64_t* empty, T* cs, T* __restrict__ out,
                              int n, int m, int nr, T rho) {
  using R = Rn<T>;
  const int lane = threadIdx.x & 31;
  Col<T, HAS_S> cur;
  mbar_wait(&full[0], 0);
  read_col(cur, ring[0], nr, m, rho, lane);
  T mine = T(0);  // new_j of the column j with j % 32 == lane
  for (int j = 0; j < n; ++j) {
    T cv[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) cv[i] = cur.c[i] < m ? cs[cur.c[i]] : T(0);
    __syncwarp(FULL);  // every lane has read column j's piece
    if (lane == 0) mbar_arrive(&empty[slot_of(j)]);
    Col<T, HAS_S> nxt;
    const bool more = j + 1 < n;
    bool ready = true;
    if (more) {
      ready = mbar_test(&full[slot_of(j + 1)], parity_of(j + 1));
      read_col(nxt, ring[slot_of(j + 1)], nr, m, rho, lane);
    }
    T acc = T(0);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      if (i >= nr) break;
      T t = T(0);
      if (cur.c[i] < m)
        t = R::mul(cur.val[i],
                   R::sub(R::mul(rho, R::sub(cv[i], cur.rhs[i])),
                          cur.dual[i]));
      acc = R::add(acc, t);
    }
    const T nj = column_value(acc, cur.S, rho);
    if ((j & 31) == lane) mine = nj;
    if ((j & 31) == 31 || j == n - 1) {
      if ((j & ~31) + lane <= j) out[(j & ~31) + lane] = mine;
    }
    const T dn = R::sub(nj, cur.S.u);
    if (cur.sorted) {
#pragma unroll
      for (int i = 0; i < SR; ++i)
        if (cur.c[i] < m)
          cs[cur.c[i]] =
              R::add(cv[i], R::mul(R::mul(cur.val[i], dn), cur.S.v));
      __syncwarp(FULL);
    } else {
#pragma unroll
      for (int i = 0; i < SR; ++i)
        if (i < nr)
          add_in_order(cs, cur.c[i],
                       R::mul(R::mul(cur.val[i], dn), cur.S.v), m, lane);
    }
    if (more) {
      if (!ready) {
        mbar_wait(&full[slot_of(j + 1)], parity_of(j + 1));
        read_col(nxt, ring[slot_of(j + 1)], nr, m, rho, lane);
      }
      cur = nxt;
    }
  }
}

// Warp 0, longer columns (np pieces): round by round.  Each piece is
// released after the column's sum has read it, and the update reads the
// column's ids and values again from global memory.
template <typename T, bool HAS_S>
__device__ void consume_long(Piece<T, HAS_S>* ring, uint64_t* full,
                             uint64_t* empty, T* cs,
                             const int* __restrict__ pc_con,
                             const T* __restrict__ pc_val,
                             T* __restrict__ out, int n, int L, int m, int np,
                             T rho) {
  using R = Rn<T>;
  const int lane = threadIdx.x & 31;
  const int nr = (L + 31) / 32;
  for (int j = 0; j < n; ++j) {
    const unsigned q0 = (unsigned)j * np;
    Scalars<T, HAS_S> S;
    bool sorted = false;
    T acc = T(0);
    for (int i = 0; i < nr; ++i) {
      const unsigned q = q0 + i / SR;
      const Piece<T, HAS_S>& P = ring[slot_of(q)];
      const int e = 32 * (i % SR) + lane;
      if (i % SR == 0) {
        mbar_wait(&full[slot_of(q)], parity_of(q));
        if (i == 0) S.load(P.scal, rho);
        if (q == q0 + np - 1) sorted = P.sorted != 0;
      }
      const int c = P.con[e];
      T t = T(0);
      if (c < m)
        t = R::mul(P.val[e],
                   R::sub(R::mul(rho, R::sub(cs[c], P.rhs[e])), P.dual[e]));
      acc = R::add(acc, t);
      if (i % SR == SR - 1 || i == nr - 1) {
        __syncwarp(FULL);
        if (lane == 0) mbar_arrive(&empty[slot_of(q)]);
      }
    }
    const T nj = column_value(acc, S, rho);
    if (lane == 0) out[j] = nj;
    const T dn = R::sub(nj, S.u);
    for (int i = 0; i < nr; ++i) {
      const int k = 32 * i + lane;
      const int c = k < L ? pc_con[(long)j * L + k] : m;
      const T val = k < L ? pc_val[(long)j * L + k] : T(0);
      const T d = R::mul(R::mul(val, dn), S.v);
      if (sorted) {
        if (c < m) cs[c] = R::add(cs[c], d);
      } else {
        add_in_order(cs, c, d, m, lane);
      }
    }
    __syncwarp(FULL);
  }
}

template <typename T, bool SMEM_CSUM, bool HAS_S>
__global__ void __launch_bounds__(THREADS, 1)
    lp_gs_kernel(const int* __restrict__ pc_con, const T* __restrict__ pc_val,
                 const T* __restrict__ obj, const T* __restrict__ nrm2,
                 const T* __restrict__ upd, const T* __restrict__ fixed,
                 T* csum, const T* __restrict__ rhs,
                 const T* __restrict__ dual, const T* __restrict__ s,
                 T* __restrict__ out, int n, int L, int m,
                 const T* __restrict__ rho_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T rho = *rho_p;  // on the device: a graph replays it as it changes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + RING;
  auto* ring = reinterpret_cast<Piece<T, HAS_S>*>(empty + RING);
  T* cs = SMEM_CSUM ? reinterpret_cast<T*>(ring + RING) : csum;
  const int nr = L > 32 ? (L + 31) / 32 : 1;  // rounds per column
  const int np = (nr + SR - 1) / SR;          // pieces per column
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (SMEM_CSUM)
    for (int k = threadIdx.x; k < m; k += THREADS) cs[k] = csum[k];
  __syncthreads();
  if (threadIdx.x >= 32) {
    const int w = threadIdx.x / 32 - 1;  // producer w of PRODUCERS
    if (np == 1 || w == 0)
      produce(ring, full, empty, pc_con, pc_val, obj, nrm2, upd, fixed, rhs,
              dual, s, n, L, m, np, w, np == 1 ? PRODUCERS : 1);
  }
  else if (np == 1)
    consume_short(ring, full, empty, cs, out, n, m, nr, rho);
  else
    consume_long(ring, full, empty, cs, pc_con, pc_val, out, n, L, m, np,
                 rho);
  __syncthreads();
  if (SMEM_CSUM)
    for (int k = threadIdx.x; k < m; k += THREADS) csum[k] = cs[k];
}

template <typename T, bool HAS_S>
size_t smem_bytes(int m, bool smem_csum) {
  return 2 * RING * sizeof(uint64_t) + RING * sizeof(Piece<T, HAS_S>) +
         (smem_csum ? (size_t)m * sizeof(T) : 0);
}

// the largest m whose csum fits in shared memory beside the ring
template <typename T, bool HAS_S>
int smem_max_m() {
  return (int)((SMEM_MAX - smem_bytes<T, HAS_S>(0, false)) / sizeof(T));
}

template <typename T, bool SMEM_CSUM, bool HAS_S>
int launch_as(const void* pc_con, const void* pc_val, const void* obj,
              const void* nrm2, const void* upd, const void* fixed,
              void* csum, const void* rhs, const void* dual, const void* s,
              void* out, int n, int L, int m, const void* rho,
              cudaStream_t stream) {
  static bool raised = false;  // the dynamic shared memory limit, once
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        lp_gs_kernel<T, SMEM_CSUM, HAS_S>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  lp_gs_kernel<T, SMEM_CSUM, HAS_S>
      <<<1, THREADS, smem_bytes<T, HAS_S>(m, SMEM_CSUM), stream>>>(
          static_cast<const int*>(pc_con), static_cast<const T*>(pc_val),
          static_cast<const T*>(obj), static_cast<const T*>(nrm2),
          static_cast<const T*>(upd), static_cast<const T*>(fixed),
          static_cast<T*>(csum), static_cast<const T*>(rhs),
          static_cast<const T*>(dual), static_cast<const T*>(s),
          static_cast<T*>(out), n, L, m, static_cast<const T*>(rho));
  return (int)cudaGetLastError();
}

// csum in shared memory when m fits (smem_max_m), else in global memory
template <typename T, bool HAS_S>
int launch(const void* pc_con, const void* pc_val, const void* obj,
           const void* nrm2, const void* upd, const void* fixed, void* csum,
           const void* rhs, const void* dual, const void* s, void* out, int n,
           int L, int m, const void* rho, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  return m <= smem_max_m<T, HAS_S>()
             ? launch_as<T, true, HAS_S>(pc_con, pc_val, obj, nrm2, upd,
                                         fixed, csum, rhs, dual, s, out, n, L,
                                         m, rho, stream)
             : launch_as<T, false, HAS_S>(pc_con, pc_val, obj, nrm2, upd,
                                          fixed, csum, rhs, dual, s, out, n,
                                          L, m, rho, stream);
}

template <typename T>
int launch_s(const void* pc_con, const void* pc_val, const void* obj,
             const void* nrm2, const void* upd, const void* fixed,
             void* csum, const void* rhs, const void* dual, const void* s,
             void* out, int n, int L, int m, const void* rho,
             cudaStream_t stream) {
  return s ? launch<T, true>(pc_con, pc_val, obj, nrm2, upd, fixed, csum,
                             rhs, dual, s, out, n, L, m, rho, stream)
           : launch<T, false>(pc_con, pc_val, obj, nrm2, upd, fixed, csum,
                              rhs, dual, s, out, n, L, m, rho, stream);
}

}  // namespace

// pc_con int32 [n, L] (padding = m), pc_val [n, L], obj / nrm2 / upd /
// fixed [n], csum [m] updated in place, rhs / dual [m], s [n] or null (no
// DUAL_U_V term), out [n], rho [1] (on the device, the dtype of csum); all
// contiguous.  is_f64: 1 for float64, 0 for
// float32.  csum stays in shared memory during the sweep when
// m <= lt_lp_gs_smem_max_m(is_f64, s != null), else in global memory.
// Returns cudaGetLastError().
extern "C" int lt_lp_gs_sweep(int is_f64, const void* pc_con,
                              const void* pc_val, const void* obj,
                              const void* nrm2, const void* upd,
                              const void* fixed, void* csum,
                              const void* rhs, const void* dual,
                              const void* s, void* out, int n, int L, int m,
                              const void* rho, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch_s<double>(pc_con, pc_val, obj, nrm2, upd, fixed,
                                   csum, rhs, dual, s, out, n, L, m, rho, st)
                : launch_s<float>(pc_con, pc_val, obj, nrm2, upd, fixed, csum,
                                  rhs, dual, s, out, n, L, m, rho, st);
}

// The largest m whose csum lt_lp_gs_sweep keeps in shared memory, without
// s (has_s 0) and with it (has_s 1: a piece holds one more scalar).
extern "C" int lt_lp_gs_smem_max_m(int is_f64, int has_s) {
  if (has_s)
    return is_f64 ? smem_max_m<double, true>() : smem_max_m<float, true>();
  return is_f64 ? smem_max_m<double, false>() : smem_max_m<float, false>();
}

// K8c lp_gs_sweep: the Gauss-Seidel sweep over the LP columns.
//
// Replaces lorads_tpu/alg/admm.py:_update_lp_var_gs (a lax.scan over the
// columns; reference LORADSUpdateLPVarOne, lorads_admm.c:595-628, driven
// column by column by lorads_alg_common.c:229-247).  Column j, in order:
//
//   base  = sum_k val_k * (rho * (csum[con_k] - rhs[con_k]) - dual[con_k])
//   wsum  = (c_j + base) - ((rho * nrm2_j) * u_j) * v_j
//   m2    = (wsum * v_j) - rho * v_j
//   new_j = ((-m2) / rho) / (1 + (nrm2_j * v_j) * v_j)
//   csum[con_k] += (val_k * (new_j - u_j)) * v_j      for every entry k
//
// over the padded per-column layout pc_con / pc_val [n, L] (padding ids
// equal m and are skipped).  Column j reads the csum that columns
// 0..j-1 updated, so the sweep is sequential by construction: one warp
// walks the columns in order.  Per column the lanes read the column's
// entries (lane l takes k = l, l+32, ...), sum their terms in order, and
// combine the 32 partial sums by shuffles (offsets 16, 8, 4, 2, 1); lane 0
// forms new_j and broadcasts it; the lanes then add their entries' deltas
// into csum.  csum is read through L2 (__ldcg) and updated with atomics,
// so every lane sees the previous column's updates after __syncwarp, and
// a repeated constraint id within a column still sums correctly (ids are
// distinct in SDPA input, and then the result is deterministic).
// Every operation is an explicitly rounded intrinsic (__dmul_rn, ...): no
// FMA contraction, so the plain version (kernels.lp_gs_sweep_plain), which
// sums in the same lane order, agrees bit for bit.
//
// What bounds it: latency.  n dependent steps, each an L2 round trip for
// the gathered csum / rhs / dual values plus a shuffle reduction and the
// atomics; the bytes (the [n, L] layout once, five [n] vectors, three [m]
// vectors) are far below one step's latency times n.

#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void lp_gs_kernel(const int* __restrict__ pc_con,
                             const T* __restrict__ pc_val,
                             const T* __restrict__ obj,
                             const T* __restrict__ nrm2,
                             const T* __restrict__ upd,
                             const T* __restrict__ fixed, T* csum,
                             const T* __restrict__ rhs,
                             const T* __restrict__ dual,
                             T* __restrict__ out, int n, int L, int m,
                             T rho) {
  using R = Rn<T>;
  const int lane = threadIdx.x;
  const unsigned full = 0xffffffffu;
  for (int j = 0; j < n; ++j) {
    const int* cj = pc_con + (long)j * L;
    const T* vj = pc_val + (long)j * L;
    T acc = T(0);
    for (int k = lane; k < L; k += 32) {
      const int c = cj[k];
      T t = T(0);
      if (c < m)
        t = R::mul(vj[k], R::sub(R::mul(rho, R::sub(__ldcg(csum + c),
                                                     rhs[c])),
                                 dual[c]));
      acc = R::add(acc, t);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc = R::add(acc, __shfl_down_sync(full, acc, off));
    const T u = upd[j], v = fixed[j];
    T nj = T(0);
    if (lane == 0) {
      const T nr = nrm2[j];
      const T wsum = R::sub(R::add(obj[j], acc),
                            R::mul(R::mul(R::mul(rho, nr), u), v));
      const T m2 = R::sub(R::mul(wsum, v), R::mul(rho, v));
      nj = R::div(R::div(-m2, rho), R::add(T(1), R::mul(R::mul(nr, v), v)));
      out[j] = nj;
    }
    nj = __shfl_sync(full, nj, 0);
    const T dn = R::sub(nj, u);
    for (int k = lane; k < L; k += 32) {
      const int c = cj[k];
      if (c < m) atomicAdd(csum + c, R::mul(R::mul(vj[k], dn), v));
    }
    __threadfence_block();
    __syncwarp(full);
  }
}

template <typename T>
int launch(const void* pc_con, const void* pc_val, const void* obj,
           const void* nrm2, const void* upd, const void* fixed,
           void* csum, const void* rhs, const void* dual,
           void* out, int n, int L, int m, double rho, cudaStream_t stream) {
  if (n > 0)
    lp_gs_kernel<T><<<1, 32, 0, stream>>>(
        static_cast<const int*>(pc_con), static_cast<const T*>(pc_val),
        static_cast<const T*>(obj), static_cast<const T*>(nrm2),
        static_cast<const T*>(upd), static_cast<const T*>(fixed),
        static_cast<T*>(csum),
        static_cast<const T*>(rhs), static_cast<const T*>(dual),
        static_cast<T*>(out), n, L, m, (T)rho);
  return (int)cudaGetLastError();
}

}  // namespace

// pc_con int32 [n, L] (padding = m), pc_val [n, L], obj / nrm2 / upd /
// fixed [n], csum [m] updated in place, rhs /
// dual [m], out [n]; all contiguous.  is_f64: 1 for float64, 0 for
// float32.  Returns cudaGetLastError().
extern "C" int lt_lp_gs_sweep(int is_f64, const void* pc_con,
                              const void* pc_val, const void* obj,
                              const void* nrm2, const void* upd,
                              const void* fixed, void* csum,
                              const void* rhs, const void* dual, void* out,
                              int n, int L, int m, double rho,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_f64 ? launch<double>(pc_con, pc_val, obj, nrm2, upd, fixed,
                                 csum, rhs, dual, out, n, L, m, rho, st)
                : launch<float>(pc_con, pc_val, obj, nrm2, upd, fixed,
                                csum, rhs, dual, out, n, L, m, rho, st);
}

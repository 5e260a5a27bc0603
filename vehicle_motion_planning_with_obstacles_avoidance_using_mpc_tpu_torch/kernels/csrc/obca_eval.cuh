// OBCA objective and constraint evaluation for one lane, shared by the
// KKT provider kernel and the line-search kernel. The math is the JAX
// package's models/obca.py (variants free, fix_terminal, fix_free_end,
// fix_eq_band; coupled motion):
// every function reads the lane's packed data and its natural-unit
// variables from the block's arena (shared memory, or a device workspace
// where the line search's arrays outgrow it). The block terms and the
// objective are written once, one block or one objective item at a time
// (block_term, objective_item), for any group of threads; block_terms
// walks the blocks over the whole CTA.
#pragma once

#include "common.cuh"

#define VMP_PIN_RHO 1.0  // models/obca.py _PIN_RHO

template <typename T>
struct LaneView {
  Dims D;
  DataOff O;
  const T* d;  // packed data (shared)
  const T* z;  // natural-unit variables, flat order (shared)

  __device__ T x(int i, int t) const { return z[D.base_x + i * (D.N + 1) + t]; }
  __device__ T u(int i, int t) const { return z[D.base_u + i * D.N + t]; }
  __device__ T lam(int kb, int e) const { return z[D.off_u + kb * D.E + e]; }
  __device__ T mu(int kb, int j) const { return z[D.off_u + D.K * D.E + kb * 4 + j]; }
  __device__ T Tv() const { return z[0]; }
  __device__ T Ts() const { return d[O.Ts]; }
  __device__ T dt() const { return D.free ? z[0] * d[O.Ts] : d[O.Ts]; }
  __device__ T A(int k, int i, int e, int c) const { return d[O.A + ((k * D.nO + i) * D.E + e) * 2 + c]; }
  __device__ T bv(int k, int i, int e) const { return d[O.b + (k * D.nO + i) * D.E + e]; }
  __device__ T xref(int i, int t) const { return d[O.xref + i * (D.N + 1) + t]; }
  __device__ T obs_mask(int i) const { return d[O.obs_mask + i]; }
  __device__ T lam_mask(int i, int e) const { return d[O.edge_mask + i * D.E + e] * d[O.obs_mask + i]; }
  __device__ T Qm(int i, int j) const { return d[O.Q + 3 * i + j]; }
  __device__ T Pm(int i, int j) const { return d[O.P + 3 * i + j]; }
  __device__ T R1m(int i, int j) const { return d[O.R1 + 2 * i + j]; }
  __device__ T R2m(int i, int j) const { return d[O.R2 + 2 * i + j]; }
  // du_c(c, t) = u_t - u_{t-1} (u_{-1} = u0): the acceleration differences
  __device__ T du_c(int c, int t) const { return t == 0 ? u(c, 0) - d[O.u0 + c] : u(c, t) - u(c, t - 1); }
};

// Per-block terms, K entries each, in shared memory.
template <typename T>
struct BlockTerms {
  T *m, *ck, *sk, *q1x, *q1y, *tx, *ty, *blam;
  __device__ void take(SmemArena& a, int K) {
    m = a.take<T>(K); ck = a.take<T>(K); sk = a.take<T>(K); q1x = a.take<T>(K);
    q1y = a.take<T>(K); tx = a.take<T>(K); ty = a.take<T>(K); blam = a.take<T>(K);
  }
};

// Natural (unscaled) equality row r (models/obca.py eq_constraints).
template <typename T>
__device__ T eq_row(const LaneView<T>& L, const BlockTerms<T>& bt, int r) {
  const Dims& D = L.D;
  const int N = D.N;
  if (r < 3 * N) {
    const int f = r / N, t = r % N;
    const T dt = L.dt();
    if (f == 0) return L.x(0, t + 1) - L.x(0, t) - dt * L.u(0, t) * cos(L.x(2, t));
    if (f == 1) return L.x(1, t + 1) - L.x(1, t) - dt * L.u(0, t) * sin(L.x(2, t));
    return L.x(2, t + 1) - L.x(2, t) - dt * L.u(1, t);
  }
  if (r < 3 * N + 3) return L.x(r - 3 * N, 0) - L.d[L.O.x0 + r - 3 * N];
  if (r < D.mE_sp) return L.x(r - 3 * N - 3, N) - L.xref(r - 3 * N - 3, N);
  int kb = r - D.mE_sp;
  const bool second = kb >= D.K;
  if (second) kb -= D.K;
  const T m = bt.m[kb], c = bt.ck[kb], s = bt.sk[kb], qx = bt.q1x[kb], qy = bt.q1y[kb];
  if (!second) return (L.mu(kb, 0) - L.mu(kb, 2)) + m * (c * qx + s * qy);
  return (L.mu(kb, 1) - L.mu(kb, 3)) + m * (-s * qx + c * qy);
}

// Natural dense inequality row r (models/obca.py ineq_constraints_dense).
template <typename T>
__device__ T dineq_row(const LaneView<T>& L, const BlockTerms<T>& bt, int r) {
  const Dims& D = L.D;
  const int N = D.N;
  if (r < 4 * N) {
    const int f = r / N, t = r % N, c = f / 2;
    const T dt = L.dt();
    const T du = (t == 0) ? L.d[L.O.u0 + c] - L.u(c, 0) : L.u(c, t - 1) - L.u(c, t);
    const T lim = (c == 0) ? L.d[L.O.a_max] : L.d[L.O.alpha_max];
    return (f % 2 == 0) ? lim * dt - du : du + lim * dt;
  }
  if (r < D.mD_sp) {
    const int j = r - 4 * N;
    if (D.band) {  // fix_eq_band: |theta_N - thetaref_N| <= theta_band
      const T dth = L.x(2, N) - L.xref(2, N), tb = T(D.theta_band);
      return j == 0 ? tb - dth : dth + tb;
    }
    const T* ts = L.d + L.O.terminal_set;  // fix_terminal: terminal set, rows x/y, cols lo/hi
    if (j == 0) return L.x(0, N) - ts[0];
    if (j == 1) return L.x(1, N) - ts[2];
    return ts[3] - L.x(1, N);
  }
  int kb = r - D.mD_sp;
  const bool dist = kb >= D.K;
  if (dist) kb -= D.K;
  if (!(bt.m[kb] > T(0))) return T(1);
  const T qx = bt.q1x[kb], qy = bt.q1y[kb];
  if (!dist) return T(1) - (qx * qx + qy * qy);
  T gmu = 0;
  for (int j = 0; j < 4; ++j) gmu += L.mu(kb, j) * L.d[L.O.ego_g + j];
  return (-gmu + bt.tx[kb] * qx + bt.ty[kb] * qy - bt.blam[kb]) - L.d[L.O.dmin];
}

// ------------------------------------------------ block terms, objective
// One block or one objective item at a time: the caller walks the items
// over its threads (a CTA, a trial group, a thread a horizon step) and
// synchronizes them itself.

// Under coupled motion (S = 4) the offsets of block (k, i) move with the
// time scale T: b_e + A_e . (k Ts T vel_i) (models/obca_struct.py). The
// shift (dx, dy) of step k at sampling time Ts and time scale Tt, vel the
// obstacle's velocity (2).
template <typename T>
__device__ __forceinline__ void motion_shift(T k, T Ts, T Tt, const T* vel, T& dx, T& dy) {
  const T kT = k * Ts * Tt;
  dx = kT * vel[0];
  dy = kT * vel[1];
}

// q1 = A^T lam, b^T lam (b moved under coupled motion), the ego
// translation point and cos/sin of the heading of block kb. NS: the slots
// a block where the caller knows them at compile time, else 0 (D.S).
template <typename T, int NS = 0>
__device__ __forceinline__ void block_term(const LaneView<T>& L, BlockTerms<T> bt, int kb) {
  const Dims& D = L.D;
  const T off = L.d[L.O.ego_offset];
  const int k = D.k_lo + kb / D.nO, i = kb % D.nO;
  const T th = L.x(2, k);
  const T c = cos(th), s = sin(th);
  T qx = 0, qy = 0, bl = 0;
  if (NS ? NS == 4 : D.S == 4) {
    T dx, dy;
    motion_shift(T(k), L.Ts(), L.Tv(), L.d + L.O.obs_vel + 2 * i, dx, dy);
    for (int e = 0; e < D.E; ++e) {
      const T l = L.lam(kb, e), a0 = L.A(k, i, e, 0), a1 = L.A(k, i, e, 1);
      qx += a0 * l;
      qy += a1 * l;
      bl += (L.bv(k, i, e) + (a0 * dx + a1 * dy)) * l;
    }
  } else {
    for (int e = 0; e < D.E; ++e) {
      const T l = L.lam(kb, e);
      qx += L.A(k, i, e, 0) * l;
      qy += L.A(k, i, e, 1) * l;
      bl += L.bv(k, i, e) * l;
    }
  }
  bt.m[kb] = L.obs_mask(i);
  bt.ck[kb] = c;
  bt.sk[kb] = s;
  bt.q1x[kb] = qx;
  bt.q1y[kb] = qy;
  bt.tx[kb] = L.x(0, k) + c * off;
  bt.ty[kb] = L.x(1, k) + s * off;
  bt.blam[kb] = bl;
}

// Number of items of the objective sum: N stage costs, the terminal cost,
// one pin / proximal term per dual variable.
__host__ __device__ inline int objective_items(const Dims& D) { return D.N + 1 + D.K * D.bq; }

// Item idx of the objective sum; dt is L.dt().
template <typename T>
__device__ __forceinline__ T objective_item(const LaneView<T>& L, int idx, T dt, T dual_reg) {
  const Dims& D = L.D;
  const int N = D.N;
  if (idx < N) {
    const int t = idx;
    T dx[3];
    for (int i = 0; i < 3; ++i) dx[i] = L.x(i, t) - L.xref(i, t);
    T cx = 0, cu = 0, ca = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) cx += dx[i] * L.Qm(i, j) * dx[j];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) {
        cu += L.u(i, t) * L.R1m(i, j) * L.u(j, t);
        ca += L.du_c(i, t) * L.R2m(i, j) * L.du_c(j, t);
      }
    return cx + cu + ca / (dt * dt);
  }
  if (idx == N) {
    T dN[3];
    for (int i = 0; i < 3; ++i) dN[i] = L.x(i, N) - L.xref(i, N);
    T ct = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) ct += dN[i] * L.Pm(i, j) * dN[j];
    if (D.free) {
      const T Tt = L.Tv();
      ct += T(N + 1) * (L.d[L.O.time_c1] * Tt + L.d[L.O.time_c2] * Tt * Tt);
    }
    return ct;
  }
  int j = idx - N - 1;
  T lm, v;
  if (j < D.K * D.E) {
    const int kb = j / D.E, e = j % D.E;
    lm = L.lam_mask(kb % D.nO, e);
    v = L.lam(kb, e);
  } else {
    j -= D.K * D.E;
    const int kb = j / 4;
    lm = L.obs_mask(kb % D.nO);
    v = L.mu(kb, j % 4);
  }
  const T a = (T(1) - lm) * v, b = lm * v;
  return T(0.5 * VMP_PIN_RHO) * a * a + T(0.5) * dual_reg * b * b;
}

// block_term of every block over the CTA. Ends with __syncthreads().
template <typename T>
__device__ void block_terms(const LaneView<T>& L, BlockTerms<T> bt) {
  for (int kb = threadIdx.x; kb < L.D.K; kb += blockDim.x) block_term(L, bt, kb);
  __syncthreads();
}

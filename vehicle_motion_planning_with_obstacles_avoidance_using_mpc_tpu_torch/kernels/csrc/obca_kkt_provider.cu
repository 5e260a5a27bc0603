// obca_kkt_provider: every KKTBundle field of the OBCA NLP at one iterate.
//
// Replaces: the JAX package's models/obca_struct.py make_provider.provider
// (:292-605), the analytic KKT provider of the fused Newton body.
// Bound on this card: memory traffic. Per lane it reads a few KB of
// problem data and the iterate and writes the bundle: the dense spine
// blocks JE_sp (mE_sp, np), JD_sp (mD_sp, np) and Hpp (np, np) and the K
// blocks' pieces, ~25 KB a lane at the fix step (N = 6, float32), ~1.5 MB
// at N = 74. The spine blocks are >99% structural zeros at long horizons
// (N = 74: ~4k nonzeros of 336k entries), and their pattern depends on the
// problem's shape alone.
// Design: the JAX provider's own structure, carried to the card. The
// pattern is decided once on the host (models/obca_struct.py
// spine_row_plan, from the JE_MAP / JD_MAP / HPP_MAP of spine_maps) and
// uploaded as a row plan: each stacked row's nonzero columns and the index
// of each nonzero's value in a lane's compact value vector. Two launches
// (prov_launch picks their shapes):
//  1. values: a CTA a lane. A thread a horizon step computes the step's
//     spine values, in the maps' registration order, and its gradient
//     entries; a thread a block (from the next warp) the block's terms,
//     row scales and curvature; every thread takes a share of the
//     objective, summed by warp shuffles. After one barrier the lane's
//     scalars, residuals and the gradient's dual entries. The compact
//     values and the block terms go to a per-lane workspace. Where this
//     launch fills the card (many lanes) the CTA also writes its blocks'
//     pieces from its shared memory.
//  2. dense: a grid over (lane, tile). A spine tile is a few stacked rows
//     of JE_sp / JD_sp / Hpp: the CTA zeroes them in shared memory,
//     scatters the plan's nonzeros (value x row scale x column scale, as
//     the parent kernel multiplied them) and stores 16 bytes a thread; no
//     integer decode or trigonometry per element. For few lanes, block
//     tiles write the pieces of PD_BLOCKS blocks each from their staged
//     terms. Hundreds of CTAs at N = 74 where one CTA a lane gave 5.
// Every element's arithmetic is the parent kernel's expression, with its
// products rounded where the parent rounded them (mul_rn), so every output
// but f is bit-equal to the parent kernel's; the objective's sum is taken
// in another order.
// Every variant: free, fix_terminal, fix_free_end and fix_eq_band (its
// terminal rows from the layout's counts, common.cuh dims_from), and free
// time with coupled motion: S = 4 slots a block (x, y, theta, T), the
// blocks' offsets moved with T (obca_eval.cuh block_term), each distance
// row's T slot in JDb_p and Hpq_c's T row; the kernels are instantiated
// for S = 3 and S = 4.
#include "obca_eval.cuh"

// The launch plan's constants (prov_launch; kernels.provider_launch_plan
// reads the plan through obca_kkt_provider_plan_info).
#define PV_MIN_THREADS 96      // threads a CTA, values launch, at least
#define PV_MAX_THREADS 512     // ... at most (a thread a step and a block up to here)
#define PV_FILL_WARPS 1056     // values warps (8 an SM) that fill the card: below, a lane's
                               // CTA is doubled; from here, it writes its blocks' pieces
#define PV_PARTS 64            // shared partial sums: objective and acceleration cost, a warp each
#define PD_THREADS 128         // threads a CTA, dense launch
#define PD_TILE_ELEMS 4096     // entries a spine tile, at most (rows of np)
#define PD_MIN_TILE_ELEMS 1024 // a tile is halved to fill the card only while it keeps this many
#define PD_FILL_CTAS 264       // spine CTAs (2 x 132 SMs) below which tiles are halved
#define PD_BLOCKS 8            // blocks a block tile

// A product rounded on its own, never fused into the add that follows, as
// the parent kernel rounded y3 * Ts (staged in shared memory) and sf * Q2
// (added to only where it met a theta-theta entry): an FMA would round
// Hpp's (T, u1) and (theta, theta) entries differently.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
struct ProvOut {
  T *f, *g, *cE, *cD, *JE_sp, *JEb_th, *JEb_q, *JD_sp, *JDb_p, *JDb_q, *Hpp, *Hpq_c, *Hqq;
};

template <typename T>
struct ProvIn {
  const T *zv, *data, *sf, *scE, *scD, *y, *wd, *ds;
};

// Offsets of a lane's compact values: JE_sp's, JD_sp's and Hpp's upper
// triangle's nonzeros, each block in models/obca_struct.py spine_maps'
// registration order.
struct ValOff {
  int je_T, je_init;                  // JE: 11 dynamics groups of N, [3 T-column groups], init + term
  int jd_fam;                         // JD: per acceleration family (a, alpha) ...
  int jd_term;                        // ... then the terminal-set or heading-band rows
  int hp_u, hp_band, hp_uth, hp_x;    // Hpp: [T row], u-u diagonals, bands, u-theta, x-x
  int jd, hp, total;                  // block offsets in the lane's vector, its length
};

__host__ __device__ inline ValOff val_off(const Dims& D) {
  const int N = D.N;
  ValOff v;
  v.je_T = 11 * N;
  v.je_init = D.free ? 14 * N : 11 * N;
  const int n_je = v.je_init + (D.mE_sp - 3 * N);
  v.jd_fam = 4 * N - 2 + (D.free ? 2 * N : 0);
  v.jd_term = 2 * v.jd_fam;
  const int n_jd = v.jd_term + (D.mD_sp - 4 * N);
  v.hp_u = D.free ? 1 + 3 * N : 0;
  v.hp_band = v.hp_u + 3 * N;
  v.hp_uth = v.hp_band + 4 * (N - 1);
  v.hp_x = v.hp_uth + N;
  const int n_hp = v.hp_x + 6 * (N + 1);
  v.jd = n_je;
  v.hp = n_je + n_jd;
  v.total = v.hp + n_hp;
  return v;
}

// A block's row scales, scaled multipliers and (theta_k, theta_k)
// curvature, K each.
template <typename T>
struct BlockScal {
  T *sE0, *sE1, *sD0, *sD1, *wn, *wdd, *yg0, *yg1, *hb;
  __device__ void take(SmemArena& a, int K) {
    sE0 = a.take<T>(K); sE1 = a.take<T>(K); sD0 = a.take<T>(K); sD1 = a.take<T>(K);
    wn = a.take<T>(K); wdd = a.take<T>(K); yg0 = a.take<T>(K); yg1 = a.take<T>(K);
    hb = a.take<T>(K);
  }
};

// A lane's workspace (the arena of its slice): the compact values, then
// the block terms and scalars, 17 arrays of K in the order of BlockTerms
// and BlockScal (WB_* below), each padded to 8 bytes.
enum { WB_M, WB_CK, WB_SK, WB_QX, WB_QY, WB_TX, WB_TY, WB_BLAM,
       WB_SE0, WB_SE1, WB_SD0, WB_SD1, WB_WN, WB_WDD, WB_YG0, WB_YG1, WB_HB };

template <typename T>
struct LaneWork {
  T* vals;
  BlockTerms<T> bt;
  BlockScal<T> bs;
  int ks;   // elements between two of the 17 arrays (K, padded to 8 bytes)
  __device__ LaneWork(T* base, const Dims& D, int n_values) {
    SmemArena ar(base);
    vals = ar.take<T>(n_values);
    bt.take(ar, D.K);
    bs.take(ar, D.K);
    ks = int(bs.sE0 - bt.m) / 8;
  }
};

// Items of a block's staged data (stage_block_item): the S slots' column
// scales, A (E x 2), b (E), the masks (E + 1), under coupled motion the
// obstacle's velocity (2).
__host__ __device__ inline int block_items(const Dims& D) {
  return D.S + 4 * D.E + 1 + (D.S == 4 ? 2 : 0);
}

// Elements of BlockData's per-block arrays for `stride` blocks, ego_g's 4
// among them.
__host__ __device__ inline int block_data_elems(const Dims& D, int stride) {
  return stride * block_items(D) + 4;
}

// ------------------------------------------------------------ the plan
struct ProvLaunch {
  int values_threads;   // threads a CTA, values launch (a CTA a lane)
  size_t values_smem;   // its shared bytes
  int rows_per_tile;    // stacked spine rows (JE_sp, JD_sp, Hpp) a spine tile
  int spine_ctas;       // spine tiles a lane
  int block_ctas;       // block tiles a lane
  size_t dense_smem;    // shared bytes a dense CTA
  int n_values;         // compact values a lane
  size_t work_elems;    // workspace elements a lane: the values, 17 arrays of K
  int lane;             // 1: one launch, the values CTA writes the whole bundle
};

__host__ __device__ inline size_t pv_r8(size_t count, size_t elem) { return (count * elem + 7) / 8 * 8; }
inline int pv_cdiv(int a, int b) { return (a + b - 1) / b; }

// The launch plan (kernels.provider_launch_plan). Values: a CTA a lane of a
// thread for each of the N + 1 steps, then from the next warp one for each
// of the K blocks, within [PV_MIN_THREADS, PV_MAX_THREADS]; in shared
// memory the lane's packed data, its variables, the steps' curvature, the
// partial sums and the 17 arrays of block terms. Where B x its warps
// reaches PV_FILL_WARPS (the launch fills the card) and a lane's stacked
// spine rows fit one tile of PD_TILE_ELEMS, it is the only launch (lane):
// the CTA also writes its blocks' pieces and its spine rows, staging the
// rows (first) and the blocks' data in shared memory too. Else the CTA is
// doubled (up to PV_MAX_THREADS) while B x its warps is below
// PV_FILL_WARPS, and the dense launch follows: spine tiles of PD_TILE_ELEMS
// / np of the mE_sp + mD_sp + np stacked rows (at least 1, at most all),
// halved while B x tiles stays below PD_FILL_CTAS and a half tile keeps
// PD_MIN_TILE_ELEMS entries, then ceil(K / PD_BLOCKS) block tiles, each
// staging its blocks' terms and data; a dense CTA's shared memory is the
// larger of the two. A stage of spine rows has two 16-byte vectors to
// spare for each of the three blocks it may touch.
// Threads of the values CTA before it is doubled for few lanes: a thread a
// step, then one a block from the next warp, within [PV_MIN_THREADS,
// PV_MAX_THREADS]. Also the width over which the objective is summed.
__host__ __device__ inline int pv_min_threads(const Dims& D) {
  const int t = 32 * ((D.N + 1 + 31) / 32) + 32 * ((D.K + 31) / 32);
  return t < PV_MIN_THREADS ? PV_MIN_THREADS : (t > PV_MAX_THREADS ? PV_MAX_THREADS : t);
}

inline ProvLaunch prov_launch(const Dims& D, const DataOff& O, long long B, size_t e) {
  ProvLaunch p;
  int t = pv_min_threads(D);
  const int np = D.np_, rows = D.mE_sp + D.mD_sp + np;
  // one launch where it fills the card and a lane's spine rows are one tile
  p.lane = B * (t / 32) >= PV_FILL_WARPS && rows * np <= PD_TILE_ELEMS;
  while (2 * t <= PV_MAX_THREADS && B * (t / 32) < PV_FILL_WARPS) t *= 2;   // few lanes
  p.values_threads = t;
  const size_t V = 16 / e;   // elements a 16-byte vector; a segment's alignment costs 2 at most
  auto stage = [&](int r) { return ((size_t(r) * np + V - 1) / V + 6) * 16; };   // spine rows
  p.values_smem = (p.lane ? stage(rows) + pv_r8(block_data_elems(D, D.K), e) : 0) +
                  pv_r8(O.total, e) + pv_r8(D.n, e) + pv_r8(D.N + 1, e) + pv_r8(PV_PARTS, e) +
                  17 * pv_r8(D.K, e);
  int rt = PD_TILE_ELEMS / np > 1 ? PD_TILE_ELEMS / np : 1;
  if (rt > rows || p.lane) rt = rows;
  while (!p.lane && rt > 1 && B * pv_cdiv(rows, rt) < PD_FILL_CTAS && (rt / 2) * np >= PD_MIN_TILE_ELEMS)
    rt /= 2;
  p.rows_per_tile = rt;
  p.spine_ctas = p.lane ? 0 : pv_cdiv(rows, rt);
  p.block_ctas = p.lane ? 0 : pv_cdiv(D.K, PD_BLOCKS);
  const size_t blocks = p.block_ctas ? (16 * PD_BLOCKS + block_data_elems(D, PD_BLOCKS)) * e : 0;
  p.dense_smem = p.lane ? 0 : (stage(rt) > blocks ? stage(rt) : blocks);
  p.n_values = val_off(D).total;
  p.work_elems = (pv_r8(p.n_values, e) + 17 * pv_r8(D.K, e)) / e;
  return p;
}

// --------------------------------------------------------- spine rows
template <typename T>
struct Vec16;
template <>
struct Vec16<float> { using type = float4; };
template <>
struct Vec16<double> { using type = double2; };

// Spine tile: stacked spine rows [g0, g0 + rows_per_tile) of lane b, a
// segment of each of JE_sp, JD_sp and Hpp it meets: zeros, then the plan's
// nonzeros, staged in shared memory at each segment's own alignment and
// stored 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void spine_tile(const ProvIn<T>& in, const ProvOut<T>& o,
                                           const T* vl, const int* plan, int nnz, const Dims& D,
                                           int rows_per_tile, int b, int tile,
                                           unsigned char* smem) {
  using VT = typename Vec16<T>::type;
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x, np = D.np_;
  const int first[4] = {0, D.mE_sp, D.mE_sp + D.mD_sp, D.mE_sp + D.mD_sp + np};
  const int g0 = tile * rows_per_tile;
  const int g1 = g0 + rows_per_tile < first[3] ? g0 + rows_per_tile : first[3];
  T* out[3] = {o.JE_sp, o.JD_sp, o.Hpp};
  size_t start[3];   // a segment's first entry in its block
  int base[3], count[3];   // its place in shared memory (a multiple of V, plus start % V), entries
  int at = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = g0 > first[k] ? g0 : first[k], z = g1 < first[k + 1] ? g1 : first[k + 1];
    count[k] = z > a ? (z - a) * np : 0;
    start[k] = (size_t(b) * (first[k + 1] - first[k]) + (a - first[k])) * np;
    base[k] = at + int(start[k] % V);
    if (count[k] > 0) at += (int(start[k] % V) + count[k] + V - 1) / V * V;
  }
  T* s = reinterpret_cast<T*>(smem);
  VT* sv = reinterpret_cast<VT*>(smem);
  for (int k = tid; k < at / V; k += nt) sv[k] = VT{};
  __syncthreads();
  const int* nz_row = plan + (first[3] + 1);
  const int* nz_col = nz_row + nnz;
  const int* nz_val = nz_col + nnz;
  for (int k = plan[g0] + tid; k < plan[g1]; k += nt) {
    const int gr = nz_row[k], c = nz_col[k];
    const int blk = gr < first[1] ? 0 : (gr < first[2] ? 1 : 2);
    const int f0 = blk == 0 ? first[0] : (blk == 1 ? first[1] : first[2]), r = gr - f0;
    const T rf = blk == 0 ? in.scE[size_t(b) * D.mE + r]
                          : (blk == 1 ? in.scD[size_t(b) * D.mD + r] : in.ds[p_flat(D, r)]);
    const int at0 = blk == 0 ? base[0] : (blk == 1 ? base[1] : base[2]);
    s[at0 + (gr - (g0 > f0 ? g0 : f0)) * np + c] = vl[nz_val[k]] * rf * in.ds[p_flat(D, c)];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (count[k] == 0) continue;
    const int sh = int(start[k] % V);
    const T* sk = s + base[k];
    T* gout = out[k] + start[k];
    const int head = (V - sh) % V < count[k] ? (V - sh) % V : count[k];
    for (int i = tid; i < head; i += nt) gout[i] = sk[i];
    const int nvec = (count[k] - head) / V;
    VT* gv = reinterpret_cast<VT*>(gout + head);
    const VT* svv = reinterpret_cast<const VT*>(sk + head);
    for (int j = tid; j < nvec; j += nt) gv[j] = svv[j];
    for (int i = head + nvec * V + tid; i < count[k]; i += nt) gout[i] = sk[i];
  }
}

// ------------------------------------------------------- block pieces
// The entries (l, i, j) of nk blocks of n1 x n2 entries, walked by a thread
// from index `start` in steps of `step` without a division after the first.
struct EntryWalk {
  int l, i, j, dl, di, dj, n1, n2;
  __device__ EntryWalk(int start, int step, int n1_, int n2_) : n1(n1_), n2(n2_) {
    l = start / (n1 * n2); i = (start / n2) % n1; j = start % n2;
    dl = step / (n1 * n2); di = (step / n2) % n1; dj = step % n2;
  }
  __device__ void next() {
    l += dl; i += di; j += dj;
    if (j >= n2) { j -= n2; ++i; }
    if (i >= n1) { i -= n1; ++l; }
  }
};

// What a block's pieces read, for local blocks l = 0 .. nk-1: the 16 term
// and scalar arrays (WB_*) at a stride, then, at `stride` a block, the
// slots' column scales (S), A (E x 2), b (E; moved with T under coupled
// motion), the masks (E + 1), ego_g and, under coupled motion, the
// obstacles' velocities (2).
template <typename T>
struct BlockData {
  T *term, *ds, *A, *bv, *mask, *ego, *vel;
  int ks, stride, E;
  __device__ T t(int j, int l) const { return term[j * ks + l]; }
  __device__ T dsl(int s, int l) const { return ds[s * stride + l]; }
  __device__ T a(int l, int e, int c) const { return A[(l * E + e) * 2 + c]; }
  __device__ T bb(int l, int e) const { return bv[l * E + e]; }
  __device__ T lm(int l, int e) const { return mask[l * E + e]; }
  __device__ T om(int l) const { return mask[E * stride + l]; }
  __device__ T v(int l, int c) const { return vel[l * 2 + c]; }
};

// BlockData over `base` (the per-block arrays, block_data_elems) and the
// term arrays `term` of stride ks, S slots a block.
template <typename T>
__device__ __forceinline__ BlockData<T> block_data(T* term, int ks, T* base, int stride, int E,
                                                   int S) {
  BlockData<T> d;
  d.term = term;
  d.ks = ks;
  d.stride = stride;
  d.E = E;
  d.ds = base;
  d.A = d.ds + S * stride;
  d.bv = d.A + 2 * E * stride;
  d.mask = d.bv + E * stride;
  d.ego = d.mask + (E + 1) * stride;
  d.vel = d.ego + 4;
  return d;
}

// Item j (0 <= j < block_items) of block kb's per-block data into local
// block l, S slots a block; Tt is the lane's time scale (natural units),
// read under coupled motion alone.
template <typename T, int S>
__device__ __forceinline__ void stage_block_item(const Dims& D, const DataOff& O, const T* dl,
                                                 const T* ds, const BlockData<T>& d, int l,
                                                 int kb, int j, T Tt) {
  const int E = D.E, nO = D.nO, k = D.k_lo + kb / nO, i = kb % nO;
  if (j < S) d.ds[j * d.stride + l] = ds[p_flat(D, slot_pos(D, j, kb))];
  else if ((j -= S) < 2 * E) d.A[l * 2 * E + j] = dl[O.A + (k * nO + i) * E * 2 + j];
  else if (j < 3 * E) {
    const int e = j - 2 * E;
    T b = dl[O.b + (k * nO + i) * E + e];
    if (S == 4) {   // the offset moved with T, as block_term moves it
      T dx, dy;
      motion_shift(T(k), dl[O.Ts], Tt, dl + O.obs_vel + 2 * i, dx, dy);
      const T* A = dl + O.A + (k * nO + i) * E * 2 + 2 * e;
      b = b + (A[0] * dx + A[1] * dy);
    }
    d.bv[l * E + e] = b;
  }
  else if (j < 4 * E) d.mask[l * E + j - 3 * E] = dl[O.edge_mask + i * E + j - 3 * E] * dl[O.obs_mask + i];
  else if (S == 3 || j == 4 * E) d.mask[E * d.stride + l] = dl[O.obs_mask + i];
  else d.vel[l * 2 + j - 4 * E - 1] = dl[O.obs_vel + 2 * i + j - 4 * E - 1];
}

// The pieces of blocks kb0 .. kb0 + nk - 1 of lane b (JEb_th, JDb_p, JEb_q,
// JDb_q, Hpq_c, Hqq) from their BlockData: every thread walks entries of
// all of them (EntryWalk), and only stores leave the CTA. NS slots a block;
// under coupled motion (NS = 4) the distance row's T slot of JDb_p,
// -m Ts k (q1 . vel), and Hpq_c's T row, wdd m Ts k (A_e . vel) (Ts the
// lane's sampling time).
template <typename T, int NS>
__device__ __forceinline__ void block_pieces(const ProvOut<T>& o, const BlockData<T>& S,
                                             const Dims& D, int b, int kb0, int nk, T sf, T off,
                                             T Ts, T dual_reg) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = D.K, E = D.E, bq = D.bq;
  const size_t bK = size_t(b) * K + kb0;
  constexpr int NP = 2 + 2 * NS;   // JEb_th (2) and JDb_p (2 x NS)
  for (int q = tid; q < nk * NP; q += nt) {
    const int l = unsigned(q) / NP, e = unsigned(q) % NP;   // NS = 3: q >> 3, q & 7
    const T m = S.t(WB_M, l), ck = S.t(WB_CK, l), sk = S.t(WB_SK, l), qx = S.t(WB_QX, l),
            qy = S.t(WB_QY, l);
    const int s = e < 2 ? 2 : (e - 2) % NS;
    const T dss = S.dsl(s, l);
    const size_t blk = bK + l;
    if (e == 0) o.JEb_th[blk * 2] = S.t(WB_SE0, l) * (m * (-sk * qx + ck * qy)) * dss;
    else if (e == 1) o.JEb_th[blk * 2 + 1] = S.t(WB_SE1, l) * (-m * (ck * qx + sk * qy)) * dss;
    else if (e < 2 + NS) o.JDb_p[blk * 2 * NS + s] = T(0);
    else if (s == 0) o.JDb_p[blk * 2 * NS + NS] = S.t(WB_SD1, l) * (m * qx) * dss;
    else if (s == 1) o.JDb_p[blk * 2 * NS + NS + 1] = S.t(WB_SD1, l) * (m * qy) * dss;
    else if (NS == 3 || s == 2) o.JDb_p[blk * 2 * NS + NS + 2] = S.t(WB_SD1, l) * (m * off * (-sk * qx + ck * qy)) * dss;
    else {
      const T k = T(D.k_lo + (kb0 + l) / D.nO);
      o.JDb_p[blk * 2 * NS + NS + 3] =
          S.t(WB_SD1, l) * (-m * Ts * k * (qx * S.v(l, 0) + qy * S.v(l, 1))) * dss;
    }
  }
  for (EntryWalk w(tid, nt, 2, bq); w.l < nk; w.next()) {   // JEb_q and JDb_q (2 x bq)
    const int l = w.l, r = w.i, e = w.j;
    const T m = S.t(WB_M, l);
    T je, jd;
    if (e < E) {
      const T a0 = S.a(l, e, 0), a1 = S.a(l, e, 1);
      const T ck = S.t(WB_CK, l), sk = S.t(WB_SK, l);
      je = r == 0 ? S.t(WB_SE0, l) * (m * (ck * a0 + sk * a1)) : S.t(WB_SE1, l) * (m * (-sk * a0 + ck * a1));
      jd = r == 0 ? S.t(WB_SD0, l) * (T(-2) * m * (S.t(WB_QX, l) * a0 + S.t(WB_QY, l) * a1))
                  : S.t(WB_SD1, l) * (m * (S.t(WB_TX, l) * a0 + S.t(WB_TY, l) * a1 - S.bb(l, e)));
    } else {
      const int j = e - E;
      je = r == 0 ? S.t(WB_SE0, l) * T(j == 0 ? 1 : (j == 2 ? -1 : 0))
                  : S.t(WB_SE1, l) * T(j == 1 ? 1 : (j == 3 ? -1 : 0));
      jd = r == 0 ? T(0) : S.t(WB_SD1, l) * (-m * S.ego[j]);
    }
    const size_t q = ((bK + l) * 2 + r) * bq + e;
    o.JEb_q[q] = je;
    o.JDb_q[q] = jd;
  }
  for (EntryWalk w(tid, nt, NS, bq); w.l < nk; w.next()) {   // Hpq_c (NS x bq): x, y, theta[, T] vs lam
    const int l = w.l, s = w.i, e = w.j;
    T v = 0;
    if (e < E) {
      const T m = S.t(WB_M, l), ck = S.t(WB_CK, l), sk = S.t(WB_SK, l), wdd = S.t(WB_WDD, l);
      const T a0 = S.a(l, e, 0), a1 = S.a(l, e, 1);
      if (s == 0) {
        v = -wdd * m * a0;
      } else if (s == 1) {
        v = -wdd * m * a1;
      } else if (NS == 3 || s == 2) {
        const T dl1 = m * (-sk * a0 + ck * a1), dl2 = m * (-ck * a0 - sk * a1);
        v = -(S.t(WB_YG0, l) * dl1 + S.t(WB_YG1, l) * dl2 + wdd * off * dl1);
      } else {
        const T k = T(D.k_lo + (kb0 + l) / D.nO);
        v = wdd * m * Ts * k * (a0 * S.v(l, 0) + a1 * S.v(l, 1));
      }
      v *= S.dsl(s, l);
    }
    o.Hpq_c[((bK + l) * NS + s) * bq + e] = v;
  }
  for (EntryWalk w(tid, nt, bq, bq); w.l < nk; w.next()) {   // Hqq (bq x bq)
    const int l = w.l, a = w.i, c = w.j;
    T v = 0;
    if (a < E && c < E) {
      const T aa = S.a(l, a, 0) * S.a(l, c, 0) + S.a(l, a, 1) * S.a(l, c, 1);
      v = T(2) * S.t(WB_WN, l) * S.t(WB_M, l) * aa;
      if (a == c) {
        const T lm = S.lm(l, a);
        v += sf * (T(VMP_PIN_RHO) * (T(1) - lm) * (T(1) - lm) + dual_reg * lm * lm);
      }
    } else if (a >= E && a == c) {
      const T om = S.om(l);
      v = sf * (T(VMP_PIN_RHO) * (T(1) - om) * (T(1) - om) + dual_reg * om * om);
    }
    o.Hqq[((bK + l) * bq + a) * bq + c] = v;
  }
}

// ------------------------------------------------------ launch 1: values
template <typename T>
struct ProvLane {   // one lane's view of the inputs
  const T *scE, *scD, *y, *wd, *ds;
  T sf, dt, dt2, Ts, Tt, off;
};

// Step t's work (0 <= t <= N): the spine values of step t but the (theta,
// theta) curvature, whose dynamics part goes to thth_dyn[t], and the
// gradient entries of u(., t) and x(., t). Returns the step's
// acceleration-cost term.
template <typename T>
__device__ __forceinline__ T step_values(const LaneView<T>& L, const ProvLane<T>& l,
                                         const ValOff& V, int t, T* vl, T* g, T* thth_dyn) {
  const Dims& D = L.D;
  const int N = D.N;
  const T dt = l.dt, dt2 = l.dt2, Ts = l.Ts, sf = l.sf;
  auto R12 = [&](int i, int j) { return L.R1m(i, j) + L.R1m(j, i); };
  auto R22 = [&](int i, int j) { return L.R2m(i, j) + L.R2m(j, i); };
  auto Q2 = [&](int i, int j) { return L.Qm(i, j) + L.Qm(j, i); };
  auto P2 = [&](int i, int j) { return L.Pm(i, j) + L.Pm(j, i); };
  T ca = 0, thth = 0;
  if (t < N) {
    const T* scE = l.scE;
    const T* y = l.y;
    const T y1 = scE[t] * y[t], y2 = scE[N + t] * y[N + t], y3 = scE[2 * N + t] * y[2 * N + t];
    const T v = L.u(0, t), th = L.x(2, t);
    const T c = cos(th), s = sin(th);
    thth = -(y1 * dt * v * c + y2 * dt * v * s);
    const T hthv = -(y1 * dt * s - y2 * dt * c);
    T gacc[2];
    for (int cc = 0; cc < 2; ++cc) {
      T a0 = 0, a1 = 0;
      for (int j = 0; j < 2; ++j) {
        a0 += R22(cc, j) * L.du_c(j, t);
        if (t + 1 < N) a1 += R22(cc, j) * L.du_c(j, t + 1);
      }
      gacc[cc] = a0 / dt2 - (t + 1 < N ? a1 / dt2 : T(0));
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) ca += L.du_c(i, t) * R22(i, j) * L.du_c(j, t);
    for (int cc = 0; cc < 2; ++cc) {
      const int j = D.base_u + cc * N + t;
      const T gn = R12(cc, 0) * L.u(0, t) + R12(cc, 1) * L.u(1, t) + gacc[cc];
      g[j] = sf * gn * l.ds[j];
    }
    // JE_sp: rows t (x), N + t (y), 2N + t (theta) of the dynamics
    T* je = vl;
    je[t] = T(1);
    je[N + t] = T(-1);
    je[2 * N + t] = dt * v * s;
    je[3 * N + t] = -dt * c;
    je[4 * N + t] = T(1);
    je[5 * N + t] = T(-1);
    je[6 * N + t] = -dt * v * c;
    je[7 * N + t] = -dt * s;
    je[8 * N + t] = T(1);
    je[9 * N + t] = T(-1);
    je[10 * N + t] = -dt;
    if (D.free) {
      je[V.je_T + t] = -Ts * v * c;
      je[V.je_T + N + t] = -Ts * v * s;
      je[V.je_T + 2 * N + t] = -Ts * L.u(1, t);
    }
    // JD_sp: the acceleration rows [hi, lo] of a and alpha at step t
    for (int cc = 0; cc < 2; ++cc) {
      T* jd = vl + V.jd + cc * V.jd_fam;
      jd[t] = T(1);
      jd[2 * N - 1 + t] = T(-1);
      if (t >= 1) {
        jd[N + t - 1] = T(-1);
        jd[3 * N - 1 + t - 1] = T(1);
      }
      if (D.free) {
        const T lim = cc == 0 ? L.d[L.O.a_max] : L.d[L.O.alpha_max];
        jd[4 * N - 2 + t] = lim * Ts;
        jd[5 * N - 2 + t] = lim * Ts;
      }
    }
    // Hpp: the T row, the u-u diagonals and bands, the u-theta entry
    T* hp = vl + V.hp;
    if (D.free) {
      const T hthT = -(y1 * Ts * v * s - y2 * Ts * v * c);
      const T hvT = -(-y1 * Ts * c - y2 * Ts * s);
      const T hwT = mul_rn(y3, Ts);
      hp[1 + t] = sf * (T(-2) * gacc[0] / l.Tt) + hvT;
      hp[1 + N + t] = sf * (T(-2) * gacc[1] / l.Tt) + hwT;
      hp[1 + 2 * N + t] = hthT;
    }
    const T cnt = t < N - 1 ? T(2) : T(1);
    hp[V.hp_u + t] = sf * (R12(0, 0) + R22(0, 0) * cnt / dt2);
    hp[V.hp_u + N + t] = sf * (R12(0, 1) + R22(0, 1) * cnt / dt2);
    hp[V.hp_u + 2 * N + t] = sf * (R12(1, 1) + R22(1, 1) * cnt / dt2);
    if (t + 1 < N) {
      hp[V.hp_band + t] = sf * (-R22(0, 0) / dt2);
      hp[V.hp_band + (N - 1) + t] = sf * (-R22(0, 1) / dt2);
      hp[V.hp_band + 2 * (N - 1) + t] = sf * (-R22(1, 1) / dt2);
      hp[V.hp_band + 3 * (N - 1) + t] = sf * (-R22(0, 1) / dt2);
    }
    hp[V.hp_uth + t] = hthv;
  }
  thth_dyn[t] = thth;
  // Hpp x-x diagonal blocks at step t, pairs (0,0) (0,1) (0,2) (1,1) (1,2);
  // (2,2) waits for the blocks' curvature
  T* hx = vl + V.hp + V.hp_x;
  int p = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3 && p < 5; ++j, ++p) hx[p * (N + 1) + t] = sf * (t < N ? Q2(i, j) : P2(i, j));
  for (int i = 0; i < 3; ++i) {
    const int j = D.base_x + i * (N + 1) + t;
    T gn = 0;
    for (int jj = 0; jj < 3; ++jj)
      gn += (t < N ? Q2(i, jj) : P2(i, jj)) * (L.x(jj, t) - L.xref(jj, t));
    g[j] = sf * gn * l.ds[j];
  }
  return ca;
}

// Block kb's terms (block_term), its row scales and scaled multipliers, and
// its (theta_k, theta_k) curvature, into shared memory (sm) for this CTA
// and into the lane's workspace (w) for the dense launch.
template <typename T, int NS>
__device__ __forceinline__ void block_values(const LaneView<T>& L, const ProvLane<T>& l,
                                             const LaneWork<T>& sm, const LaneWork<T>& w, int kb) {
  const Dims& D = L.D;
  const int K = D.K;
  const BlockTerms<T>& bt = sm.bt;
  block_term<T, NS>(L, bt, kb);
  const T sE0 = l.scE[D.mE_sp + kb], sE1 = l.scE[D.mE_sp + K + kb];
  const T sD0 = l.scD[D.mD_sp + kb], sD1 = l.scD[D.mD_sp + K + kb];
  const T yg0 = sE0 * l.y[D.mE_sp + kb], yg1 = sE1 * l.y[D.mE_sp + K + kb];
  const T wdd = sD1 * l.wd[D.mD_sp + K + kb];
  const T m = bt.m[kb], ck = bt.ck[kb], sk = bt.sk[kb], qx = bt.q1x[kb], qy = bt.q1y[kb];
  const T hb = -(yg0 * m * (-ck * qx - sk * qy) + yg1 * m * (sk * qx - ck * qy) +
                 wdd * m * l.off * (-ck * qx - sk * qy));
  auto put = [&](int j, T v) {   // scalars to both places, terms (already shared) to the workspace
    if (j >= WB_SE0) sm.bt.m[j * sm.ks + kb] = v;
    w.bt.m[j * w.ks + kb] = v;
  };
  put(WB_M, m);
  put(WB_CK, ck);
  put(WB_SK, sk);
  put(WB_QX, qx);
  put(WB_QY, qy);
  put(WB_TX, bt.tx[kb]);
  put(WB_TY, bt.ty[kb]);
  put(WB_BLAM, bt.blam[kb]);
  put(WB_SE0, sE0);
  put(WB_SE1, sE1);
  put(WB_SD0, sD0);
  put(WB_SD1, sD1);
  put(WB_WN, sD0 * l.wd[D.mD_sp + kb]);
  put(WB_WDD, wdd);
  put(WB_YG0, yg0);
  put(WB_YG1, yg1);
  put(WB_HB, hb);
}

template <typename T, int NS>
__global__ void __launch_bounds__(PV_MAX_THREADS, 2)   // <= 64 registers: 16 CTAs of 64 an SM
    prov_values_kernel(ProvIn<T> in, ProvOut<T> o, T* work, const int* plan, int nnz, Dims D,
                       DataOff O, ValOff V, ProvLaunch P, T dual_reg) {
  extern __shared__ __align__(16) double smem_raw[];
  SmemArena ar(smem_raw);
  const int rows = D.mE_sp + D.mD_sp + D.np_;
  unsigned char* sst = P.lane ? ar.take<unsigned char>(int(((rows * D.np_ + 16 / sizeof(T) - 1) /
                                                             (16 / sizeof(T)) + 6) * 16))
                              : nullptr;   // first: the spine rows' stage, 16-byte aligned
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int N = D.N, K = D.K, E = D.E, bq = D.bq;

  T* sd = ar.take<T>(O.total);
  T* z = ar.take<T>(D.n);
  T* thth_dyn = ar.take<T>(N + 1);
  T* part = ar.take<T>(PV_PARTS);
  T* bdat = P.lane ? ar.take<T>(block_data_elems(D, K)) : nullptr;
  const LaneWork<T> sm(ar.take<T>(0), D, 0);   // last: the 17 arrays of block terms
  const BlockData<T> S = block_data<T>(sm.bt.m, sm.ks, bdat, K, E, NS);

  const T* dl = in.data + size_t(b) * O.total;
#pragma unroll 4
  for (int i = tid; i < O.total; i += nt) sd[i] = dl[i];
  const T* zl = in.zv + size_t(b) * D.n;
#pragma unroll 4
  for (int j = tid; j < D.n; j += nt) z[j] = zl[j] * in.ds[j];
  __syncthreads();

  const LaneView<T> L{D, O, sd, z};
  const LaneWork<T> w(work + size_t(b) * P.work_elems, D, V.total);
  ProvLane<T> l;
  l.scE = in.scE + size_t(b) * D.mE;
  l.scD = in.scD + size_t(b) * D.mD;
  l.y = in.y + size_t(b) * D.mE;
  l.wd = in.wd + size_t(b) * D.mD;
  l.ds = in.ds;
  l.sf = in.sf[b];
  l.dt = L.dt();
  l.dt2 = l.dt * l.dt;
  l.Ts = L.Ts();
  l.Tt = D.free ? L.Tv() : T(1);
  l.off = sd[O.ego_offset];
  const T sf = l.sf;
  T* vl = w.vals;
  T* g = o.g + size_t(b) * D.n;

  // ---- a thread a step or a block, the blocks from the next warp on. The
  // objective: the last t0 = pv_min_threads threads take a share each, as
  // a CTA of t0 threads shares it (from its first thread with no step or
  // block), so that the sum runs in one order whatever the CTA's size: the
  // size doubles for few lanes, and a lane's f must not depend on how many
  // lanes share the launch (solver/compact.py)
  const int nb0 = 32 * ((N + 32) / 32), t0 = pv_min_threads(D);
  const int own = tid - (nt - t0), busy = nb0 + K < t0 ? nb0 + K : 0;
  T ca = 0, fo = 0;
  for (int i = tid; i < nb0 + K; i += nt) {
    if (i <= N) {
      ca += step_values(L, l, V, i, vl, g, thth_dyn);
    } else if (i >= nb0) {
      block_values<T, NS>(L, l, sm, w, i - nb0);
      if (P.lane)
        for (int j = 0; j < block_items(D); ++j)
          stage_block_item<T, NS>(D, O, sd, in.ds, S, i - nb0, i - nb0, j, l.Tt);
    }
  }
  if (P.lane && tid < 4) S.ego[tid] = sd[O.ego_g + tid];
  if (own >= 0)
    for (int i = (own + t0 - busy) % t0; i < objective_items(D); i += t0)
      fo += objective_item(L, i, l.dt, dual_reg);
  fo = warp_sum(fo);
  ca = warp_sum(ca);
  if (lane == 0) {
    part[warp] = fo;
    part[PV_PARTS / 2 + warp] = ca;
  }
  __syncthreads();

  // ---- the lane's scalars, the constant spine values, the (theta, theta)
  // curvature
  if (tid == 0) {
    T f_nat = part[0], cacc = part[PV_PARTS / 2];
    for (int j = 1; j < nw; ++j) {
      f_nat += part[j];
      cacc += part[PV_PARTS / 2 + j];
    }
    const T cost_acc = T(0.5) * cacc / l.dt2;
    o.f[b] = sf * f_nat;
    if (D.free) {
      const T c1 = sd[O.time_c1], c2 = sd[O.time_c2], Tt = l.Tt;
      g[0] = sf * (T(-2) * cost_acc / Tt + T(N + 1) * (c1 + T(2) * c2 * Tt)) * in.ds[0];
      vl[V.hp] = sf * (T(6) * cost_acc / (Tt * Tt) + T(2) * c2 * T(N + 1));
    }
    for (int r = 0; r < D.mE_sp - 3 * N; ++r) vl[V.je_init + r] = T(1);   // init, term rows
    for (int j = 0; j < D.mD_sp - 4 * N; ++j)   // x_N, y_N, -y_N; the band's -theta_N, theta_N
      vl[V.jd + V.jd_term + j] = (D.band ? j == 0 : j == 2) ? T(-1) : T(1);
  }
  for (int t = tid; t <= N; t += nt) {
    T v = thth_dyn[t];
    if (t >= D.k_lo) {
      T acc = 0;
      for (int i = 0; i < D.nO; ++i) acc += sm.bs.hb[(t - D.k_lo) * D.nO + i];
      v += acc;
    }
    vl[V.hp + V.hp_x + 5 * (N + 1) + t] =
        mul_rn(sf, t < N ? L.Qm(2, 2) + L.Qm(2, 2) : L.Pm(2, 2) + L.Pm(2, 2)) + v;
  }

  // ---- residuals and the gradient's dual entries
#pragma unroll 2
  for (int r = tid; r < D.mE; r += nt) o.cE[size_t(b) * D.mE + r] = eq_row(L, sm.bt, r) * l.scE[r];
#pragma unroll 2
  for (int r = tid; r < D.mD; r += nt) o.cD[size_t(b) * D.mD + r] = dineq_row(L, sm.bt, r) * l.scD[r];
  for (int q = tid; q < K * bq; q += nt) {
    const int j = D.off_u + q;
    const T lm = q < K * E ? L.lam_mask((q / E) % D.nO, q % E) : L.obs_mask(((q - K * E) / 4) % D.nO);
    g[j] = sf * ((T(VMP_PIN_RHO) * (T(1) - lm) * (T(1) - lm) + dual_reg * lm * lm) * z[j]) * in.ds[j];
  }
  if (P.lane) {   // the lane's blocks' pieces and all its spine rows
    block_pieces<T, NS>(o, S, D, b, 0, K, sf, l.off, l.Ts, dual_reg);
    spine_tile(in, o, vl, plan, nnz, D, rows, b, 0, sst);
  }
}

// ------------------------------------------------------- launch 2: dense
// Block tile: the pieces of blocks [kb0, kb0 + PD_BLOCKS) of lane b. Their
// terms (wb: the lane's 17 workspace arrays of stride ks) and data are
// staged in shared memory in one pass, then block_pieces.
template <typename T, int NS>
__device__ __forceinline__ void block_tile(const ProvIn<T>& in, const ProvOut<T>& o,
                                           const T* wb, int ks, const Dims& D, const DataOff& O,
                                           int b, int kb0, T dual_reg, T* st) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = D.K, E = D.E, PB = PD_BLOCKS, ni = block_items(D);
  const int nk = K - kb0 < PB ? K - kb0 : PB;
  const T* dl = in.data + size_t(b) * O.total;
  const T Tt = NS == 4 ? in.zv[size_t(b) * D.n] * in.ds[0] : T(1);   // natural T (coupled motion)
  const BlockData<T> S = block_data<T>(st, PB, st + 16 * PB, PB, E, NS);
  const int n1 = 16 * nk, n2 = n1 + ni * nk;
#pragma unroll 2
  for (int q = tid; q < n2 + 4; q += nt) {
    if (q < n1) st[(q / nk) * PB + q % nk] = wb[(q / nk) * ks + kb0 + q % nk];
    else if (q < n2) stage_block_item<T, NS>(D, O, dl, in.ds, S, (q - n1) / ni, kb0 + (q - n1) / ni, (q - n1) % ni, Tt);
    else S.ego[q - n2] = dl[O.ego_g + q - n2];
  }
  __syncthreads();
  block_pieces<T, NS>(o, S, D, b, kb0, nk, in.sf[b], dl[O.ego_offset], dl[O.Ts], dual_reg);
}

template <typename T, int NS>
__global__ void __launch_bounds__(PD_THREADS)
    prov_dense_kernel(ProvIn<T> in, ProvOut<T> o, const T* work, const int* plan, int nnz,
                      Dims D, DataOff O, ProvLaunch P, T dual_reg) {
  extern __shared__ __align__(16) unsigned char pd_smem[];
  const int b = blockIdx.x, tile = blockIdx.y;   // lanes on grid x: no limit of 65535
  const T* wl = work + size_t(b) * P.work_elems;
  const int nv8 = int(pv_r8(P.n_values, sizeof(T)) / sizeof(T));   // the values, padded
  if (tile < P.spine_ctas)
    spine_tile(in, o, wl, plan, nnz, D, P.rows_per_tile, b, tile, pd_smem);
  else
    block_tile<T, NS>(in, o, wl + nv8, int(pv_r8(D.K, sizeof(T)) / sizeof(T)), D, O, b,
               (tile - P.spine_ctas) * PD_BLOCKS, dual_reg, reinterpret_cast<T*>(pd_smem));
}

// ------------------------------------------------------------ the entry
static bool prov_setup(const long long* ints, int nint, Dims& D, DataOff& O) {
  if (nint < VMP_DIMS_END + 1 || !dims_from(ints, D)) return false;
  O = make_data_off(D);
  return ints[1] >= 0 && ints[VMP_DIMS_END] == O.total;
}

template <typename T, int NS>
static int launch_provider(void** p, const long long* ints, double dual_reg, cudaStream_t st) {
  Dims D;
  DataOff O;
  if (!prov_setup(ints, VMP_DIMS_END + 5, D, O) || D.S != NS) return VMP_BAD_ARGS;
  const long long B = ints[1];
  const ProvLaunch P = prov_launch(D, O, B, sizeof(T));
  const ValOff V = val_off(D);
  // the row plan's values a lane; the wrapper's workspace a lane and rows a tile
  const long long* own = ints + VMP_DIMS_END;
  if (own[2] != P.n_values || own[3] != (long long)P.work_elems || own[4] != P.rows_per_tile)
    return VMP_BAD_ARGS;
  ProvIn<T> in{(const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
               (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7]};
  ProvOut<T> o{(T*)p[8],  (T*)p[9],  (T*)p[10], (T*)p[11], (T*)p[12], (T*)p[13], (T*)p[14],
               (T*)p[15], (T*)p[16], (T*)p[17], (T*)p[18], (T*)p[19], (T*)p[20]};
  const int* plan = (const int*)p[21];
  T* work = (T*)p[22];
  auto aligned = [](const T* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  if (!aligned(o.JE_sp) || !aligned(o.JD_sp) || !aligned(o.Hpp)) return VMP_BAD_ARGS;   // 16-byte stores
  if (P.values_smem > VMP_SMEM_MAX || P.dense_smem > VMP_SMEM_MAX ||
      P.spine_ctas + P.block_ctas > 65535)   // a lane's tiles on grid y
    return VMP_TOO_LARGE;
  auto values = prov_values_kernel<T, NS>;   // names with a comma cannot pass the macro
  auto dense = prov_dense_kernel<T, NS>;
  cudaError_t e = vmp_allow_smem(values, P.values_smem);
  if (e != cudaSuccess) return int(e);
  e = vmp_allow_smem(dense, P.dense_smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  VMP_LAUNCH(values, unsigned(B), P.values_threads, P.values_smem, st)(
      in, o, work, plan, int(own[1]), D, O, V, P, T(dual_reg));
  e = cudaGetLastError();
  if (e != cudaSuccess || P.lane) return int(e);
  VMP_LAUNCH(dense, dim3(unsigned(B), P.spine_ctas + P.block_ctas), PD_THREADS,
             P.dense_smem, st)(in, o, work, plan, int(own[1]), D, O, P, T(dual_reg));
  return int(cudaGetLastError());
}

// ptrs: zv, data, sf, scE, scD, y, w_d, ds | f, g, cE, cD, JE_sp, JEb_th,
//       JEb_q, JD_sp, JDb_p, JDb_q, Hpp, Hpq_c, Hqq | the row plan (int32),
//       the workspace (B x work_elems)
// ints: dtype, B, dims (common.cuh dims_from), packed data width, the
//       plan's nonzeros, values a lane, workspace elements a lane, rows a
//       spine tile
// reals: dual_reg
VMP_ENTRY(obca_kkt_provider) {
  if (nptr != 23 || nint != VMP_DIMS_END + 5 || nreal != 1) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool s4 = ints[10] == 4;   // dims' S
  if (ints[0] == 0)
    return s4 ? launch_provider<float, 4>(ptrs, ints, reals[0], st)
              : launch_provider<float, 3>(ptrs, ints, reals[0], st);
  if (ints[0] == 1)
    return s4 ? launch_provider<double, 4>(ptrs, ints, reals[0], st)
              : launch_provider<double, 3>(ptrs, ints, reals[0], st);
  return VMP_BAD_DTYPE;
}

// The launch plan this library makes for ints = dtype, B, dims, packed data
// width: out = values threads, values shared bytes, rows a spine tile,
// spine CTAs a lane, block CTAs a lane, dense shared bytes, values a lane,
// workspace elements a lane, blocks in the values CTA (0/1)
// (kernels.provider_launch_plan).
extern "C" int obca_kkt_provider_plan_info(const long long* ints, int nint, long long* out) {
  Dims D;
  DataOff O;
  if (!prov_setup(ints, nint, D, O) || (ints[0] != 0 && ints[0] != 1)) return VMP_BAD_ARGS;
  const ProvLaunch P = prov_launch(D, O, ints[1], ints[0] == 0 ? 4 : 8);
  out[0] = P.values_threads;
  out[1] = (long long)P.values_smem;
  out[2] = P.rows_per_tile;
  out[3] = P.spine_ctas;
  out[4] = P.block_ctas;
  out[5] = (long long)P.dense_smem;
  out[6] = P.n_values;
  out[7] = (long long)P.work_elems;
  out[8] = P.lane;
  return 0;
}

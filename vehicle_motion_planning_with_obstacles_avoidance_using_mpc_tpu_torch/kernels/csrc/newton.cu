// newton_*: the fused block-arrow Newton solve of the OBCA KKT system.
//
// Replaces: the JAX package's solver/ipm.py fused Newton step — G assembly
// (:882-927), kkt_solve_fused (:937-980) with its helpers (:654-732), and
// the unrolled ladder rungs (:982-994). Three entry points around the
// SPD inverses of spd_inv.cu:
//   newton_assemble  W = H + JI^T (W/S) JI and G = W + JE^T JE / dd in
//                    compressed arrow form, Gqq + delta*I for every rung
//                    (only the W pieces with w_only);
//   newton_schur     Yq = Gqq^-1 Gqp and S = Gpp + delta*I - clique(Gpq Yq);
//   newton_al_solve  the augmented-Lagrangian solve, n_refine refinement
//                    passes against the delta_d-regularized saddle system,
//                    and the curvature test -> (sol, good) per rung.
// Bound on this card: latency at the batch shapes. Per lane the work is a
// few dozen dependent matrix-vector passes over ~45-100 KB of operands
// (Wpp, Sinv, JE_sp, the (K, 8, 8) blocks). At long horizons the
// assembly's two spine products (JD^T diag(sigma) JD and JE^T JE, ~2 np^2
// (mD_sp + mE_sp) flops a lane: 147 MFLOP at N = 74) bound it by
// operations instead; see the assembly's section for its tile grid.
// Design: the assembly as a grid of spine tiles (its section below); a
// grid of (lane, tile of spine rows) for the Schur complement, each tile
// serving every rung from a static tile plan (its section below); one CTA
// per lane for the
// AL solve, its rungs in rung groups over operands staged once in shared
// memory (its section below). The block->spine accumulations are sums
// over the nO obstacles of a step, computed by the thread that owns the
// spine entry (no atomics).
// Every variant (the layout's counts come through dims_from). A block
// couples to S spine slots: x, y, theta of its step (S = 3), and under
// coupled motion also T (S = 4), spine position 0 of every block. Each
// kernel is a template on S, instantiated for 3 and 4; under S = 4 the T
// position is a clique row of every step (its sums run over all blocks).
#include "common.cuh"

#include <algorithm>
#include <vector>

template <typename T>
__host__ __device__ inline size_t r8(int count) { return ((size_t(count) * sizeof(T) + 7) / 8) * 8; }

// ------------------------------------------------------------ assemble
// A grid of (lane x upper triangular ASM_TILE^2 tile of the spine) plus,
// per lane, one CTA for every ASM_SMALL_KB blocks of the (K, S, bq) and
// (K, bq, bq) pieces. A tile CTA streams ASM_ROWS rows of the sigma-scaled
// JD (then of JE) through shared memory, the next chunk's loads in flight
// while the current one is multiplied out, and accumulates both symmetric
// products in 4x4 register blocks; an off-diagonal tile stores its entries
// and their mirror images, a diagonal tile first sums the box rows of each
// of its positions once. At demo9's N = 74 (np = 374, 527 rows) that is
// 21 tile CTAs per lane instead of one CTA for ~147 MFLOP; at the batch
// shapes (np = 33-54, one tile) it beat one CTA per lane with a thread per
// spine entry (PERF.md section 6). With w_only (the QR rung) JE^T JE, Gpp0,
// Gpq0 and Gqq are not formed.
#define ASM_TILE 64
#define ASM_ROWS 16
#define ASM_SMALL_KB 16

template <typename T>
struct AsmArgs {
  const T *Hpp, *Hpq, *Hqq, *JE_sp, *JEb_th, *JEb_q, *JD_sp, *JDb_p, *JDb_q, *sigma, *sgn,
      *ladder;
  const long long* id_p_pos;
  T *Wpp, *Wpq, *Wqq, *Gpp0, *Gpq0, *Gqq;
};

// the box rows' diagonal sgn^2 sigma at spine position r of lane b, summed
// in row order
template <typename T>
__device__ T asm_box_diag(const AsmArgs<T>& a, const Dims& D, int b, int r) {
  const int K = D.K, bq = D.bq, n_box = D.m_id - K * bq;
  const T* sigma = a.sigma + size_t(b) * D.mI + K * bq;
  const T* sgn = a.sgn + size_t(b) * D.m_id + K * bq;
  T dg = 0;
#pragma unroll 8
  for (int j = 0; j < n_box; ++j)
    if (a.id_p_pos[j] == r) dg += sgn[j] * sgn[j] * sigma[j];
  return dg;
}

// spine entry (r, c) of lane b from its products jd = (JD^T diag(sigma) JD)[r][c]
// and je = (JE^T JE)[r][c] and, where r == c, the box diagonal dg: Wpp adds
// Hpp, dg and the clique, Gpp0 the JE product / dd and the theta rows'
// diagonal. The clique entries: the state slots (sr, sc) of one step; under
// S = 4 also (T, slot) and (slot, T) of every step k >= k_lo, and (T, T)
// summed over every block.
template <typename T, int S>
__device__ void asm_spine_store(const AsmArgs<T>& a, const Dims& D, T dd, bool w_only, int b,
                                int r, int c, T jd, T je, T dg) {
  const int np_ = D.np_, K = D.K, nO = D.nO;
  const T* sigma = a.sigma + size_t(b) * D.mI;
  const T* JEth = a.JEb_th + size_t(b) * K * 2;
  const T* JDp = a.JDb_p + size_t(b) * K * 2 * S;
  const T* sig_b = sigma + D.m_id + D.mD_sp;   // [rr * K + kb]
  const size_t idx = size_t(b) * np_ * np_ + size_t(r) * np_ + c;
  T w = a.Hpp[idx];
  w += jd;
  if (r == c) w += dg;
  T th2 = 0;
  int sr, tr, sc, tc;
  if (pos_slot(D, r, sr, tr) && pos_slot(D, c, sc, tc) && tr == tc && tr >= D.k_lo) {
    T cl = 0;
    for (int i = 0; i < nO; ++i) {
      const int kb = (tr - D.k_lo) * nO + i;
      for (int rr = 0; rr < 2; ++rr)
        cl += sig_b[rr * K + kb] * JDp[(kb * 2 + rr) * S + sr] * JDp[(kb * 2 + rr) * S + sc];
      if (sr == 2 && sc == 2)
        th2 += JEth[kb * 2] * JEth[kb * 2] + JEth[kb * 2 + 1] * JEth[kb * 2 + 1];
    }
    w += cl;
    th2 /= dd;
  } else if (S == 4 && (r == 0 || c == 0)) {
    // the T row / column: slot 3 against the other position's slot, over
    // the blocks of its step, or over every block at (T, T)
    int s = 3, t = D.k_lo;
    if ((r == 0 && c == 0) || (pos_slot(D, r + c, s, t) && t >= D.k_lo)) {
      const int kb0 = (r == 0 && c == 0) ? 0 : (t - D.k_lo) * nO;
      const int kb1 = (r == 0 && c == 0) ? K : kb0 + nO;
      T cl = 0;
      for (int kb = kb0; kb < kb1; ++kb)
        for (int rr = 0; rr < 2; ++rr)
          cl += sig_b[rr * K + kb] * JDp[(kb * 2 + rr) * S + 3] * JDp[(kb * 2 + rr) * S + s];
      w += cl;
    }
  }
  a.Wpp[idx] = w;
  if (!w_only) a.Gpp0[idx] = w + je / dd + th2;
}

// coupling Wpq/Gpq0 (K, S, bq) and blocks Wqq/Gqq + delta_j I of lane b
// for the blocks kb0 .. kb1-1, strided over the CTA's threads
template <typename T, int S>
__device__ void asm_small(const AsmArgs<T>& a, const Dims& D, int R, T dd, bool w_only, int b,
                          int kb0, int kb1) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = D.K, bq = D.bq;
  const T* sigma = a.sigma + size_t(b) * D.mI;
  const T* sgn = a.sgn + size_t(b) * D.m_id;
  const T* JEth = a.JEb_th + size_t(b) * K * 2;
  const T* JEq = a.JEb_q + size_t(b) * K * 2 * bq;
  const T* JDp = a.JDb_p + size_t(b) * K * 2 * S;
  const T* JDq = a.JDb_q + size_t(b) * K * 2 * bq;
  const T* sig_b = sigma + D.m_id + D.mD_sp;   // [rr * K + kb]

  for (int idx = kb0 * S * bq + tid; idx < kb1 * S * bq; idx += nt) {
    const int kb = idx / (S * bq), s = (idx / bq) % S, c = idx % bq;
    T w = a.Hpq[size_t(b) * K * S * bq + idx];
    T g = 0;
    for (int rr = 0; rr < 2; ++rr) {
      w += sig_b[rr * K + kb] * JDp[(kb * 2 + rr) * S + s] * JDq[(kb * 2 + rr) * bq + c];
      g += JEth[kb * 2 + rr] * JEq[(kb * 2 + rr) * bq + c];
    }
    a.Wpq[size_t(b) * K * S * bq + idx] = w;
    if (!w_only) a.Gpq0[size_t(b) * K * S * bq + idx] = (s == 2) ? w + g / dd : w;
  }

  for (int idx = kb0 * bq * bq + tid; idx < kb1 * bq * bq; idx += nt) {
    const int kb = idx / (bq * bq), r = (idx / bq) % bq, c = idx % bq;
    T w = a.Hqq[size_t(b) * K * bq * bq + idx];
    T g = 0;
    for (int rr = 0; rr < 2; ++rr) {
      w += sig_b[rr * K + kb] * JDq[(kb * 2 + rr) * bq + r] * JDq[(kb * 2 + rr) * bq + c];
      g += JEq[(kb * 2 + rr) * bq + r] * JEq[(kb * 2 + rr) * bq + c];
    }
    if (r == c) {
      const int f = r < D.E ? kb * D.E + r : K * D.E + kb * 4 + (r - D.E);
      w += sgn[f] * sgn[f] * sigma[f];
    }
    a.Wqq[size_t(b) * K * bq * bq + idx] = w;
    if (w_only) continue;
    const T g0 = w + g / dd;
    for (int j = 0; j < R; ++j)
      a.Gqq[(size_t(b) * R + j) * K * bq * bq + idx] = (r == c) ? g0 + a.ladder[b * R + j] : g0;
  }
}

// acc[i][j] += sum over the rows of X[row][r0 + ty + 16 i] * X[row][c0 + tx + 16 j]
// for a (rows, np) row-major X, scaled by scale[row] on the left when given
template <typename T>
__device__ void asm_tile_product(const T* X, const T* scale, int rows, int np_, int r0, int c0,
                                 T (*Xs)[ASM_TILE], T (*Ys)[ASM_TILE], T acc[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  constexpr int PER = ASM_ROWS * ASM_TILE / 256;   // entries a thread stages per chunk
  T xr[PER], yr[PER];
  auto fetch = [&](int row0) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + 256 * q, row = row0 + e / ASM_TILE, cc = e % ASM_TILE;
      xr[q] = yr[q] = T(0);
      if (row < rows) {
        if (r0 + cc < np_) {
          xr[q] = X[size_t(row) * np_ + r0 + cc];
          if (scale) xr[q] *= scale[row];
        }
        if (c0 + cc < np_) yr[q] = X[size_t(row) * np_ + c0 + cc];
      }
    }
  };
  fetch(0);
  for (int row0 = 0; row0 < rows; row0 += ASM_ROWS) {
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + 256 * q;
      Xs[e / ASM_TILE][e % ASM_TILE] = xr[q];
      Ys[e / ASM_TILE][e % ASM_TILE] = yr[q];
    }
    __syncthreads();
    if (row0 + ASM_ROWS < rows) fetch(row0 + ASM_ROWS);
#pragma unroll 4
    for (int rr = 0; rr < ASM_ROWS; ++rr) {
      T xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xv[i] = Xs[rr][ty + 16 * i];
        yv[i] = Ys[rr][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * yv[j];
    }
    __syncthreads();
  }
}

// grid (lane, tile): tiles 0 .. n_up-1 are the upper triangle of the
// spine's ASM_TILE tiles, the rest ASM_SMALL_KB blocks each of the small
// pieces
template <typename T, int S>
__global__ void __launch_bounds__(256) newton_assemble_kernel(AsmArgs<T> a, Dims D, int R, T dd,
                                                              int w_only) {
  __shared__ T Xs[ASM_ROWS][ASM_TILE], Ys[ASM_ROWS][ASM_TILE], dgs[ASM_TILE];
  const int b = blockIdx.x, np_ = D.np_;
  const int nT = (np_ + ASM_TILE - 1) / ASM_TILE, n_up = nT * (nT + 1) / 2;
  int t = blockIdx.y;
  if (t >= n_up) {
    const int kb0 = (t - n_up) * ASM_SMALL_KB;
    asm_small<T, S>(a, D, R, dd, w_only != 0, b, kb0, min(D.K, kb0 + ASM_SMALL_KB));
    return;
  }
  int ti = 0;
  while (t >= nT - ti) {
    t -= nT - ti;
    ++ti;
  }
  const int tj = ti + t, r0 = ti * ASM_TILE, c0 = tj * ASM_TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  if (ti == tj)   // read after the products' barriers
    for (int p = threadIdx.x; p < ASM_TILE && r0 + p < np_; p += blockDim.x)
      dgs[p] = asm_box_diag(a, D, b, r0 + p);
  T jd[4][4] = {}, je[4][4] = {};
  asm_tile_product(a.JD_sp + size_t(b) * D.mD_sp * np_, a.sigma + size_t(b) * D.mI + D.m_id,
                   D.mD_sp, np_, r0, c0, Xs, Ys, jd);
  if (!w_only)
    asm_tile_product(a.JE_sp + size_t(b) * D.mE_sp * np_, (const T*)nullptr, D.mE_sp, np_, r0,
                     c0, Xs, Ys, je);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
      if (r >= np_ || c >= np_) continue;
      const T dg = r == c ? dgs[r - r0] : T(0);
      asm_spine_store<T, S>(a, D, dd, w_only != 0, b, r, c, jd[i][j], je[i][j], dg);
      if (ti != tj) asm_spine_store<T, S>(a, D, dd, w_only != 0, b, c, r, jd[i][j], je[i][j], T(0));
    }
}

// --------------------------------------------------------------- schur
// Yq = Qinv Gqp (B,R,K,bq,S) and S = Gpp0 + delta*I - clique(Gpq Yq)
// (B,R,np,np). A grid of (lane x tile of `rows` spine rows x rung). Which
// steps and clique rows a tile holds is a static plan made once per
// layout on the host (solver/newton.py schur_tile_plan, uploaded by the
// wrapper):
//   ints [0, nT]        the tiles' first step entries (CSR)
//        [nT+1, 2nT+1]  the tiles' first clique-row entries (CSR)
//        then per tile (j_a, n_a, j_b, n_b): its steps as two ranges of
//        consecutive steps (read with the offsets, so that no load of the
//        staging pass waits on another)
//   then per step entry (j, owner, pos0 .. pos{S-1}): the step, whether
//        this tile writes its blocks' Yq (the tile of its lowest state
//        row), the spine positions of its S slots;
//   then per clique row (row in tile, slot s, the step entry's index in
//        the tile), in row order. Under S = 4 the T position (row 0) is a
//        clique row of every step: its tile holds every step, and no other
//        tile writes row 0.
// A CTA serves every rung of its tile, in phases between barriers:
//   stage  in one pass, each thread issuing SCH_STAGE_U loads before its
//          stores (a chain of dependent loads, not the bytes, set the pace
//          of the kernel this replaces), its plan entries, the ladder, its
//          rows of Gpp0 (16-byte loads at the source's alignment, the
//          ragged ends by element) and its steps' Gpq0 blocks and every
//          rung's Qinv blocks (16-byte where aligned) into shared memory;
//   Yq     a thread per (step, rung, obstacle, row c): the row of Yq, its
//          Qinv row and Gpq rows read as 16-byte vectors (bq = 8; a strided
//          read of the rows conflicts 8 ways in the shared-memory banks),
//          written out where the tile owns the step;
//   SS     a thread per (step, rung, obstacle, s, t) of SS = Gpq Yq;
//   patch  a thread per entry of the rows' diagonal (+ delta) and of the
//          clique entries, the S x S slot blocks of steps k >= k_lo, each
//          less its step's SS summed over the nO obstacles in obstacle
//          order (a diagonal less that of each of its row's clique rows,
//          every step's at T): its value for every rung, rung 0's written
//          in place;
// then, rung by rung, it stores its rows to the rung's S (16-byte stores
// at that rung's alignment) and writes the next rung's patches.
// A step's state slot rows may lie in three tiles, which each compute its
// blocks (no cross-CTA dependence, one launch). Arithmetic as the
// one-CTA-a-(lane, rung) kernel it replaces: Yq and SS by FMA chains from
// 0 in the same order, delta added before the clique sum is subtracted,
// so the outputs are the same bits. Tiles: a lane's matrix is one tile
// where the lanes fill the card (SCH_FILL_LANES), else tiles of at least
// SCH_MIN_ROWS rows for SCH_SPREAD_CTAS CTAs; rows halved until the
// shared memory fits. Threads: where a CTA has few rounds of work, more
// CTAs an SM win (on an H100 at the fix step 128 threads took 0.0273 ms
// against 256's 0.0298); where it has many, fewer rounds win (the free
// batch: 256 threads 0.0092 against 128's 0.0120; tiled lanes: 512 beat
// 256; PERF.md section 6): 128 where a lane is one tile staging at most
// SCH_SMALL_STAGE bytes, 256 where it stages more, 512 where it is tiled.
#define SCH_THREADS_SMALL 128   // threads a CTA: a lane's matrix as one tile, its staging small
#define SCH_THREADS 256         // ... a lane's matrix as one tile
#define SCH_THREADS_TILED 512   // ... a lane's matrix in tiles
#define SCH_SMALL_STAGE (24 * 1024)   // staged bytes (rows, Qinv, Gpq0) of a small staging
#define SCH_MIN_ROWS 8
#define SCH_FILL_LANES 132    // lanes from which a lane's matrix is one tile (a CTA an SM)
#define SCH_SPREAD_CTAS 264   // CTAs to aim for where lanes are tiled (2 an SM)
#define SCH_ROW_INTS 3
#define SCH_RANGE_INTS 4
#define SCH_STAGE_U 4         // loads a thread has in flight while staging
#define SCH_MIN_CTAS 2        // 512-thread CTAs an SM must hold (caps the registers at 64)
enum { SCH_ST_NONE = 0, SCH_ST_4, SCH_ST_8, SCH_ST_16, SCH_ST_16E };   // staged item kinds

struct SchurPlan {
  int tiles, rows, threads, max_steps, max_crows, total_steps, total_crows;
  size_t smem;
  long long table;   // ints of the plan table
};

__host__ __device__ inline size_t sch_r16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// ints a step entry: the step, its owner flag, its S slots' positions
__host__ __device__ constexpr int sch_step_ints(int S) { return 2 + S; }

// shared bytes a CTA: the tile's rows of Gpp0, its steps' Qinv (every
// rung), Gpq0, Yq and SS, the other rungs' patches, the ladder, the row
// map, the plan entries
inline size_t sch_smem(const Dims& D, int R, int rows, int ms, int mc, size_t e) {
  const size_t nO = D.nO, bq = D.bq, S = D.S;
  return sch_r16(size_t(rows) * D.np_ * e) + sch_r16(ms * R * nO * bq * bq * e) +
         sch_r16(ms * nO * S * bq * e) + sch_r16(ms * R * nO * bq * S * e) +
         sch_r16(ms * R * nO * S * S * e) + sch_r16(size_t(R) * (rows + (S - 1) * mc) * e) +
         sch_r16(size_t(R) * e) + sch_r16(size_t(rows) * sizeof(int)) +
         sch_r16(size_t(sch_step_ints(D.S) * ms + SCH_ROW_INTS * mc) * sizeof(int));
}

// the tiles' step and clique-row counts for tiles of `rows` rows: a state
// row of a step k >= k_lo is one clique row; under S = 4 row 0 (T) is one
// of every step
static void sch_counts(const Dims& D, int rows, SchurPlan& p) {
  const int np_ = D.np_;
  p.rows = rows;
  p.tiles = (np_ + rows - 1) / rows;
  p.max_steps = p.max_crows = p.total_steps = p.total_crows = 0;
  std::vector<char> seen(D.n_k > 0 ? D.n_k : 1);
  for (int t0 = 0; t0 < np_; t0 += rows) {
    std::fill(seen.begin(), seen.end(), 0);
    int ns = 0, nc = 0, s, t;
    for (int r = t0; r < t0 + rows && r < np_; ++r) {
      if (D.S == 4 && r == 0) {
        nc += D.n_k;
        for (int j = 0; j < D.n_k; ++j)
          if (!seen[j]) {
            seen[j] = 1;
            ++ns;
          }
      } else if (pos_slot(D, r, s, t) && t >= D.k_lo) {
        ++nc;
        if (!seen[t - D.k_lo]) {
          seen[t - D.k_lo] = 1;
          ++ns;
        }
      }
    }
    p.max_steps = std::max(p.max_steps, ns);
    p.max_crows = std::max(p.max_crows, nc);
    p.total_steps += ns;
    p.total_crows += nc;
  }
  p.table = 2LL * (p.tiles + 1) + SCH_RANGE_INTS * p.tiles +
            sch_step_ints(D.S) * p.total_steps + SCH_ROW_INTS * p.total_crows;
}

// The plan of B lanes and R rungs: 0, or VMP_TOO_LARGE
static int schur_plan(const Dims& D, int R, long long B, size_t e, SchurPlan& p) {
  const int np_ = D.np_;
  const long long lanes = std::max(B, 1LL);
  int tiles = 1;
  if (lanes < SCH_FILL_LANES)
    tiles = int(std::min<long long>((np_ + SCH_MIN_ROWS - 1) / SCH_MIN_ROWS,
                                    (SCH_SPREAD_CTAS + lanes - 1) / lanes));
  int rows = (np_ + tiles - 1) / tiles;
  for (;;) {
    sch_counts(D, rows, p);
    p.smem = sch_smem(D, R, rows, p.max_steps, p.max_crows, e);
    const size_t staged = sch_r16(size_t(rows) * np_ * e) +
                          sch_r16(size_t(p.max_steps) * R * D.nO * D.bq * D.bq * e) +
                          sch_r16(size_t(p.max_steps) * D.nO * D.S * D.bq * e);
    p.threads = p.tiles > 1 ? SCH_THREADS_TILED
                            : staged <= SCH_SMALL_STAGE ? SCH_THREADS_SMALL : SCH_THREADS;
    if (p.smem <= VMP_SMEM_MAX) return 0;
    if (rows == 1) return VMP_TOO_LARGE;
    rows = (rows + 1) / 2;
  }
}

// n elements from shared sm (16-byte aligned) to global g: 16-byte
// stores where g's alignment allows, by all threads
template <typename T>
__device__ void sch_store(T* __restrict__ g, const T* sm, int n) {
  constexpr int W = 16 / sizeof(T);
  const int mis = int((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(T));
  const int head = mis ? min(n, W - mis) : 0;
  const int nv = (n - head) / W;
  for (int k = threadIdx.x; k < head; k += blockDim.x) g[k] = sm[k];
  uint4* gv = reinterpret_cast<uint4*>(g + head);
  if ((head * sizeof(T)) % 16 == 0) {
    const uint4* sv = reinterpret_cast<const uint4*>(sm + head);
    for (int v = threadIdx.x; v < nv; v += blockDim.x) gv[v] = sv[v];
  } else {
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      uint4 x;
      T* xs = reinterpret_cast<T*>(&x);
#pragma unroll
      for (int w = 0; w < W; ++w) xs[w] = sm[head + v * W + w];
      gv[v] = x;
    }
  }
  for (int k = head + nv * W + threadIdx.x; k < n; k += blockDim.x) g[k] = sm[k];
}

__device__ inline float sch_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ inline double sch_fma(double a, double b, double c) { return __fma_rn(a, b, c); }

// Yq's row c of one block: acc_s = sum_d Q[c][d] G[s][d], an FMA chain
// from 0 in d for each of the S slots s
template <typename T, int S>
__device__ inline void sch_yq_row(const T* Qrow, const T* G, int bq, T* y) {
  if (bq == 8) {   // the rows as 16-byte vectors (both 16-byte aligned)
    alignas(16) T q[8];
    alignas(16) T g[8];
    const uint4* qv = reinterpret_cast<const uint4*>(Qrow);
#pragma unroll
    for (int w = 0; w < 8 * int(sizeof(T)) / 16; ++w)
      reinterpret_cast<uint4*>(q)[w] = qv[w];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint4* gv = reinterpret_cast<const uint4*>(G + s * 8);
#pragma unroll
      for (int w = 0; w < 8 * int(sizeof(T)) / 16; ++w)
        reinterpret_cast<uint4*>(g)[w] = gv[w];
      T acc = 0;
#pragma unroll
      for (int d = 0; d < 8; ++d) acc = sch_fma(q[d], g[d], acc);
      y[s] = acc;
    }
    return;
  }
  T acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = T(0);
  for (int d = 0; d < bq; ++d) {
    const T a = Qrow[d];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = sch_fma(a, G[s * bq + d], acc[s]);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) y[s] = acc[s];
}

template <typename T, int S>
__global__ void __launch_bounds__(SCH_THREADS_TILED, SCH_MIN_CTAS) newton_schur_kernel(
    const T* __restrict__ Qinv, const T* __restrict__ Gpq0, const T* __restrict__ Gpp0,
    const T* __restrict__ ladder, T* __restrict__ Yq, T* __restrict__ S_out,
    const int* __restrict__ plan, Dims D, int R, int rows, int max_steps, int max_crows) {
  extern __shared__ __align__(16) unsigned char sch_smem_raw[];
  const int b = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int np_ = D.np_, K = D.K, bq = D.bq, nO = D.nO, nT = gridDim.y;
  const int r0 = tile * rows, nr = min(rows, np_ - r0);
  const int s0 = plan[tile], ns = plan[tile + 1] - s0;
  const int c0 = plan[nT + 1 + tile], nc = plan[nT + 2 + tile] - c0;
  const int* rng = plan + 2 * (nT + 1) + SCH_RANGE_INTS * tile;
  const int ja = rng[0], na = rng[1], jb = rng[2];
  constexpr int SI = sch_step_ints(S), SS2 = S * S;
  const int* steps = plan + 2 * (nT + 1) + SCH_RANGE_INTS * nT + SI * s0;
  const int* crows = plan + 2 * (nT + 1) + SCH_RANGE_INTS * nT + SI * plan[nT] +
                     SCH_ROW_INTS * c0;
  const int nQ = nO * bq * bq, nG = nO * S * bq, nY = nO * bq * S, PV = rows + (S - 1) * max_crows;
  unsigned char* sp = sch_smem_raw;
  auto take = [&](size_t count, size_t size) {
    unsigned char* q = sp;
    sp += sch_r16(count * size);
    return q;
  };
  T* Gt = reinterpret_cast<T*>(take(size_t(rows) * np_, sizeof(T)));
  T* Qs = reinterpret_cast<T*>(take(size_t(max_steps) * R * nQ, sizeof(T)));
  T* Gs = reinterpret_cast<T*>(take(size_t(max_steps) * nG, sizeof(T)));
  T* Ys = reinterpret_cast<T*>(take(size_t(max_steps) * R * nY, sizeof(T)));
  T* SSs = reinterpret_cast<T*>(take(size_t(max_steps) * R * nO * SS2, sizeof(T)));
  T* pv = reinterpret_cast<T*>(take(size_t(R) * PV, sizeof(T)));
  T* dl = reinterpret_cast<T*>(take(R, sizeof(T)));
  int* rowmap = reinterpret_cast<int*>(take(rows, sizeof(int)));
  int* pl = reinterpret_cast<int*>(take(SI * max_steps + SCH_ROW_INTS * max_crows, sizeof(int)));
  const int* st_s = pl;                              // the tile's step entries
  const int* cr_s = pl + SI * ns;                    // its clique rows

  // ---- stage
  constexpr int W = 16 / sizeof(T);
  constexpr unsigned KT = sizeof(T) == 8 ? SCH_ST_8 : SCH_ST_4;
  const T* tg = Gpp0 + size_t(b) * np_ * np_ + size_t(r0) * np_;
  const int tn = nr * np_;
  const int tmis = int((reinterpret_cast<uintptr_t>(tg) & 15) / sizeof(T));
  const int th = tmis ? min(tn, W - tmis) : 0, tv = (tn - th) / W;
  const bool t_al = (th * sizeof(T)) % 16 == 0;     // the tile's vectors land aligned
  const bool g_vec = (reinterpret_cast<uintptr_t>(Gpq0) & 15) == 0 && (S * bq * sizeof(T)) % 16 == 0;
  const bool q_vec = (reinterpret_cast<uintptr_t>(Qinv) & 15) == 0 && (bq * bq * sizeof(T)) % 16 == 0;
  const int gw = g_vec ? W : 1, qw = q_vec ? W : 1, gi = nG / gw, qi = nQ / qw;
  const int n_int = SI * ns + SCH_ROW_INTS * nc, n_tile = th + tv + (tn - th - tv * W);
  const int total = n_int + R + n_tile + ns * gi + ns * R * qi;
  for (int r = tid; r < nr; r += nt) rowmap[r] = -1;
  for (int k0 = 0; k0 < total; k0 += nt * SCH_STAGE_U) {
    uint4 v[SCH_STAGE_U];
    unsigned to[SCH_STAGE_U];   // (kind << 24) | shared byte offset
#pragma unroll
    for (int u = 0; u < SCH_STAGE_U; ++u) {
      int k = k0 + u * nt + tid;
      const void* src = nullptr;
      const void* at = nullptr;
      unsigned kind = SCH_ST_NONE;
      if (k < total) {
        if (k < n_int) {
          src = k < SI * ns ? steps + k : crows + (k - SI * ns);
          at = pl + k;
          kind = SCH_ST_4;
        } else if ((k -= n_int) < R) {
          src = ladder + size_t(b) * R + k;
          at = dl + k;
          kind = KT;
        } else if ((k -= R) < n_tile) {
          const int e = k < th ? k : k < th + tv ? th + (k - th) * W : k - tv + tv * W;
          src = tg + e;
          at = Gt + e;
          kind = (k < th || k >= th + tv) ? KT : t_al ? SCH_ST_16 : SCH_ST_16E;
        } else if ((k -= n_tile) < ns * gi) {
          const int q = k / gi, o = (k - q * gi) * gw, j = q < na ? ja + q : jb + (q - na);
          src = Gpq0 + (size_t(b) * K + size_t(j) * nO) * S * bq + o;
          at = Gs + q * nG + o;
          kind = g_vec ? SCH_ST_16 : KT;
        } else {
          k -= ns * gi;
          const int qr = k / qi, o = (k - qr * qi) * qw, q = qr / R, rg = qr - q * R;
          const int j = q < na ? ja + q : jb + (q - na);
          src = Qinv + ((size_t(b) * R + rg) * K + size_t(j) * nO) * bq * bq + o;
          at = Qs + size_t(qr) * nQ + o;
          kind = q_vec ? SCH_ST_16 : KT;
        }
        if (kind >= SCH_ST_16) v[u] = __ldg(reinterpret_cast<const uint4*>(src));
        else if (kind == SCH_ST_8) {
          const unsigned long long x = __ldg(reinterpret_cast<const unsigned long long*>(src));
          v[u].x = unsigned(x);
          v[u].y = unsigned(x >> 32);
        } else v[u].x = __ldg(reinterpret_cast<const unsigned*>(src));
      }
      to[u] = kind ? (kind << 24) | unsigned(static_cast<const unsigned char*>(at) - sch_smem_raw)
                   : 0u;
    }
#pragma unroll
    for (int u = 0; u < SCH_STAGE_U; ++u) {
      unsigned char* d = sch_smem_raw + (to[u] & 0xffffffu);
      switch (to[u] >> 24) {
        case SCH_ST_16: *reinterpret_cast<uint4*>(d) = v[u]; break;
        case SCH_ST_16E: {
          const T* xs = reinterpret_cast<const T*>(&v[u]);
#pragma unroll
          for (int w = 0; w < W; ++w) reinterpret_cast<T*>(d)[w] = xs[w];
          break;
        }
        case SCH_ST_8:
          *reinterpret_cast<unsigned long long*>(d) =
              (static_cast<unsigned long long>(v[u].y) << 32) | v[u].x;
          break;
        case SCH_ST_4: *reinterpret_cast<unsigned*>(d) = v[u].x; break;
        default: break;
      }
    }
  }
  __syncthreads();

  // ---- Yq of the tile's blocks: a thread per (step, rung, obstacle, row c);
  // a row's first clique row in the row map
  for (int c = tid; c < nc; c += nt) {   // (S = 3: one clique row a row)
    const int r = cr_s[SCH_ROW_INTS * c];
    if (S == 3 || c == 0 || cr_s[SCH_ROW_INTS * (c - 1)] != r) rowmap[r] = c;
  }
  for (int idx = tid; idx < ns * R * nO * bq; idx += nt) {
    const int c = idx % bq, kq = idx / bq;       // kq = (q * R + rg) * nO + i
    const int i = kq % nO, q = kq / (nO * R), rg = (kq / nO) % R;
    T y[S];
    sch_yq_row<T, S>(Qs + size_t(kq) * bq * bq + c * bq, Gs + (q * nO + i) * S * bq, bq, y);
    T* ys = Ys + (size_t(kq) * bq + c) * S;
#pragma unroll
    for (int s = 0; s < S; ++s) ys[s] = y[s];
    if (st_s[SI * q + 1]) {
      const int kb = st_s[SI * q] * nO + i;
      T* out = Yq + ((size_t(b) * R + rg) * K + kb) * bq * S + c * S;
#pragma unroll
      for (int s = 0; s < S; ++s) out[s] = y[s];
    }
  }
  __syncthreads();
  // ---- SS = Gpq Yq of the tile's blocks: a thread per (step, rung, obstacle, s, t)
  for (int idx = tid; idx < ns * R * nO * SS2; idx += nt) {
    const int st = idx % SS2, kq = idx / SS2, s = st / S, t = st % S;
    const int q = kq / (nO * R), i = kq % nO;
    const T* G = Gs + (q * nO + i) * S * bq + s * bq;
    const T* y = Ys + size_t(kq) * bq * S + t;
    T acc = 0;
    for (int c = 0; c < bq; ++c) acc = sch_fma(G[c], y[c * S], acc);
    SSs[idx] = acc;
  }
  __syncthreads();
  // ---- the patches: a thread per entry (the rows' diagonal, then the
  // clique rows' S - 1 off-diagonal entries) computes its value for every
  // rung from the staged value (cl = sum over the obstacles from 0, a
  // diagonal less that of each clique row of its row), writes rung 0's in
  // place and keeps the others
  for (int e = tid; e < nr + (S - 1) * nc; e += nt) {
    int r, col, ci, t = 0;
    if (e < nr) {
      r = e;
      col = r0 + r;
      ci = rowmap[r];
    } else {
      ci = (e - nr) / (S - 1);
      r = cr_s[SCH_ROW_INTS * ci];
      const int s = cr_s[SCH_ROW_INTS * ci + 1], k = (e - nr) % (S - 1);
      t = k + (k >= s);   // the slots other than s
      col = st_s[SI * cr_s[SCH_ROW_INTS * ci + 2] + 2 + t];
    }
    const T g = Gt[r * np_ + col];
    int s = 0, q = 0;
    if (ci >= 0) {
      s = cr_s[SCH_ROW_INTS * ci + 1];
      q = cr_s[SCH_ROW_INTS * ci + 2];
      if (e < nr) t = s;
    }
    for (int rg = 0; rg < R; ++rg) {
      T v = g;
      if (e < nr) v += dl[rg];
      if (ci >= 0) {
        const T* ss = SSs + size_t(q * R + rg) * nO * SS2 + s * S + t;
        T cl = 0;
        for (int i = 0; i < nO; ++i) cl += ss[i * SS2];
        v -= cl;
        // S = 4: T's diagonal less every other step's (T, T) sum in turn
        for (int cj = ci + 1; S == 4 && e < nr && cj < nc && cr_s[SCH_ROW_INTS * cj] == r; ++cj) {
          const T* sj = SSs + size_t(cr_s[SCH_ROW_INTS * cj + 2] * R + rg) * nO * SS2 + SS2 - 1;
          T cj_sum = 0;
          for (int i = 0; i < nO; ++i) cj_sum += sj[i * SS2];
          v -= cj_sum;
        }
      }
      if (rg == 0) Gt[r * np_ + col] = v;
      else pv[rg * PV + (e < nr ? e : rows + (e - nr))] = v;
    }
  }
  // ---- rung by rung: the store, then the next rung's patches
  for (int rg = 0; rg < R; ++rg) {
    __syncthreads();
    sch_store(S_out + (size_t(b) * R + rg) * np_ * np_ + size_t(r0) * np_, Gt, nr * np_);
    if (rg + 1 == R) break;
    __syncthreads();
    for (int e = tid; e < nr + (S - 1) * nc; e += nt) {
      int at;
      if (e < nr) {
        at = e * np_ + r0 + e;
      } else {
        const int ci = (e - nr) / (S - 1), s = cr_s[SCH_ROW_INTS * ci + 1];
        const int k = (e - nr) % (S - 1), t = k + (k >= s);
        at = cr_s[SCH_ROW_INTS * ci] * np_ + st_s[SI * cr_s[SCH_ROW_INTS * ci + 2] + 2 + t];
      }
      Gt[at] = pv[(rg + 1) * PV + (e < nr ? e : rows + (e - nr))];
    }
  }
}

// ------------------------------------------------------------ AL solve
// Replaces kkt_solve_fused's gsolve, al_solve and refinement loop with the
// curvature test (the JAX package's solver/ipm.py:937-981). Bound: one
// lane's chain of ~10 dependent passes a rung (its bytes, ~45 KB a lane
// in float32 at the fix step, would take the card 0.019 ms for 1280
// lanes). A lane's R rungs run in `groups` groups of `threads` threads
// (rungs g, g + groups, ... one after another in group g), each group
// synchronised by its own named barrier: on the staged route all of them
// in one CTA a lane, reading the lane's operands once; on the global
// route a CTA a rung. Per rung, with x = (p, q):
//   first:  b = r1 + JE^T r2 / dd,  d = G^-1 b,  v = (JE d - r2) / dd
//   refine: res2 = JE d - delta_d v - r2,
//           b = ((W d + delta d) + JE^T v - r1) + JE^T res2 / dd,
//           c = G^-1 b,  cv = (JE c - res2) / dd,  d -= c,  v -= cv
//   good = all finite (d, v) and d^T W d + delta |d|^2 > 0,
// with G^-1 by block elimination (wq = Qi bq, rp = bp - slot_add(Gpq wq),
// dp = Si rp, dq = wq - Yq dp_slots; under S = 4 a block's T slot is spine
// position 0, whose sums run over every block). Four passes a solve and
// one for the curvature, each closed by the group's barrier:
//   rhs    W's spine rows, JE^T's spine part, and per block bq, then
//          wq = Qi bq (bq's entries shuffled within the block's lanes)
//          and gk = Gpq wq;
//   rp     a thread an entry: rp = b - slot_add(gk);
//   spine  dp (or c's p) = Si rp;
//   finish JE's spine rows, and per block dq = wq - Yq dp_slots with JE's
//          two block rows, each row's v / res2 update done by the lane
//          that sums it; a correction also forms d - c and JE (d - c).
// Every product runs on tiles of 4 rows x 8 columns a warp: 8 lanes a row
// (a row of Wpp, Si or JE_sp; for JE^T 8 lanes an output column, the 4
// row groups summed), their partial sums finished with __shfl_xor_sync;
// a (bq, bq) block takes an aligned group of 8 lanes, a lane a row.
// Two routes, chosen on the host from the layout and the dtype (al_route,
// kernels.al_solve_route):
//   staged  the lane's operands (JE_sp, JEb_th, JEb_q, Wpp, Wpq, Wqq,
//           Gpq0) and right-hand sides, and each group's rung operands
//           (Qinv, Yq, Sinv), copied once into shared memory with
//           cp.async; every pass then reads shared memory only. Wpp, Si
//           and JE_sp get a row stride of 8 mod 16 and the blocks an odd
//           one, so that a tile's reads hit distinct banks. The rungs run
//           as concurrent groups where they fit, else one group in turn;
//   global  where the staged lane does not fit in 227 KB (long
//           horizons): the operands stay in device memory (a tile row is
//           one 32-byte sector in float32), a CTA a rung (each on its own
//           SM's path to L2: a pass streams ~1 MB at N = 74), its vectors
//           in shared memory (up to N ~ 170, beyond what newton_schur
//           takes).
// On both routes the vectors and every sum are float64 (AlAcc).
#define AL_TG 256           // threads a rung group, staged route (kernels.AL_TG)
#define AL_TG_GLOBAL 1024   // threads a CTA (one rung), global route (kernels.AL_TG_GLOBAL)
#define AL_MAX_G 2          // rung groups a CTA (kernels.AL_MAX_G)
#define AL_SW 8             // lanes a row of a row product (4 rows a warp)
#define AL_FULL 0xffffffffu

#ifndef VMP_NAMED_BARRIER
#define VMP_NAMED_BARRIER(id, n) __syncthreads()
#endif

__host__ __device__ inline size_t al_r8(size_t count, size_t elem) {
  return (count * elem + 7) / 8 * 8;
}

// the staged row stride of an (r, np) matrix: at least np and 8 mod 16,
// so that a tile's 4 rows of 8 entries fall on distinct banks (float32:
// rows 8 or 24 words apart mod 32; float64: each half-warp's 2 rows 16
// words apart)
__host__ __device__ inline int al_ld(int np_) { return np_ <= 8 ? 8 : 8 + (np_ - 8 + 15) / 16 * 16; }

// The launch shape of one call (kernels.al_solve_route mirrors it).
struct AlRoute {
  int staged;    // 1: operands staged in shared memory
  int ctas;      // CTAs a lane (CTA c runs the rung groups c groups, ...)
  int groups;    // rung groups a CTA
  int threads;   // threads a group
  int ld, ldB;   // row strides of Wpp / Si / JE_sp and of the (bq, bq) blocks
  size_t smem;   // dynamic shared bytes a CTA
};

// Bytes of the staged lane operands and right-hand sides, of one group's
// staged rung operands, and of one group's vectors (the kernel's order).
__host__ __device__ inline size_t al_lane_bytes(const Dims& D, int ld, int ldB, size_t e) {
  const size_t K = D.K, bq = D.bq, S = D.S;
  return al_r8(size_t(D.mE_sp) * ld, e) + al_r8(2 * K, e) + al_r8(2 * K * bq, e) +
         al_r8(size_t(D.np_) * ld, e) + al_r8(S * K * bq, e) + al_r8(K * bq * ldB, e) +
         al_r8(S * K * bq, e) + al_r8(D.n, e) + al_r8(D.mE, e);
}
__host__ __device__ inline size_t al_rung_bytes(const Dims& D, int ld, int ldB, size_t e) {
  const size_t K = D.K, bq = D.bq, S = D.S;
  return al_r8(K * bq * ldB, e) + al_r8(S * K * bq, e) + al_r8(size_t(D.np_) * ld, e);
}
__host__ __device__ inline size_t al_vec_bytes(const Dims& D) {
  const size_t K = D.K, bq = D.bq, S = D.S, a = sizeof(double);
  return 5 * al_r8(D.np_, a) + 2 * al_r8(K * bq, a) + al_r8(S * K, a) + 2 * al_r8(D.mE, a) +
         3 * 32 * sizeof(double);
}

// the index tables of a CTA: each spine position's slot (kb0 4 + s of the
// first block of its step, -1 off the states' slots) and each block's
// first slot position
__host__ __device__ inline size_t al_table_bytes(const Dims& D) {
  return al_r8(D.np_, sizeof(int)) + al_r8(D.K, sizeof(int));
}

// the dynamic shared memory a CTA may take besides the groups' views
#define AL_SMEM_BUDGET (VMP_SMEM_MAX - 1024)

// The route of one call; smem above AL_SMEM_BUDGET where the global
// route's vectors do not fit either (VMP_TOO_LARGE)
inline AlRoute al_route(const Dims& D, int R, size_t e) {
  AlRoute r;
  const int G = R < AL_MAX_G ? R : AL_MAX_G;
  r.threads = AL_TG;
  r.ld = al_ld(D.np_);
  r.ldB = D.bq | 1;
  const size_t lane = al_table_bytes(D) + al_lane_bytes(D, r.ld, r.ldB, e);
  const size_t per = al_rung_bytes(D, r.ld, r.ldB, e) + al_vec_bytes(D);
  for (int g = G; g >= 1; g = (g == 1 ? 0 : 1)) {   // the rungs at once, else in turn
    if (lane + g * per <= AL_SMEM_BUDGET) {
      r.staged = 1;
      r.ctas = 1;
      r.groups = g;
      r.smem = lane + g * per;
      return r;
    }
  }
  // operands in device memory: a CTA a rung, each on its own SM's path
  // to L2 (a lane's passes stream ~1 MB of operands at N = 74)
  r.staged = 0;
  r.ctas = R;
  r.groups = 1;
  r.threads = AL_TG_GLOBAL;
  r.ld = D.np_;
  r.ldB = D.bq;
  r.smem = al_table_bytes(D) + al_vec_bytes(D);
  return r;
}

template <typename T>
struct AlArgs {
  const T *JE, *JEth, *JEq, *Wpp, *Wpq, *Wqq, *Gpq, *Qi, *Yq, *Si, *rhs1, *rhs2, *ladder;
  T* sol;
  unsigned char* good;
};

// sum over the lanes xor'ed by o0, 2 o0, ... o1 (powers of two, o1 <= 16)
template <typename T>
__device__ inline T al_xsum(T v, int o0, int o1) {
#pragma unroll
  for (int o = 1; o <= 16; o <<= 1)
    if (o >= o0 && o <= o1) v += __shfl_xor_sync(AL_FULL, v, o);
  return v;
}

// One element global -> shared without a register (cp.async); a plain
// copy where there is no device code.
template <typename T>
__device__ inline void al_copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

__device__ inline void al_copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// rows x w elements of src (rows back to back) into dst at row stride ld;
// thread t of nt copies elements t, t + nt, ... (its row and column
// stepped without a division an element)
template <typename T>
__device__ inline void al_stage(T* dst, const T* src, int rows, int w, int ld, int t, int nt) {
  if (ld == w) {
    for (int i = t; i < rows * w; i += nt) al_copy_async(dst + i, src + i);
    return;
  }
  const int dr = nt / w, dc = nt - dr * w;
  int r = t / w, c = t - r * w;
  for (int i = t; i < rows * w; i += nt) {
    al_copy_async(dst + r * ld + c, src + i);
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

template <typename T, bool STAGED>
__device__ inline T al_ld(const T* p) {
  if constexpr (STAGED) return *p;
  else return __ldg(p);
}

// acc + a b in the accumulator's type A
template <typename A, typename X, typename Y>
__device__ inline A al_fma(X a, Y b, A acc) { return fma(A(a), A(b), acc); }

// The type of the solve's vectors and sums: float64 whatever T and the
// route. With float32 tensors this gives the float64 algorithm's result
// on the same operands. float32 rounding moves an ill-conditioned lane's
// residual by several times, and can flip its curvature test (PERF.md
// §6; scripts/al_precision_ab.py builds and compares the rules).
template <typename T, bool STAGED>
using AlAcc = double;

// What a rung group's threads share, in shared memory (a thread's 64
// registers do not hold it): the sizes, the operands (shared memory when
// STAGED, else device memory) and the group's vectors, in A.
template <typename T, typename A>
struct AlView {
  Dims D;
  int nt, nw, bar, gw, ld, ldB;
  A rdd, delta_d;   // 1 / dd
  const int *pinfo, *bs0;   // al_table_bytes
  const T *JE, *JEth, *JEq, *Wpp, *Wpq, *Wqq, *Gpq, *Qi, *Yq, *Si, *r1, *r2;
  A *cp, *tj, *tv, *dq, *wq, *gk, *v, *res2;
  double* red;
};

static_assert(AL_MAX_G * sizeof(AlView<double, double>) <= 1024,
              "AlView outgrows AL_SMEM_BUDGET's margin");

// One thread of a rung group: its place, the rung's delta and d's spine
// part dp (dn = dp - c is written while dp is still read; the two swap
// after every correction). S slots a block.
template <typename T, bool STAGED, int S>
struct AlGroup {
  using A = AlAcc<T, STAGED>;
  const AlView<T, A>& V;
  int gt, lane, warp;
  A delta;
  A *dp, *dn;

  __device__ void sync() const {
    if (V.bar == 0) __syncthreads();
    else {
#if defined(__CUDA_ARCH__)
      asm volatile("bar.sync %0, %1;\n" ::"r"(V.bar), "r"(V.nt) : "memory");
#else
      VMP_NAMED_BARRIER(V.bar, V.nt);
#endif
    }
  }

  // first task >= t0 of this warp (tasks go round-robin over the warps)
  __device__ int first_task(int t0) const { return t0 + ((warp - t0) % V.nw + V.nw) % V.nw; }

  // this lane's part of (W d)_p, 8 lanes a row (sub: the lane's column
  // offset): Wpp's row and, at a state slot, the coupling to the blocks
  // of its step (at T under S = 4, to every block)
  __device__ A w_row(int p, int sub) const {
    const int np_ = V.D.np_, bq = V.D.bq, sw = AL_SW;
    const T* row = V.Wpp + size_t(p) * V.ld;
    const A* x = dp;
    A acc = 0;
#pragma unroll 4
    for (int c = sub; c < np_; c += sw) acc = al_fma(al_ld<T, STAGED>(row + c), x[c], acc);
    const int pi = V.pinfo[p];
    if (pi >= 0) {
      const int kb0 = pi >> 2, s = pi & 3, nO = V.D.nO;
      const T* wpq = V.Wpq;
      const A* xq = V.dq;
      for (int i = 0; i < nO; ++i)
        for (int c = sub; c < bq; c += sw)
          acc = al_fma(al_ld<T, STAGED>(wpq + ((kb0 + i) * S + s) * bq + c), xq[(kb0 + i) * bq + c],
                       acc);
    }
    if (S == 4 && p == 0) {
      const T* wpq = V.Wpq;
      const A* xq = V.dq;
      for (int kb = 0; kb < V.D.K; ++kb)
        for (int c = sub; c < bq; c += sw)
          acc = al_fma(al_ld<T, STAGED>(wpq + (kb * S + 3) * bq + c), xq[kb * bq + c], acc);
    }
    return acc;
  }

  // (W d)_q of entry c of block kb
  __device__ A w_block(int kb, int c) const {
    const int bq = V.D.bq, N1 = V.D.N + 1, s0 = V.bs0[kb];
    const T* wpq = V.Wpq;
    const A *x = dp, *xq = V.dq;
    A acc = 0;
    for (int s = 0; s < 3; ++s)
      acc = al_fma(al_ld<T, STAGED>(wpq + (kb * S + s) * bq + c), x[s0 + s * N1], acc);
    if (S == 4) acc = al_fma(al_ld<T, STAGED>(wpq + (kb * S + 3) * bq + c), x[0], acc);
    const T* row = V.Wqq + size_t(kb * bq + c) * V.ldB;
#pragma unroll 8
    for (int d = 0; d < bq; ++d) acc = al_fma(al_ld<T, STAGED>(row + d), xq[kb * bq + d], acc);
    return acc;
  }

  // pass rhs, first: tj = (JE^T r2)_p; refine: cp = W d + delta d,
  // tv = (JE^T v)_p, tj = (JE^T res2)_p. Per block bq (first r1 + JE^T
  // r2 / dd, refine (W d + delta d + JE^T v - r1) + JE^T res2 / dd), then
  // wq = Qi bq and gk = Gpq wq.
  __device__ void pass_rhs(bool refine) const {
    const int np_ = V.D.np_, K = V.D.K, mE_sp = V.D.mE_sp, sw = AL_SW, rpt = 32 / AL_SW;
    const int n_w = refine ? (np_ + rpt - 1) / rpt : 0;
    const int n_je = n_w + (np_ + 7) / 8;
    const int bpw = 32 / V.gw;
    const int n_task = n_je + (K + bpw - 1) / bpw;
    for (int task = warp; task < n_w; task += V.nw) {   // W's rows rpt task .. + rpt - 1
      const int p = rpt * task + lane / sw, sub = lane % sw;
      const A wv = al_xsum(p < np_ ? w_row(p, sub) : A(0), 1, sw >> 1);
      if (sub == 0 && p < np_) V.cp[p] = fma(delta, dp[p], wv);
    }
    {   // JE^T's outputs 8 (task - n_w) .. + 7: 8 lanes an output, 4 rows at a time
      const T *je = V.JE, *jth = V.JEth, *r2 = V.r2;
      const A *res2 = V.res2, *y2 = V.v;
      const int lds = V.ld, nO = V.D.nO;
      A *o = V.tj, *o2 = V.tv;
      // y: r2 (first) or res2 (refine)
      auto y = [&](int j) { return refine ? res2[j] : A(r2[j]); };
      const int seg = lane / 8;
      for (int task = first_task(n_w); task < n_je; task += V.nw) {
        const int p = 8 * (task - n_w) + lane % 8;
        A acc = 0, acc2 = 0;
        if (p < np_) {
#pragma unroll 4
          for (int j = seg; j < mE_sp; j += 4) {
            const T e = al_ld<T, STAGED>(je + size_t(j) * lds + p);
            acc = al_fma(e, y(j), acc);
            if (refine) acc2 = al_fma(e, y2[j], acc2);
          }
          const int pi = V.pinfo[p];
          if (seg == 0 && pi >= 0 && (pi & 3) == 2) {
            const int kb0 = pi >> 2;
            for (int i = 0; i < nO; ++i) {
              const int kb = kb0 + i;
              const T e0 = al_ld<T, STAGED>(jth + kb * 2), e1 = al_ld<T, STAGED>(jth + kb * 2 + 1);
              acc = al_fma(y(mE_sp + K + kb), e1, al_fma(y(mE_sp + kb), e0, acc));
              if (refine) acc2 = al_fma(y2[mE_sp + K + kb], e1, al_fma(y2[mE_sp + kb], e0, acc2));
            }
          }
        }
        acc = al_xsum(acc, 8, 16);
        if (refine) acc2 = al_xsum(acc2, 8, 16);
        if (seg == 0 && p < np_) {
          o[p] = acc;
          if (refine) o2[p] = acc2;
        }
      }
    }
    {   // blocks, gw lanes a block
      const int bq = V.D.bq, lb = V.ldB, g = V.gw;
      const T *jeq = V.JEq, *qi = V.Qi, *gpq = V.Gpq, *r2 = V.r2, *rr1 = V.r1;
      const A *res2 = V.res2, *y2 = V.v, *xq = V.dq;
      const A rdd = V.rdd;
      A *owq = V.wq, *ogk = V.gk;
      auto y = [&](int j) { return refine ? res2[j] : A(r2[j]); };
      for (int task = first_task(n_je); task < n_task; task += V.nw) {
        const int kb = (task - n_je) * bpw + lane / g, c = lane & (g - 1);
        const bool ok = kb < K && c < bq;
        A bqc = 0;
        if (ok) {
          const T e0 = al_ld<T, STAGED>(jeq + (kb * 2) * bq + c);
          const T e1 = al_ld<T, STAGED>(jeq + (kb * 2 + 1) * bq + c);
          const A jr = al_fma(y(mE_sp + K + kb), e1, al_fma(y(mE_sp + kb), e0, A(0)));
          const A r1q = rr1[q_flat(V.D, kb, c)];
          if (refine) {
            const A jv = al_fma(y2[mE_sp + K + kb], e1, al_fma(y2[mE_sp + kb], e0, A(0)));
            bqc = ((fma(delta, xq[kb * bq + c], w_block(kb, c)) + jv) - r1q) + jr * rdd;
          } else {
            bqc = r1q + jr * rdd;
          }
        }
        const int base = lane & ~(g - 1);
        const T* qrow = qi + size_t(ok ? kb * bq + c : 0) * lb;
        A w = 0;
#pragma unroll 8
        for (int d = 0; d < bq; ++d) {
          const A bd = __shfl_sync(AL_FULL, bqc, base + d);
          if (ok) w = al_fma(al_ld<T, STAGED>(qrow + d), bd, w);
        }
        if (ok) owq[kb * bq + c] = w;
        for (int s = 0; s < S; ++s) {
          const A gs =
              al_xsum(ok ? al_fma(al_ld<T, STAGED>(gpq + (kb * S + s) * bq + c), w, A(0)) : A(0), 1,
                      g >> 1);
          if (ok && c == s) ogk[kb * S + s] = gs;
        }
      }
    }
    sync();
  }

  // pass rp: tj = b - slot_add(gk), b = r1 + tj / dd (first) or
  // ((cp + tv) - r1) + tj / dd
  __device__ void pass_rp(bool refine) const {
    const int np_ = V.D.np_, nO = V.D.nO;
    const A *a = V.cp, *av = V.tv, *g = V.gk;
    const T* rr1 = V.r1;
    const A rdd = V.rdd;
    A* o = V.tj;
    for (int p = gt; p < np_; p += V.nt) {
      const A r = rr1[p_flat(V.D, p)];
      A b = refine ? ((a[p] + av[p]) - r) + o[p] * rdd : r + o[p] * rdd;
      const int pi = V.pinfo[p];
      if (pi >= 0) {
        const int kb0 = pi >> 2, s = pi & 3;
        A gs = 0;
        for (int i = 0; i < nO; ++i) gs += g[(kb0 + i) * S + s];
        b -= gs;
      } else if (S == 4 && p == 0) {   // T: every block's slot 3
        A gs = 0;
        for (int kb = 0; kb < V.D.K; ++kb) gs += g[kb * S + 3];
        b -= gs;
      }
      o[p] = b;
    }
    sync();
  }

  // pass spine: out = Si rp, summed in float64 whatever A: near a singular
  // spine Si's large entries cancel against rp's (PERF.md §6)
  __device__ void pass_spine(A* out) const {
    const int np_ = V.D.np_, sw = AL_SW, rpt = 32 / AL_SW, sub = lane % sw, lds = V.ld;
    const T* si = V.Si;
    const A* x = V.tj;
    for (int task = warp; task < (np_ + rpt - 1) / rpt; task += V.nw) {
      const int p = rpt * task + lane / sw;
      double acc = 0;
      if (p < np_) {
        const T* a = si + size_t(p) * lds;
#pragma unroll 4
        for (int c = sub; c < np_; c += sw) acc = al_fma(al_ld<T, STAGED>(a + c), x[c], acc);
      }
      acc = al_xsum(acc, 1, sw >> 1);
      if (sub == 0 && p < np_) out[p] = A(acc);
    }
    sync();
  }

  // row m of JE x is om_m (and of JE (d - x), refine, on_m): the first
  // solve's v, om, res2, or a correction's update of them
  __device__ void row_update(bool refine, int m, A om_m, A on_m) const {
    const A r = V.r2[m], rdd = V.rdd;
    A vm, o;
    if (!refine) {
      vm = (om_m - r) * rdd;
      o = om_m;
    } else {
      vm = V.v[m] - (om_m - V.res2[m]) * rdd;
      o = on_m;
    }
    V.v[m] = vm;
    V.res2[m] = (o - V.delta_d * vm) - r;
  }

  // pass finish: x = dp (first) or c's p part (refine); dq = wq - Yq
  // x_slots (or dq -= it), JE x row by row; refine also dn = dp - x and
  // JE dn
  __device__ void pass_finish(bool refine, const A* x) const {
    const int np_ = V.D.np_, K = V.D.K, mE_sp = V.D.mE_sp, sw = AL_SW, rpt = 32 / AL_SW;
    const int sub = lane % sw;
    const int n_sp = (mE_sp + rpt - 1) / rpt;
    const int bpw = 32 / V.gw;
    const int n_task = n_sp + (K + bpw - 1) / bpw;
    {   // JE's spine rows rpt task .. + rpt - 1
      const T* je = V.JE;
      const A* d = dp;
      const int lds = V.ld;
      for (int task = warp; task < n_sp; task += V.nw) {
        const int r = rpt * task + lane / sw;
        A a = 0, an = 0;
        if (r < mE_sp) {
          const T* row = je + size_t(r) * lds;
#pragma unroll 4
          for (int c = sub; c < np_; c += sw) {
            const T e = al_ld<T, STAGED>(row + c);
            a = al_fma(e, x[c], a);
            if (refine) an = al_fma(e, d[c] - x[c], an);
          }
        }
        a = al_xsum(a, 1, sw >> 1);
        if (refine) an = al_xsum(an, 1, sw >> 1);
        if (sub == 0 && r < mE_sp) row_update(refine, r, a, an);
      }
    }
    {   // blocks, gw lanes a block
      const int bq = V.D.bq, N1 = V.D.N + 1, g = V.gw;
      const T *yq = V.Yq, *jeq = V.JEq, *jth = V.JEth;
      const A *w = V.wq, *d = dp;
      A* xq = V.dq;
      for (int task = first_task(n_sp); task < n_task; task += V.nw) {
        const int kb = (task - n_sp) * bpw + lane / g, c = lane & (g - 1);
        const bool ok = kb < K && c < bq;
        const int s0 = ok ? V.bs0[kb] : 0;
        A cq = 0, nq = 0;
        if (ok) {
          const T* yr = yq + size_t(kb * bq + c) * S;
          A ys = 0;
          for (int s = 0; s < 3; ++s) ys = al_fma(al_ld<T, STAGED>(yr + s), x[s0 + s * N1], ys);
          if (S == 4) ys = al_fma(al_ld<T, STAGED>(yr + 3), x[0], ys);
          cq = w[kb * bq + c] - ys;
          nq = refine ? xq[kb * bq + c] - cq : cq;
          xq[kb * bq + c] = nq;
        }
        for (int rr = 0; rr < 2; ++rr) {
          const T e = ok ? al_ld<T, STAGED>(jeq + (kb * 2 + rr) * bq + c) : T(0);
          const A m = al_xsum(al_fma(e, cq, A(0)), 1, g >> 1);
          const A mn = refine ? al_xsum(al_fma(e, nq, A(0)), 1, g >> 1) : A(0);
          if (ok && c == rr) {
            const T th = al_ld<T, STAGED>(jth + kb * 2 + rr);
            const A xs = x[s0 + 2 * N1];
            row_update(refine, mE_sp + rr * K + kb, al_fma(th, xs, m),
                       refine ? al_fma(th, d[s0 + 2 * N1] - xs, mn) : A(0));
          }
        }
      }
    }
    if (refine) {
      const A* d = dp;
      A* o = dn;
      for (int p = gt; p < np_; p += V.nt) o[p] = d[p] - x[p];
    }
    sync();
  }

  // the curvature test and sol in flat order, both on sol's values in T;
  // thread 0 of the group writes good
  __device__ void pass_curvature(T* so, unsigned char* good) const {
    const int np_ = V.D.np_, K = V.D.K, bq = V.D.bq, mE = V.D.mE, n = V.D.n;
    const int sw = AL_SW, rpt = 32 / AL_SW, sub = lane % sw;
    const int n_sp = (np_ + rpt - 1) / rpt;
    const int bpw = 32 / V.gw;
    const int n_task = n_sp + (K + bpw - 1) / bpw;
    // sol, its values rounded to T in place: W and the curvature read d
    // as sol holds it
    const A *xp = dp, *xq = V.dq, *xv = V.v;
    for (int p = gt; p < np_; p += V.nt) {
      const T val = T(dp[p]);
      so[p_flat(V.D, p)] = val;
      dp[p] = val;
    }
    for (int m = gt; m < mE; m += V.nt) {
      const T val = T(V.v[m]);
      so[n + m] = val;
      V.v[m] = val;
    }
    const int gw = V.gw, cq = gt & (gw - 1);   // gw threads a block, a thread an entry
    if (cq < bq)
      for (int kb = gt / gw; kb < K; kb += V.nt / gw) {
        const T val = T(V.dq[kb * bq + cq]);
        so[q_flat(V.D, kb, cq)] = val;
        V.dq[kb * bq + cq] = val;
      }
    sync();
    A bad = 0, s1 = 0, s2 = 0;
    for (int task = warp; task < n_sp; task += V.nw) {
      const int p = rpt * task + lane / sw;
      const A wv = al_xsum(p < np_ ? w_row(p, sub) : A(0), 1, sw >> 1);
      if (sub == 0 && p < np_) {
        const A d = xp[p];
        s1 = fma(d, wv, s1);
        s2 = fma(d, d, s2);
        bad += isfinite(d) ? A(0) : A(1);
      }
    }
    for (int task = first_task(n_sp); task < n_task; task += V.nw) {
      const int kb = (task - n_sp) * bpw + lane / V.gw, c = lane & (V.gw - 1);
      if (kb < K && c < bq) {
        const A d = xq[kb * bq + c];
        s1 = fma(d, w_block(kb, c), s1);
        s2 = fma(d, d, s2);
        bad += isfinite(d) ? A(0) : A(1);
      }
    }
    for (int m = gt; m < mE; m += V.nt) bad += isfinite(xv[m]) ? A(0) : A(1);
    bad = al_xsum(bad, 1, 16);
    s1 = al_xsum(s1, 1, 16);
    s2 = al_xsum(s2, 1, 16);
    if (lane == 0) {
      V.red[warp * 3] = bad;
      V.red[warp * 3 + 1] = s1;
      V.red[warp * 3 + 2] = s2;
    }
    sync();
    if (gt == 0) {
      A b = 0, a1 = 0, a2 = 0;
      for (int w = 0; w < V.nw; ++w) {
        b += V.red[w * 3];
        a1 += V.red[w * 3 + 1];
        a2 += V.red[w * 3 + 2];
      }
      *good = (b == A(0)) && (fma(delta, a2, a1) > A(0));
    }
  }
};

template <typename T, bool STAGED, int S>
__global__ void __launch_bounds__(1024, 1)
    newton_al_solve_kernel(AlArgs<T> a, Dims D, AlRoute rt, int R, int n_refine, T dd, T delta_d) {
  extern __shared__ double smem_raw[];
  using A = AlAcc<T, STAGED>;
  __shared__ AlView<T, A> views[AL_MAX_G];
  const int lane_b = blockIdx.x / rt.ctas, cta = blockIdx.x - lane_b * rt.ctas;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int np_ = D.np_, K = D.K, bq = D.bq, mE = D.mE;
  const int g = tid / rt.threads, gt = tid - g * rt.threads;
  AlView<T, A>& V = views[g];
  const size_t oK2 = size_t(lane_b) * K * 2, oKBS = size_t(lane_b) * K * S * bq;
  const T* gJE = a.JE + size_t(lane_b) * D.mE_sp * np_;
  const T* gJEth = a.JEth + oK2;
  const T* gJEq = a.JEq + oK2 * bq;
  const T* gWpp = a.Wpp + size_t(lane_b) * np_ * np_;
  const T* gWpq = a.Wpq + oKBS;
  const T* gWqq = a.Wqq + size_t(lane_b) * K * bq * bq;
  const T* gGpq = a.Gpq + oKBS;
  const T* gr1 = a.rhs1 + size_t(lane_b) * D.n;
  const T* gr2 = a.rhs2 + size_t(lane_b) * mE;

  SmemArena ar(smem_raw);
  int* pinfo = ar.take<int>(np_);
  int* bs0 = ar.take<int>(K);
  for (int p = tid; p < np_; p += nthr) {
    int s, t;
    pinfo[p] = pos_slot(D, p, s, t) && t >= D.k_lo ? (t - D.k_lo) * D.nO * 4 + s : -1;
  }
  for (int kb = tid; kb < K; kb += nthr) bs0[kb] = xpos(D, 0, D.k_lo + kb / D.nO);
  if (gt == 0) {
    V.pinfo = pinfo;
    V.bs0 = bs0;
    V.D = D;
    V.nt = rt.threads;
    V.nw = rt.threads >> 5;
    V.bar = rt.groups == 1 ? 0 : 1 + g;
    V.gw = bq <= 8 ? 8 : (bq <= 16 ? 16 : 32);
    V.ld = rt.ld;
    V.ldB = rt.ldB;
    V.rdd = A(1) / A(dd);
    V.delta_d = delta_d;
  }
  if (STAGED) {
    T* JE = ar.take<T>(D.mE_sp * rt.ld);
    T* JEth = ar.take<T>(2 * K);
    T* JEq = ar.take<T>(2 * K * bq);
    T* Wpp = ar.take<T>(np_ * rt.ld);
    T* Wpq = ar.take<T>(S * K * bq);
    T* Wqq = ar.take<T>(K * bq * rt.ldB);
    T* Gpq = ar.take<T>(S * K * bq);
    T* r1 = ar.take<T>(D.n);
    T* r2 = ar.take<T>(mE);
    al_stage(JE, gJE, D.mE_sp, np_, rt.ld, tid, nthr);
    al_stage(JEth, gJEth, 1, 2 * K, 2 * K, tid, nthr);
    al_stage(JEq, gJEq, 1, 2 * K * bq, 2 * K * bq, tid, nthr);
    al_stage(Wpp, gWpp, np_, np_, rt.ld, tid, nthr);
    al_stage(Wpq, gWpq, 1, S * K * bq, S * K * bq, tid, nthr);
    al_stage(Wqq, gWqq, K * bq, bq, rt.ldB, tid, nthr);
    al_stage(Gpq, gGpq, 1, S * K * bq, S * K * bq, tid, nthr);
    al_stage(r1, gr1, 1, D.n, D.n, tid, nthr);
    al_stage(r2, gr2, 1, mE, mE, tid, nthr);
    if (gt == 0) {
      V.JE = JE; V.JEth = JEth; V.JEq = JEq; V.Wpp = Wpp; V.Wpq = Wpq; V.Wqq = Wqq;
      V.Gpq = Gpq; V.r1 = r1; V.r2 = r2;
    }
  } else if (gt == 0) {
    V.JE = gJE; V.JEth = gJEth; V.JEq = gJEq; V.Wpp = gWpp; V.Wpq = gWpq; V.Wqq = gWqq;
    V.Gpq = gGpq; V.r1 = gr1; V.r2 = gr2;
  }
  // each group's rung operands (staged) and vectors, group after group
  T *sQi = nullptr, *sYq = nullptr, *sSi = nullptr;
  A *dp = nullptr, *dn = nullptr;
  for (int h = 0; h < rt.groups; ++h) {
    T *Qi = nullptr, *Yq = nullptr, *Si = nullptr;
    if (STAGED) {
      Qi = ar.take<T>(K * bq * rt.ldB);
      Yq = ar.take<T>(K * bq * S);
      Si = ar.take<T>(np_ * rt.ld);
    }
    A* dp_h = ar.take<A>(np_);
    A* dn_h = ar.take<A>(np_);
    A* cp = ar.take<A>(np_);
    A* tj = ar.take<A>(np_);
    A* tv = ar.take<A>(np_);
    A* dq = ar.take<A>(K * bq);
    A* wq = ar.take<A>(K * bq);
    A* gk = ar.take<A>(S * K);
    A* v = ar.take<A>(mE);
    A* res2 = ar.take<A>(mE);
    double* red = ar.take<double>(3 * 32);
    if (h == g) {
      sQi = Qi; sYq = Yq; sSi = Si; dp = dp_h; dn = dn_h;
      if (gt == 0) {
        V.cp = cp; V.tj = tj; V.tv = tv; V.dq = dq; V.wq = wq; V.gk = gk;
        V.v = v; V.res2 = res2; V.red = red;
        V.Qi = sQi; V.Yq = sYq; V.Si = sSi;
      }
    }
  }
  AlGroup<T, STAGED, S> c{V, gt, tid & 31, gt >> 5, A(0), dp, dn};

  const int j0 = cta * rt.groups + g;
  for (int j = j0; j < R; j += rt.ctas * rt.groups) {
    const size_t br = size_t(lane_b) * R + j;
    const T* gQi = a.Qi + br * K * bq * bq;
    const T* gYq = a.Yq + br * K * bq * S;
    const T* gSi = a.Si + br * np_ * np_;
    if (STAGED) {
      al_stage(sQi, gQi, K * bq, bq, rt.ldB, gt, rt.threads);
      al_stage(sYq, gYq, 1, K * bq * S, K * bq * S, gt, rt.threads);
      al_stage(sSi, gSi, np_, np_, rt.ld, gt, rt.threads);
      al_copy_wait();
    } else if (gt == 0) {
      V.Qi = gQi; V.Yq = gYq; V.Si = gSi;
    }
    if (j == j0) __syncthreads();   // the lane's operands and the views too, CTA-wide
    else c.sync();
    c.delta = a.ladder[br];
    c.pass_rhs(false);
    c.pass_rp(false);
    c.pass_spine(c.dp);
    c.pass_finish(false, c.dp);
    for (int it = 0; it < n_refine; ++it) {
      c.pass_rhs(true);
      c.pass_rp(true);
      c.pass_spine(V.cp);
      c.pass_finish(true, V.cp);
      A* t = c.dp;   // dn = dp - c becomes d
      c.dp = c.dn;
      c.dn = t;
    }
    c.pass_curvature(a.sol + br * (D.n + mE), a.good + br);
    // the next rung's staging overwrites Qi, Yq, Si (and the global route
    // its pointers): every read of them lies before the curvature pass's
    // barrier
  }
}

// ------------------------------------------------------------ launchers
template <typename T, int S>
static int launch_assemble(void** p, const long long* ints, double dd, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[VMP_DIMS_END]), w_only = int(ints[VMP_DIMS_END + 1]);
  Dims D;
  if (!dims_from(ints, D) || D.S != S || (w_only != 0 && w_only != 1)) return VMP_BAD_ARGS;
  AsmArgs<T> a{(const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4],
               (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8], (const T*)p[9],
               (const T*)p[10], (const T*)p[11], (const long long*)p[12],
               (T*)p[13], (T*)p[14], (T*)p[15], (T*)p[16], (T*)p[17], (T*)p[18]};
  if (B == 0) return 0;
  const int nT = (D.np_ + ASM_TILE - 1) / ASM_TILE;
  const int n_small = (D.K + ASM_SMALL_KB - 1) / ASM_SMALL_KB;
  auto kernel = newton_assemble_kernel<T, S>;   // a name with a comma cannot pass the macro
  VMP_LAUNCH(kernel, dim3(B, nT * (nT + 1) / 2 + n_small), 256, 0, st)(
      a, D, R, T(dd), w_only);
  return int(cudaGetLastError());
}

template <typename T, int S>
static int launch_schur(void** p, const long long* ints, cudaStream_t st) {
  const long long B = ints[1];
  const int R = int(ints[VMP_DIMS_END]);
  Dims D;
  if (!dims_from(ints, D) || D.S != S || R < 0 || B < 0) return VMP_BAD_ARGS;
  SchurPlan P;
  const int rc = schur_plan(D, R, B, sizeof(T), P);
  if (rc) return rc;
  if (ints[VMP_DIMS_END + 1] != P.rows || ints[VMP_DIMS_END + 2] != P.table)
    return VMP_BAD_ARGS;   // the wrapper's plan
  auto kernel = newton_schur_kernel<T, S>;
  cudaError_t e = vmp_allow_smem(kernel, P.smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0 || R == 0) return 0;
  VMP_LAUNCH(kernel, dim3(unsigned(B), unsigned(P.tiles)), P.threads, P.smem,
             st)((const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (T*)p[4],
                 (T*)p[5], (const int*)p[6], D, R, P.rows, P.max_steps, P.max_crows);
  return int(cudaGetLastError());
}

template <typename T, int S>
static int launch_al_solve(void** p, const long long* ints, const double* reals, cudaStream_t st) {
  const int B = int(ints[1]), R = int(ints[VMP_DIMS_END]), n_refine = int(ints[VMP_DIMS_END + 1]);
  Dims D;
  if (!dims_from(ints, D) || D.S != S || R < 1 || n_refine < 0) return VMP_BAD_ARGS;
  const AlRoute rt = al_route(D, R, sizeof(T));
  if (rt.smem > AL_SMEM_BUDGET) return VMP_TOO_LARGE;
  AlArgs<T> a{(const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3], (const T*)p[4],
              (const T*)p[5], (const T*)p[6], (const T*)p[7], (const T*)p[8], (const T*)p[9],
              (const T*)p[10], (const T*)p[11], (const T*)p[12], (T*)p[13],
              (unsigned char*)p[14]};
  void (*kernel)(AlArgs<T>, Dims, AlRoute, int, int, T, T) =
      rt.staged ? newton_al_solve_kernel<T, true, S> : newton_al_solve_kernel<T, false, S>;
  cudaError_t e = vmp_allow_smem(kernel, rt.smem);
  if (e != cudaSuccess) return int(e);
  if (B == 0) return 0;
  VMP_LAUNCH(kernel, B * rt.ctas, rt.groups * rt.threads, rt.smem, st)(a, D, rt, R, n_refine,
                                                                         T(reals[0]),
                                                              T(reals[1]));
  return int(cudaGetLastError());
}

// The launcher of dtype ints[0] and S = ints[10] (dims' S): its result, or
// VMP_BAD_DTYPE
#define NEWTON_DISPATCH(launch, ...)                                                       \
  do {                                                                                     \
    const bool s4 = ints[10] == 4;                                                         \
    if (ints[0] == 0) return s4 ? launch<float, 4>(__VA_ARGS__) : launch<float, 3>(__VA_ARGS__);     \
    if (ints[0] == 1) return s4 ? launch<double, 4>(__VA_ARGS__) : launch<double, 3>(__VA_ARGS__);   \
    return VMP_BAD_DTYPE;                                                                  \
  } while (0)

// ptrs: Hpp, Hpq_c, Hqq, JE_sp, JEb_th, JEb_q, JD_sp, JDb_p, JDb_q, sigma,
//       sgn_eff, ladder, id_p_pos (int64) | Wpp, Wpq, Wqq, Gpp0, Gpq0, Gqq
//       (the G outputs are not written with w_only)
// ints: dtype, B, dims (common.cuh dims_from), R, w_only (0/1);  reals: dd
VMP_ENTRY(newton_assemble) {
  if (nptr != 19 || nint != VMP_DIMS_END + 2 || nreal != 1) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NEWTON_DISPATCH(launch_assemble, ptrs, ints, reals[0], st);
}

// ptrs: Qinv, Gpq0, Gpp0, ladder | Yq, S | the tile plan (int32,
//       solver/newton.py schur_tile_plan)
// ints: dtype, B, dims (common.cuh dims_from), R, rows a tile, the plan's
//       ints (both as newton_schur_plan_info gives them)
VMP_ENTRY(newton_schur) {
  if (nptr != 7 || nint != VMP_DIMS_END + 3 || nreal != 0) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NEWTON_DISPATCH(launch_schur, ptrs, ints, st);
}

// ptrs: JE_sp, JEb_th, JEb_q, Wpp, Wpq, Wqq, Gpq0, Qinv, Yq, Sinv, rhs1,
//       rhs2, ladder | sol, good (uint8)
// ints: dtype, B, dims (common.cuh dims_from), R, n_refine;  reals: dd, delta_d
VMP_ENTRY(newton_al_solve) {
  if (nptr != 15 || nint != VMP_DIMS_END + 2 || nreal != 2) return VMP_BAD_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  NEWTON_DISPATCH(launch_al_solve, ptrs, ints, reals, st);
}

// The plan of newton_schur for its first VMP_DIMS_END + 1 ints (dtype, B,
// dims, R) as out = {tiles a lane, rows a tile, threads, smem, max steps a
// tile, max clique rows a tile, steps, clique rows, the plan table's
// ints}, for kernels.schur_launch_plan; VMP_TOO_LARGE where a tile of one
// row does not fit.
extern "C" int newton_schur_plan_info(const long long* ints, int nint, long long* out) {
  Dims D;
  if (nint < VMP_DIMS_END + 1 || !dims_from(ints, D) || ints[VMP_DIMS_END] < 0 || ints[1] < 0)
    return VMP_BAD_ARGS;
  if (ints[0] != 0 && ints[0] != 1) return VMP_BAD_DTYPE;
  SchurPlan P;
  const int rc = schur_plan(D, int(ints[VMP_DIMS_END]), ints[1],
                            ints[0] == 0 ? sizeof(float) : sizeof(double), P);
  if (rc) return rc;
  out[0] = P.tiles;
  out[1] = P.rows;
  out[2] = P.threads;
  out[3] = (long long)P.smem;
  out[4] = P.max_steps;
  out[5] = P.max_crows;
  out[6] = P.total_steps;
  out[7] = P.total_crows;
  out[8] = P.table;
  return 0;
}

// The route of newton_al_solve for its first VMP_DIMS_END + 1 ints (dtype,
// B, dims, R) as out = {staged, ctas, groups, threads, smem}, for
// kernels.al_solve_route to be checked against; VMP_TOO_LARGE where it
// does not fit.
extern "C" int newton_al_route_info(const long long* ints, int nint, long long* out) {
  Dims D;
  if (nint < VMP_DIMS_END + 1 || !dims_from(ints, D) || ints[VMP_DIMS_END] < 1) return VMP_BAD_ARGS;
  if (ints[0] != 0 && ints[0] != 1) return VMP_BAD_DTYPE;
  const AlRoute r = al_route(D, int(ints[VMP_DIMS_END]), ints[0] == 0 ? sizeof(float) : sizeof(double));
  out[0] = r.staged;
  out[1] = r.ctas;
  out[2] = r.groups;
  out[3] = r.threads;
  out[4] = (long long)r.smem;
  if (r.smem > AL_SMEM_BUDGET) return VMP_TOO_LARGE;
  return 0;
}

// Fused ResnetFC forward for Hopper (sm_90a), four entry points:
//
//   resnetfc_fwd_dense      replaces pixelnerf_tpu/ops/resnetfc_pallas.py::_kernel_2d
//   resnetfc_fwd_gather     replaces pixelnerf_tpu/ops/resnetfc_pallas.py::_kernel_2d_gather
//   resnetfc_fwd_dense_mv   replaces pixelnerf_tpu/ops/resnetfc_pallas.py::_kernel_2d_mv
//   resnetfc_fwd_gather_mv  replaces pixelnerf_tpu/ops/resnetfc_pallas.py::_kernel_2d_mv_gather
//
// Each takes the deferred positional code's operands (code_w, code_f, code_p,
// code_m, d_raw): null code_w means x is the encoded code, as before; else x
// is the raw (rows, d_raw) f32 coordinates and the kernel's CODE variant
// evaluates the code while loading each tile, the port of
// resnetfc_pallas.py::_x_feat (fused_code).  The code adds 2 d_raw d_in FLOP
// and d_in sinf a point (~0.5 KFLOP at sn64) to the tower's ~6.9 MFLOP, and
// reads 24 raw bytes a point where the encoded code is 168: it does not move
// the bound.
//
// What bounds them: ~6.86 MFLOP per point at sn64 widths (H=512, 5 blocks,
// 3 latent injections), and NS = 3 views ~16.4 MFLOP per output point,
// against ~0.1 KB of input per point and view, so the tower is bound by
// tensor-core operations, not device memory.  What holds a kernel back is
// the weights' trip from L2 (~6.9 MB bf16 at sn64) into every SM: a tile of
// P points reads all of them once, so the traffic is (points / P) x 6.9 MB
// (at NS views, the layers below the view mean NS times).
//
// The four run one kernel body on the 64-point wgmma tile of tile64.cuh,
// which the backward's data kernel shares, so the backward's recompute takes
// its products in this body's order, at one view and at NS views:
// - one CTA of two warpgroups a 64-point tile, each warpgroup owning 256 of
//   the 512 columns of the f32 stream in registers; every product is wgmma
//   m64n128k16 pieces with operand A a 64 x 512 bf16 swizzled tile in shared
//   memory (the code, the latent, relu(x) or relu(fc_0)) and operand B
//   64 x 64 TMA boxes of the packed row-major weights (MN-major for x W)
//   through a 3-stage, 32 KB ring.  Each warpgroup keeps its own half of
//   every stage (the boxes of its piece) fed: its first thread refills the
//   half as soon as the warpgroup's four warps have read it (one arrival a
//   warp), so neither warpgroup waits for the other's.  A tile reads each
//   weight byte out of L2 once for 64 points;
// - the code comes by the threads (encoded: rounded to bf16; CODE: evaluated
//   as tile64.cuh says); the latent of each injection either by TMA from a
//   dense bf16 z (B, C) (the dense kernels; rows past B read as zeros) or,
//   in the gather kernels, as the 4-tap lookup z[g] = sum_{j<4} w[g, j] *
//   table[idx[g, j]] that the threads build straight into the operand tile
//   (gather_fill);
// - a dense latent wider than one operand tile (512 < C <= 1024: the global
//   encoder's code before the pixel latent, 640 at sn64) is injected in
//   pieces of at most 512 columns, each a step of the stored program whose
//   product adds to the f32 stream (the bias with the first piece), as the
//   TPU kernel's one K = C product is split; at C <= 512 the program and
//   its bits are those of one piece.  The gather kernels keep C <= 512;
// - lin_out (d_out <= 4) stays on the CUDA cores, a warp a point;
// - no atomics: two calls on the same inputs give the same bits.
// The weights' tensor maps are encoded once per set of weight addresses
// (resnetfc_fwd_dense_plan) and kept by the wrapper; the latent's is encoded
// per call.  What binds it on an H100 is the weights' stream into each SM
// (~30 GB/s an SM, ~4 TB/s in all): 96 KB of ring in flight is all the shared
// memory beside the two operand tiles.  Clusters of two CTAs sharing every
// weight box by TMA multicast halve the L2 reads but not that stream, and
// couple the pair's rings: they measured slower, and so did refills that do
// not wait.
//
// The gather kernels' lookup reads the (T, C) bf16 table (L2-resident: 1 MB
// at sn64) once an injection, since the two operand tiles and the ring leave
// no room to keep the latent: 64 points x 4 taps x 1 KB, 0.75 MB a tile at
// sn64 beside its 6.55 MB of weights.  The TPU kernel builds the lookup as a
// one-hot matmul and so rounds the tap weights to bf16; here they stay f32,
// a difference the on-card tolerance covers.  The taps are taken in the
// plain version's order and rounding (gather_reference: from +0, w_j t_j
// rounded, then added, j = 0..3), so a gather kernel's output is its dense
// twin's on that bf16 latent, bit for bit.
//
// The multi-view kernels (resnetfc_fwd_dense_mv, resnetfc_fwd_gather_mv) run
// the forward half of the data kernel's multi-view program on the same tile:
// per view v its lin_in, injections and blocks k < pre, then FOLD into the
// view sum; then the shared blocks and lin_out.  One view's steps are stored
// once and walked NS times (tile64.cuh), so any view count up to 255 fits
// the program.  The mean is the TPU kernel's sum(xs) * (1 / NS): an f32 sum
// in view order, then one multiply.  Their CTAs are persistent (one an SM at
// most), each walking its tiles with a 128 KB device-memory slot for the
// view sum (the 64 x 512 f32 stream, each thread coalesced on its own words;
// 16.5 MB over 132 SMs, L2-resident beside the weights), and each
// warpgroup's feeder runs on from the last stage of a tile into the next
// tile's first, so the ring does not drain between tiles.  Input rows are
// object-major (tile64.cuh, src_row): in the dense kernel a tile inside one
// object reads each view's latent as one TMA box of 64 rows; a tile whose
// points straddle two objects (or end past B) reads two runs of rows, so the
// threads load it (~5% slower than TMA on an H100).  The multi-view gather
// takes one object (SB = 1) and builds view v's latent from table v with
// gather_fill.  A 64-point tile at NS views streams the layers below the
// mean NS times (15.6 MiB of weights at sn64 and NS = 3, 2.4x the one-view
// tile's 6.55 MiB); that stream binds it as it binds the one-view kernels
// (~29 GB/s an SM on an H100), and the latent fills add ~7%.

#include <string.h>

#include "tile64.cuh"

namespace {

using namespace rfc;

// Attach the code operands (code_w null: x is the encoded code); returns
// whether the CODE variant runs, or -1 for an incomplete set.
int attach_code(TowerParams& p, const void* code_w, const void* code_f, const void* code_p,
                const void* code_m, int d_raw) {
  if (code_w == nullptr) return 0;
  if (code_f == nullptr || code_p == nullptr || code_m == nullptr || d_raw < 1) return -1;
  p.code_w = static_cast<const float*>(code_w);
  p.code_f = static_cast<const float*>(code_f);
  p.code_p = static_cast<const float*>(code_p);
  p.code_m = static_cast<const float*>(code_m);
  p.d_raw = d_raw;
  return 1;
}

// ---------------------------------------------------------------------------
// the tile kernels: 64-point wgmma tiles, weights by TMA
// ---------------------------------------------------------------------------

// steps of a tile's stored program (fwd_program; sn64: 14 at one view, 15 at
// any view count: one view's segment and the shared blocks)
constexpr int F_MAX_STEPS = 128;
constexpr int F_MAX_K = HID;  // the widest code, and a latent's widest piece: one 64 x 512 operand tile
// the widest latent: an injection of a latent wider than one operand tile
// runs as pieces of at most HID columns (latent_pieces), each a step of its
// own that adds its product to the f32 stream
constexpr int F_MAX_C = 2 * HID;
// f32 words of a multi-view CTA's view-sum slot: every thread's share of the
// 64 x 512 stream (128 KB)
constexpr int F_SLOT_FLOATS = TILE_STREAM * TILE_THREADS;

// The weights' tensor maps (64 x 64 boxes of w_in (kin, H), w_z (n_lin_z C,
// H) and w_blk (2 n_blocks H, H)) and what they were encoded for: built once
// per set of weight addresses by resnetfc_fwd_dense_plan.
struct DensePlan {
  CUtensorMap m_in, m_z, m_blk;
  const void *w_in, *w_z, *w_blk;
  int kin, C, n_blocks, n_lin_z;
};

struct DenseParams {
  TowerParams t;  // the gather kernels: also idx, w, table, T, taps; multi-view: NS, B_obj, pre, vsum
  CUtensorMap m_in, m_z, m_blk;
  // the dense kernels' z in 64 x 64 boxes: (B, C), rows past B read as zeros;
  // multi-view (NS B, C), read only by tiles inside one object
  CUtensorMap m_lat;
};

// The pieces of HID columns an injection of a C-wide latent takes (1 up to
// C = 512; 0 without a latent).
__host__ __device__ inline int latent_pieces(int C) { return (C + HID - 1) / HID; }

// The tile's program as stored: lin_in, then per block k < pre its injection
// (k < n_lin_z; one Z_FWD step a piece of the latent, aux the piece), fc_0
// and fc_1, and, multi-view (mv), the fold into the view mean -- one view's
// segment, which the walk takes NS times (one view: pre = n_blocks) -- then
// the shared blocks k >= pre.
// Walked, it is the forward half of the data kernel's program
// (data_program), in its order and with its aux flags, when the latent is one
// piece (C <= 512: the data kernel takes only C = 512).
__host__ __device__ inline int fwd_program(int* out, int n_blocks, int n_lin_z, bool mv, int pre,
                                           int pieces) {
  int n = 0;
  auto put = [&](int s) {
    if (out != nullptr) out[n] = s;
    ++n;
  };
  // block 0 reads relu(x) directly when no latent is injected first
  put(step(IN_FWD, 0, n_lin_z == 0 && pre > 0));
  for (int k = 0; k < pre; ++k) {
    if (k < n_lin_z)
      for (int j = 0; j < pieces; ++j) put(step(Z_FWD, k, j));
    put(step(B0_FWD, k, 0));
    // the next reader of relu(x) is fc_0 of block k + 1 (or lin_out) unless
    // block k + 1 injects the latent first, or the view mean comes next
    put(step(B1_FWD, k, k + 1 >= n_lin_z && (k + 1 < pre || !mv)));
  }
  if (mv) put(step(FOLD, 0, 0));
  for (int k = pre; k < n_blocks; ++k) {
    put(step(B0_FWD, k, 0));
    put(step(B1_FWD, k, 1));
  }
  return n;
}

// The weight operand of a forward product step: tile64.cuh's gemm_of, but in
// the dense kernels (WIDE) an injection's piece j (aux) reads rows j HID.. of
// W_z[k], at most HID of them.  The gather kernels' latent is one piece, and
// they decode as the data kernel does (the decoding costs the multi-view
// gather's CODE twin a spill).
template <bool WIDE>
__device__ __forceinline__ Gemm fwd_gemm_of(int s, int kin, int C) {
  if (WIDE && step_kind(s) == Z_FWD) {
    const int off = step_aux(s) * HID;
    return Gemm{1, 0, step_k(s) * C + off, min(HID, C - off)};
  }
  return gemm_of(s, kin, C);
}

// A feeding state, which only a warpgroup's first thread keeps (in shared
// memory, so that no other thread holds registers for it): the next stage is
// step g, piece pc, K rows ks * 64...  Multi-view, g indexes the program's
// products only (f_gprog), which the feeder walks as the threads walk the
// program: the view segment's products once for each view, then the shared
// blocks', then on into the CTA's next tile.
struct DenseFeed {
  int g, pc, ks;
};

// A warpgroup's half of a ring stage: the weight boxes of its piece.
constexpr uint32_t HALF_BYTES = TILE_BPW * BOX_BYTES;

// Shared state beside the dynamic operand tiles and ring, at fixed addresses:
// each warpgroup's full / empty mbarriers of its halves of the ring stages
// (empty: one arrival a warp of the warpgroup) and its feeding state; the
// latent's mbarrier (the dense kernels' TMA latent; the gather kernels never
// arm it); the program.  Multi-view also: the program's products alone
// (what the feeders walk: the fold has none) and how many of them the view
// segment holds, each feeder's tiles still to feed and views still to come
// after its current one, the current tile's first row and the latents taken
// by TMA so far (the parity of f_lat_full's next phase), read where used
// rather than kept in registers.  The feeders' work
// lies on the products' path (a warpgroup's first thread feeds before it
// issues its next product), so theirs is kept short: no division, no step to
// skip (feeders that found their step by a division a stage made the kernel
// 1.19x slower on an H100).
__shared__ __align__(8) uint64_t f_full[2][RING_STAGES], f_empty[2][RING_STAGES], f_lat_full;
__shared__ int f_prog[F_MAX_STEPS], f_gprog[F_MAX_STEPS];
__shared__ int f_n_steps, f_n_gemms, f_seg_gemms, f_end;
__shared__ DenseFeed f_feed[2];
__shared__ int f_left[2], f_vleft[2], f_row0, f_lat_n;

// Thread 128 h: warpgroup h's half of the next stage into ring slot `slot`
// -- the weight boxes of its piece pc, K rows rowbase + ks * 64.. -- on
// full[h].
template <bool MV, bool WIDE>
__device__ __forceinline__ void dense_feed(const DenseParams& q, unsigned char* ring, int slot, int h) {
  DenseFeed f = f_feed[h];
  if (MV ? f_left[h] == 0 : f.g >= f_n_steps) return;  // the CTA's last stage is in
  const Gemm op = fwd_gemm_of<WIDE>(MV ? f_gprog[f.g] : f_prog[f.g], q.t.kin, q.t.C);
  const CUtensorMap* m = op.map == 0 ? &q.m_in : op.map == 1 ? &q.m_z : &q.m_blk;
  hopper::mbar_arrive_expect_tx(&f_full[h][slot], HALF_BYTES);
  unsigned char* dst = ring + slot * STAGE_BYTES + h * HALF_BYTES;
#pragma unroll
  for (int b = 0; b < TILE_BPW; ++b)
    hopper::tma_load_2d(dst + b * BOX_BYTES, m, &f_full[h][slot],
                        h * TILE_HALF + f.pc * TILE_PIECE + b * 64, op.rowbase + f.ks * 64);
  if (++f.ks * 64 >= op.K) {
    f.ks = 0;
    if (++f.pc == TILE_NP) {
      f.pc = 0;
      ++f.g;
      if (MV) {
        if (f.g == f_seg_gemms && f_vleft[h] > 0) {  // the next view's segment
          f.g = 0;
          --f_vleft[h];
        } else if (f.g == f_n_gemms) {  // on into the CTA's next tile
          f.g = 0;
          f_vleft[h] = q.t.NS - 1;
          --f_left[h];
        }
      }
    }
  }
  f_feed[h] = f;
}

// Stage u is read by this warp: it arrives on its warpgroup's empty barrier
// of the stage; the warpgroup's first thread waits until its four warps have,
// and loads the warpgroup's half of stage u + RING_STAGES into the slot.  So
// each warpgroup keeps its own half of the ring fed, and neither waits for
// the other's warps.
template <bool MV, bool WIDE>
__device__ __forceinline__ void dense_release(const DenseParams& q, unsigned char* ring, uint32_t u) {
  const int slot = u % RING_STAGES, h = threadIdx.x >> 7;
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&f_empty[h][slot]);
  if ((threadIdx.x & 127) == 0) {
    hopper::mbar_wait(&f_empty[h][slot], (u / RING_STAGES) & 1);
    dense_feed<MV, WIDE>(q, ring, slot, h);
  }
}

// For each piece of this warpgroup's columns, acc = A . B over K (A a
// swizzled (64, K) tile, B the ring's MN-major boxes), then epi(piece, acc):
// the pieces, k16 steps and stages of the data kernel's forward products.
template <bool MV, bool WIDE, typename Epi>
__device__ __forceinline__ void dense_gemm(const DenseParams& q, unsigned char* ring, uint32_t& it,
                                           const unsigned char* A, int K, Epi epi) {
  const int wg = threadIdx.x >> 7;
  const int nks = (K + 63) / 64;
#pragma unroll
  for (int pc = 0; pc < TILE_NP; ++pc) {
    float acc[TILE_ACC];
#pragma unroll
    for (int i = 0; i < TILE_ACC; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < nks; ++ks) {
      const int st = it % RING_STAGES;
      hopper::mbar_wait(&f_full[wg][st], (it / RING_STAGES) & 1);
      const unsigned char* b = ring + st * STAGE_BYTES + wg * HALF_BYTES;
      const int nk = min(4, (K - ks * 64) / 16);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kk < nk)
          hopper::wgmma_m64n128k16<0, 1>(acc, hopper::desc_kmajor_sw128(A + ks * 8192 + kk * 32),
                                         hopper::desc_sw128(b + kk * 2048, BOX_BYTES, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // stage ks - 1's products have read it
      if (ks > 0) dense_release<MV, WIDE>(q, ring, it - 1);
      ++it;
    }
    hopper::wgmma_wait<0>();
    dense_release<MV, WIDE>(q, ring, it - 1);
    epi(pc, acc);
  }
}

// The tile's code into `tile` (bf16, zeros past B and past d_in): the
// encoded f32 code rounded, or (CODE) the positional code of the raw
// coordinates as tile64.cuh sets out; at NS views (MV), view v's rows.  Reads go out four at a time so that they
// overlap.
template <bool CODE, bool MV>
__device__ __forceinline__ void dense_code(const TowerParams& p, unsigned char* tile, int row0, int v) {
  const int kin = p.kin, n = TILE_PTS * kin;
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * TILE_THREADS) {
    float f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * TILE_THREADS, r = e / kin, c = e - r * kin, g = row0 + r;
      f[u] = 0.0f;
      if (e < n && g < p.B && c < p.d_in) {
        const size_t row = MV ? src_row(p, g, v) : (size_t)g;  // the input row of point g
        if (CODE) {
          const float* raw = p.x + row * p.d_raw;
          float xg = __ldg(raw) * __ldg(p.code_w + c);
          for (int j = 1; j < p.d_raw; ++j) xg += __ldg(raw + j) * __ldg(p.code_w + j * p.d_in + c);
          f[u] = __ldg(p.code_m + c) > 0.0f ? sinf(xg * __ldg(p.code_f + c) + __ldg(p.code_p + c)) : xg;
        } else {
          f[u] = p.x[row * p.d_in + c];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * TILE_THREADS, r = e / kin, c = e - r * kin;
      if (e < n) *reinterpret_cast<bf16*>(tile + hopper::sw128_offset(r, c)) = __float2bfloat16_rn(f[u]);
    }
  }
}

// View v's latent of the tile at row0 into `tile` (bf16, zeros past B) by
// the threads, for a tile whose points straddle two objects (or end past B):
// their rows of z are two runs (object-major rows, src_row).  The piece's kp
// columns from column off: kp / 8 chunks of 16 bytes a row, read four at a
// time so that they overlap.
__device__ __forceinline__ void view_latent(const TowerParams& p, unsigned char* tile, int row0, int v,
                                            int off, int kp) {
  const int nq = kp >> 3, n = TILE_PTS * nq;
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * TILE_THREADS) {
    uint4 c8[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * TILE_THREADS, r = e / nq, g = row0 + r;
      c8[u] = make_uint4(0u, 0u, 0u, 0u);
      if (e < n && g < p.B)
        c8[u] = __ldg(reinterpret_cast<const uint4*>(p.z + src_row(p, g, v) * p.C + off) + (e - r * nq));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * TILE_THREADS, r = e / nq;
      if (e < n) *reinterpret_cast<uint4*>(tile + hopper::sw128_offset(r, 8 * (e - r * nq))) = c8[u];
    }
  }
}

// The tile's latent into `tile` (bf16, zeros past B): row r, channels
// 8q..8q+7 of z[g] = sum_{j<4} w[g, j] * table[idx[g, j]], g = row0 + r, a
// tap with idx outside [0, T) contributing nothing; at NS views (MV), view
// v's: idx / w row src_row(g, v) into table v (the tap's row v T + idx of
// the (NS T, C) stack).  Warp w takes rows w,
// w + 8, ..; lane l chunks l and l + 32 of a row (C <= 512), so a warp reads
// a tap's table row whole, 16 bytes a lane, and writes the tile 128 bytes a
// phase.  Lane 4 i + j reads tap j of the warp's row i once, for the warp to
// share by shuffles.  Each sum starts from +0 and adds w_j t_j in tap order,
// the product and the sum each rounded (no contraction into an FMA), as
// gather_reference sums.  A tap outside [0, T) reads a zero row here and a
// zero weight on the clamped row there: either product is +-0, which leaves
// a sum that started from +0 unchanged (the table's values are finite).  So
// the tile holds gather_reference's bf16 latent bit for bit.
template <bool MV>
__device__ __forceinline__ void gather_fill(const TowerParams& p, unsigned char* tile, int row0,
                                            int v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = p.C >> 3;  // 16-byte chunks of a table row
  const int gl = row0 + warp + 8 * (lane >> 2);
  int tap = -1;
  float wt = 0.0f;
  if (gl < p.B) {
    const size_t row = MV ? src_row(p, gl, v) : (size_t)gl;  // point gl's idx / w row
    tap = __ldg(p.idx + row * p.taps + (lane & 3));
    wt = __ldg(p.w + row * p.taps + (lane & 3));
    tap = tap < 0 || tap >= p.T ? -1 : MV ? tap + v * p.T : tap;
  }
#pragma unroll 1
  for (int i = 0; i < TILE_PTS / 8; ++i) {
    uint4 v[2][4];
    float wj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ri = __shfl_sync(0xffffffffu, tap, 4 * i + j);
      wj[j] = __shfl_sync(0xffffffffu, wt, 4 * i + j);
      const uint4* row = reinterpret_cast<const uint4*>(p.table + (size_t)(ri < 0 ? 0 : ri) * p.C);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h][j] = make_uint4(0u, 0u, 0u, 0u);
        if (ri >= 0 && lane + 32 * h < nq) v[h][j] = __ldg(row + lane + 32 * h);
      }
    }
    const int r = warp + 8 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = lane + 32 * h;
      if (q >= nq) continue;
      float acc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t words[4] = {v[h][j].x, v[h][j].y, v[h][j].z, v[h][j].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[2 * u] = __fadd_rn(acc[2 * u], __fmul_rn(wj[j], bf16_lo(words[u])));
          acc[2 * u + 1] = __fadd_rn(acc[2 * u + 1], __fmul_rn(wj[j], bf16_hi(words[u])));
        }
      }
      *reinterpret_cast<uint4*>(tile + hopper::sw128_offset(r, 8 * q)) =
          make_uint4(pack_bf16x2(acc[0], acc[1]), pack_bf16x2(acc[2], acc[3]),
                     pack_bf16x2(acc[4], acc[5]), pack_bf16x2(acc[6], acc[7]));
    }
  }
}

// One 64-point tile (tile64.cuh's tile) of 256 threads: the body of the
// four tile kernels, which differ only in where each injection's latent
// comes from (GATHER: gather_fill; else TMA, or at NS views (MV) by the
// threads on a tile that straddles two objects) and in the views (MV: each
// view's layers below the mean, folded, then the shared blocks).  `sv`
// holds this thread's share of the f32 residual stream; `act` and `hb` are
// the two operand tiles (a product reads one and its epilogue writes the
// other); `it` counts the ring's stages taken.
template <bool GATHER, bool CODE, bool MV>
__device__ __forceinline__ void fwd_body(const DenseParams& q, unsigned char* act, unsigned char* hb,
                                         unsigned char* ring, uint32_t& it) {
  const TowerParams& p = q.t;
  // the tile's first row (read where used, not kept in a register)
  auto row0 = [] { return MV ? f_row0 : (int)blockIdx.x * TILE_PTS; };
  if (!MV) {
    // lin_in's operand, before the stream is live
    dense_code<CODE, false>(p, hb, row0(), 0);
    publish();
  }

  float sv[TILE_STREAM];

  // bf16(relu(sv)) into act
  auto emit_relu = [&](int pc) {
#pragma unroll
    for (int i = 0; i < TILE_ACC; i += 2)
      put2(act, acc_row(i), piece_col(pc) + acc_col(i), fmaxf(sv[pc * TILE_ACC + i], 0.0f),
           fmaxf(sv[pc * TILE_ACC + i + 1], 0.0f));
  };

  // multi-view, the walk takes the view segment once for each view (si holds
  // the view, tile64.cuh's walk_at), then the shared blocks, which read no
  // view: the last one's stays in si until the walk's end, f_end
  for (int si = 0; si < (MV ? f_end : f_n_steps); ++si) {
    const int s = f_prog[MV ? walk_idx(si) : si];
    const int kind = step_kind(s);
    if (MV && kind == FOLD) {
      // the view mean, as the data kernel's FOLD: sum in view order in the
      // CTA's slot, then sum * (1 / NS); after the last view, relu(mean) for
      // the first shared block
      const int v = walk_view(si), NS = p.NS;
      const float inv = 1.0f / (float)NS;
#pragma unroll
      for (int i = 0; i < TILE_STREAM; ++i) {
        float* a = p.vsum + ((size_t)blockIdx.x * TILE_STREAM + i) * TILE_THREADS + threadIdx.x;
        if (v == 0) {
          *a = sv[i];
        } else {
          const float sum = *a + sv[i];
          if (v + 1 < NS)
            *a = sum;
          else
            sv[i] = sum * inv;
        }
        if (i % 16 == 15) group_fence();
      }
      if (v + 1 == NS)
#pragma unroll
        for (int pc = 0; pc < TILE_NP; ++pc) emit_relu(pc);
      if (v + 1 < NS) si = walk_at(0, v + 1) - 1;  // the next view's segment
      continue;
    }
    const unsigned char* A = act;
    if (kind == IN_FWD) {
      if (MV) {
        __syncthreads();  // hb's last readers (the previous view's or tile's fc_1) are done
        dense_code<CODE, true>(p, hb, row0(), walk_view(si));
        publish();
      }
      A = hb;  // the code
    } else if (kind == Z_FWD) {
      const int lat_n = MV ? f_lat_n : 0;  // read before thread 0 counts this latent
      // the piece's columns: off.. (aux the piece; all C at C <= 512)
      const int off = step_aux(s) * HID, kp = min(HID, p.C - off);
      __syncthreads();  // hb's last readers (lin_in, the previous fc_1 or piece) are done
      if (GATHER) {
        gather_fill<MV>(p, hb, row0(), MV ? walk_view(si) : 0);
        publish();
      } else if (MV && row0() % p.B_obj + TILE_PTS > p.B_obj) {
        view_latent(p, hb, row0(), walk_view(si), off, kp);  // two runs of rows: by the threads
        publish();
      } else {
        if (threadIdx.x == 0) {
          const int boxes = (kp + 63) / 64;
          const int r = MV ? (int)src_row(p, row0(), walk_view(si)) : row0();
          hopper::mbar_arrive_expect_tx(&f_lat_full, boxes * BOX_BYTES);
          for (int j = 0; j < boxes; ++j)
            hopper::tma_load_2d(hb + j * BOX_BYTES, &q.m_lat, &f_lat_full, off + 64 * j, r);
          if (MV) f_lat_n = lat_n + 1;
        }
        // one view: the latents taken so far are k pieces a block, then aux
        hopper::mbar_wait(&f_lat_full,
                          (MV ? lat_n : step_k(s) * latent_pieces(p.C) + step_aux(s)) & 1);
      }
      A = hb;
    } else {
      publish();  // act = r_k (fc_0) or hb = s_k (fc_1)
      if (kind == B1_FWD) A = hb;
    }
    const Gemm op = fwd_gemm_of<!GATHER>(s, p.kin, p.C);
    // one product site, the epilogue chosen inside: so ptxas keeps the stream
    // and the accumulators where they are (a site per epilogue kind spilled)
    dense_gemm<MV, !GATHER>(q, ring, it, A, op.K, [&](int pc, float(&acc)[TILE_ACC]) {
      if (step_kind(s) == B0_FWD) {
        const int c0 = piece_col(pc);
        const float* bias = p.b_blk + (size_t)(2 * step_k(s)) * HID;
#pragma unroll
        for (int j = 0; j < TILE_ACC / 4; ++j) {
          const int c = c0 + acc_col(4 * j);
          const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + c));
#pragma unroll
          for (int h = 0; h < 2; ++h)
            put2(hb, acc_row(4 * j + 2 * h), c, fmaxf(acc[4 * j + 2 * h] + bj.x, 0.0f),
                 fmaxf(acc[4 * j + 2 * h + 1] + bj.y, 0.0f));
          if ((j & 3) == 3) group_fence();
        }
      } else {
        const int c0 = piece_col(pc);
        const int kind = step_kind(s), k = step_k(s), aux = step_aux(s);  // from s: fewer live registers
        const float* bias = kind == IN_FWD  ? p.b_in
                            : kind == Z_FWD ? p.b_z + (size_t)k * HID
                                            : p.b_blk + (size_t)(2 * k + 1) * HID;
        // an injection's bias comes with its first piece only
        const bool biased = GATHER || kind != Z_FWD || aux == 0;
#pragma unroll
        for (int j = 0; j < TILE_ACC / 4; ++j) {  // one bias pair serves rows r and r + 8
          float2 bj = make_float2(0.0f, 0.0f);
          if (biased) bj = __ldg(reinterpret_cast<const float2*>(bias + c0 + acc_col(4 * j)));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float u = acc[i] + ((e & 1) ? bj.y : bj.x);
            sv[pc * TILE_ACC + i] = kind == IN_FWD ? u : sv[pc * TILE_ACC + i] + u;
          }
          if ((j & 3) == 3) group_fence();
        }
        if (kind == Z_FWD || aux) emit_relu(pc);
      }
    });
  }
  __syncthreads();  // act = t = bf16(relu(x)) of the last block

  // lin_out on the CUDA cores: warp w takes points w, w + 8, ..; lane l the
  // 16 columns 16 l.. of t, summed in order, then across the warp
  const int lane = threadIdx.x & 31, d_out = p.d_out;
  float wo[16][TILE_MAX_OUT];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int o = 0; o < TILE_MAX_OUT; ++o)
      wo[i][o] = o < d_out ? __bfloat162float(p.w_out[(size_t)(16 * lane + i) * d_out + o]) : 0.0f;
  for (int r = threadIdx.x >> 5; r < TILE_PTS && row0() + r < p.B; r += TILE_THREADS / 32) {
    float acc[TILE_MAX_OUT] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(act + hopper::sw128_offset(r, 16 * lane + 8 * h));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int o = 0; o < TILE_MAX_OUT; ++o) {
          acc[o] = fmaf(bf16_lo(words[u]), wo[8 * h + 2 * u][o], acc[o]);
          acc[o] = fmaf(bf16_hi(words[u]), wo[8 * h + 2 * u + 1][o], acc[o]);
        }
    }
    float mine = 0.0f;  // lane o writes output o
#pragma unroll
    for (int o = 0; o < TILE_MAX_OUT; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
      if (lane == o) mine = acc[o];
    }
    if (lane < d_out) {
      const int g = row0() + r;
      const float v = mine + p.b_out[lane];
      if (p.planar)
        p.out[(size_t)lane * p.B + g] = v;
      else
        p.out[(size_t)g * d_out + lane] = v;
    }
  }
}

template <bool GATHER, bool CODE, bool MV>
__device__ __forceinline__ void fwd_tile(const DenseParams& q) {
  extern __shared__ unsigned char f_smem_raw[];
  const TowerParams& p = q.t;
  const uint32_t raw = hopper::smem_u32(f_smem_raw);
  unsigned char* act = f_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* hb = act + TILE_BYTES;
  unsigned char* ring = hb + TILE_BYTES;
  const int n_tiles = (p.B + TILE_PTS - 1) / TILE_PTS;

  if (threadIdx.x == 0) {
    for (int h = 0; h < 2; ++h)
      for (int st = 0; st < RING_STAGES; ++st) {
        hopper::mbar_init(&f_full[h][st], 1);
        hopper::mbar_init(&f_empty[h][st], 4);  // the warps of warpgroup h
      }
    hopper::mbar_init(&f_lat_full, 1);
    hopper::mbar_fence_init();
    f_n_steps = fwd_program(f_prog, p.n_blocks, p.n_lin_z, MV, MV ? p.pre : p.n_blocks,
                            GATHER ? 1 : latent_pieces(p.C));
    if (MV) {
      f_n_gemms = 0;
      for (int i = 0; i < f_n_steps; ++i) {
        if (step_kind(f_prog[i]) == FOLD) f_seg_gemms = f_n_gemms;  // the view segment's products
        else f_gprog[f_n_gemms++] = f_prog[i];
      }
      // the CTA's tiles are blockIdx.x, + gridDim.x, ..
      f_left[0] = f_left[1] = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
      f_vleft[0] = f_vleft[1] = p.NS - 1;
      f_end = walk_at(f_n_steps, p.NS - 1);
      f_lat_n = 0;
    }
    f_feed[0] = f_feed[1] = DenseFeed{0, 0, 0};
  }
  __syncthreads();
  if ((threadIdx.x & 127) == 0)
    for (int st = 0; st < RING_STAGES; ++st) dense_feed<MV, !GATHER>(q, ring, st, threadIdx.x >> 7);

  uint32_t it = 0;  // stages taken
  if (MV) {
    // persistent CTAs walk the tiles, each with its view-sum slot; the
    // feeders run on into the next tile's stages
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      __syncthreads();  // the previous tile's last readers of f_row0 are done
      if (threadIdx.x == 0) f_row0 = tile * TILE_PTS;
      __syncthreads();
      fwd_body<GATHER, CODE, true>(q, act, hb, ring, it);
    }
  } else {
    fwd_body<GATHER, CODE, false>(q, act, hb, ring, it);
  }
}

template <bool CODE>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    resnetfc_fwd_dense_kernel(const __grid_constant__ DenseParams q) {
  fwd_tile<false, CODE, false>(q);
}

template <bool CODE>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    resnetfc_fwd_gather_kernel(const __grid_constant__ DenseParams q) {
  fwd_tile<true, CODE, false>(q);
}

template <bool CODE>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    resnetfc_fwd_dense_mv_kernel(const __grid_constant__ DenseParams q) {
  fwd_tile<false, CODE, true>(q);
}

template <bool CODE>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    resnetfc_fwd_gather_mv_kernel(const __grid_constant__ DenseParams q) {
  fwd_tile<true, CODE, true>(q);
}

// A grid of `grid` tile CTAs: one a 64-point tile (one view), or persistent
// CTAs (multi-view).
int launch_tile(void (*kernel)(DenseParams), const DenseParams& q, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TILE_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, TILE_THREADS, TILE_SMEM, stream>>>(q);
  return (int)cudaGetLastError();
}

int tiles_of(int B) { return (B + TILE_PTS - 1) / TILE_PTS; }

bool dense_widths_ok(int kin, int C, int n_blocks, int n_lin_z) {
  return kin >= 16 && kin <= F_MAX_K && kin % 16 == 0 && n_blocks >= 1 && n_lin_z >= 0 &&
         n_lin_z <= n_blocks && (n_lin_z == 0 || (C >= 16 && C <= F_MAX_C && C % 16 == 0)) &&
         fwd_program(nullptr, n_blocks, n_lin_z, false, n_blocks, latent_pieces(C)) <= F_MAX_STEPS;
}

// The parameters of a tile launch on `plan`'s weights (which must be the
// w_in, w_z, w_blk given here) and B >= 1 output points, at one view;
// returns whether the CODE variant runs, or -1 for widths or operands the
// tile does not take.
int tile_params(DenseParams& q, const void* plan, const void* x, const void* w_in,
                const void* b_in, const void* w_z, const void* b_z, const void* w_blk,
                const void* b_blk, const void* w_out, const void* b_out, void* out, int B, int d_in,
                int kin, int H, int C, int n_blocks, int n_lin_z, int d_out, int planar,
                const void* code_w, const void* code_f, const void* code_p, const void* code_m,
                int d_raw) {
  DensePlan d;
  memcpy(&d, plan, sizeof d);
  if (H != HID || B < 1 || d_in < 1 || d_in > kin || d_out < 1 || d_out > TILE_MAX_OUT ||
      !dense_widths_ok(kin, C, n_blocks, n_lin_z) || d.w_in != w_in || d.w_blk != w_blk ||
      d.w_z != (n_lin_z > 0 ? w_z : nullptr) || d.kin != kin || d.C != C ||
      d.n_blocks != n_blocks || d.n_lin_z != n_lin_z)
    return -1;
  q = DenseParams{};
  q.t = tower_params(x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, B, d_in, kin, C,
                     n_blocks, n_lin_z, d_out);
  q.t.out = static_cast<float*>(out);
  q.t.planar = planar;
  q.m_in = d.m_in;
  q.m_z = d.m_z;
  q.m_blk = d.m_blk;
  return attach_code(q.t, code_w, code_f, code_p, code_m, d_raw);
}

// The multi-view part of a tile launch's parameters: NS views (2..255, v's
// 8 bits of a step) of B = SB B_obj output points, the first `pre` blocks
// per view with every injection among them, and n_ctas view-sum slots at
// vsum; false for what the kernels do not take.  The stored program is one
// view's segment and the shared blocks at any NS.
bool mv_params(DenseParams& q, int NS, int B_obj, int pre, void* vsum, int n_ctas) {
  const TowerParams& p = q.t;
  if (NS < 2 || NS > 255 || pre < 0 || pre >= p.n_blocks || p.n_lin_z > pre || B_obj < 1 ||
      p.B % B_obj != 0 || vsum == nullptr || n_ctas < 1 ||
      fwd_program(nullptr, p.n_blocks, p.n_lin_z, true, pre, latent_pieces(p.C)) > F_MAX_STEPS)
    return false;
  q.t.NS = NS;
  q.t.B_obj = B_obj;
  q.t.pre = pre;
  q.t.vsum = static_cast<float*>(vsum);
  return true;
}

// The lookup's operands of a gather launch: idx (rows, taps) int32 and w
// (rows, taps) f32 (taps >= 4, columns 0..3 used), T table rows of C bf16
// each (a table per view, multi-view), 16-byte aligned; false for what the
// kernels do not take.
bool gather_params(DenseParams& q, const void* idx, const void* w, int taps, const void* table,
                   int T) {
  // the lookup builds the whole latent into one operand tile: C <= HID
  if (taps < 4 || T < 1 || q.t.C % 8 != 0 || q.t.C > HID || idx == nullptr || w == nullptr ||
      table == nullptr || reinterpret_cast<uintptr_t>(table) % 16 != 0)
    return false;
  q.t.idx = static_cast<const int*>(idx);
  q.t.w = static_cast<const float*>(w);
  q.t.table = static_cast<const bf16*>(table);
  q.t.T = T;
  q.t.taps = taps;
  return true;
}

}  // namespace

extern "C" {

const char* resnetfc_fwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// What the tile kernels fix, for the wrapper to plan with: out[0..6] =
// points a tile, threads a CTA, weight-ring stages, the most outputs of
// lin_out, the most steps of a tile's stored program (one view's segment and
// the shared blocks), the widest code (and latent piece), the f32 words of
// a multi-view CTA's view-sum slot, the widest latent of the dense kernels.
// Returns the bytes of a plan; *smem gets the shared memory a CTA.
size_t resnetfc_fwd_dense_limits(int* out, size_t* smem) {
  out[0] = TILE_PTS;
  out[1] = TILE_THREADS;
  out[2] = RING_STAGES;
  out[3] = TILE_MAX_OUT;
  out[4] = F_MAX_STEPS;
  out[5] = F_MAX_K;
  out[6] = F_SLOT_FLOATS;
  out[7] = F_MAX_C;
  *smem = TILE_SMEM;
  return sizeof(DensePlan);
}

// Fills `plan` (resnetfc_fwd_dense_limits' bytes) with the tensor maps of
// the packed weights w_in (kin, 512), w_z (n_lin_z, C, 512) and w_blk
// (n_blocks, 2, 512, 512), bf16 row-major.  A plan holds addresses but no
// buffer of a call, so a caller keeps it for as long as the weights stay
// where they are.
int resnetfc_fwd_dense_plan(void* plan, const void* w_in, const void* w_z, const void* w_blk,
                            int kin, int C, int n_blocks, int n_lin_z) {
  if (!dense_widths_ok(kin, C, n_blocks, n_lin_z)) return (int)cudaErrorInvalidValue;
  DensePlan d = {};
  int err = hopper::encode_bf16_sw128(&d.m_in, w_in, kin, HID, HID, 64);
  if (err == 0 && n_lin_z > 0)
    err = hopper::encode_bf16_sw128(&d.m_z, w_z, (uint64_t)n_lin_z * C, HID, HID, 64);
  if (err == 0)
    err = hopper::encode_bf16_sw128(&d.m_blk, w_blk, (uint64_t)2 * n_blocks * HID, HID, HID, 64);
  if (err != 0) return err;
  d.w_in = w_in;
  d.w_z = n_lin_z > 0 ? w_z : nullptr;
  d.w_blk = w_blk;
  d.kin = kin;
  d.C = C;
  d.n_blocks = n_blocks;
  d.n_lin_z = n_lin_z;
  memcpy(plan, &d, sizeof d);
  return (int)cudaSuccess;
}

// One view, dense bf16 latent z (B, C) (null without injection): the plan's
// weights (which must be the w_in, w_z, w_blk given here) and B >= 1 points.
int resnetfc_fwd_dense(const void* plan, const void* z, const void* x, const void* w_in,
                       const void* b_in, const void* w_z, const void* b_z, const void* w_blk,
                       const void* b_blk, const void* w_out, const void* b_out, void* out, int B,
                       int d_in, int kin, int H, int C, int n_blocks, int n_lin_z, int d_out,
                       int planar, const void* code_w, const void* code_f, const void* code_p,
                       const void* code_m, int d_raw, void* stream) {
  DenseParams q;
  const int code = tile_params(q, plan, x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, out,
                               B, d_in, kin, H, C, n_blocks, n_lin_z, d_out, planar, code_w,
                               code_f, code_p, code_m, d_raw);
  if (code < 0 || (n_lin_z > 0 && z == nullptr)) return (int)cudaErrorInvalidValue;
  q.t.z = static_cast<const bf16*>(z);
  if (n_lin_z > 0) {
    const int err = hopper::encode_bf16_sw128(&q.m_lat, z, B, C, C, 64);
    if (err != 0) return err;
  }
  return launch_tile(code ? resnetfc_fwd_dense_kernel<true> : resnetfc_fwd_dense_kernel<false>, q,
                     tiles_of(B), static_cast<cudaStream_t>(stream));
}

// One view with the lookup z[g] = sum_{j<4} w[g, j] * table[idx[g, j]]
// fused in: idx (B, taps) int32 and w (B, taps) f32 (taps >= 4, columns 0..3
// used), table (T, C) bf16 with 16-byte aligned rows; otherwise as
// resnetfc_fwd_dense.
int resnetfc_fwd_gather(const void* plan, const void* idx, const void* w, int taps,
                        const void* table, int T, const void* x, const void* w_in,
                        const void* b_in, const void* w_z, const void* b_z, const void* w_blk,
                        const void* b_blk, const void* w_out, const void* b_out, void* out, int B,
                        int d_in, int kin, int H, int C, int n_blocks, int n_lin_z, int d_out,
                        int planar, const void* code_w, const void* code_f, const void* code_p,
                        const void* code_m, int d_raw, void* stream) {
  DenseParams q;
  const int code = tile_params(q, plan, x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, out,
                               B, d_in, kin, H, C, n_blocks, n_lin_z, d_out, planar, code_w,
                               code_f, code_p, code_m, d_raw);
  if (code < 0 || !gather_params(q, idx, w, taps, table, T)) return (int)cudaErrorInvalidValue;
  return launch_tile(code ? resnetfc_fwd_gather_kernel<true> : resnetfc_fwd_gather_kernel<false>,
                     q, tiles_of(B), static_cast<cudaStream_t>(stream));
}

// Multi-view, dense bf16 latent z (NS B, C) (null without injection): B =
// SB B_obj output points, NS views of each as object-major input rows; the
// first `pre` blocks run per view, the rest on their mean.  The plan's
// weights as resnetfc_fwd_dense; vsum holds n_ctas slots of
// resnetfc_fwd_dense_limits' f32 words, and the grid is at most n_ctas
// persistent CTAs.
int resnetfc_fwd_dense_mv(const void* plan, const void* z, const void* x, const void* w_in,
                          const void* b_in, const void* w_z, const void* b_z, const void* w_blk,
                          const void* b_blk, const void* w_out, const void* b_out, void* out, int B,
                          int d_in, int kin, int H, int C, int n_blocks, int n_lin_z, int d_out,
                          int planar, int NS, int B_obj, int pre, void* vsum, int n_ctas,
                          const void* code_w, const void* code_f, const void* code_p,
                          const void* code_m, int d_raw, void* stream) {
  DenseParams q;
  const int code = tile_params(q, plan, x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, out,
                               B, d_in, kin, H, C, n_blocks, n_lin_z, d_out, planar, code_w,
                               code_f, code_p, code_m, d_raw);
  if (code < 0 || !mv_params(q, NS, B_obj, pre, vsum, n_ctas) ||
      (n_lin_z > 0 && (z == nullptr || reinterpret_cast<uintptr_t>(z) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  q.t.z = static_cast<const bf16*>(z);
  if (n_lin_z > 0) {
    const int err = hopper::encode_bf16_sw128(&q.m_lat, z, (uint64_t)NS * B, C, C, 64);
    if (err != 0) return err;
  }
  const int grid = n_ctas < tiles_of(B) ? n_ctas : tiles_of(B);
  return launch_tile(code ? resnetfc_fwd_dense_mv_kernel<true> : resnetfc_fwd_dense_mv_kernel<false>,
                     q, grid, static_cast<cudaStream_t>(stream));
}

// Multi-view with view v's lookup z[g] = sum_{j<4} w[r, j] * table[v][idx[r,
// j]] fused in, r = v B + g: one object (B_obj = B), idx (NS B, taps) int32
// and w (NS B, taps) f32 view-major, tables (NS, T, C) bf16 with 16-byte
// aligned rows; otherwise as resnetfc_fwd_dense_mv.
int resnetfc_fwd_gather_mv(const void* plan, const void* idx, const void* w, int taps,
                           const void* table, int T, const void* x, const void* w_in,
                           const void* b_in, const void* w_z, const void* b_z, const void* w_blk,
                           const void* b_blk, const void* w_out, const void* b_out, void* out,
                           int B, int d_in, int kin, int H, int C, int n_blocks, int n_lin_z,
                           int d_out, int planar, int NS, int B_obj, int pre, void* vsum,
                           int n_ctas, const void* code_w, const void* code_f, const void* code_p,
                           const void* code_m, int d_raw, void* stream) {
  DenseParams q;
  const int code = tile_params(q, plan, x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, out,
                               B, d_in, kin, H, C, n_blocks, n_lin_z, d_out, planar, code_w,
                               code_f, code_p, code_m, d_raw);
  if (code < 0 || B_obj != B || !mv_params(q, NS, B_obj, pre, vsum, n_ctas) ||
      !gather_params(q, idx, w, taps, table, T))
    return (int)cudaErrorInvalidValue;
  const int grid = n_ctas < tiles_of(B) ? n_ctas : tiles_of(B);
  return launch_tile(code ? resnetfc_fwd_gather_mv_kernel<true> : resnetfc_fwd_gather_mv_kernel<false>,
                     q, grid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

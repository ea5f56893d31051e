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
// - one CTA of two warpgroups a 64-point tile, each warpgroup owning half of
//   the tower's HID columns of the f32 stream in registers (256 of 512 at
//   sn64); every product is wgmma pieces (m64n128k16; m64n64k16 at HID 128
//   and, three a warpgroup, at 384; m64n32k16 at 64; m64n96k16 at 192; two
//   m64n80k16 at 320) with operand A a 64 x
//   512 bf16 swizzled tile in shared memory (the code, the latent, relu(x)
//   or relu(fc_0)) and operand B 64 x 64 TMA boxes of the packed row-major
//   weights (MN-major for x W; where a piece is not whole 64-column boxes,
//   each warpgroup's 64 x 32 boxes, 64-byte swizzled, or 64 x 16, 32-byte
//   swizzled, at 320) through a ring of 96 KB (3 stages of 32 KB; 6 of 16
//   KB at HID 128 and 384, 12 of 8 KB at 64, 4 of 24 KB at 192, 4 of 20 KB
//   at 320).  Each warpgroup keeps its
//   own half of every stage (the boxes of its piece) fed: its first thread
//   refills the half as soon as the warpgroup's four warps have read it (one
//   arrival a warp), so neither warpgroup waits for the other's.  A tile
//   reads each weight byte out of L2 once for 64 points;
// - the code comes by the threads (encoded: rounded to bf16; CODE: evaluated
//   as tile64.cuh says); the latent of each injection either by TMA from a
//   dense bf16 z (B, C) (the dense kernels; rows past B read as zeros) or,
//   in the gather kernels, as the 4-tap lookup z[g] = sum_{j<4} w[g, j] *
//   table[idx[g, j]] that the threads build straight into the operand tile
//   (gather_fill);
// - a latent wider than one operand tile (512 < C <= 4096: the global
//   encoder's code before the pixel latent, 640 at sn64; ResNet50's unified
//   map, 832 / 1856 / 3904 at 3 / 4 / 5 layers) is injected in pieces of at
//   most 512 columns, each a step of the stored program whose product adds
//   to the f32 stream (the bias with the first piece), as the TPU kernel's
//   one K = C product is split; the last piece's K stops at C.  The dense
//   kernels take each piece by TMA, the gathers build each one's lookup;
//   at C <= 512 the program and its bits are those of one piece;
// - lin_out (d_out <= 4) stays on the CUDA cores, a warp a point;
// - no atomics: two calls on the same inputs give the same bits.
// - the tower's width HID is the library's (-DRFC_HID: every multiple of 64
//   up to 512 but 448, and 1024, one library each); the operand tiles keep their 512 columns at
//   every width, so the code and a latent piece do not shrink with it.  A
//   narrower tower streams fewer weight bytes a tile (0.61x at 384, 0.31x
//   at 256, 0.11x at 128, 0.04x at 64 at sn64's other widths) and runs its
//   products on fewer columns, the same tile and ring otherwise.  At 64 the
//   FLOP no longer bound the dense kernels: a point's 1 KB of bf16 latent
//   (3 injections read 512 columns each) weighs more than its ~0.29 MFLOP
//   at the card's ratio of ~295 FLOP a byte.
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
// at sn64, 3.6 MB at ResNet50's 1856) once an injection, piece by piece,
// since the two operand tiles and the ring leave no room to keep the latent:
// 64 points x 4 taps x 1 KB, 0.75 MB a tile at sn64 beside its 6.55 MB of
// weights (2.7 MB beside 8.6 MB at 1856).  A piece's fill reads its points'
// taps and weights again (32 bytes a point beside its 4 x 1 KB of table
// rows): shared memory has no 2 KB left to keep them across the product
// between two pieces.  The TPU kernel builds the lookup as a
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
// most), each walking its tiles with a device-memory slot for the view sum
// (the 64 x HID f32 stream, each thread coalesced on its own words; 128 KB,
// 16.5 MB over 132 SMs at HID 512, L2-resident beside the weights), and each
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
//
// At d_hidden 1024 (the one library past 512; tile64.cuh's CLUSTER 2) a
// tile is a cluster of two CTAs on neighbouring SMs, CTA r owning columns
// [512 r, 512 r + 512) with the 512-wide layout inside it: its half of the
// f32 stream in registers, its half of every product's N, its half of
// each weight matrix's columns through its own ring.  A block product's
// operand A is the whole 1024-wide activation (act, 128 KB in each CTA),
// which each CTA writes half of into both copies between the products
// (share_relu, share_stage: distributed shared memory, two cluster
// barriers each); the code and the latent's pieces come into each CTA's own
// 64 KB tile as at 512, each CTA building the same one.  The two operand
// tiles leave 32 KB of the 227 KB for the ring: 2 stages of 16 KB, a
// third of the 512 tile's weights in flight; each warpgroup's 256 columns
// run as four m64n64k16 pieces.  sn64's tower at 1024
// streams 24.2 MB of weights a tile (12.1 MB into each SM) for 24.2 MFLOP
// a point, 3.5x 512's 6.86: the weights' stream binds it as it binds 512,
// and harder with less in flight.  lin_out: each CTA sums its 512 columns
// a point; CTA c writes points 32 c.. of the tile as CTA 0's sum plus CTA
// 1's, then the bias, so a second call gives the same bits.  Every 1024
// kernel walks its tiles on persistent pairs, the one-view ones as the
// multi-view walk of a single view; each multi-view CTA's view-sum slot
// holds its half of the stream (128 KB, as at 512).

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
// any view count: one view's segment and the shared blocks; an injection of
// C = 4096 adds 7 pieces: 35 and 36)
constexpr int F_MAX_STEPS = 128;
constexpr int F_MAX_K = TILE_K;  // the widest code, and a latent's widest piece: one 64 x 512 operand tile
// the widest latent of the dense kernels and of the gathers (tile64.cuh's
// MAX_C, in pieces of at most TILE_K columns)
constexpr int F_MAX_C = MAX_C;
constexpr int F_MAX_GATHER_C = MAX_C;
// f32 words of a multi-view CTA's view-sum slot: every thread's share of the
// 64 x CTA_HID stream (128 KB at HID 512 and 1024)
constexpr int F_SLOT_FLOATS = TILE_STREAM * TILE_THREADS;
// lin_out: the columns of t a lane sums (16 at HID 512, and of a CTA's 512
// at 1024), read 8 at a time
// (16 bytes; 4 at HID 128 and 384, whose 12 a lane are three reads of 4; 2
// at 64, 192 and 320: 1, 3 and 5 reads of 2)
constexpr int OUT_COLS = CTA_HID / 32;
constexpr int OUT_VEC = OUT_COLS % 8 == 0 ? 8 : OUT_COLS % 4 == 0 ? 4 : 2;
static_assert(OUT_COLS % OUT_VEC == 0 && (OUT_VEC == 8 || OUT_VEC == 4 || OUT_VEC == 2),
              "a lane's columns of t are whole reads");

// The weights' tensor maps (the boxes of tile64.cuh's encode_weights of w_in
// (kin, H), w_z (n_lin_z C, H) and w_blk (2 n_blocks H, H)) and what they
// were encoded for: built once per set of weight addresses by
// resnetfc_fwd_dense_plan.
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

// The tile's program as stored: lin_in, then per block k < pre its injection
// (k < n_lin_z; one Z_FWD step a piece of the latent, aux the piece), fc_0
// and fc_1, and, multi-view (mv), the fold into the view mean -- one view's
// segment, which the walk takes NS times (one view: pre = n_blocks) -- then
// the shared blocks k >= pre.
// Walked, it is the forward half of the data kernel's program
// (data_program), in its order and with its aux flags, at any latent width.
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
constexpr uint32_t HALF_BYTES = TILE_BPW * W_BOX_BYTES;

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
// -- the weight boxes of its piece pc (among this CTA's columns), K rows
// rowbase + ks * 64.. -- on full[h].
template <bool MV>
__device__ __forceinline__ void dense_feed(const DenseParams& q, unsigned char* ring, int slot, int h) {
  DenseFeed f = f_feed[h];
  if (MV ? f_left[h] == 0 : f.g >= f_n_steps) return;  // the CTA's last stage is in
  const Gemm op = piece_gemm_of<false>(MV ? f_gprog[f.g] : f_prog[f.g], q.t.kin, q.t.C);
  const CUtensorMap* m = op.map == 0 ? &q.m_in : op.map == 1 ? &q.m_z : &q.m_blk;
  hopper::mbar_arrive_expect_tx(&f_full[h][slot], HALF_BYTES);
  unsigned char* dst = ring + slot * STAGE_BYTES + h * HALF_BYTES;
#pragma unroll
  for (int b = 0; b < TILE_BPW; ++b)
    hopper::tma_load_2d(dst + b * W_BOX_BYTES, m, &f_full[h][slot],
                        cta_col0() + h * TILE_HALF + f.pc * TILE_PIECE + b * W_BOX_COLS,
                        op.rowbase + f.ks * 64);
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
template <bool MV>
__device__ __forceinline__ void dense_release(const DenseParams& q, unsigned char* ring, uint32_t u) {
  const int slot = u % RING_STAGES, h = threadIdx.x >> 7;
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&f_empty[h][slot]);
  if ((threadIdx.x & 127) == 0) {
    hopper::mbar_wait(&f_empty[h][slot], (u / RING_STAGES) & 1);
    dense_feed<MV>(q, ring, slot, h);
  }
}

// For each piece of this warpgroup's columns, acc = A . B over K (A a
// swizzled (64, K) tile, B the ring's MN-major boxes), then epi(piece, acc):
// the pieces, k16 steps and stages of the data kernel's forward products.
template <bool MV, typename Epi>
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
          wgmma_piece<0, 1>(acc, hopper::desc_kmajor_sw128(A + ks * 8192 + kk * 32), w_desc(b, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // stage ks - 1's products have read it
      if (ks > 0) dense_release<MV>(q, ring, it - 1);
      ++it;
    }
    hopper::wgmma_wait<0>();
    dense_release<MV>(q, ring, it - 1);
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

// The piece of the tile's latent at column `off` (kp columns, at most
// TILE_K) into `tile` (bf16, zeros past B): row r, channels off + 8q..
// off + 8q + 7 of z[g] = sum_{j<4} w[g, j] * table[idx[g, j]], g = row0 + r,
// at tile column 8q, a tap with idx outside [0, T) contributing nothing; at
// NS views (MV), view v's: idx / w row src_row(g, v) into table v (the tap's
// row v T + idx of the (NS T, C) stack).  Warp w takes rows w, w + 8, ..;
// lane l chunks l and l + 32 of the piece's row, so a warp reads a tap's
// piece of a table row whole, 16 bytes a lane, and writes the tile 128 bytes
// a phase; the tile's columns past kp stay as they were, and the product's
// K stops at kp.  Lane 4 i + j reads tap j of the warp's row i once (again
// for each piece), for the warp to share by shuffles.  Each sum starts from
// +0 and adds w_j t_j in tap order,
// the product and the sum each rounded (no contraction into an FMA), as
// gather_reference sums.  A tap outside [0, T) reads a zero row here and a
// zero weight on the clamped row there: either product is +-0, which leaves
// a sum that started from +0 unchanged (the table's values are finite).  So
// the tile holds gather_reference's bf16 latent bit for bit.
template <bool MV>
__device__ __forceinline__ void gather_fill(const TowerParams& p, unsigned char* tile, int row0,
                                            int v, int off, int kp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = kp >> 3;  // 16-byte chunks of the piece's row
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
      const uint4* row =
          reinterpret_cast<const uint4*>(p.table + (size_t)(ri < 0 ? 0 : ri) * p.C + off);
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

// ---------------------------------------------------------------------------
// HID 1024: the pair of CTAs of a cluster shares each block product's operand
// ---------------------------------------------------------------------------
//
// Each CTA keeps its own copy of a block product's K = HID operand in `act`
// (128 KB) and writes its own CTA_HID columns of it into both copies, its
// partner's through distributed shared memory.  An epilogue cannot write a
// copy while a product reads it, so a block product's operand is shared
// between the products, after a cluster barrier that marks both CTAs' last
// readers done and before one that publishes the writes:
// - before fc_0 (share_relu): relu(x) from the stream's registers, whether
//   lin_in, an injection, fc_1 or the view mean was the stream's last writer;
// - before fc_1 (share_stage): fc_0's output, which its epilogue left in the
//   CTA's `hb` at the CTA's own columns (fc_0 reads act, not hb).
// lin_in and the latent's pieces read `hb` (K <= TILE_K) as at the narrower
// widths, each CTA filling its own.

// This CTA's columns of act (whole 64-column atoms of the swizzled tile, so
// the bytes move as they lie) from `src` into its partner's copy of act,
// and into its own when `local`; then the pair meets, both copies whole.
__device__ __forceinline__ void send_own(unsigned char* act, const unsigned char* src, bool local) {
  const uint32_t own = (uint32_t)(cta_col0() / 64) * 8192;  // this CTA's atoms of act
  const uint32_t remote = hopper::mapa(hopper::smem_u32(act), hopper::cluster_ctarank() ^ 1) + own;
#pragma unroll 1
  for (int e = threadIdx.x; e < (int)(TILE_PTS * CTA_HID * 2 / 16); e += TILE_THREADS) {
    const uint4 v = reinterpret_cast<const uint4*>(src)[e];
    if (local) *reinterpret_cast<uint4*>(act + own + 16 * e) = v;
    hopper::st_cluster(remote + 16 * e, v);
  }
  hopper::fence_proxy_async_cluster();
  hopper::cluster_sync();
}

// relu(x) of this CTA's columns, bf16, into act at those columns, in this
// CTA's copy and in its partner's.
__device__ __forceinline__ void share_relu(unsigned char* act, const float (&sv)[TILE_STREAM]) {
  hopper::cluster_sync();  // both CTAs' last readers of act (the last fc_1) are done
#pragma unroll
  for (int pc = 0; pc < TILE_NP; ++pc)
#pragma unroll
    for (int i = 0; i < TILE_ACC; i += 2)
      put2(act, acc_row(i), cta_col0() + piece_col(pc) + acc_col(i),
           fmaxf(sv[pc * TILE_ACC + i], 0.0f), fmaxf(sv[pc * TILE_ACC + i + 1], 0.0f));
  __syncthreads();  // this CTA's columns of its own copy whole
  send_own(act, act + (cta_col0() / 64) * 8192, false);
}

// fc_0's output of this CTA's columns (hb, the CTA's columns from 0) into act
// at those columns, in this CTA's copy and in its partner's.
__device__ __forceinline__ void share_stage(unsigned char* act, const unsigned char* hb) {
  hopper::cluster_sync();  // hb whole; both CTAs' fc_0 products are done with act
  send_own(act, hb, true);
}

// One 64-point tile (tile64.cuh's tile) of 256 threads: the body of the
// four tile kernels, which differ only in where each injection's latent
// comes from (GATHER: gather_fill; else TMA, or at NS views (MV) by the
// threads on a tile that straddles two objects) and in the views (MV: each
// view's layers below the mean, folded, then the shared blocks).  `sv`
// holds this thread's share of the f32 residual stream; `act` and `hb` are
// the two operand tiles (a product reads one and its epilogue writes the
// other); `it` counts the ring's stages taken.  At HID 1024 (CLUSTER 2)
// the stream and every product's N are this CTA's columns, and the block
// products read `act` whole, shared by the pair as above.
template <bool GATHER, bool CODE, bool MV>
__device__ __forceinline__ void fwd_body(const DenseParams& q, unsigned char* act, unsigned char* hb,
                                         unsigned char* ring, uint32_t& it) {
  const TowerParams& p = q.t;
  // the tile's first row (read where used, not kept in a register): one
  // tile a CTA, or a cluster's pair of CTAs
  auto row0 = [] { return MV ? f_row0 : (int)blockIdx.x / CLUSTER * TILE_PTS; };
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
      if (CLUSTER == 1 && v + 1 == NS)  // (CLUSTER 2: share_relu before the first shared fc_0)
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
      const int off = step_aux(s) * TILE_K, kp = min(TILE_K, p.C - off);
      __syncthreads();  // hb's last readers (lin_in, the previous fc_1 or piece) are done
      if (GATHER) {
        gather_fill<MV>(p, hb, row0(), MV ? walk_view(si) : 0, off, kp);
        publish();
      } else if (MV && row0() % p.B_obj + TILE_PTS > p.B_obj) {
        view_latent(p, hb, row0(), walk_view(si), off, kp);  // two runs of rows: by the threads
        publish();
      } else {
        if (threadIdx.x == 0) {
          // (CLUSTER 2: hb's last readers were the threads' share_stage loads)
          if (CLUSTER > 1) hopper::fence_proxy_async();
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
    } else if (CLUSTER > 1) {
      if (kind == B0_FWD)
        share_relu(act, sv);  // act = r_k, both CTAs' columns
      else
        share_stage(act, hb);  // act = s_k, both CTAs' columns
    } else {
      publish();  // act = r_k (fc_0) or hb = s_k (fc_1)
      if (kind == B1_FWD) A = hb;
    }
    const Gemm op = piece_gemm_of<false>(s, p.kin, p.C);
    // one product site, the epilogue chosen inside: so ptxas keeps the stream
    // and the accumulators where they are (a site per epilogue kind spilled)
    dense_gemm<MV>(q, ring, it, A, op.K, [&](int pc, float(&acc)[TILE_ACC]) {
      if (step_kind(s) == B0_FWD) {
        const int c0 = piece_col(pc);
        const float* bias = p.b_blk + (size_t)(2 * step_k(s)) * HID + cta_col0();
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
        const float* bias = (kind == IN_FWD  ? p.b_in
                             : kind == Z_FWD ? p.b_z + (size_t)k * HID
                                             : p.b_blk + (size_t)(2 * k + 1) * HID) +
                            cta_col0();
        // an injection's bias comes with its first piece only
        const bool biased = kind != Z_FWD || aux == 0;
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
        if (CLUSTER == 1 && (kind == Z_FWD || aux)) emit_relu(pc);
      }
    });
  }
  // t = bf16(relu(x)) of the last block: in act, or (CLUSTER 2) this CTA's
  // columns of it in hb
  unsigned char* t_tile = act;
  if (CLUSTER > 1) {
    t_tile = hb;
#pragma unroll
    for (int pc = 0; pc < TILE_NP; ++pc)
#pragma unroll
      for (int i = 0; i < TILE_ACC; i += 2)
        put2(hb, acc_row(i), piece_col(pc) + acc_col(i), fmaxf(sv[pc * TILE_ACC + i], 0.0f),
             fmaxf(sv[pc * TILE_ACC + i + 1], 0.0f));
  }
  __syncthreads();

  // lin_out on the CUDA cores: warp w takes points w, w + 8, ..; lane l the
  // OUT_COLS columns OUT_COLS l.. of t (of this CTA's), summed in order,
  // then across the warp
  const int lane = threadIdx.x & 31, d_out = p.d_out;
  // (w_out's bf16 rows i, i + 1 a register: its f32 values exactly, in half
  // the registers)
  uint32_t wo[OUT_COLS / 2][TILE_MAX_OUT];
#pragma unroll
  for (int i = 0; i < OUT_COLS / 2; ++i)
#pragma unroll
    for (int o = 0; o < TILE_MAX_OUT; ++o) {
      const size_t r = (size_t)(cta_col0() + OUT_COLS * lane + 2 * i) * d_out + o;
      wo[i][o] = o < d_out ? (uint32_t)__bfloat16_as_ushort(p.w_out[r]) |
                                 ((uint32_t)__bfloat16_as_ushort(p.w_out[r + d_out]) << 16)
                           : 0u;
    }
  // (CLUSTER 2) each CTA's sums over its columns go to the start of its act,
  // dead since the last fc_1: point r's output o at float r TILE_MAX_OUT + o
  float* part = reinterpret_cast<float*>(act);
  for (int r = threadIdx.x >> 5; r < TILE_PTS && row0() + r < p.B; r += TILE_THREADS / 32) {
    float acc[TILE_MAX_OUT] = {};
#pragma unroll
    for (int h = 0; h < OUT_COLS / OUT_VEC; ++h) {
      const unsigned char* a = t_tile + hopper::sw128_offset(r, OUT_COLS * lane + OUT_VEC * h);
      uint32_t words[4];
      if (OUT_VEC == 8) {
        const uint4 v = *reinterpret_cast<const uint4*>(a);
        words[0] = v.x, words[1] = v.y, words[2] = v.z, words[3] = v.w;
      } else if (OUT_VEC == 4) {
        const uint2 v = *reinterpret_cast<const uint2*>(a);
        words[0] = v.x, words[1] = v.y;
      } else {
        words[0] = *reinterpret_cast<const uint32_t*>(a);
      }
#pragma unroll
      for (int u = 0; u < OUT_VEC / 2; ++u)
#pragma unroll
        for (int o = 0; o < TILE_MAX_OUT; ++o) {
          acc[o] = fmaf(bf16_lo(words[u]), bf16_lo(wo[OUT_VEC * h / 2 + u][o]), acc[o]);
          acc[o] = fmaf(bf16_hi(words[u]), bf16_hi(wo[OUT_VEC * h / 2 + u][o]), acc[o]);
        }
    }
    float mine = 0.0f;  // lane o writes output o
#pragma unroll
    for (int o = 0; o < TILE_MAX_OUT; ++o) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
      if (lane == o) mine = acc[o];
    }
    if (CLUSTER > 1) {
      if (lane < d_out) part[r * TILE_MAX_OUT + lane] = mine;
    } else if (lane < d_out) {
      const int g = row0() + r;
      const float v = mine + p.b_out[lane];
      if (p.planar)
        p.out[(size_t)lane * p.B + g] = v;
      else
        p.out[(size_t)g * d_out + lane] = v;
    }
  }
  if (CLUSTER > 1) {
    // CTA c writes points [32 c, 32 c + 32) of the tile: CTA 0's sum, plus
    // CTA 1's, then the bias, in this order in both
    hopper::cluster_sync();  // both CTAs' sums are in
    const int e = threadIdx.x, n_own = TILE_PTS / CLUSTER;
    const int r = n_own * (int)hopper::cluster_ctarank() + e / TILE_MAX_OUT, o = e % TILE_MAX_OUT;
    if (e < n_own * TILE_MAX_OUT && o < d_out && row0() + r < p.B) {
      const uint32_t a = hopper::smem_u32(part + r * TILE_MAX_OUT + o);
      const float v =
          (hopper::ld_cluster_f32(hopper::mapa(a, 0)) + hopper::ld_cluster_f32(hopper::mapa(a, 1))) +
          p.b_out[o];
      const int g = row0() + r;
      if (p.planar)
        p.out[(size_t)o * p.B + g] = v;
      else
        p.out[(size_t)g * d_out + o] = v;
    }
    hopper::cluster_sync();  // the partner's reads of these sums are done
  }
}

template <bool GATHER, bool CODE, bool MV>
__device__ __forceinline__ void fwd_tile(const DenseParams& q) {
  extern __shared__ unsigned char f_smem_raw[];
  const TowerParams& p = q.t;
  const uint32_t raw = hopper::smem_u32(f_smem_raw);
  unsigned char* act = f_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* hb = act + ACT_BYTES;
  unsigned char* ring = hb + TILE_BYTES;
  const int n_tiles = (p.B + TILE_PTS - 1) / TILE_PTS;
  // a tile a CTA, or (CLUSTER 2) a tile a cluster's pair of CTAs
  const int unit = (int)blockIdx.x / CLUSTER, n_units = (int)gridDim.x / CLUSTER;

  if (threadIdx.x == 0) {
    for (int h = 0; h < 2; ++h)
      for (int st = 0; st < RING_STAGES; ++st) {
        hopper::mbar_init(&f_full[h][st], 1);
        hopper::mbar_init(&f_empty[h][st], 4);  // the warps of warpgroup h
      }
    hopper::mbar_init(&f_lat_full, 1);
    hopper::mbar_fence_init();
    // (one view on the walk of NS views: no fold)
    f_n_steps = fwd_program(f_prog, p.n_blocks, p.n_lin_z, MV && p.NS > 1,
                            MV ? p.pre : p.n_blocks, latent_pieces(p.C));
    if (MV) {
      f_n_gemms = f_seg_gemms = 0;
      for (int i = 0; i < f_n_steps; ++i) {
        if (step_kind(f_prog[i]) == FOLD) f_seg_gemms = f_n_gemms;  // the view segment's products
        else f_gprog[f_n_gemms++] = f_prog[i];
      }
      // the CTA's tiles are unit, + n_units, ..
      f_left[0] = f_left[1] = (n_tiles - unit + n_units - 1) / n_units;
      f_vleft[0] = f_vleft[1] = p.NS - 1;
      f_end = walk_at(f_n_steps, p.NS - 1);
      f_lat_n = 0;
    }
    f_feed[0] = f_feed[1] = DenseFeed{0, 0, 0};
  }
  __syncthreads();
  if ((threadIdx.x & 127) == 0)
    for (int st = 0; st < RING_STAGES; ++st) dense_feed<MV>(q, ring, st, threadIdx.x >> 7);

  uint32_t it = 0;  // stages taken
  if (MV) {
    // persistent CTAs walk the tiles, each with its view-sum slot; the
    // feeders run on into the next tile's stages
    for (int tile = unit; tile < n_tiles; tile += n_units) {
      __syncthreads();  // the previous tile's last readers of f_row0 are done
      if (threadIdx.x == 0) f_row0 = tile * TILE_PTS;
      __syncthreads();
      fwd_body<GATHER, CODE, true>(q, act, hb, ring, it);
    }
  } else {
    fwd_body<GATHER, CODE, false>(q, act, hb, ring, it);
  }
}

// At CLUSTER 2 the one-view kernels walk their tiles as the multi-view ones
// do, at one view (NS 1: no fold, no slot): persistent pairs, the same code
// as their multi-view twins (a tile a pair of its own spilled: 236-252 B).
template <bool CODE>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    resnetfc_fwd_dense_kernel(const __grid_constant__ DenseParams q) {
  fwd_tile<false, CODE, (CLUSTER > 1)>(q);
}

template <bool CODE>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    resnetfc_fwd_gather_kernel(const __grid_constant__ DenseParams q) {
  fwd_tile<true, CODE, (CLUSTER > 1)>(q);
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

// A grid of `units` tile units -- a CTA, or (CLUSTER 2) a cluster of two --
// one a 64-point tile (one view), or persistent (multi-view).  A cluster
// launch the card refuses returns its error.
int launch_tile(void (*kernel)(DenseParams), const DenseParams& q, int units, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TILE_SMEM);
  if (err != cudaSuccess) return (int)err;
  if (CLUSTER > 1)
    return (int)hopper::launch_cluster(kernel, units * CLUSTER, TILE_THREADS, TILE_SMEM, stream,
                                       CLUSTER, q);
  kernel<<<units, TILE_THREADS, TILE_SMEM, stream>>>(q);
  return (int)cudaGetLastError();
}

int tiles_of(int B) { return (B + TILE_PTS - 1) / TILE_PTS; }

// The tile units (CTAs, or clusters of CLUSTER CTAs) the card holds at once
// (every tile kernel holds an SM alone), or a negative cudaError_t; asked
// of the card once.
int resident_units() {
  static int n = 0;
  if (n <= 0) {
    void (*kernel)(DenseParams) = resnetfc_fwd_dense_kernel<false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILE_SMEM);
    n = err != cudaSuccess ? -(int)err
                           : hopper::max_active_clusters(kernel, TILE_THREADS, TILE_SMEM, CLUSTER);
  }
  return n;
}

// The units of a one-view launch: a CTA a tile, or at CLUSTER 2 persistent
// pairs, at most one a tile and no more than the card holds at once.
int one_view_units(int B) {
  if (CLUSTER == 1) return tiles_of(B);
  return resident_units() < tiles_of(B) ? resident_units() : tiles_of(B);
}

// The persistent units of a multi-view launch: at most one a tile, n_ctas /
// CLUSTER (the view-sum slots hold a CTA each), and at CLUSTER 2 no more
// clusters than the card holds at once (a persistent cluster that waited
// for another to finish would walk its tiles after it); below 1 if the card
// holds none.
int mv_units(int B, int n_ctas) {
  const int units = n_ctas / CLUSTER < tiles_of(B) ? n_ctas / CLUSTER : tiles_of(B);
  return CLUSTER > 1 && resident_units() < units ? resident_units() : units;
}

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
// kernels do not take.  The lookup builds one piece of at most TILE_K
// columns at a time into the operand tile: any C the dense kernels take.
bool gather_params(DenseParams& q, const void* idx, const void* w, int taps, const void* table,
                   int T) {
  if (taps < 4 || T < 1 || q.t.C % 8 != 0 || q.t.C > F_MAX_GATHER_C || idx == nullptr ||
      w == nullptr || table == nullptr || reinterpret_cast<uintptr_t>(table) % 16 != 0)
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

// What the tile kernels fix, for the wrapper to plan with: out[0..10] =
// points a tile, threads a CTA, weight-ring stages, the most outputs of
// lin_out, the most steps of a tile's stored program (one view's segment and
// the shared blocks), the widest code (and latent piece), the f32 words of
// a multi-view CTA's view-sum slot, the widest latent of the dense kernels,
// the tower's width this library is built for, the widest latent of the
// gather kernels' table, the CTAs of a tile (2: a cluster, at d_hidden
// 1024; else 1).
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
  out[8] = HID;
  out[9] = F_MAX_GATHER_C;
  out[10] = CLUSTER;
  *smem = TILE_SMEM;
  return sizeof(DensePlan);
}

// Fills `plan` (resnetfc_fwd_dense_limits' bytes) with the tensor maps of
// the packed weights w_in (kin, H), w_z (n_lin_z, C, H) and w_blk
// (n_blocks, 2, H, H), bf16 row-major, H the library's HID, in the boxes
// the products read (tile64.cuh's encode_weights).  A plan holds
// addresses but no buffer of a call, so a caller keeps it for as long as the
// weights stay where they are.
int resnetfc_fwd_dense_plan(void* plan, const void* w_in, const void* w_z, const void* w_blk,
                            int kin, int C, int n_blocks, int n_lin_z) {
  if (!dense_widths_ok(kin, C, n_blocks, n_lin_z)) return (int)cudaErrorInvalidValue;
  DensePlan d = {};
  int err = encode_weights(&d.m_in, w_in, kin, false);
  if (err == 0 && n_lin_z > 0) err = encode_weights(&d.m_z, w_z, (uint64_t)n_lin_z * C, false);
  if (err == 0) err = encode_weights(&d.m_blk, w_blk, (uint64_t)2 * n_blocks * HID, false);
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
  const int units = one_view_units(B);
  if (units < 1) return (int)cudaErrorInvalidConfiguration;
  return launch_tile(code ? resnetfc_fwd_dense_kernel<true> : resnetfc_fwd_dense_kernel<false>, q,
                     units, static_cast<cudaStream_t>(stream));
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
  const int units = one_view_units(B);
  if (units < 1) return (int)cudaErrorInvalidConfiguration;
  return launch_tile(code ? resnetfc_fwd_gather_kernel<true> : resnetfc_fwd_gather_kernel<false>,
                     q, units, static_cast<cudaStream_t>(stream));
}

// Multi-view, dense bf16 latent z (NS B, C) (null without injection): B =
// SB B_obj output points, NS views of each as object-major input rows; the
// first `pre` blocks run per view, the rest on their mean.  The plan's
// weights as resnetfc_fwd_dense; vsum holds n_ctas slots of
// resnetfc_fwd_dense_limits' f32 words, and the grid is at most n_ctas
// persistent CTAs (at d_hidden 1024 clusters of two, no more of them than
// the card holds at once: mv_units).
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
  const int units = mv_units(B, n_ctas);
  if (units < 1) return (int)cudaErrorInvalidConfiguration;
  return launch_tile(code ? resnetfc_fwd_dense_mv_kernel<true> : resnetfc_fwd_dense_mv_kernel<false>,
                     q, units, static_cast<cudaStream_t>(stream));
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
  const int units = mv_units(B, n_ctas);
  if (units < 1) return (int)cudaErrorInvalidConfiguration;
  return launch_tile(code ? resnetfc_fwd_gather_mv_kernel<true> : resnetfc_fwd_gather_mv_kernel<false>,
                     q, units, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

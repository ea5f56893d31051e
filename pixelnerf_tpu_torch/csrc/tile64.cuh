// The 64-point wgmma tile of the ResnetFC kernels for Hopper (sm_90a), which
// the forward kernels (resnetfc_fwd.cu: resnetfc_fwd_dense, the fused gather
// resnetfc_fwd_gather, and the multi-view resnetfc_fwd_dense_mv and
// resnetfc_fwd_gather_mv) and the backward's data kernel (resnetfc_bwd.cu,
// resnetfc_bwd_data) share:
// - a tile is 64 points, one wgmma M, walked by 256 threads: warpgroups 0
//   and 1 each own half of the HID columns of every layer for all 64 points
//   (256 of 512 at sn64, 192 of 384, 32 of 64), their share of the f32
//   residual stream (or of its cotangent) in HID / 4 registers a thread;
// - every product is wgmma pieces of TILE_PIECE columns (m64n128k16, two a
//   warpgroup at HID 512, one at 256; m64n64k16, three at 384, one at 128;
//   m64n32k16, one at 64; at 192 and 320, whose halves of 96 and 160
//   columns are no whole 64-column pieces, one m64n96k16 and two
//   m64n80k16): operand A a 64 x 512 bf16 tile in shared memory,
//   K-major with the 128-byte swizzle (hopper::sw128_offset), written by the
//   threads from their accumulators (put2) and published to the async proxy
//   (publish);
//   operand B TMA boxes of 64 K rows of the packed row-major weights (64
//   columns, 128-byte swizzle; where a piece is not whole 64-column boxes,
//   32 columns, 64-byte swizzle, or 16, 32-byte swizzle: W_BOX_COLS)
//   through a ring of RING_STAGES stages, at most 96 KB in all;
// - a tile's work is a program of steps (Kind, step) whose products read
//   their weights as gemm_of says.  At NS views the steps of one view are
//   stored once and walked NS times, the walk position carrying the view
//   (walk_at): so a program's length does not grow with the view count.
// The forward and the data kernel take the products in the same order -- the
// same pieces, the same k16 steps, each bias added to the f32 product before
// the residual add, the views folded in the same order -- so the backward's
// recompute reproduces the forward's f32 stream bit for bit, at one view and
// at NS views.
//
// Per point (one view; each view below combine_layer at NS > 1):
//   x = lin_in(code)
//   for k < n_blocks:  [x += lin_z_k(z) while k < n_lin_z]
//                      x += fc_1(relu(fc_0(relu(x))))
// with bf16 operands and f32 accumulation: the code, z and every relu output
// are rounded to bf16 before their product, biases and the residual stream
// stay f32, and each layer adds its bias to the f32 product before the
// residual add.  At NS > 1 the views' mean is the TPU kernel's sum(xs) *
// (1 / NS): an f32 sum in view order, then one multiply.
//
// Input rows are where the model's query leaves them, object-major: point b
// of object s, view v is row (s NS + v) B_obj + b, and its output column is
// s B_obj + b (src_row).  The multi-view gather's idx/w rows are view-major
// (SB = 1, the same formula) and view v reads table v.
//
// Deferred positional code (the CODE variants, the port of
// resnetfc_pallas.py::_x_feat): x holds the raw (rows, d_raw) f32 coordinates
// and the tile's code is evaluated while it is loaded,
//   xg[c] = sum_j raw[j] code_w[j, c]   (f32, j in order; not a tensor-core
//                                        product: its rounding would be
//                                        amplified by the frequencies)
//   enc[c] = code_m[c] > 0 ? sinf(xg[c] code_f[c] + code_p[c]) : xg[c]
// and rounded to bf16 only after the sin.  sinf is the accurate one: the
// arguments reach ~70 rad, where __sinf's error grows.  The code arrays
// (~1.7 KB at sn64) are read through the read-only cache.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace rfc {

typedef __nv_bfloat16 bf16;

// The tower's width (d_hidden): the N of every product, the f32 stream, the
// bias strides and the weights' rows.  One library is built for each width,
// with -DRFC_HID=<width>: every multiple of 64 up to 512 but 448 (every
// config in conf/ uses 512, ResnetFC's default is 128), and 1024 for the
// forward kernels only.  A tower of any other width up to 1024 runs on the
// next library's, its weights zero-padded to that width
// (ops/resnetfc_fused.py, library_width).  448 has no library of its own:
// its pieces (seven of 32 columns a warpgroup; two of 112 spilled) ran
// slower than the same tower padded onto 512's.
#ifndef RFC_HID
#define RFC_HID 512
#endif
constexpr int HID = RFC_HID;
static_assert(HID == 64 || HID == 128 || HID == 192 || HID == 256 || HID == 320 || HID == 384 ||
                  HID == 512 || HID == 1024,
              "the tile takes d_hidden 64, 128, 192, 256, 320, 384, 512 or 1024");

// Past 512 columns one CTA cannot hold a 64-point tile: its f32 stream (256
// KB at 1024) alone fills an SM's registers.  At HID 1024 a tile is one
// thread-block cluster of CLUSTER = 2 CTAs on neighbouring SMs, and CTA r
// (%cluster_ctarank) owns columns [CTA_HID r, CTA_HID (r + 1)) of every
// product's N, of the f32 stream and of each bias; inside a CTA the layout
// is the 512-wide one (two warpgroups of 256 columns, 128 stream registers
// a thread; its pieces are 64 columns wide, TILE_PIECE).  A block product's operand A is the full
// K = HID bf16 activation (128 KB, ACT_BYTES): each CTA writes its own
// columns of it into its own copy and into its partner's (distributed shared
// memory), and the pair meets at a cluster barrier before either reads it.
// Every output column's K sum runs over k = 0..HID - 1 in order, the same
// k16 steps in both CTAs, as at the narrower widths: the order a recompute
// of this forward has to follow to reproduce its f32 stream bit for bit.
constexpr int CLUSTER = HID > 512 ? 2 : 1;
constexpr int CTA_HID = HID / CLUSTER;  // the columns a CTA owns: HID up to 512, 512 at 1024
// The operand tile's K capacity, the same at every HID: the widest code, and
// the widest piece of a latent (so sn64's C = 512 latent is one piece at any
// tower width).
constexpr int TILE_K = 512;
// The widest latent, 4096 columns (ResNet50's unified map at 5 layers is
// 3904): an injection of a latent wider than one operand tile runs as pieces
// of at most TILE_K columns (latent_pieces: 8 at most), each a step of its
// own -- in the forward and the recompute a product that adds to the f32
// stream (the dense kernels' piece by TMA, the gathers' built by the
// threads), in the walk back a product that writes its own columns of dz.
constexpr int MAX_C = 8 * TILE_K;

// The pieces of TILE_K columns an injection of a C-wide latent takes (1 up
// to C = 512, 4 at ResNet50's 1856, 8 at 3904; 0 without a latent).  The
// last piece is ragged when C is not a multiple of 512 (320 columns at 1856
// and 3904): its product's K stops at C.
__host__ __device__ inline int latent_pieces(int C) { return (C + TILE_K - 1) / TILE_K; }
// The steps of HID dz columns the data kernel's walk back takes for an
// injection of a C-wide latent: a product's N is the tower's HID columns (a
// warpgroup's half in its pieces), so each step forms HID columns of dz
// (latent_pieces(C) at HID 512; 4 at C = 512 and HID 128, 8 at HID 64, 2
// at HID 384, 61 at C = 3904 and HID 64).  Columns at or past C (the second
// step's 384-767 at C = 512 and HID 384; the fourth's 1856-2047 at 1856 and
// HID 512) are formed from what TMA reads there and dropped by the wrapper.
__host__ __device__ inline int dz_pieces(int C) { return (C + HID - 1) / HID; }

struct TowerParams {
  const bf16* z;       // (NS B, C) dense latent (the dense kernels); unused by the gather kernels
  const int* idx;      // (NS B, taps) int32 tap rows, columns 0..3 used
  const float* w;      // (NS B, taps) f32 tap weights
  const bf16* table;   // (NS, T, C) feature tables
  const float* x;      // (NS B, d_in) f32 coordinate code, or (NS B, d_raw) raw coordinates
  const bf16* w_in;    // (kin, H), rows >= d_in are zero
  const float* b_in;   // (H)
  const bf16* w_z;     // (n_lin_z, C, H)
  const float* b_z;    // (n_lin_z, H)
  const bf16* w_blk;   // (n_blocks, 2, H, H): fc_0, fc_1
  const float* b_blk;  // (n_blocks, 2, H)
  const bf16* w_out;   // (H, d_out)
  const float* b_out;  // (d_out)
  float* out;          // (d_out, B) when planar, else (B, d_out)
  float* vsum;         // (gridDim.x, slot) view-sum slots, multi-view only
  int B, d_in, kin, C, T, taps, n_blocks, n_lin_z, d_out, planar;
  // views, points per object (B = SB B_obj) and the blocks each view runs on
  // its own (combine_layer; n_blocks when NS == 1)
  int NS, B_obj, pre;
  // the deferred positional code (CODE variant only): x is then the raw
  // (NS B, d_raw) coordinates
  const float* code_w;  // (d_raw, d_in) f32 select matrix
  const float* code_f;  // (d_in) f32 per-column frequency
  const float* code_p;  // (d_in) f32 per-column phase
  const float* code_m;  // (d_in) f32, > 0 where the sin applies
  int d_raw;
};

// The input row of output point g in view v (object-major rows).
__device__ __forceinline__ size_t src_row(const TowerParams& p, int g, int v) {
  if (p.NS == 1) return (size_t)g;
  const int s = g / p.B_obj;
  return ((size_t)s * p.NS + v) * p.B_obj + (g - s * p.B_obj);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

inline TowerParams tower_params(const void* x, const void* w_in, const void* b_in, const void* w_z,
                                const void* b_z, const void* w_blk, const void* b_blk,
                                const void* w_out, const void* b_out, int B, int d_in, int kin,
                                int C, int n_blocks, int n_lin_z, int d_out) {
  TowerParams p = {};
  p.x = static_cast<const float*>(x);
  p.w_in = static_cast<const bf16*>(w_in);
  p.b_in = static_cast<const float*>(b_in);
  p.w_z = static_cast<const bf16*>(w_z);
  p.b_z = static_cast<const float*>(b_z);
  p.w_blk = static_cast<const bf16*>(w_blk);
  p.b_blk = static_cast<const float*>(b_blk);
  p.w_out = static_cast<const bf16*>(w_out);
  p.b_out = static_cast<const float*>(b_out);
  p.B = B;
  p.d_in = d_in;
  p.kin = kin;
  p.C = C;
  p.n_blocks = n_blocks;
  p.n_lin_z = n_lin_z;
  p.d_out = d_out;
  p.NS = 1;
  p.B_obj = B;
  p.pre = n_blocks;
  return p;
}

constexpr int TILE_PTS = 64;        // points a tile: one wgmma M
// two warpgroups and no producer warp: thread 0 also keeps the weight ring
// fed, so that every thread may hold 255 registers (a ninth warp would leave
// three warps on one SM quarter's 16 K registers: 168 each)
constexpr int TILE_THREADS = 256;
// (the numbers at HID 512; at 256 one piece a warpgroup, at 128 one piece
// of 64 columns, wgmma m64n64k16, and a ring of 6 stages of 16 KB; at 384
// three such pieces a warpgroup, the same ring; at 64 one piece of 32
// columns, wgmma m64n32k16, from one 64 x 32 box a warpgroup, and a ring of
// 12 stages of 8 KB; at 192 one
// piece of 96 columns, wgmma m64n96k16, from three 64 x 32 boxes a
// warpgroup, and a ring of 4 stages of 24 KB; at 320 two pieces of 80,
// m64n80k16, each five 64 x 16 boxes (the 32-byte swizzle), and a ring of
// 4 stages of 20 KB)
constexpr int TILE_HALF = CTA_HID / 2;  // columns a warpgroup owns: 256 (at 1024 too)
// columns of one product: 128 where they divide a warpgroup's half, else 64
// (a half of 192 at HID 384 is three pieces of 64), else the whole half up
// to 128 (32 at HID 64, 96 at 192), else half of it (80 at 320).  Fewer
// and larger stages than pieces of 32 (the per-stage waits, not the FLOP,
// set a narrow tile's time) where the registers allow: a piece of 160 at
// 320 spilled the multi-view data kernel (its 255 registers).  At HID 1024
// four pieces of 64: 32 accumulators a thread beside the stream, and whole
// 64-row stages of 16 KB in the 32 KB ring that the 128 KB operand tile
// leaves (two pieces of 128 need stages of 32 K rows)
constexpr int TILE_PIECE = CLUSTER > 1             ? 64
                           : TILE_HALF % 128 == 0 ? 128
                           : TILE_HALF % 64 == 0  ? 64
                           : TILE_HALF <= 128     ? TILE_HALF
                                                  : TILE_HALF / 2;
static_assert(TILE_HALF % TILE_PIECE == 0 && TILE_PIECE % 16 == 0,
              "a warpgroup's half is whole pieces of whole boxes");
// a weight box's columns: 64 (128 bytes, the 128-byte swizzle) where they
// divide a piece, else 32 (64 bytes, the 64-byte swizzle), else 16 (32
// bytes, the 32-byte swizzle)
constexpr int W_BOX_COLS = TILE_PIECE % 64 == 0 ? 64 : TILE_PIECE % 32 == 0 ? 32 : 16;
constexpr uint32_t W_BOX_BYTES = 64 * W_BOX_COLS * 2;  // 64 rows of K: 8 KB (4 / 2 KB at 32 / 16 columns)
constexpr int TILE_BPW = TILE_PIECE / W_BOX_COLS;  // weight boxes a warpgroup a stage: 2 (3 at 192, 5 at 320)
constexpr int TILE_NP = TILE_HALF / TILE_PIECE;  // pieces a warpgroup: 2 (3 at HID 384, 4 at 1024; 1 at 256, 128, 64, 192)
constexpr int TILE_ACC = TILE_PIECE * TILE_PTS / 128;  // f32 accumulators a thread a piece: 64
constexpr int TILE_STREAM = TILE_NP * TILE_ACC;        // a thread's share of a 64 x CTA_HID stream: 128
constexpr uint32_t BOX_BYTES = 64 * 128;  // a 64 x 64 bf16 box of an operand tile (latent, masks)
constexpr uint32_t STAGE_BYTES = 2 * TILE_BPW * W_BOX_BYTES;  // 64 of K x the two warpgroups' pieces
// 96 KB of weights in flight: 3 stages, 6 at HID 128 and 384, 12 at 64, 4
// at 192 and 320; at 1024, where the 128 KB operand tile leaves 32 KB of
// shared memory for the ring, 2 stages of 16 KB
constexpr int RING_STAGES = (CLUSTER > 1 ? 32768 : 3 * 32768) / STAGE_BYTES;
static_assert(RING_STAGES >= 2, "the ring holds a stage being read and one being loaded");
constexpr uint32_t TILE_BYTES = TILE_PTS * TILE_K * 2;        // a 64 x 512 bf16 operand tile
// the operand tile of the block products (act): K = HID columns, 128 KB at
// 1024; the other operand tile (the code, a latent piece) stays TILE_BYTES
constexpr uint32_t ACT_BYTES = TILE_PTS * (HID > TILE_K ? HID : TILE_K) * 2;
constexpr size_t TILE_SMEM = ACT_BYTES + TILE_BYTES + (size_t)RING_STAGES * STAGE_BYTES + 1024;  // + alignment
// (the card gives a CTA 232,448 B; the kernels' static shared memory, under
// 2 KB, comes on top)
static_assert(TILE_SMEM + 2048 <= 232448, "a CTA's shared memory");

constexpr int TILE_MAX_OUT = 4;  // outputs of lin_out the tile kernels take (d_out 4 in every config)

// One k16 step of a piece's product: wgmma m64n128k16 at 64 accumulators a
// thread, m64n64k16 at 32 (HID 128, 384 and 1024), m64n32k16 at 16 (HID 64),
// m64n96k16 at 48 (HID 192), m64n80k16 at 40 (HID 320).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_piece(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  hopper::wgmma_m64n128k16<TA, TB>(d, a, b, scale_d);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_piece(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
  hopper::wgmma_m64n96k16<TA, TB>(d, a, b, scale_d);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_piece(float (&d)[40], uint64_t a, uint64_t b, int scale_d) {
  hopper::wgmma_m64n80k16<TA, TB>(d, a, b, scale_d);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_piece(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  hopper::wgmma_m64n64k16<TA, TB>(d, a, b, scale_d);
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_piece(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  hopper::wgmma_m64n32k16<TA, TB>(d, a, b, scale_d);
}

// Operand B of k16 step kk of a stage, x W: a warpgroup's weight boxes of
// the stage at `b`, read MN-major (64 K rows of W_BOX_COLS columns each; box
// j holds the piece's columns j W_BOX_COLS.., the leading byte offset).
__device__ __forceinline__ uint64_t w_desc(const unsigned char* b, int kk) {
  if (W_BOX_COLS == 64) return hopper::desc_sw128(b + kk * 2048, W_BOX_BYTES, 1024);
  if (W_BOX_COLS == 32) return hopper::desc_sw64(b + kk * 1024, W_BOX_BYTES, 512);
  return hopper::desc_sw32(b + kk * 512, W_BOX_BYTES, 256);
}

// The tensor map of a packed (rows, HID) row-major weight array as the
// products read it: boxes of 64 K rows x W_BOX_COLS columns (x W), or, walked
// back (B = W^T, read K-major), W_BOX_COLS rows (the product's columns) x 64
// K columns, 128-byte swizzled, a piece's boxes one after another (its rows
// in order).  At 64-column boxes both are 64 x 64 boxes.
inline int encode_weights(CUtensorMap* map, const void* w, uint64_t rows, bool walk_back) {
  return walk_back ? hopper::encode_bf16(map, w, rows, HID, HID, W_BOX_COLS, 64)
                   : hopper::encode_bf16(map, w, rows, HID, HID, 64, W_BOX_COLS);
}

// The first column this CTA owns: 0, or at HID 1024 CTA_HID times its rank
// in the cluster.
__device__ __forceinline__ int cta_col0() {
  if (CLUSTER == 1) return 0;
  return (int)hopper::cluster_ctarank() * CTA_HID;
}

// Where accumulator i of this thread lies in a 64 x TILE_PIECE piece: row,
// and the first of two neighbouring columns (i even; i + 1 is the next
// column).
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3); }

// Memory accesses are not moved across this point: a loop over the stream
// fenced every few elements reads only those elements ahead, so that its
// reads do not all wait in registers beside the stream and the accumulators.
__device__ __forceinline__ void group_fence() { asm volatile("" ::: "memory"); }

// This warpgroup's first column of piece p, among its CTA's (cta_col0()
// before them in the tower).
__device__ __forceinline__ int piece_col(int p) { return (threadIdx.x >> 7) * TILE_HALF + p * TILE_PIECE; }

// Shared-memory writes by the threads made visible to the products that
// read them next.
__device__ __forceinline__ void publish() {
  hopper::fence_proxy_async();
  __syncthreads();
}

// Two f32 values as bf16 at (r, c), (r, c + 1) of a swizzled operand tile.
__device__ __forceinline__ void put2(unsigned char* tile, int r, int c, float a, float b) {
  *reinterpret_cast<uint32_t*>(tile + hopper::sw128_offset(r, c)) = pack_bf16x2(a, b);
}

// A tile's program, the same for every tile: a list of steps that every
// thread walks in order, and that thread 0 also walks, ahead, to feed the
// weight ring with the products' boxes.  A step is one product (with what
// precedes it and its epilogue) or one action between products; each kind's
// code exists once, so a kernel stays small.  The forward runs the first five
// kinds; the data kernel all of them.
enum Kind {
  IN_FWD,  // lin_in of the view: x = code W_in + b_in (aux: emit relu(x))
  Z_FWD,   // injection k of the view: x += z W_z[k] + b_z[k] (aux: the latent's piece, the bias with piece 0)
  B0_FWD,  // fc_0 of block k: s = relu(r_k W0 + b0), r_k = relu(x) stashed
  B1_FWD,  // fc_1 of block k: x += s_k W1 + b1, s_k stashed (aux: emit relu(x))
  FOLD,    // the view's x into the view mean (multi-view)
  T_OUT,   // t stashed; lin_out's sums; the cotangent of t
  GB,      // gb = bf16(cotangent of block k's output) into act, stashed, summed
  Z_BWD,   // dz_v (+)= gb W_z[k]^T (aux: dz's HID-column step; the view's first injection, k = n_lin_z - 1, writes)
  B1_BWD,  // dh = gb W1^T [s_k > 0] into hb, summed
  B0_BWD,  // cotangent += bf16(dh) W0^T [r_k > 0], dh stashed
  DVIEW,   // the view's walk starts from dview = cotangent / NS (multi-view)
  G_IN,    // the cotangent of lin_in's output into act, stashed, summed; dx
};
// A step word is 16 bits: the kind, the block k (< 64: the forward's program
// holds 62 blocks, the data kernel checks its towers) and aux (< 64: a
// latent's piece, or the walk back's dz step, at most 64 of HID >= 64
// columns in a 4096-wide latent), so that the data kernel stores 512 steps
// where 256 words of 32 bits would fit.
__host__ __device__ constexpr int step(int kind, int k, int aux) {
  return kind | (k << 4) | (aux << 10);
}
constexpr int STEP_MAX_K = 64;
__device__ __forceinline__ int step_kind(int s) { return s & 15; }
__device__ __forceinline__ int step_k(int s) { return (s >> 4) & 63; }
__device__ __forceinline__ int step_aux(int s) { return s >> 10; }
// A walk position: the index of a stored step in the low 12 bits and the
// view above them, so that one register walks a segment of the program once
// for each view.  The step word itself stays the stored one: its users read
// the view from the walk.
constexpr int WALK_IDX = (1 << 12) - 1;
__device__ __forceinline__ int walk_idx(int si) { return si & WALK_IDX; }
__device__ __forceinline__ int walk_view(int si) { return si >> 12; }
__device__ __forceinline__ int walk_at(int i, int v) { return i | (v << 12); }
__device__ __forceinline__ bool is_gemm(int kind) {
  return kind != FOLD && kind != T_OUT && kind != GB && kind != DVIEW && kind != G_IN;
}

// The weight operand of a product step: map (0 w_in, 1 w_z, 2 w_blk), walk
// back (B = W^T) or not, first weight row, K.
struct Gemm {
  int map, trans, rowbase, K;
};
__device__ __forceinline__ Gemm gemm_of(int s, int kin, int C) {
  const int k = step_k(s);
  switch (step_kind(s)) {
    case IN_FWD: return Gemm{0, 0, 0, kin};
    case Z_FWD: return Gemm{1, 0, k * C, C};
    case B0_FWD: return Gemm{2, 0, 2 * k * HID, HID};
    case B1_FWD: return Gemm{2, 0, (2 * k + 1) * HID, HID};
    case Z_BWD: return Gemm{1, 1, k * C, HID};
    case B1_BWD: return Gemm{2, 1, (2 * k + 1) * HID, HID};
    default: return Gemm{2, 1, 2 * k * HID, HID};  // B0_BWD
  }
}

// The weight operand of a product step with the latent in pieces: gemm_of,
// but the forward's (and the recompute's) piece j (Z_FWD, aux j) reads rows
// j TILE_K.. of W_z[k], at most TILE_K of them as K, and in the data kernel
// (WALK_BACK) the walk back's step j (Z_BWD, aux j; dz_pieces) rows j HID..
// as the product's HID columns.  Every tile kernel's products and feeders
// call it.
template <bool WALK_BACK>
__device__ __forceinline__ Gemm piece_gemm_of(int s, int kin, int C) {
  const int kind = step_kind(s);
  if (kind == Z_FWD) {
    const int off = step_aux(s) * TILE_K;
    return Gemm{1, 0, step_k(s) * C + off, min(TILE_K, C - off)};
  }
  if (WALK_BACK && kind == Z_BWD)
    return Gemm{1, 1, step_k(s) * C + step_aux(s) * HID, HID};
  return gemm_of(s, kin, C);
}

}  // namespace rfc

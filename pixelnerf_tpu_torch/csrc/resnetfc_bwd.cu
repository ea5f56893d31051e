// ResnetFC backward for Hopper (sm_90a): the port of
// pixelnerf_tpu/ops/resnetfc_vjp.py::_bwd_kernel (reached through _core_bwd),
// for one view and for NS > 1 views, as two kernels that together compute
// what the TPU kernel does:
//
//   resnetfc_bwd_data     one CTA per 64-point tile (multi-view: persistent
//                         CTAs walking the tiles).  Recomputes the forward
//                         (lin_in, the injections, the blocks; bf16 operands,
//                         f32 sums), then backpropagates through lin_out, the
//                         blocks and the injections.  It writes dz (and dx
//                         when asked) per point, stashes the products'
//                         operands for the weight gradients in a workspace --
//                         the bf16 operands r_k, s_k of every block and t of
//                         lin_out, the bf16 cotangents of every layer and the
//                         bf16 code (and, multi-view, latent) -- and writes
//                         f32 column sums per 32 rows for the biases and the
//                         thin lin_out product.
//   resnetfc_bwd_weights  the _dot_aTg products of _bwd_kernel
//                         (resnetfc_vjp.py:156): dW = A^T . G over the point
//                         axis for every weight matrix (lin_in, lin_z_k,
//                         fc_0/fc_1 of every block) as one grouped split-K
//                         GEMM on wgmma fed by TMA (hopper_mma.cuh); and the
//                         per-tile bias sums reduced in tile order.  Both
//                         reductions are deterministic: two calls on the same
//                         inputs give the same bits.
//
// Multi-view (resnetfc_vjp.py:305-327): the recompute runs every view's
// blocks k < pre and folds them into the mean (the FOLD step); the walk back
// runs the shared blocks k >= pre once, takes dview = dxc * (1 / NS), and
// walks each view back through its own stashed operands from that same f32
// start.  The view sum and dview are the 64 x HID f32 tile's worth of a
// CTA's stream, kept in a per-CTA device-memory slot.  The layers below the
// mean have NS workspace planes (view v at +v), so their weight products sum
// over NS B_pad rows -- the views are simply more points -- and those above
// it over B_pad rows.
//
// Numerics (resnetfc_vjp.py:279-331): each block's weight gradient takes the
// bf16-rounded cotangent, its bias gradient sums the f32 one; dz accumulates
// bf16(dv) . W_z[k]^T in f32 over the injections (the wrapper casts it to z's
// dtype); weight gradients are cast to the packed weights' dtype (bf16), as the
// TPU kernel's are.  Rows past B carry a zero cotangent and so contribute
// nothing; latent rows past B are read as zeros.
//
// What bounds it: 6 H (kin + n_lin_z C + 2 n_blocks H + d_out) FLOP per point
// and view below the mean, ~20.6 MFLOP at sn64 and one view (recompute, data
// gradient, weight gradient), against ~1.1 KB of input per point: tensor-core
// operations bound the function.  This design adds ~21 KB of workspace per
// point and view, written once and read once (~2 GB of traffic at 49,152
// points and one view, ~0.6 ms at 3.35 TB/s), which stays below the
// operations bound.
//
// The data kernel on its own: two thirds of those FLOP (the recompute and
// the data gradients), a bound of 0.68 ms at -V 1's fine pass on an H100 SXM
// (989 TFLOP/s).  What held its 32-point wmma predecessor to ~100 TFLOP/s
// was the weights' trip out of L2:
// every tile read all of them twice (forward and transposed, ~13.6 MB at
// sn64) through per-warp cp.async slabs, ~3.2 TB/s of L2 reads, with the
// products on nvcuda::wmma at the 255-register limit.  This design halves
// that traffic and moves the products to wgmma:
// - 64-point tiles, 256 threads: warpgroups 0 and 1 each own half of the
//   HID columns of every layer for all 64 points (its share of the f32
//   stream or of its cotangent in HID / 4 registers a thread: 128 at sn64's
//   512); thread 0 also keeps the weight ring fed.  HID is the library's
//   tower width (-DRFC_HID: every multiple of 64 up to 512 but 448, one library each, as
//   the forward's; the numbers here are 512's).  A producer warp would cost
//   registers: a ninth warp leaves three warps on one SM quarter's 16 K
//   registers, 168 a thread, and setmaxnreg did not lift ptxas' allocation
//   past the launch bound's 168;
// - every product is the tile's wgmma pieces (m64n128k16; m64n64k16 at
//   HID 128 and, three a warpgroup, at 384; m64n32k16 at 64; m64n96k16 at
//   192; two m64n80k16 at 320): operand A a
//   64 x 512 bf16 tile in shared memory (act or hb), K-major with the
//   128-byte swizzle, written by the threads from their accumulators and
//   published to the async proxy (fence.proxy.async + a CTA barrier);
//   operand B 64 x 64 TMA boxes of the packed row-major weights through a
//   96 KB full / empty mbarrier ring (3 stages of 32 KB; 6 of 16 KB at HID
//   128 and 384, 12 of 8 KB at 64, 4 of 24 KB at 192, 4 of 20 KB at 320):
//   MN-major for
//   x W, and the same boxes K-major for dh W^T, so no transposed copy of a
//   weight exists.  Where a piece is not whole 64-column boxes (HID 64,
//   192, 320) x W reads 64 x 32 boxes (64-byte swizzle; 64 x 16, the
//   32-byte swizzle, at 320), dh W^T 32 x 64 (16 x 64) boxes of W's
//   rows, each through a tensor map of its own (m_zt, m_blkt);
// - the tile's work is a program of steps (data_program) that every thread
//   walks and thread 0 also walks ahead to feed the ring;
// - the walk back's relu masks, the r_k and s_k planes just stashed, come
//   back by TMA into the operand tile that the product does not read;
// - the thin parts stay on the CUDA cores: lin_out's d_out = 4 product and
//   its column sums, dx (d_in <= kin <= 512 columns: a thread forms one
//   point's column, a dot product over HID), the per-32-row bias sums
//   (shuffles within a warp, then the half's second warp adds to the
//   first's after a warpgroup barrier), dz's f32 read-modify-write in
//   injection order by the thread that wrote it;
// - a 64-point tile writes two rows of per-32-row sums, so the DataOut
//   (B_pad = B rounded up to 32) is the weights kernel's as before; a last
//   tile half past B_pad reads zeros and writes nothing there;
// - no atomics: two calls on the same inputs give the same bits;
// - a latent of any width the forward takes (16 <= C <= 4096, a multiple of
//   16: the ConvEncoder's 128, the global encoder's 640, ResNet50's 832,
//   1856 and 3904) in the forward's pieces (tile64.cuh, latent_pieces, 8 at
//   most): the recompute injects each piece of at most 512 columns as a step
//   of its own (its rows of W_z as K, the bias with the first; the last
//   piece's K stops at C), and the walk back forms dz HID columns a step
//   (dz_pieces: its rows of W_z as the product's HID columns) into a
//   (NS B_pad, HID) f32 plane of its own, which the wrapper joins into dz's
//   C columns: so each step's epilogue is the one-piece epilogue (no column
//   test, constant row stride: a stride-C epilogue spilled the multi-view
//   kernel's registers).  Columns at or past C are computed from whatever
//   W_z rows TMA reads there (zeros past the array) into the plane's unused
//   part, whether or not C is a multiple of HID.  At HID 512 and C <= 512
//   the program and the arithmetic are those of one piece; at HID 128, C =
//   512 takes 4 walk-back steps an injection, 8 at HID 64, 2 at HID 384 (the
//   second step's columns 384-767: W_z rows past C are the next
//   injection's, or TMA's zeros past the array, and land in the plane's
//   unused part, which the wrapper drops); C = 1856 takes 4 at HID 512 (the
//   fourth's columns 1856-2047 dropped) and 3904 takes 61 at HID 64, within
//   the stored program at sn64's three injections (235 steps).
// The tile, its constants and its step kinds are in tile64.cuh, which the
// dense forwards (resnetfc_fwd_dense, and resnetfc_fwd_dense_mv at NS > 1)
// share: their programs are this kernel's recompute, so it takes the primal's
// products in the primal's order and folds the views in its order, bit for
// bit.  The backward's gates still allow <= 1e-3 relu-mask flips against the
// plain recompute, whose f32 sums run in another order.
//
// The weights kernel on its own is bound by bytes on an H100 SXM: the train
// step's fine pass reads its workspace once, 1.18 GB at -V 1 and 2.4 GiB at
// -V 3 (0.35 and 0.82 ms at 3.35 TB/s), against 3.4e11 and 8.1e11 FLOP (0.34
// and 0.81 ms at 989 TFLOP/s).  Its design: 128 x WT_N output tiles (WT_N =
// min(256, HID), 192 at HID 384, 160 at 320), each one m64n256k16 product
// per consumer warpgroup (m64n192k16 at HID 384 and 192, m64n160k16 at 320,
// m64n128k16 at 128, m64n64k16 at 64),
// both operands
// MN-major (the
// planes are (points, width) row-major and the product sums over points)
// straight from 128-byte-swizzled TMA boxes of 64 points, so no thread
// touches an operand; a 4-stage full / empty mbarrier ring kept full by one
// producer thread; the point axis split so that the CTAs fill the SMs in
// whole waves, numbered split-major so that the CTAs in flight share their A
// and G strips in L2; ragged edges (B rows of z read in place, kin < 64)
// come from TMA's zero fill, and a ragged last M tile (lin_in's at kin 144:
// rows 128-143) reads zeros past the operand's columns and writes only its
// rows.  The tensor maps and the task table are encoded
// once per set of operand addresses (resnetfc_bwd_weights_plan) and kept by
// the wrapper, which copies them to device memory once, so a launch costs the
// host one parameter copy; the kernel's producer acquires each map it reads
// for the tensormap proxy.  They hold every tower the forward kernels take
// (MAX_MAPS, MAX_TASKS: 62 blocks at sn64's three injections; the data
// kernel's program holds them too).

#include <stddef.h>
#include <string.h>

#include "tile64.cuh"

// The backward is built at the widths up to 512 only: its tile has no
// cluster layout (tile64.cuh, CLUSTER).
static_assert(rfc::CLUSTER == 1, "the backward kernels take d_hidden up to 512");

namespace {

using namespace rfc;

// The tower's width is the tile's HID, one library a width (tile64.cuh):
// the workspace planes, the rows of sums, the view-sum slot and each dz
// plane are HID columns wide; the operand tiles keep TILE_K columns (the
// code, a latent's piece).

// ---------------------------------------------------------------------------
// data gradients: 64-point tiles on wgmma, weights fed by TMA
// ---------------------------------------------------------------------------

// steps of one tile's stored program (data_program; sn64: 34 at one view, 36
// at any view count: one view's recompute and walk back, the shared steps;
// five more a block; two more an injection at 512 < C <= 1024, fourteen at
// 3584 < C <= 4096 (8 pieces each way); seven more an injection at HID 64,
// three at HID 128, one at HID 256 and at 384, two at 192, C = 512; 235 at
// HID 64 and C = 3904), as 16-bit step words (tile64.cuh): 1 KB, which
// holds every tower the forward's program does at sn64's other widths (62
// blocks, 319 steps at one view; 61 at NS > 1, 316), and 64 blocks (the
// step's k) at most
constexpr int D_MAX_STEPS = 512;
// f32 words of one CTA's view-sum slot (multi-view): every thread's share of
// the 64 x HID stream
constexpr int D_SLOT_FLOATS = TILE_STREAM * TILE_THREADS;
// named barrier 2 + wg: over warpgroup wg

// Workspace planes, in units of one (B_pad, H) plane.  A layer below the
// view mean has NS planes (view v at +v), one above it has one.  Block k's
// first plane is plane_at(k) (NS == 1: k), so the stashed operands of block
// k sit at 2 plane_at(k) (r_k) and 2 plane_at(k) + NS or 1 (s_k), and t
// after all blocks.
__device__ __forceinline__ size_t plane_at(const TowerParams& p, int k) {
  return k < p.pre ? (size_t)p.NS * k : (size_t)p.NS * p.pre + (k - p.pre);
}

struct BwdParams {
  TowerParams t;   // z, x and the packed weights
  CUtensorMap m_in, m_z, m_blk;  // w_in (kin, H), w_z (n_lin_z C, H), w_blk (2 n_blocks H, H)
  CUtensorMap m_zt, m_blkt;  // w_z and w_blk as the walk back reads them (encode_weights)
  CUtensorMap m_act;  // ws_act as ((2 NP + 1) B_pad, H): the relu masks, read back
  const float* g;  // (d_out, B) planar f32 cotangent
  float* dz;       // (dz_pieces(C), NS B_pad, H) f32: dz's columns H j.. in plane j, written when n_lin_z > 0
  float* dx;       // (NS B, d_in) f32, or null
  bf16* ws_act;    // (2 NP + 1, B_pad, H): r_k, s_k, t (NP = plane_at(n_blocks))
  bf16* ws_cot;    // (2 NP + NS, B_pad, H): gb_k, dh_k, g_in
  bf16* ws_x;      // (NS, B_pad, kin) bf16 code
  bf16* ws_z;      // (NS, B_pad, C) bf16 latent, multi-view only
  float* rows;     // (B_pad / 32, R, H) per-32-row column sums
  float* vsum;     // (gridDim.x, D_SLOT_FLOATS), multi-view only
  int B_pad, R;
};
// rows: 0 db_in | 1 + k db_z[k] | 1 + n_lin_z + 2k + i db of fc_i of block k
//       | 1 + n_lin_z + 2 n_blocks db_out (first d_out columns) | then d_out
//       rows of dW_out^T

// Both bf16 values at (r, c), (r, c + 1) of a swizzled operand tile are > 0
// (bits 0 and 1); rows at or past `valid` read as not live.
__device__ __forceinline__ int live2(const unsigned char* tile, int row, int c, int valid) {
  if (row >= valid) return 0;
  const uint32_t v = *reinterpret_cast<const uint32_t*>(tile + hopper::sw128_offset(row, c));
  return (bf16_lo(v) > 0.0f ? 1 : 0) | (bf16_hi(v) > 0.0f ? 2 : 0);
}

// Thread 0: the tile's rows of workspace plane `plane` of ws_act (a stashed
// r_k or s_k) into `tile` by TMA, swizzled as the operand tiles are, on `bar`:
// HID / 64 boxes, the tile's first HID columns.
__device__ __forceinline__ void load_mask(const BwdParams& q, unsigned char* tile, uint64_t* bar,
                                          size_t plane, int row0) {
  hopper::mbar_arrive_expect_tx(bar, HID / 64 * BOX_BYTES);
#pragma unroll
  for (int j = 0; j < HID / 64; ++j)
    hopper::tma_load_2d(tile + j * BOX_BYTES, &q.m_act, bar, 64 * j, (int)(plane * q.B_pad) + row0);
}

// Column sums over each 32-row half of the tile at row0 of one piece's f32
// values val(i) (accumulator layout), into rows ra and rb (rb < 0: none) of
// the per-32-row sums `rows` (half h of the tile at 32-row tile row0 / 32 +
// h); add: added to what is there (a later view of the same tile).  A half's
// rows lie in two warps: the first writes its 16 rows' sums, the second adds
// its own after a barrier over the warpgroup.  A half at or past `valid`
// rows (past B_pad) is not written.
template <typename Val>
__device__ __forceinline__ void half_sums(Val val, int p, float* rows, int row0, int valid, int R,
                                          int ra, int rb, bool add) {
  const int halves = valid >> 5;
  float* rows_t = rows + (size_t)(row0 >> 5) * R * HID;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int half = warp >> 1, second = warp & 1;
  const int wg = threadIdx.x >> 7;
  // every lane reads (a half past B_pad reads half 0's row and writes nothing),
  // so that a group's reads go out together
  const int hs = half < halves ? half : 0;
  const bool wr = lane < 4 && half < halves;
  float* da = rows_t + ((size_t)hs * R + ra) * HID + piece_col(p) + 2 * (lane & 3);
  float* db = rb >= 0 ? rows_t + ((size_t)hs * R + rb) * HID + piece_col(p) + 2 * (lane & 3) : nullptr;
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) hopper::named_barrier(2 + wg, 128);
    if (second != pass) continue;
    const bool rd = add || pass == 1;
#pragma unroll
    for (int j0 = 0; j0 < TILE_ACC / 4; j0 += 2) {  // two 8-column groups at a time
      float2 s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float a[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          a[e] = val(4 * (j0 + j) + e) + val(4 * (j0 + j) + 2 + e);
          a[e] += __shfl_xor_sync(0xffffffffu, a[e], 4);
          a[e] += __shfl_xor_sync(0xffffffffu, a[e], 8);
          a[e] += __shfl_xor_sync(0xffffffffu, a[e], 16);
        }
        s[j] = make_float2(a[0], a[1]);
      }
      for (int w = 0; w < 2; ++w) {
        float* d = w == 0 ? da : db;
        if (d == nullptr) continue;
        float2 o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          o[j] = rd ? *reinterpret_cast<const float2*>(d + 8 * (j0 + j)) : make_float2(0.0f, 0.0f);
        if (wr)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(d + 8 * (j0 + j)) = make_float2(o[j].x + s[j].x, o[j].y + s[j].y);
      }
    }
  }
}

// A swizzled (64, H) tile into rows row0.. of an (rows, H) row-major global
// plane, 16 bytes a copy; rows at or past `valid` are not written.
__device__ __forceinline__ void stash(const unsigned char* tile, bf16* dst, int row0, int valid) {
  constexpr int NQ = HID / 8;
#pragma unroll 1
  for (int e = threadIdx.x; e < valid * NQ; e += TILE_THREADS) {
    const int r = e / NQ, c = (e % NQ) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * HID + c) =
        *reinterpret_cast<const uint4*>(tile + hopper::sw128_offset(r, c));
  }
}

// The tile's bf16 code of view v into `tile` (zeros past B and past d_in)
// and its stash ws_x (view v at v B_pad rows).  Reads go out two at a time,
// from a clamped row, so that they overlap.
__device__ __forceinline__ void load_code(const BwdParams& q, unsigned char* tile, int row0, int v,
                                          int valid) {
  const TowerParams& p = q.t;
  const int kin = p.kin, n = TILE_PTS * kin;
  for (int e0 = threadIdx.x; e0 < n; e0 += 2 * TILE_THREADS) {
    float f[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = min(e0 + u * TILE_THREADS, n - 1), r = e / kin, c = e - r * kin;
      const int g = min(row0 + r, p.B - 1);
      f[u] = p.x[src_row(p, g, v) * p.d_in + min(c, p.d_in - 1)];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = min(e0 + u * TILE_THREADS, n - 1), r = e / kin, c = e - r * kin;
      if (e0 + u * TILE_THREADS >= n) continue;
      const bf16 b = __float2bfloat16_rn(row0 + r < p.B && c < p.d_in ? f[u] : 0.0f);
      *reinterpret_cast<bf16*>(tile + hopper::sw128_offset(r, c)) = b;
      if (r < valid) q.ws_x[((size_t)v * q.B_pad + row0 + r) * kin + c] = b;
    }
  }
}

// The piece of the tile's bf16 latent of view v at column `off` (at most
// TILE_K columns) into `tile` (zeros past B); multi-view also stashes it in ws_z,
// rows of stride C as z's.  Thread t takes the piece's 16-byte chunk t % 64
// of rows t / 64, + 4, ... (threads past the piece's chunks none), two rows
// at a time from a clamped row.
__device__ __forceinline__ void load_latent(const BwdParams& q, unsigned char* tile, int row0, int v,
                                            int valid, int off) {
  const TowerParams& p = q.t;
  const int c = (threadIdx.x & 63) * 8;
  if (c >= min(TILE_K, p.C - off)) return;
  // the stash's first row, kept in one pointer (recomputed per row, the
  // multi-view kernel spilled); used only where ws_z is set
  bf16* wz = q.ws_z + ((size_t)v * q.B_pad + row0) * p.C + off + c;
  for (int r0 = threadIdx.x >> 6; r0 < TILE_PTS; r0 += 8) {
    uint4 v8[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int g = min(row0 + r0 + 4 * u, p.B - 1);
      v8[u] = __ldg(reinterpret_cast<const uint4*>(p.z + src_row(p, g, v) * p.C + off + c));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + 4 * u;
      if (row0 + r >= p.B) v8[u] = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(tile + hopper::sw128_offset(r, c)) = v8[u];
      if (q.ws_z != nullptr && r < valid)
        *reinterpret_cast<uint4*>(wz + (size_t)r * p.C) = v8[u];
    }
  }
}

// The steps of one tile as stored, in three parts; returns their count.
// n_lin_z <= pre.  Multi-view (mv), the first and the last part are one
// view's, and the walk takes each once for every view (tile64.cuh's
// walk_at): the recompute of lin_in, the injections and the
// blocks below the mean, ending in FOLD; the shared blocks, T_OUT and their
// walk back, once; the view's walk back, starting at DVIEW.  One view (pre =
// n_blocks): the three parts walked once, in order.  Each injection is
// `pieces` steps in the recompute (latent_pieces(C)), Z_FWD with the piece
// in aux, and `dz_steps` in the walk back (dz_pieces(C)), Z_BWD with the
// step in aux (the view's first injection walked back, k = n_lin_z - 1,
// writes dz, the later ones add to it).
__host__ __device__ inline int data_program(uint16_t* out, int n_blocks, int n_lin_z, bool mv,
                                            int pre, int pieces, int dz_steps) {
  int n = 0;
  auto put = [&](int s) {
    if (out != nullptr) out[n] = (uint16_t)s;
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
  put(step(T_OUT, 0, 0));
  for (int k = n_blocks - 1; k >= pre; --k) {
    put(step(GB, k, 0));
    put(step(B1_BWD, k, 0));
    put(step(B0_BWD, k, 0));
  }
  if (mv) put(step(DVIEW, 0, 0));
  for (int k = pre - 1; k >= 0; --k) {
    put(step(GB, k, 0));
    if (k + 1 < n_lin_z)
      for (int j = 0; j < dz_steps; ++j) put(step(Z_BWD, k + 1, j));
    put(step(B1_BWD, k, 0));
    put(step(B0_BWD, k, 0));
  }
  put(step(G_IN, 0, 0));
  if (n_lin_z > 0)
    for (int j = 0; j < dz_steps; ++j) put(step(Z_BWD, 0, j));
  return n;
}

// The feeding state of the weight ring, which only thread 0 keeps (in shared
// memory, so that no other thread holds registers for it): the next stage to
// load is step g of the program, piece pc, K rows ks * 64.., of this CTA's
// tile `tile` -- in the order the threads take the stages, tile after tile.
// Multi-view, its view is d_feed_v, apart so that the feeder holds it in no
// register but where it counts.
struct Feed {
  int g, pc, ks, tile;
};

// The data kernel's shared state beside its dynamic operand tiles and ring,
// at fixed addresses so that no thread holds registers for them: the ring's
// full / empty mbarriers, the relu masks' mbarrier, the tile's program (its
// recompute segment ends at d_seg1, its walk-back segment starts at d_seg3)
// and thread 0's feeding state.
__shared__ __align__(8) uint64_t d_full[RING_STAGES], d_empty[RING_STAGES], d_mask_full;
__shared__ uint16_t d_prog[D_MAX_STEPS];
__shared__ int d_n_steps, d_seg1, d_seg3, d_feed_v, d_bound, d_end;
// the current tile's first row and its rows inside B_pad (64, or 32 at a
// ragged end), read where used rather than kept in registers
__shared__ int d_row0, d_valid;
__shared__ Feed d_feed;

// Zeros: the bias of an injection's later pieces.
__device__ float d_zero_bias[HID];

// The weight ring: RING_STAGES stages of STAGE_BYTES bytes at `base` with the
// mbarriers d_full / d_empty; `it` counts the stages the threads have taken.
struct Ring {
  unsigned char* base;
  uint32_t it;
};

// The step after f's in the walk: multi-view, the recompute segment
// [0, d_seg1) once for each view, the shared steps once, the walk-back
// segment [d_seg3, d_n_steps) once for each view, then the CTA's next tile.
// One compare a step, as at one view: d_bound is where the walk next turns.
template <bool MV>
__device__ __forceinline__ void next_step(const BwdParams& q, Feed& f) {
  ++f.g;
  if (f.g == (MV ? d_bound : d_n_steps)) {
    if (MV && f.g == d_seg1) {
      if (++d_feed_v < q.t.NS) {  // the next view's recompute
        f.g = 0;
      } else {  // on into the shared steps
        d_feed_v = 0;
        d_bound = d_n_steps;
      }
    } else if (MV && ++d_feed_v < q.t.NS) {  // the next view's walk back
      f.g = d_seg3;
    } else {  // the CTA's next tile
      if (MV) {
        d_feed_v = 0;
        d_bound = d_seg1;
      }
      f.g = 0;
      f.tile += gridDim.x;
    }
  }
}

// Thread 0: load the next stage into ring slot `slot`: the weight boxes of
// piece pc of both warpgroups.  Forward: B = W rows rowbase + k, read
// MN-major; walk back: B = W^T, the boxes of W rows rowbase + n (the output
// columns) and columns k, read K-major.  One view, the steps that are not
// products are skipped before every stage; multi-view, once, at the end of
// the product before, off the stages' path (skipped before every stage, the
// data kernel at -V 3 took 6% longer on an H100).
template <bool MV>
__device__ __forceinline__ void feed(const BwdParams& q, Ring& rg, int slot) {
  const int n_tiles = (q.B_pad + TILE_PTS - 1) / TILE_PTS;
  Feed f = d_feed;
  if (!MV)
    while (f.tile < n_tiles && !is_gemm(step_kind(d_prog[f.g]))) next_step<false>(q, f);
  if (f.tile < n_tiles) {
    const Gemm op = piece_gemm_of<true>(d_prog[f.g], q.t.kin, q.t.C);
    const CUtensorMap* m = op.map == 0 ? &q.m_in : op.map == 1 ? &q.m_z : &q.m_blk;
    // below 64-column boxes the walk back reads W_BOX_COLS x 64 boxes, through maps of their own
    if (W_BOX_COLS < 64 && op.trans) m = op.map == 1 ? &q.m_zt : &q.m_blkt;
    hopper::mbar_arrive_expect_tx(&d_full[slot], STAGE_BYTES);
    unsigned char* dst = rg.base + slot * STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < 2 * TILE_BPW; ++j) {
      const int n = (j / TILE_BPW) * TILE_HALF + f.pc * TILE_PIECE + (j % TILE_BPW) * W_BOX_COLS;
      if (op.trans)
        hopper::tma_load_2d(dst + j * W_BOX_BYTES, m, &d_full[slot], f.ks * 64, op.rowbase + n);
      else
        hopper::tma_load_2d(dst + j * W_BOX_BYTES, m, &d_full[slot], n, op.rowbase + f.ks * 64);
    }
    if (++f.ks * 64 >= op.K) {
      f.ks = 0;
      if (++f.pc == TILE_NP) {
        f.pc = 0;
        if (MV) {
          do next_step<true>(q, f);
          while (f.tile < n_tiles && !is_gemm(step_kind(d_prog[f.g])));
        } else {
          next_step<false>(q, f);
        }
      }
    }
  }
  d_feed = f;
}

// Stage u is read: every thread arrives on its empty barrier; thread 0 waits
// until all have and loads stage u + RING_STAGES into the slot.
template <bool MV>
__device__ __forceinline__ void release(const BwdParams& q, Ring& rg, uint32_t u) {
  const int slot = u % RING_STAGES;
  hopper::mbar_arrive(&d_empty[slot]);
  if (threadIdx.x == 0) {
    hopper::mbar_wait(&d_empty[slot], (u / RING_STAGES) & 1);
    feed<MV>(q, rg, slot);
  }
}

// For each piece p of this warpgroup's columns, acc = A . B over K (A a
// swizzled (64, K) tile, B from the ring as `feed` laid it out: MN-major
// forward, K-major with trans), then epi(p, acc).
template <bool MV, int TB, typename Epi>
__device__ __forceinline__ void gemm(const BwdParams& q, Ring& rg, const unsigned char* A, int K,
                                     Epi epi) {
  const int wg = threadIdx.x >> 7;
  const int nks = (K + 63) / 64;
#pragma unroll
  for (int pc = 0; pc < TILE_NP; ++pc) {
    float acc[TILE_ACC];
#pragma unroll
    for (int i = 0; i < TILE_ACC; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < nks; ++ks) {
      const int st = rg.it % RING_STAGES;
      hopper::mbar_wait(&d_full[st], (rg.it / RING_STAGES) & 1);
      const unsigned char* b = rg.base + st * STAGE_BYTES + wg * TILE_BPW * W_BOX_BYTES;
      const int nk = min(4, (K - ks * 64) / 16);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk < nk) {
          const uint64_t da = hopper::desc_kmajor_sw128(A + ks * 8192 + kk * 32);
          if (TB)
            wgmma_piece<0, 1>(acc, da, w_desc(b, kk), 1);
          else
            wgmma_piece<0, 0>(acc, da, hopper::desc_kmajor_sw128(b + kk * 32), 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // stage ks - 1's products have read it
      if (ks > 0) release<MV>(q, rg, rg.it - 1);
      ++rg.it;
    }
    hopper::wgmma_wait<0>();
    release<MV>(q, rg, rg.it - 1);
    epi(pc, acc);
  }
}

// One CTA of 256 threads walks 64-point tiles (multi-view: persistent CTAs,
// one per SM).  Warpgroups 0 and 1 each own half of the HID columns of every
// layer for all 64 points: their share of the f32 residual stream (the
// recompute) or of its cotangent (the walk back) lives in HID / 4 registers
// a thread, `sv`.  Operand A of every product is a 64 x 512 bf16 tile in
// shared memory, K-major with the 128-byte swizzle, written by the threads
// from their accumulators: `act` (r_k, t or the cotangent) and `hb` (the
// code, the latent, s_k or dh).  Every product is preceded by a fence of the
// async proxy and a barrier over both warpgroups, and writes its epilogue into
// the other tile, so that no tile is rewritten while a product still reads
// it.  Operand B streams through the weight ring, RING_STAGES - 1 stages ahead:
// thread 0 refills each slot as soon as both warpgroups have read it.
template <bool MV>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    resnetfc_bwd_data_kernel(const __grid_constant__ BwdParams q) {
  extern __shared__ unsigned char d_smem_raw[];
  const TowerParams& p = q.t;
  const uint32_t raw = hopper::smem_u32(d_smem_raw);
  unsigned char* act = d_smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* hb = act + TILE_BYTES;
  const int nb = p.n_blocks, nlz = p.n_lin_z, C = p.C, kin = p.kin, d_out = p.d_out;
  // one view: every block per view, one plane each
  const int pre = MV ? p.pre : nb, NS = MV ? p.NS : 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < RING_STAGES; ++st) {
      hopper::mbar_init(&d_full[st], 1);
      hopper::mbar_init(&d_empty[st], TILE_THREADS);
    }
    hopper::mbar_init(&d_mask_full, 1);
    hopper::mbar_fence_init();
    d_n_steps = data_program(d_prog, nb, nlz, MV, pre, latent_pieces(C), dz_pieces(C));
    d_seg1 = d_seg3 = 0;  // one view: no segment is walked twice
    for (int i = 0; i < d_n_steps; ++i) {
      if (step_kind(d_prog[i]) == FOLD) d_seg1 = i + 1;
      if (step_kind(d_prog[i]) == DVIEW) d_seg3 = i;
    }
    d_feed_v = 0;
    d_bound = d_seg1;
    d_end = walk_at(d_n_steps, NS - 1);
  }
  __syncthreads();
  Ring rg{hb + TILE_BYTES, 0u};
  if (threadIdx.x == 0) {
    d_feed = Feed{0, 0, 0, (int)blockIdx.x};
    for (int st = 0; st < RING_STAGES; ++st) feed<MV>(q, rg, st);
  }

  auto first_plane = [&](int k) -> size_t { return MV ? plane_at(p, k) : (size_t)k; };
  const int plane = q.B_pad * HID;  // elements of one workspace plane
  const int NP = (int)first_plane(nb);  // planes of one kind (r, s, gb or dh) over all blocks
  const int R = q.R, row_bout = 1 + nlz + 2 * nb;

  float sv[TILE_STREAM];  // the stream x (recompute), then its cotangent (walk back)

  // bf16(relu(sv)) into act
  auto emit_relu = [&](int pc) {
#pragma unroll
    for (int i = 0; i < TILE_ACC; i += 2)
      put2(act, acc_row(i), piece_col(pc) + acc_col(i), fmaxf(sv[pc * TILE_ACC + i], 0.0f),
           fmaxf(sv[pc * TILE_ACC + i + 1], 0.0f));
  };

  // the CTA's tiles: the next one from d_row0, so that no register holds the
  // tile across the steps (at 255 registers the multi-view walk spilled it)
  for (int tile = blockIdx.x; tile * TILE_PTS < q.B_pad; tile = d_row0 / TILE_PTS + gridDim.x) {
    // gb = bf16(sv) into act, the f32 column sums of sv into rows ra (and rb)
    auto emit_cot = [&](int ra, int rb, bool add) {
#pragma unroll
      for (int pc = 0; pc < TILE_NP; ++pc) {
#pragma unroll
        for (int i = 0; i < TILE_ACC; i += 2)
          put2(act, acc_row(i), piece_col(pc) + acc_col(i), sv[pc * TILE_ACC + i],
               sv[pc * TILE_ACC + i + 1]);
        half_sums([&](int i) { return sv[pc * TILE_ACC + i]; }, pc, q.rows, d_row0, d_valid, R, ra, rb, add);
      }
    };
    __syncthreads();  // the previous tile's last readers of act, hb and the tile's rows are done
    if (threadIdx.x == 0) {
      d_row0 = tile * TILE_PTS;
      d_valid = min(TILE_PTS, q.B_pad - tile * TILE_PTS);  // rows inside B_pad: 64, or 32 at a ragged end
    }
    __syncthreads();

    // multi-view, the walk takes the recompute segment once for each view
    // (si holds the view, tile64.cuh's walk_at), the shared steps once, then
    // the walk-back segment once for each view, to the walk's end, d_end
    for (int si = 0; si < (MV ? d_end : d_n_steps); ++si) {
      if (MV && walk_idx(si) == d_n_steps) si = walk_at(d_seg3, walk_view(si) + 1);  // the next view's walk back
      const int s = d_prog[MV ? walk_idx(si) : si];
      const int kind = step_kind(s), k = step_k(s), v = MV ? walk_view(si) : 0, aux = step_aux(s);
      const bool below = k < pre;
      // block k's planes: r_k at pa (s_k at pa + views), gb_k at pcot (dh_k at NP + pcot)
      const int pa = 2 * (int)first_plane(k) + (below ? v : 0);
      const int pcot = (int)first_plane(k) + (below ? v : 0);
      const int views = below ? NS : 1;
      // ---- the actions between products ----
      if (kind == FOLD) {
        // the view mean: sum in view order in the slot, then sum * (1 / NS);
        // after the last view, relu(mean) for the first shared block
        const float inv = 1.0f / (float)NS;
#pragma unroll
        for (int i = 0; i < TILE_STREAM; ++i) {
          float* a = q.vsum + ((size_t)blockIdx.x * TILE_STREAM + i) * TILE_THREADS + threadIdx.x;
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
        // the next view's recompute, or on into the shared steps
        if (MV) si = v + 1 < NS ? walk_at(0, v + 1) - 1 : walk_idx(si);
        continue;
      }
      if (kind == T_OUT) {
        publish();  // act = t
        stash(act, q.ws_act + (size_t)(2 * NP) * plane, d_row0, d_valid);
        // lin_out: dW_out^T and db_out as per-32-row sums; cotangent = bf16(g) W_out^T [t > 0]
        float gb[2][TILE_MAX_OUT];  // bf16(g) of this thread's two rows (0 past B)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gi = d_row0 + acc_row(2 * h);
#pragma unroll
          for (int o = 0; o < TILE_MAX_OUT; ++o) {
            const float u = q.g[(size_t)min(o, d_out - 1) * p.B + min(gi, p.B - 1)];
            gb[h][o] = (o < d_out && gi < p.B) ? round_bf16(u) : 0.0f;
          }
        }
#pragma unroll
        for (int pc = 0; pc < TILE_NP; ++pc)
#pragma unroll
          for (int o = 0; o < TILE_MAX_OUT; ++o)
            if (o < d_out)
              half_sums([&](int i) { return round_bf16(fmaxf(sv[pc * TILE_ACC + i], 0.0f)) * gb[(i >> 1) & 1][o]; },
                        pc, q.rows, d_row0, d_valid, R, row_bout + 1 + o, -1, false);
        float* rows_t = q.rows + (size_t)(d_row0 >> 5) * R * HID;
        for (int e = threadIdx.x; e < (d_valid >> 5) * HID; e += TILE_THREADS) {
          const int h = e / HID, c = e - h * HID;
          float sb = 0.0f;
          if (c < d_out)
#pragma unroll 8
            for (int r = 0; r < 32; ++r) {
              const int gi = d_row0 + 32 * h + r;
              const float u = q.g[(size_t)c * p.B + min(gi, p.B - 1)];
              sb += gi < p.B ? u : 0.0f;
            }
          rows_t[((size_t)h * R + row_bout) * HID + c] = sb;
        }
#pragma unroll
        for (int pc = 0; pc < TILE_NP; ++pc)
#pragma unroll
          for (int j = 0; j < TILE_ACC / 4; ++j) {
            // W_out's rows c, c + 1 serve rows r and r + 8 of this thread
            const int c = piece_col(pc) + acc_col(4 * j);
            float w[2][TILE_MAX_OUT];
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int o = 0; o < TILE_MAX_OUT; ++o)
                w[e][o] = o < d_out ? __bfloat162float(p.w_out[(size_t)(c + e) * d_out + o]) : 0.0f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e;
              float u = 0.0f;
#pragma unroll
              for (int o = 0; o < TILE_MAX_OUT; ++o) u = fmaf(gb[e >> 1][o], w[e & 1][o], u);
              sv[pc * TILE_ACC + i] = sv[pc * TILE_ACC + i] > 0.0f ? u : 0.0f;
            }
            if ((j & 3) == 3) group_fence();
          }
        __syncthreads();  // every thread has read t out of act
        continue;
      }
      if (kind == DVIEW) {
        // dview = cotangent * (1 / NS) starts every view's walk: kept in the slot
        const float inv = 1.0f / (float)NS;
#pragma unroll
        for (int i = 0; i < TILE_STREAM; ++i) {
          float* a = q.vsum + ((size_t)blockIdx.x * TILE_STREAM + i) * TILE_THREADS + threadIdx.x;
          if (v == 0) {
            sv[i] *= inv;
            *a = sv[i];
          } else {
            sv[i] = *a;
          }
          if (i % 16 == 15) group_fence();
        }
        if (v > 0) __syncthreads();  // the previous view's last readers of act are done
        continue;
      }
      if (kind == GB) {
        // gb = bf16(cotangent of block k's output); db of fc_1 sums the f32 one,
        // and so does db of lin_z_{k+1}, whose output meets the same cotangent
        emit_cot(1 + nlz + 2 * k + 1, k + 1 < nlz ? 2 + k : -1, below && v > 0);
        publish();
        // s_k, fc_1's relu mask, into hb while the products before it run
        if (threadIdx.x == 0) load_mask(q, hb, &d_mask_full, pa + views, d_row0);
        stash(act, q.ws_cot + (size_t)pcot * plane, d_row0, d_valid);
        continue;
      }
      if (kind == G_IN) {
        // the cotangent of lin_in's output, which is also lin_z_0's
        emit_cot(0, nlz > 0 ? 1 : -1, v > 0);
        publish();
        stash(act, q.ws_cot + (size_t)(2 * NP + v) * plane, d_row0, d_valid);
        if (q.dx != nullptr) {
          // dx = bf16(dv) W_in^T on the CUDA cores: a thread a (point, column), d_in <= 512
          for (int e = threadIdx.x; e < TILE_PTS * p.d_in; e += TILE_THREADS) {
            const int r = e / p.d_in, c = e - r * p.d_in, gi = d_row0 + r;
            if (gi >= p.B) continue;
            const bf16* w = p.w_in + (size_t)c * HID;
            float acc = 0.0f;
            for (int h = 0; h < HID; h += 8) {
              const uint4 a = *reinterpret_cast<const uint4*>(act + hopper::sw128_offset(r, h));
              const uint4 b = __ldg(reinterpret_cast<const uint4*>(w + h));
              const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                acc = fmaf(bf16_lo(av[u]), bf16_lo(bv[u]), acc);
                acc = fmaf(bf16_hi(av[u]), bf16_hi(bv[u]), acc);
              }
            }
            q.dx[(MV ? src_row(p, gi, v) : (size_t)gi) * p.d_in + c] = acc;
          }
        }
        continue;
      }

      // ---- a product: what precedes it, then the product and its epilogue ----
      const unsigned char* A = act;
      if (kind == IN_FWD || kind == Z_FWD) {
        __syncthreads();  // hb's last readers (lin_in or the previous fc_1) are done
        if (kind == IN_FWD)
          load_code(q, hb, d_row0, v, d_valid);
        else
          load_latent(q, hb, d_row0, v, d_valid, aux * TILE_K);  // the piece's columns
        publish();
        A = hb;
      } else if (kind == B0_FWD) {
        publish();  // act = r_k
        stash(act, q.ws_act + (size_t)pa * plane, d_row0, d_valid);
      } else if (kind == B1_FWD) {
        publish();  // hb = s_k
        stash(hb, q.ws_act + (size_t)(pa + views) * plane, d_row0, d_valid);
        A = hb;
      } else if (kind == B0_BWD) {
        publish();  // hb = dh
        if (threadIdx.x == 0) load_mask(q, act, &d_mask_full, pa, d_row0);  // r_k, fc_0's relu mask
        stash(hb, q.ws_cot + (size_t)(NP + pcot) * plane, d_row0, d_valid);
        A = hb;
      }
      const Gemm op = piece_gemm_of<true>(s, kin, C);
      // one product site per epilogue kind, so that each keeps only its own
      // temporaries beside the stream and the accumulators
      if (kind == IN_FWD || kind == Z_FWD || kind == B1_FWD) {
        // the residual stream: sv (+)= acc + bias; relu(sv) into act for the next product
        gemm<MV, 1>(q, rg, A, op.K, [&](int pc, float(&acc)[TILE_ACC]) {
          const int c0 = piece_col(pc);
          const int kind = step_kind(s), k = step_k(s), aux = step_aux(s);  // from s: fewer live registers
          // an injection's bias comes with its first piece only: the later
          // pieces add zeros, as the forward's do
          const float* bias = kind == IN_FWD  ? p.b_in
                              : kind == Z_FWD ? (aux ? d_zero_bias : p.b_z + (size_t)k * HID)
                                              : p.b_blk + (size_t)(2 * k + 1) * HID;
#pragma unroll
          for (int j = 0; j < TILE_ACC / 4; ++j) {  // one bias pair serves rows r and r + 8
            const float2 bj = __ldg(reinterpret_cast<const float2*>(bias + c0 + acc_col(4 * j)));
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * j + e;
              const float u = acc[i] + ((e & 1) ? bj.y : bj.x);
              sv[pc * TILE_ACC + i] = kind == IN_FWD ? u : sv[pc * TILE_ACC + i] + u;
            }
            if ((j & 3) == 3) group_fence();
          }
          if (kind == Z_FWD || aux) emit_relu(pc);
        });
      } else if (kind == B0_FWD) {
        gemm<MV, 1>(q, rg, A, op.K, [&](int pc, float(&acc)[TILE_ACC]) {
          const int c0 = piece_col(pc);
          const int k = step_k(s);
          const float* bias = p.b_blk + (size_t)(2 * k) * HID;
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
        });
      } else if (kind == Z_BWD) {
        // summed in f32 in dz in injection order (the view's first, k =
        // n_lin_z - 1, writes); each thread reads back only what it wrote.
        // dz's columns HID j.. are plane j (aux) of
        // (NS B_pad, HID) rows, view v's at v B_pad, so that every step is a
        // whole HID-column product written as at C = HID; its columns at or
        // past C land in the plane's unused part
        gemm<MV, 0>(q, rg, A, op.K, [&](int pc, float(&acc)[TILE_ACC]) {
          const int c0 = piece_col(pc);
          const int v = MV ? walk_view(si) : 0, aux = step_aux(s);
          const bool first = step_k(s) == p.n_lin_z - 1;
          float* dzt = q.dz + ((size_t)(aux * NS + v) * q.B_pad + d_row0) * HID + c0;
#pragma unroll
          for (int i0 = 0; i0 < TILE_ACC; i0 += 4) {  // two pairs at a time, their reads together
            float2 o[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = i0 + 2 * u, r = min(acc_row(i), d_valid - 1);
              o[u] = first ? make_float2(0.0f, 0.0f)
                               : *reinterpret_cast<const float2*>(dzt + r * HID + acc_col(i));
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int i = i0 + 2 * u;
              if (acc_row(i) < d_valid)
                *reinterpret_cast<float2*>(dzt + acc_row(i) * HID + acc_col(i)) =
                    make_float2(o[u].x + acc[i], o[u].y + acc[i + 1]);
            }
            group_fence();
          }
        });
      } else if (kind == B1_BWD) {
        // dh = ds [s > 0]: bf16 into hb over s_k's mask, f32 column sums for
        // db of fc_0
        gemm<MV, 0>(q, rg, A, op.K, [&](int pc, float(&acc)[TILE_ACC]) {
          const int c0 = piece_col(pc);
          const int k = step_k(s), v = MV ? walk_view(si) : 0;
          // each block loads two masks, s_k then r_k: s_k completes even phases
          hopper::mbar_wait(&d_mask_full, 0);
#pragma unroll
          for (int i = 0; i < TILE_ACC; i += 2) {
            const int m = live2(hb, acc_row(i), c0 + acc_col(i), d_valid);
            acc[i] = (m & 1) ? acc[i] : 0.0f;
            acc[i + 1] = (m & 2) ? acc[i + 1] : 0.0f;
            put2(hb, acc_row(i), c0 + acc_col(i), acc[i], acc[i + 1]);
          }
          half_sums([&](int i) { return acc[i]; }, pc, q.rows, d_row0, d_valid, R, 1 + nlz + 2 * k, -1,
                    k < pre && v > 0);
        });
      } else {  // B0_BWD: dr = bf16(dh) W0^T [r > 0] onto the cotangent
        gemm<MV, 0>(q, rg, A, op.K, [&](int pc, float(&acc)[TILE_ACC]) {
          const int c0 = piece_col(pc);
          hopper::mbar_wait(&d_mask_full, 1);  // r_k: the odd phases
#pragma unroll
          for (int i = 0; i < TILE_ACC; i += 2) {
            const int m = live2(act, acc_row(i), c0 + acc_col(i), d_valid);
            if (m & 1) sv[pc * TILE_ACC + i] += acc[i];
            if (m & 2) sv[pc * TILE_ACC + i + 1] += acc[i + 1];
            if (i % 16 == 14) group_fence();
          }
        });
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradients: dW[m, n] = sum_p A[p, m] G[p, n], a grouped split-K GEMM
// on wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int WT_M = 128;  // output tile: rows of dW (two warpgroups of 64)
// output tile: columns of dW, one m64n256 product (m64n192 at HID 384, two
// column tiles; m64n192 at 192, m64n128 at 128, m64n64 at 64: the blocks' dW
// is HID x HID; m64n160 at 320, two column tiles)
constexpr int WT_N = HID <= 256 ? HID : HID % 256 == 0 ? 256 : HID % 192 == 0 ? 192 : HID / 2;
static_assert(HID % WT_N == 0 && WT_N % 32 == 0, "dW's columns are whole output tiles");
constexpr int WK = 64;     // points per k-step: one TMA box is 64 columns x 64 points
constexpr int W_STAGES = 4;
constexpr int W_THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int W_CONSUMERS = 256;
constexpr uint32_t W_BOX = WK * 128;            // bytes of one 64 x 64 bf16 box
constexpr uint32_t W_STAGE_A = 2 * W_BOX;       // A: 64 points x 128 columns
// G: 64 points x WT_N columns, in boxes of 64 columns (128-byte swizzle), or
// of 32 (64-byte swizzle) where 64 does not divide WT_N (160)
constexpr int W_G_COLS = WT_N % 64 == 0 ? 64 : 32;
constexpr uint32_t W_G_BOX = WK * W_G_COLS * 2;
constexpr int W_G_BOXES = WT_N / W_G_COLS;
constexpr uint32_t W_STAGE = W_STAGE_A + W_G_BOXES * W_G_BOX;
constexpr size_t W_SMEM = (size_t)W_STAGES * W_STAGE + 1024;  // + alignment slack
// The tensor maps and the task table of a launch lie in device memory (the
// plan's WTable, copied there once per plan), so that the kernel's
// parameters stay within 4 KB.  (CUDA 12.1 and later take up to 32,764
// bytes of parameters; with the table in them this kernel faulted now and
// then on an H100 (an illegal address at d_hidden 256 and 384; nvcc 12.9,
// driver 580), and from device memory it did not.)  A tower of n blocks and
// n_lin_z injections takes 4 n + 2 maps (one more with a latent) and 2 n +
// n_lin_z + 1 tasks at every view count (sn64, 5 blocks: 23 and 14).  A
// tile's stored forward program has at least a step a task (F_MAX_STEPS =
// 128 in resnetfc_fwd.cu) and the maps are at most twice the tasks, so
// these hold every tower the forward kernels take: 62 blocks at sn64's
// three injections.
constexpr int MAX_TASKS = 128;
constexpr int MAX_MAPS = 2 * MAX_TASKS;
constexpr int MAX_SPLITS = 24;

struct WTask {
  size_t out;        // first element of dW (M, N) row-major in the output buffer
  int a_map, g_map;  // tensor maps of A (P x M) and G (P x N)
  int M, P;          // dW rows; points summed over
  int splits;        // the point axis in `pts`-point pieces, the last one shorter
  int m_tiles, tile0, unit0;  // M tiles; first tile and first (tile, split) slot
};

// A plan's tensor maps and task table, as the kernel reads them from device
// memory.
struct WTable {
  CUtensorMap maps[MAX_MAPS];
  WTask task[MAX_TASKS];
};

// A launch's parameters: the plan (the device copy of its table, the CTA
// order), which depends only on the operands' addresses and shapes and is
// built once per such set by resnetfc_bwd_weights_plan, and the buffers of
// one call.
struct WParams {
  const WTable* table;  // the plan's table in device memory
  int split_cta0[MAX_SPLITS + 1];  // first GEMM CTA of each split (split-major order)
  int n_tasks, n_splits, N, pts, tiles, units;
  bf16* out;       // the weight gradients, one buffer
  float* partial;  // (units, WT_M * WT_N) f32 per (tile, split), tasks with splits > 1
  int* counters;   // (tiles), zero on entry
  const float* rows;
  int n_row_tiles, R;
  float* rows_out;  // (R, N)
};
static_assert(sizeof(WParams) <= 4096, "the parameters stay within 4 KB: the table is apart");

// A plan as the host keeps it: the launch's parameters and the host image of
// the table, which the caller copies to device memory (64-byte aligned) and
// passes at each launch.
struct WPlan {
  WParams head;
  WTable table;
};

// The GEMM CTAs, split-major (the tiles of split 0 of every task, then split
// 1, ...), then one bias CTA per row of sums, which the last wave's idle SMs
// take.  A GEMM CTA runs one (tile, split): warpgroup 2's first thread
// streams the split's points through a W_STAGES ring with TMA (full / empty
// mbarriers); warpgroups 0 and 1 each multiply one 64-row half of the A tile
// by the whole G tile with wgmma m64n256k16 (m64n192k16, m64n160k16,
// m64n128k16 or m64n64k16 at those WT_N), both operands MN-major from
// 128-byte-swizzled boxes (G's 64-byte-swizzled at WT_N 160).  A tile of one split writes bf16 directly;
// otherwise each split writes its f32 partial and the last CTA of the tile
// sums them in split order.
// One k16 step of a consumer's product: m64n256k16 at 128 accumulators a
// thread, m64n192k16 at 96 (WT_N 192),
// m64n160k16 at 80 (WT_N 160), m64n128k16 at 64 (WT_N 128), m64n64k16 at 32
// (WT_N 64); both operands MN-major.
__device__ __forceinline__ void wt_mma(float (&d)[128], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n256k16<1, 1>(d, a, b, 1);
}
__device__ __forceinline__ void wt_mma(float (&d)[96], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n192k16<1, 1>(d, a, b, 1);
}
__device__ __forceinline__ void wt_mma(float (&d)[80], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n160k16<1, 1>(d, a, b, 1);
}
__device__ __forceinline__ void wt_mma(float (&d)[64], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n128k16<1, 1>(d, a, b, 1);
}
__device__ __forceinline__ void wt_mma(float (&d)[32], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n64k16<1, 1>(d, a, b, 1);
}

__global__ void __launch_bounds__(W_THREADS, 1)
    resnetfc_bwd_weights_kernel(const __grid_constant__ WParams q) {
  extern __shared__ unsigned char w_smem_raw[];
  __shared__ __align__(8) uint64_t full[W_STAGES], empty[W_STAGES];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int bid = blockIdx.x;
  if (bid >= q.split_cta0[q.n_splits]) {  // bias / lin_out rows: sum the tiles in order
    const int r = bid - q.split_cta0[q.n_splits];
    for (int col = tid; col < q.N; col += W_THREADS) {
      float acc = 0.0f;
      for (int t = 0; t < q.n_row_tiles; ++t) acc += q.rows[((size_t)t * q.R + r) * q.N + col];
      q.rows_out[(size_t)r * q.N + col] = acc;
    }
    return;
  }
  int s = 0;
  while (s + 1 < q.n_splits && bid >= q.split_cta0[s + 1]) ++s;
  const int ntn = q.N / WT_N;
  const WTask* tasks = q.table->task;
  int local = bid - q.split_cta0[s], ti = 0;
  for (; ti < q.n_tasks; ++ti) {
    if (tasks[ti].splits <= s) continue;
    const int nt = tasks[ti].m_tiles * ntn;
    if (local < nt) break;
    local -= nt;
  }
  // a CTA past the plan's tiles would read past its table: fail loudly
  // (resnetfc_bwd_weights_plan sizes the grid so that none is)
  if (ti == q.n_tasks) __trap();
  const WTask T = tasks[ti];
  const int mt = local / ntn, m0 = mt * WT_M, n0 = (local - mt * ntn) * WT_N;
  const int p0 = s * q.pts, p1 = min(T.P, p0 + q.pts);
  const int nk = (p1 - p0 + WK - 1) / WK;
  // the ring starts at a 1024-byte boundary (the swizzle atom)
  const uint32_t raw = hopper::smem_u32(w_smem_raw);
  unsigned char* ring = w_smem_raw + (((raw + 1023) & ~1023u) - raw);

  if (tid == 0) {
    for (int st = 0; st < W_STAGES; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], W_CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 2 * 128) {
      // the maps were copied to device memory before the launch: acquire
      // them for the tensormap proxy that TMA reads them through
      const CUtensorMap* am = q.table->maps + T.a_map;
      const CUtensorMap* gm = q.table->maps + T.g_map;
      hopper::fence_tensormap(am);
      hopper::fence_tensormap(gm);
      for (int i = 0; i < nk; ++i) {
        const int st = i % W_STAGES;
        hopper::mbar_wait(&empty[st], ((i / W_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], W_STAGE);
        unsigned char* a = ring + st * W_STAGE;
        const int p = p0 + i * WK;
        hopper::tma_load_2d(a, am, &full[st], m0, p);
        hopper::tma_load_2d(a + W_BOX, am, &full[st], m0 + 64, p);
#pragma unroll
        for (int j = 0; j < W_G_BOXES; ++j)
          hopper::tma_load_2d(a + W_STAGE_A + j * W_G_BOX, gm, &full[st], n0 + W_G_COLS * j, p);
      }
    }
  } else {  // consumers: rows 64 wg .. 64 wg + 63 of the tile
    hopper::setmaxnreg_inc<232>();
    float acc[WT_N / 2];
#pragma unroll
    for (int i = 0; i < WT_N / 2; ++i) acc[i] = 0.0f;
    for (int i = 0; i < nk; ++i) {
      const int st = i % W_STAGES;
      hopper::mbar_wait(&full[st], (i / W_STAGES) & 1);
      const unsigned char* a = ring + st * W_STAGE + wg * W_BOX;
      const unsigned char* g = ring + st * W_STAGE + W_STAGE_A;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)  // 16 points = 16 rows of 128 B (G: of 64 B at 32 columns)
        wt_mma(acc, hopper::desc_sw128(a + kk * 2048, W_BOX, 1024),
               W_G_COLS == 64 ? hopper::desc_sw128(g + kk * 2048, W_G_BOX, 1024)
                              : hopper::desc_sw64(g + kk * 1024, W_G_BOX, 512));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // step i - 1's products have read their stage
      if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % W_STAGES]);
    }
    hopper::wgmma_wait<0>();

    const int tw = tid & 127, r0 = 64 * wg + 16 * (tw >> 5) + ((tw & 31) >> 2);
    const int c0 = 2 * (tw & 3);
    if (T.splits == 1) {
#pragma unroll
      for (int j = 0; j < WT_N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (m0 + r < T.M)
            *reinterpret_cast<uint32_t*>(q.out + T.out + (size_t)(m0 + r) * q.N + n0 + 8 * j + c0) =
                pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      return;
    }
    const size_t unit = (size_t)T.unit0 + (size_t)local * T.splits;
    float* part = q.partial + (unit + s) * (WT_M * WT_N);
#pragma unroll
    for (int j = 0; j < WT_N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (r0 + 8 * h) * WT_N + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    __threadfence();
    hopper::named_barrier(1, W_CONSUMERS);
    if (tid == 0) last = atomicAdd(q.counters + T.tile0 + local, 1) == T.splits - 1;
    hopper::named_barrier(1, W_CONSUMERS);
    if (!last) return;
    __threadfence();
    // the last CTA of this tile sums the partials in split order
    const float* base = q.partial + unit * (WT_M * WT_N);
    for (int e = tid * 4; e < WT_M * WT_N; e += W_CONSUMERS * 4) {
      float4 a4 = __ldcg(reinterpret_cast<const float4*>(base + e));
      for (int sp = 1; sp < T.splits; ++sp) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(base + (size_t)sp * WT_M * WT_N + e));
        a4.x += v.x;
        a4.y += v.y;
        a4.z += v.z;
        a4.w += v.w;
      }
      const int r = e / WT_N, c = e - r * WT_N;
      if (m0 + r < T.M)
        *reinterpret_cast<uint2*>(q.out + T.out + (size_t)(m0 + r) * q.N + n0 + c) =
            make_uint2(pack_bf16x2(a4.x, a4.y), pack_bf16x2(a4.z, a4.w));
    }
  }
}

int n_rows(int n_blocks, int n_lin_z, int d_out) { return 2 + n_lin_z + 2 * n_blocks + d_out; }

}  // namespace

extern "C" {

const char* resnetfc_bwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Rows of per-tile sums: db_in, db_z[k], db of every block layer, db_out and
// the d_out rows of dW_out^T.
int resnetfc_bwd_rows(int n_blocks, int n_lin_z, int d_out) { return n_rows(n_blocks, n_lin_z, d_out); }

// Multi-view (NS > 1): B = SB B_obj output points, NS object-major input
// rows each, the first `pre` blocks per view; ws_z holds NS (B_pad, C) bf16
// latent planes and vsum n_ctas slots of resnetfc_bwd_data_limits' f32 words,
// and the grid is at most n_ctas.  NS == 1 ignores B_obj, pre, ws_z, vsum and
// n_ctas.  B_pad is B rounded up to 32 (the workspace's rows); tiles are 64
// points, the last one half full when B_pad is an odd multiple of 32.
int resnetfc_bwd_data(const void* g, const void* z, const void* x, const void* w_in,
                      const void* b_in, const void* w_z, const void* b_z, const void* w_blk,
                      const void* b_blk, const void* w_out, void* dz, void* dx, void* ws_act,
                      void* ws_cot, void* ws_x, void* ws_z, void* rows, void* vsum, int B,
                      int d_in, int kin, int H, int C, int n_blocks, int n_lin_z, int d_out,
                      int NS, int B_obj, int pre, int n_ctas, void* stream) {
  if (H != HID || (n_lin_z > 0 && (C < 16 || C > MAX_C || C % 16 != 0)) || kin < 16 ||
      kin > TILE_K || kin % 16 != 0 || d_in > kin || n_blocks < 1 || d_out < 1 ||
      d_out > TILE_MAX_OUT)
    return (int)cudaErrorInvalidValue;
  const bool mv = NS > 1;
  if (mv && (pre < 0 || pre >= n_blocks || n_lin_z > pre || B_obj < 1 || B % B_obj != 0 ||
             vsum == nullptr || n_ctas < 1 || (n_lin_z > 0 && ws_z == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_blocks > STEP_MAX_K || NS > 255 ||
      data_program(nullptr, n_blocks, n_lin_z, mv, mv ? pre : n_blocks, latent_pieces(C),
                   dz_pieces(C)) > D_MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  BwdParams q = {};
  q.t = tower_params(x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, nullptr, B, d_in, kin, C,
                     n_blocks, n_lin_z, d_out);
  q.t.z = static_cast<const bf16*>(z);
  if (mv) {
    q.t.NS = NS;
    q.t.B_obj = B_obj;
    q.t.pre = pre;
  }
  // the weights in the boxes the products read (tile64.cuh's encode_weights;
  // rows past kin read as zeros) and the workspace's stashed operands as TMA
  // boxes of 64 x 64
  const int B_pad = (B + 31) / 32 * 32;
  const int NP = mv ? NS * pre + n_blocks - pre : n_blocks;
  const uint64_t z_rows = (uint64_t)n_lin_z * C, blk_rows = (uint64_t)2 * n_blocks * HID;
  int err = encode_weights(&q.m_in, w_in, kin, false);
  if (err == 0 && n_lin_z > 0) err = encode_weights(&q.m_z, w_z, z_rows, false);
  if (err == 0 && n_lin_z > 0) err = encode_weights(&q.m_zt, w_z, z_rows, true);
  if (err == 0) err = encode_weights(&q.m_blk, w_blk, blk_rows, false);
  if (err == 0) err = encode_weights(&q.m_blkt, w_blk, blk_rows, true);
  if (err == 0)
    err = hopper::encode_bf16_sw128(&q.m_act, ws_act, (uint64_t)(2 * NP + 1) * B_pad, HID, HID, 64);
  if (err != 0) return err;
  q.g = static_cast<const float*>(g);
  q.dz = static_cast<float*>(dz);
  q.dx = static_cast<float*>(dx);
  q.ws_act = static_cast<bf16*>(ws_act);
  q.ws_cot = static_cast<bf16*>(ws_cot);
  q.ws_x = static_cast<bf16*>(ws_x);
  q.ws_z = mv ? static_cast<bf16*>(ws_z) : nullptr;
  q.rows = static_cast<float*>(rows);
  q.vsum = static_cast<float*>(vsum);
  q.B_pad = B_pad;
  q.R = n_rows(n_blocks, n_lin_z, d_out);
  const int n_tiles = (q.B_pad + TILE_PTS - 1) / TILE_PTS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mv) {
    e = cudaFuncSetAttribute(resnetfc_bwd_data_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILE_SMEM);
    if (e != cudaSuccess) return (int)e;
    const int grid = n_ctas < n_tiles ? n_ctas : n_tiles;
    resnetfc_bwd_data_kernel<true><<<grid, TILE_THREADS, TILE_SMEM, st>>>(q);
  } else {
    e = cudaFuncSetAttribute(resnetfc_bwd_data_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TILE_SMEM);
    if (e != cudaSuccess) return (int)e;
    resnetfc_bwd_data_kernel<false><<<n_tiles, TILE_THREADS, TILE_SMEM, st>>>(q);
  }
  return (int)cudaGetLastError();
}

// What the data kernel fixes, for the wrapper to plan with: out[0..9] =
// points a tile, threads a CTA, f32 words of a multi-view slot, weight-ring
// stages, the most outputs of lin_out, the most steps of a tile, the widest
// latent, the tower width HID, the widest code (kin), the most blocks (a
// step's k).  Returns its shared memory a CTA.
size_t resnetfc_bwd_data_limits(int* out) {
  out[0] = TILE_PTS;
  out[1] = TILE_THREADS;
  out[2] = D_SLOT_FLOATS;
  out[3] = RING_STAGES;
  out[4] = TILE_MAX_OUT;
  out[5] = D_MAX_STEPS;
  out[6] = MAX_C;
  out[7] = HID;
  out[8] = TILE_K;
  out[9] = STEP_MAX_K;
  return TILE_SMEM;
}

// Shared memory of one weight-gradient CTA (the TMA ring).
size_t resnetfc_bwd_weights_smem_bytes() { return W_SMEM; }

// What the weights kernel fixes, for the wrapper to plan with: out[0..6] =
// the output tile's rows and columns, the most splits of a product, the most
// tensor maps and the most tasks of one launch, and where a plan's table
// lies in it (offset and bytes; the wrapper copies it to device memory).
// Returns the bytes of a plan.
size_t resnetfc_bwd_weights_limits(int* out) {
  out[0] = WT_M;
  out[1] = WT_N;
  out[2] = MAX_SPLITS;
  out[3] = MAX_MAPS;
  out[4] = MAX_TASKS;
  out[5] = (int)offsetof(WPlan, table);
  out[6] = (int)sizeof(WTable);
  return sizeof(WPlan);
}

// Fills `plan` (resnetfc_bwd_weights_limits' bytes) for the weight-gradient
// products of ops/resnetfc_vjp.py::weight_plan: tensor map k reads bases[k]
// as a (dims[3k] rows, dims[3k+1] columns, row stride dims[3k+2]) bf16
// matrix; task t is (A map, G map, M, P, splits, first element of its
// (M, N) bf16 output) at tasks[6t..], summed over `pts`-point pieces of its P
// points.  A plan holds addresses but no buffer of a call, so a caller keeps
// it (and the device copy of its table) for as long as the operands stay
// where they are.
int resnetfc_bwd_weights_plan(void* plan, const void* const* bases, const int* dims, int n_maps,
                              const int* tasks, int n_tasks, int N, int pts) {
  if (n_maps < 1 || n_maps > MAX_MAPS || n_tasks < 1 || n_tasks > MAX_TASKS || N % WT_N != 0 ||
      pts < WK || pts % WK != 0)
    return (int)cudaErrorInvalidValue;
  // built here (the caller's buffer need not be 64-byte aligned), zeroed: the
  // unused maps and tasks of the table copied to the card
  WPlan w = {};
  WParams& q = w.head;
  // a map read as G takes G's boxes (W_G_COLS columns), one read as A 64
  // columns; at W_G_COLS 32 no map may be both
  uint8_t role[MAX_MAPS] = {};  // bit 0: read as A, bit 1: read as G
  for (int t = 0; t < n_tasks; ++t) {
    const int* d = tasks + 6 * t;
    if (d[0] < 0 || d[0] >= n_maps || d[1] < 0 || d[1] >= n_maps) return (int)cudaErrorInvalidValue;
    role[d[0]] |= 1;
    role[d[1]] |= 2;
  }
  for (int k = 0; k < n_maps; ++k) {
    if (W_G_COLS != 64 && role[k] == 3) return (int)cudaErrorInvalidValue;
    const int err = hopper::encode_bf16(&w.table.maps[k], bases[k], dims[3 * k], dims[3 * k + 1],
                                        dims[3 * k + 2], WK, role[k] == 2 ? W_G_COLS : 64);
    if (err != 0) return err;
  }
  int tiles = 0, units = 0, n_splits = 0;
  for (int t = 0; t < n_tasks; ++t) {
    WTask& T = w.table.task[t];
    const int* d = tasks + 6 * t;
    T.a_map = d[0];
    T.g_map = d[1];
    T.M = d[2];
    T.P = d[3];
    T.splits = d[4];
    T.out = (size_t)d[5];
    if (T.a_map < 0 || T.a_map >= n_maps || T.g_map < 0 || T.g_map >= n_maps || T.M < 1 ||
        T.splits < 1 || T.splits > MAX_SPLITS || (T.splits - 1) * pts >= T.P ||
        T.P > T.splits * pts || d[5] < 0)
      return (int)cudaErrorInvalidValue;
    T.m_tiles = (T.M + WT_M - 1) / WT_M;
    T.tile0 = tiles;
    T.unit0 = units;
    tiles += T.m_tiles * (N / WT_N);
    if (T.splits > 1) units += T.m_tiles * (N / WT_N) * T.splits;
    n_splits = T.splits > n_splits ? T.splits : n_splits;
  }
  int ctas = 0;
  for (int s = 0; s < n_splits; ++s) {
    q.split_cta0[s] = ctas;
    for (int t = 0; t < n_tasks; ++t)
      if (w.table.task[t].splits > s) ctas += w.table.task[t].m_tiles * (N / WT_N);
  }
  q.split_cta0[n_splits] = ctas;
  q.n_tasks = n_tasks;
  q.n_splits = n_splits;
  q.N = N;
  q.pts = pts;
  q.tiles = tiles;
  q.units = units;
  memcpy(plan, &w, sizeof w);
  return (int)cudaSuccess;
}

// One launch of a plan: the products into `out` (bf16, at the plan's
// offsets), and the R rows of per-tile sums in `rows` (n_row_tiles, R, N)
// summed in tile order into rows_out (R, N).  table is the device copy of
// the plan's table (64-byte aligned); partial holds one f32 tile per (tile,
// split) of the tasks with splits > 1 and counters one zeroed int per tile.
int resnetfc_bwd_weights(const void* plan, const void* table, void* out, const void* rows,
                         void* rows_out, int n_row_tiles, int R, void* partial, void* counters,
                         void* stream) {
  WParams q;
  memcpy(&q, plan, sizeof q);
  if (R < 1 || out == nullptr || counters == nullptr || (q.units > 0 && partial == nullptr) ||
      table == nullptr || reinterpret_cast<uintptr_t>(table) % 64 != 0)
    return (int)cudaErrorInvalidValue;
  q.table = static_cast<const WTable*>(table);
  q.out = static_cast<bf16*>(out);
  q.partial = static_cast<float*>(partial);
  q.counters = static_cast<int*>(counters);
  q.rows = static_cast<const float*>(rows);
  q.n_row_tiles = n_row_tiles;
  q.R = R;
  q.rows_out = static_cast<float*>(rows_out);
  cudaError_t err = cudaFuncSetAttribute(resnetfc_bwd_weights_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ctas = q.split_cta0[q.n_splits];
  resnetfc_bwd_weights_kernel<<<ctas + R, W_THREADS, W_SMEM, static_cast<cudaStream_t>(stream)>>>(q);
  return (int)cudaGetLastError();
}

}  // extern "C"

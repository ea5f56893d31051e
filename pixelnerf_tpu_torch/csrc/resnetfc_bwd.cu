// ResnetFC backward for Hopper (sm_90a): the port of
// pixelnerf_tpu/ops/resnetfc_vjp.py::_bwd_kernel (reached through _core_bwd),
// for one view and for NS > 1 views, as two kernels that together compute
// what the TPU kernel does:
//
//   resnetfc_bwd_data     one CTA per 32-point tile (multi-view: persistent
//                         CTAs walking the tiles).  Recomputes the forward
//                         with the forward kernels' own tower code
//                         (resnetfc_tower.cuh), so the relu masks equal the
//                         primal's bit for bit, then backpropagates through
//                         lin_out, the blocks and the injections.  It writes
//                         dz (and dx when asked) per point, stashes the
//                         products' operands for the weight gradients in a
//                         workspace -- the bf16 operands r_k, s_k of every
//                         block and t of lin_out, the bf16 cotangents of every
//                         layer and the bf16 code (and, multi-view, latent) --
//                         and writes per-tile f32 column sums for the biases
//                         and the thin lin_out product.
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
// blocks k < pre and folds them into the mean (tower_mv); the walk back runs
// the shared blocks k >= pre once, takes dview = dxc * (1 / NS), and walks
// each view back through its own stashed operands from that same f32 start.
// dview is a 32 x 512 f32 tile like the view sum, and is kept in the same
// per-CTA device-memory slot.  The layers below the mean have NS workspace
// planes (view v at +v), so their weight products sum over NS B_pad rows --
// the views are simply more points -- and those above it over B_pad rows.
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
// operations bound.  The data kernel uses nvcuda::wmma 16x16x16 bf16 products
// with cp.async staging.
//
// The weights kernel on its own is bound by bytes on an H100 SXM: the train
// step's fine pass reads its workspace once, 1.18 GB at -V 1 and 2.4 GiB at
// -V 3 (0.35 and 0.82 ms at 3.35 TB/s), against 3.4e11 and 8.1e11 FLOP (0.34
// and 0.81 ms at 989 TFLOP/s).  Its design: 128 x 256 output tiles, each one
// m64n256k16 product per consumer warpgroup, both operands MN-major (the
// planes are (points, width) row-major and the product sums over points)
// straight from 128-byte-swizzled TMA boxes of 64 points, so no thread
// touches an operand; a 4-stage full / empty mbarrier ring kept full by one
// producer thread; the point axis split so that the CTAs fill the SMs in
// whole waves, numbered split-major so that the CTAs in flight share their A
// and G strips in L2; ragged edges (B rows of z read in place, kin < 64)
// come from TMA's zero fill.  The tensor maps and the task table are encoded
// once per set of operand addresses (resnetfc_bwd_weights_plan) and kept by
// the wrapper, so a launch costs the host one parameter copy; they travel in
// the 4 KB of kernel parameters, which hold up to 5 blocks (the wrapper
// refuses deeper towers).

#include <string.h>

#include "hopper_mma.cuh"
#include "resnetfc_tower.cuh"

namespace {

using namespace rfc;

struct BwdParams {
  TowerParams t;   // z, x and the packed weights
  const float* g;  // (d_out, B) planar f32 cotangent
  float* dz;       // (B_pad, C) f32, written when n_lin_z > 0
  float* dx;       // (B, d_in) f32, or null
  bf16* ws_act;    // (2 NP + 1, B_pad, H): r_k, s_k, t (NP = plane_at(n_blocks))
  bf16* ws_cot;    // (2 NP + NS, B_pad, H): gb_k, dh_k, g_in
  bf16* ws_x;      // (NS, B_pad, kin) bf16 code
  bf16* ws_z;      // (NS, B_pad, C) bf16 latent, multi-view only
  float* rows;     // (n_tiles, R, H) per-tile column sums
  float* vsum;     // (gridDim.x, SLOT_FLOATS), multi-view only
  int B_pad, R;
};
// rows: 0 db_in | 1 + k db_z[k] | 1 + n_lin_z + 2k + i db of fc_i of block k
//       | 1 + n_lin_z + 2 n_blocks db_out (first d_out columns) | then d_out
//       rows of dW_out^T

// dst = bf16(f) over the warp's fragments, and the column sums of the f32 f
// over the tile's rows into ra (and rb when given), or added to them (`add`:
// a later view of the same tile).
__device__ __forceinline__ void emit_cot(const FragC (&f)[2][J], bf16* dst, int ld, int col0,
                                         float* stg, float* ra, float* rb, bool add) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float csum = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wmma::store_matrix_sync(stg, f[h][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        dst[(16 * h + (e >> 4)) * ld + col0 + 16 * j + (e & 15)] = __float2bfloat16_rn(stg[e]);
      if (lane < 16)
        for (int r = 0; r < 16; ++r) csum += stg[r * 16 + lane];
      __syncwarp();
    }
    if (lane < 16) {
      float* a = ra + col0 + 16 * j + lane;
      *a = add ? *a + csum : csum;
      if (rb) {
        float* b = rb + col0 + 16 * j + lane;
        *b = add ? *b + csum : csum;
      }
    }
  }
}

__device__ __forceinline__ bool live(const bf16* m, int ld, int h, int col, int e) {
  return __bfloat162float(m[(16 * h + (e >> 4)) * ld + col + (e & 15)]) > 0.0f;
}

template <bool MV>
__global__ void __launch_bounds__(NTHREADS, 1) resnetfc_bwd_data_kernel(const BwdParams q) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const TowerParams& p = q.t;
  const Layout L = layout(p.C, p.kin, p.n_lin_z, true);
  const Smem s = carve(smem_raw, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = warp * J * 16;
  const int nb = p.n_blocks, nlz = p.n_lin_z, d_out = p.d_out, C = p.C;
  // one view: every block per view, one plane each (compile-time, so the
  // single-view kernel keeps the shape it had before the view loop)
  const int pre = MV ? p.pre : nb, NS = MV ? p.NS : 1;
  auto first_plane = [&](int k) -> size_t { return MV ? plane_at(p, k) : (size_t)k; };
  const size_t plane = (size_t)q.B_pad * HID;
  const size_t NP = first_plane(nb);  // planes of one kind (r, s, gb or dh) over all blocks
  const int row_bout = 1 + nlz + 2 * nb;
  const int n_tiles = q.B_pad / BM;
  float* slot = MV ? q.vsum + (size_t)blockIdx.x * SLOT_FLOATS : nullptr;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * BM;
    float* rows = q.rows + (size_t)tile * q.R * HID;
    FragC dxc[2][J], acc[2][J];
    if (MV) {
      tower_mv<false, true>(p, L, s, dxc, acc, row0, slot, q.ws_act, q.ws_x, q.ws_z, q.B_pad);
    } else {
      load_inputs<false>(p, L, s, row0, 0);
      __syncthreads();
      copy_tile<true>(s.xin, L.ldx, q.ws_x, p.kin, row0);
      tower<true>(p, L, s, dxc, acc, row0, q.ws_act, plane);  // s.act = t
    }
    copy_tile<true>(s.act, L.lda, q.ws_act + 2 * NP * plane, HID, row0);

    // ---- lin_out: dW_out += t^T bf16(g), db_out += sum g, dt = bf16(g) W_out^T ----
    float* gs = reinterpret_cast<float*>(s.mb);  // (BM, d_out) cotangent tile
    for (int e = tid; e < BM * d_out; e += NTHREADS) {
      const int r = e / d_out, c = e - r * d_out, gi = row0 + r;
      gs[e] = gi < p.B ? q.g[(size_t)c * p.B + gi] : 0.0f;
    }
    __syncthreads();
    for (int c = tid; c < HID; c += NTHREADS) {
      float sb = 0.0f;
      if (c < d_out)
        for (int r = 0; r < BM; ++r) sb += gs[r * d_out + c];
      rows[(size_t)row_bout * HID + c] = sb;
      for (int o = 0; o < d_out; ++o) {
        float sw = 0.0f;
        for (int r = 0; r < BM; ++r)
          sw = fmaf(__bfloat162float(s.act[r * L.lda + c]), round_bf16(gs[r * d_out + o]), sw);
        rows[(size_t)(row_bout + 1 + o) * HID + c] = sw;
      }
    }
  #pragma unroll
    for (int j = 0; j < J; ++j) {
  #pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (int e = lane; e < 256; e += 32) {
          const int r = 16 * h + (e >> 4), col = col0 + 16 * j + (e & 15);
          float v = 0.0f;
          for (int o = 0; o < d_out; ++o)
            v = fmaf(round_bf16(gs[r * d_out + o]), __bfloat162float(p.w_out[(size_t)col * d_out + o]), v);
          s.stg[e] = live(s.act, L.lda, h, col0 + 16 * j, e) ? v : 0.0f;
        }
        __syncwarp();
        wmma::load_matrix_sync(dxc[h][j], s.stg, 16, wmma::mem_row_major);
        __syncwarp();
      }
    }
    __syncthreads();  // t and the g tile are read; s.act and s.mb are rewritten below

    bool dz_started = false;
    // dz_v (+)= bf16(dv) W_z[kz]^T with bf16(dv) in s.act, summed in f32 in dz
    // (view v's rows start at v B_pad)
    auto dz_add = [&](int kz, int v) {
      warp_gemm<true>(acc, s.act, L.lda, HID, p.w_z + (size_t)kz * C * HID, HID, col0, s.ring, L.sld);
  #pragma unroll
      for (int j = 0; j < J; ++j) {
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* dst = q.dz + ((size_t)v * q.B_pad + row0 + 16 * h) * C + col0 + 16 * j;
          if (dz_started) {
            FragC old;
            wmma::load_matrix_sync(old, dst, C, wmma::mem_row_major);
  #pragma unroll
            for (int i = 0; i < old.num_elements; ++i) acc[h][j].x[i] = old.x[i] + acc[h][j].x[i];
          }
          wmma::store_matrix_sync(dst, acc[h][j], C, wmma::mem_row_major);
        }
      }
      dz_started = true;
    };

    // back through block k (view v below the mean, 0 above it); a later view
    // adds its bias column sums to the earlier views'
    auto block_back = [&](int k, int v) {
      const bool below = k < pre, add = below && v > 0;
      const size_t pc = first_plane(k) + (below ? v : 0);      // gb_k; dh_k at NP + pc
      const size_t pa = 2 * first_plane(k) + (below ? v : 0);  // r_k; s_k at pa + views
      const bf16* w0 = p.w_blk + (size_t)(2 * k) * HID * HID;
      // gb = bf16(cotangent of block k's output); db of fc_1 sums the f32 one,
      // and so does db of lin_z_{k+1}, whose output meets the same cotangent
      emit_cot(dxc, s.act, L.lda, col0, s.stg, rows + (size_t)(1 + nlz + 2 * k + 1) * HID,
               k + 1 < nlz ? rows + (size_t)(2 + k) * HID : nullptr, add);
      __syncthreads();
      copy_tile<true>(s.act, L.lda, q.ws_cot + pc * plane, HID, row0);
      if (k + 1 < nlz) dz_add(k + 1, v);
      copy_tile<false>(s.mb, L.lda, q.ws_act + (pa + (below ? NS : 1)) * plane, HID, row0);
      warp_gemm<true>(acc, s.act, L.lda, HID, w0 + (size_t)HID * HID, HID, col0, s.ring, L.sld);
      __syncthreads();  // s_k complete
      // dh = ds [s > 0]: bf16 into hb, f32 column sums for db of fc_0
      float* row_fc0 = rows + (size_t)(1 + nlz + 2 * k) * HID;
  #pragma unroll
      for (int j = 0; j < J; ++j) {
        float csum = 0.0f;
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          wmma::store_matrix_sync(s.stg, acc[h][j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const float dh = live(s.mb, L.lda, h, col0 + 16 * j, e) ? s.stg[e] : 0.0f;
            s.stg[e] = dh;
            s.hb[(16 * h + (e >> 4)) * L.lda + col0 + 16 * j + (e & 15)] = __float2bfloat16_rn(dh);
          }
          __syncwarp();
          if (lane < 16)
            for (int r = 0; r < 16; ++r) csum += s.stg[r * 16 + lane];
          __syncwarp();
        }
        if (lane < 16) {
          float* a = row_fc0 + col0 + 16 * j + lane;
          *a = add ? *a + csum : csum;
        }
      }
      __syncthreads();  // hb complete; the s_k masks are read
      copy_tile<true>(s.hb, L.lda, q.ws_cot + (NP + pc) * plane, HID, row0);
      copy_tile<false>(s.mb, L.lda, q.ws_act + pa * plane, HID, row0);  // r_k
      warp_gemm<true>(acc, s.hb, L.lda, HID, w0, HID, col0, s.ring, L.sld);  // dr = bf16(dh) W0^T
      __syncthreads();  // r_k complete
  #pragma unroll
      for (int j = 0; j < J; ++j) {
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          wmma::store_matrix_sync(s.stg, acc[h][j], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32)
            if (!live(s.mb, L.lda, h, col0 + 16 * j, e)) s.stg[e] = 0.0f;
          __syncwarp();
          FragC dr;
          wmma::load_matrix_sync(dr, s.stg, 16, wmma::mem_row_major);
          __syncwarp();
  #pragma unroll
          for (int i = 0; i < dr.num_elements; ++i) dxc[h][j].x[i] += dr.x[i];
        }
      }
    };

    for (int k = nb - 1; k >= pre; --k) block_back(k, 0);  // above the mean (none when NS == 1)
    for (int v = 0; v < NS; ++v) {
      if (MV) {
        // dview = dxc * (1 / NS) starts every view's walk: kept in the slot
        const float inv = 1.0f / (float)NS;
  #pragma unroll
        for (int h = 0; h < 2; ++h)
  #pragma unroll
          for (int j = 0; j < J; ++j)
  #pragma unroll
            for (int i = 0; i < FragC::num_elements; ++i) {
              float* a = slot_at(slot, h, j, i);
              if (v == 0) {
                dxc[h][j].x[i] *= inv;
                *a = dxc[h][j].x[i];
              } else {
                dxc[h][j].x[i] = *a;
              }
            }
      }
      dz_started = false;
      for (int k = pre - 1; k >= 0; --k) block_back(k, v);

      // the cotangent of lin_in's output, which is also lin_z_0's
      emit_cot(dxc, s.act, L.lda, col0, s.stg, rows, nlz > 0 ? rows + HID : nullptr, v > 0);
      __syncthreads();
      copy_tile<true>(s.act, L.lda, q.ws_cot + (2 * NP + v) * plane, HID, row0);
      if (nlz > 0) dz_add(0, v);
      if (q.dx != nullptr && warp < p.kin / 16) {
        // dx = bf16(dv) W_in^T: one 16-column tile of the code per warp
        FragC d[2];
        wmma::fill_fragment(d[0], 0.0f);
        wmma::fill_fragment(d[1], 0.0f);
        for (int ks = 0; ks < HID / 16; ++ks) {
          FragA a0, a1;
          FragBT b;
          wmma::load_matrix_sync(a0, s.act + ks * 16, L.lda);
          wmma::load_matrix_sync(a1, s.act + 16 * L.lda + ks * 16, L.lda);
          wmma::load_matrix_sync(b, p.w_in + (size_t)(16 * warp) * HID + ks * 16, HID);
          wmma::mma_sync(d[0], a0, b, d[0]);
          wmma::mma_sync(d[1], a1, b, d[1]);
        }
        for (int h = 0; h < 2; ++h) {
          wmma::store_matrix_sync(s.stg, d[h], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int gi = row0 + 16 * h + (e >> 4), c = 16 * warp + (e & 15);
            if (gi < p.B && c < p.d_in)
              q.dx[(MV ? src_row(p, gi, v) : (size_t)gi) * p.d_in + c] = s.stg[e];
          }
          __syncwarp();
        }
      }
      __syncthreads();  // s.act (g_in of view v) is read before the next view rewrites it
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradients: dW[m, n] = sum_p A[p, m] G[p, n], a grouped split-K GEMM
// on wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int WT_M = 128;  // output tile: rows of dW (two warpgroups of 64)
constexpr int WT_N = 256;  // output tile: columns of dW (one m64n256 product)
constexpr int WK = 64;     // points per k-step: one TMA box is 64 columns x 64 points
constexpr int W_STAGES = 4;
constexpr int W_THREADS = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int W_CONSUMERS = 256;
constexpr uint32_t W_BOX = WK * 128;            // bytes of one 64 x 64 bf16 box
constexpr uint32_t W_STAGE_A = 2 * W_BOX;       // A: 64 points x 128 columns
constexpr uint32_t W_STAGE = W_STAGE_A + 4 * W_BOX;  // + G: 64 points x 256 columns
constexpr size_t W_SMEM = (size_t)W_STAGES * W_STAGE + 1024;  // + alignment slack
// The tensor maps and the task table travel in the kernel's parameters, which
// every CUDA 12 toolkit caps at 4 KB: sn64 (5 blocks) takes 23 maps and 14
// tasks at both view counts; 6 blocks would take 27 maps.
constexpr int MAX_MAPS = 24;
constexpr int MAX_TASKS = 16;
constexpr int MAX_SPLITS = 24;

struct WTask {
  size_t out;        // first element of dW (M, N) row-major in the output buffer
  int a_map, g_map;  // tensor maps of A (P x M) and G (P x N)
  int M, P;          // dW rows; points summed over
  int splits;        // the point axis in `pts`-point pieces, the last one shorter
  int m_tiles, tile0, unit0;  // M tiles; first tile and first (tile, split) slot
};

// A launch's parameters: the plan (maps, tasks, CTA order), which depends only
// on the operands' addresses and shapes and is built once per such set by
// resnetfc_bwd_weights_plan, and the buffers of one call.
struct WParams {
  CUtensorMap maps[MAX_MAPS];
  WTask task[MAX_TASKS];
  int split_cta0[MAX_SPLITS + 1];  // first GEMM CTA of each split (split-major order)
  int n_tasks, n_splits, N, pts, tiles, units;
  bf16* out;       // the weight gradients, one buffer
  float* partial;  // (units, WT_M * WT_N) f32 per (tile, split), tasks with splits > 1
  int* counters;   // (tiles), zero on entry
  const float* rows;
  int n_row_tiles, R;
  float* rows_out;  // (R, N)
};
static_assert(sizeof(WParams) <= 4096, "kernel parameters of every CUDA 12 toolkit");

// The GEMM CTAs, split-major (the tiles of split 0 of every task, then split
// 1, ...), then one bias CTA per row of sums, which the last wave's idle SMs
// take.  A GEMM CTA runs one (tile, split): warpgroup 2's first thread
// streams the split's points through a W_STAGES ring with TMA (full / empty
// mbarriers); warpgroups 0 and 1 each multiply one 64-row half of the A tile
// by the whole G tile with wgmma m64n256k16, both operands MN-major from
// 128-byte-swizzled boxes.  A tile of one split writes bf16 directly;
// otherwise each split writes its f32 partial and the last CTA of the tile
// sums them in split order.
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
  int local = bid - q.split_cta0[s], ti = 0;
  for (; ti < q.n_tasks; ++ti) {
    if (q.task[ti].splits <= s) continue;
    const int nt = q.task[ti].m_tiles * ntn;
    if (local < nt) break;
    local -= nt;
  }
  const WTask& T = q.task[ti];
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
      const CUtensorMap* am = &q.maps[T.a_map];
      const CUtensorMap* gm = &q.maps[T.g_map];
      for (int i = 0; i < nk; ++i) {
        const int st = i % W_STAGES;
        hopper::mbar_wait(&empty[st], ((i / W_STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], W_STAGE);
        unsigned char* a = ring + st * W_STAGE;
        const int p = p0 + i * WK;
        hopper::tma_load_2d(a, am, &full[st], m0, p);
        hopper::tma_load_2d(a + W_BOX, am, &full[st], m0 + 64, p);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hopper::tma_load_2d(a + W_STAGE_A + j * W_BOX, gm, &full[st], n0 + 64 * j, p);
      }
    }
  } else {  // consumers: rows 64 wg .. 64 wg + 63 of the tile
    hopper::setmaxnreg_inc<232>();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int i = 0; i < nk; ++i) {
      const int st = i % W_STAGES;
      hopper::mbar_wait(&full[st], (i / W_STAGES) & 1);
      const unsigned char* a = ring + st * W_STAGE + wg * W_BOX;
      const unsigned char* g = ring + st * W_STAGE + W_STAGE_A;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)  // 16 points = 16 rows of 128 B
        hopper::wgmma_m64n256k16<1, 1>(acc, hopper::desc_sw128(a + kk * 2048, W_BOX, 1024),
                                       hopper::desc_sw128(g + kk * 2048, W_BOX, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // step i - 1's products have read their stage
      if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % W_STAGES]);
    }
    hopper::wgmma_wait<0>();

    const int tw = tid & 127, r0 = 64 * wg + 16 * (tw >> 5) + ((tw & 31) >> 2);
    const int c0 = 2 * (tw & 3);
    if (T.splits == 1) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
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
    for (int j = 0; j < 32; ++j)
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

size_t resnetfc_bwd_smem_bytes(int C, int kin, int n_lin_z) {
  return layout(C, kin, n_lin_z, true).total;
}

// Rows of per-tile sums: db_in, db_z[k], db of every block layer, db_out and
// the d_out rows of dW_out^T.
int resnetfc_bwd_rows(int n_blocks, int n_lin_z, int d_out) { return n_rows(n_blocks, n_lin_z, d_out); }

// Multi-view (NS > 1): B = SB B_obj output points, NS object-major input
// rows each, the first `pre` blocks per view; ws_z holds NS (B_pad, C) bf16
// latent planes and vsum n_ctas slots of SLOT_FLOATS f32, and the grid is at
// most n_ctas.  NS == 1 ignores B_obj, pre, ws_z, vsum and n_ctas.
int resnetfc_bwd_data(const void* g, const void* z, const void* x, const void* w_in,
                      const void* b_in, const void* w_z, const void* b_z, const void* w_blk,
                      const void* b_blk, const void* w_out, void* dz, void* dx, void* ws_act,
                      void* ws_cot, void* ws_x, void* ws_z, void* rows, void* vsum, int B,
                      int d_in, int kin, int H, int C, int n_blocks, int n_lin_z, int d_out,
                      int NS, int B_obj, int pre, int n_ctas, void* stream) {
  if (H != HID || (n_lin_z > 0 && C != HID) || kin / 16 > NWARPS || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const bool mv = NS > 1;
  if (mv && (pre < 0 || pre >= n_blocks || n_lin_z > pre || B_obj < 1 || B % B_obj != 0 ||
             vsum == nullptr || n_ctas < 1 || (n_lin_z > 0 && ws_z == nullptr)))
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
  q.g = static_cast<const float*>(g);
  q.dz = static_cast<float*>(dz);
  q.dx = static_cast<float*>(dx);
  q.ws_act = static_cast<bf16*>(ws_act);
  q.ws_cot = static_cast<bf16*>(ws_cot);
  q.ws_x = static_cast<bf16*>(ws_x);
  q.ws_z = static_cast<bf16*>(ws_z);
  q.rows = static_cast<float*>(rows);
  q.vsum = static_cast<float*>(vsum);
  const int n_tiles = (B + BM - 1) / BM;
  q.B_pad = n_tiles * BM;
  q.R = n_rows(n_blocks, n_lin_z, d_out);
  const size_t smem = layout(C, kin, n_lin_z, true).total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mv) {
    err = cudaFuncSetAttribute(resnetfc_bwd_data_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int grid = n_ctas < n_tiles ? n_ctas : n_tiles;
    resnetfc_bwd_data_kernel<true><<<grid, NTHREADS, smem, st>>>(q);
  } else {
    err = cudaFuncSetAttribute(resnetfc_bwd_data_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    resnetfc_bwd_data_kernel<false><<<n_tiles, NTHREADS, smem, st>>>(q);
  }
  return (int)cudaGetLastError();
}

// Shared memory of one weight-gradient CTA (the TMA ring).
size_t resnetfc_bwd_weights_smem_bytes() { return W_SMEM; }

// What the weights kernel fixes, for the wrapper to plan with: out[0..4] =
// the output tile's rows and columns, the most splits of a product, the most
// tensor maps and the most tasks of one launch.  Returns the bytes of a plan.
size_t resnetfc_bwd_weights_limits(int* out) {
  out[0] = WT_M;
  out[1] = WT_N;
  out[2] = MAX_SPLITS;
  out[3] = MAX_MAPS;
  out[4] = MAX_TASKS;
  return sizeof(WParams);
}

// Fills `plan` (resnetfc_bwd_weights_limits' bytes) for the weight-gradient
// products of ops/resnetfc_vjp.py::weight_plan: tensor map k reads bases[k]
// as a (dims[3k] rows, dims[3k+1] columns, row stride dims[3k+2]) bf16
// matrix; task t is (A map, G map, M, P, splits, first element of its
// (M, N) bf16 output) at tasks[6t..], summed over `pts`-point pieces of its P
// points.  A plan holds addresses but no buffer of a call, so a caller keeps
// it for as long as the operands stay where they are.
int resnetfc_bwd_weights_plan(void* plan, const void* const* bases, const int* dims, int n_maps,
                              const int* tasks, int n_tasks, int N, int pts) {
  if (n_maps < 1 || n_maps > MAX_MAPS || n_tasks < 1 || n_tasks > MAX_TASKS || N % WT_N != 0 ||
      pts < WK || pts % WK != 0)
    return (int)cudaErrorInvalidValue;
  WParams q = {};
  for (int k = 0; k < n_maps; ++k) {
    const int err = hopper::encode_bf16_sw128(&q.maps[k], bases[k], dims[3 * k], dims[3 * k + 1],
                                              dims[3 * k + 2], WK);
    if (err != 0) return err;
  }
  int tiles = 0, units = 0, n_splits = 0;
  for (int t = 0; t < n_tasks; ++t) {
    WTask& T = q.task[t];
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
      if (q.task[t].splits > s) ctas += q.task[t].m_tiles * (N / WT_N);
  }
  q.split_cta0[n_splits] = ctas;
  q.n_tasks = n_tasks;
  q.n_splits = n_splits;
  q.N = N;
  q.pts = pts;
  q.tiles = tiles;
  q.units = units;
  memcpy(plan, &q, sizeof q);
  return (int)cudaSuccess;
}

// One launch of a plan: the products into `out` (bf16, at the plan's
// offsets), and the R rows of per-tile sums in `rows` (n_row_tiles, R, N)
// summed in tile order into rows_out (R, N).  partial holds one f32 tile per
// (tile, split) of the tasks with splits > 1 and counters one zeroed int per
// tile.
int resnetfc_bwd_weights(const void* plan, void* out, const void* rows, void* rows_out,
                         int n_row_tiles, int R, void* partial, void* counters, void* stream) {
  WParams q;
  memcpy(&q, plan, sizeof q);
  if (R < 1 || out == nullptr || counters == nullptr || (q.units > 0 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
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

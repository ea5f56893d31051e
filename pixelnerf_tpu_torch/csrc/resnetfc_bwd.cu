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
//   resnetfc_bwd_weights  dW = A^T . G over the point axis for every weight
//                         matrix (lin_in, lin_z_k, fc_0/fc_1 of every block),
//                         128x128 output tiles, the point axis split into f32
//                         partials that the last CTA of each tile sums in a
//                         fixed order; and the per-tile bias sums reduced in
//                         tile order.  Both reductions are deterministic: two
//                         calls on the same inputs give the same bits.
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
// operations bound.  Both kernels use nvcuda::wmma 16x16x16 bf16 products
// with cp.async staging; wgmma and TMA are later work.

#include "resnetfc_tower.cuh"

namespace {

using namespace rfc;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAT;

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
// weight gradients: dW[m, n] = sum_p A[p, m] G[p, n]
// ---------------------------------------------------------------------------

constexpr int WT = 128;      // output tile, rows and columns
constexpr int WK = 32;       // points per k-step
constexpr int WLD = WT + 8;  // shared-memory row stride (elements)
constexpr int WSTAGES = 3;
constexpr int MAX_TASKS = 40;
constexpr size_t W_SMEM = (size_t)2 * WSTAGES * WK * WLD * sizeof(bf16);

struct WTask {
  const bf16* A;  // (rows, lda) row-major, columns 0..M-1 used
  const bf16* G;  // (P, N) row-major
  bf16* out;      // (M, N) row-major
  // P: points summed over (NS B_pad below the view mean, B_pad above it),
  // pts: points per split, a multiple of WK
  int M, lda, rows_valid, tile0, m_tiles, P, pts;
};

struct WParams {
  WTask task[MAX_TASKS];
  int n_tasks, N, splits, n_gemm_ctas;
  float* partial;  // (tiles, splits, WT * WT)
  int* counters;   // (tiles), zero on entry
  const float* rows;
  int n_row_tiles, R;
  float* rows_out;  // (R, N)
};

__global__ void __launch_bounds__(NTHREADS) resnetfc_bwd_weights_kernel(const WParams q) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int last;
  const int tid = threadIdx.x;
  int bid = blockIdx.x;
  if (bid >= q.n_gemm_ctas) {  // bias / lin_out rows: sum the tiles in order
    bid -= q.n_gemm_ctas;
    const int per_row = q.N / NTHREADS;
    const int r = bid / per_row, col = (bid - r * per_row) * NTHREADS + tid;
    float acc = 0.0f;
    for (int t = 0; t < q.n_row_tiles; ++t) acc += q.rows[((size_t)t * q.R + r) * q.N + col];
    q.rows_out[(size_t)r * q.N + col] = acc;
    return;
  }
  const int tile = bid / q.splits, split = bid - tile * q.splits;
  int ti = 0;
  while (ti + 1 < q.n_tasks && tile >= q.task[ti + 1].tile0) ++ti;
  const WTask& T = q.task[ti];
  const int ntn = q.N / WT;
  const int local = tile - T.tile0, mt = local / ntn, nt = local - mt * ntn;
  const int m0 = mt * WT, n0 = nt * WT;
  const int p_begin = split * T.pts;
  const int p_end = min(T.P, p_begin + T.pts);
  const int nk = p_end > p_begin ? (p_end - p_begin) / WK : 0;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = As + WSTAGES * WK * WLD;

  auto stage = [&](int slot, int ks) {
    const int p0 = p_begin + ks * WK;
    bf16* a = As + slot * WK * WLD;
    bf16* g = Gs + slot * WK * WLD;
    for (int c = tid; c < WK * (WT / 8); c += NTHREADS) {
      const int r = c / (WT / 8), u = c - r * (WT / 8);
      const int pt = p0 + r, m = m0 + u * 8;
      const bool ok = pt < T.rows_valid && m < T.M;
      cp_async16_zfill(a + r * WLD + u * 8, ok ? (const void*)(T.A + (size_t)pt * T.lda + m)
                                               : (const void*)T.A, ok ? 16 : 0);
      cp_async16(g + r * WLD + u * 8, T.G + (size_t)pt * q.N + n0 + u * 8);
    }
  };

  const int warp = tid >> 5, wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wmma::fill_fragment(acc[i][0], 0.0f);
    wmma::fill_fragment(acc[i][1], 0.0f);
  }
#pragma unroll
  for (int sl = 0; sl < WSTAGES - 1; ++sl) {
    if (sl < nk) stage(sl, sl);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();  // slot ks landed for every thread; slot ks-1 is no longer read
    const int pre = ks + WSTAGES - 1;
    if (pre < nk) stage(pre % WSTAGES, pre);
    cp_async_commit();
    const bf16* a = As + (ks % WSTAGES) * WK * WLD;
    const bf16* g = Gs + (ks % WSTAGES) * WK * WLD;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      FragAT fa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a + kk * 16 * WLD + wm * 64 + i * 16, WLD);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        FragB fb;
        wmma::load_matrix_sync(fb, g + kk * 16 * WLD + wn * 32 + jn * 16, WLD);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][jn], fa[i], fb, acc[i][jn]);
      }
    }
  }
  cp_async_wait<0>();

  float* part = q.partial + ((size_t)tile * q.splits + split) * WT * WT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
      wmma::store_matrix_sync(part + (size_t)(wm * 64 + i * 16) * WT + wn * 32 + jn * 16,
                              acc[i][jn], WT, wmma::mem_row_major);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(q.counters + tile, 1) == q.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last CTA of this tile sums the partials in split order
  const float* base = q.partial + (size_t)tile * q.splits * WT * WT;
  for (int e = tid * 4; e < WT * WT; e += NTHREADS * 4) {
    float4 acc4 = __ldcg(reinterpret_cast<const float4*>(base + e));
    for (int sp = 1; sp < q.splits; ++sp) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(base + (size_t)sp * WT * WT + e));
      acc4.x += v.x;
      acc4.y += v.y;
      acc4.z += v.z;
      acc4.w += v.w;
    }
    const int r = e / WT, c = e - r * WT;
    if (m0 + r < T.M) {
      uint2* o = reinterpret_cast<uint2*>(T.out + (size_t)(m0 + r) * q.N + n0 + c);
      *o = make_uint2(pack_bf16x2(acc4.x, acc4.y), pack_bf16x2(acc4.z, acc4.w));
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

// 128 x 128 output tiles of the weight-gradient products.
int resnetfc_bwd_weight_tiles(int kin, int H, int C, int n_blocks, int n_lin_z) {
  const int ntn = H / WT;
  return ((kin + WT - 1) / WT + n_lin_z * ((C + WT - 1) / WT) + 2 * n_blocks * (H / WT)) * ntn;
}

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

// The tasks' point axes: NS B_pad rows for lin_in, lin_z_k and blocks
// k < pre, B_pad for the rest (NS == 1: B_pad for all).  z is read in place
// when NS == 1; multi-view reads the tile-ordered bf16 planes ws_z.
int resnetfc_bwd_weights(const void* z, const void* ws_act, const void* ws_cot, const void* ws_x,
                         const void* ws_z, const void* rows, void* dw_in, void* dw_z,
                         void* dw_blk, void* rows_out, void* partial, void* counters, int B,
                         int kin, int H, int C, int n_blocks, int n_lin_z, int d_out, int NS,
                         int pre, int splits, void* stream) {
  const int B_pad = (B + BM - 1) / BM * BM;
  const int n_tasks = 1 + n_lin_z + 2 * n_blocks;
  if (NS == 1) pre = n_blocks;
  if (H != HID || n_tasks > MAX_TASKS || splits < 1 || kin % 8 != 0 || C % 8 != 0 || NS < 1 ||
      pre < 0 || pre > n_blocks || (NS > 1 && n_lin_z > 0 && ws_z == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)B_pad * H;
  // planes of block k (r_k, gb_k, ...) start at plane_of(k); NP over all blocks
  auto plane_of = [&](int k) {
    return k < pre ? (size_t)NS * k : (size_t)NS * pre + (k - pre);
  };
  const size_t NP = plane_of(n_blocks);
  const bf16* act = static_cast<const bf16*>(ws_act);
  const bf16* cot = static_cast<const bf16*>(ws_cot);
  const bf16* g_in = cot + 2 * NP * plane;
  const int P_views = NS * B_pad;
  WParams q = {};
  int tiles = 0, t = 0;
  auto add = [&](const bf16* A, int lda, int M, int rows_valid, int P, const bf16* G, bf16* out) {
    WTask& T = q.task[t++];
    T.A = A;
    T.G = G;
    T.out = out;
    T.M = M;
    T.lda = lda;
    T.rows_valid = rows_valid;
    T.P = P;
    T.pts = ((P + splits - 1) / splits + WK - 1) / WK * WK;
    T.tile0 = tiles;
    T.m_tiles = (M + WT - 1) / WT;
    tiles += T.m_tiles * (H / WT);
  };
  add(static_cast<const bf16*>(ws_x), kin, kin, P_views, P_views, g_in, static_cast<bf16*>(dw_in));
  for (int k = 0; k < n_lin_z; ++k) {
    const bf16* A = NS == 1 ? static_cast<const bf16*>(z) : static_cast<const bf16*>(ws_z);
    add(A, C, C, NS == 1 ? B : P_views, P_views, k == 0 ? g_in : cot + plane_of(k - 1) * plane,
        static_cast<bf16*>(dw_z) + (size_t)k * C * H);
  }
  for (int k = 0; k < n_blocks; ++k) {
    const int views = k < pre ? NS : 1;
    const size_t pk = plane_of(k);
    bf16* o = static_cast<bf16*>(dw_blk) + (size_t)(2 * k) * H * H;
    add(act + 2 * pk * plane, H, H, views * B_pad, views * B_pad, cot + (NP + pk) * plane, o);
    add(act + (2 * pk + views) * plane, H, H, views * B_pad, views * B_pad, cot + pk * plane,
        o + (size_t)H * H);
  }
  q.n_tasks = n_tasks;
  q.N = H;
  q.splits = splits;
  q.n_gemm_ctas = tiles * splits;
  q.partial = static_cast<float*>(partial);
  q.counters = static_cast<int*>(counters);
  q.rows = static_cast<const float*>(rows);
  q.n_row_tiles = B_pad / BM;
  q.R = n_rows(n_blocks, n_lin_z, d_out);
  q.rows_out = static_cast<float*>(rows_out);
  cudaError_t err = cudaFuncSetAttribute(resnetfc_bwd_weights_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = q.n_gemm_ctas + q.R * (H / NTHREADS);
  resnetfc_bwd_weights_kernel<<<grid, NTHREADS, W_SMEM, static_cast<cudaStream_t>(stream)>>>(q);
  return (int)cudaGetLastError();
}

}  // extern "C"

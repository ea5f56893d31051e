// The ResnetFC tower on one 32-point tile, for the one forward kernel that
// has not moved onto the 64-point wgmma tile (tile64.cuh) yet: the
// multi-view gather (resnetfc_fwd_gather_mv, in resnetfc_fwd.cu).  Its
// TowerParams, src_row and bf16 helpers also serve the tile kernels.
//
// Per point (one view; each view below combine_layer at NS > 1):
//   x = lin_in(code)
//   for k < n_blocks:  [x += lin_z_k(z) while k < n_lin_z]
//                      x += fc_1(relu(fc_0(relu(x))))
// with bf16 operands and f32 accumulation: the code, z and every relu output
// are rounded to bf16 before their product, biases and the residual stream
// stay f32, and each layer adds its bias to the f32 product before the
// residual add.
//
// One CTA of 8 warps per 32-point tile, each warp owning 64 output columns of
// every layer.  A warp's slice of the f32 residual stream lives in its
// accumulator fragments; bias, relu and the bf16 rounding are applied per
// fragment through a small per-warp staging tile.  Weights (~7 MB bf16,
// L2-resident) reach shared memory through a 4-stage per-warp cp.async ring of
// 16-row slabs in 16-byte coalesced copies; the bf16 operand buffers are
// row-padded against bank conflicts.
//
// Multi-view (NS > 1, the port of _kernel_2d_mv_gather): a tile is 32
// output points, and each view of them runs lin_in and blocks k < pre (=
// combine_layer) in turn through the same code; the view mean then feeds the
// shared blocks k >= pre and lin_out.  The mean is the TPU kernel's sum(xs) *
// (1 / NS): an f32 sum in view order, then one multiply.  The running sum is
// a second 32 x 512 f32 residual, 64 KB a tile, which fits neither beside the
// stream in registers (64 a thread each) nor in the ~185 KB of shared memory
// the tower already takes.  It lives in device memory instead, in a per-CTA
// slot (`vsum`, 64 KB) that each thread writes and reads back only its own
// fragment elements of, coalesced; the kernel is persistent (one CTA per SM
// walks the tiles), so the slots total 132 x 64 KB = 8.4 MB and stay in the
// 50 MB L2.  The multi-view dense kernel takes the same walk on the 64-point
// tile (resnetfc_fwd.cu), with 128 KB slots.
//
// Input rows are where the model's query leaves them, object-major: point b
// of object s, view v is row (s NS + v) B_obj + b, and its output column is
// s B_obj + b.  The gather's idx/w rows are view-major (SB = 1, the same
// formula) and view v reads table v.
//
// Deferred positional code (the CODE variant of load_inputs, the port of
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
#include <mma.h>
#include <stdint.h>

namespace rfc {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 32;  // points per CTA: two 16-row wmma tiles
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int STAGES = 4;  // cp.async ring depth for weight slabs
constexpr int PAD = 8;     // bf16 elements of row padding (16 bytes)
// Hidden width: every config in conf/ uses d_hidden 512.  Each warp owns
// J = HID / (16 * NWARPS) = 4 column tiles of every layer.
constexpr int HID = 512;
constexpr int J = HID / (16 * NWARPS);
// f32 words of one CTA's view-sum slot: a thread's 2 x J accumulator
// fragments of 8 elements each, for every thread (64 KB)
constexpr int SLOT_FLOATS = 2 * J * 8 * NTHREADS;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct TowerParams {
  const bf16* z;       // (NS B, C) dense latent (the tile kernels); unused by the gather kernels
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

// Shared-memory layout, in bytes from the base; every offset is a multiple
// of 128 for the widths the wrappers admit (C and kin multiples of 16).
struct Layout {
  int lda, ldz, ldx, sld;  // row strides in elements
  size_t act, hb, zb, xin, stg, wst, total;
};

__host__ __device__ inline Layout layout(int C, int kin, int n_lin_z) {
  Layout L;
  L.lda = HID + PAD;
  L.ldz = C + PAD;
  L.ldx = kin + PAD;
  L.sld = J * 16 + PAD;
  L.act = 0;
  L.hb = L.act + (size_t)BM * L.lda * sizeof(bf16);
  L.zb = L.hb + (size_t)BM * L.lda * sizeof(bf16);
  L.xin = L.zb + (n_lin_z > 0 ? (size_t)BM * L.ldz * sizeof(bf16) : 0);
  L.stg = L.xin + (size_t)BM * L.ldx * sizeof(bf16);
  L.wst = L.stg + (size_t)NWARPS * 256 * sizeof(float);
  L.total = L.wst + (size_t)NWARPS * STAGES * 16 * L.sld * sizeof(bf16);
  return L;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One 16-row slab of W (rows k..k+15, columns col0..col0+16J) into a warp's
// staging buffer, as 16-byte copies.
__device__ __forceinline__ void stage_w(bf16* dst, int sld, const bf16* W, int N, int k, int col0) {
  constexpr int CPR = J * 2;  // 16-byte chunks per row
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, q = c - r * CPR;
    cp_async16(dst + r * sld + q * 8, W + (size_t)(k + r) * N + col0 + q * 8);
  }
}

// acc[h][j] = A[16h.., K] @ W[K, col0 + 16j ..] for this warp's J column
// tiles.  A is bf16 in shared memory (row stride lda), W bf16 row-major in
// global memory, streamed through the warp's STAGES-deep cp.async ring.
__device__ __forceinline__ void warp_gemm(FragC (&acc)[2][J], const bf16* A, int lda, int K,
                                          const bf16* W, int N, int col0, bf16* ring, int sld) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    wmma::fill_fragment(acc[0][j], 0.0f);
    wmma::fill_fragment(acc[1][j], 0.0f);
  }
  const int nk = K / 16;
  const int slab = 16 * sld;
  auto stage = [&](int s, int ks) { stage_w(ring + s * slab, sld, W, N, ks * 16, col0); };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s, s);
    cp_async_commit();
  }
  for (int ks = 0; ks < nk; ++ks) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of slab ks have landed
    __syncwarp();                 // ... and every lane's; slab ks-1 is no longer read
    const int pre = ks + STAGES - 1;
    if (pre < nk) stage(pre % STAGES, pre);
    cp_async_commit();
    const bf16* Bs = ring + (ks % STAGES) * slab;
    FragA a0, a1;
    wmma::load_matrix_sync(a0, A + ks * 16, lda);
    wmma::load_matrix_sync(a1, A + 16 * lda + ks * 16, lda);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      FragB b;
      wmma::load_matrix_sync(b, Bs + j * 16, sld);
      wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
      wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
    }
  }
  cp_async_wait<0>();
  __syncwarp();
}

// bias[col..col+16] broadcast over 16 rows, in accumulator layout.
__device__ __forceinline__ void bias_frag(FragC& b, const float* bias, int col, float* stg) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = lane; e < 256; e += 32) stg[e] = bias[col + (e & 15)];
  __syncwarp();
  wmma::load_matrix_sync(b, stg, 16, wmma::mem_row_major);
  __syncwarp();
}

// dst[16h + r][col + c] = bf16(relu(f)) for one 16x16 fragment.
__device__ __forceinline__ void emit_relu(bf16* dst, int ld, int h, int col, const FragC& f,
                                          float* stg) {
  const int lane = threadIdx.x & 31;
  wmma::store_matrix_sync(stg, f, 16, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 256; e += 32)
    dst[(16 * h + (e >> 4)) * ld + col + (e & 15)] = __float2bfloat16_rn(fmaxf(stg[e], 0.0f));
  __syncwarp();
}

// x (+)= acc + bias over the warp's fragments; emit bf16(relu(x)) into act.
__device__ __forceinline__ void residual(FragC (&x)[2][J], const FragC (&acc)[2][J],
                                         const float* bias, int col0, bool init, bf16* act,
                                         int lda, bool emit, float* stg) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    FragC b;
    bias_frag(b, bias, col0 + 16 * j, stg);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < b.num_elements; ++i) {
        const float v = acc[h][j].x[i] + b.x[i];
        x[h][j].x[i] = init ? v : x[h][j].x[i] + v;
      }
      if (emit) emit_relu(act, lda, h, col0 + 16 * j, x[h][j], stg);
    }
  }
}

struct Smem {
  bf16 *act, *hb, *zb, *xin, *ring;
  float* stg;
};

__device__ __forceinline__ Smem carve(unsigned char* base, const Layout& L) {
  const int warp = threadIdx.x >> 5;
  Smem s;
  s.act = reinterpret_cast<bf16*>(base + L.act);  // relu(x) operand (BM, H)
  s.hb = reinterpret_cast<bf16*>(base + L.hb);    // relu(fc_0) operand (BM, H)
  s.zb = reinterpret_cast<bf16*>(base + L.zb);    // latent (BM, C)
  s.xin = reinterpret_cast<bf16*>(base + L.xin);  // code (BM, kin)
  s.stg = reinterpret_cast<float*>(base + L.stg) + warp * 256;
  s.ring = reinterpret_cast<bf16*>(base + L.wst) + (size_t)warp * STAGES * 16 * L.sld;
  return s;
}

// The tile's code and latent of view v into shared memory (zeros past B):
// the latent z[i] = sum_{j<4} w[i,j] * table_v[idx[i,j]] as a real 4-tap
// read of the (T, C) bf16 table of view v, summed in f32 and rounded to bf16.
// The CODE variant evaluates the positional code of the raw coordinates (see
// the head of this file); a raw row (24 bytes at sn64) is not 16-byte
// aligned, so it is read with scalar loads.
template <bool CODE>
__device__ __forceinline__ void load_inputs(const TowerParams& p, const Layout& L, const Smem& s,
                                            int row0, int view) {
  const int tid = threadIdx.x, C = p.C, kin = p.kin;
  for (int e = tid; e < BM * kin; e += NTHREADS) {
    const int r = e / kin, c = e - r * kin, g = row0 + r;
    float v;
    if (CODE) {
      v = 0.0f;
      if (g < p.B && c < p.d_in) {
        const float* raw = p.x + src_row(p, g, view) * p.d_raw;
        float xg = __ldg(raw) * __ldg(p.code_w + c);
        for (int j = 1; j < p.d_raw; ++j) xg += __ldg(raw + j) * __ldg(p.code_w + j * p.d_in + c);
        v = __ldg(p.code_m + c) > 0.0f ? sinf(xg * __ldg(p.code_f + c) + __ldg(p.code_p + c)) : xg;
      }
    } else {
      v = (g < p.B && c < p.d_in) ? p.x[src_row(p, g, view) * p.d_in + c] : 0.0f;
    }
    s.xin[r * L.ldx + c] = __float2bfloat16_rn(v);
  }
  if (p.n_lin_z > 0) {
    const int nq = C / 8;  // 16-byte chunks of eight channels per row
    const bf16* table = p.table + (size_t)view * p.T * C;
    for (int t = tid; t < BM * nq; t += NTHREADS) {
      const int r = t / nq, q = t - r * nq, g = row0 + r;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (g < p.B) {
        const size_t row = src_row(p, g, view);
        float acc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[u] = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ri = p.idx[row * p.taps + j];
          const float wj = p.w[row * p.taps + j];
          if (ri >= 0 && ri < p.T) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(table + (size_t)ri * C) + q);
            const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[2 * u] = fmaf(wj, bf16_lo(words[u]), acc[2 * u]);
              acc[2 * u + 1] = fmaf(wj, bf16_hi(words[u]), acc[2 * u + 1]);
            }
          }
        }
        packed.x = pack_bf16x2(acc[0], acc[1]);
        packed.y = pack_bf16x2(acc[2], acc[3]);
        packed.z = pack_bf16x2(acc[4], acc[5]);
        packed.w = pack_bf16x2(acc[6], acc[7]);
      }
      *reinterpret_cast<uint4*>(s.zb + r * L.ldz + q * 8) = packed;
    }
  }
}

// lin_in: x = code W_in + b_in; with emit, also bf16(relu(x)) into s.act
// (block 0 reads it directly when no latent is injected).
__device__ __forceinline__ void tower_in(const TowerParams& p, const Layout& L, const Smem& s,
                                         FragC (&x)[2][J], FragC (&acc)[2][J], bool emit) {
  const int col0 = (threadIdx.x >> 5) * J * 16;  // this warp's output columns
  warp_gemm(acc, s.xin, L.ldx, p.kin, p.w_in, HID, col0, s.ring, L.sld);
  residual(x, acc, p.b_in, col0, true, s.act, L.lda, emit, s.stg);
  __syncthreads();
}

// Residual blocks k0 <= k < k1 on the f32 stream x.  After the last one
// s.act holds bf16(relu(x)) only with emit_end.
__device__ __forceinline__ void tower_blocks(const TowerParams& p, const Layout& L, const Smem& s,
                                             FragC (&x)[2][J], FragC (&acc)[2][J], int k0, int k1,
                                             bool emit_end) {
  constexpr int H = HID;
  const int C = p.C;
  const int col0 = (threadIdx.x >> 5) * J * 16;  // this warp's output columns
  for (int k = k0; k < k1; ++k) {
    if (k < p.n_lin_z) {
      warp_gemm(acc, s.zb, L.ldz, C, p.w_z + (size_t)k * C * H, H, col0, s.ring, L.sld);
      residual(x, acc, p.b_z + (size_t)k * H, col0, false, s.act, L.lda, true, s.stg);
      __syncthreads();  // act complete before fc_0 reads it
    }
    const bf16* w0 = p.w_blk + (size_t)(2 * k) * H * H;
    const float* b0 = p.b_blk + (size_t)(2 * k) * H;
    warp_gemm(acc, s.act, L.lda, H, w0, H, col0, s.ring, L.sld);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      FragC b;
      bias_frag(b, b0, col0 + 16 * j, s.stg);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < b.num_elements; ++i) acc[h][j].x[i] += b.x[i];
        emit_relu(s.hb, L.lda, h, col0 + 16 * j, acc[h][j], s.stg);
      }
    }
    __syncthreads();  // hb complete before fc_1 reads it
    warp_gemm(acc, s.hb, L.lda, H, w0 + (size_t)H * H, H, col0, s.ring, L.sld);
    // the next consumer of relu(x) is fc_0 of block k+1 (or lin_out) unless
    // block k+1 injects the latent first, or the view mean comes next
    residual(x, acc, b0 + H, col0, false, s.act, L.lda,
             k + 1 >= p.n_lin_z && (k + 1 < k1 || emit_end), s.stg);
    __syncthreads();
  }
}

// Element i of fragment (h, j) of this thread, in a CTA's 64 KB slot: each
// thread touches only its own elements, and neighbouring threads neighbouring
// words.
__device__ __forceinline__ float* slot_at(float* slot, int h, int j, int i) {
  return slot + ((h * J + j) * FragC::num_elements + i) * NTHREADS + threadIdx.x;
}

// Fold view v's residual x into the view sum held in `slot`: sum = x_0, then
// sum + x_v in view order; at the last view x becomes sum * (1 / NS), the
// TPU kernel's sum(xs) * (1.0 / NS).
__device__ __forceinline__ void fold_view(FragC (&x)[2][J], float* slot, int v, int NS) {
  static_assert(FragC::num_elements == 8, "SLOT_FLOATS assumes 8 accumulator elements a thread");
  const float inv = 1.0f / (float)NS;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < FragC::num_elements; ++i) {
        float* a = slot_at(slot, h, j, i);
        if (v == 0) {
          *a = x[h][j].x[i];
        } else {
          const float sum = *a + x[h][j].x[i];
          if (v + 1 < NS)
            *a = sum;
          else
            x[h][j].x[i] = sum * inv;
        }
      }
}

// bf16(relu(x)) into s.act over the warp's fragments, for the blocks after
// the view mean.
__device__ __forceinline__ void emit_stream(const Layout& L, const Smem& s, const FragC (&x)[2][J]) {
  const int col0 = (threadIdx.x >> 5) * J * 16;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) emit_relu(s.act, L.lda, h, col0 + 16 * j, x[h][j], s.stg);
  __syncthreads();
}

// The multi-view tower on tile row0 (one object x NS views): every view's
// lin_in and blocks k < pre, folded into the mean, then the shared blocks.
// On return s.act holds t.
template <bool CODE>
__device__ __forceinline__ void tower_mv(const TowerParams& p, const Layout& L, const Smem& s,
                                         FragC (&x)[2][J], FragC (&acc)[2][J], int row0,
                                         float* slot) {
  for (int v = 0; v < p.NS; ++v) {
    load_inputs<CODE>(p, L, s, row0, v);
    __syncthreads();
    tower_in(p, L, s, x, acc, p.n_lin_z == 0 && p.pre > 0);
    tower_blocks(p, L, s, x, acc, 0, p.pre, false);
    fold_view(x, slot, v, p.NS);
  }
  emit_stream(L, s, x);
  tower_blocks(p, L, s, x, acc, p.pre, p.n_blocks, true);
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

}  // namespace rfc

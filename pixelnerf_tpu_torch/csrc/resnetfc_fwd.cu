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
// The tower and its numerics contract live in resnetfc_tower.cuh, which the
// backward's recompute (resnetfc_bwd.cu) shares, and so does the multi-view
// design (the per-view branches, the view sum in a per-CTA device-memory
// slot, the persistent grid).  The gather entry points first build
// z[i] = sum_{j<4} w[i,j] * table[idx[i,j]] as a real 4-tap read of the (T, C)
// bf16 table of the point's view (L2-resident at T*C*2 = 1 MB a view for
// sn64), sum in f32 and round to bf16 into shared memory.  The TPU kernel
// builds the same lookup as a one-hot matmul and so rounds the tap weights to
// bf16; here they stay f32, a difference the on-card tolerance covers.  An
// index outside [0, T) contributes nothing, as a one-hot row would.
//
// What bounds it: ~6.86 MFLOP per point at sn64 widths (H=512, 5 blocks,
// 3 latent injections), and NS = 3 views ~16.4 MFLOP per output point,
// against ~0.1 KB of input per point and view, so the tower is bound by
// tensor-core operations, not device memory.  This version keeps to
// nvcuda::wmma 16x16x16 bf16 products, one CTA of 8 warps per 32-point tile
// (resnetfc_tower.cuh).  Every CTA still re-reads all weights from L2 for 32
// points (NS times for the per-view blocks); larger point tiles with wgmma
// and TMA are the next step.  The ragged last tile is masked in-kernel.

#include "resnetfc_tower.cuh"

namespace {

using namespace rfc;

template <bool GATHER, bool MV, bool CODE>
__global__ void __launch_bounds__(NTHREADS, 1) resnetfc_fwd_kernel(const TowerParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout L = layout(p.C, p.kin, p.n_lin_z, false);
  const Smem s = carve(smem_raw, L);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (p.B + BM - 1) / BM;
  float* slot = MV ? p.vsum + (size_t)blockIdx.x * SLOT_FLOATS : nullptr;

  // single view: one tile per CTA; multi-view: persistent CTAs, one view-sum
  // slot each
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * BM;
    FragC x[2][J], acc[2][J];
    if (MV) {
      tower_mv<GATHER, false, CODE>(p, L, s, x, acc, row0, slot, nullptr, nullptr, nullptr, 0);
    } else {
      load_inputs<GATHER, CODE>(p, L, s, row0, 0);
      __syncthreads();
      tower<false>(p, L, s, x, acc, row0, nullptr, 0);
    }

    // lin_out is only d_out (4) wide: one warp per (point, channel) dot product
    for (int pc = warp; pc < BM * p.d_out; pc += NWARPS) {
      const int r = pc / p.d_out, c = pc - r * p.d_out, g = row0 + r;
      float acc_o = 0.0f;
      for (int kk = lane; kk < HID; kk += 32)
        acc_o = fmaf(__bfloat162float(s.act[r * L.lda + kk]),
                     __bfloat162float(p.w_out[(size_t)kk * p.d_out + c]), acc_o);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc_o += __shfl_xor_sync(0xffffffffu, acc_o, off);
      if (lane == 0 && g < p.B) {
        const float v = acc_o + p.b_out[c];
        if (p.planar)
          p.out[(size_t)c * p.B + g] = v;
        else
          p.out[(size_t)g * p.d_out + c] = v;
      }
    }
    __syncthreads();  // s.act is read before the next tile rewrites it
  }
}

template <bool GATHER, bool MV, bool CODE>
int launch_variant(const TowerParams& p, int n_ctas, cudaStream_t stream) {
  const size_t smem = layout(p.C, p.kin, p.n_lin_z, false).total;
  cudaError_t err = cudaFuncSetAttribute(resnetfc_fwd_kernel<GATHER, MV, CODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (p.B + BM - 1) / BM;
  const int grid = MV && n_ctas < n_tiles ? n_ctas : n_tiles;
  resnetfc_fwd_kernel<GATHER, MV, CODE><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Validate, attach the code operands (code_w null: x is the encoded code)
// and launch the matching variant.
template <bool GATHER, bool MV>
int launch(TowerParams& p, int H, int n_ctas, const void* code_w, const void* code_f,
           const void* code_p, const void* code_m, int d_raw, cudaStream_t stream) {
  if (H != HID) return (int)cudaErrorInvalidValue;
  if (MV && (p.NS < 2 || p.pre < 0 || p.pre >= p.n_blocks || p.n_lin_z > p.pre ||
             p.B_obj < 1 || p.B % p.B_obj != 0 || p.vsum == nullptr || n_ctas < 1))
    return (int)cudaErrorInvalidValue;
  if (code_w == nullptr) return launch_variant<GATHER, MV, false>(p, n_ctas, stream);
  if (code_f == nullptr || code_p == nullptr || code_m == nullptr || d_raw < 1)
    return (int)cudaErrorInvalidValue;
  p.code_w = static_cast<const float*>(code_w);
  p.code_f = static_cast<const float*>(code_f);
  p.code_p = static_cast<const float*>(code_p);
  p.code_m = static_cast<const float*>(code_m);
  p.d_raw = d_raw;
  return launch_variant<GATHER, MV, true>(p, n_ctas, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs at these widths (H = 512).
size_t resnetfc_fwd_smem_bytes(int C, int kin, int n_lin_z) {
  return layout(C, kin, n_lin_z, false).total;
}

const char* resnetfc_fwd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// f32 words of one CTA's view-sum slot (the multi-view kernels' vsum).
int resnetfc_fwd_slot_floats() { return SLOT_FLOATS; }

int resnetfc_fwd_dense(const void* z, const void* x, const void* w_in, const void* b_in,
                       const void* w_z, const void* b_z, const void* w_blk, const void* b_blk,
                       const void* w_out, const void* b_out, void* out, int B, int d_in, int kin,
                       int H, int C, int n_blocks, int n_lin_z, int d_out, int planar,
                       const void* code_w, const void* code_f, const void* code_p,
                       const void* code_m, int d_raw, void* stream) {
  TowerParams p = tower_params(x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, B, d_in, kin,
                               C, n_blocks, n_lin_z, d_out);
  p.out = static_cast<float*>(out);
  p.planar = planar;
  p.z = static_cast<const bf16*>(z);
  return launch<false, false>(p, H, 0, code_w, code_f, code_p, code_m, d_raw,
                              static_cast<cudaStream_t>(stream));
}

int resnetfc_fwd_gather(const void* idx, const void* w, int taps, const void* table, int T,
                        const void* x, const void* w_in, const void* b_in, const void* w_z,
                        const void* b_z, const void* w_blk, const void* b_blk, const void* w_out,
                        const void* b_out, void* out, int B, int d_in, int kin, int H, int C,
                        int n_blocks, int n_lin_z, int d_out, int planar, const void* code_w,
                        const void* code_f, const void* code_p, const void* code_m, int d_raw,
                        void* stream) {
  TowerParams p = tower_params(x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, B, d_in, kin,
                               C, n_blocks, n_lin_z, d_out);
  p.out = static_cast<float*>(out);
  p.planar = planar;
  p.idx = static_cast<const int*>(idx);
  p.w = static_cast<const float*>(w);
  p.table = static_cast<const bf16*>(table);
  p.T = T;
  p.taps = taps;
  return launch<true, false>(p, H, 0, code_w, code_f, code_p, code_m, d_raw,
                             static_cast<cudaStream_t>(stream));
}

// Multi-view: B = SB B_obj output points, NS views of each as object-major
// input rows; the first `pre` blocks run per view, the rest on their mean.
// vsum holds n_ctas slots of SLOT_FLOATS f32; the grid is at most n_ctas.
int resnetfc_fwd_dense_mv(const void* z, const void* x, const void* w_in, const void* b_in,
                          const void* w_z, const void* b_z, const void* w_blk, const void* b_blk,
                          const void* w_out, const void* b_out, void* out, int B, int d_in,
                          int kin, int H, int C, int n_blocks, int n_lin_z, int d_out, int planar,
                          int NS, int B_obj, int pre, void* vsum, int n_ctas,
                          const void* code_w, const void* code_f, const void* code_p,
                          const void* code_m, int d_raw, void* stream) {
  TowerParams p = tower_params(x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, B, d_in, kin,
                               C, n_blocks, n_lin_z, d_out);
  p.out = static_cast<float*>(out);
  p.planar = planar;
  p.z = static_cast<const bf16*>(z);
  p.NS = NS;
  p.B_obj = B_obj;
  p.pre = pre;
  p.vsum = static_cast<float*>(vsum);
  return launch<false, true>(p, H, n_ctas, code_w, code_f, code_p, code_m, d_raw,
                             static_cast<cudaStream_t>(stream));
}

// Multi-view fused gather, one object (B_obj = B): idx/w rows view-major,
// table (NS, T, C), view v reading table v.
int resnetfc_fwd_gather_mv(const void* idx, const void* w, int taps, const void* table, int T,
                           const void* x, const void* w_in, const void* b_in, const void* w_z,
                           const void* b_z, const void* w_blk, const void* b_blk,
                           const void* w_out, const void* b_out, void* out, int B, int d_in,
                           int kin, int H, int C, int n_blocks, int n_lin_z, int d_out, int planar,
                           int NS, int B_obj, int pre, void* vsum, int n_ctas,
                          const void* code_w, const void* code_f, const void* code_p,
                          const void* code_m, int d_raw, void* stream) {
  TowerParams p = tower_params(x, w_in, b_in, w_z, b_z, w_blk, b_blk, w_out, b_out, B, d_in, kin,
                               C, n_blocks, n_lin_z, d_out);
  p.out = static_cast<float*>(out);
  p.planar = planar;
  p.idx = static_cast<const int*>(idx);
  p.w = static_cast<const float*>(w);
  p.table = static_cast<const bf16*>(table);
  p.T = T;
  p.taps = taps;
  p.NS = NS;
  p.B_obj = B_obj;
  p.pre = pre;
  p.vsum = static_cast<float*>(vsum);
  if (B_obj != B) return (int)cudaErrorInvalidValue;
  return launch<true, true>(p, H, n_ctas, code_w, code_f, code_p, code_m, d_raw,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"

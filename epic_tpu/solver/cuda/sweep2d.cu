// Temporally blocked red-black log-space sweeps for 2D grids, called from
// JAX through the foreign function interface (solver/cuda_sweep.py).
//
// One launch runs up to K sweeps. Each block owns a TH x TW tile of the
// grid and loads it with a K-deep halo of u (f32) and the frozen mask
// (locked cells and the boundary ring) into shared memory. It then sweeps
// in place: a cell's four neighbours always have the other colour, so
// updating one colour while reading the other is race-free, and a
// __syncthreads() separates the sweeps. The region a block can trust
// shrinks by one cell per sweep, so after at most K sweeps its own tile is
// exact and it writes only that tile back. Launches with more than one
// sweep read one buffer and write another (the caller chains them); a
// one-sweep launch may update its buffer in place.
//
// The update rule and its operation order are solver.core's
// _neighbor_logsumexp: the max over (N, S, W, E), a left-to-right sum of
// the shifted exponentials, log, add the max, subtract log(2n). The parity
// comes from the global iteration as in core.sweep: a 2D sweep at
// iteration t updates the cells with (y + x + t) odd.
//
// The first sweep's max |delta| over each block's own tile is reduced in
// shared memory to one value per block, and a second one-block pass takes
// the max over blocks (the two-stage reduction of the reference's
// harmonic_gpu.cu). It stays on the device.
//
// Build (sm_90a, for Hopper):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libepic_sweep2d.so
//        sweep2d.cu
// solver/cuda_sweep.py runs this at first use.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kObstacle = -1.0e6f;  // constants.LOG_SPACE_OBSTACLE
constexpr int kReduceThreads = 256;

template <int TH, int TW, int K, int NT>
__global__ void __launch_bounds__(NT)
    sweep_tile(const float* src, float* dst, const bool* __restrict__ locked,
               const int32_t* __restrict__ iteration, int it_offset, int H,
               int W, int nsweeps, float log2n, float* __restrict__ partials) {
  constexpr int EH = TH + 2 * K;
  constexpr int EW = TW + 2 * K;
  extern __shared__ float smem[];
  float* su = smem;                 // EH * EW values
  float* sred = smem + EH * EW;     // NT partial maxima
  unsigned char* sf = reinterpret_cast<unsigned char*>(sred + NT);  // EH * EW

  const int tid = threadIdx.x;
  const int y0 = static_cast<int>(blockIdx.y) * TH - K;  // grid row of ext row 0
  const int x0 = static_cast<int>(blockIdx.x) * TW - K;
  const int t0 = *iteration + it_offset;

  for (int i = tid; i < EH * EW; i += NT) {
    const int r = i / EW;
    const int c = i - r * EW;
    const int gy = y0 + r;
    const int gx = x0 + c;
    float v = kObstacle;
    unsigned char f = 1;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t g = static_cast<size_t>(gy) * W + gx;
      v = src[g];
      f = locked[g] || gy == 0 || gy == H - 1 || gx == 0 || gx == W - 1;
    }
    su[i] = v;
    sf[i] = f;
  }
  __syncthreads();

  float dmax = 0.0f;
  for (int s = 0; s < nsweeps; ++s) {
    const int t = t0 + s;
    const int r0 = s + 1;
    const int r1 = EH - 1 - s;
    const int c0 = s + 1;
    const int c1 = EW - 1 - s;
    const int half = (c1 - c0 + 1) / 2;  // cells of one colour per row, at most
    const int total = (r1 - r0) * half;
    for (int i = tid; i < total; i += NT) {
      const int rr = i / half;
      const int r = r0 + rr;
      // First column of this row whose (y + x + t) is odd.
      const int c = c0 + ((y0 + r + x0 + c0 + t + 1) & 1) + 2 * (i - rr * half);
      if (c >= c1) continue;
      const int k = r * EW + c;
      if (sf[k]) continue;
      const float n0 = su[k - EW];
      const float n1 = su[k + EW];
      const float n2 = su[k - 1];
      const float n3 = su[k + 1];
      const float m = fmaxf(fmaxf(fmaxf(n0, n1), n2), n3);
      float acc = expf(n0 - m);
      acc = acc + expf(n1 - m);
      acc = acc + expf(n2 - m);
      acc = acc + expf(n3 - m);
      const float v = (m + logf(acc)) - log2n;
      if (s == 0 && r >= K && r < K + TH && c >= K && c < K + TW) {
        dmax = fmaxf(dmax, fabsf(v - su[k]));
      }
      su[k] = v;
    }
    __syncthreads();
  }

  for (int i = tid; i < TH * TW; i += NT) {
    const int r = i / TW;
    const int c = i - r * TW;
    const int gy = y0 + K + r;
    const int gx = x0 + K + c;
    if (gy < H && gx < W) {
      dst[static_cast<size_t>(gy) * W + gx] = su[(r + K) * EW + c + K];
    }
  }

  if (partials != nullptr) {
    sred[tid] = dmax;
    __syncthreads();
    for (int w = NT / 2; w > 0; w >>= 1) {
      if (tid < w) sred[tid] = fmaxf(sred[tid], sred[tid + w]);
      __syncthreads();
    }
    if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = sred[0];
  }
}

__global__ void __launch_bounds__(kReduceThreads)
    reduce_max(const float* __restrict__ partials, int n, float* out) {
  __shared__ float s[kReduceThreads];
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) m = fmaxf(m, partials[i]);
  s[threadIdx.x] = m;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w) s[threadIdx.x] = fmaxf(s[threadIdx.x], s[threadIdx.x + w]);
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

template <int TH, int TW, int K, int NT>
cudaError_t launch(cudaStream_t stream, const float* src, float* dst,
                   const bool* locked, const int32_t* iteration, int it_offset,
                   int H, int W, int nsweeps, float log2n, float* partials) {
  constexpr size_t kSmem = (TH + 2 * K) * (TW + 2 * K) * (sizeof(float) + 1) +
                           NT * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      sweep_tile<TH, TW, K, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  sweep_tile<TH, TW, K, NT><<<grid, NT, kSmem, stream>>>(
      src, dst, locked, iteration, it_offset, H, W, nsweeps, log2n, partials);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(cudaStream_t, const float*, float*,
                                 const bool*, const int32_t*, int, int, int,
                                 int, float, float*);

struct Variant {
  int th, tw, k, nt;
  LaunchFn fn;
};

// Keep in step with cuda_sweep.GEOMETRIES.
constexpr Variant kVariants[] = {
    {32, 32, 8, 256, launch<32, 32, 8, 256>},
    {64, 128, 16, 512, launch<64, 128, 16, 512>},
};

ffi::Error SweepImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> u,
                     ffi::Buffer<ffi::PRED> locked,
                     ffi::Buffer<ffi::S32> iteration,
                     ffi::ResultBuffer<ffi::F32> out,
                     ffi::ResultBuffer<ffi::F32> delta,
                     ffi::ResultBuffer<ffi::F32> partials, int32_t nsweeps,
                     int32_t it_offset, int32_t tile_h, int32_t tile_w,
                     int32_t depth, int32_t threads, int32_t with_delta,
                     float log2n) {
  const auto dims = u.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("u must be 2D");
  const int H = static_cast<int>(dims[0]);
  const int W = static_cast<int>(dims[1]);
  const float* src = u.typed_data();
  float* dst = out->typed_data();
  if (nsweeps < 1 || nsweeps > depth) {
    return ffi::Error::InvalidArgument("nsweeps must be in [1, depth]");
  }
  if (nsweeps > 1 && src == dst) {
    return ffi::Error::InvalidArgument(
        "a multi-sweep launch needs distinct input and output buffers");
  }
  const Variant* var = nullptr;
  for (const Variant& v : kVariants) {
    if (v.th == tile_h && v.tw == tile_w && v.k == depth && v.nt == threads) {
      var = &v;
    }
  }
  if (var == nullptr) return ffi::Error::InvalidArgument("unknown tile geometry");
  const int blocks = ((H + tile_h - 1) / tile_h) * ((W + tile_w - 1) / tile_w);
  if (with_delta && partials->element_count() < static_cast<size_t>(blocks)) {
    return ffi::Error::InvalidArgument("partials buffer too small");
  }
  float* part = with_delta ? partials->typed_data() : nullptr;
  cudaError_t err = var->fn(stream, src, dst, locked.typed_data(),
                            iteration.typed_data(), it_offset, H, W, nsweeps,
                            log2n, part);
  if (err == cudaSuccess && with_delta) {
    reduce_max<<<1, kReduceThreads, 0, stream>>>(part, blocks,
                                                 delta->typed_data());
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(EpicSweep2d, SweepImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()   // u
                                  .Arg<ffi::Buffer<ffi::PRED>>()  // locked
                                  .Arg<ffi::Buffer<ffi::S32>>()   // iteration
                                  .Ret<ffi::Buffer<ffi::F32>>()   // u'
                                  .Ret<ffi::Buffer<ffi::F32>>()   // delta
                                  .Ret<ffi::Buffer<ffi::F32>>()   // partials
                                  .Attr<int32_t>("nsweeps")
                                  .Attr<int32_t>("it_offset")
                                  .Attr<int32_t>("tile_h")
                                  .Attr<int32_t>("tile_w")
                                  .Attr<int32_t>("depth")
                                  .Attr<int32_t>("threads")
                                  .Attr<int32_t>("with_delta")
                                  .Attr<float>("log2n"));

// Faithful bf16x2 split of an fp32 tensor: hi = bf16(x), lo = bf16(x - hi).
//
// Replaces the TPU kernel `_split_kernel_body` / `_split_bf16x2`
// (spotify_recommender_tpu/ops/pallas/fused_topk.py:237, :244).  On the TPU
// the split had to live inside a kernel because XLA demoted the fp32
// subtraction to bf16 and zeroed the lo plane.  Here it is a kernel because
// the port hand-writes every kernel on the certified path; the arithmetic is
// the same:
//
//   hi = __float2bfloat16_rn(x)                 round to nearest even
//   lo = __float2bfloat16_rn(x - float(hi))     the fp32 subtraction is exact
//
// Built without --use_fast_math: flush-to-zero would flush tiny unit-vector
// components, and the certificate's bound (fused_topk.py BF16X2_EPS) assumes
// round-to-nearest.  The result is bitwise equal to the plain torch version
// `hi = x.to(bfloat16); lo = (x - hi.float()).to(bfloat16)` for finite x.
//
// What bounds it on an H100: memory.  Each element reads 4 bytes and writes
// 4; on the certified path the input is the (B, F) unit-query matrix, a few
// tens of KB, so the launch itself dominates.  Design: one thread per
// element over a grid-stride loop; no shared memory, nothing to reuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void split_bf16x2_kernel(const float* __restrict__ x,
                                    __nv_bfloat16* __restrict__ hi,
                                    __nv_bfloat16* __restrict__ lo,
                                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float v = x[i];
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

}  // namespace

extern "C" int srt_split_bf16x2(const void* x, void* hi, void* lo, int64_t n,
                                void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int64_t want = (n + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 65536 ? want : 65536);
    split_bf16x2_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<__nv_bfloat16*>(hi),
        static_cast<__nv_bfloat16*>(lo), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

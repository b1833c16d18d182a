// Kernel 2: the faithful bf16x2 split, in two entry points.
//
// srt_query_prologue: the serving paths' query prologue in one launch.
//   Replaces the TPU kernel `_split_kernel_body` / `_split_bf16x2`
//   (spotify_recommender_tpu/ops/pallas/fused_topk.py:237, :244) together
//   with the XLA ops around its query calls: the normalization and the
//   concatenations at fused_topk.py:450, :704 and :1451.  From raw fp32
//   queries q (B, F) and their norms qn (B,) it writes the scan's operand
//   q2 (B, 4F) bf16:
//
//     u  = q / max(qn, 1e-30)            IEEE round-to-nearest division
//     hi = __float2bfloat16_rn(u)        round to nearest even
//     lo = __float2bfloat16_rn(u - float(hi))   the subtraction is exact
//     q2[b] = [hi, lo, lo, hi]           against the catalog's [hi; lo]:
//                                        qh·hi + ql·lo + ql·hi + qh·lo
//
//   The max is a compare, not fmaxf: a NaN norm propagates as it does
//   through torch.clamp_min and jnp.maximum.
//
// srt_split_bf16x2: hi = bf16(x), lo = bf16(x - hi) of any fp32 tensor; the
//   sharded catalog's device layout build splits its unit rows with it.
//
// On the TPU the split had to live inside a kernel because XLA demoted the
// fp32 subtraction to bf16 and zeroed the lo plane; the card has no such
// constraint, so here the kernel takes the whole prologue.
//
// Built without --use_fast_math: flush-to-zero would flush subnormal lo
// values of tiny unit-vector components, and the certificate's bound
// (ops/fused_topk.BF16X2_EPS) assumes round-to-nearest.  Both entry points
// are bitwise equal to their plain torch versions (ops/cuda/split.py).
//
// What bounds it on an H100: bytes, B·F·4 + B·4 read and B·4F·2 written,
// about 0.15 MB at 1024 x 12 (4.5e-5 ms at 3.35 TB/s).  What keeps it from
// that bound is its launch: the design's point is one launch and one
// allocation (q2) where the prologue took four ops and three allocations
// (division, split, concatenation).  One thread per (query, feature), each
// writing its four bf16 outputs; no shared memory, nothing to reuse.

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

__global__ void query_prologue_kernel(const float* __restrict__ q,
                                      const float* __restrict__ qn,
                                      __nv_bfloat16* __restrict__ q2,
                                      int64_t n, int64_t f) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t b = i / f;
    const int64_t j = i - b * f;
    const float d = qn[b];
    const float m = d < 1e-30f ? 1e-30f : d;   // NaN stays NaN
    const float u = __fdiv_rn(q[i], m);
    const __nv_bfloat16 h = __float2bfloat16_rn(u);
    const __nv_bfloat16 l = __float2bfloat16_rn(u - __bfloat162float(h));
    __nv_bfloat16* row = q2 + b * 4 * f;
    row[j] = h;
    row[f + j] = l;
    row[2 * f + j] = l;
    row[3 * f + j] = h;
  }
}

int blocks_for(int64_t n, int threads) {
  const int64_t want = (n + threads - 1) / threads;
  return static_cast<int>(want < 65536 ? want : 65536);
}

}  // namespace

extern "C" int srt_split_bf16x2(const void* x, void* hi, void* lo, int64_t n,
                                void* stream) {
  if (n > 0) {
    const int threads = 256;
    split_bf16x2_kernel<<<blocks_for(n, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<__nv_bfloat16*>(hi),
        static_cast<__nv_bfloat16*>(lo), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_query_prologue(const void* q, const void* qn, void* q2,
                                  int64_t b, int64_t f, void* stream) {
  const int64_t n = b * f;
  if (n > 0) {
    const int threads = 256;
    query_prologue_kernel<<<blocks_for(n, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(qn),
        static_cast<__nv_bfloat16*>(q2), n, f);
  }
  return static_cast<int>(cudaGetLastError());
}

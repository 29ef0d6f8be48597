// Re-identification matcher for Hopper (sm_90a): per gallery row, the best
// cosine score over the first `nq` query rows, the index of that query, and
// whether the score reaches the threshold.
//
// Replaces the TPU kernel `reid_match_pallas`
// (src/repro/kernels/reid_match/kernel.py, body `_kernel`): per gallery tile
// it L2-normalises each row with max(||g||, 1e-6), takes the f32 dot
// product with every pre-normalised query row, and keeps the maximum score,
// the first query index that attains it (argmax order) and score >= threshold.
// The query rows are normalised once by the caller, as the TPU kernel's
// wrapper does outside its grid.
//
// Design: one warp per gallery row, WARPS_PER_BLOCK rows per block.  The
// warp stages its row in shared memory (16-byte loads when the row allows
// them), reduces the sum of squares with shuffles, divides the row by
// fmaxf(sqrtf(ss), 1e-6f), then takes a shuffle-reduced dot product with
// each valid query row in ascending order; strict `>` keeps the first index
// on ties.  With nq == 0 the score is -inf, best is 0 and match is false.
// Built without fast math, so sqrtf and the division are IEEE.
//
// Bound: the work is N*D*4 + Q*D*4 bytes in and 9*N bytes out (score f32,
// best i32, match u8) against 2*N*D*(nq+1) flops, far below Hopper's
// ~20 flops/byte balance, so it is bound by bytes at 3.35 TB/s.  At the
// tracking path's shapes (N <= 32 gallery rows per VA batch, Q = 1) that
// bound is tens of nanoseconds and the call is bound by the launch itself
// (a few microseconds).  A later change should amortise launches rather
// than tune this body: batch several VA batches into one launch, or capture
// the per-batch sequence in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // Butterfly: every lane ends with the same total.
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(FULL_MASK, v, offset);
  }
  return v;
}

__global__ void reid_match_kernel(const float* __restrict__ gallery,
                                  const float* __restrict__ queries, int n,
                                  int d, int nq, float threshold,
                                  float* __restrict__ scores,
                                  int* __restrict__ best,
                                  unsigned char* __restrict__ match) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS_PER_BLOCK + warp;
  if (row >= n) return;  // the whole warp leaves together

  float* srow = smem + (size_t)warp * d;
  const float* g = gallery + row * (long long)d;

  float ss = 0.0f;
  const bool vec4 =
      (d % 4 == 0) && ((reinterpret_cast<uintptr_t>(g) & 15u) == 0);
  if (vec4) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* s4 = reinterpret_cast<float4*>(srow);
    for (int i = lane; i < d / 4; i += 32) {
      const float4 v = g4[i];
      s4[i] = v;
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float v = g[i];
      srow[i] = v;
      ss += v * v;
    }
  }
  ss = warp_sum(ss);
  __syncwarp();

  const float norm = fmaxf(sqrtf(ss), 1e-6f);
  for (int i = lane; i < d; i += 32) srow[i] = srow[i] / norm;
  __syncwarp();

  float best_s = -INFINITY;
  int best_q = 0;
  for (int q = 0; q < nq; ++q) {
    const float* qr = queries + (long long)q * d;
    float dot = 0.0f;
    for (int i = lane; i < d; i += 32) dot += srow[i] * qr[i];
    dot = warp_sum(dot);
    if (dot > best_s) {
      best_s = dot;
      best_q = q;
    }
  }
  if (lane == 0) {
    scores[row] = best_s;
    best[row] = best_q;
    match[row] = best_s >= threshold ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for rows of width d.
int reid_match_smem_bytes(int d) {
  return (int)(WARPS_PER_BLOCK * (size_t)d * sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() of the launch (0 is
// success).  The caller guarantees n >= 1, d >= 1, 0 <= nq <= Q and that
// the pointers are contiguous f32/f32/f32/i32/u8 device buffers.
int reid_match_launch(const float* gallery, const float* queries, int n, int d,
                      int nq, float threshold, float* scores, int* best,
                      unsigned char* match, void* stream) {
  const int smem = reid_match_smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        reid_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
  }
  const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  reid_match_kernel<<<blocks, WARPS_PER_BLOCK * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      gallery, queries, n, d, nq, threshold, scores, best, match);
  return (int)cudaGetLastError();
}

}  // extern "C"

// Exact softmax attention, forward only, for Hopper (sm_90a): one fused
// pass in the manner of FlashAttention-2, fp32 in and out, the two products
// in TF32 on the tensor cores with fp32 accumulation.
//
// It replaces no TPU kernel: the JAX package leaves attention to XLA
// (gaussiananything_tpu/models/layers.py:32-68). It was added because the
// plain version (`ops/attention.attention_plain`: matmul, scale, softmax,
// matmul) writes each score matrix to device memory and reads it back five
// times, and in a release image-to-3D request that traffic was the largest
// part of the DiT-L evaluations that set the request's time: per evaluation
// 24 blocks score 2 × 16 × 768 × 768 (self) and 2 × 16 × 768 × 1369 (cross)
// fp32 entries, 210 MB a block, 30 GB an evaluation.
//
// What bounds it on this card: the arithmetic. An evaluation's attention is
// 323 GFLOP (4·T·S·64 a (batch, head)), 0.65 ms at 495 TFLOP/s TF32,
// against 1.45 GB of q, k, v and o, 0.43 ms at 3.35 TB/s; the scores never
// leave the SM. The design:
//
//   * a block takes 64 queries of one (batch, head), four warps of 16
//     queries each, and walks the keys in tiles of 64. q, k and v are read
//     through their strides as the caller holds them, (B, T, H, 64) with
//     unit stride along the head dim: no transposes, no copies;
//   * S = Q·Kᵀ with `mma.sync` m16n8k8 TF32, fp32 accumulation; the 1/√64
//     scale and log₂e are one multiply folded into the `exp2` argument; the
//     running row max and sum stay fp32 in registers; P is rounded to TF32
//     for P·V, which accumulates in fp32, and each row is divided by its sum
//     once at the end. These are the plain version's products under the
//     TF32 policy (JAX's Precision.DEFAULT on an H100) with fp32 scores and
//     softmax. Every operand is rounded to nearest (ties away) by adding
//     half a TF32 ulp to its bits, which gives `cvt.rna.tf32.f32`'s value
//     in one integer add where the conversion is a quarter-rate
//     instruction;
//   * P goes from the accumulator to the A operand of P·V in registers. A
//     thread's accumulator holds keys 2t and 2t+1 of each 8-key step where
//     the A operand wants keys t and t+4; the sum over keys does not care
//     about their order, so the kernel sums the keys as (2t, 2t+1) and
//     reads V's rows in the same order. In the same way each product's
//     head-dim order is permuted so that a thread's operands lie side by
//     side in shared memory (one 16-byte load for two steps of Q·Kᵀ, for
//     four output columns of P·V);
//   * the K and V tiles are copied with 16-byte `cp.async` into two buffers
//     each, laid out with an XOR swizzle of 16-byte chunks so that those
//     loads hit 32 distinct banks: K(j+1) is in flight while S(j), the
//     softmax and P·V(j) run, V(j+1) while P·V(j) and S(j+1) do; Q takes
//     V(1)'s place until it is in registers;
//   * 64 KB of shared memory and at most 168 registers a thread leave room
//     for three blocks on an SM: 396 slots for the 352-384 blocks of the
//     release shapes, one wave. (Two m16 tiles a warp, 128 queries a
//     block, reuse each K and V load twice but fill only 192 of 264 slots;
//     they measured 19-23% slower.)
//   * no atomics: one block writes each output row, so a result is the
//     same from run to run; rows and keys past T and S are zero-filled on
//     their way in, the keys masked to -inf, the rows not written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBM = 64;       // queries a block
constexpr int kBN = 64;       // keys a tile
constexpr int kThreads = 128;
constexpr int kTile = kBN * kD;  // floats of one tile
// K(0), K(1), V(0), V(1); Q sits in V(1)'s place until it is in registers
constexpr int kSmemBytes = 4 * kTile * (int)sizeof(float);
// (1/sqrt(64)) * log2(e): the score scale folded into exp2's argument
constexpr float kScaleLog2 = 0.125f * 1.4426950408889634f;

struct Strides {
  long long qb, qt, qh, kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ void cp_async_16(float* smem, const float* gmem,
                                            bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// x rounded to TF32 for the tensor cores, which read the top 19 bits of
// an operand register: adding half a TF32 ulp (bit 12) rounds to nearest,
// ties away from zero, as `cvt.rna.tf32.f32` does, in one integer add where
// the conversion is a quarter-rate instruction; the low 13 bits left behind
// are not read. (For finite x; every operand of the kernel is.)
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// 2^x by the special-function unit (2 ulp; results below 2^-126 are 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a · b, a 16×8 (row), b 8×8 (col), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Shared tiles are 64 rows of 16 chunks of 16 bytes; chunk c of row r sits
// at chunk c ^ swizzle(r). Q and K are read a row's chunk 4k'+t by the
// lanes (g, t) of rows g ∈ {2p, 2p+1}: flipping bit 2 on odd rows puts the
// two rows on the two halves of the banks. V is read chunk 2g(+1) of rows
// 2t(+1): bits 0 and 2 from bits 1 and 2 of the row give the four rows of
// a quarter-warp four distinct offsets.
__device__ __forceinline__ int qk_swizzle(int r) { return (r & 1) << 2; }
__device__ __forceinline__ int v_swizzle(int r) {
  return ((r >> 1) & 1) | (r & 4);
}

// Copy rows row0 .. row0 + 63 of one (batch, head) into a shared tile; rows
// at or past `rows` are zero-filled.
template <bool kIsV>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          long long row_stride, int row0,
                                          int rows) {
#pragma unroll
  for (int i = 0; i < kBM * kD / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 4, c = idx & 15;
    const bool ok = row0 + r < rows;
    const float* g = ok ? src + (long long)(row0 + r) * row_stride + c * 4
                        : src;
    const int pos = c ^ (kIsV ? v_swizzle(r) : qk_swizzle(r));
    cp_async_16(tile + r * kD + pos * 4, g, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int T, int S, int H, Strides st) {
  extern __shared__ __align__(128) float smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;

  load_tile<false>(smem + 3 * kTile, qp, st.qt, m0, T);
  load_tile<false>(smem, kp, st.ks, 0, S);
  cp_async_commit();
  load_tile<true>(smem + 2 * kTile, vp, st.vs, 0, S);
  cp_async_commit();

  // Q·Kᵀ's A operand for the warp's 16 rows, k-step kk = 2k' + e reading
  // head dims 16k' + 4t + 2e (a0, a1) and + 1 (a2, a3)
  uint32_t qf[8][4];
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // rows g and g + 8 of the warp: running max (raw score) and partial sum
  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.f, 0.f};

  // Tile j's K and V live in buffers j & 1. K(j + 1) is copied while S(j),
  // the softmax and P·V(j) run, V(j + 1) while P·V(j) and S(j + 1) do.
  const int n_tiles = (S + kBN - 1) / kBN;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBN;
    const float* ks = smem + (j & 1) * kTile;
    const float* vs = smem + (2 + (j & 1)) * kTile;
    cp_async_wait<1>();  // K(j) (and Q) have landed; V(j) may be in flight
    __syncthreads();     // for every thread; every warp is done with tile j-1

    if (j == 0) {
      const float* qs = smem + 3 * kTile;
      const int r0 = warp * 16 + g;
#pragma unroll
      for (int kp2 = 0; kp2 < 4; ++kp2) {
        const int pos = (4 * kp2 + t) ^ qk_swizzle(r0);
        const float4 lo = *reinterpret_cast<const float4*>(
            qs + r0 * kD + pos * 4);
        const float4 hi = *reinterpret_cast<const float4*>(
            qs + (r0 + 8) * kD + pos * 4);
        qf[2 * kp2][0] = tf32(lo.x);
        qf[2 * kp2][1] = tf32(hi.x);
        qf[2 * kp2][2] = tf32(lo.y);
        qf[2 * kp2][3] = tf32(hi.y);
        qf[2 * kp2 + 1][0] = tf32(lo.z);
        qf[2 * kp2 + 1][1] = tf32(hi.z);
        qf[2 * kp2 + 1][2] = tf32(lo.w);
        qf[2 * kp2 + 1][3] = tf32(hi.w);
      }
    }
    if (j + 1 < n_tiles)  // into tile j-1's K buffer
      load_tile<false>(smem + ((j + 1) & 1) * kTile, kp, st.ks, n0 + kBN, S);
    cp_async_commit();  // empty after the last tile: each wait counts alike

    // S = Q·Kᵀ: n-tile n is keys n0 + 8n .. + 7; a thread gets keys
    // 8n + 2t, 8n + 2t + 1 of rows g (s[n][0], s[n][1]) and g + 8 ([2], [3])
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
      const int r = 8 * n + g;
#pragma unroll
      for (int kp2 = 0; kp2 < 4; ++kp2) {
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + r * kD + ((4 * kp2 + t) ^ qk_swizzle(r)) * 4);
        mma_tf32(s[n], qf[2 * kp2][0], qf[2 * kp2][1], qf[2 * kp2][2],
                 qf[2 * kp2][3], tf32(kv.x), tf32(kv.y));
        mma_tf32(s[n], qf[2 * kp2 + 1][0], qf[2 * kp2 + 1][1],
                 qf[2 * kp2 + 1][2], qf[2 * kp2 + 1][3], tf32(kv.z),
                 tf32(kv.w));
      }
    }

    if (n0 + kBN > S) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int key = n0 + 8 * n + 2 * t;
        if (key >= S) s[n][0] = s[n][2] = -INFINITY;
        if (key + 1 >= S) s[n][1] = s[n][3] = -INFINITY;
      }
    }

    // online softmax: the new row max over the quad of lanes sharing a row
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float scaled_max[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // every tile holds a real key, so mx is finite; on the first tile
      // exp2(-inf) = 0 rescales the empty sums
      const float alpha = exp2_approx((row_max[i] - mx[i]) * kScaleLog2);
      row_max[i] = mx[i];
      scaled_max[i] = mx[i] * kScaleLog2;
      row_sum[i] *= alpha;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2_approx(fmaf(s[n][i], kScaleLog2, -scaled_max[i >> 1]));
        ls[i >> 1] += s[n][i];
      }
    }
    row_sum[0] += ls[0];
    row_sum[1] += ls[1];

    cp_async_wait<1>();  // V(j) has landed; K(j + 1) may be in flight
    __syncthreads();     // for every thread; every warp has read Q
    if (j + 1 < n_tiles)  // into tile j-1's V buffer (at j = 0, Q's place)
      load_tile<true>(smem + (2 + ((j + 1) & 1)) * kTile, vp, st.vs,
                      n0 + kBN, S);
    cp_async_commit();

    // O += P·V over the tile's 8 key steps. P's A operand is the
    // accumulator as it stands, read as keys (2t, 2t+1); B is V's rows
    // 8j + 2t (b0) and + 1 (b1), and output column n of the n-tile is head
    // dim 8g + n, so a thread reads V's dims 8g .. 8g + 7 of each row.
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const uint32_t a0 = tf32(s[jj][0]), a1 = tf32(s[jj][2]),
                     a2 = tf32(s[jj][1]), a3 = tf32(s[jj][3]);
      const int r = 8 * jj + 2 * t;
      const int sw = v_swizzle(r);  // the same for r + 1
      const float4 v0lo = *reinterpret_cast<const float4*>(
          vs + r * kD + ((2 * g) ^ sw) * 4);
      const float4 v0hi = *reinterpret_cast<const float4*>(
          vs + r * kD + ((2 * g + 1) ^ sw) * 4);
      const float4 v1lo = *reinterpret_cast<const float4*>(
          vs + (r + 1) * kD + ((2 * g) ^ sw) * 4);
      const float4 v1hi = *reinterpret_cast<const float4*>(
          vs + (r + 1) * kD + ((2 * g + 1) ^ sw) * 4);
      mma_tf32(acc[0], a0, a1, a2, a3, tf32(v0lo.x), tf32(v1lo.x));
      mma_tf32(acc[1], a0, a1, a2, a3, tf32(v0lo.y), tf32(v1lo.y));
      mma_tf32(acc[2], a0, a1, a2, a3, tf32(v0lo.z), tf32(v1lo.z));
      mma_tf32(acc[3], a0, a1, a2, a3, tf32(v0lo.w), tf32(v1lo.w));
      mma_tf32(acc[4], a0, a1, a2, a3, tf32(v0hi.x), tf32(v1hi.x));
      mma_tf32(acc[5], a0, a1, a2, a3, tf32(v0hi.y), tf32(v1hi.y));
      mma_tf32(acc[6], a0, a1, a2, a3, tf32(v0hi.z), tf32(v1hi.z));
      mma_tf32(acc[7], a0, a1, a2, a3, tf32(v0hi.w), tf32(v1hi.w));
    }
  }

  // acc[n][0] is row g, head dim 16t + n; acc[n][1] dim 16t + 8 + n;
  // [2], [3] the same dims of row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = row_sum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = m0 + warp * 16 + g + 8 * i;
    if (row >= T) continue;
    float* out = o + (((long long)b * T + row) * H + h) * kD + 16 * t;
    const int c0 = 2 * i, c1 = 2 * i + 1;
    reinterpret_cast<float4*>(out)[0] =
        make_float4(acc[0][c0] * inv, acc[1][c0] * inv, acc[2][c0] * inv,
                    acc[3][c0] * inv);
    reinterpret_cast<float4*>(out)[1] =
        make_float4(acc[4][c0] * inv, acc[5][c0] * inv, acc[6][c0] * inv,
                    acc[7][c0] * inv);
    reinterpret_cast<float4*>(out)[2] =
        make_float4(acc[0][c1] * inv, acc[1][c1] * inv, acc[2][c1] * inv,
                    acc[3][c1] * inv);
    reinterpret_cast<float4*>(out)[3] =
        make_float4(acc[4][c1] * inv, acc[5][c1] * inv, acc[6][c1] * inv,
                    acc[7][c1] * inv);
  }
}

}  // namespace

// q (B, T, H, 64), k and v (B, S, H, 64) fp32 with unit stride along the
// head dim, every other stride (in elements) a multiple of 4 and every
// base 16-byte aligned (the wrapper checks); o (B, T, H, 64) contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int ga_attention(const void* q, const void* k, const void* v,
                            void* o, int B, int T, int S, int H,
                            long long qb, long long qt, long long qh,
                            long long kb, long long ks, long long kh,
                            long long vb, long long vs, long long vh,
                            void* stream) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{qb, qt, qh, kb, ks, kh, vb, vs, vh};
  const cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBM - 1) / kBM, H, B);
  attention_fwd_kernel<<<grid, kThreads, kSmemBytes,
                         (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, T, S, H,
      st);
  return (int)cudaGetLastError();
}

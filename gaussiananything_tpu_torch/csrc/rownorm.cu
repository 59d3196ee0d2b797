// One-pass row normalisation for Hopper (sm_90a): the residual add with its
// gate, the RMS normalisation with its weight and the adaLN modulation of a
// DiT block, in one read of each row and one write of each result.
//
// It replaces no TPU kernel: the JAX package leaves these expressions to
// XLA (gaussiananything_tpu/models/layers.py, models/dit.py). It was added
// because in PyTorch each of them is its own launch: `RMSNorm.forward` is
// six (x*x, mean, +eps, rsqrt, x*r, *w), `modulate` three, a gated residual
// two, and a release DiT-L block made ~55 such launches, each reading and
// writing a (2, 768, 1024) fp32 tensor, the q/k norms through the generic
// strided path. Inside the DiT-Ls' CUDA graphs the host costs nothing, but
// each launch still pays its ramp and tail on the card (~4 µs).
//
// What bounds it on this card: bytes and launches, not arithmetic. The
// fused residual + norm + modulate at (2, 768, 1024) reads x and y and
// writes x' and h: 25 MB, 7.5 µs at 3.35 TB/s, less where the rows are
// still in the 50 MB L2 from the product that wrote y. The design:
//
//   * a group of L lanes takes one row (L = 32 for D = 1024: 32 fp32 a
//     lane as eight 16-byte loads; L = 16 for a 64-wide q/k head), lane l
//     reading the 16-byte chunks l, l + L, ... so that neighbouring lanes
//     read neighbouring addresses; rows are read through their strides as
//     the caller holds them (q and k straight out of the packed qkv
//     projection), the results written contiguous;
//   * the row stays in registers between the sum of squares and the
//     output: x' = x + gate·y (or x + y, or x), the sum of x'² over the
//     lane, then over the group by a butterfly of warp shuffles, which
//     leaves the same bits in every lane: no shared memory, no atomics, so
//     two launches give the same bits;
//   * the arithmetic is `RMSNorm.forward`'s and `modulate`'s, operation by
//     operation and rounded as they round (h = x'·r·w with r =
//     rsqrt(mean(x'²) + eps), then h·(1 + scale) + shift; the products and
//     sums of the outputs rounded apart, no fused multiply-adds); only the
//     sum of squares is summed in another order;
//   * the per-batch vectors (gate, shift, scale: rows of the block's adaLN
//     table) are indexed by the row's batch; they and the weight are read
//     16 bytes at a time where all of them are 16-byte aligned, else a
//     float at a time (a weight may be a view at any offset into one
//     buffer of parameters); they are a few KB, from L1 and L2;
//   * one launch runs up to two jobs of the same width, the grid split
//     between them: the q and the k norms of one attention.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxJobs = 2;

// One job: rows of x (B, N, H, D) read through their strides (in floats;
// the last dim unit stride), optional y of the same frame, optional
// per-batch rows gate, shift, scale (B, D); outputs contiguous (B, N, H, D).
// Laid out as `ops/rownorm._Job`.
struct Job {
  const float* x;
  long long xb, xn, xh;
  const float* y;  // null: no residual
  long long yb, yn, yh;
  const float* gate;  // null: x + y
  long long gb;
  const float* w;  // null: residual only, no h
  const float* shift;  // null: no modulation (then scale is null too)
  long long sb;
  const float* scale;
  long long cb;
  float* xo;  // x' (written when y is given)
  float* ho;  // h (written when w is given)
  long long B, N, H;
  float eps;
  int vec4;  // weight, gate, shift, scale all 16-byte aligned
};

struct Jobs {
  Job job[kMaxJobs];
  long long first_block[kMaxJobs + 1];  // job j owns [first[j], first[j+1])
  int n;
};

__device__ __forceinline__ float4 ld4(const float* row, int c) {
  return reinterpret_cast<const float4*>(row)[c];
}

// chunk c of a vector read 16 bytes at once, or a float at a time
__device__ __forceinline__ float4 ldv(const float* v, int c, bool vec4) {
  if (vec4) return ld4(v, c);
  v += 4 * c;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(float* row, int c, float4 v) {
  reinterpret_cast<float4*>(row)[c] = v;
}

// x + g·y, rounded as the plain version's two operations
__device__ __forceinline__ float4 residual(float4 x, float4 y, float4 g,
                                           bool gated) {
  if (gated) {
    y.x = __fmul_rn(g.x, y.x);
    y.y = __fmul_rn(g.y, y.y);
    y.z = __fmul_rn(g.z, y.z);
    y.w = __fmul_rn(g.w, y.w);
  }
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                     __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

// h = (x·r)·w, then h·(1 + scale) + shift when modulated
__device__ __forceinline__ float norm1(float x, float r, float w, bool mod,
                                       float sh, float sc) {
  float h = __fmul_rn(__fmul_rn(x, r), w);
  if (mod) h = __fadd_rn(__fmul_rn(h, __fadd_rn(1.0f, sc)), sh);
  return h;
}

// L lanes a row, NV 16-byte chunks a lane: D/4 <= L * NV
template <int L, int NV>
__global__ void __launch_bounds__(kThreads)
    rownorm_kernel(const Jobs jobs, int D) {
  static_assert(kMaxJobs == 2, "the job is picked out of two");
  const long long blk = blockIdx.x;
  // constant indices only: a parameter indexed at run time goes to the stack
  const int j = (jobs.n > 1 && blk >= jobs.first_block[1]) ? 1 : 0;
  const Job p = j ? jobs.job[1] : jobs.job[0];
  constexpr int kRows = kThreads / L;  // rows a block
  const int lane = threadIdx.x % L;
  const long long row =
      (blk - (j ? jobs.first_block[1] : 0)) * kRows + threadIdx.x / L;
  const long long rows = p.B * p.N * p.H;
  // a group past the last row keeps its lanes in the shuffles below
  const bool valid = row < rows;
  const int d4 = D / 4;
  long long b = 0, n = 0, h = 0;
  if (valid) {
    h = row % p.H;
    const long long t = row / p.H;
    n = t % p.N;
    b = t / p.N;
  }
  const float* xr = p.x + b * p.xb + n * p.xn + h * p.xh;
  const float* yr = p.y ? p.y + b * p.yb + n * p.yn + h * p.yh : nullptr;
  const float* gr = p.gate ? p.gate + b * p.gb : nullptr;

  float4 v[NV];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * L;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid && c < d4) {
      v[i] = ld4(xr, c);
      if (yr) {
        const float4 g = gr ? ldv(gr, c, p.vec4) : v[i];
        v[i] = residual(v[i], ld4(yr, c), g, gr != nullptr);
      }
      ss = __fadd_rn(ss, __fmul_rn(v[i].x, v[i].x));
      ss = __fadd_rn(ss, __fmul_rn(v[i].y, v[i].y));
      ss = __fadd_rn(ss, __fmul_rn(v[i].z, v[i].z));
      ss = __fadd_rn(ss, __fmul_rn(v[i].w, v[i].w));
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (!valid) return;

  const long long out = row * (long long)D;
  if (p.xo) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * L;
      if (c < d4) st4(p.xo + out, c, v[i]);
    }
  }
  if (!p.w) return;
  // mean as torch's reduction takes it: the sum times (float)(1/D)
  const float ms = __fmul_rn(ss, __fdiv_rn(1.0f, (float)D));
  const float r = rsqrtf(__fadd_rn(ms, p.eps));
  const bool mod = p.shift != nullptr;
  const float* shr = mod ? p.shift + b * p.sb : nullptr;
  const float* scr = mod ? p.scale + b * p.cb : nullptr;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * L;
    if (c >= d4) continue;
    const float4 w = ldv(p.w, c, p.vec4);
    float4 sh = make_float4(0.f, 0.f, 0.f, 0.f), sc = sh;
    if (mod) {
      sh = ldv(shr, c, p.vec4);
      sc = ldv(scr, c, p.vec4);
    }
    st4(p.ho + out, c,
        make_float4(norm1(v[i].x, r, w.x, mod, sh.x, sc.x),
                    norm1(v[i].y, r, w.y, mod, sh.y, sc.y),
                    norm1(v[i].z, r, w.z, mod, sh.z, sc.z),
                    norm1(v[i].w, r, w.w, mod, sh.w, sc.w)));
  }
}

template <int L, int NV>
cudaError_t launch(Jobs& jobs, int D, cudaStream_t stream) {
  constexpr int kRows = kThreads / L;
  jobs.first_block[0] = 0;
  for (int j = 0; j < jobs.n; ++j) {
    const Job& p = jobs.job[j];
    const long long rows = p.B * p.N * p.H;
    jobs.first_block[j + 1] =
        jobs.first_block[j] + (rows + kRows - 1) / kRows;
  }
  const long long blocks = jobs.first_block[jobs.n];
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rownorm_kernel<L, NV><<<(unsigned)blocks, kThreads, 0, stream>>>(jobs, D);
  return cudaGetLastError();
}

}  // namespace

// jobs: n_jobs (1 or 2) jobs of one width D (a multiple of 4, at most
// 1024); returns a cudaError_t as int, 0 on success.
extern "C" int ga_rownorm(const void* jobs, int n_jobs, int D,
                          void* stream) {
  if (n_jobs < 1 || n_jobs > kMaxJobs || D < 4 || D % 4 || D > 1024)
    return (int)cudaErrorInvalidValue;
  Jobs all{};
  all.n = n_jobs;
  for (int j = 0; j < n_jobs; ++j) all.job[j] = ((const Job*)jobs)[j];
  const cudaStream_t s = (cudaStream_t)stream;
  const int d4 = D / 4;
  if (d4 <= 1) return (int)launch<1, 1>(all, D, s);
  if (d4 <= 2) return (int)launch<2, 1>(all, D, s);
  if (d4 <= 4) return (int)launch<4, 1>(all, D, s);
  if (d4 <= 8) return (int)launch<8, 1>(all, D, s);
  if (d4 <= 16) return (int)launch<16, 1>(all, D, s);
  switch ((d4 + 31) / 32) {
    case 1: return (int)launch<32, 1>(all, D, s);
    case 2: return (int)launch<32, 2>(all, D, s);
    case 3: return (int)launch<32, 3>(all, D, s);
    case 4: return (int)launch<32, 4>(all, D, s);
    case 5: return (int)launch<32, 5>(all, D, s);
    case 6: return (int)launch<32, 6>(all, D, s);
    case 7: return (int)launch<32, 7>(all, D, s);
    default: return (int)launch<32, 8>(all, D, s);
  }
}

// The conv stack's LayerNorm over the channels of an NHWC float32 map, fused
// with what follows it at every site: y = relu(LayerNorm_C(x) * gamma + beta
// [+ residual]), over rows of C contiguous floats, and its backward.
//
// It replaces no TPU kernel. The JAX package's LayerNorm is flax
// nn.LayerNorm() on the channel axis (lightzero_tpu/models/common.py), which
// XLA compiles and fuses with the relu and the add. The port ran PyTorch's
// layer_norm, then a relu kernel, then an add where there is a residual.
// aten's vectorized_layer_norm_kernel gives each row its own thread block;
// here a row is 16 to 96 floats, so tens of thousands of blocks each loaded
// one to four float4s while most of each block's threads sat idle: it reached
// 6-7 % of the card's memory bound. The relu and the add then read and wrote
// the whole map again, and in the backward a relu backward and a gamma/beta
// kernel did the same.
//
// What bounds it on the H100: bytes. A few operations an element against 8
// to 20 bytes moved (x read, y written, the residual read; the backward reads
// dy, x and y and writes dx and the residual's gradient).
//
// The design:
// - A row to a group of G lanes, each lane V float4s (G a power of two, G x
//   V float4s at least C / 4; lanes past the row's end hold zeros and store
//   nothing): C=64 takes 16 lanes, C=32 eight, C=16 four, so a warp holds 2
//   to 8 rows and every lane loads. The group's sums are xor shuffles inside
//   the group, so every lane of the group holds the same bits.
// - The statistics and the output are aten's, bit for bit: each lane a
//   Welford sum over its float4, then aten's warp reduction order inside the
//   group (shuffles down), rstd = rsqrtf(m2 / C + eps), y = fma(gamma, rstd
//   (x - mean), beta), with aten's fused multiply-adds written out (the
//   library builds with --fmad=false). So the port's outputs and the
//   references that keep aten's layer_norm agree exactly; an output a
//   rounding from 0 would otherwise fall on the other side of the relu, and
//   the gradient with it.
// - Persistent blocks that loop over the rows, kUnroll row slots a lane in
//   flight, gamma and beta (and in the backward the lane's gamma/beta
//   gradient sums) in registers: a lane's channels are the same in every
//   row it visits.
// - The epilogue adds the residual and applies the relu before one float4
//   store. The mean and rstd are written only when the caller asks for them
//   (autograd); a search under no_grad saves nothing.
// - Backward: the relu's mask from the saved output (y > 0), x-hat
//   recomputed from x, mean and rstd; one pass writes dx and, where there is
//   a residual, its gradient (the masked dy). The gamma and beta gradients
//   are summed in double, per lane over its rows, then over the warp's
//   groups by shuffles, then over the block's warps in shared memory, into
//   one partial row a block; a second launch sums the blocks' partials in a
//   fixed order, a warp a channel. No atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// row slots a lane group carries at once
constexpr int kUnroll = 2;
constexpr int kMaxChannels = 256;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// the sum over a group of G lanes (xor butterfly): every lane gets it
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// relu that keeps a NaN, as torch.relu does
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// A row's running mean, sum of squared deviations and count, as aten's
// LayerNorm keeps them (WelfordDataLN in layer_norm_kernel.cu).
struct Welford {
  float mean, m2, count;
};

// aten's cuWelfordOnlineSum, with the fused multiply-adds its build makes
__device__ __forceinline__ Welford welford_add(Welford w, float v) {
  const float delta = v - w.mean;
  const float count = w.count + 1.f;
  const float mean = __fmaf_rn(delta, 1.f / count, w.mean);
  return {mean, __fmaf_rn(delta, v - mean, w.m2), count};
}

// aten's cuWelfordCombine(own, other), with the fused multiply-adds its
// build makes
__device__ __forceinline__ Welford welford_merge(Welford own, Welford other) {
  const float count = other.count + own.count;
  if (!(count > 0.f)) return {0.f, 0.f, count};
  const float delta = own.mean - other.mean;
  const float coef = 1.f / count;
  const float n_other = other.count * coef, n_own = own.count * coef;
  return {__fmaf_rn(n_other, other.mean, n_own * own.mean),
          __fmaf_rn(delta * delta * other.count, n_own, other.m2 + own.m2), count};
}

__device__ __forceinline__ Welford welford_of(float4 v) {
  Welford w = {0.f, 0.f, 0.f};
  w = welford_add(w, v.x);
  w = welford_add(w, v.y);
  w = welford_add(w, v.z);
  return welford_add(w, v.w);
}

// aten's warp reduction (shuffles down, each lane merging the one `o` lanes
// above it) over a group of G lanes, whose first lane then holds aten's
// result; every lane of the group takes it. aten's steps at offsets of G or
// more merge lanes that hold nothing, which leaves a count of 4 as it was.
template <int G>
__device__ __forceinline__ Welford group_welford(Welford w) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const Welford other = {__shfl_down_sync(kFullMask, w.mean, o),
                           __shfl_down_sync(kFullMask, w.m2, o),
                           __shfl_down_sync(kFullMask, w.count, o)};
    w = welford_merge(w, other);
  }
  const int first = (threadIdx.x & 31) & ~(G - 1);
  return {__shfl_sync(kFullMask, w.mean, first), __shfl_sync(kFullMask, w.m2, first),
          __shfl_sync(kFullMask, w.count, first)};
}

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
channel_norm_fwd_kernel(const float4* __restrict__ x, const float4* __restrict__ res,
                        const float4* __restrict__ gamma, const float4* __restrict__ beta,
                        float4* __restrict__ y, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, long long rows, int c4, float eps) {
  constexpr int kRowsPerWarp = 32 / G;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int grp = lane / G;
  const float channels = 4.f * c4;
  float4 g[V], b[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = sub + v * G;
    g[v] = j < c4 ? gamma[j] : zero4();
    b[v] = j < c4 ? beta[j] : zero4();
  }
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long step = (long long)gridDim.x * kWarps * kRowsPerWarp * kUnroll;
  for (long long base = warp * kRowsPerWarp * kUnroll; base < rows; base += step) {
    float4 xv[kUnroll][V];
    float4 rv[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * kRowsPerWarp + grp;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = sub + v * G;
        const bool in = row < rows && j < c4;
        xv[u][v] = in ? x[row * c4 + j] : zero4();
        rv[u][v] = (in && res != nullptr) ? res[row * c4 + j] : zero4();
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * kRowsPerWarp + grp;
      // aten's thread (lane) j holds float4 j of the row; past 32 float4s
      // its second warp holds the rest, merged into the first's
      Welford w = {0.f, 0.f, 0.f};
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const Welford part = group_welford<G>(sub + v * G < c4 ? welford_of(xv[u][v])
                                                               : Welford{0.f, 0.f, 0.f});
        w = v == 0 ? part : welford_merge(w, part);
      }
      const float mean = w.mean;
      const float rstd = rsqrtf(w.m2 / channels + eps);
      if (row >= rows) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = sub + v * G;
        if (j >= c4) continue;
        const float4 xi = xv[u][v], ri = rv[u][v];
        float4 o;
        o.x = relu(__fmaf_rn(g[v].x, rstd * (xi.x - mean), b[v].x) + ri.x);
        o.y = relu(__fmaf_rn(g[v].y, rstd * (xi.y - mean), b[v].y) + ri.y);
        o.z = relu(__fmaf_rn(g[v].z, rstd * (xi.z - mean), b[v].z) + ri.z);
        o.w = relu(__fmaf_rn(g[v].w, rstd * (xi.w - mean), b[v].w) + ri.w);
        y[row * c4 + j] = o;
      }
      if (mean_out != nullptr && sub == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
  }
}

template <int G, int V>
__global__ void __launch_bounds__(kThreads)
channel_norm_bwd_kernel(const float4* __restrict__ dy, const float4* __restrict__ x,
                        const float4* __restrict__ y, const float* __restrict__ mean,
                        const float* __restrict__ rstd, const float4* __restrict__ gamma,
                        float4* __restrict__ dx, float4* __restrict__ dres,
                        double* __restrict__ partial, long long rows, int c4) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kWidth = 4 * G * V;  // the channels a warp's first group covers
  __shared__ double sums[kWarps][2][kWidth];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int sub = lane % G;
  const int grp = lane / G;
  const float channels = 4.f * c4;
  float4 g[V];
  double dg[V][4], db[V][4];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int j = sub + v * G;
    g[v] = j < c4 ? gamma[j] : zero4();
#pragma unroll
    for (int k = 0; k < 4; ++k) dg[v][k] = db[v][k] = 0.0;
  }
  const long long warp = (long long)blockIdx.x * kWarps + wid;
  const long long step = (long long)gridDim.x * kWarps * kRowsPerWarp * kUnroll;
  for (long long base = warp * kRowsPerWarp * kUnroll; base < rows; base += step) {
    float4 gv[kUnroll][V], xv[kUnroll][V];
    float mu[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * kRowsPerWarp + grp;
      const bool row_in = row < rows;
      mu[u] = row_in ? mean[row] : 0.f;
      rs[u] = row_in ? rstd[row] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = sub + v * G;
        const bool in = row_in && j < c4;
        const float4 d = in ? dy[row * c4 + j] : zero4();
        const float4 o = in ? y[row * c4 + j] : zero4();
        xv[u][v] = in ? x[row * c4 + j] : zero4();
        // the relu's gradient: dy where the output is positive
        gv[u][v] = make_float4(o.x > 0.f ? d.x : 0.f, o.y > 0.f ? d.y : 0.f,
                               o.z > 0.f ? d.z : 0.f, o.w > 0.f ? d.w : 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * kRowsPerWarp + grp;
      float4 xh[V], dh[V];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 xi = xv[u][v], gi = gv[u][v];
        xh[v] = make_float4((xi.x - mu[u]) * rs[u], (xi.y - mu[u]) * rs[u],
                            (xi.z - mu[u]) * rs[u], (xi.w - mu[u]) * rs[u]);
        dh[v] = make_float4(gi.x * g[v].x, gi.y * g[v].y, gi.z * g[v].z, gi.w * g[v].w);
        s1 += (dh[v].x + dh[v].y) + (dh[v].z + dh[v].w);
        s2 += (dh[v].x * xh[v].x + dh[v].y * xh[v].y) + (dh[v].z * xh[v].z + dh[v].w * xh[v].w);
      }
      const float a = group_sum<G>(s1) / channels;
      const float c = group_sum<G>(s2) / channels;
      if (row >= rows) continue;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int j = sub + v * G;
        if (j >= c4) continue;
        const float4 gi = gv[u][v];
        float4 o;
        o.x = rs[u] * (dh[v].x - a - xh[v].x * c);
        o.y = rs[u] * (dh[v].y - a - xh[v].y * c);
        o.z = rs[u] * (dh[v].z - a - xh[v].z * c);
        o.w = rs[u] * (dh[v].w - a - xh[v].w * c);
        dx[row * c4 + j] = o;
        if (dres != nullptr) dres[row * c4 + j] = gi;
        dg[v][0] += (double)gi.x * xh[v].x;
        dg[v][1] += (double)gi.y * xh[v].y;
        dg[v][2] += (double)gi.z * xh[v].z;
        dg[v][3] += (double)gi.w * xh[v].w;
        db[v][0] += (double)gi.x;
        db[v][1] += (double)gi.y;
        db[v][2] += (double)gi.z;
        db[v][3] += (double)gi.w;
      }
    }
  }
  // the warp's groups, then the block's warps, in a fixed order
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int o = G; o < 32; o <<= 1) {
        dg[v][k] += __shfl_xor_sync(kFullMask, dg[v][k], o);
        db[v][k] += __shfl_xor_sync(kFullMask, db[v][k], o);
      }
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = 4 * (sub + v * G) + k;
        sums[wid][0][ch] = dg[v][k];
        sums[wid][1][ch] = db[v][k];
      }
    }
  }
  __syncthreads();
  const int C = 4 * c4;
  for (int t = threadIdx.x; t < 2 * C; t += kThreads) {
    const int which = t / C, ch = t % C;
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sums[w][which][ch];
    partial[(long long)blockIdx.x * 2 * C + t] = s;
  }
}

// the blocks' partial rows (blocks, 2C) summed a warp a column: each lane a
// strided share in order, then a fixed butterfly; the gamma gradient, then
// beta's
__global__ void __launch_bounds__(kThreads)
channel_norm_param_grad_kernel(const double* __restrict__ partial, int blocks, int C,
                               float* __restrict__ dgamma, float* __restrict__ dbeta) {
  const int col = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (col >= 2 * C) return;
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) s += partial[(long long)b * 2 * C + col];
  s = group_sum<32>(s);
  if (lane == 0) {
    if (col < C) dgamma[col] = (float)s;
    else dbeta[col - C] = (float)s;
  }
}

// G lanes a row and V float4s a lane for C channels (C % 4 == 0, C <= 256)
void shape_of(int C, int* G, int* V) {
  const int c4 = C / 4;
  *V = c4 <= 32 ? 1 : 2;
  const int per = (c4 + *V - 1) / *V;
  int g = 1;
  while (g < per) g <<= 1;
  *G = g;
}

typedef void (*FwdKernel)(const float4*, const float4*, const float4*, const float4*, float4*,
                          float*, float*, long long, int, float);
typedef void (*BwdKernel)(const float4*, const float4*, const float4*, const float*,
                          const float*, const float4*, float4*, float4*, double*, long long,
                          int);

FwdKernel fwd_kernel(int G, int V) {
  if (V == 2) return channel_norm_fwd_kernel<32, 2>;
  switch (G) {
    case 1: return channel_norm_fwd_kernel<1, 1>;
    case 2: return channel_norm_fwd_kernel<2, 1>;
    case 4: return channel_norm_fwd_kernel<4, 1>;
    case 8: return channel_norm_fwd_kernel<8, 1>;
    case 16: return channel_norm_fwd_kernel<16, 1>;
    default: return channel_norm_fwd_kernel<32, 1>;
  }
}

BwdKernel bwd_kernel(int G, int V) {
  if (V == 2) return channel_norm_bwd_kernel<32, 2>;
  switch (G) {
    case 1: return channel_norm_bwd_kernel<1, 1>;
    case 2: return channel_norm_bwd_kernel<2, 1>;
    case 4: return channel_norm_bwd_kernel<4, 1>;
    case 8: return channel_norm_bwd_kernel<8, 1>;
    case 16: return channel_norm_bwd_kernel<16, 1>;
    default: return channel_norm_bwd_kernel<32, 1>;
  }
}

bool takes(int C) { return C > 0 && C % 4 == 0 && C <= kMaxChannels; }

}  // namespace

extern "C" {

int channel_norm_max_channels() { return kMaxChannels; }

// The blocks a launch over `rows` rows of C channels takes: enough to cover
// the rows once, at most as many as the card holds at once. The backward's
// partial rows number as many; the wrapper allocates them. -1: C not taken,
// or a CUDA error.
int channel_norm_blocks(long long rows, int C, int backward) {
  if (!takes(C) || rows < 0) return -1;
  int G, V;
  shape_of(C, &G, &V);
  int device, sms, per_sm;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const cudaError_t rc =
      backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bwd_kernel(G, V),
                                                                kThreads, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_kernel(G, V),
                                                                kThreads, 0);
  if (rc != cudaSuccess) return -1;
  const long long rows_per_block = (long long)kWarps * (32 / G) * kUnroll;
  const long long needed = (rows + rows_per_block - 1) / rows_per_block;
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (int)(needed < most ? (needed > 0 ? needed : 1) : most);
}

// y = relu(LayerNorm_C(x) * gamma + beta [+ res]) over `rows` rows; mean
// and rstd (rows,) are written where not null. Every pointer 16-byte
// aligned, every map contiguous (rows, C).
int channel_norm_forward(const void* x, const void* res, const void* gamma, const void* beta,
                         void* y, void* mean, void* rstd, long long rows, int C, int blocks,
                         float eps, void* stream) {
  if (!takes(C) || blocks <= 0) return (int)cudaErrorInvalidValue;
  int G, V;
  shape_of(C, &G, &V);
  const FwdKernel kernel = fwd_kernel(G, V);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)res, (const float4*)gamma, (const float4*)beta,
      (float4*)y, (float*)mean, (float*)rstd, rows, C / 4, eps);
  return (int)cudaGetLastError();
}

// dx (and dres, where not null: the residual's gradient) from dy, the saved
// x, output y and stats (rows means, then rows rstds); dgamma and dbeta
// through `partial` (blocks, 2C) doubles, in a second launch.
int channel_norm_backward(const void* dy, const void* x, const void* y, const void* stats,
                          const void* gamma, void* dx, void* dres, void* partial, void* dgamma,
                          void* dbeta, long long rows, int C, int blocks, void* stream) {
  if (!takes(C) || blocks <= 0) return (int)cudaErrorInvalidValue;
  int G, V;
  shape_of(C, &G, &V);
  cudaStream_t s = (cudaStream_t)stream;
  const BwdKernel kernel = bwd_kernel(G, V);
  kernel<<<blocks, kThreads, 0, s>>>(
      (const float4*)dy, (const float4*)x, (const float4*)y, (const float*)stats,
      (const float*)stats + rows, (const float4*)gamma, (float4*)dx, (float4*)dres,
      (double*)partial, rows, C / 4);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  channel_norm_param_grad_kernel<<<(2 * C + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      (const double*)partial, blocks, C, (float*)dgamma, (float*)dbeta);
  return (int)cudaGetLastError();
}

}  // extern "C"

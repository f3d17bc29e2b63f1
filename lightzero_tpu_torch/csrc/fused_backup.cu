// Fused expand and backup for a batch of one-player search trees: the tail
// of one pUCT simulation, after the recurrent inference. Each tree's leaf
// (node sim + 1) gets its prior, legal mask, scalars, embedding row and the
// link from its parent, and the leaf's value is backed up along the path
// the descent recorded: value sums, visit counts and the per-tree MinMax
// stats.
//
// It replaces no TPU kernel. The JAX package's backup is plain jnp, an
// associative scan over the path (lightzero_tpu/search/puct.py:650-677),
// which XLA compiles into the search's one program. The port runs the loop
// eagerly, and the same function in PyTorch (fused_backup_reference in
// lightzero_tpu_torch/search/fused_backup.py) is about 110 device ops a
// simulation at 2,048 trees, each over a few thousand elements: the card
// finished each before the host issued the next, and sat idle under the
// backup.
//
// What bounds it on the H100: the launch, and the bytes. At B=2,048 trees
// and P=52 path slots the path tables are about 2 MB (the int64 node path
// and three f32 stat tables); a conv embedding row of 6x6x64 floats adds
// 9,216 bytes a tree read and as many written, 18.9 MB each way. Every
// other access is a few bytes a tree. The arithmetic is a few hundred
// operations a tree.
//
// The design:
// - One warp per tree, 4 warps a block. The tree's scalars are read by all
//   lanes (one broadcast load each).
// - Expand (trees that did not stop at an existing terminal node): lane j
//   writes the prior and legal flag of action j (j, j + 32, ... past 32
//   actions). The prior is the softmax over the legal logits, computed in
//   the order of PyTorch's CUDA softmax for rows of up to 1,024 entries
//   (softmax_warp_forward): entry j in lane j % w of a group of w =
//   min(next power of two >= A, 32) lanes, each lane's entries first, then
//   a butterfly over the w lanes for the max and for the sum of exp(x -
//   max), then exp(x - max) / sum. Under prior_is_logits (Gumbel trees) the
//   row keeps the logits, illegal actions at -1e9. Lane 0 writes the row's
//   scalars and the parent's child link.
// - The embedding row, where it is one tensor, is copied by the warp with
//   16-byte loads and stores where the row's bytes and both addresses allow
//   it (4-byte or byte copies otherwise).
// - Backup: the bootstrap along the path, contrib_i = r_{i+1} + discount *
//   contrib_{i+1} with the leaf's value at the leaf, is the composition of
//   the affine maps g_i(x) = a_i x + b_i from each position to the end of
//   the path. It is composed by doubling, in the plain version's order: in
//   round k, (a_i, b_i) <- (a_i * a_{i+k}, a_i * b_{i+k} + b_i), identity
//   (1, 0) past the end, for k = 1, 2, 4, ... < P, every product and sum
//   rounded on its own (--fmad=false). The tables live in the warp's shared
//   memory and are updated in place 32 positions at a time from the first
//   position to the last: a position reads only positions at or after its
//   own, which the in-place update has not yet reached. So contributions,
//   value sums, visit counts and post-backup values are bitwise those of
//   the plain version.
// - Each path node appears once on its path, so each node's value sum and
//   visit count are read and written by one lane: no atomics.
// - The post-backup q of the path's nodes is reduced by a warp min and max
//   into new vmin and vmax tables; the input tables are left as they were.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The pointers and sizes of one launch; search/fused_backup.py mirrors this
// layout in _Args. Optional inputs are null when absent. Outside the
// anonymous namespace: the launcher's C interface takes it.
struct FusedBackupArgs {
  // the tree, updated in place: (B, N) and (B, N, A) tables
  int* visit_count;
  float* value_sum;
  float* reward;
  float* raw_value;
  float* prior;
  int* children;
  int* to_play;
  unsigned char* terminal;
  unsigned char* is_chance;
  unsigned char* legal;
  unsigned char* embedding;  // (B, N, E bytes); null: the row is written elsewhere
  const float* vmin;
  const float* vmax;
  // the new MinMax stats (B,)
  float* vmin_out;
  float* vmax_out;
  // the descent: (B,) and (B, P)
  const long long* depth;
  const long long* path;
  const long long* parent;
  const long long* last_action;
  const int* virtual_to_play;
  const unsigned char* leaf_is_terminal_node;
  const float* path_reward;
  const float* path_vsum;
  const float* path_visit;
  const unsigned char* reuse_hit;  // with value_override
  // the recurrent output: (B,), (B, A) and (B, E bytes)
  const float* leaf_reward;
  const float* leaf_value;
  const float* logits;
  const unsigned char* legal_mask;
  const unsigned char* leaf_terminal;
  const unsigned char* leaf_is_chance;
  const float* value_override;
  const unsigned char* leaf_embedding;
  long long embedding_bytes;
  int B, A, N, P, new_idx;
  float discount;
  int prior_is_logits;
};

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
// the most dynamic shared memory a block can ask for on sm_90 (227 KB)
constexpr size_t kMaxSharedBytes = 232448;
// the widest row PyTorch's CUDA softmax takes through softmax_warp_forward
constexpr int kMaxA = 1024;

typedef unsigned char u8;
typedef FusedBackupArgs Args;

// min and max that keep a NaN from either side, as torch.minimum and
// torch.maximum do (and the reductions along the path)
__device__ __forceinline__ float nan_min(float x, float y) {
  return (x != x) ? x : ((y != y) ? y : ((y < x) ? y : x));
}
__device__ __forceinline__ float nan_max(float x, float y) {
  return (x != x) ? x : ((y != y) ? y : ((x < y) ? y : x));
}

// The new row's prior and legal flags (Node.expand, ptree_mz.py:46-69).
__device__ void expand_row(const Args& a, int b, int lane) {
  const int A = a.A;
  const size_t row = ((size_t)b * a.N + a.new_idx) * A;
  const float* logits = a.logits + (size_t)b * A;
  const u8* mask = a.legal_mask ? a.legal_mask + (size_t)b * A : nullptr;
  if (a.prior_is_logits) {
    for (int j = lane; j < A; j += 32) {
      const bool legal = mask == nullptr || mask[j] != 0;
      a.prior[row + j] = legal ? logits[j] : -1e9f;
      a.legal[row + j] = legal;
    }
    return;
  }
  // softmax(where(legal, logits, -inf)), then where(legal, prior, 0), with
  // softmax_warp_forward's lanes and order: entries past A read -inf
  int npot = 1;
  while (npot < A) npot <<= 1;
  const int w = npot < 32 ? npot : 32;
  const int iters = npot / w;
  auto element = [&](int j) -> float {
    return (j < A && (mask == nullptr || mask[j] != 0)) ? logits[j] : -INFINITY;
  };
  float m = element(lane);
  for (int it = 1; it < iters; ++it) {
    const float x = element(lane + it * w);
    m = (m > x) ? m : x;
  }
  for (int off = w / 2; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFullMask, m, off);
    m = (m < o) ? o : m;
  }
  float sum = 0.0f;
  for (int it = 0; it < iters; ++it) sum += expf(element(lane + it * w) - m);
  for (int off = w / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFullMask, sum, off);
  if (lane >= w) return;
  for (int it = 0; it < iters; ++it) {
    const int j = lane + it * w;
    if (j >= A) break;
    const bool legal = mask == nullptr || mask[j] != 0;
    const float p = sum == 0.0f ? __int_as_float(0x7fc00000) : expf(element(j) - m) / sum;
    a.prior[row + j] = legal ? p : 0.0f;
    a.legal[row + j] = legal;
  }
}

// The new node's embedding row: E bytes from the recurrent output's row b.
__device__ void copy_embedding(const Args& a, int b, int lane) {
  const size_t E = (size_t)a.embedding_bytes;
  u8* dst = a.embedding + ((size_t)b * a.N + a.new_idx) * E;
  const u8* src = a.leaf_embedding + (size_t)b * E;
  const uintptr_t align = (uintptr_t)dst | (uintptr_t)src | (uintptr_t)E;
  if (align % 16 == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const size_t n = E / 16;
#pragma unroll 4
    for (size_t i = lane; i < n; i += 32) d[i] = __ldg(s + i);
  } else if (align % 4 == 0) {
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    for (size_t i = lane; i < E / 4; i += 32) d[i] = __ldg(s + i);
  } else {
    for (size_t i = lane; i < E; i += 32) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_backup_kernel(const Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;  // whole warps leave together
  const int N = a.N, P = a.P, new_idx = a.new_idx;
  float* sa = smem + (size_t)warp * 2 * P;
  float* sb = sa + P;

  // trees that stopped at an existing terminal node expand nothing
  const bool expand = a.leaf_is_terminal_node[b] == 0;
  const float leaf_reward = a.leaf_reward[b];
  const float leaf_value = a.leaf_value[b];
  if (expand) {
    expand_row(a, b, lane);
    if (a.embedding_bytes > 0) copy_embedding(a, b, lane);
    if (lane == 0) {
      const size_t link = ((size_t)b * N + (size_t)a.parent[b]) * a.A + (size_t)a.last_action[b];
      a.children[link] = new_idx;
      const size_t node = (size_t)b * N + new_idx;
      a.reward[node] = leaf_reward;
      a.raw_value[node] = leaf_value;
      a.to_play[node] = a.virtual_to_play[b];
      a.terminal[node] = a.leaf_terminal ? a.leaf_terminal[b] : 0;
      if (a.leaf_is_chance) a.is_chance[node] = a.leaf_is_chance[b];
    }
  }

  // the path: the recorded nodes and, for expanding trees, the new leaf
  // one past the descent's depth
  const int depth = (int)a.depth[b];
  const int leaf_pos = expand ? depth + 1 : depth;
  const float value = (a.value_override && a.reuse_hit[b]) ? a.value_override[b] : leaf_value;
  const float disc = a.discount;
  const float* path_reward = a.path_reward + (size_t)b * P;
  auto node_reward = [&](int i) -> float {
    return (expand && i == leaf_pos) ? leaf_reward : path_reward[i];
  };
  for (int i = lane; i < P; i += 32) {
    const bool valid_next = i + 1 < P && i + 1 <= leaf_pos;
    sa[i] = valid_next ? disc : 1.0f;
    sb[i] = valid_next ? node_reward(i + 1) : 0.0f;
  }
  __syncwarp();
  for (int k = 1; k < P; k <<= 1) {
    for (int base = 0; base < P; base += 32) {
      const int i = base + lane;
      float na = 0.0f, nb = 0.0f;
      if (i < P) {
        const float ai = sa[i], bi = sb[i];
        const float a_far = i + k < P ? sa[i + k] : 1.0f;
        const float b_far = i + k < P ? sb[i + k] : 0.0f;
        na = ai * a_far;
        nb = ai * b_far + bi;
      }
      __syncwarp();
      if (i < P) {
        sa[i] = na;
        sb[i] = nb;
      }
      __syncwarp();
    }
  }

  const long long* path = a.path + (size_t)b * P;
  const float* path_vsum = a.path_vsum + (size_t)b * P;
  const float* path_visit = a.path_visit + (size_t)b * P;
  float qmin = INFINITY, qmax = -INFINITY;
  for (int i = lane; i <= leaf_pos && i < P; i += 32) {
    const bool is_leaf = expand && i == leaf_pos;
    const float contrib = sa[i] * value + sb[i];
    const size_t node = (size_t)b * N + (is_leaf ? new_idx : (int)path[i]);
    a.value_sum[node] = a.value_sum[node] + contrib;
    a.visit_count[node] += 1;
    // post-backup node value from the recorded pre-backup stats
    const float pre_vsum = is_leaf ? 0.0f : path_vsum[i];
    const float pre_visit = is_leaf ? 0.0f : path_visit[i];
    const float node_value = (pre_vsum + contrib) / (pre_visit + 1.0f);
    const float q = node_reward(i) + disc * node_value;
    qmin = nan_min(qmin, q);
    qmax = nan_max(qmax, q);
  }
  for (int off = 16; off > 0; off >>= 1) {
    qmin = nan_min(qmin, __shfl_xor_sync(kFullMask, qmin, off));
    qmax = nan_max(qmax, __shfl_xor_sync(kFullMask, qmax, off));
  }
  if (lane == 0) {
    a.vmin_out[b] = nan_min(a.vmin[b], qmin);
    a.vmax_out[b] = nan_max(a.vmax[b], qmax);
  }
}

}  // namespace

// Widest action space and longest path a launch takes.
extern "C" int fused_backup_max_actions() { return kMaxA; }
extern "C" int fused_backup_max_path() { return (int)(kMaxSharedBytes / (2 * sizeof(float))); }

extern "C" int fused_backup_launch(const Args* args, void* stream) {
  const Args& a = *args;
  if (a.B == 0) return 0;
  if (a.A < 1 || a.A > kMaxA || a.P < 2 || a.P > fused_backup_max_path())
    return (int)cudaErrorInvalidValue;
  // fewer warps a block where four warps' tables would not fit
  const size_t warp_bytes = 2 * sizeof(float) * (size_t)a.P;
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * warp_bytes > kMaxSharedBytes) warps >>= 1;
  const size_t shared = warps * warp_bytes;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_backup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((a.B + warps - 1) / warps);
  fused_backup_kernel<<<blocks, warps * 32, shared, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

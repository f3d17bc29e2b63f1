// Native replay-buffer core: prioritized sampling + unroll/target index
// assembly. A copy of lightzero_tpu/buffers/native/replay_core.cpp; the two
// must stay equal, so that the same priorities and seed give the same
// samples in both packages.
//
// Role: the host side of the replay pipeline. It removes the per-sample
// Python loops of GameBuffer._make_batch by emitting gather indices, masks
// and reward sums that numpy fancy-indexing consumes in bulk.
//
// Built as a plain C shared library with g++ -O3 -std=c++17 -shared -fPIC
// at first use (lightzero_tpu_torch/_build.py) and loaded with ctypes
// (lightzero_tpu_torch/buffers/native.py).
#include <cstdint>
#include <cmath>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Prioritized sampling: draw `batch` indices ~ p_i^alpha, return indices and
// max-normalized importance weights (n * P(i))^-beta
// (reference _sample_orig_data, lzero/mcts/buffer/game_buffer.py:105-243).
void sample_prioritized(
    const double* priorities, int64_t n, double alpha, double beta,
    int64_t batch, uint64_t seed, int64_t* out_idx, float* out_weights) {
  std::vector<double> cdf(n);
  double acc = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    acc += std::pow(priorities[i], alpha);
    cdf[i] = acc;
  }
  std::mt19937_64 rng(seed);
  // std::uniform_real_distribution's algorithm is left to the standard
  // library: the JAX package's build of this file and the port's draw the
  // same numbers because the same g++ (libstdc++) builds both.
  std::uniform_real_distribution<double> uni(0.0, acc);
  double wmax = 0.0;
  std::vector<double> probs(batch);
  for (int64_t b = 0; b < batch; ++b) {
    double u = uni(rng);
    int64_t lo = 0, hi = n - 1;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (cdf[mid] < u) lo = mid + 1; else hi = mid;
    }
    out_idx[b] = lo;
    double p = (std::pow(priorities[lo], alpha)) / acc;
    double w = std::pow((double)n * p, -beta);
    probs[b] = w;
    if (w > wmax) wmax = w;
  }
  for (int64_t b = 0; b < batch; ++b)
    out_weights[b] = (float)(probs[b] / (wmax > 0 ? wmax : 1.0));
}

// Unroll/target index assembly for a batch of sampled (episode, pos) pairs.
//
// Inputs are the buffer's flat layout: for each sampled flat transition we
// get its episode start offset in the concatenated arrays (ep_start), the
// episode length (ep_len) and the position within the episode (pos).
//
// Outputs (all row-major):
//   obs_idx      (B, K+1)  flat index of obs at pos+k (clamped; see valid)
//   obs_valid    (B, K+1)  1 if pos+k < T else 0 (targets zero when 0)
//   action_idx   (B, K)    flat index of action at pos+k (clamped)
//   action_pad   (B, K)    1 where the action must be randomly padded
//   mask         (B, K)    reference mask_batch: 1 while pos+k+1 < T
//   reward_sum   (B, K+1)  sum_{i<td_eff} gamma^i r_{pos+k+i}
//   boot_idx     (B, K+1)  flat obs index of the bootstrap obs (clamped)
//   boot_valid   (B, K+1)  1 if the bootstrap obs exists
//   boot_disc    (B, K+1)  gamma^td_eff (0 when invalid)
// (reference _compute_target_reward_value, game_buffer_muzero.py:467-577)
// `truncated[b]`: 1 when the sampled episode was cut by a time limit rather
// than ending in a terminal state — the n-step horizon is then capped at
// T-1 so the tail bootstraps from the last stored obs instead of treating
// beyond-end positions as absorbing zero-value states.
void assemble_unroll(
    const int64_t* ep_start, const int64_t* ep_len, const int64_t* pos,
    const uint8_t* truncated,
    const float* flat_rewards, int64_t batch, int64_t K, int64_t td,
    double gamma,
    int64_t* obs_idx, uint8_t* obs_valid, int64_t* action_idx,
    uint8_t* action_pad, float* mask, float* reward_sum, int64_t* boot_idx,
    uint8_t* boot_valid, float* boot_disc) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t start = ep_start[b];
    const int64_t T = ep_len[b];
    const int64_t p0 = pos[b];
    const int64_t horizon = truncated[b] ? T - 1 : T;
    for (int64_t k = 0; k <= K; ++k) {
      const int64_t t = p0 + k;
      const int64_t row = b * (K + 1) + k;
      const bool in_ep = t < T;
      obs_idx[row] = start + (in_ep ? t : T - 1);
      obs_valid[row] = in_ep ? 1 : 0;
      if (in_ep) {
        int64_t td_eff = td < (horizon - t) ? td : (horizon - t);
        if (td_eff < 0) td_eff = 0;
        double rsum = 0.0, disc = 1.0;
        for (int64_t i = 0; i < td_eff; ++i) {
          rsum += disc * (double)flat_rewards[start + t + i];
          disc *= gamma;
        }
        reward_sum[row] = (float)rsum;
        const int64_t bt = t + td_eff;
        if (bt < T) {
          boot_idx[row] = start + bt;
          boot_valid[row] = 1;
          boot_disc[row] = (float)disc;  // gamma^td_eff
        } else {
          boot_idx[row] = start + T - 1;
          boot_valid[row] = 0;
          boot_disc[row] = 0.0f;
        }
      } else {
        reward_sum[row] = 0.0f;
        boot_idx[row] = start + T - 1;
        boot_valid[row] = 0;
        boot_disc[row] = 0.0f;
      }
      if (k < K) {
        const int64_t arow = b * K + k;
        action_idx[arow] = start + (in_ep ? t : T - 1);
        action_pad[arow] = in_ep ? 0 : 1;
        mask[arow] = (t + 1 < T) ? 1.0f : 0.0f;
      }
    }
  }
}

}  // extern "C"

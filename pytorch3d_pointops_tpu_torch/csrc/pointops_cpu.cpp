// Native host-side (CPU) implementations of the point-cloud operators.
//
// TPU-native framework's counterpart of the reference's CPU kernel layer
// (/root/reference/pytorch3d_pointops/csrc/*_cpu.cpp): an independent C++
// implementation of the same op semantics, used as (a) a fast host-side
// fallback when no accelerator is attached and (b) a second,
// torch/JAX-independent oracle for the dual-implementation tests
// (SURVEY §4 item 1).  Written from scratch against the documented
// semantics (SURVEY §2.4); exposed with a plain C ABI for ctypes.
//
// Threading: ops parallelize over the batch dimension with std::thread,
// capped like the reference's sample_pdf CPU driver
// (csrc/sample_pdf/sample_pdf_cpu.cpp:110-140 caps at 4).
//
// Build: g++ -O3 -march=native -shared -fPIC (see native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

inline int64_t num_threads(int64_t batch) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  return std::min<int64_t>(std::min<int64_t>(hw, 16), batch > 0 ? batch : 1);
}

// Run fn(n) for n in [0, batch) across threads.
template <typename Fn>
void parallel_batch(int64_t batch, Fn fn) {
  int64_t nt = num_threads(batch);
  if (nt <= 1) {
    for (int64_t n = 0; n < batch; ++n) fn(n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int64_t t = 0; t < nt; ++t) {
    threads.emplace_back([=]() {
      for (int64_t n = t; n < batch; n += nt) fn(n);
    });
  }
  for (auto& th : threads) th.join();
}

inline float dist_l2(const float* a, const float* b, int64_t D) {
  float s = 0.f;
  for (int64_t d = 0; d < D; ++d) {
    float diff = a[d] - b[d];
    s += diff * diff;
  }
  return s;
}

inline float dist_l1(const float* a, const float* b, int64_t D) {
  float s = 0.f;
  for (int64_t d = 0; d < D; ++d) s += std::fabs(a[d] - b[d]);
  return s;
}

}  // namespace

extern "C" {

// KNN forward: squared-L2 (norm=2) or L1 (norm=1) brute force with running
// top-K per query.  Outputs sorted ascending; rows past lengths1 and columns
// past min(K, lengths2) are dist=0 idx=0 (reference pad conventions,
// knn.h:29-37 + functions/knn.py:77-89).
void pointops_knn(const float* p1, const float* p2, const int64_t* lengths1,
                  const int64_t* lengths2, int64_t N, int64_t P1, int64_t P2,
                  int64_t D, int64_t K, int norm, float* out_dists,
                  int32_t* out_idx) {
  parallel_batch(N, [=](int64_t n) {
    const float* p1n = p1 + n * P1 * D;
    const float* p2n = p2 + n * P2 * D;
    float* dn = out_dists + n * P1 * K;
    int32_t* in_ = out_idx + n * P1 * K;
    int64_t len1 = lengths1[n], len2 = lengths2[n];
    int64_t kv = std::min<int64_t>(K, len2);
    // (dist, idx) candidate buffer per query, kept sorted via insertion.
    std::vector<float> bd(K);
    std::vector<int32_t> bi(K);
    for (int64_t i = 0; i < P1; ++i) {
      float* di = dn + i * K;
      int32_t* ii = in_ + i * K;
      std::fill(di, di + K, 0.f);
      std::fill(ii, ii + K, 0);
      if (i >= len1 || kv == 0) continue;
      int64_t filled = 0;
      const float* q = p1n + i * D;
      for (int64_t j = 0; j < len2; ++j) {
        float dist = (norm == 1) ? dist_l1(q, p2n + j * D, D)
                                 : dist_l2(q, p2n + j * D, D);
        if (filled < kv) {
          // insertion sort append (first-seen wins on ties: strict <)
          int64_t pos = filled++;
          while (pos > 0 && bd[pos - 1] > dist) {
            bd[pos] = bd[pos - 1];
            bi[pos] = bi[pos - 1];
            --pos;
          }
          bd[pos] = dist;
          bi[pos] = static_cast<int32_t>(j);
        } else if (dist < bd[kv - 1]) {
          int64_t pos = kv - 1;
          while (pos > 0 && bd[pos - 1] > dist) {
            bd[pos] = bd[pos - 1];
            bi[pos] = bi[pos - 1];
            --pos;
          }
          bd[pos] = dist;
          bi[pos] = static_cast<int32_t>(j);
        }
      }
      for (int64_t k = 0; k < kv; ++k) {
        di[k] = bd[k];
        ii[k] = bi[k];
      }
    }
  });
}

// KNN/ball-query backward: d(dist)/d(p1), d(dist)/d(p2) accumulation
// (reference knn.cu:503-515 formulas; idx==-1 and out-of-length entries
// contribute nothing).  Deterministic (serial per batch element).
void pointops_knn_backward(const float* p1, const float* p2,
                           const int64_t* lengths1, const int64_t* lengths2,
                           const int32_t* idx, const float* grad_dists,
                           int64_t N, int64_t P1, int64_t P2, int64_t D,
                           int64_t K, int norm, float* grad_p1,
                           float* grad_p2) {
  std::memset(grad_p1, 0, sizeof(float) * N * P1 * D);
  std::memset(grad_p2, 0, sizeof(float) * N * P2 * D);
  parallel_batch(N, [=](int64_t n) {
    int64_t len1 = lengths1[n], len2 = lengths2[n];
    int64_t kv = std::min<int64_t>(K, len2);
    for (int64_t i = 0; i < std::min(P1, len1); ++i) {
      for (int64_t k = 0; k < kv; ++k) {
        int64_t off = (n * P1 + i) * K + k;
        int32_t j = idx[off];
        if (j < 0) continue;
        float g = grad_dists[off];
        const float* a = p1 + (n * P1 + i) * D;
        const float* b = p2 + (n * P2 + j) * D;
        float* ga = grad_p1 + (n * P1 + i) * D;
        float* gb = grad_p2 + (n * P2 + j) * D;
        for (int64_t d = 0; d < D; ++d) {
          float diff;
          if (norm == 1) {
            diff = g * (a[d] > b[d] ? 1.f : -1.f);
          } else {
            diff = 2.f * g * (a[d] - b[d]);
          }
          ga[d] += diff;
          gb[d] -= diff;
        }
      }
    }
  });
}

// Ball query: first K points (scan order) with dist2 < radius^2
// (ball_query.cu:53-70); idx pad -1, dists pad 0.
void pointops_ball_query(const float* p1, const float* p2,
                         const int64_t* lengths1, const int64_t* lengths2,
                         int64_t N, int64_t P1, int64_t P2, int64_t D,
                         int64_t K, float radius, float* out_dists,
                         int32_t* out_idx) {
  float r2 = radius * radius;
  parallel_batch(N, [=](int64_t n) {
    const float* p1n = p1 + n * P1 * D;
    const float* p2n = p2 + n * P2 * D;
    int64_t len1 = lengths1[n], len2 = lengths2[n];
    for (int64_t i = 0; i < P1; ++i) {
      float* di = out_dists + (n * P1 + i) * K;
      int32_t* ii = out_idx + (n * P1 + i) * K;
      std::fill(di, di + K, 0.f);
      std::fill(ii, ii + K, -1);
      if (i >= len1) continue;
      const float* q = p1n + i * D;
      int64_t count = 0;
      for (int64_t j = 0; j < len2 && count < K; ++j) {
        float dist = dist_l2(q, p2n + j * D, D);
        if (dist < r2) {
          di[count] = dist;
          ii[count] = static_cast<int32_t>(j);
          ++count;
        }
      }
    }
  });
}

// Farthest point sampling: K[n] iterative rounds per cloud, ties to the
// first maximal index (std::max_element semantics,
// sample_farthest_points_cpu.cpp:91-92 convention); idx pad -1.
void pointops_fps(const float* points, const int64_t* lengths,
                  const int64_t* K, const int64_t* start_idxs, int64_t N,
                  int64_t P, int64_t D, int64_t max_K, int32_t* out_idx) {
  parallel_batch(N, [=](int64_t n) {
    const float* pts = points + n * P * D;
    int32_t* out = out_idx + n * max_K;
    std::fill(out, out + max_K, -1);
    int64_t len = lengths[n];
    int64_t k_n = std::min(len, K[n]);
    if (k_n <= 0) return;
    std::vector<float> min_d(len, kInf);
    int64_t sel = start_idxs[n];
    out[0] = static_cast<int32_t>(sel);
    for (int64_t k = 1; k < k_n; ++k) {
      const float* s = pts + sel * D;
      int64_t best = 0;
      float best_d = -kInf;
      for (int64_t j = 0; j < len; ++j) {
        float dist = dist_l2(s, pts + j * D, D);
        if (dist < min_d[j]) min_d[j] = dist;
        if (min_d[j] > best_d) {  // strict >: first max wins
          best_d = min_d[j];
          best = j;
        }
      }
      sel = best;
      out[k] = static_cast<int32_t>(sel);
    }
  });
}

// Packed (F, D) -> padded (N, M, D) using cumulative first_idxs
// (packed_to_padded_tensor.cu:15-43 semantics).
void pointops_packed_to_padded(const float* inputs, const int64_t* first_idxs,
                               int64_t F, int64_t D, int64_t N, int64_t M,
                               float* out) {
  std::memset(out, 0, sizeof(float) * N * M * D);
  parallel_batch(N, [=](int64_t n) {
    int64_t start = first_idxs[n];
    int64_t end = (n + 1 < N) ? first_idxs[n + 1] : F;
    int64_t len = std::min(end - start, M);
    std::memcpy(out + n * M * D, inputs + start * D, sizeof(float) * len * D);
  });
}

// Padded (N, M, D) -> packed (F, D).
void pointops_padded_to_packed(const float* inputs, const int64_t* first_idxs,
                               int64_t N, int64_t M, int64_t D, int64_t F,
                               float* out) {
  parallel_batch(N, [=](int64_t n) {
    int64_t start = first_idxs[n];
    int64_t end = (n + 1 < N) ? first_idxs[n + 1] : F;
    int64_t len = std::min(end - start, M);
    std::memcpy(out + start * D, inputs + n * M * D, sizeof(float) * len * D);
  });
}

// Inverse-CDF sampling (sample_pdf_cpu.cpp semantics): binary search over
// un-normalized partial weight sums, per-bin lerp with the bin_weight>eps /
// overflow-to-bin-end cases.  uniforms (B, S) in [0,1] are consumed and
// samples written to out (B, S).
void pointops_sample_pdf(const float* bins, const float* weights,
                         const float* uniforms, int64_t B, int64_t n_bins,
                         int64_t S, float eps, float* out) {
  parallel_batch(B, [=](int64_t b) {
    const float* w = weights + b * n_bins;
    const float* e = bins + b * (n_bins + 1);
    const float* u = uniforms + b * S;
    float* o = out + b * S;
    std::vector<float> partial(n_bins);
    float acc = 0.f;
    for (int64_t i = 0; i < n_bins; ++i) {
      acc += w[i];
      partial[i] = acc;
    }
    float total = acc + eps;
    for (int64_t s = 0; s < S; ++s) {
      float uu = u[s] * total;
      // lower_bound over partial[0 .. n_bins-2]
      const float* lo =
          std::lower_bound(partial.data(), partial.data() + (n_bins - 1), uu);
      int64_t i_bin = lo - partial.data();
      float prev = (i_bin > 0) ? partial[i_bin - 1] : 0.f;
      float u_rem = uu - prev;
      float bw = w[i_bin];
      float bs = e[i_bin], be = e[i_bin + 1];
      float val;
      if (u_rem > bw) {
        val = be;
      } else if (bw > eps) {
        val = bs + (u_rem / bw) * (be - bs);
      } else {
        val = bs;
      }
      o[s] = val;
    }
  });
}

}  // extern "C"

// Native batch collator of the PyTorch port (ralf_tpu_torch/data/native.py),
// a copy of the JAX package's native/collate.cpp: the same transforms, the
// same std::mt19937_64 stream for a seed, so both give the same batches.
//
// Host-side input-pipeline hot path: per-sample instance transforms
// (shuffle / sort_label / sort_lexicographic) + fixed-shape padding +
// mask construction for a whole batch, in one C++ call instead of
// per-sample Python loops (the reference does this work inside torch
// DataLoader workers — `image2layout/train/data.py:42-117` +
// `helpers/hfds_instance_wise_transforms.py`).
//
// Layout batches arrive as dense [B, S] arrays with per-sample valid
// lengths; all transforms permute only the first `len` elements, exactly
// like the numpy implementation in ralf_tpu_torch/data/transforms.py.
//
// Built at first use by ralf_tpu_torch/data/native.py:
//   g++ -O3 -shared -fPIC collate.cpp -o libralf_collate_<hash>.so

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <random>
#include <vector>

namespace {

struct View {
  int64_t* label;
  float* cx;
  float* cy;
  float* w;
  float* h;
  int S;

  void permute_row(int b, const std::vector<int>& order) {
    const int n = static_cast<int>(order.size());
    std::vector<int64_t> lab(n);
    std::vector<float> tcx(n), tcy(n), tw(n), th(n);
    int64_t* L = label + static_cast<int64_t>(b) * S;
    float* CX = cx + static_cast<int64_t>(b) * S;
    float* CY = cy + static_cast<int64_t>(b) * S;
    float* W = w + static_cast<int64_t>(b) * S;
    float* H = h + static_cast<int64_t>(b) * S;
    for (int i = 0; i < n; ++i) {
      lab[i] = L[order[i]];
      tcx[i] = CX[order[i]];
      tcy[i] = CY[order[i]];
      tw[i] = W[order[i]];
      th[i] = H[order[i]];
    }
    for (int i = 0; i < n; ++i) {
      L[i] = lab[i];
      CX[i] = tcx[i];
      CY[i] = tcy[i];
      W[i] = tw[i];
      H[i] = th[i];
    }
  }
};

}  // namespace

extern "C" {

// In-place batched transforms + mask fill.
// flags: bit0 shuffle, bit1 sort_label, bit2 sort_lexicographic
// (applied in that order, as a transform list names them).
void ralf_collate_batch(int64_t* label, float* cx, float* cy, float* w,
                        float* h, uint8_t* mask, const int32_t* lengths,
                        int32_t B, int32_t S, int32_t flags, uint64_t seed) {
  View v{label, cx, cy, w, h, S};
  std::mt19937_64 rng(seed);

  for (int b = 0; b < B; ++b) {
    const int n = lengths[b];
    uint8_t* M = mask + static_cast<int64_t>(b) * S;
    for (int i = 0; i < S; ++i) M[i] = i < n ? 1 : 0;
    if (n <= 1) continue;

    std::vector<int> order(n);
    std::iota(order.begin(), order.end(), 0);

    if (flags & 1) {  // shuffle
      std::shuffle(order.begin(), order.end(), rng);
      v.permute_row(b, order);
      std::iota(order.begin(), order.end(), 0);
    }
    if (flags & 2) {  // stable sort by label
      const int64_t* L = label + static_cast<int64_t>(b) * S;
      std::stable_sort(order.begin(), order.end(),
                       [&](int i, int j) { return L[i] < L[j]; });
      v.permute_row(b, order);
      std::iota(order.begin(), order.end(), 0);
    }
    if (flags & 4) {  // lexicographic: (top, left) raster order
      const float* CX = cx + static_cast<int64_t>(b) * S;
      const float* CY = cy + static_cast<int64_t>(b) * S;
      const float* W = w + static_cast<int64_t>(b) * S;
      const float* H = h + static_cast<int64_t>(b) * S;
      std::vector<std::pair<float, float>> key(n);
      for (int i = 0; i < n; ++i) {
        key[i] = {CY[i] - H[i] / 2.0f, CX[i] - W[i] / 2.0f};
      }
      std::stable_sort(order.begin(), order.end(), [&](int i, int j) {
        if (key[i].first != key[j].first) return key[i].first < key[j].first;
        return key[i].second < key[j].second;
      });
      v.permute_row(b, order);
    }
    // zero out the padded tail so downstream static-shape ops see a
    // canonical representation
    int64_t* L = label + static_cast<int64_t>(b) * S;
    float* CX = cx + static_cast<int64_t>(b) * S;
    float* CY = cy + static_cast<int64_t>(b) * S;
    float* W = w + static_cast<int64_t>(b) * S;
    float* H = h + static_cast<int64_t>(b) * S;
    for (int i = n; i < S; ++i) {
      L[i] = 0;
      CX[i] = CY[i] = W[i] = H[i] = 0.0f;
    }
  }
}

// Gather K retrieval neighbors per sample from the gallery arrays into
// [B, K, S] batch tensors (one call per batch instead of B*K Python-side
// dataset reads — `helpers/retrieval_dataset_wrapper.py:89-148`).
void ralf_gather_neighbors(const int64_t* g_label, const float* g_cx,
                           const float* g_cy, const float* g_w,
                           const float* g_h, const uint8_t* g_mask,
                           const int64_t* indices, int32_t B, int32_t K,
                           int32_t S, int64_t* o_label, float* o_cx,
                           float* o_cy, float* o_w, float* o_h,
                           uint8_t* o_mask) {
  for (int64_t bk = 0; bk < static_cast<int64_t>(B) * K; ++bk) {
    const int64_t src = indices[bk] * S;
    const int64_t dst = bk * S;
    std::copy(g_label + src, g_label + src + S, o_label + dst);
    std::copy(g_cx + src, g_cx + src + S, o_cx + dst);
    std::copy(g_cy + src, g_cy + src + S, o_cy + dst);
    std::copy(g_w + src, g_w + src + S, o_w + dst);
    std::copy(g_h + src, g_h + src + S, o_h + dst);
    std::copy(g_mask + src, g_mask + src + S, o_mask + dst);
  }
}

}  // extern "C"

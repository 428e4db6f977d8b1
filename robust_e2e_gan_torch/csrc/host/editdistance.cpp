// Edit distance of robust_e2e_gan_torch's host library.
//
// WER/CER scoring: a two-row Levenshtein over int32 token ids, and a
// corpus scorer that splits utterances over threads. Exposed with a C ABI
// for the ctypes binding in robust_e2e_gan_torch/utils/native.py;
// ops/editdistance.py keeps the Python recursion as the plain version. The
// same C entry points as the JAX package's csrc/editdistance.cpp.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Levenshtein distance between two int32 token sequences.
int64_t rg_edit_distance_i32(const int32_t* ref, int64_t n,
                             const int32_t* hyp, int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int64_t> prev(m + 1), cur(m + 1);
  for (int64_t j = 0; j <= m; ++j) prev[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = i;
    const int32_t ri = ref[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t cost = (ri == hyp[j - 1]) ? 0 : 1;
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost});
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

// Corpus scorer: flattened ragged refs/hyps with offsets (CSR layout).
// Writes per-utterance distances into out[n_utts]; returns total errors.
// Threads across utterances (scoring thousands of CHiME-4 utterances after
// a batched decode is host-side work the reference did serially).
int64_t rg_edit_distance_corpus_i32(
    const int32_t* refs, const int64_t* ref_offsets,
    const int32_t* hyps, const int64_t* hyp_offsets,
    int64_t n_utts, int64_t* out, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t u = lo; u < hi; ++u) {
      out[u] = rg_edit_distance_i32(
          refs + ref_offsets[u], ref_offsets[u + 1] - ref_offsets[u],
          hyps + hyp_offsets[u], hyp_offsets[u + 1] - hyp_offsets[u]);
    }
  };
  if (n_threads == 1 || n_utts < 2 * n_threads) {
    work(0, n_utts);
  } else {
    std::vector<std::thread> ts;
    const int64_t chunk = (n_utts + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
      const int64_t lo = t * chunk;
      const int64_t hi = std::min<int64_t>(lo + chunk, n_utts);
      if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  int64_t total = 0;
  for (int64_t u = 0; u < n_utts; ++u) total += out[u];
  return total;
}

}  // extern "C"

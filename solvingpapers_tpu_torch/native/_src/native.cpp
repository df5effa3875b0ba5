// Native runtime hot paths: byte-level BPE (encode + trainer) and the
// token-window batch gather that feeds the device.
//
// Capability target: the reference's tokenize-once-then-train pipeline
// (deepseekv3/deepseekv3.ipynb cells 6-14) runs its BPE through HF's native
// tokenizers; the Python fallback in ../data/bpe.py gives semantics, this
// file gives it framework-grade speed. Exposed as a plain C ABI for ctypes
// (no pybind11 in this environment).
//
// Parity contract (tested in tests/test_native.py):
//   * bpe_encode == ByteBPETokenizer.encode's merge loop, chunk by chunk
//   * bpe_train  == ByteBPETokenizer.train under the canonical tie-break
//     (max count, then smallest (left_id, right_id))
//   * gather_windows == the numpy stack/astype in data/batches.py

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct BpeCtx {
  // pair -> (rank, merged id); rank = index into the merges list
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> pairs;
  int32_t byte_to_id[256];
};

// Apply the classic greedy merge loop to one chunk (lowest-rank adjacent
// pair first, all its occurrences left-to-right per round) — the same loop
// as ByteBPETokenizer._bpe.
void encode_chunk(const BpeCtx& ctx, const uint8_t* bytes, int64_t len,
                  std::vector<int32_t>& out) {
  std::vector<int32_t> word(len);
  for (int64_t i = 0; i < len; ++i) word[i] = ctx.byte_to_id[bytes[i]];
  while (word.size() > 1) {
    int32_t best_rank = INT32_MAX;
    int32_t best_merged = -1;
    uint64_t best_key = 0;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      uint64_t k = pair_key(word[i], word[i + 1]);
      auto it = ctx.pairs.find(k);
      if (it != ctx.pairs.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_merged = it->second.second;
        best_key = k;
      }
    }
    if (best_merged < 0) break;
    std::vector<int32_t> next;
    next.reserve(word.size());
    for (size_t i = 0; i < word.size();) {
      if (i + 1 < word.size() && pair_key(word[i], word[i + 1]) == best_key) {
        next.push_back(best_merged);
        i += 2;
      } else {
        next.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(next);
  }
  out.insert(out.end(), word.begin(), word.end());
}

}  // namespace

extern "C" {

void* bpe_ctx_new(const int32_t* byte_to_id, const int32_t* lefts,
                  const int32_t* rights, const int32_t* merged,
                  int64_t n_merges) {
  auto* ctx = new BpeCtx();
  std::memcpy(ctx->byte_to_id, byte_to_id, 256 * sizeof(int32_t));
  ctx->pairs.reserve(static_cast<size_t>(n_merges) * 2);
  for (int64_t r = 0; r < n_merges; ++r) {
    ctx->pairs.emplace(pair_key(lefts[r], rights[r]),
                       std::make_pair(static_cast<int32_t>(r), merged[r]));
  }
  return ctx;
}

void bpe_ctx_free(void* ctx) { delete static_cast<BpeCtx*>(ctx); }

// Encode n_chunks byte slices (bytes[offsets[i]:offsets[i+1]]) to token ids.
// out_counts (optional, length n_chunks) receives the per-chunk token count
// so callers can cache per-chunk results. Returns total ids written, or
// -(needed) if out_cap is too small (caller retries with a bigger buffer;
// ids are not partially valid in that case).
int64_t bpe_encode(void* vctx, const uint8_t* bytes, const int64_t* offsets,
                   int64_t n_chunks, int32_t* out, int64_t out_cap,
                   int32_t* out_counts, int32_t n_threads) {
  const auto& ctx = *static_cast<BpeCtx*>(vctx);
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(n_chunks, 1));
  std::vector<std::vector<int32_t>> parts(n_threads);
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      int64_t lo = n_chunks * t / n_threads;
      int64_t hi = n_chunks * (t + 1) / n_threads;
      auto& part = parts[t];
      part.reserve((offsets[hi] - offsets[lo]) / 2 + 8);
      for (int64_t c = lo; c < hi; ++c) {
        size_t before = part.size();
        encode_chunk(ctx, bytes + offsets[c], offsets[c + 1] - offsets[c],
                     part);
        if (out_counts)
          out_counts[c] = static_cast<int32_t>(part.size() - before);
      }
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (const auto& p : parts) total += static_cast<int64_t>(p.size());
  if (total > out_cap) return -total;
  int64_t pos = 0;
  for (const auto& p : parts) {
    std::memcpy(out + pos, p.data(), p.size() * sizeof(int32_t));
    pos += static_cast<int64_t>(p.size());
  }
  return total;
}

// BPE trainer over pre-split words (id sequences + frequencies). Merge i
// creates symbol id 256+i (the Python trainer's id assignment). Best pair
// per round: max count, tie-break smallest (left, right) — incremental
// counts with a lazy max-heap, so cost scales with words *touched* per
// merge, not corpus size x vocab size like the Python fallback.
// Returns the number of merges produced (<= n_merges_target).
int64_t bpe_train(const int32_t* words_flat, const int64_t* offsets,
                  const int64_t* freqs, int64_t n_words,
                  int64_t n_merges_target, int64_t min_pair_count,
                  int32_t* out_lefts, int32_t* out_rights) {
  std::vector<std::vector<int32_t>> words(n_words);
  for (int64_t w = 0; w < n_words; ++w) {
    words[w].assign(words_flat + offsets[w], words_flat + offsets[w + 1]);
  }
  std::unordered_map<uint64_t, int64_t> count;
  std::unordered_map<uint64_t, std::vector<int64_t>> where;  // may hold stales
  for (int64_t w = 0; w < n_words; ++w) {
    const auto& word = words[w];
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      uint64_t k = pair_key(word[i], word[i + 1]);
      count[k] += freqs[w];
      auto& lst = where[k];
      if (lst.empty() || lst.back() != w) lst.push_back(w);
    }
  }
  // max-heap entries (count, ~left, ~right, key); stale entries are skipped
  // when their recorded count no longer matches the live count.
  using Entry = std::tuple<int64_t, int32_t, int32_t, uint64_t>;
  std::priority_queue<Entry> heap;
  for (const auto& [k, c] : count) {
    heap.emplace(c, ~static_cast<int32_t>(k >> 32),
                 ~static_cast<int32_t>(k & 0xffffffff), k);
  }
  int64_t n_merges = 0;
  while (n_merges < n_merges_target && !heap.empty()) {
    auto [c, nl, nr, k] = heap.top();
    heap.pop();
    auto it = count.find(k);
    if (it == count.end() || it->second != c) continue;  // stale
    if (c < min_pair_count) break;
    const int32_t left = ~nl, right = ~nr;
    const int32_t merged = static_cast<int32_t>(256 + n_merges);
    out_lefts[n_merges] = left;
    out_rights[n_merges] = right;
    ++n_merges;
    count.erase(it);
    auto wh = where.find(k);
    if (wh == where.end()) continue;
    std::vector<int64_t> touched = std::move(wh->second);
    where.erase(wh);
    std::sort(touched.begin(), touched.end());
    touched.erase(std::unique(touched.begin(), touched.end()), touched.end());
    for (int64_t w : touched) {
      auto& word = words[w];
      bool contains = false;
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        if (word[i] == left && word[i + 1] == right) { contains = true; break; }
      }
      if (!contains) continue;  // stale index entry
      const int64_t f = freqs[w];
      auto bump = [&](uint64_t pk, int64_t delta) {
        if (pk == k) return;  // the merged pair itself is being retired
        int64_t& cc = count[pk];
        cc += delta;
        if (cc <= 0) {
          count.erase(pk);
        } else {
          heap.emplace(cc, ~static_cast<int32_t>(pk >> 32),
                       ~static_cast<int32_t>(pk & 0xffffffff), pk);
        }
      };
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        bump(pair_key(word[i], word[i + 1]), -f);
      }
      std::vector<int32_t> next;
      next.reserve(word.size());
      for (size_t i = 0; i < word.size();) {
        if (i + 1 < word.size() && word[i] == left && word[i + 1] == right) {
          next.push_back(merged);
          i += 2;
        } else {
          next.push_back(word[i]);
          i += 1;
        }
      }
      word.swap(next);
      for (size_t i = 0; i + 1 < word.size(); ++i) {
        uint64_t pk = pair_key(word[i], word[i + 1]);
        bump(pk, f);
        auto& lst = where[pk];
        if (lst.empty() || lst.back() != w) lst.push_back(w);
      }
    }
  }
  return n_merges;
}

// Gather batch windows x=data[s:s+block], y=data[s+1:s+block+1] as int32,
// parallel over rows. dtype_code: 0=uint16, 1=uint32, 2=int32, 3=uint8,
// 4=int64. Runs with the GIL released (ctypes), so a Python-side prefetch
// thread overlaps this with the device step.
void gather_windows(const void* data, int32_t dtype_code,
                    const int64_t* starts, int64_t batch, int64_t block,
                    int32_t* x_out, int32_t* y_out, int32_t n_threads) {
  auto copy_row = [&](int64_t r) {
    const int64_t s = starts[r];
    int32_t* x = x_out + r * block;
    int32_t* y = y_out + r * block;
    switch (dtype_code) {
      case 0: {
        const auto* d = static_cast<const uint16_t*>(data) + s;
        for (int64_t i = 0; i < block; ++i) x[i] = d[i];
        for (int64_t i = 0; i < block; ++i) y[i] = d[i + 1];
        break;
      }
      case 1: {
        const auto* d = static_cast<const uint32_t*>(data) + s;
        for (int64_t i = 0; i < block; ++i) x[i] = static_cast<int32_t>(d[i]);
        for (int64_t i = 0; i < block; ++i)
          y[i] = static_cast<int32_t>(d[i + 1]);
        break;
      }
      case 2: {
        const auto* d = static_cast<const int32_t*>(data) + s;
        std::memcpy(x, d, block * sizeof(int32_t));
        std::memcpy(y, d + 1, block * sizeof(int32_t));
        break;
      }
      case 3: {
        const auto* d = static_cast<const uint8_t*>(data) + s;
        for (int64_t i = 0; i < block; ++i) x[i] = d[i];
        for (int64_t i = 0; i < block; ++i) y[i] = d[i + 1];
        break;
      }
      case 4: {
        const auto* d = static_cast<const int64_t*>(data) + s;
        for (int64_t i = 0; i < block; ++i) x[i] = static_cast<int32_t>(d[i]);
        for (int64_t i = 0; i < block; ++i)
          y[i] = static_cast<int32_t>(d[i + 1]);
        break;
      }
    }
  };
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(batch, 1));
  if (n_threads == 1 || batch < 8) {
    for (int64_t r = 0; r < batch; ++r) copy_row(r);
    return;
  }
  std::vector<std::thread> threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      for (int64_t r = batch * t / n_threads; r < batch * (t + 1) / n_threads;
           ++r)
        copy_row(r);
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"

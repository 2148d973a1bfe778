// Native BPE encode hot loop (engine/bpe.py's C++ twin).
//
// Tokenization runs on the host for every request (and again for every
// routing token count); the merge loop is the only quadratic-ish piece of
// that path.  The port's own copy of the JAX package's bpe_encoder.cc,
// code unchanged.  Semantics are BIT-IDENTICAL to
// BPETokenizer._encode_chunk for ASCII input (the Python caller only
// routes ASCII here: C byte-wise isspace and Python's unicode-aware \s
// agree exactly on ASCII):
//
//   chunks   = /\s*\S+|\s+$/  (a word plus its leading whitespace)
//   per chunk: repeatedly merge the LOWEST-RANK adjacent pair, merging
//   every occurrence of that pair in the chunk, until no pair has a rank.
//
// Merge tables are registered per tokenizer instance and addressed by
// handle, so differently-trained vocabularies coexist in one process.

#include <cstdint>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t kFirstMergeId = 259;   // engine/bpe.py _FIRST_MERGE_ID

std::mutex g_mu;
// deque: push_back never moves existing elements, so a table reference
// taken under the lock stays valid while another thread registers a new
// tokenizer's table concurrently.
std::deque<std::unordered_map<uint64_t, int32_t>>* g_tables =
    new std::deque<std::unordered_map<uint64_t, int32_t>>();

inline uint64_t pair_key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

void encode_chunk(const std::unordered_map<uint64_t, int32_t>& ranks,
                  std::vector<int32_t>& ids) {
  while (ids.size() > 1) {
    int32_t best_rank = INT32_MAX;
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      auto it = ranks.find(pair_key(ids[i], ids[i + 1]));
      if (it != ranks.end() && it->second < best_rank) best_rank = it->second;
    }
    if (best_rank == INT32_MAX) break;
    // Rebuild with EVERY occurrence of the winning pair merged — same as
    // the Python reference's inner rewrite loop.
    int32_t target_rank = best_rank;
    int32_t a = 0, b = 0;
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      auto it = ranks.find(pair_key(ids[i], ids[i + 1]));
      if (it != ranks.end() && it->second == target_rank) {
        a = ids[i];
        b = ids[i + 1];
        break;
      }
    }
    const int32_t new_id = kFirstMergeId + target_rank;
    std::vector<int32_t> out;
    out.reserve(ids.size());
    for (size_t i = 0; i < ids.size();) {
      if (i + 1 < ids.size() && ids[i] == a && ids[i + 1] == b) {
        out.push_back(new_id);
        i += 2;
      } else {
        out.push_back(ids[i]);
        i += 1;
      }
    }
    ids.swap(out);
  }
}

// Python's \s on ASCII: space, \t-\r (0x09-0x0D), AND the file/group/
// record/unit separators 0x1C-0x1F ('\x1c'.isspace() is True).  C's
// isspace() misses the latter, which would silently split chunks
// differently from the Python reference on log-like input.
inline bool is_ws(uint8_t c) {
  return c == 0x20 || (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F);
}

}  // namespace

extern "C" {

// Register a merge table (pairs = [a0,b0,a1,b1,...], rank = index).
// Returns a handle for dllm_bpe_encode.
int dllm_bpe_load(const int32_t* pairs, int n_merges) {
  std::unordered_map<uint64_t, int32_t> table;
  table.reserve(static_cast<size_t>(n_merges) * 2);
  for (int i = 0; i < n_merges; ++i)
    table.emplace(pair_key(pairs[2 * i], pairs[2 * i + 1]), i);
  std::lock_guard<std::mutex> lk(g_mu);
  g_tables->push_back(std::move(table));
  return static_cast<int>(g_tables->size()) - 1;
}

// Encode `len` bytes of ASCII text into `out` (capacity `cap` ids).
// Returns the id count, or -1 on bad handle / overflow (caller falls
// back to Python).
int dllm_bpe_encode(int handle, const uint8_t* text, int len, int32_t* out,
                    int cap) {
  const std::unordered_map<uint64_t, int32_t>* ranks;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    if (handle < 0 || handle >= static_cast<int>(g_tables->size())) return -1;
    ranks = &(*g_tables)[handle];
  }
  int n_out = 0;
  std::vector<int32_t> ids;
  int i = 0;
  while (i < len) {
    const int start = i;
    while (i < len && is_ws(text[i])) ++i;
    while (i < len && !is_ws(text[i])) ++i;
    // A pure-whitespace tail is its own chunk (/\s+$/), same as Python.
    if (i == start) break;
    ids.assign(text + start, text + i);
    encode_chunk(*ranks, ids);
    if (n_out + static_cast<int>(ids.size()) > cap) return -1;
    for (int32_t id : ids) out[n_out++] = id;
  }
  return n_out;
}

}  // extern "C"

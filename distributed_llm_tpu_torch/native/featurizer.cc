// Native featurizer: hashed n-gram text features for the routing embedder.
//
// The host-side hot loop of routing/embedder.py: per-word hashing on
// EVERY routed query and semantic-cache lookup, in C++17 behind a C ABI
// bound with ctypes.  The port's own copy of the JAX package's
// featurizer.cc, code unchanged.
//
// Parity contract with the Python twin (routing/embedder.py::_features)
// is EXACT: same CRC-32 (zlib polynomial) hashing, same tokenization
// ([a-z0-9']+ runs over lowercased bytes), same possessive stripping,
// same stopword set and weights; tests assert bit-identical vectors.
//
// Built by native/__init__.py at first use (g++ -O3 -shared -fPIC
// -std=c++17, with bpe_encoder.cc) into build/native/; a failed build
// raises.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

// CRC-32 (IEEE 802.3, the zlib/crc32 polynomial), table-driven — must match
// Python's zlib.crc32 exactly.
uint32_t kCrcTable[256];
bool kCrcInit = []() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    kCrcTable[i] = c;
  }
  return true;
}();

uint32_t Crc32(const std::string& s) {
  uint32_t c = 0xFFFFFFFFu;
  for (unsigned char ch : s) c = kCrcTable[(c ^ ch) & 0xFFu] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

const std::unordered_set<std::string>& Stopwords() {
  static const std::unordered_set<std::string> kSet = {
      "a", "an", "and", "are", "as", "at", "be", "but", "by", "can", "could",
      "did", "do", "does", "for", "from", "had", "has", "have", "he", "her",
      "his", "how", "i", "if", "in", "is", "it", "its", "may", "me", "my",
      "of", "on", "or", "our", "she", "should", "so", "that", "the", "their",
      "them", "they", "this", "to", "us", "was", "we", "were", "what", "when",
      "where", "which", "who", "why", "will", "with", "would", "you", "your"};
  return kSet;
}

// double, not float: the Python reference does its weight arithmetic in
// float64 and only rounds on store into the float32 vector — bit parity
// requires the same (e.g. 0.4*0.15 differs between fp32 and fp64 rounding).
constexpr double kStopWeight = 0.15;
constexpr double kBigramWeight = 0.4;
constexpr double kTrigramWeight = 0.15;

// [a-z0-9']+ runs over bytewise-lowercased input (non-ASCII bytes are
// delimiters, matching the Python regex on ASCII-range text).
std::vector<std::string> Tokenize(const char* text) {
  std::vector<std::string> words;
  std::string cur;
  for (const unsigned char* p = (const unsigned char*)text; *p; ++p) {
    unsigned char c = *p;
    if (c >= 'A' && c <= 'Z') c += 'a' - 'A';
    if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '\'') {
      cur.push_back((char)c);
    } else if (!cur.empty()) {
      words.push_back(std::move(cur));
      cur.clear();
    }
  }
  if (!cur.empty()) words.push_back(std::move(cur));

  // Possessive stripping: trailing "'s" dropped, other apostrophes removed.
  for (auto& w : words) {
    size_t n = w.size();
    if (n >= 2 && w[n - 2] == '\'' && w[n - 1] == 's') {
      w.resize(n - 2);
    } else {
      std::string out;
      out.reserve(n);
      for (char ch : w)
        if (ch != '\'') out.push_back(ch);
      w = std::move(out);
    }
  }
  return words;
}

void Bump(float* vec, int dim, const std::string& token, double weight) {
  uint32_t h = Crc32(token);
  double sign = ((h >> 16) & 1u) ? 1.0 : -1.0;
  uint32_t idx = h % (uint32_t)dim;
  vec[idx] = (float)((double)vec[idx] + sign * weight);
}

}  // namespace

extern "C" {

// Fill out[dim] with the signed hashed bag of word 1/2-grams + char
// trigrams for one text.  out must be zeroed by the caller.
void dllm_featurize(const char* text, float* out, int dim) {
  const auto& stop = Stopwords();
  std::vector<std::string> words = Tokenize(text);

  for (const auto& w : words)
    Bump(out, dim, "u:" + w, stop.count(w) ? kStopWeight : 1.0);

  for (size_t i = 0; i + 1 < words.size(); ++i) {
    double wgt = kBigramWeight;
    if (stop.count(words[i]) && stop.count(words[i + 1])) wgt *= kStopWeight;
    Bump(out, dim, "b:" + words[i] + "_" + words[i + 1], wgt);
  }

  std::string squashed;
  for (const auto& w : words)
    if (!stop.count(w)) squashed += w;
  for (size_t i = 0; i + 2 < squashed.size(); ++i)
    Bump(out, dim, "c:" + squashed.substr(i, 3), kTrigramWeight);
}

// Batch entry: texts[n] NUL-terminated strings -> out[n * dim], zeroed by
// the caller.
void dllm_featurize_batch(const char** texts, int n, float* out, int dim) {
  for (int i = 0; i < n; ++i) dllm_featurize(texts[i], out + (size_t)i * dim, dim);
}

int dllm_abi_version() { return 2; }   // 2: + bpe_encoder.cc

}  // extern "C"

// Native text-processing kernels (host C++, built with g++ by the port's
// native.py).
//
// A copy of the JAX package's native/text_native.cpp, unchanged apart from
// comments. Hot paths of the text pipeline behind a C ABI for ctypes:
//
//   * tokenize_spans  — \w+ word-span scanner (the tokenizer inner loop)
//   * ascii_lower     — case folding
//   * count_syllables — the vowel-run estimator of text.processor
//   * WordPiece       — greedy longest-match subword encoder with a
//                       preloaded vocab hash (the embedding tokenizer's
//                       per-word hot loop)
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC -o libtss_native.so
//        text_native.cpp trie_builder.cpp

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

inline bool is_word_byte(unsigned char c) {
  // ASCII alnum + underscore; any non-ASCII byte counts as a word byte
  // (UTF-8 continuation/lead bytes — matches \w's unicode behaviour for
  // letter scripts closely enough for span finding).
  return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z') ||
         (c >= 'a' && c <= 'z') || c == '_' || c >= 0x80;
}

}  // namespace

extern "C" {

// Find word spans [start, end) of \w+ runs. Returns the number of tokens
// written (capped at max_tokens); pass nullptr arrays to count only.
int64_t tss_tokenize_spans(const char* text, int64_t len, int32_t* starts,
                           int32_t* ends, int64_t max_tokens) {
  int64_t count = 0;
  int64_t i = 0;
  while (i < len) {
    if (is_word_byte(static_cast<unsigned char>(text[i]))) {
      int64_t start = i;
      while (i < len && is_word_byte(static_cast<unsigned char>(text[i]))) ++i;
      if (starts != nullptr) {
        if (count >= max_tokens) return count;
        starts[count] = static_cast<int32_t>(start);
        ends[count] = static_cast<int32_t>(i);
      }
      ++count;
    } else {
      ++i;
    }
  }
  return count;
}

void tss_ascii_lower(const char* in, int64_t len, char* out) {
  for (int64_t i = 0; i < len; ++i) {
    char c = in[i];
    out[i] = (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
  }
}

// Vowel-run syllable estimator (text.processor.count_syllables): count
// vowel runs, silent-e discount, min 1.
int32_t tss_count_syllables(const char* word, int64_t len) {
  auto is_vowel = [](char c) {
    c = (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
    return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' || c == 'y';
  };
  int32_t count = 0;
  bool prev = false;
  for (int64_t i = 0; i < len; ++i) {
    bool v = is_vowel(word[i]);
    if (v && !prev) ++count;
    prev = v;
  }
  if (len > 0) {
    char last = word[len - 1];
    last = (last >= 'A' && last <= 'Z') ? static_cast<char>(last + 32) : last;
    if (last == 'e' && count > 1) --count;
  }
  return count > 0 ? count : 1;
}

// ---------------------------------------------------------------------------
// WordPiece
// ---------------------------------------------------------------------------

struct WordPiece {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id;
  int64_t max_chars;
};

void* tss_wp_create(const char* pieces, const int32_t* ids, int64_t n,
                    int32_t unk_id, int64_t max_chars) {
  // `pieces` is a single buffer of NUL-separated strings.
  auto* wp = new WordPiece{};
  wp->unk_id = unk_id;
  wp->max_chars = max_chars;
  wp->vocab.reserve(static_cast<size_t>(n) * 2);
  const char* p = pieces;
  for (int64_t i = 0; i < n; ++i) {
    size_t l = std::strlen(p);
    wp->vocab.emplace(std::string(p, l), ids[i]);
    p += l + 1;
  }
  return wp;
}

void tss_wp_free(void* handle) { delete static_cast<WordPiece*>(handle); }

// Greedy longest-match WordPiece for one word. Writes piece ids to `out`
// (capacity max_out). Returns the piece count, or -1 meaning [UNK].
int64_t tss_wp_encode_word(void* handle, const char* word, int64_t len,
                           int32_t* out, int64_t max_out) {
  auto* wp = static_cast<WordPiece*>(handle);
  if (len > wp->max_chars) return -1;
  std::string buf;  // reused for "##" + substring lookups
  int64_t count = 0;
  int64_t start = 0;
  while (start < len) {
    int64_t end = len;
    int32_t piece_id = -1;
    while (start < end) {
      buf.clear();
      if (start > 0) buf.append("##");
      buf.append(word + start, static_cast<size_t>(end - start));
      auto it = wp->vocab.find(buf);
      if (it != wp->vocab.end()) {
        piece_id = it->second;
        break;
      }
      --end;
    }
    if (piece_id < 0) return -1;
    if (count >= max_out) return count;
    out[count++] = piece_id;
    start = end;
  }
  return count;
}

// Batch encode: text -> word spans -> lowercase -> wordpiece ids, in one
// native pass (the full serving-tokenizer hot loop). Returns total ids
// written into `out` (capped at max_out).
int64_t tss_wp_encode_text(void* handle, const char* text, int64_t len,
                           int32_t* out, int64_t max_out) {
  auto* wp = static_cast<WordPiece*>(handle);
  int64_t total = 0;
  int64_t i = 0;
  std::string lowered;
  while (i < len && total < max_out) {
    if (!is_word_byte(static_cast<unsigned char>(text[i]))) {
      ++i;
      continue;
    }
    int64_t start = i;
    while (i < len && is_word_byte(static_cast<unsigned char>(text[i]))) ++i;
    lowered.assign(text + start, static_cast<size_t>(i - start));
    for (auto& c : lowered)
      if (c >= 'A' && c <= 'Z') c = static_cast<char>(c + 32);
    int64_t n = tss_wp_encode_word(handle, lowered.data(),
                                   static_cast<int64_t>(lowered.size()),
                                   out + total, max_out - total);
    if (n < 0) {
      out[total++] = wp->unk_id;
    } else {
      total += n;
    }
  }
  return total;
}

}  // extern "C"

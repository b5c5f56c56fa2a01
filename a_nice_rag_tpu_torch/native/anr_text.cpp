// Native BM25 text preprocessing (host hot path).
//
// C++ implementation of a_nice_rag_tpu_torch.text.preprocess.preprocess_text:
// lowercase -> delete ASCII punctuation -> whitespace tokenize -> drop
// stopwords/numerics/single-chars -> optional morphy-style noun
// lemmatization (irregular table + guards + suffix rules). Exposed with
// a C ABI consumed through ctypes; token/irregular/stopword tables are
// generated from the Python source of truth (anr_text_tables.h).
//
// Unicode note: the Python path lowercases the full Unicode range; this
// fast path lowercases ASCII only and passes other bytes through. The
// Python implementation stays authoritative; parity is exact for ASCII
// inputs (clinical guideline text is ASCII-dominated).

#include <cctype>
#include <cstring>
#include <string>
#include <vector>

#include "anr_text_tables.h"

namespace {

bool is_ascii_punct(unsigned char c) {
  // Mirrors Python's string.punctuation.
  return std::strchr("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~", c) != nullptr;
}

bool all_digits(const std::string& s) {
  if (s.empty()) return false;
  for (unsigned char c : s)
    if (!std::isdigit(c)) return false;
  return true;
}

struct Rule {
  const char* suffix;
  const char* repl;
};

// Morphy noun rules; order mirrors text/preprocess.py (calibrated
// against real NLTK outputs — see that module's comments).
const Rule kMorphyRules[] = {
    {"sses", "ss"}, {"ches", "ch"}, {"shes", "sh"}, {"xes", "x"},
    {"zes", "z"},   {"ies", "y"},   {"s", ""},
};

bool ends_with(const std::string& s, const char* suffix) {
  size_t n = std::strlen(suffix);
  return s.size() >= n && s.compare(s.size() - n, n, suffix) == 0;
}

std::string lemmatize(const std::string& tok) {
  // Observed real-NLTK outputs override the rule path (lexicon-
  // membership decisions; see text/lemma_calibration.py).
  auto cal = kCalibrated.find(tok);
  if (cal != kCalibrated.end()) return cal->second;
  auto irr = kIrregular.find(tok);
  if (irr != kIrregular.end()) return irr->second;
  if (tok.size() <= 3 || kNoLemma.count(tok)) return tok;
  if (ends_with(tok, "ss") || ends_with(tok, "us") || ends_with(tok, "is"))
    return tok;
  for (const Rule& r : kMorphyRules) {
    if (ends_with(tok, r.suffix)) {
      std::string lemma =
          tok.substr(0, tok.size() - std::strlen(r.suffix)) + r.repl;
      if (lemma.size() >= 2) return lemma;
      return tok;
    }
  }
  return tok;
}

}  // namespace

extern "C" {

// Preprocess `text` into '\n'-separated tokens written to `out`
// (capacity `out_cap`). Returns the number of bytes written, or -1 if
// the output buffer is too small.
int anr_preprocess(const char* text, int use_lemmatization, char* out,
                   int out_cap) {
  if (text == nullptr) return 0;
  std::string cleaned;
  cleaned.reserve(std::strlen(text));
  for (const char* p = text; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (is_ascii_punct(c)) continue;  // deletion merges, matching translate()
    cleaned.push_back(
        c < 128 ? static_cast<char>(std::tolower(c)) : static_cast<char>(c));
  }

  int written = 0;
  bool overflow = false;
  auto emit = [&](std::string tok) {
    if (overflow || tok.size() <= 1) return;
    if (kStopwords.count(tok)) return;
    if (all_digits(tok)) return;
    if (use_lemmatization) tok = lemmatize(tok);
    int need = static_cast<int>(tok.size()) + 1;
    if (written + need >= out_cap) {
      overflow = true;
      return;
    }
    std::memcpy(out + written, tok.data(), tok.size());
    written += static_cast<int>(tok.size());
    out[written++] = '\n';
  };

  size_t i = 0;
  const size_t n = cleaned.size();
  std::string tok;
  while (i < n) {
    while (i < n && std::isspace(static_cast<unsigned char>(cleaned[i]))) i++;
    size_t start = i;
    while (i < n && !std::isspace(static_cast<unsigned char>(cleaned[i]))) i++;
    if (i == start) break;
    tok.assign(cleaned, start, i - start);
    // NLTK contraction splits ("cannot" -> can + not); each half goes
    // through the normal filters.
    auto split = kContractionSplits.find(tok);
    if (split != kContractionSplits.end()) {
      emit(split->second.first);
      emit(split->second.second);
    } else {
      emit(tok);
    }
    if (overflow) return -1;
  }
  return written;
}

}  // extern "C"

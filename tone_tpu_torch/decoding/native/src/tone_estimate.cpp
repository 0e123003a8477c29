// First-party n-gram LM estimation, native twin of decoding/estimate.py
// (the port's copy of the JAX package's source; interpolated modified Kneser-Ney with
// lmplz-style pruning).  The Python estimator is the semantic reference —
// this file mirrors it step for step (counting, adjusted counts, discounts,
// pruning with closure repair, bottom-up interpolation, <s>/<unk>
// handling) so the two emit the same model up to float rounding; the fuzz
// test pins that (tests/test_estimate.py, tests/test_torch_artifacts_cli.py).  Exists for corpus scale: the
// pure-Python loop is ~8 s per 1M tokens; this path is tokenize-to-ARPA
// native end to end on flat open-addressing tables (no node allocations —
// a std::unordered_map<std::string,...> first cut measured SLOWER than
// CPython's dicts).
//
// Reference context: the published kenlm.bin is built with the external
// KenLM lmplz tool (reference tone/decoder.py:84-95); here estimation is
// in-framework.
//
// Built at first use by decoding/native/estimate.py (ops/_build.py GxxLibrary).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using Count = long long;

inline uint64_t mix64(uint64_t x) {  // splitmix64 finalizer
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

inline uint64_t hash_ids(const int32_t* ids, int width) {
  uint64_t h = 0x9e3779b97f4a7c15ULL;
  for (int i = 0; i < width; ++i) h = mix64(h ^ (uint32_t)ids[i]);
  return h;
}

// Open-addressing hash map with inline fixed-width int32 keys (one n-gram
// per slot, no per-node allocation).  Linear probing, power-of-two
// capacity, grows at 60% load.  V is Count or double.
template <typename V>
struct FlatMap {
  int width = 1;
  std::vector<int32_t> keys;  // cap*width; slot empty iff used[slot]==0
  std::vector<V> vals;
  std::vector<uint8_t> used;
  size_t cap = 0, count = 0;

  explicit FlatMap(int w = 1, size_t expect = 16) : width(w) { rehash_to(expect); }

  void rehash_to(size_t expect) {
    size_t want = 16;
    while (want * 3 < expect * 5) want <<= 1;  // ~60% max load
    std::vector<int32_t> ok = std::move(keys);
    std::vector<V> ov = std::move(vals);
    std::vector<uint8_t> ou = std::move(used);
    size_t ocap = cap;
    cap = want;
    keys.assign(cap * width, 0);
    vals.assign(cap, V());
    used.assign(cap, 0);
    count = 0;
    for (size_t s = 0; s < ocap; ++s)
      if (ou[s]) slot_for(&ok[s * width], true, ov[s]);
  }

  // Find (or insert) the slot for key; when inserting, seed with v0.
  // Returns pointer to the value, or nullptr if absent and !insert.
  V* slot_for(const int32_t* key, bool insert, V v0 = V()) {
    size_t mask = cap - 1;
    size_t s = hash_ids(key, width) & mask;
    while (true) {
      if (!used[s]) {
        if (!insert) return nullptr;
        used[s] = 1;
        std::memcpy(&keys[s * width], key, (size_t)width * 4);
        vals[s] = v0;
        ++count;
        if (count * 5 > cap * 3) {
          rehash_to(count * 2);
          return slot_for(key, false);  // re-find after rehash
        }
        return &vals[s];
      }
      if (!std::memcmp(&keys[s * width], key, (size_t)width * 4))
        return &vals[s];
      s = (s + 1) & mask;
    }
  }

  V* find(const int32_t* key) { return slot_for(key, false); }
  V& get(const int32_t* key, V v0 = V()) { return *slot_for(key, true, v0); }
  bool erase(const int32_t* key) {
    // Linear-probing erase via backward-shift deletion.
    size_t mask = cap - 1;
    size_t s = hash_ids(key, width) & mask;
    while (used[s]) {
      if (!std::memcmp(&keys[s * width], key, (size_t)width * 4)) {
        size_t hole = s, n = (s + 1) & mask;
        while (used[n]) {
          size_t home = hash_ids(&keys[n * width], width) & mask;
          // can n's entry legally move into the hole?
          bool between = hole <= n ? (home <= hole || home > n)
                                   : (home <= hole && home > n);
          if (between) {
            std::memcpy(&keys[hole * width], &keys[n * width],
                        (size_t)width * 4);
            vals[hole] = vals[n];
            hole = n;
          }
          n = (n + 1) & mask;
        }
        used[hole] = 0;
        --count;
        return true;
      }
      s = (s + 1) & mask;
    }
    return false;
  }

  template <typename F>
  void for_each(F f) const {
    for (size_t s = 0; s < cap; ++s)
      if (used[s]) f(&keys[s * width], vals[s]);
  }
};

// Lowercase ASCII + Cyrillic (А-Я -> а-я, Ё -> ё) in-place on UTF-8 bytes —
// the scripts the label set covers (tone/decoder.py:23); other code points
// pass through.  Matches Python str.lower() on these ranges.
void lower_utf8(std::string& s) {
  for (size_t i = 0; i < s.size(); ++i) {
    unsigned char c = s[i];
    if (c >= 'A' && c <= 'Z') {
      s[i] = (char)(c + 32);
    } else if (c == 0xD0 && i + 1 < s.size()) {
      unsigned char d = s[i + 1];
      if (d >= 0x90 && d <= 0x9F) {        // А-П -> а-п
        s[i + 1] = (char)(d + 0x20);
      } else if (d >= 0xA0 && d <= 0xAF) { // Р-Я -> р-я
        s[i] = (char)0xD1;
        s[i + 1] = (char)(d - 0x20);
      } else if (d == 0x81) {              // Ё -> ё
        s[i] = (char)0xD1;
        s[i + 1] = (char)0x91;
      }
      ++i;
    } else if (c >= 0xC0) {
      // skip the rest of this multi-byte code point
      while (i + 1 < s.size() && ((unsigned char)s[i + 1] & 0xC0) == 0x80) ++i;
    }
  }
}

struct Estimator {
  int order;
  std::vector<std::string> words;                // id -> word
  std::unordered_map<std::string, int32_t> ids;  // word -> id
  int32_t bos = 0, eos = 0;
  double gamma0 = 0.0;  // unigram-level leftover mass (context = empty)
  std::string error;

  int32_t intern(const std::string& w) {
    auto it = ids.find(w);
    if (it != ids.end()) return it->second;
    int32_t id = (int32_t)words.size();
    ids.emplace(w, id);
    words.push_back(w);
    return id;
  }

  bool fail(const std::string& msg) {
    error = msg;
    return false;
  }

  // --- counting (estimate.py _count) ------------------------------------
  std::vector<FlatMap<Count>> raw;
  bool count_file(const char* path) {
    std::ifstream in(path, std::ios::binary);
    if (!in) return fail("cannot open corpus file");
    bos = intern("<s>");
    eos = intern("</s>");
    raw.clear();
    for (int n = 1; n <= order; ++n) raw.emplace_back(n, 1 << 16);
    std::string line;
    bool any = false;
    std::vector<int32_t> toks;
    while (std::getline(in, line)) {
      if (!line.empty() && line.back() == '\r') line.pop_back();
      lower_utf8(line);
      toks.clear();
      toks.push_back(bos);
      size_t i = 0;
      while (i < line.size()) {
        while (i < line.size() && (line[i] == ' ' || line[i] == '\t')) ++i;
        size_t j = i;
        while (j < line.size() && line[j] != ' ' && line[j] != '\t') ++j;
        if (j > i) {
          std::string w = line.substr(i, j - i);
          if (w == "<s>" || w == "</s>")
            return fail("corpus contains reserved token " + w);
          toks.push_back(intern(w));
        }
        i = j;
      }
      if (toks.size() == 1) continue;  // blank line: skipped (estimate_from_text)
      any = true;
      toks.push_back(eos);
      for (int n = 1; n <= order; ++n) {
        FlatMap<Count>& t = raw[n - 1];
        for (size_t k = 0; k + n <= toks.size(); ++k)
          ++t.get(toks.data() + k);
      }
    }
    if (!any) return fail("empty corpus");
    return true;
  }

  // --- adjusted counts (estimate.py _adjust) -----------------------------
  std::vector<FlatMap<Count>> adjusted;
  void adjust() {
    adjusted.clear();
    for (int n = 1; n <= order; ++n) adjusted.emplace_back(n, 16);
    for (int n = order - 1; n >= 1; --n) {
      FlatMap<Count>& cont = adjusted[n - 1];
      cont.rehash_to(raw[n].count);
      raw[n].for_each([&](const int32_t* g, Count) { ++cont.get(g + 1); });
      raw[n - 1].for_each([&](const int32_t* g, Count c) {
        if (g[0] == bos && !cont.find(g)) cont.get(g) = c;
      });
      if (n < order - 1)  // the top raw table IS adjusted[order-1]; keep it
        raw[n] = FlatMap<Count>(n + 1);  // free as we go
    }
    adjusted[order - 1] = std::move(raw[order - 1]);
    raw.clear();
  }
};

struct D3 { double d1, d2, d3; };

// Modified-KN discounts (estimate.py _discounts): closed form from the
// adjusted count-of-counts, with conservative fallbacks/clamps.
D3 mkn_discounts(const FlatMap<Count>& counts) {
  Count t[6] = {0, 0, 0, 0, 0, 0};
  counts.for_each([&](const int32_t*, Count c) {
    if (c <= 4) ++t[c];
  });
  D3 fallback{0.5, 1.0, 1.5};
  if (!t[1] || !t[2]) return fallback;
  double y = (double)t[1] / ((double)t[1] + 2.0 * (double)t[2]);
  double out[3];
  const double defaults[3] = {0.5, 1.0, 1.5};
  for (int k = 1; k <= 3; ++k) {
    if (!t[k] || !t[k + 1]) {
      out[k - 1] = defaults[k - 1];
      continue;
    }
    double d = k - (k + 1.0) * y * (double)t[k + 1] / (double)t[k];
    out[k - 1] = std::min(std::max(d, 1e-6), k - 1e-6);
  }
  return {out[0], out[1], out[2]};
}

// --- pruning (estimate.py _prune) ----------------------------------------
bool prune_tables(std::vector<FlatMap<Count>>& adjusted, int order,
                  const Count* prune, int n_prune, std::string& error) {
  if (n_prune <= 0) return true;
  if (n_prune > order) {
    error = "more prune thresholds than orders";
    return false;
  }
  std::vector<Count> p(prune, prune + n_prune);
  while ((int)p.size() < order) p.push_back(p.back());
  if (p[0] != 0) {
    error = "unigrams cannot be pruned (threshold must be 0)";
    return false;
  }
  for (size_t i = 1; i < p.size(); ++i)
    if (p[i - 1] > p[i]) {
      error = "prune thresholds must be non-decreasing";
      return false;
    }
  FlatMap<Count> forced(1, 16);  // value unused; presence set
  for (int n = order - 1; n >= 0; --n) {
    FlatMap<Count> kept(n + 1, adjusted[n].count);
    adjusted[n].for_each([&](const int32_t* g, Count c) {
      if (c > p[n] || forced.find(g)) kept.get(g) = c;
    });
    adjusted[n] = std::move(kept);
    if (n > 0) {
      FlatMap<Count> next_forced(n, adjusted[n].count * 2);
      adjusted[n].for_each([&](const int32_t* g, Count) {
        next_forced.get(g + 1);       // suffix
        next_forced.get(g);           // context prefix (first n ids)
      });
      forced = std::move(next_forced);
    }
  }
  return true;
}

struct ArpaEntry {
  const int32_t* gram;  // borrowed from the prob table's key slab
  double log_p;
  double log_b;         // 0.0 = omit
};

}  // namespace

extern "C" {

// Estimate an interpolated modified-KN LM from a text corpus (one sentence
// per line; lowercased; whitespace-tokenized) and write a standard ARPA
// file.  prune: per-order thresholds (lmplz --prune semantics) or
// n_prune=0 for none.  Returns the total n-gram count written, or -1 with
// a message in err.
long long tone_estimate_arpa(const char* corpus_path, int order,
                             const long long* prune, int n_prune,
                             const char* out_path, char* err, int err_cap) {
  auto report = [&](const std::string& m) -> long long {
    if (err && err_cap > 0) std::snprintf(err, (size_t)err_cap, "%s", m.c_str());
    return -1;
  };
  if (order < 1) return report("order must be >= 1");
  Estimator est;
  est.order = order;
  if (!est.count_file(corpus_path)) return report(est.error);
  est.adjust();

  // <s> is never a legal prediction (estimate.py:170-175).
  bool had_bos = est.adjusted[0].erase(&est.bos);

  // Discounts from pre-pruning count-of-counts.
  std::vector<D3> ds;
  ds.reserve(order);
  for (int n = 0; n < order; ++n) ds.push_back(mkn_discounts(est.adjusted[n]));

  std::string error;
  if (!prune_tables(est.adjusted, order, prune, n_prune, error))
    return report(error);

  double n_predictable = (double)est.adjusted[0].count + 1.0;

  // Bottom-up interpolated probabilities (estimate.py:184-214).
  std::vector<FlatMap<double>> probs, gammas;
  for (int n = 0; n < order; ++n) {
    probs.emplace_back(n + 1, est.adjusted[n].count);
    gammas.emplace_back(std::max(n, 1), 16);
  }
  for (int n = 0; n < order; ++n) {
    FlatMap<Count>& counts = est.adjusted[n];
    const D3 d = ds[n];
    auto discount = [&](Count c) -> double {
      return c == 0 ? 0.0 : c == 1 ? d.d1 : c == 2 ? d.d2 : d.d3;
    };
    // denom and mass keyed by the (possibly empty) context.  Order-0
    // context is empty: track as two scalars instead of a 0-width map.
    FlatMap<double> denom(std::max(n, 1), counts.count);
    FlatMap<double> mass(std::max(n, 1), counts.count);
    double denom0 = 0.0, mass0 = 0.0;
    counts.for_each([&](const int32_t* g, Count c) {
      if (n == 0) {
        denom0 += (double)c;
        mass0 += discount(c);
      } else {
        denom.get(g) += (double)c;  // context = first n ids of the key
        mass.get(g) += discount(c);
      }
    });
    auto& p_n = probs[n];
    counts.for_each([&](const int32_t* g, Count c) {
      double dn = n == 0 ? denom0 : *denom.find(g);
      double ms = n == 0 ? mass0 : *mass.find(g);
      double u = ((double)c - discount(c)) / dn;
      double gamma = ms / dn;
      double lower = n == 0 ? 1.0 / n_predictable : *probs[n - 1].find(g + 1);
      p_n.get(g) = u + gamma * lower;
    });
    if (n == 0) {
      est.gamma0 = mass0 / denom0;  // gammas[0] has only the empty context
    } else {
      auto& g_n = gammas[n];
      g_n.rehash_to(denom.count);
      denom.for_each([&](const int32_t* ctx, double dn) {
        g_n.get(ctx) = *mass.find(ctx) / dn;
      });
    }
  }

  // <unk> and <s> specials (estimate.py:216-219).
  int32_t unk = est.intern("<unk>");
  probs[0].get(&unk) = est.gamma0 * (1.0 / n_predictable);
  if (had_bos || order > 1) probs[0].get(&est.bos) = 0.0;

  // Assemble per-order ARPA entries (estimate.py:221-227 + write_arpa).
  std::vector<std::vector<ArpaEntry>> entries(order);
  long long total = 0;
  for (int n = 0; n < order; ++n) {
    entries[n].reserve(probs[n].count);
    probs[n].for_each([&](const int32_t* g, double p) {
      double log_p = p > 0 ? std::log10(p) : -99.0;
      double log_b = 0.0;
      if (n + 1 < order) {
        double* bo = gammas[n + 1].find(g);
        if (bo && *bo != 0.0) log_b = std::log10(*bo);
      }
      entries[n].push_back({g, log_p, log_b});
    });
    // Tuple-of-words order (Python sorted(table)); UTF-8 byte comparison
    // of individual words equals code-point comparison.
    const auto& w = est.words;
    int width = n + 1;
    std::sort(entries[n].begin(), entries[n].end(),
              [&](const ArpaEntry& a, const ArpaEntry& b) {
                for (int i = 0; i < width; ++i)
                  if (a.gram[i] != b.gram[i]) {
                    int c = w[a.gram[i]].compare(w[b.gram[i]]);
                    if (c) return c < 0;
                  }
                return false;
              });
    total += (long long)entries[n].size();
  }

  std::FILE* f = std::fopen(out_path, "wb");
  if (!f) return report("cannot open output file");
  std::fprintf(f, "\\data\\\n");
  for (int n = 0; n < order; ++n)
    std::fprintf(f, "ngram %d=%zu\n", n + 1, entries[n].size());
  for (int n = 0; n < order; ++n) {
    std::fprintf(f, "\n\\%d-grams:\n", n + 1);
    for (const auto& e : entries[n]) {
      std::fprintf(f, "%.7f\t", e.log_p);
      for (int i = 0; i <= n; ++i) {
        std::fputs(est.words[e.gram[i]].c_str(), f);
        if (i < n) std::fputc(' ', f);
      }
      if (e.log_b != 0.0) std::fprintf(f, "\t%.7f", e.log_b);
      std::fputc('\n', f);
    }
  }
  std::fprintf(f, "\n\\end\\\n");
  std::fclose(f);
  return total;
}

}  // extern "C"

// Native CTC prefix beam search with word n-gram LM shallow fusion.
//
// First-party replacement for the reference's pyctcdecode + KenLM stack
// (reference tone/decoder.py:108-133): identical algorithm to the Python
// implementation in tone_tpu_torch/decoding/beam.py (tests assert equality), at
// production speed.  Exposed via a C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC tone_decode.cpp -o libtone_decode.so
// (tone_tpu_torch/decoding/native/beamsearch.py builds it at first use).
//
// A copy of tone_tpu/decoding/native/src/tone_decode.cpp, kept in this
// package so that the port builds and loads a library of its own.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <stdexcept>
#include <sstream>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
constexpr double kLog10ToLn = 2.302585092994046;

inline double logaddexp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// ---------------------------------------------------------------------------
// Word n-gram LM interface: log10 scores with Katz backoff.
// ---------------------------------------------------------------------------

struct LM {
  int order = 0;
  virtual ~LM() = default;
  // -1 = out of vocabulary.
  virtual int32_t word_id(const std::string& w) const = 0;
  // log10 P(word | context); context = word ids, most recent last.
  virtual float score(const int32_t* context, int ctx_len,
                      int32_t word) const = 0;
};

// ---------------------------------------------------------------------------
// ARPA text LM (string-keyed tables).
// ---------------------------------------------------------------------------

struct NGramLM : LM {
  std::unordered_map<std::string, int32_t> vocab;
  // ngrams[k]: key = concatenated word ids ((k+1) * 4 bytes) -> (prob, backoff)
  std::vector<std::unordered_map<std::string, std::pair<float, float>>> ngrams;
  int32_t unk_id = -1;
  float unk_floor = -10.0f;

  int32_t word_id(const std::string& w) const override {
    auto it = vocab.find(w);
    return it == vocab.end() ? -1 : it->second;
  }

  static std::string key_of(const int32_t* ids, int n) {
    return std::string(reinterpret_cast<const char*>(ids), n * sizeof(int32_t));
  }

  float score(const int32_t* context, int ctx_len, int32_t word) const override {
    if (word < 0) {
      if (unk_id < 0) return unk_floor;
      word = unk_id;
    }
    if (ctx_len > order - 1) {
      context += ctx_len - (order - 1);
      ctx_len = order - 1;
    }
    float backoff_sum = 0.0f;
    std::vector<int32_t> gram(ctx_len + 1);
    for (int start = 0; start <= ctx_len; ++start) {
      int n = ctx_len - start + 1;
      for (int i = 0; i < n - 1; ++i) gram[i] = context[start + i];
      gram[n - 1] = word;
      if (n <= order) {
        auto& table = ngrams[n - 1];
        auto it = table.find(key_of(gram.data(), n));
        if (it != table.end()) return it->second.first + backoff_sum;
      }
      if (n - 1 > 0) {
        auto& ctx_table = ngrams[n - 2];
        auto it = ctx_table.find(key_of(context + start, n - 1));
        if (it != ctx_table.end()) backoff_sum += it->second.second;
      }
    }
    // unigram fallback (word guaranteed present or unk)
    auto it = ngrams[0].find(key_of(&word, 1));
    if (it != ngrams[0].end()) return it->second.first + backoff_sum;
    return unk_floor;
  }
};

NGramLM* load_arpa(const char* path) {
  std::ifstream in(path);
  if (!in) return nullptr;
  auto lm = std::make_unique<NGramLM>();
  std::string line;
  int section = 0;
  while (std::getline(in, line)) {
    // trim \r and whitespace
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n' ||
                             line.back() == ' ' || line.back() == '\t'))
      line.pop_back();
    if (line.empty()) continue;
    if (line[0] == '\\') {
      if (line.find("-grams:") != std::string::npos) {
        section = std::stoi(line.substr(1));
        while ((int)lm->ngrams.size() < section) lm->ngrams.emplace_back();
      } else if (line.rfind("\\end\\", 0) == 0) {
        break;
      }
      continue;
    }
    if (section == 0) continue;
    std::istringstream ss(line);
    float prob;
    if (!(ss >> prob)) continue;
    std::vector<int32_t> ids(section);
    std::string w;
    bool ok = true;
    for (int i = 0; i < section; ++i) {
      if (!(ss >> w)) { ok = false; break; }
      auto it = lm->vocab.find(w);
      int32_t id;
      if (it == lm->vocab.end()) {
        id = (int32_t)lm->vocab.size();
        lm->vocab.emplace(w, id);
      } else {
        id = it->second;
      }
      ids[i] = id;
    }
    if (!ok) continue;
    float backoff = 0.0f;
    ss >> backoff;  // absent => stays 0
    lm->ngrams[section - 1][NGramLM::key_of(ids.data(), section)] = {prob, backoff};
  }
  if (lm->ngrams.empty()) return nullptr;
  lm->order = (int)lm->ngrams.size();
  auto it = lm->vocab.find("<unk>");
  lm->unk_id = it == lm->vocab.end() ? -1 : it->second;
  return lm.release();
}

// ---------------------------------------------------------------------------
// KenLM binary LM (probing / rest-probing format; see
// tone_tpu_torch/decoding/kenlm_binary.py for the layout documentation).
// Tables are kept in their on-disk probing-hash layout and probed directly —
// zero rehash cost at load, identical lookup behavior to KenLM itself.
// ---------------------------------------------------------------------------

#pragma pack(push, 4)
struct VocabEntry { uint64_t key; uint32_t value; };
struct ProbBackoff { float prob; float backoff; };
struct RestWeights { float prob; float backoff; float rest; };
struct MiddleEntry { uint64_t key; float prob; float backoff; };
struct MiddleRestEntry { uint64_t key; float prob; float backoff; float rest; };
struct LongestEntry { uint64_t key; float prob; };
#pragma pack(pop)

inline uint64_t murmur64a(const void* key, size_t len, uint64_t seed = 0) {
  const uint64_t m = 0xc6a4a7935bd1e995ull;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const unsigned char* data = static_cast<const unsigned char*>(key);
  size_t n8 = len & ~size_t(7);
  for (size_t i = 0; i < n8; i += 8) {
    uint64_t k;
    std::memcpy(&k, data + i, 8);
    k *= m; k ^= k >> r; k *= m;
    h ^= k; h *= m;
  }
  uint64_t tail = 0;
  if (len & 7) {
    std::memcpy(&tail, data + n8, len & 7);
    h ^= tail; h *= m;
  }
  h ^= h >> r; h *= m; h ^= h >> r;
  return h;
}

inline uint64_t combine_word_hash(uint64_t current, uint32_t word_id) {
  return (current * 8978948897894561157ull) ^
         ((uint64_t)(1 + word_id) * 17894857484156487943ull);
}

template <class Entry>
const Entry* probing_find(const std::vector<Entry>& table, uint64_t key) {
  if (table.empty()) return nullptr;
  uint64_t n = table.size();
  for (uint64_t i = key % n;; i = (i + 1 == n ? 0 : i + 1)) {
    if (table[i].key == key) return &table[i];
    if (table[i].key == 0) return nullptr;
  }
}

struct KenLMProbing : LM {
  std::vector<VocabEntry> vocab;                 // probing layout
  std::vector<ProbBackoff> unigram;              // indexed by word id
  std::vector<std::vector<MiddleEntry>> middle;  // orders 2..order-1
  std::vector<LongestEntry> longest;             // order n

  int32_t word_id(const std::string& w) const override {
    uint64_t h = murmur64a(w.data(), w.size());
    static const uint64_t unk1 = murmur64a("<unk>", 5);
    static const uint64_t unk2 = murmur64a("<UNK>", 5);
    if (h == unk1 || h == unk2) return 0;
    const VocabEntry* e = probing_find(vocab, h);
    return e ? (int32_t)e->value : -1;
  }

  float score(const int32_t* context, int ctx_len, int32_t word) const override {
    uint32_t w = word < 0 ? 0u : (uint32_t)word;
    if (w >= unigram.size()) w = 0;
    if (ctx_len > order - 1) {
      context += ctx_len - (order - 1);
      ctx_len = order - 1;
    }
    auto cid = [&](int k) {  // k-th most recent context word id
      int32_t c = context[ctx_len - 1 - k];
      uint32_t u = c < 0 ? 0u : (uint32_t)c;
      return u >= unigram.size() ? 0u : u;
    };
    // Longest match, extending one context word at a time (KenLM order).
    float prob = -std::fabs(unigram[w].prob);
    int matched = 1;
    uint64_t node = w;
    for (int k = 0; k < ctx_len; ++k) {
      node = combine_word_hash(node, cid(k));
      int n = k + 2;
      if (n < order) {
        const MiddleEntry* e = probing_find(middle[n - 2], node);
        if (e == nullptr) break;
        prob = -std::fabs(e->prob);
        matched = n;
      } else {
        const LongestEntry* e = probing_find(longest, node);
        if (e != nullptr) {
          prob = -std::fabs(e->prob);
          matched = n;
        }
        break;
      }
    }
    // Backoff weights of context grams at least as long as the match.
    float backoff = 0.0f;
    uint64_t cnode = 0;
    for (int k = 0; k < ctx_len; ++k) {
      int clen = k + 1;
      if (clen == 1) {
        cnode = cid(k);
        if (clen >= matched) backoff += unigram[cid(k)].backoff;
        continue;
      }
      cnode = combine_word_hash(cnode, cid(k));
      if (clen >= matched && clen < order) {
        const MiddleEntry* e = probing_find(middle[clen - 2], cnode);
        if (e != nullptr) backoff += e->backoff;
      }
    }
    return prob + backoff;
  }
};

inline uint64_t probing_buckets(uint64_t entries, float multiplier) {
  uint64_t scaled = (uint64_t)(multiplier * (float)entries);
  return entries + 1 > scaled ? entries + 1 : scaled;
}

KenLMProbing* load_kenlm(const char* path) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return nullptr;
  std::vector<char> buf((std::istreambuf_iterator<char>(in)),
                        std::istreambuf_iterator<char>());
  static const char kMagic[] = "mmap lm http://kheafield.com/code format version 5\n";
  constexpr size_t kMagicPad = 56, kSanity = 88, kFixed = 20;
  if (buf.size() < kSanity + kFixed + 8 ||
      std::memcmp(buf.data(), kMagic, sizeof(kMagic) - 1) != 0)
    return nullptr;
  uint8_t order = (uint8_t)buf[kSanity];
  float multiplier;
  uint32_t model_type;
  uint8_t has_vocab;
  std::memcpy(&multiplier, buf.data() + kSanity + 4, 4);
  std::memcpy(&model_type, buf.data() + kSanity + 8, 4);
  has_vocab = (uint8_t)buf[kSanity + 12];
  (void)has_vocab;
  (void)kMagicPad;
  if (order < 1 || (model_type != 0 && model_type != 1)) return nullptr;
  bool rest = model_type == 1;
  std::vector<uint64_t> counts(order);
  std::memcpy(counts.data(), buf.data() + kSanity + kFixed, 8 * order);
  size_t off = (kSanity + kFixed + 8 * order + 7) & ~size_t(7);

  auto lm = std::make_unique<KenLMProbing>();
  lm->order = order;

  auto need = [&](size_t bytes) {
    if (off + bytes > buf.size()) throw std::length_error("truncated");
    const char* p = buf.data() + off;
    off += bytes;
    return p;
  };
  try {
    need(8);  // vocab bound (unused: ids are validated against unigram size)
    uint64_t vb = probing_buckets(counts[0], multiplier);
    lm->vocab.resize(vb);
    std::memcpy(lm->vocab.data(), need(vb * sizeof(VocabEntry)),
                vb * sizeof(VocabEntry));

    lm->unigram.resize(counts[0] + 1);
    if (rest) {
      const char* p = need((counts[0] + 1) * sizeof(RestWeights));
      for (uint64_t i = 0; i <= counts[0]; ++i) {
        RestWeights rw;
        std::memcpy(&rw, p + i * sizeof(RestWeights), sizeof(RestWeights));
        lm->unigram[i] = {rw.prob, rw.backoff};
      }
    } else {
      std::memcpy(lm->unigram.data(), need((counts[0] + 1) * sizeof(ProbBackoff)),
                  (counts[0] + 1) * sizeof(ProbBackoff));
    }

    for (int n = 2; n < (int)order; ++n) {
      uint64_t nb = probing_buckets(counts[n - 1], multiplier);
      std::vector<MiddleEntry> table(nb);
      if (rest) {
        const char* p = need(nb * sizeof(MiddleRestEntry));
        for (uint64_t i = 0; i < nb; ++i) {
          MiddleRestEntry e;
          std::memcpy(&e, p + i * sizeof(MiddleRestEntry), sizeof(e));
          table[i] = {e.key, e.prob, e.backoff};
        }
      } else {
        std::memcpy(table.data(), need(nb * sizeof(MiddleEntry)),
                    nb * sizeof(MiddleEntry));
      }
      uint64_t found = 0;
      for (const auto& e : table) found += e.key != 0;
      if (found != counts[n - 1]) return nullptr;
      lm->middle.push_back(std::move(table));
    }
    if (order > 1) {
      uint64_t nb = probing_buckets(counts[order - 1], multiplier);
      lm->longest.resize(nb);
      std::memcpy(lm->longest.data(), need(nb * sizeof(LongestEntry)),
                  nb * sizeof(LongestEntry));
      uint64_t found = 0;
      for (const auto& e : lm->longest) found += e.key != 0;
      if (found != counts[order - 1]) return nullptr;
    }
  } catch (const std::length_error&) {
    return nullptr;
  }
  return lm.release();
}

// Sniff the file magic: KenLM binary vs ARPA text.
LM* load_lm(const char* path) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return nullptr;
  char head[8] = {0};
  in.read(head, 8);
  in.close();
  if (std::memcmp(head, "mmap lm ", 8) == 0) return load_kenlm(path);
  return load_arpa(path);
}

// ---------------------------------------------------------------------------
// CTC prefix beam search (identical semantics to tone_tpu_torch/decoding/beam.py).
// ---------------------------------------------------------------------------

inline uint64_t hash_step(uint64_t h, int32_t x) {
  h ^= (uint64_t)(uint32_t)x;
  h *= 1099511628211ull;
  return h;
}
constexpr uint64_t kHashSeed = 1469598103934665603ull;

struct Beam {
  std::vector<int32_t> seq;   // collapsed label ids; spaces appear only after
                              // completed (non-empty) words
  uint64_t hash = kHashSeed;  // incremental FNV hash of seq
  bool last_space = false;    // last emitted symbol was a space (leading and
                              // duplicate spaces never enter seq)
  double p_b = kNegInf;       // prefix ends in blank
  double p_nb = kNegInf;      // prefix ends in non-blank
  double lm_score = 0.0;      // accumulated LM + hotword contribution (ln)
  std::vector<int32_t> ctx;   // word-id history for the LM (-1 = OOV)
  int word_start = 0;         // index in seq where the in-progress word begins
  int32_t hw_node = 0;        // hotword automaton node
  double hw_tent = 0.0;       // retractable hotword boost

  double total() const { return logaddexp(p_b, p_nb) + lm_score; }
};

// A candidate key: the source beam's sequence, optionally extended by one
// label — compared without materializing the extended vector.
struct CandKey {
  uint64_t h;
  const std::vector<int32_t>* base;
  int32_t extra;  // -1 = no extension
  bool last_space;

  size_t len() const { return base->size() + (extra >= 0 ? 1 : 0); }
  int32_t at(size_t i) const {
    return i < base->size() ? (*base)[i] : extra;
  }
  bool operator==(const CandKey& o) const {
    if (h != o.h || last_space != o.last_space || len() != o.len()) return false;
    for (size_t i = 0, n = len(); i < n; ++i)
      if (at(i) != o.at(i)) return false;
    return true;
  }
};

struct CandHash {
  size_t operator()(const CandKey& k) const {
    return (size_t)(k.h ^ (k.last_space ? 0x9e3779b97f4a7c15ull : 0));
  }
};

struct Decoder {
  std::vector<std::string> labels;  // UTF-8 per label id
  int space_id = -1;
};

// labels_joined: n_labels UTF-8 strings separated by '\n'.
bool parse_labels(const char* labels_joined, int n_labels, Decoder& dec) {
  std::string all(labels_joined);
  size_t pos = 0;
  for (int i = 0; i < n_labels; ++i) {
    size_t nl = all.find('\n', pos);
    std::string lab = all.substr(pos, nl == std::string::npos
                                          ? std::string::npos
                                          : nl - pos);
    dec.labels.push_back(lab);
    if (lab == " ") dec.space_id = i;
    if (nl == std::string::npos) break;
    pos = nl + 1;
  }
  return (int)dec.labels.size() == n_labels;
}

// word string from seq[start, end)
std::string word_of(const Decoder& dec, const std::vector<int32_t>& seq,
                    int start, int end) {
  std::string w;
  for (int i = start; i < end; ++i) w += dec.labels[seq[i]];
  return w;
}

// ---------------------------------------------------------------------------
// Hotword (contextual-biasing) automaton — the native twin of
// tone_tpu_torch/decoding/hotwords.py.  A character trie over label ids; each beam
// carries (node, tentative boost); matching chars add `weight` tentatively,
// a word boundary on a terminal node commits, and falling off rematches the
// longest word-aligned suffix still on a hotword path (Aho–Corasick-style
// failure links), else retracts and parks until the next boundary.
// ---------------------------------------------------------------------------

struct Hotwords {
  double weight = 10.0;
  int space_id = -1;
  std::vector<std::unordered_map<int32_t, int32_t>> children;
  std::vector<uint8_t> terminal;
  // Failure machinery (exact twin of hotwords.py _build_links):
  // goto_: fail-chain-resolved transitions consulted when the direct child
  // is missing; tent_at: tentative outstanding at a node on any path;
  // full: a fresh match's total value (weight * depth).
  std::vector<std::unordered_map<int32_t, int32_t>> goto_;
  std::vector<double> tent_at;
  std::vector<double> full;
  // depth (chars) per node, and per node the lengths of its proper
  // word-aligned suffixes that are complete hotwords — each commits its
  // full value at a word boundary where the longer match dies.
  std::vector<int32_t> depth_;
  std::vector<std::vector<int32_t>> term_suf_lens;

  // phrases_joined: '\n'-separated UTF-8 phrases. Every code point must be a
  // label (single-code-point labels, as parse_labels produces).
  bool build(const Decoder& dec, const char* phrases_joined) {
    space_id = dec.space_id;
    children.assign(1, {});
    terminal.assign(1, 0);
    std::vector<std::vector<int32_t>> paths(1);
    std::unordered_map<std::string, int32_t> label_id;
    for (size_t i = 0; i < dec.labels.size(); ++i)
      label_id[dec.labels[i]] = (int32_t)i;
    std::string all(phrases_joined);
    size_t pos = 0;
    bool any = false;
    while (pos < all.size()) {
      size_t nl = all.find('\n', pos);
      std::string phrase = all.substr(
          pos, nl == std::string::npos ? std::string::npos : nl - pos);
      pos = nl == std::string::npos ? all.size() : nl + 1;
      if (phrase.empty()) continue;
      int32_t node = 0;
      size_t i = 0;
      while (i < phrase.size()) {
        size_t j = i + 1;  // UTF-8 code point: continuation bytes are 10xxxxxx
        while (j < phrase.size() && (phrase[j] & 0xC0) == 0x80) ++j;
        auto it = label_id.find(phrase.substr(i, j - i));
        if (it == label_id.end()) return false;  // char outside the label set
        auto child = children[node].find(it->second);
        if (child == children[node].end()) {
          int32_t nxt = (int32_t)children.size();
          children[node][it->second] = nxt;
          children.emplace_back();
          terminal.push_back(0);
          paths.push_back(paths[node]);
          paths.back().push_back(it->second);
          node = nxt;
        } else {
          node = child->second;
        }
        i = j;
      }
      terminal[node] = 1;
      any = true;
    }
    if (any) build_links(paths);
    return any;
  }

  // Word-aligned failure links + per-node boost values — the exact twin of
  // hotwords.py _build_links (see there for the derivation).
  void build_links(const std::vector<std::vector<int32_t>>& paths) {
    size_t n = children.size();
    std::map<std::vector<int32_t>, int32_t> node_of;
    for (size_t i = 0; i < n; ++i) node_of[paths[i]] = (int32_t)i;
    std::vector<int32_t> fail(n, -1);
    tent_at.assign(n, 0.0);
    full.assign(n, 0.0);
    depth_.assign(n, 0);
    term_suf_lens.assign(n, {});
    for (size_t i = 0; i < n; ++i) {
      const auto& s = paths[i];
      full[i] = weight * (double)s.size();
      depth_[i] = (int32_t)s.size();
      for (size_t k = 1; k < s.size(); ++k) {  // ascending k = longest first
        if (s[k - 1] != space_id) continue;
        auto it = node_of.find({s.begin() + k, s.end()});
        if (it != node_of.end()) {
          if (fail[i] < 0) fail[i] = it->second;
          if (terminal[it->second])
            term_suf_lens[i].push_back((int32_t)(s.size() - k));
        }
      }
      size_t last_commit = 0;
      for (size_t j = s.size(); j-- > 1;) {  // deepest committed boundary
        if (s[j] == space_id &&
            terminal[node_of[{s.begin(), s.begin() + j}]]) {
          last_commit = j;
          break;
        }
      }
      tent_at[i] = weight * (double)(s.size() - last_commit);
    }
    goto_.assign(n, {});
    std::vector<int32_t> order(n);
    for (size_t i = 0; i < n; ++i) order[i] = (int32_t)i;
    std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
      return paths[a].size() < paths[b].size();
    });
    for (int32_t i : order) {  // fail targets are shorter: already resolved
      int32_t f = fail[i];
      if (f < 0) continue;
      goto_[i] = goto_[f];
      for (const auto& kv : children[f]) goto_[i][kv.first] = kv.second;
    }
  }

  // Advance on one emitted label; updates (node, tent) in place and returns
  // the score delta (mirrors hotwords.py HotwordScorer.step exactly).
  // Node -1 = parked (mid-word after a mismatch) until the next boundary.
  double step(int32_t& node, double& tent, int32_t label) const {
    if (node < 0) {  // parked: matches only begin at word starts
      if (label == space_id) {
        node = 0;
        tent = 0.0;
      }
      return 0.0;
    }
    bool commit = label == space_id && terminal[node];
    auto it = children[node].find(label);
    if (it != children[node].end()) {
      if (commit) {
        // Completed hotword with a continuing longer phrase: commit what's
        // accrued; only the continuation (this space) stays tentative.
        node = it->second;
        tent = weight;
        return weight;
      }
      node = it->second;
      tent += weight;
      return weight;
    }
    auto gt = goto_[node].find(label);
    if (gt != goto_[node].end()) {
      // Fell off this match: re-enter at the longest word-aligned suffix
      // still on a hotword path.  A commit keeps its accrued boost;
      // otherwise the old tentative retracts against the fresh value.
      // At a boundary, terminal suffixes longer than the rematch target
      // also complete here — commit them (shorter ones are inside the
      // fresh value already).
      double bonus = 0.0;
      if (label == space_id) {
        int32_t keep = depth_[gt->second] - 1;
        for (int32_t L : term_suf_lens[node])
          if (L > keep) bonus += weight * (double)L;
      }
      double d = full[gt->second] + bonus - (commit ? 0.0 : tent);
      node = gt->second;
      tent = tent_at[node];
      return d;
    }
    double d = commit ? 0.0 : -tent;
    if (label == space_id) {
      // The match dies at this boundary with no rematch: word-aligned
      // suffixes that are complete hotwords still finished as words here.
      for (int32_t L : term_suf_lens[node]) d += weight * (double)L;
      node = 0;  // rearm for the next word
      tent = 0.0;
      return d;
    }
    node = -1;  // park until the next boundary
    tent = 0.0;
    return d;
  }
};

double lm_word_contrib(const LM* lm, double alpha, double beta,
                       const std::vector<int32_t>& ctx, int32_t word_id) {
  if (lm == nullptr) return 0.0;
  double s = lm->score(ctx.data(), (int)ctx.size(), word_id);
  return alpha * s * kLog10ToLn + beta;
}

// The search as carried state: advance() consumes frames as they arrive,
// result() reads the current best without finalizing.  Prefix beam search is
// frame-sequential, so feeding frames incrementally is exactly the batch
// pass (the Python twin in tone_tpu_torch/decoding/beam.py has the same shape).
struct StreamingBeamSearch {
  Decoder dec;
  const LM* lm = nullptr;
  const Hotwords* hw = nullptr;
  double alpha = 0.4, beta = 0.9, token_min_logp = -5.0;
  int beam_width = 200;

  std::vector<Beam> beams;
  // scratch, reused across frames
  std::unordered_map<CandKey, Beam, CandHash> next;
  std::vector<int> tokens;

  void reset() {
    beams.assign(1, Beam());
    if (lm != nullptr) beams[0].ctx.push_back(lm->word_id("<s>"));
    beams[0].p_b = 0.0f;
  }

  void advance(const float* logprobs, int t_max, int n_classes);
  std::string result() const;
  // up to n (score, text) pairs, best first, stripped and deduplicated —
  // the same final ranking result() uses
  std::vector<std::pair<double, std::string>> nbest(int n) const;
};

std::string beam_search(const Decoder& dec, const float* logprobs, int t_max,
                        int n_classes, const LM* lm, double alpha,
                        double beta, int beam_width, double token_min_logp,
                        const Hotwords* hw = nullptr) {
  StreamingBeamSearch s;
  s.dec = dec;
  s.lm = lm;
  s.hw = hw;
  s.alpha = alpha;
  s.beta = beta;
  s.beam_width = beam_width;
  s.token_min_logp = token_min_logp;
  s.next.reserve(4096);
  s.reset();
  s.advance(logprobs, t_max, n_classes);
  return s.result();
}

void StreamingBeamSearch::advance(const float* logprobs, int t_max,
                                  int n_classes) {
  const int blank = n_classes - 1;
  tokens.reserve(n_classes);

  for (int t = 0; t < t_max; ++t) {
    const float* frame = logprobs + (size_t)t * n_classes;
    tokens.clear();
    int best_tok = 0;
    for (int c = 1; c < n_classes; ++c)
      if (frame[c] > frame[best_tok]) best_tok = c;
    for (int c = 0; c < n_classes; ++c)
      if (frame[c] >= token_min_logp || c == best_tok) tokens.push_back(c);

    next.clear();
    // Candidate keys reference the (stable) source beams' sequences; the
    // extended vector is only materialized on first insertion.
    // hw_label: label to feed the hotword automaton (-1 = no emission /
    // collapsed space).  hw state is a pure function of the candidate key's
    // emitted text, so merged sources always agree on it.
    auto merge = [&](const Beam& src, int32_t extra, bool last_space,
                     double p_b, double p_nb, bool new_word,
                     int32_t completed_word, int new_word_start,
                     int32_t hw_label) {
      CandKey key{extra >= 0 ? hash_step(src.hash, extra) : src.hash,
                  &src.seq, extra, last_space};
      auto it = next.find(key);
      if (it != next.end()) {
        it->second.p_b = logaddexp(it->second.p_b, p_b);
        it->second.p_nb = logaddexp(it->second.p_nb, p_nb);
        return;
      }
      Beam nb;
      nb.seq = src.seq;
      if (extra >= 0) nb.seq.push_back(extra);
      nb.hash = key.h;
      nb.last_space = last_space;
      nb.p_b = p_b;
      nb.p_nb = p_nb;
      nb.ctx = src.ctx;
      nb.word_start = new_word_start;
      if (new_word) {
        nb.lm_score = src.lm_score +
            lm_word_contrib(lm, alpha, beta, src.ctx, completed_word);
        if (lm != nullptr && completed_word != INT32_MIN)
          nb.ctx.push_back(completed_word);
      } else {
        nb.lm_score = src.lm_score;
      }
      nb.hw_node = src.hw_node;
      nb.hw_tent = src.hw_tent;
      if (hw != nullptr && hw_label >= 0)
        nb.lm_score += hw->step(nb.hw_node, nb.hw_tent, hw_label);
      next.emplace(key, std::move(nb));
    };

    for (const Beam& beam : beams) {
      double p_total = logaddexp(beam.p_b, beam.p_nb);
      // python-parity "last_char": a letter, a space, or nothing (initial)
      int32_t last = beam.last_space
                         ? dec.space_id
                         : (beam.seq.empty() ? -1 : beam.seq.back());
      for (int tok : tokens) {
        double p = frame[tok];
        if (tok == blank) {
          merge(beam, -1, beam.last_space, p_total + p, kNegInf, false, 0,
                beam.word_start, -1);
          continue;
        }
        double src_p;
        if (tok == last) {
          // extend the run (same collapsed prefix)
          merge(beam, -1, beam.last_space, kNegInf, beam.p_nb + p, false, 0,
                beam.word_start, -1);
          src_p = beam.p_b;  // new symbol only after explicit blank
        } else {
          src_p = p_total;
        }
        if (src_p == kNegInf) continue;
        if (tok == dec.space_id) {
          bool has_word = (int)beam.seq.size() > beam.word_start;
          if (has_word) {
            int32_t wid = INT32_MIN;
            if (lm != nullptr) {
              std::string w = word_of(dec, beam.seq, beam.word_start,
                                      (int)beam.seq.size());
              wid = lm->word_id(w);
            }
            merge(beam, tok, true, kNegInf, src_p + p, true, wid,
                  (int)beam.seq.size() + 1, tok);
          } else {
            // empty word: the space is dropped from the prefix (leading /
            // duplicate spaces), only the last_space flag is set
            merge(beam, -1, true, kNegInf, src_p + p, false, 0,
                  beam.word_start, -1);
          }
        } else {
          merge(beam, tok, false, kNegInf, src_p + p, false, 0,
                beam.word_start, tok);
        }
      }
    }

    // prune to beam_width: total desc, tie-break on text asc (UTF-8 byte
    // order == code-point order, matching the Python implementation)
    std::vector<Beam> pruned;
    pruned.reserve(next.size());
    for (auto& kv : next) pruned.push_back(std::move(kv.second));
    auto cmp = [&](const Beam& a, const Beam& b) {
      double ta = a.total(), tb = b.total();
      if (ta != tb) return ta > tb;
      size_t n = std::min(a.seq.size(), b.seq.size());
      for (size_t i = 0; i < n; ++i)
        if (a.seq[i] != b.seq[i])
          return dec.labels[a.seq[i]] < dec.labels[b.seq[i]];
      if (a.seq.size() != b.seq.size()) return a.seq.size() < b.seq.size();
      return a.last_space < b.last_space;
    };
    if ((int)pruned.size() > beam_width) {
      std::nth_element(pruned.begin(), pruned.begin() + beam_width, pruned.end(),
                       cmp);
      pruned.resize(beam_width);
    }
    beams = std::move(pruned);
  }
}

std::string StreamingBeamSearch::result() const {
  // score trailing partial words for the ranking, pick the best
  const Beam* best = nullptr;
  double best_score = kNegInf;
  auto text_less = [&](const Beam& a, const Beam& b) {
    size_t n = std::min(a.seq.size(), b.seq.size());
    for (size_t i = 0; i < n; ++i)
      if (a.seq[i] != b.seq[i])
        return dec.labels[a.seq[i]] < dec.labels[b.seq[i]];
    if (a.seq.size() != b.seq.size()) return a.seq.size() < b.seq.size();
    return a.last_space < b.last_space;
  };
  for (const Beam& b : beams) {
    double s = b.total();
    if (lm != nullptr && (int)b.seq.size() > b.word_start) {
      std::string w = word_of(dec, b.seq, b.word_start, (int)b.seq.size());
      s += lm_word_contrib(lm, alpha, beta, b.ctx, lm->word_id(w));
    }
    if (best == nullptr || s > best_score ||
        (s == best_score && text_less(b, *best))) {
      best_score = s;
      best = &b;
    }
  }
  if (best == nullptr) return "";
  std::string text;
  for (int32_t id : best->seq) text += dec.labels[id];
  // strip leading/trailing spaces
  size_t a = text.find_first_not_of(' ');
  size_t z = text.find_last_not_of(' ');
  if (a == std::string::npos) return "";
  return text.substr(a, z - a + 1);
}

std::vector<std::pair<double, std::string>> StreamingBeamSearch::nbest(
    int n) const {
  // (score, unstripped text, stripped text): ties break on the UNSTRIPPED
  // text, matching the Python twin's (text + partial) tie-break exactly.
  std::vector<std::tuple<double, std::string, std::string>> scored;
  scored.reserve(beams.size());
  for (const Beam& b : beams) {
    double s = b.total();
    if (lm != nullptr && (int)b.seq.size() > b.word_start) {
      std::string w = word_of(dec, b.seq, b.word_start, (int)b.seq.size());
      s += lm_word_contrib(lm, alpha, beta, b.ctx, lm->word_id(w));
    }
    std::string raw;
    for (int32_t id : b.seq) raw += dec.labels[id];
    size_t a = raw.find_first_not_of(' ');
    size_t z = raw.find_last_not_of(' ');
    std::string text = a == std::string::npos ? "" : raw.substr(a, z - a + 1);
    scored.emplace_back(s, std::move(raw), std::move(text));
  }
  std::sort(scored.begin(), scored.end(), [](const auto& x, const auto& y) {
    if (std::get<0>(x) != std::get<0>(y)) return std::get<0>(x) > std::get<0>(y);
    return std::get<1>(x) < std::get<1>(y);
  });
  // dedup stripped-text twins, keep the best-scoring
  std::vector<std::pair<double, std::string>> out;
  for (auto& p : scored) {
    if ((int)out.size() >= n) break;
    if (std::get<0>(p) <= -1e30 && !out.empty()) break;  // placeholder beams
    bool dup = false;
    for (const auto& q : out) dup |= q.second == std::get<2>(p);
    if (!dup) out.emplace_back(std::get<0>(p), std::move(std::get<2>(p)));
  }
  return out;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* tone_lm_load_arpa(const char* path) { return load_arpa(path); }

// Load an LM from ARPA text or a KenLM binary (dispatch on file magic).
void* tone_lm_load(const char* path) { return load_lm(path); }

void tone_lm_free(void* lm) { delete static_cast<LM*>(lm); }

int tone_lm_order(void* lm) {
  return lm ? static_cast<LM*>(lm)->order : 0;
}

// Word id for a UTF-8 word (-1 = OOV). For KenLM binaries OOV maps to 0.
int tone_lm_word_id(void* lm, const char* word) {
  return static_cast<LM*>(lm)->word_id(word);
}

// log10 P(word | context); context = word ids, most recent last.
float tone_lm_score(void* lm, const int32_t* context, int ctx_len,
                    int32_t word) {
  return static_cast<LM*>(lm)->score(context, ctx_len, word);
}

// Build a hotword automaton over the label set. phrases_joined:
// '\n'-separated UTF-8 phrases. Returns nullptr if no valid phrase or a
// phrase uses a character outside the labels.
void* tone_hotwords_create(const char* labels_joined, int n_labels,
                           const char* phrases_joined, double weight) {
  Decoder dec;
  if (!parse_labels(labels_joined, n_labels, dec)) return nullptr;
  auto hw = std::make_unique<Hotwords>();
  hw->weight = weight;
  if (!hw->build(dec, phrases_joined)) return nullptr;
  return hw.release();
}

void tone_hotwords_free(void* hw) { delete static_cast<Hotwords*>(hw); }

// labels: n_labels UTF-8 strings concatenated, separated by '\n'.
// Returns bytes written to out (excluding NUL), or -1 on error.
int tone_ctc_beam_search(const float* logprobs, int t_max, int n_classes,
                         const char* labels_joined, int n_labels, void* lm,
                         double alpha, double beta, int beam_width,
                         double token_min_logp, void* hotwords,
                         char* out, int out_cap) {
  Decoder dec;
  if (!parse_labels(labels_joined, n_labels, dec)) return -1;
  std::string text =
      beam_search(dec, logprobs, t_max, n_classes,
                  static_cast<LM*>(lm), alpha, beta, beam_width,
                  token_min_logp, static_cast<Hotwords*>(hotwords));
  if ((int)text.size() + 1 > out_cap) return -1;
  std::memcpy(out, text.c_str(), text.size() + 1);
  return (int)text.size();
}

// ---- streaming (incremental) beam search ----------------------------------
// A handle carries the pruned beam set between calls; feeding frames in any
// split yields exactly the batch result.  The LM handle (if any) must stay
// alive for the handle's lifetime (the Python wrapper holds a reference).

void* tone_beam_create(const char* labels_joined, int n_labels, void* lm,
                       double alpha, double beta, int beam_width,
                       double token_min_logp, void* hotwords) {
  auto s = std::make_unique<StreamingBeamSearch>();
  if (!parse_labels(labels_joined, n_labels, s->dec)) return nullptr;
  s->lm = static_cast<LM*>(lm);
  s->hw = static_cast<Hotwords*>(hotwords);
  s->alpha = alpha;
  s->beta = beta;
  s->beam_width = beam_width;
  s->token_min_logp = token_min_logp;
  s->next.reserve(4096);
  s->reset();
  return s.release();
}

// Consume (t_max, n_classes) frames. Returns 0, or -1 on error.
int tone_beam_advance(void* handle, const float* logprobs, int t_max,
                      int n_classes) {
  if (handle == nullptr || t_max < 0 || n_classes < 2) return -1;
  static_cast<StreamingBeamSearch*>(handle)->advance(logprobs, t_max,
                                                     n_classes);
  return 0;
}

// Current best hypothesis (non-destructive). Returns bytes written
// (excluding NUL), or -1 on error / insufficient buffer.
int tone_beam_result(void* handle, char* out, int out_cap) {
  if (handle == nullptr) return -1;
  std::string text = static_cast<StreamingBeamSearch*>(handle)->result();
  if ((int)text.size() + 1 > out_cap) return -1;
  std::memcpy(out, text.c_str(), text.size() + 1);
  return (int)text.size();
}

// Up to n hypotheses, best first, serialized as "score\ttext\n" lines.
// Returns bytes written (excluding NUL), or -1 on error / short buffer.
int tone_beam_nbest(void* handle, int n, char* out, int out_cap) {
  if (handle == nullptr || n < 1) return -1;
  auto hyps = static_cast<StreamingBeamSearch*>(handle)->nbest(n);
  std::string blob;
  for (const auto& p : hyps) {
    char score[64];
    std::snprintf(score, sizeof(score), "%.10g", p.first);
    blob += score;
    blob += '\t';
    blob += p.second;
    blob += '\n';
  }
  if ((int)blob.size() + 1 > out_cap) return -1;
  std::memcpy(out, blob.c_str(), blob.size() + 1);
  return (int)blob.size();
}

// Restart the search (keeps labels/LM/params).
void tone_beam_reset(void* handle) {
  if (handle != nullptr) static_cast<StreamingBeamSearch*>(handle)->reset();
}

void tone_beam_free(void* handle) {
  delete static_cast<StreamingBeamSearch*>(handle);
}

}  // extern "C"

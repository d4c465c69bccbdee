// b2txt_tpu native runtime: word-synchronous CTC beam search with n-gram
// fusion, C++ host implementation.
//
// This is the native counterpart of the reference's C++ decode stack
// (runtime/core/decoder/* + kaldi token passing), rebuilt for the FST-free
// design: it loads an ARPA n-gram and a pronunciation lexicon directly,
// walks a phoneme trie, and scores words at SIL boundaries — the exact
// semantics of b2txt_tpu.decode.lmbeam (the Python host searcher), which is
// its correctness oracle. Used for low-latency host decoding when the TPU is
// busy with the RNN, and as the high-throughput offline decode path.
//
// Self-contained: C++17, no external dependencies. Exposed through a C API
// (see capi section) consumed via ctypes from b2txt_tpu.runtime.
//
// Reference semantics carried over (citations into the reference repo):
//   - acoustic_scale / nbest      lm_decoder.cc:30-35
//   - blank_penalty (log-domain)  lm_decoder.cc:14-37
//   - blank-skip + re-inserted blank frame  ctc_wfst_beam_search.cc:70-121
//   - ac/lm score split           brain_speech_decoder.h:100-108

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <limits>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace b2t {

constexpr int kMaxCtx = 8;
constexpr float kNegInf = -std::numeric_limits<float>::infinity();
constexpr double kLog10 = 2.302585092994046;
constexpr double kNoProb = -99.0 * kLog10;

static inline double LogAdd(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = std::max(a, b);
  return m + std::log1p(std::exp(std::min(a, b) - m));
}

// ---------------------------------------------------------------- n-gram LM
//
// KenLM-class packed storage: each order's n-grams live in one flat array of
// 16-byte records (64-bit FNV key of the word-id sequence + float logp +
// float backoff), sorted by key and probed with binary search. Exactly
// 16 B/entry with zero per-entry allocator overhead — a 5-gram with hundreds
// of millions of n-grams fits in a few GB of RAM where the reference's SRILM
// in-memory representation needs ~60-300 GB (reference README.md:101).

struct NGramLM {
  struct Rec {
    uint64_t key;
    float logp;
    float backoff;
  };
  static_assert(sizeof(Rec) == 16, "packed 16-byte n-gram records");

  struct PackedTable {
    std::vector<Rec> recs;  // sorted by key after Finish()

    void Finish() {
      std::sort(recs.begin(), recs.end(),
                [](const Rec& a, const Rec& b) { return a.key < b.key; });
      // duplicate keys (hash collisions or repeated ARPA lines): keep first
      recs.erase(std::unique(recs.begin(), recs.end(),
                             [](const Rec& a, const Rec& b) {
                               return a.key == b.key;
                             }),
                 recs.end());
    }

    const Rec* Find(uint64_t key) const {
      auto it = std::lower_bound(
          recs.begin(), recs.end(), key,
          [](const Rec& r, uint64_t k) { return r.key < k; });
      if (it != recs.end() && it->key == key) return &*it;
      return nullptr;
    }
  };

  int order = 0;
  std::vector<PackedTable> tables;
  std::unordered_map<std::string, int> word_ids;  // includes <s>,</s>,<unk>
  std::vector<std::string> words;
  int bos = -1, eos = -1, unk = -1;

  static uint64_t HashIds(const int* ids, int n) {
    uint64_t h = 1469598103934665603ull;  // FNV offset
    for (int i = 0; i < n; ++i) {
      h ^= static_cast<uint64_t>(ids[i] + 1);
      h *= 1099511628211ull;  // FNV prime
    }
    return h;
  }

  int Intern(const std::string& w) {
    auto it = word_ids.find(w);
    if (it != word_ids.end()) return it->second;
    int id = static_cast<int>(words.size());
    word_ids.emplace(w, id);
    words.push_back(w);
    return id;
  }

  size_t TotalEntries() const {
    size_t n = 0;
    for (const auto& t : tables) n += t.recs.size();
    return n;
  }

  bool LoadArpa(const std::string& path) {
    std::ifstream f(path);
    if (!f) return false;
    std::string line;
    // find \data\ header
    while (std::getline(f, line) && line.find("\\data\\") == std::string::npos) {
    }
    std::vector<size_t> counts;
    while (std::getline(f, line)) {
      if (line.rfind("ngram ", 0) == 0) {
        counts.push_back(std::stoul(line.substr(line.find('=') + 1)));
      } else if (!line.empty() && line[0] == '\\') {
        break;
      }
    }
    order = static_cast<int>(counts.size());
    tables.assign(order, {});
    for (int k = 0; k < order; ++k) tables[k].recs.reserve(counts[k]);
    int cur = 0;
    // `line` holds "\1-grams:" at this point
    do {
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line.find("-grams:") != std::string::npos) {
          if (cur > 0) tables[cur - 1].Finish();
          cur = std::stoi(line.substr(1));
        } else if (line.find("\\end\\") != std::string::npos) {
          break;
        }
        continue;
      }
      if (cur == 0) continue;
      // fast manual parse (the 100M-entry regime is load-bound on this path):
      // "<logp>\t<w1> ... <wN>[\t<backoff>]"
      const char* s = line.c_str();
      char* end = nullptr;
      double logp = std::strtod(s, &end);
      if (end == s) continue;
      s = end;
      int ids[8];
      bool ok = true;
      for (int i = 0; i < cur; ++i) {
        while (*s == ' ' || *s == '\t') ++s;
        const char* ws = s;
        while (*s && *s != ' ' && *s != '\t') ++s;
        if (s == ws) {
          ok = false;
          break;
        }
        ids[i] = Intern(std::string(ws, s - ws));
      }
      if (!ok) continue;
      double bow = std::strtod(s, &end);  // optional; 0.0 if absent
      tables[cur - 1].recs.push_back(
          Rec{HashIds(ids, cur), static_cast<float>(logp * kLog10),
              static_cast<float>(bow * kLog10)});
    } while (std::getline(f, line));
    if (cur > 0) tables[cur - 1].Finish();

    auto find = [&](const char* w) {
      auto it = word_ids.find(w);
      return it == word_ids.end() ? -1 : it->second;
    };
    bos = find("<s>");
    eos = find("</s>");
    unk = find("<unk>");
    return true;
  }

  // log P(word | context); context = last (order-1) ids, most recent last.
  float LogP(const int* ctx, int ctx_len, int word) const {
    if (word < 0) word = unk;
    if (word < 0) return static_cast<float>(kNoProb);
    int start = std::max(0, ctx_len - (order - 1));
    const int* c = ctx + start;
    int n = ctx_len - start;
    double bo_sum = 0.0;
    while (true) {
      int gram[8];
      for (int i = 0; i < n; ++i) gram[i] = c[i];
      gram[n] = word;
      if (n + 1 <= order) {
        const Rec* r = tables[n].Find(HashIds(gram, n + 1));
        if (r && r->logp > kNoProb + 1e-3) {
          return static_cast<float>(bo_sum + r->logp);
        }
      }
      if (n == 0) {
        const Rec* r = tables[0].Find(HashIds(&word, 1));
        double p = r ? r->logp : kNoProb;
        if (p <= kNoProb + 1e-3 && unk >= 0 && word != unk) {
          const Rec* ru = tables[0].Find(HashIds(&unk, 1));
          if (ru) p = ru->logp;
        }
        return static_cast<float>(bo_sum + p);
      }
      const Rec* bo = tables[n - 1].Find(HashIds(c, n));
      if (bo) bo_sum += bo->backoff;
      ++c;
      --n;
    }
  }

  // Full-sentence score: Σ log P(w_i | <s>, w_1..w_{i-1}) + log P(</s> | ...).
  // Used by n-best rescoring with the unpruned LM (the n-best analogue of the
  // reference's lattice −G_pruned/+G_unpruned compose,
  // brain_speech_decoder.cc:61-101).
  double SentenceLogP(const std::vector<int>& word_ids_seq) const {
    int ctx[kMaxCtx];
    int n = 0;
    if (bos >= 0) ctx[n++] = bos;
    double total = 0.0;
    auto push = [&](int w) {
      if (n == order - 1 && n > 0) {
        for (int i = 1; i < n; ++i) ctx[i - 1] = ctx[i];
        --n;
      }
      if (order > 1) ctx[n++] = w;
    };
    for (int w : word_ids_seq) {
      total += LogP(ctx, n, w);
      push(w);
    }
    if (eos >= 0) total += LogP(ctx, n, eos);
    return total;
  }
};

// ----------------------------------------------------------------- lexicon

struct Lexicon {
  // trie over phoneme ids (model channel order, SIL excluded from arcs)
  int n_phones = 41;
  std::vector<std::vector<int>> next;       // [node][phone] -> node or -1
  std::vector<std::vector<int>> words_at;   // [node] -> lm word ids
  std::vector<std::string> out_words;       // decode-output word strings
  std::unordered_map<std::string, int> phone_ids;

  Lexicon() {
    static const char* kPhones[] = {
        "BLANK", "AA", "AE", "AH", "AO", "AW", "AY", "B",  "CH", "D",  "DH",
        "EH",    "ER", "EY", "F",  "G",  "HH", "IH", "IY", "JH", "K",  "L",
        "M",     "N",  "NG", "OW", "OY", "P",  "R",  "S",  "SH", "T",  "TH",
        "UH",    "UW", "V",  "W",  "Y",  "Z",  "ZH"};
    for (int i = 0; i < 40; ++i) phone_ids[kPhones[i]] = i;
    next.emplace_back(n_phones, -1);
    words_at.emplace_back();
  }

  // Load "WORD  P1 P2 ..." lines; words interned into `lm` for LM ids.
  bool Load(const std::string& path, NGramLM* lm) {
    std::ifstream f(path);
    if (!f) return false;
    std::string line;
    while (std::getline(f, line)) {
      if (line.empty() || line[0] == ';' || line[0] == '#') continue;
      std::istringstream ss(line);
      std::string word;
      ss >> word;
      // strip (N) alternate markers
      auto paren = word.find('(');
      if (paren != std::string::npos) word = word.substr(0, paren);
      std::string lower = word;
      for (auto& ch : lower) ch = static_cast<char>(std::tolower(ch));
      std::vector<int> pron;
      std::string p;
      bool ok = true;
      while (ss >> p) {
        // strip stress digits
        while (!p.empty() && std::isdigit(static_cast<unsigned char>(p.back())))
          p.pop_back();
        auto it = phone_ids.find(p);
        if (it == phone_ids.end()) {
          ok = false;
          break;
        }
        pron.push_back(it->second);
      }
      if (!ok || pron.empty()) continue;
      int lm_id = lm->Intern(lower);
      if (lm_id >= static_cast<int>(out_words.size()))
        out_words.resize(lm_id + 1);
      out_words[lm_id] = lower;
      int node = 0;
      for (int pid : pron) {
        int& child = next[node][pid];
        if (child < 0) {
          child = static_cast<int>(next.size());
          next.emplace_back(n_phones, -1);
          words_at.emplace_back();
        }
        node = child;
      }
      auto& ws = words_at[node];
      if (std::find(ws.begin(), ws.end(), lm_id) == ws.end())
        ws.push_back(lm_id);
    }
    return true;
  }
};

// ------------------------------------------------------------- beam search

struct Options {
  double acoustic_scale = 0.325;
  double blank_penalty = 90.0;
  double blank_skip_thresh = 1.0;
  double length_penalty = 0.0;
  double beam = 17.0;          // score-window prune relative to best
  int nbest = 100;
  int beam_width = 128;
  int max_homophones = 4;
  int first_beam = 0;          // restrict phone extensions to the frame's
                               // top-k phones (0 = all); SIL always kept
  bool sum_mode = true;        // true: CTC-proper log-sum path merge
                               // (ctc_prefix_beam_search semantics); false:
                               // Viterbi max (Kaldi token passing over TLG)
  // --- lattice n-best (decode/lattice.py design; Viterbi mode only) ---
  bool ngram_key = false;      // truncate the hypothesis state to the LM
                               // context (Kaldi's token-passing state space,
                               // lattice-faster-decoder.h) so different
                               // histories merge — the lattice depth source
  bool lattice_nbest = false;  // Finalize() = k-best over the recorded
                               // provenance graph instead of the beam pool
  double lattice_beam = 8.0;   // margin for keeping merged-away alternatives
                               // (LatticeFasterDecoderConfig::lattice_beam)
};

struct Decoder {
  const NGramLM* lm;
  const Lexicon* lex;
  const NGramLM* rescore_lm = nullptr;  // unpruned LM for n-best rescoring
  Options opts;
  int blank = 0, sil = 40;

  // word-history arena: (word, parent index), deduped so that identical word
  // histories share one node and hypotheses merge correctly
  std::vector<std::pair<int, int>> arena;
  std::unordered_map<int64_t, int> arena_index;

  int ArenaNode(int word, int parent) {
    int64_t key = (static_cast<int64_t>(parent + 1) << 21) | word;
    auto it = arena_index.find(key);
    if (it != arena_index.end()) return it->second;
    arena.emplace_back(word, parent);
    int idx = static_cast<int>(arena.size()) - 1;
    arena_index.emplace(key, idx);
    return idx;
  }

  struct Hyp {
    int word_node = -1;  // arena index, -1 = empty history
    int node = 0;        // trie node
    int last = -1;       // last emitted phone
    double s = kNegInf, ns = kNegInf;      // ranking (scaled ac + lm)
    double ac_s = kNegInf, ac_ns = kNegInf;
    double lm_score = 0.0;
    // lattice provenance (Viterbi mode): graph node each component descends
    // from (0 = start) + the component's score AT that node, so edge
    // weights are exact span costs (mirrors lmbeam.py barc_*/bsc_*)
    int bnode_s = 0, bnode_ns = 0;
    double bsc_s = 0.0, bsc_ns = 0.0;
    // ranking: log-sum of the blank/non-blank components (CTC marginal) or
    // Viterbi max, per Options::sum_mode
    double Score(bool sum) const {
      return sum ? LogAdd(s, ns) : std::max(s, ns);
    }
    // blank/non-blank acoustic parts combine by log-sum (path marginal);
    // duplicates merge by max (viterbi) — mirrors lmbeam.py's ac tracking
    double Ac() const { return LogAdd(ac_s, ac_ns); }
  };

  std::vector<Hyp> hyps;
  int n_frames = 0;
  bool pending_blank = false;

  // ------------------------------------------------------- lattice graph
  // provenance graph of word-close events + state-merge alternatives
  // (decode/lattice.py design; node ids are topological by construction)
  struct LatEdge {
    int src;
    int word;   // -1 = epsilon (merge alternative)
    double w;   // exact span weight (cumulative score delta)
  };
  std::vector<int> lat_frame;                // per node: creation step
  std::vector<std::vector<LatEdge>> lat_in;  // per node: in-edges
  std::vector<LatEdge> lat_final;            // sink edges (src, end word, w)
  std::unordered_map<uint64_t, int> lat_close_ids;
  int step_idx = 0;
  // recording gate LATCHED per utterance at Reset: enabling lattice opts
  // mid-utterance (SetOpt between chunks) must not take effect until the
  // next Reset — a graph recorded from mid-utterance on would be missing
  // every word closed before the toggle and FinalizeLattice would
  // backtrace truncated sentences with full-looking scores
  bool lat_rec = false;

  int LatClose(int parent, int new_hist, int word, double weight) {
    // recombine by (step, LM-context tail of the NEW history): boundary
    // states are canonical (root, last=SIL, single score component), so any
    // in-edge may precede any out-edge with exact spliced scores
    int ctx[8];
    int n;
    Context(new_hist, ctx, &n);
    uint64_t h = NGramLM::HashIds(ctx, n) * 1000003ull +
                 static_cast<uint64_t>(step_idx);
    auto it = lat_close_ids.find(h);
    int nid;
    if (it == lat_close_ids.end()) {
      nid = static_cast<int>(lat_frame.size());
      lat_frame.push_back(step_idx);
      lat_in.emplace_back();
      lat_close_ids.emplace(h, nid);
    } else {
      nid = it->second;
    }
    lat_in[nid].push_back({parent, word, weight});
    return nid;
  }

  int LatMerge(int win_node, double win_w, int lose_node, double lose_w) {
    int nid = static_cast<int>(lat_frame.size());
    lat_frame.push_back(step_idx);
    lat_in.emplace_back();
    lat_in[nid].push_back({win_node, -1, win_w});
    lat_in[nid].push_back({lose_node, -1, lose_w});
    return nid;
  }
  // per-utterance memo of n-gram lookups: beams revisit the same
  // (context, word) pairs on nearly every frame
  std::unordered_map<uint64_t, double> lm_cache;

  double CachedLogP(const int* ctx, int ctx_len, int w) {
    int key_ids[kMaxCtx + 1];
    int n = 0;
    for (int i = 0; i < ctx_len; ++i) key_ids[n++] = ctx[i];
    key_ids[n++] = w;
    uint64_t key = NGramLM::HashIds(key_ids, n);
    auto it = lm_cache.find(key);
    if (it != lm_cache.end()) return it->second;
    double v = lm->LogP(ctx, ctx_len, w);
    lm_cache.emplace(key, v);
    return v;
  }

  struct Key {
    int64_t a;
    int64_t b;
    bool operator==(const Key& o) const { return a == o.a && b == o.b; }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return std::hash<int64_t>()(k.a * 1000003 + k.b);
    }
  };

  std::vector<double> la;  // per-node LM lookahead (best reachable unigram)

  explicit Decoder(const NGramLM* lm_, const Lexicon* lex_) : lm(lm_), lex(lex_) {
    // Bottom-up lookahead smearing (nodes are created parent-before-child).
    int n_nodes = static_cast<int>(lex->next.size());
    la.assign(n_nodes, kNegInf);
    for (int node = n_nodes - 1; node >= 0; --node) {
      double best = kNegInf;
      for (int w : lex->words_at[node])
        best = std::max(best, static_cast<double>(lm->LogP(nullptr, 0, w)));
      for (int child : lex->next[node])
        if (child >= 0) best = std::max(best, la[child]);
      la[node] = best;
    }
    Reset();
  }

  void Reset() {
    arena.clear();
    arena_index.clear();
    lm_cache.clear();
    hyps.clear();
    Hyp root;
    root.s = 0.0;
    root.ac_s = 0.0;
    hyps.push_back(root);
    n_frames = 0;
    pending_blank = false;
    finalized_.clear();
    has_final_ = false;
    lat_frame.assign(1, -1);  // node 0 = utterance start
    lat_in.assign(1, {});
    lat_final.clear();
    lat_close_ids.clear();
    step_idx = 0;
    lat_rec = !opts.sum_mode && (opts.lattice_nbest || opts.ngram_key);
  }

  void Context(int word_node, int* ctx, int* ctx_len) const {
    int tmp[8];
    int n = 0;
    int cur = word_node;
    while (cur >= 0 && n < lm->order - 1) {
      tmp[n++] = arena[cur].first;
      cur = arena[cur].second;
    }
    int m = 0;
    ctx[m++] = lm->bos;  // sentence-start conditioning (G.fst start state)
    for (int i = n - 1; i >= 0; --i) ctx[m++] = tmp[i];
    *ctx_len = m;
  }

  void Step(const float* lp) {
    std::unordered_map<Key, Hyp, KeyHash> next_map;
    next_map.reserve(hyps.size() * 8);
    const double scale = opts.acoustic_scale;
    // lattice recording costs a hash+insert per close and a node per
    // competitive merge; it is opt-in (the plain Viterbi decode path stays
    // at its measured throughput) and latched per utterance at Reset
    const bool rec = lat_rec;

    auto tail_key = [&](int word_node) -> int64_t {
      int c[8];
      int n;
      Context(word_node, c, &n);
      return static_cast<int64_t>(NGramLM::HashIds(c, n));
    };

    // ``hist`` = the hypothesis-identity key for its word history: the
    // arena index (full history) or, under ngram keying, the LM-context
    // tail hash — computed ONCE per source hypothesis / close target, not
    // per candidate (a hyp emits ~40 candidates per frame)
    auto merge = [&](int64_t hist, int word_node, int node, int last,
                     double s, double ns,
                     double ac_s, double ac_ns, double lm_score,
                     int bn_s, double bs_s, int bn_ns, double bs_ns) {
      Key k{(hist << 20) ^ node, static_cast<int64_t>(last)};
      auto it = next_map.find(k);
      if (it == next_map.end()) {
        Hyp h;
        h.word_node = word_node;
        h.node = node;
        h.last = last;
        h.s = s;
        h.ns = ns;
        h.ac_s = ac_s;
        h.ac_ns = ac_ns;
        h.lm_score = lm_score;
        h.bnode_s = bn_s;
        h.bsc_s = bs_s;
        h.bnode_ns = bn_ns;
        h.bsc_ns = bs_ns;
        next_map.emplace(k, h);
      } else {
        Hyp& h = it->second;
        if (opts.sum_mode) {
          h.s = LogAdd(h.s, s);
          h.ns = LogAdd(h.ns, ns);
          h.ac_s = std::max(h.ac_s, ac_s);
          h.ac_ns = std::max(h.ac_ns, ac_ns);
          return;
        }
        // Viterbi: each component keeps its best path (ac follows it).
        // Under ngram keying different full histories share a key: the
        // readout fields follow the overall-best path (the lattice readout
        // is exact regardless)
        if (opts.ngram_key && std::max(s, ns) > std::max(h.s, h.ns)) {
          h.word_node = word_node;
          h.lm_score = lm_score;
        }
        // a finite loser from a DIFFERENT boundary within lattice_beam
        // becomes a merge eps-edge (Kaldi's lattice-arc retention)
        auto comp = [&](double win_v, double win_ac, int win_b, double win_bs,
                        double lose_v, int lose_b, double lose_bs,
                        double* v, double* acv, int* b, double* bs) {
          if (rec && lose_v != kNegInf && win_b != lose_b &&
              win_v - lose_v <= opts.lattice_beam) {
            int m = LatMerge(win_b, win_v - win_bs, lose_b, lose_v - lose_bs);
            *v = win_v;
            *acv = win_ac;
            *b = m;
            *bs = win_v;
          } else {
            *v = win_v;
            *acv = win_ac;
            *b = win_b;
            *bs = win_bs;
          }
        };
        if (s > h.s) {
          comp(s, ac_s, bn_s, bs_s, h.s, h.bnode_s, h.bsc_s,
               &h.s, &h.ac_s, &h.bnode_s, &h.bsc_s);
        } else if (h.s != kNegInf) {
          comp(h.s, h.ac_s, h.bnode_s, h.bsc_s, s, bn_s, bs_s,
               &h.s, &h.ac_s, &h.bnode_s, &h.bsc_s);
        }
        if (ns > h.ns) {
          comp(ns, ac_ns, bn_ns, bs_ns, h.ns, h.bnode_ns, h.bsc_ns,
               &h.ns, &h.ac_ns, &h.bnode_ns, &h.bsc_ns);
        } else if (h.ns != kNegInf) {
          comp(h.ns, h.ac_ns, h.bnode_ns, h.bsc_ns, ns, bn_ns, bs_ns,
               &h.ns, &h.ac_ns, &h.bnode_ns, &h.bsc_ns);
        }
      }
    };

    int ctx[8];
    int ctx_len;
    const int V = lex->n_phones;
    // first-beam prune: threshold at the k-th best phone log-prob this frame
    float fb_thresh = -std::numeric_limits<float>::infinity();
    if (opts.first_beam > 0 && opts.first_beam < V - 2) {
      std::vector<float> vals;
      vals.reserve(V - 2);
      for (int c = 1; c < V; ++c)
        if (c != sil) vals.push_back(lp[c]);
      std::nth_element(vals.begin(), vals.begin() + opts.first_beam - 1,
                       vals.end(), std::greater<float>());
      fb_thresh = vals[opts.first_beam - 1];
    }
    const bool sum = opts.sum_mode;
    double window_cutoff = -std::numeric_limits<double>::infinity();
    if (!hyps.empty() && opts.beam > 0)
      window_cutoff = hyps.front().Score(sum) - opts.beam;

    for (const Hyp& h : hyps) {
      double score = h.Score(sum);
      if (score < window_cutoff) continue;
      double ac = h.Ac();
      // boundary provenance of the max component (Viterbi)
      int bb;
      double bbs;
      if (h.s >= h.ns) {
        bb = h.bnode_s;
        bbs = h.bsc_s;
      } else {
        bb = h.bnode_ns;
        bbs = h.bsc_ns;
      }
      const int64_t h_hist = opts.ngram_key
                                 ? tail_key(h.word_node)
                                 : static_cast<int64_t>(h.word_node);
      // blank / absorbed repeat (stay)
      merge(h_hist, h.word_node, h.node, h.last,
            score + scale * lp[blank], kNegInf,
            ac + lp[blank], kNegInf, h.lm_score, bb, bbs, 0, 0.0);
      if (h.last >= 0 && h.ns != kNegInf) {
        merge(h_hist, h.word_node, h.node, h.last, kNegInf,
              h.ns + scale * lp[h.last],
              kNegInf, h.ac_ns + lp[h.last], h.lm_score,
              0, 0.0, h.bnode_ns, h.bsc_ns);
      }
      // extensions
      for (int c = 1; c < V; ++c) {
        if (c != sil && lp[c] < fb_thresh) continue;
        double base = (c == h.last) ? h.s : score;
        double ac_base = (c == h.last) ? h.ac_s : ac;
        if (base == kNegInf) continue;
        int src_b = (c == h.last) ? h.bnode_s : bb;
        double src_bs = (c == h.last) ? h.bsc_s : bbs;
        double lc = lp[c];
        if (c == sil) {
          if (h.node == 0) {
            merge(h_hist, h.word_node, 0, sil, kNegInf, base + scale * lc,
                  kNegInf, ac_base + lc, h.lm_score, 0, 0.0, src_b, src_bs);
          }
          const auto& ws = lex->words_at[h.node];
          if (!ws.empty()) {
            Context(h.word_node, ctx, &ctx_len);
            int limit = std::min<int>(ws.size(), opts.max_homophones);
            for (int j = 0; j < limit; ++j) {
              double wlp =
                  CachedLogP(ctx, ctx_len, ws[j]) + opts.length_penalty;
              int wn = ArenaNode(ws[j], h.word_node);
              // swap lookahead for the true LM score; re-enter root lookahead
              double la_adj = la[0] - la[h.node];
              double ns_new = base + scale * lc + wlp + la_adj;
              int arc = 0;
              if (rec) arc = LatClose(src_b, wn, ws[j], ns_new - src_bs);
              merge(opts.ngram_key ? tail_key(wn)
                                   : static_cast<int64_t>(wn),
                    wn, 0, sil, kNegInf, ns_new,
                    kNegInf, ac_base + lc, h.lm_score + wlp,
                    0, 0.0, arc, ns_new);
            }
          }
        } else {
          int child = lex->next[h.node][c];
          if (child < 0) continue;
          merge(h_hist, h.word_node, child, c, kNegInf,
                base + scale * lc + (la[child] - la[h.node]), kNegInf,
                ac_base + lc, h.lm_score, 0, 0.0, src_b, src_bs);
        }
      }
    }

    std::vector<Hyp> ranked;
    ranked.reserve(next_map.size());
    for (auto& kv : next_map) ranked.push_back(kv.second);
    std::sort(ranked.begin(), ranked.end(),
              [sum](const Hyp& a, const Hyp& b) {
                return a.Score(sum) > b.Score(sum);
              });
    if (static_cast<int>(ranked.size()) > opts.beam_width)
      ranked.resize(opts.beam_width);
    if (!ranked.empty() && opts.beam > 0) {
      double cutoff = ranked[0].Score(sum) - opts.beam;
      while (!ranked.empty() && ranked.back().Score(sum) < cutoff)
        ranked.pop_back();
    }
    hyps.swap(ranked);
    ++step_idx;  // counts Step calls incl. re-inserted blank frames
  }

  void Decode(const float* logprobs, int T, int C) {
    std::vector<float> row(C);
    double log_bp = std::log(opts.blank_penalty);
    for (int t = 0; t < T; ++t) {
      const float* src = logprobs + static_cast<int64_t>(t) * C;
      if (opts.blank_skip_thresh < 1.0 &&
          std::exp(static_cast<double>(src[blank]) - log_bp) >
              opts.blank_skip_thresh) {
        pending_blank = true;
        ++n_frames;
        continue;
      }
      if (pending_blank) {
        std::fill(row.begin(), row.end(), -30.0f);
        row[blank] = 0.0f;
        Step(row.data());
        pending_blank = false;
      }
      std::copy(src, src + C, row.begin());
      row[blank] -= static_cast<float>(log_bp);
      Step(row.data());
      ++n_frames;
    }
    has_final_ = false;
  }

  struct Result {
    std::string sentence;
    double ac_score;
    double lm_score;
  };

  std::vector<Result> finalized_;
  bool has_final_ = false;

  // word ids (decode-LM interning) in sentence order
  std::vector<int> CollectWords(int word_node, int extra_word) const {
    std::vector<int> ws;
    if (extra_word >= 0) ws.push_back(extra_word);
    int cur = word_node;
    while (cur >= 0) {
      ws.push_back(arena[cur].first);
      cur = arena[cur].second;
    }
    std::reverse(ws.begin(), ws.end());
    return ws;
  }

  std::string Sentence(const std::vector<int>& ws) const {
    std::string out;
    for (int w : ws) {
      if (!out.empty()) out += ' ';
      out += lex->out_words[w];
    }
    return out;
  }

  const std::vector<Result>& Finalize() {
    struct Cand {
      double score;
      double ac;
      double lms;
      int word_node;
      int extra;
    };
    const bool rec = lat_rec;
    lat_final.clear();
    std::vector<Cand> cands;
    int ctx[8];
    int ctx_len;
    for (const Hyp& h : hyps) {
      double score = h.Score(opts.sum_mode);
      if (score == kNegInf) continue;
      int bb;
      double bbs;
      if (h.s >= h.ns) {
        bb = h.bnode_s;
        bbs = h.bsc_s;
      } else {
        bb = h.bnode_ns;
        bbs = h.bsc_ns;
      }
      if (h.node == 0) {
        Context(h.word_node, ctx, &ctx_len);
        double e = CachedLogP(ctx, ctx_len, lm->eos);
        cands.push_back({score + e, h.Ac(), h.lm_score + e, h.word_node, -1});
        if (rec) lat_final.push_back({bb, -1, score + e - bbs});
      } else {
        const auto& ws = lex->words_at[h.node];
        Context(h.word_node, ctx, &ctx_len);
        int limit = std::min<int>(ws.size(), opts.max_homophones);
        for (int j = 0; j < limit; ++j) {
          double wlp = CachedLogP(ctx, ctx_len, ws[j]) + opts.length_penalty;
          // shift context for </s>
          int ctx2[8];
          int n2 = std::min(ctx_len + 1, lm->order - 1);
          int src_start = ctx_len + 1 - n2;
          for (int i = 0; i < n2; ++i) {
            int idx = src_start + i;
            ctx2[i] = (idx < ctx_len) ? ctx[idx] : ws[j];
          }
          double e = CachedLogP(ctx2, n2, lm->eos);
          // lookahead cancellation so all final candidates share la[0]
          double la_adj = la[0] - la[h.node];
          cands.push_back({score + wlp + la_adj + e, h.Ac(),
                           h.lm_score + wlp + e, h.word_node, ws[j]});
          if (rec)
            lat_final.push_back({bb, ws[j], score + wlp + la_adj + e - bbs});
        }
      }
    }
    // lattice finalize only when this utterance actually RECORDED (the
    // latch), so a mid-utterance lattice_nbest enable degrades to the pool
    // finalize instead of a truncated lattice
    if (opts.lattice_nbest && !opts.sum_mode && lat_rec)
      return FinalizeLattice();
    // Unpruned-LM rescoring over the candidate set: replace each candidate's
    // decode-LM score with the unpruned LM's full-sentence score and re-rank
    // — the n-best analogue of the reference's lattice −G_pruned/+G_unpruned
    // compose (brain_speech_decoder.cc:61-101).
    if (rescore_lm != nullptr) {
      for (Cand& c : cands) {
        if (c.score == kNegInf) continue;
        std::vector<int> ws = CollectWords(c.word_node, c.extra);
        std::vector<int> rs;
        rs.reserve(ws.size());
        for (int w : ws) {
          auto it = rescore_lm->word_ids.find(lex->out_words[w]);
          rs.push_back(it == rescore_lm->word_ids.end() ? -1 : it->second);
        }
        double lm_new = rescore_lm->SentenceLogP(rs) +
                        opts.length_penalty * static_cast<double>(ws.size());
        c.score += lm_new - c.lms;
        c.lms = lm_new;
      }
    }
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& b) { return a.score > b.score; });
    finalized_.clear();
    std::unordered_map<std::string, bool> seen;
    for (const Cand& c : cands) {
      if (static_cast<int>(finalized_.size()) >= opts.nbest) break;
      std::string s = Sentence(CollectWords(c.word_node, c.extra));
      if (s.empty() || seen.count(s)) continue;
      seen[s] = true;
      finalized_.push_back({s, c.ac, c.lms});
    }
    has_final_ = true;
    return finalized_;
  }

  // k-best distinct word sequences over the recorded provenance graph
  // (mirrors decode/lattice.py LatticeGraph.kbest; the reference analogue
  // is ShortestPath over the determinized lattice,
  // ctc_wfst_beam_search.cc:123-160). Scores: rank = scale*ac + lm exactly;
  // lm recomputed per sequence so Result carries the same (ac, lm) split.
  const std::vector<Result>& FinalizeLattice() {
    const int k = opts.nbest;
    const int n = static_cast<int>(lat_frame.size());
    // backward-reachability prune: only nodes on some path to a final edge
    // need the k-best DP (most recorded merge-chain alternatives died
    // before the utterance end); node ids are topological ⇒ reverse sweep
    std::vector<char> live(n, 0);
    for (const auto& f : lat_final) live[f.src] = 1;
    for (int nid = n - 1; nid > 0; --nid) {
      if (!live[nid]) continue;
      for (const auto& e : lat_in[nid]) live[e.src] = 1;
    }
    struct Entry {
      double s;
      int ei;   // edge index in node (-1 = start)
      int r;    // rank in src node's list
    };
    std::vector<std::vector<Entry>> best(n);
    best[0] = {{0.0, -1, -1}};
    std::vector<Entry> cand;
    for (int nid = 1; nid < n; ++nid) {
      if (!live[nid]) continue;
      cand.clear();
      const auto& edges = lat_in[nid];
      for (int ei = 0; ei < static_cast<int>(edges.size()); ++ei) {
        const auto& bsrc = best[edges[ei].src];
        for (int r = 0; r < static_cast<int>(bsrc.size()); ++r)
          cand.push_back({bsrc[r].s + edges[ei].w, ei, r});
      }
      std::sort(cand.begin(), cand.end(),
                [](const Entry& a, const Entry& b) { return a.s > b.s; });
      if (static_cast<int>(cand.size()) > k) cand.resize(k);
      best[nid] = cand;
    }
    struct FinalCand {
      double s;
      int fi;
      int r;
    };
    std::vector<FinalCand> finals;
    for (int fi = 0; fi < static_cast<int>(lat_final.size()); ++fi) {
      const auto& f = lat_final[fi];
      const auto& bsrc = best[f.src];
      for (int r = 0; r < static_cast<int>(bsrc.size()); ++r)
        finals.push_back({bsrc[r].s + f.w, fi, r});
    }
    std::sort(finals.begin(), finals.end(),
              [](const FinalCand& a, const FinalCand& b) { return a.s > b.s; });

    struct Out {
      double rank;
      double lms;
      std::vector<int> words;
    };
    std::vector<Out> outs;
    std::unordered_map<std::string, bool> seen;
    int ctx[8];
    int ctx_len;
    for (const auto& fc : finals) {
      if (static_cast<int>(outs.size()) >= k) break;
      const auto& f = lat_final[fc.fi];
      std::vector<int> words;
      int cur = f.src, r = fc.r;
      bool ok = true;
      while (cur != 0) {
        if (r >= static_cast<int>(best[cur].size())) {
          ok = false;
          break;
        }
        const Entry& e = best[cur][r];
        const LatEdge& edge = lat_in[cur][e.ei];
        if (edge.word >= 0) words.push_back(edge.word);
        cur = edge.src;
        r = e.r;
      }
      if (!ok) continue;
      std::reverse(words.begin(), words.end());
      if (f.word >= 0) words.push_back(f.word);
      if (words.empty()) continue;
      std::string s = Sentence(words);
      if (seen.count(s)) continue;
      seen[s] = true;
      // exact LM of the sequence (BOS-conditioned + </s>)
      double lms = 0.0;
      ctx[0] = lm->bos;
      ctx_len = 1;
      for (int w : words) {
        lms += CachedLogP(ctx, ctx_len, w) + opts.length_penalty;
        if (ctx_len == lm->order) {  // keep the last order-1 ids
          for (int i = 1; i < ctx_len; ++i) ctx[i - 1] = ctx[i];
          --ctx_len;
        }
        ctx[ctx_len++] = w;
      }
      lms += CachedLogP(ctx, ctx_len, lm->eos);
      outs.push_back({fc.s, lms, std::move(words)});
    }
    // unpruned-LM rescoring over the lattice list (same semantics as the
    // pool rescore above)
    if (rescore_lm != nullptr) {
      for (Out& o : outs) {
        std::vector<int> rs;
        rs.reserve(o.words.size());
        for (int w : o.words) {
          auto it = rescore_lm->word_ids.find(lex->out_words[w]);
          rs.push_back(it == rescore_lm->word_ids.end() ? -1 : it->second);
        }
        double lm_new = rescore_lm->SentenceLogP(rs) +
                        opts.length_penalty * static_cast<double>(o.words.size());
        o.rank += lm_new - o.lms;
        o.lms = lm_new;
      }
      std::sort(outs.begin(), outs.end(),
                [](const Out& a, const Out& b) { return a.rank > b.rank; });
    }
    finalized_.clear();
    for (const Out& o : outs) {
      finalized_.push_back({Sentence(o.words),
                            (o.rank - o.lms) / opts.acoustic_scale, o.lms});
    }
    has_final_ = true;
    return finalized_;
  }

  Result Partial() const {
    if (hyps.empty()) return {"", 0.0, 0.0};
    const Hyp* best = &hyps[0];
    for (const Hyp& h : hyps)
      if (h.Score(opts.sum_mode) > best->Score(opts.sum_mode)) best = &h;
    return {Sentence(CollectWords(best->word_node, -1)), best->Ac(),
            best->lm_score};
  }
};

}  // namespace b2t

// ------------------------------------------------------------------- C API

struct B2TDecoder {
  b2t::NGramLM lm;
  b2t::Lexicon lex;
  std::unique_ptr<b2t::NGramLM> rescore_lm;
  std::unique_ptr<b2t::Decoder> dec;
};

extern "C" {

void* b2t_create(const char* arpa_path, const char* lexicon_path) {
  auto* d = new B2TDecoder();
  if (!d->lm.LoadArpa(arpa_path) || !d->lex.Load(lexicon_path, &d->lm)) {
    delete d;
    return nullptr;
  }
  // Order each node's homophone-class members by DESCENDING unigram
  // log-prob (stable: ties keep lexicon-file order), so the
  // max_homophones cap drops the least-likely members — the same drop
  // policy as the host oracle (lmbeam.py _node_words) and the device
  // searcher (lmbeam_jax.TrieArrays); cross-backend n-best parity holds
  // even when a class exceeds the cap.
  for (auto& ws : d->lex.words_at) {
    if (ws.size() > 1) {
      std::stable_sort(ws.begin(), ws.end(), [&](int a, int b) {
        return d->lm.LogP(nullptr, 0, a) > d->lm.LogP(nullptr, 0, b);
      });
    }
  }
  d->dec = std::make_unique<b2t::Decoder>(&d->lm, &d->lex);
  return d;
}

void b2t_destroy(void* p) { delete static_cast<B2TDecoder*>(p); }

// Load an unpruned LM for n-best rescoring (reference: G_no_prune.fst in
// DecodeResource + Rescore, brain_speech_decoder.h:45-98). Returns 0 on
// success. Passing an empty path clears the rescorer.
int b2t_set_rescore_lm(void* p, const char* arpa_path) {
  auto* d = static_cast<B2TDecoder*>(p);
  if (arpa_path == nullptr || arpa_path[0] == '\0') {
    d->dec->rescore_lm = nullptr;
    d->rescore_lm.reset();
    return 0;
  }
  auto lm = std::make_unique<b2t::NGramLM>();
  if (!lm->LoadArpa(arpa_path)) return 1;
  d->rescore_lm = std::move(lm);
  d->dec->rescore_lm = d->rescore_lm.get();
  return 0;
}

// Introspection for memory drives: entries across all orders.
long long b2t_lm_entries(void* p) {
  return static_cast<long long>(
      static_cast<B2TDecoder*>(p)->lm.TotalEntries());
}

void b2t_reset(void* p) { static_cast<B2TDecoder*>(p)->dec->Reset(); }

void b2t_set_opt(void* p, double acoustic_scale, double blank_penalty,
                 double blank_skip_thresh, double length_penalty, int nbest,
                 int beam_width, double beam, int max_homophones,
                 int first_beam, int sum_mode) {
  auto* dec = static_cast<B2TDecoder*>(p)->dec.get();
  auto& o = dec->opts;
  o.acoustic_scale = acoustic_scale;
  o.blank_penalty = blank_penalty;
  o.blank_skip_thresh = blank_skip_thresh;
  o.length_penalty = length_penalty;
  o.nbest = nbest;
  o.beam_width = beam_width;
  o.beam = beam;
  o.max_homophones = max_homophones;
  o.first_beam = first_beam;
  o.sum_mode = sum_mode != 0;
  // sum_mode gates lattice recording; refresh the latch on a fresh state
  if (dec->n_frames == 0 && dec->step_idx == 0)
    dec->lat_rec = !o.sum_mode && (o.lattice_nbest || o.ngram_key);
}

// Lattice n-best controls (decode/lattice.py semantics): ngram_key switches
// the hypothesis state to the LM context (Kaldi token-passing state space),
// lattice_nbest routes Finalize through the provenance-graph k-best,
// lattice_beam is the merged-alternative retention margin.
void b2t_set_lattice_opt(void* p, int ngram_key, int lattice_nbest,
                         double lattice_beam) {
  auto* dec = static_cast<B2TDecoder*>(p)->dec.get();
  auto& o = dec->opts;
  o.ngram_key = ngram_key != 0;
  o.lattice_nbest = lattice_nbest != 0;
  o.lattice_beam = lattice_beam;
  // re-latch the per-utterance recording gate if nothing was decoded yet
  // (the common construct → set opts → decode flow); mid-utterance the
  // latch stays, taking effect at the next Reset
  if (dec->n_frames == 0 && dec->step_idx == 0)
    dec->lat_rec = !o.sum_mode && (o.lattice_nbest || o.ngram_key);
}

void b2t_decode(void* p, const float* logprobs, int T, int C) {
  static_cast<B2TDecoder*>(p)->dec->Decode(logprobs, T, C);
}

// Pack results as "sentence\tac\tlm\n" lines into out. Returns bytes written.
static int PackResults(const std::vector<b2t::Decoder::Result>& rs, char* out,
                       int cap) {
  std::string buf;
  for (const auto& r : rs) {
    buf += r.sentence;
    buf += '\t';
    buf += std::to_string(r.ac_score);
    buf += '\t';
    buf += std::to_string(r.lm_score);
    buf += '\n';
  }
  int n = std::min<int>(buf.size(), cap - 1);
  std::memcpy(out, buf.data(), n);
  out[n] = '\0';
  return n;
}

int b2t_finalize(void* p, char* out, int cap) {
  auto& rs = static_cast<B2TDecoder*>(p)->dec->Finalize();
  return PackResults(rs, out, cap);
}

int b2t_partial(void* p, char* out, int cap) {
  auto r = static_cast<B2TDecoder*>(p)->dec->Partial();
  return PackResults({r}, out, cap);
}

}  // extern "C"

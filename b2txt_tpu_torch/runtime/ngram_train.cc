// b2txt_tpu native runtime: interpolated Kneser-Ney n-gram training.
//
// The SRILM ngram-count replacement for corpus scales where the pure-Python
// trainer (lm/ngram.py) is too slow — same estimator, hash-map counting in
// C++, streaming corpus read, ARPA output. Parity-tested against the Python
// trainer (identical backoff scores via exact-normalization bows).
//
// Exposed as a C API consumed via ctypes from b2txt_tpu.runtime.train_ngram_native.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace b2t_train {

constexpr int kMaxOrder = 6;
constexpr double kLog10 = 2.302585092994046;
constexpr double kNoProb10 = -99.0;

static uint64_t HashIds(const int* ids, int n) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < n; ++i) {
    h ^= static_cast<uint64_t>(ids[i] + 1);
    h *= 1099511628211ull;
  }
  return h;
}

struct GramTable {
  // gram storage: flat ids (order per entry), counts, probs, bows
  int order;
  std::unordered_map<uint64_t, int32_t> index;
  std::vector<int32_t> ids;     // size order * n
  std::vector<int64_t> count;
  std::vector<double> logp;     // natural log
  std::vector<double> bow;      // natural log

  int32_t FindOrAdd(const int* g) {
    uint64_t h = HashIds(g, order);
    auto it = index.find(h);
    if (it != index.end()) return it->second;
    int32_t idx = static_cast<int32_t>(count.size());
    index.emplace(h, idx);
    ids.insert(ids.end(), g, g + order);
    count.push_back(0);
    return idx;
  }

  int32_t Find(const int* g) const {
    auto it = index.find(HashIds(g, order));
    return it == index.end() ? -1 : it->second;
  }

  size_t size() const { return count.size(); }
  const int32_t* Gram(int32_t i) const { return &ids[size_t(i) * order]; }
};

struct Trainer {
  int order;
  double discount;
  std::unordered_map<std::string, int> word_ids;
  std::vector<std::string> words;
  int bos, eos, unk;
  bool limit_vocab = false;
  std::unordered_set<int> vocab;

  std::vector<GramTable> counts;        // raw counts, order 1..N
  std::vector<GramTable> cont;          // continuation counts for orders 1..N-1
  // context aggregates
  std::vector<std::unordered_map<uint64_t, int64_t>> ctx_totals;   // per order
  std::vector<std::unordered_map<uint64_t, int64_t>> type_counts;  // per order
  // the unigram normalizers do not depend on the word: summed once in
  // Estimate, not in every UnigramP call (a sum over the vocabulary per word
  // is quadratic: ~50 s at 125k words)
  int64_t uni_total = 0, uni_types = 0;

  int Intern(const std::string& w) {
    auto it = word_ids.find(w);
    if (it != word_ids.end()) return it->second;
    int id = static_cast<int>(words.size());
    word_ids.emplace(w, id);
    words.push_back(w);
    return id;
  }

  Trainer(int order_, double discount_) : order(order_), discount(discount_) {
    bos = Intern("<s>");
    eos = Intern("</s>");
    unk = Intern("<unk>");
    counts.resize(order);
    cont.resize(order);
    for (int n = 0; n < order; ++n) {
      counts[n].order = n + 1;
      cont[n].order = n + 1;
    }
  }

  void AddSentence(const std::vector<int>& sent_words) {
    std::vector<int> padded;
    padded.reserve(sent_words.size() + 2);
    padded.push_back(bos);
    for (int w : sent_words) padded.push_back(w);
    padded.push_back(eos);
    int L = static_cast<int>(padded.size());
    for (int n = 1; n <= order; ++n) {
      for (int i = 0; i + n <= L; ++i) {
        int32_t idx = counts[n - 1].FindOrAdd(&padded[i]);
        counts[n - 1].count[idx]++;
      }
    }
  }

  void LoadCorpus(const std::string& path) {
    std::ifstream f(path);
    std::string line;
    std::vector<int> sent;
    while (std::getline(f, line)) {
      sent.clear();
      std::istringstream ss(line);
      std::string w;
      while (ss >> w) {
        int id;
        if (limit_vocab) {
          auto it = word_ids.find(w);
          id = (it != word_ids.end() && vocab.count(it->second))
                   ? it->second
                   : unk;
        } else {
          id = Intern(w);
        }
        sent.push_back(id);
      }
      if (!sent.empty()) AddSentence(sent);
    }
  }

  // ---- estimation (mirrors lm/ngram.py train_ngram / prob2 exactly) ----

  void BuildContinuation() {
    // cont[n-1][gram] = #distinct left extensions of the n-gram (from order n+1 types)
    for (int n = 2; n <= order; ++n) {
      GramTable& src = counts[n - 1];
      GramTable& dst = cont[n - 2];
      for (size_t i = 0; i < src.size(); ++i) {
        const int32_t* g = src.Gram(static_cast<int32_t>(i));
        int32_t idx = dst.FindOrAdd(g + 1);
        dst.count[idx]++;
      }
    }
  }

  void BuildAggregates() {
    ctx_totals.assign(order, {});
    type_counts.assign(order, {});
    // highest order: raw counts; lower orders: continuation counts
    {
      GramTable& t = counts[order - 1];
      for (size_t i = 0; i < t.size(); ++i) {
        const int32_t* g = t.Gram(static_cast<int32_t>(i));
        uint64_t ch = HashIds(g, order - 1);
        ctx_totals[order - 1][ch] += t.count[i];
        type_counts[order - 1][ch] += 1;
      }
    }
    for (int n = 2; n < order; ++n) {
      GramTable& t = cont[n - 1];
      for (size_t i = 0; i < t.size(); ++i) {
        const int32_t* g = t.Gram(static_cast<int32_t>(i));
        uint64_t ch = HashIds(g, n - 1);
        ctx_totals[n - 1][ch] += t.count[i];
        type_counts[n - 1][ch] += 1;
      }
    }
  }

  // unigram support: corpus word types except <s>, plus </s> and <unk>
  std::vector<int> VocabWords() const {
    std::vector<int> out;
    for (size_t i = 0; i < counts[0].size(); ++i) {
      int w = counts[0].Gram(static_cast<int32_t>(i))[0];
      if (w != bos) out.push_back(w);
    }
    std::unordered_set<int> seen(out.begin(), out.end());
    if (!seen.count(unk)) out.push_back(unk);
    if (!seen.count(eos)) out.push_back(eos);
    return out;
  }

  void SumUnigramNormalizers() {
    uni_total = uni_types = 0;
    if (order == 1) {
      for (size_t i = 0; i < counts[0].size(); ++i)
        if (counts[0].Gram(static_cast<int32_t>(i))[0] != bos)
          uni_total += counts[0].count[i];
      return;
    }
    for (size_t i = 0; i < cont[0].size(); ++i) {
      uni_total += cont[0].count[i];
      uni_types++;
    }
  }

  double UnigramP(int w, const std::vector<int>& vw) const {
    int V = static_cast<int>(vw.size());
    if (order == 1) {
      int64_t total = uni_total;
      int32_t idx = counts[0].Find(&w);
      int64_t c = idx >= 0 ? counts[0].count[idx] : 0;
      return (c + 0.5) / (total + 0.5 * V);
    }
    int64_t total = uni_total;
    int64_t nt = uni_types;
    int32_t idx = cont[0].Find(&w);
    int64_t c = idx >= 0 ? cont[0].count[idx] : 0;
    double disc = std::max(double(c) - discount, 0.0) / std::max<int64_t>(total, 1);
    double lam = discount * double(nt) / std::max<int64_t>(total, 1);
    return disc + lam / V;
  }

  double LevelP(int n, const int* gram, const std::vector<int>& vw) const {
    if (n == 1) return UnigramP(gram[0], vw);
    uint64_t ch = HashIds(gram, n - 1);
    int64_t c, total;
    if (n == order) {
      int32_t idx = counts[n - 1].Find(gram);
      c = idx >= 0 ? counts[n - 1].count[idx] : 0;
      auto it = ctx_totals[n - 1].find(ch);
      total = it != ctx_totals[n - 1].end() ? it->second : 0;
    } else {
      int32_t idx = cont[n - 1].Find(gram);
      c = idx >= 0 ? cont[n - 1].count[idx] : 0;
      auto it = ctx_totals[n - 1].find(ch);
      total = it != ctx_totals[n - 1].end() ? it->second : 0;
    }
    if (total == 0) return LevelP(n - 1, gram + 1, vw);
    auto tt = type_counts[n - 1].find(ch);
    int64_t nt = tt != type_counts[n - 1].end() ? tt->second : 0;
    double disc = std::max(double(c) - discount, 0.0) / total;
    double lam = discount * double(nt) / total;
    return disc + lam * LevelP(n - 1, gram + 1, vw);
  }

  // backoff scorer over the finalized tables up to a given order
  double LogP(int max_n, const int* ctx, int ctx_len, int w) const {
    int start = std::max(0, ctx_len - (max_n - 1));
    const int* c = ctx + start;
    int n = ctx_len - start;
    double bo_sum = 0.0;
    while (true) {
      int gram[kMaxOrder + 1];
      for (int i = 0; i < n; ++i) gram[i] = c[i];
      gram[n] = w;
      int32_t idx = counts[n].Find(gram);
      if (idx >= 0 && counts[n].logp[idx] > (kNoProb10 * kLog10) + 1e-3) {
        return bo_sum + counts[n].logp[idx];
      }
      if (n == 0) {
        double p = idx >= 0 ? counts[0].logp[idx] : kNoProb10 * kLog10;
        return bo_sum + p;
      }
      int32_t bi = counts[n - 1].Find(c);
      if (bi >= 0) bo_sum += counts[n - 1].bow[bi];
      ++c;
      --n;
    }
  }

  void Estimate() {
    BuildContinuation();
    BuildAggregates();
    std::vector<int> vw = VocabWords();

    // unigram table: replace raw counts table entries with the support set
    {
      GramTable fresh;
      fresh.order = 1;
      for (int w : vw) {
        int g[1] = {w};
        int32_t idx = fresh.FindOrAdd(g);
        fresh.count[idx] = 1;
      }
      int gb[1] = {bos};
      fresh.FindOrAdd(gb);
      // carry original raw counts where present (for order==1 UnigramP)
      for (size_t i = 0; i < fresh.size(); ++i) {
        int32_t oi = counts[0].Find(fresh.Gram(static_cast<int32_t>(i)));
        fresh.count[i] = oi >= 0 ? counts[0].count[oi] : 0;
      }
      std::swap(counts[0].index, fresh.index);
      std::swap(counts[0].ids, fresh.ids);
      std::swap(counts[0].count, fresh.count);
    }
    SumUnigramNormalizers();

    // probabilities
    for (int n = 1; n <= order; ++n) {
      GramTable& t = counts[n - 1];
      t.logp.assign(t.size(), kNoProb10 * kLog10);
      t.bow.assign(t.size(), 0.0);
      for (size_t i = 0; i < t.size(); ++i) {
        const int32_t* g = t.Gram(static_cast<int32_t>(i));
        if (g[n - 1] == bos) continue;  // never predict <s>
        if (n > 1 && t.count[i] == 0) continue;
        double p = LevelP(n, g, vw);
        t.logp[i] = std::log(std::max(p, 1e-99));
      }
    }

    // backoff weights, ascending: bow(ctx) = (1-Σp_seen)/(1-Σp_low)
    for (int n = 2; n <= order; ++n) {
      GramTable& t = counts[n - 1];
      std::unordered_map<uint64_t, std::pair<double, double>> sums;
      std::unordered_map<uint64_t, int32_t> ctx_entry;
      for (size_t i = 0; i < t.size(); ++i) {
        if (t.logp[i] <= (kNoProb10 * kLog10) + 1e-3) continue;
        const int32_t* g = t.Gram(static_cast<int32_t>(i));
        uint64_t ch = HashIds(g, n - 1);
        double p = std::exp(t.logp[i]);
        double plow = std::exp(LogP(n - 1, g + 1, n - 2, g[n - 1]));
        auto& s = sums[ch];
        s.first += p;
        s.second += plow;
      }
      GramTable& ct = counts[n - 2];
      for (auto& kv : sums) {
        // locate/create the context entry in the (n-1)-gram table
        // find any gram with this context by re-deriving from a member —
        // store ids lazily: we need the context ids; recover from first gram
        // (second pass below)
        (void)kv;
      }
      // second pass to attach bows (we need context ids; walk grams again)
      std::unordered_set<uint64_t> done;
      for (size_t i = 0; i < t.size(); ++i) {
        if (t.logp[i] <= (kNoProb10 * kLog10) + 1e-3) continue;
        const int32_t* g = t.Gram(static_cast<int32_t>(i));
        uint64_t ch = HashIds(g, n - 1);
        if (done.count(ch)) continue;
        done.insert(ch);
        auto s = sums[ch];
        double num = std::max(1.0 - s.first, 1e-99);
        double den = std::max(1.0 - s.second, 1e-99);
        double b = std::log(num) - std::log(den);
        int32_t ci = ct.FindOrAdd(g);  // context gram (first n-1 ids)
        if (ci >= static_cast<int32_t>(ct.logp.size())) {
          ct.logp.resize(ci + 1, kNoProb10 * kLog10);
          ct.bow.resize(ci + 1, 0.0);
          ct.count.resize(ci + 1, 0);
        }
        ct.bow[ci] = b;
      }
    }
  }

  bool WriteArpa(const std::string& path) const {
    std::ofstream f(path);
    if (!f) return false;
    // count real entries per order
    std::vector<std::vector<int32_t>> keep(order);
    for (int n = 1; n <= order; ++n) {
      const GramTable& t = counts[n - 1];
      for (size_t i = 0; i < t.size(); ++i) {
        bool has_p = t.logp[i] > (kNoProb10 * kLog10) + 1e-3;
        bool has_b = n < order && std::abs(t.bow[i]) > 1e-12;
        if (has_p || has_b) keep[n - 1].push_back(static_cast<int32_t>(i));
      }
      // sort lexicographically by word strings for stable output
      std::sort(keep[n - 1].begin(), keep[n - 1].end(),
                [&](int32_t a, int32_t b) {
                  const int32_t* ga = t.Gram(a);
                  const int32_t* gb = t.Gram(b);
                  for (int k = 0; k < n; ++k) {
                    if (words[ga[k]] != words[gb[k]])
                      return words[ga[k]] < words[gb[k]];
                  }
                  return false;
                });
    }
    f << "\n\\data\\\n";
    for (int n = 1; n <= order; ++n)
      f << "ngram " << n << "=" << keep[n - 1].size() << "\n";
    f.precision(7);
    f << std::fixed;
    for (int n = 1; n <= order; ++n) {
      f << "\n\\" << n << "-grams:\n";
      const GramTable& t = counts[n - 1];
      for (int32_t i : keep[n - 1]) {
        double p10 = t.logp[i] / kLog10;
        if (p10 < -98.9) p10 = -99.0;
        f << p10 << "\t";
        const int32_t* g = t.Gram(i);
        for (int k = 0; k < n; ++k) {
          if (k) f << ' ';
          f << words[g[k]];
        }
        if (n < order && std::abs(t.bow[i]) > 1e-12)
          f << "\t" << t.bow[i] / kLog10;
        f << "\n";
      }
    }
    f << "\n\\end\\\n";
    return true;
  }
};

}  // namespace b2t_train

extern "C" {

// Returns 0 on success. vocab_path may be empty (no -limit-vocab).
int b2t_train_ngram(const char* corpus_path, const char* vocab_path,
                    int order, double discount, const char* out_arpa) {
  if (order < 1 || order > b2t_train::kMaxOrder) return 2;
  b2t_train::Trainer tr(order, discount);
  if (vocab_path && vocab_path[0]) {
    std::ifstream vf(vocab_path);
    if (!vf) return 3;
    std::string w;
    tr.limit_vocab = true;
    while (vf >> w) tr.vocab.insert(tr.Intern(w));
  }
  tr.LoadCorpus(corpus_path);
  if (tr.counts[0].size() == 0) return 4;
  tr.Estimate();
  return tr.WriteArpa(out_arpa) ? 0 : 5;
}

}  // extern "C"

// The device beam search's frame step for Hopper (sm_90a), bound with ctypes:
// K6 of the port.
//
// Replaces no TPU kernel: the JAX package's frame step (lmbeam_jax.py) is XLA.
// It replaces the port's frame step issued op by op, `_expand` with its
// masking and record writes (decode/lmbeam_device.py), ~600 kernels a frame,
// each a few microseconds of launch and DRAM round trip for a few KB of work.
// One CTA takes one utterance row of the batch and does, in shared memory:
//
//   1. the row's K beams and its frame of log-probs in; each beam's score
//      (max or log-sum-exp of its two CTC paths) and acoustic total;
//   2. the frame's first beam: the phones (blank and SIL aside) at or above
//      its `first_beam`-th best log-prob, ties included, as the host
//      searchers threshold it (every phone without one); the trie's packed
//      node rows and [child, lookahead] pairs;
//   3. the close branch's n-gram scores as DeviceNGram.logp_words gives them:
//      each context suffix hashed once a beam, one bucket-row probe a gram and
//      a context backoff (at most one hit a bucket), the longest match with
//      its accumulated backoff, the dense unigrams of the node row;
//   4. the candidates in `_expand`'s order (stay K, extend K*E for the E
//      phones of the first beam, silence at the root K, close K*H): a 64-bit
//      identity key, four score columns (`_expand` also lays out the phones
//      outside the beam, at NEG; they can only fill slots at the NEG floor);
//   5. one bitonic sort of (key, Viterbi rank, candidate) ascending, so each
//      key's segment ends in its best path, the element `_expand`'s two stable
//      sorts leave last, and its members lie in their order of summation;
//   6. each segment merged as _seg_merge4 does (in Viterbi each ranking
//      column's best path with its own acoustic score; in sum mode a
//      max-shifted log-sum-exp summed in that order), its total at its end;
//   7. a second bitonic sort of (total descending, position) for the top K,
//      at NEG the invalid ones (fewer segments than K) and, with a `beam`,
//      those more than `beam` below the best (the host searchers' window);
//   8. the survivors' payloads rebuilt from their candidate index and written
//      in place over the row's state, with row t of the parents (int16) and
//      words; a row past its length keeps its beams. The last CTA to finish
//      advances the frame counter t, so a frame is one launch.
//
// Numerics: every score operation is a float32 add, subtract or multiply in
// `_expand`'s order with no contraction (__fadd_rn, __fsub_rn, __fmul_rn), and
// expf, log1pf and logf are the CUDA library's, as PyTorch's kernels call them,
// so a live beam's scores equal `_expand`'s bit for bit on the card.
//
// What bounds it: neither bytes nor operations. A frame of 32 rows reads ~9
// bucket rows of 256 B a beam (~3.5 MB, ~1 us at 3.35 TB/s) and does ~1e6
// integer and float operations; what is left is the chain of dependent steps
// above (a DRAM round trip for the trie rows, another for the probes, the two
// sorts' ~110 barrier-separated stages), a few tens of microseconds on one SM
// a row. The design keeps every intermediate in shared memory, issues each
// DRAM round trip for the whole row at once (a thread a probe, its bucket's
// sixteen 16-byte slots loaded together), and never leaves the SM between
// the reads of the frame and the writes of the next state. The one
// exception is a frame whose candidates outgrow what a CTA has left after
// the beams' own arrays (K = 128 with every phone in the first beam: ~6,000
// candidates, a sort of 8,192): its candidates and both sorts run in the
// row's slice of a global workspace, which stays in the SM's L1 and L2.
//
// The caller's contract (ops/beam_step.py checks it): state arrays (B, K) and
// ctx (B, K, CW) contiguous and updated in place; lp (B, T_lp, V) float32, the
// frame read at row *t + t_offset; lens (B,) int64 or null (every row active);
// parents (T, B, K) int16 and words (T, B, K) int32, or both null (no record);
// node_pack (nodes, 2H + 1), next_la2 (nodes, V, 2), table (buckets, cap * 4)
// int32 with buckets a power of two and cap a multiple of 16; the beams' own
// arrays (b2t_beam_step_fixed) within a CTA's 232,448 bytes less 1,024; work
// B * b2t_beam_step_work() bytes, 16-aligned, or null where that is 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
// a CTA's shared memory on Hopper (227 KB), less room for the static variables
constexpr int MAX_DYNAMIC_SMEM = 232448 - 1024;
constexpr float NEG = -1.0e30f;
constexpr uint32_t SEED1 = 0x9E3779B9u, SEED2 = 0x7F4A7C15u;
constexpr uint32_t H1_INIT = 0x811C9DC5u, H2_INIT = 0x01000193u;

struct Params {
  int *h1, *h2, *node, *last, *ctx;
  float *s, *ns, *acs, *acns, *lm;
  const float* lp;
  const long long* lens;
  long long* t;
  unsigned* ticket;
  short* parents;
  int* words;
  const int *node_pack, *next_la2, *table;
  const float *uni_logp, *uni_bow;
  unsigned char* work;
  int B, K, V, T_lp, CW, H, first_beam, order, n_buckets, cap, blank, sil, n_exact,
      ngram_key, sum_mode, t_offset, advance;
  float scale, length_penalty, la0, unk_logp, beam;
};

__host__ __device__ inline size_t take(size_t& o, size_t n) {
  const size_t at = o;
  o += (n + 15) / 16 * 16;
  return at;
}

__host__ __device__ inline int pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The candidates' arrays for N candidates, sorted as P = pow2(N): keys, the
// secondary keys, four score columns of N, the segment totals.
struct Cands {
  size_t skey, ssec, sc, tot, bytes;

  __host__ __device__ explicit Cands(int N) {
    const int P = pow2(N);
    size_t o = 0;
    skey = take(o, (size_t)P * 8);
    ssec = take(o, (size_t)P * 8);
    sc = take(o, (size_t)4 * N * 4);
    tot = take(o, (size_t)P * 4);
    bytes = o;
  }
};

// The shared memory of one CTA: the beams' own arrays (every offset in
// bytes, 16-aligned), then the candidates' at `cand`. Room is planned for up
// to K * (2 + V + H) candidates (every phone in the first beam: ties at its
// threshold can bring them). Where that outgrows a CTA, the launch takes all
// of it and a row whose frame brings more candidates than the rest holds
// keeps them in its slice of a global workspace, `work` bytes a row.
struct Layout {
  int L;
  size_t beam_i, beam_f, bctx, wid, uniw, wlp, ch, gv, gf, cbow, cf, ex1, child, lachild, ph,
      lprow, cand, bytes, work;

  __host__ __device__ Layout(int K, int V, int H, int CW, int order) {
    L = order > 1 ? order - 1 : 0;
    size_t o = 0;
    beam_i = take(o, (size_t)5 * K * 4);   // h1, h2, node, last, n_valid
    beam_f = take(o, (size_t)9 * K * 4);   // s, ns, acs, acns, lm, score, ac, la_node, bow1
    bctx = take(o, (size_t)K * CW * 4);
    wid = take(o, (size_t)K * H * 4);
    uniw = take(o, (size_t)K * H * 4);
    wlp = take(o, (size_t)K * H * 4);
    ch = take(o, (size_t)2 * K * L * 4);   // context suffix hashes, both lanes
    gv = take(o, (size_t)L * K * H * 4);
    gf = take(o, (size_t)L * K * H);
    cbow = take(o, (size_t)(L > 1 ? L - 1 : 0) * K * 4);
    cf = take(o, (size_t)(L > 1 ? L - 1 : 0) * K);
    ex1 = take(o, (size_t)K);
    child = take(o, (size_t)K * V * 4);
    lachild = take(o, (size_t)K * V * 4);
    ph = take(o, (size_t)V * 4);
    lprow = take(o, (size_t)V * 4);
    cand = o;
    const size_t most = Cands(K * (2 + V + H)).bytes;
    const bool fits = cand + most <= (size_t)MAX_DYNAMIC_SMEM;
    bytes = fits ? cand + most : (size_t)MAX_DYNAMIC_SMEM;
    work = fits ? 0 : most;
  }
};

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// decode/lmbeam_device.py's _logaddexp
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, NEG);
  const float out = fadd(ms, log1pf(expf(fsub(fminf(a, b), ms))));
  return m <= NEG ? NEG : out;
}

// lm/device_ngram.py's _mix and hash_extend, on uint32
__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t c, uint32_t seed) {
  uint32_t x = h ^ (c * seed);
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ void extend(uint32_t& h1, uint32_t& h2, int id) {
  const uint32_t c = (uint32_t)(id + 3);
  h1 = mix(h1, c, SEED1);
  h2 = mix(h2, c, SEED2);
}

// _expand's sort_keys: identity (history, trie node, last phone) as one
// unsigned 64-bit key, whose order is _key64's
__device__ __forceinline__ uint64_t merge_key(uint32_t h1, uint32_t h2, int node, int last,
                                              int V) {
  extend(h1, h2, node * (V + 2) + last + 2);
  return ((uint64_t)h1 << 32) | h2;
}

// a float's bits as an unsigned integer of the same order (-0 as +0)
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// one bucket row (cap slots of [key1, key2, value, backoff]): at most one hit
__device__ __forceinline__ bool probe(const int* __restrict__ table, int n_buckets, int cap,
                                      uint32_t h1, uint32_t h2, int& vbits, int& bbits) {
  if (h1 == 0 && h2 == 0) h1 = 1;  // (0, 0) marks an empty slot
  const int4* row = reinterpret_cast<const int4*>(table) + (size_t)(h1 & (n_buckets - 1)) * cap;
  bool found = false;
  vbits = 0;
  bbits = 0;
  for (int s0 = 0; s0 < cap; s0 += 16) {
    int4 e[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) e[s] = __ldg(row + s0 + s);
#pragma unroll
    for (int s = 0; s < 16; ++s) {
      if ((uint32_t)e[s].x == h1 && (uint32_t)e[s].y == h2) {
        found = true;
        vbits += e[s].z;
        bbits += e[s].w;
      }
    }
  }
  return found;
}

// ascending bitonic sort of P (a power of two) entries; with `sec`, by
// (key, sec), else by key alone
template <bool SEC>
__device__ void bitonic(uint64_t* key, uint64_t* sec, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (P >> 1); i += blockDim.x) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const uint64_t a = key[lo], b = key[hi];
        bool greater = a > b;
        if (SEC) greater = greater || (a == b && sec[lo] > sec[hi]);
        if (greater == ((lo & k) == 0)) {
          key[lo] = b;
          key[hi] = a;
          if (SEC) {
            const uint64_t t = sec[lo];
            sec[lo] = sec[hi];
            sec[hi] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}

// WORK: the shape may need the workspace (Layout::work > 0). Without it the
// candidates are known to be in shared memory and addressed as such.
template <bool WORK>
__global__ void __launch_bounds__(THREADS) beam_step_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_frame;
  __shared__ int s_active, s_phones;
  __shared__ float s_kth;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int K = p.K, V = p.V, H = p.H, CW = p.CW;
  const Layout lay(K, V, H, CW, p.order);
  const int L = lay.L;

  if (tid == 0) {
    const long long f = *p.t + p.t_offset;
    s_frame = f;
    s_active = p.lens == nullptr || p.lens[b] > f;
  }
  __syncthreads();
  const long long frame = s_frame;
  const size_t rec = ((size_t)frame * p.B + b) * K;

  if (!s_active) {  // a row past its length keeps its beams
    if (p.parents != nullptr)
      for (int r = tid; r < K; r += nt) {
        p.parents[rec + r] = (short)r;
        p.words[rec + r] = -1;
      }
  } else {
    int* bh1 = reinterpret_cast<int*>(smem + lay.beam_i);
    int* bh2 = bh1 + K;
    int* bnode = bh2 + K;
    int* blast = bnode + K;
    int* nvalid = blast + K;
    float* bs = reinterpret_cast<float*>(smem + lay.beam_f);
    float* bns = bs + K;
    float* bacs = bns + K;
    float* bacns = bacs + K;
    float* blm = bacns + K;
    float* bscore = blm + K;
    float* bac = bscore + K;
    float* bla = bac + K;
    float* bow1 = bla + K;
    int* bctx = reinterpret_cast<int*>(smem + lay.bctx);
    int* wid = reinterpret_cast<int*>(smem + lay.wid);
    float* uniw = reinterpret_cast<float*>(smem + lay.uniw);
    float* wlp = reinterpret_cast<float*>(smem + lay.wlp);
    uint32_t* ch1 = reinterpret_cast<uint32_t*>(smem + lay.ch);
    uint32_t* ch2 = ch1 + K * L;
    float* gv = reinterpret_cast<float*>(smem + lay.gv);
    unsigned char* gf = smem + lay.gf;
    float* cbow = reinterpret_cast<float*>(smem + lay.cbow);
    unsigned char* cf = smem + lay.cf;
    unsigned char* ex1 = smem + lay.ex1;
    int* child = reinterpret_cast<int*>(smem + lay.child);
    float* lachild = reinterpret_cast<float*>(smem + lay.lachild);
    int* ph = reinterpret_cast<int*>(smem + lay.ph);
    float* lprow = reinterpret_cast<float*>(smem + lay.lprow);
    const int H2 = 2 * H + 1;
    const float scale = p.scale;

    // ---- 1. the row's beams and its frame
    for (int k = tid; k < K; k += nt) {
      const size_t o = (size_t)b * K + k;
      bh1[k] = p.h1[o];
      bh2[k] = p.h2[o];
      bnode[k] = p.node[o];
      blast[k] = p.last[o];
      const float s = p.s[o], ns = p.ns[o], acs = p.acs[o], acns = p.acns[o];
      bs[k] = s;
      bns[k] = ns;
      bacs[k] = acs;
      bacns[k] = acns;
      blm[k] = p.lm[o];
      bscore[k] = p.sum_mode ? logaddexp(s, ns) : fmaxf(s, ns);
      bac[k] = logaddexp(acs, acns);
    }
    for (int i = tid; i < K * CW; i += nt) bctx[i] = p.ctx[(size_t)b * K * CW + i];
    const float* lp_row = p.lp + ((size_t)b * p.T_lp + frame) * V;
    for (int c = tid; c < V; c += nt) lprow[c] = lp_row[c];
    __syncthreads();

    // ---- 2. node rows, the frame's phones, context hashes
    for (int i = tid; i < K * H2; i += nt) {
      const int k = i / H2, j = i - k * H2;
      const int v = p.node_pack[(size_t)bnode[k] * H2 + j];
      if (j < H) wid[k * H + j] = v;
      else if (j < 2 * H) uniw[k * H + j - H] = __int_as_float(v);
      else bla[k] = __int_as_float(v);
    }
    if (p.first_beam > 0)  // the first_beam-th best log-prob, blank and SIL aside
      for (int c = tid; c < V; c += nt) {
        const float mine = (c == p.blank || c == p.sil) ? -INFINITY : lprow[c];
        int rank = 0;
        for (int q = 0; q < V; ++q) {
          const float o = (q == p.blank || q == p.sil) ? -INFINITY : lprow[q];
          rank += (o > mine) || (o == mine && q < c);
        }
        if (rank == p.first_beam - 1) s_kth = mine;
      }
    for (int i = tid; i < K * L; i += nt) {  // suffix of the context from `start`
      const int k = i / L, start = i - k * L;
      uint32_t h1 = H1_INIT, h2 = H2_INIT;
      for (int j = start; j < L; ++j) {
        const int w = bctx[k * CW + j];
        if (w >= 0) extend(h1, h2, w);
      }
      ch1[i] = h1;
      ch2[i] = h2;
    }
    if (L > 0)
      for (int k = tid; k < K; k += nt) {
        int n = 0;
        for (int j = 0; j < L; ++j) n += bctx[k * CW + j] >= 0;
        nvalid[k] = n;
        const int last = max(bctx[k * CW + L - 1], 0);
        bow1[k] = p.uni_bow[last];
        ex1[k] = p.uni_logp[last] > -5.0e8f;  // MISSING / 2
      }
    __syncthreads();

    // ---- 3. the first beam's phones in order, children and the n-gram
    // probes, all in flight together
    if (tid == 0) {
      int n = 0;
      for (int c = 0; c < V; ++c)
        if (c != p.blank && c != p.sil && (p.first_beam == 0 || lprow[c] >= s_kth)) ph[n++] = c;
      s_phones = n;
    }
    __syncthreads();
    const int FB = s_phones, N = K * (2 + FB + H), P = pow2(N);
    const Cands cl(N);
    unsigned char* cand = !WORK || lay.cand + cl.bytes <= lay.bytes
                              ? smem + lay.cand
                              : p.work + (size_t)b * lay.work;
    uint64_t* skey = reinterpret_cast<uint64_t*>(cand + cl.skey);
    uint64_t* ssec = reinterpret_cast<uint64_t*>(cand + cl.ssec);
    float* sc = reinterpret_cast<float*>(cand + cl.sc);  // 4 columns of N
    float* tot = reinterpret_cast<float*>(cand + cl.tot);
    for (int i = tid; i < K * FB; i += nt) {
      const int k = i / FB, j = i - k * FB;
      const int* pair = p.next_la2 + ((size_t)bnode[k] * V + ph[j]) * 2;
      child[i] = pair[0];
      lachild[i] = __int_as_float(pair[1]);
    }
    const int n_probe = min(p.n_exact, H);
    const int n_gram = L * K * n_probe, n_ctx = (L > 1 ? L - 1 : 0) * K;
    for (int i = tid; i < n_gram + n_ctx; i += nt) {
      int vbits, bbits;
      if (i < n_gram) {  // level L - li: the gram (context suffix from li, word)
        const int li = i / (K * n_probe), rem = i - li * K * n_probe;
        const int k = rem / n_probe, h = rem - k * n_probe;
        uint32_t h1 = ch1[k * L + li], h2 = ch2[k * L + li];
        extend(h1, h2, max(wid[k * H + h], 0));
        const bool f = probe(p.table, p.n_buckets, p.cap, h1, h2, vbits, bbits);
        gv[(li * K + k) * H + h] = f ? __int_as_float(vbits) : p.unk_logp;
        gf[(li * K + k) * H + h] = f;
      } else {  // level L - li >= 2: the context's own backoff
        const int j = i - n_gram, li = j / K, k = j - li * K;
        const bool f = probe(p.table, p.n_buckets, p.cap, ch1[k * L + li], ch2[k * L + li],
                             vbits, bbits);
        cbow[j] = f ? __int_as_float(bbits) : 0.0f;
        cf[j] = f;
      }
    }
    __syncthreads();

    // ---- 4. each (beam, homophone)'s n-gram score: the longest match with
    // its accumulated backoff, else the unigram, else <unk>
    for (int i = tid; i < K * H; i += nt) {
      const int k = i / H, h = i - k * H;
      float result = p.unk_logp, bo = 0.0f;
      bool resolved = false;
      for (int li = 0; li < L; ++li) {
        const int level = L - li;
        const bool level_ok = nvalid[k] >= level;
        const bool found = h < n_probe && gf[(li * K + k) * H + h];
        const float v = h < n_probe ? gv[(li * K + k) * H + h] : 0.0f;
        const bool hit = found && v > -200.0f && level_ok && !resolved;
        if (hit) result = fadd(bo, v);
        resolved = resolved || hit;
        const bool exists = level >= 2 ? cf[li * K + k] != 0 : ex1[k] != 0;
        const float bow = level >= 2 ? cbow[li * K + k] : bow1[k];
        bo = fadd(bo, (exists && level_ok && !resolved) ? bow : 0.0f);
      }
      const float u = uniw[i];
      const bool hit0 = u > -200.0f && !resolved;
      if (hit0) result = fadd(bo, u);
      resolved = resolved || hit0;
      wlp[i] = fadd(resolved ? result : fadd(bo, p.unk_logp), p.length_penalty);
    }
    __syncthreads();

    // ---- 5. the candidates: stay, extend, silence at the root, close
    const int e0 = K, r0 = K + K * FB, c0 = 2 * K + K * FB;
    const float lp_blank = lprow[p.blank], lp_sil = lprow[p.sil];
    for (int i = tid; i < P; i += nt) {
      if (i >= N) {
        skey[i] = ~0ull;
        ssec[i] = ~0ull;
        continue;
      }
      float s = NEG, ns = NEG, as = NEG, ans = NEG;
      uint64_t key;
      if (i < e0) {
        const int k = i, last = blast[k];
        const bool has_last = last >= 0;
        const float lp_last = has_last ? lprow[min(last, V - 1)] : NEG;
        key = merge_key(bh1[k], bh2[k], bnode[k], last, V);
        s = fadd(bscore[k], fmul(scale, lp_blank));
        if (has_last) ns = fadd(bns[k], fmul(scale, lp_last));
        as = fadd(bac[k], lp_blank);
        if (has_last) ans = fadd(bacns[k], lp_last);
      } else if (i < r0) {
        const int q = i - e0, k = q / FB, j = q - k * FB;
        const int c = ph[j], ch = child[q];
        const float lpe = lprow[c];
        const bool rep = c == blast[k];
        const bool ok = c != p.blank && c != p.sil && ch >= 0 && isfinite(lpe);
        key = merge_key(bh1[k], bh2[k], max(ch, 0), c, V);
        if (ok) {
          ns = fadd(fadd(rep ? bs[k] : bscore[k], fmul(scale, lpe)), fsub(lachild[q], bla[k]));
          ans = fadd(rep ? bacs[k] : bac[k], lpe);
        }
      } else if (i < c0) {
        const int k = i - r0;
        const bool last_sil = blast[k] == p.sil;
        key = merge_key(bh1[k], bh2[k], 0, p.sil, V);
        if (bnode[k] == 0) {
          ns = fadd(last_sil ? bs[k] : bscore[k], fmul(scale, lp_sil));
          ans = fadd(last_sil ? bacs[k] : bac[k], lp_sil);
        }
      } else {
        const int q = i - c0, k = q / H;
        const int w = wid[q];
        const bool last_sil = blast[k] == p.sil;
        uint32_t h1 = bh1[k], h2 = bh2[k];
        if (p.ngram_key) {  // hash_ctx of the new context window
          h1 = H1_INIT;
          h2 = H2_INIT;
          for (int j = 1; j < CW; ++j) extend(h1, h2, bctx[k * CW + j]);
          extend(h1, h2, max(w, 0));
        } else {
          extend(h1, h2, w + V + 2);
        }
        key = merge_key(h1, h2, 0, p.sil, V);
        if (w >= 0) {
          ns = fadd(fadd(fadd(last_sil ? bs[k] : bscore[k], fmul(scale, lp_sil)), wlp[q]),
                    fsub(p.la0, bla[k]));
          ans = fadd(last_sil ? bacs[k] : bac[k], lp_sil);
        }
      }
      sc[i] = s;
      sc[N + i] = ns;
      sc[2 * N + i] = as;
      sc[3 * N + i] = ans;
      skey[i] = key;
      ssec[i] = ((uint64_t)ordered(fmaxf(s, ns)) << 32) | (uint32_t)i;
    }
    __syncthreads();

    // ---- 6. by (key, Viterbi rank, candidate): a key's segment ends in its
    // best path
    bitonic<true>(skey, ssec, P);

    // ---- 7. merge each segment at its end: the merged columns over its
    // representative's, the ranking total into tot
    for (int i = tid; i < P; i += nt) {
      float total = -INFINITY;
      if (i < N && (i == N - 1 || skey[i + 1] != skey[i])) {
        int start = i;
        while (start > 0 && skey[start - 1] == skey[i]) --start;
        float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
        for (int e = start; e <= i; ++e) {
          const int c = (int)(uint32_t)ssec[e];
          for (int col = 0; col < (p.sum_mode ? 4 : 2); ++col)
            m[col] = fmaxf(m[col], sc[col * N + c]);
        }
        if (!p.sum_mode) {  // each acoustic column: its ranking column's best path's
          for (int e = start; e <= i; ++e) {
            const int c = (int)(uint32_t)ssec[e];
            for (int col = 0; col < 2; ++col)
              if (sc[col * N + c] == m[col]) m[2 + col] = fmaxf(m[2 + col], sc[(2 + col) * N + c]);
          }
        }
        if (p.sum_mode) {  // the ranking columns: log-sum-exp in sorted order
          for (int col = 0; col < 2; ++col) {
            const float ms = fmaxf(m[col], NEG);
            float sum = 0.0f;
            for (int e = start; e <= i; ++e)
              sum = fadd(sum, expf(fsub(sc[col * N + (int)(uint32_t)ssec[e]], ms)));
            m[col] = m[col] <= NEG ? NEG : fadd(ms, logf(sum));
          }
          total = logaddexp(m[0], m[1]);
        } else {
          total = fmaxf(m[0], m[1]);
        }
        const int rep = (int)(uint32_t)ssec[i];
        for (int col = 0; col < 4; ++col) sc[col * N + rep] = m[col];
      }
      tot[i] = total;
    }
    __syncthreads();

    // ---- 8. the top K totals, ties by position (key order)
    for (int i = tid; i < P; i += nt)
      skey[i] = i < N ? ((uint64_t)~ordered(tot[i]) << 32) | (uint32_t)i : ~0ull;
    __syncthreads();
    bitonic<false>(skey, nullptr, P);

    // ---- 9. the survivors' payloads, in place over the row's state
    const float cutoff = fsub(tot[(int)(uint32_t)skey[0]], p.beam);
    for (int r = tid; r < K; r += nt) {
      const int pos = (int)(uint32_t)skey[r];
      const bool valid = tot[pos] > -INFINITY && (p.beam <= 0.0f || tot[pos] >= cutoff);
      const int c = (int)(uint32_t)ssec[pos];
      int k, node, last, word = -1;
      uint32_t h1, h2;
      float lm;
      const int* ctx_src;
      int ctx_word = -2;  // -2: the beam's context as it is, else shifted in
      if (c < e0 || (c >= r0 && c < c0)) {  // stay or silence
        k = c < e0 ? c : c - r0;
        node = c < e0 ? bnode[k] : 0;
        last = c < e0 ? blast[k] : p.sil;
        h1 = bh1[k];
        h2 = bh2[k];
        lm = blm[k];
      } else if (c < r0) {  // extend
        const int q = c - e0;
        k = q / FB;
        node = max(child[q], 0);
        last = ph[q - k * FB];
        h1 = bh1[k];
        h2 = bh2[k];
        lm = blm[k];
      } else {  // close
        const int q = c - c0, w = wid[q];
        k = q / H;
        node = 0;
        last = p.sil;
        h1 = bh1[k];
        h2 = bh2[k];
        if (p.ngram_key) {
          h1 = H1_INIT;
          h2 = H2_INIT;
          for (int j = 1; j < CW; ++j) extend(h1, h2, bctx[k * CW + j]);
          extend(h1, h2, max(w, 0));
        } else {
          extend(h1, h2, w + V + 2);
        }
        word = w >= 0 ? w : -1;
        lm = w >= 0 ? fadd(blm[k], wlp[q]) : blm[k];
        ctx_word = max(w, 0);
      }
      ctx_src = bctx + k * CW;
      const size_t o = (size_t)b * K + r;
      p.h1[o] = (int)h1;
      p.h2[o] = (int)h2;
      p.node[o] = node;
      p.last[o] = last;
      p.lm[o] = lm;
      for (int j = 0; j < CW; ++j)
        p.ctx[o * CW + j] = ctx_word == -2 ? ctx_src[j]
                                           : (j + 1 < CW ? ctx_src[j + 1] : ctx_word);
      p.s[o] = valid ? sc[c] : NEG;
      p.ns[o] = valid ? sc[N + c] : NEG;
      p.acs[o] = valid ? sc[2 * N + c] : NEG;
      p.acns[o] = valid ? sc[3 * N + c] : NEG;
      if (p.parents != nullptr) {
        p.parents[rec + r] = (short)k;
        p.words[rec + r] = word;
      }
    }
  }

  // ---- 10. the last CTA to finish advances the frame counter: every CTA
  // read it before taking its ticket
  if (p.advance) {
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      if (atomicAdd(p.ticket, 1u) == (unsigned)gridDim.x - 1) {
        *p.ticket = 0;
        *p.t += 1;
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory a CTA of the frame step takes, of it the beams' own
// arrays, and of the global workspace a row (ops/beam_step.py's layout gives
// the same).
long long b2t_beam_step_smem(int K, int V, int H, int CW, int order) {
  return (long long)Layout(K, V, H, CW, order).bytes;
}

long long b2t_beam_step_fixed(int K, int V, int H, int CW, int order) {
  return (long long)Layout(K, V, H, CW, order).cand;
}

long long b2t_beam_step_work(int K, int V, int H, int CW, int order) {
  return (long long)Layout(K, V, H, CW, order).work;
}

// One frame of the beam search for B rows; see the contract above.
// Returns a cudaError_t (0 = launched).
int b2t_beam_step(void* h1, void* h2, void* node, void* last, void* ctx, void* s, void* ns,
                  void* acs, void* acns, void* lm, const void* lp, const void* lens, void* t,
                  void* ticket, void* parents, void* words, const void* node_pack,
                  const void* next_la2, const void* table, const void* uni_logp,
                  const void* uni_bow, void* work, int B, int K, int V, int T_lp, int CW, int H,
                  int first_beam, int order, int n_buckets, int cap, int blank, int sil, int n_exact,
                  int ngram_key, int sum_mode, int t_offset, int advance, float scale,
                  float length_penalty, float la0, float unk_logp, float beam,
                  void* stream) {
  const Layout lay(K, V, H, CW, order);
  const size_t bytes = lay.bytes;
  if (B < 1 || K < 1 || K > 32767 || first_beam < 0 || first_beam > V || H < 1 || CW < 1 ||
      cap % 16 != 0 ||
      n_buckets < 1 || (n_buckets & (n_buckets - 1)) != 0 || lay.cand > (size_t)MAX_DYNAMIC_SMEM ||
      (lay.work != 0 && work == nullptr) || (parents == nullptr) != (words == nullptr))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(beam_step_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_DYNAMIC_SMEM),
      cudaFuncSetAttribute(beam_step_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_DYNAMIC_SMEM)};
  if (attr[0] != cudaSuccess) return (int)attr[0];
  if (attr[1] != cudaSuccess) return (int)attr[1];
  Params p;
  p.h1 = static_cast<int*>(h1);
  p.h2 = static_cast<int*>(h2);
  p.node = static_cast<int*>(node);
  p.last = static_cast<int*>(last);
  p.ctx = static_cast<int*>(ctx);
  p.s = static_cast<float*>(s);
  p.ns = static_cast<float*>(ns);
  p.acs = static_cast<float*>(acs);
  p.acns = static_cast<float*>(acns);
  p.lm = static_cast<float*>(lm);
  p.lp = static_cast<const float*>(lp);
  p.lens = static_cast<const long long*>(lens);
  p.t = static_cast<long long*>(t);
  p.ticket = static_cast<unsigned*>(ticket);
  p.parents = static_cast<short*>(parents);
  p.words = static_cast<int*>(words);
  p.node_pack = static_cast<const int*>(node_pack);
  p.next_la2 = static_cast<const int*>(next_la2);
  p.table = static_cast<const int*>(table);
  p.uni_logp = static_cast<const float*>(uni_logp);
  p.uni_bow = static_cast<const float*>(uni_bow);
  p.work = static_cast<unsigned char*>(work);
  p.B = B;
  p.K = K;
  p.V = V;
  p.T_lp = T_lp;
  p.CW = CW;
  p.H = H;
  p.first_beam = first_beam;
  p.order = order;
  p.n_buckets = n_buckets;
  p.cap = cap;
  p.blank = blank;
  p.sil = sil;
  p.n_exact = n_exact;
  p.ngram_key = ngram_key;
  p.sum_mode = sum_mode;
  p.t_offset = t_offset;
  p.advance = advance;
  p.scale = scale;
  p.length_penalty = length_penalty;
  p.la0 = la0;
  p.unk_logp = unk_logp;
  p.beam = beam;
  if (lay.work != 0)
    beam_step_kernel<true><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  else
    beam_step_kernel<false><<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* b2t_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

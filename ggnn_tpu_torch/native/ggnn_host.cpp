// ggnn_host: native host-side runtime of the PyTorch/CUDA port.
//
// The port's copy of ggnn_tpu/native/ggnn_host.cpp (the same functions and
// the same results): the bAbI text parser, the edge sort of batch_graphs,
// the halo partition plan, and the window layout plan of
// build_window_layout.  Multi-million-edge graphs are batched and laid out
// at memory bandwidth rather than interpreter speed; the device compute
// path is the port's CUDA kernels.
//
// Exposed as a plain extern "C" ABI consumed via ctypes
// (ggnn_tpu_torch/native/__init__.py); every entry point has a numpy
// counterpart in the port with identical results (tested equal in
// tests/test_torch_native.py).
//
// Build: at first use by ggnn_tpu_torch.native.build(), into
// ggnn_tpu_torch/_build/; by hand: make -C ggnn_tpu_torch/native

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

namespace {

struct Example {
  int32_t n_nodes = 0;
  std::vector<int32_t> edges;  // flattened (src, type, dst), 0-indexed
  int32_t qtype = 0;
  std::vector<int32_t> args;
  std::vector<int32_t> target;  // 1 entry for node/class, k for seq
};

struct ParseResult {
  std::vector<Example> examples;
};

// Parse one whitespace-separated signed integer; returns false at end.
bool next_tok(const char*& p, const char* end, std::string& tok) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  if (p >= end || *p == '\n') return false;
  const char* s = p;
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  tok.assign(s, p - s);
  return true;
}

}  // namespace

extern "C" {

// target_kind: 0 = scalar (node / graph_class), 1 = sequence (comma list)
void* ggnn_parse(const char* text, int64_t len, int32_t n_args,
                 int32_t target_kind) {
  auto* res = new ParseResult();
  const char* p = text;
  const char* end = text + len;

  std::vector<int32_t> edges;  // current block, flattened (src,type,dst) 1-idx
  struct Q {
    int32_t qtype;
    std::vector<int32_t> args;
    std::vector<int32_t> target;
  };
  std::vector<Q> questions;

  auto flush = [&]() {
    if (edges.empty() && questions.empty()) return;
    int32_t max_node = 0;
    for (size_t i = 0; i < edges.size(); i += 3) {
      max_node = std::max({max_node, edges[i], edges[i + 2]});
    }
    for (auto& q : questions) {
      for (auto a : q.args) max_node = std::max(max_node, a);
      if (target_kind == 0 && !q.target.empty())
        max_node = std::max(max_node, q.target[0] + 1);
    }
    std::vector<int32_t> e0(edges.size());
    for (size_t i = 0; i < edges.size(); ++i) e0[i] = edges[i] - 1;
    for (auto& q : questions) {
      Example ex;
      ex.n_nodes = max_node;
      ex.edges = e0;
      ex.qtype = q.qtype - 1;
      ex.args.reserve(q.args.size());
      for (auto a : q.args) ex.args.push_back(a - 1);
      ex.target = q.target;  // already 0-indexed below
      res->examples.push_back(std::move(ex));
    }
    edges.clear();
    questions.clear();
  };

  std::string tok;
  while (p < end) {
    // read one line
    std::vector<std::string> toks;
    while (next_tok(p, end, tok)) toks.push_back(tok);
    if (p < end && *p == '\n') ++p;
    if (toks.empty()) {
      flush();
      continue;
    }
    if (toks[0] == "?") {
      Q q;
      q.qtype = std::stoi(toks[1]);
      for (int i = 0; i < n_args; ++i) q.args.push_back(std::stoi(toks[2 + i]));
      const std::string& t = toks[2 + n_args];
      if (target_kind == 1) {
        size_t pos = 0;
        while (pos < t.size()) {
          size_t comma = t.find(',', pos);
          if (comma == std::string::npos) comma = t.size();
          q.target.push_back(std::stoi(t.substr(pos, comma - pos)) - 1);
          pos = comma + 1;
        }
      } else {
        q.target.push_back(std::stoi(t) - 1);
      }
      questions.push_back(std::move(q));
    } else if (toks.size() >= 3) {
      edges.push_back(std::stoi(toks[0]));
      edges.push_back(std::stoi(toks[1]));
      edges.push_back(std::stoi(toks[2]));
    }
  }
  flush();
  return res;
}

int64_t ggnn_parse_num_examples(void* h) {
  return static_cast<ParseResult*>(h)->examples.size();
}

void ggnn_example_info(void* h, int64_t i, int32_t* n_nodes, int64_t* n_edges,
                       int32_t* qtype, int64_t* n_args, int64_t* n_target) {
  auto& ex = static_cast<ParseResult*>(h)->examples[i];
  *n_nodes = ex.n_nodes;
  *n_edges = static_cast<int64_t>(ex.edges.size() / 3);
  *qtype = ex.qtype;
  *n_args = static_cast<int64_t>(ex.args.size());
  *n_target = static_cast<int64_t>(ex.target.size());
}

void ggnn_example_fill(void* h, int64_t i, int32_t* edges, int32_t* args,
                       int32_t* target) {
  auto& ex = static_cast<ParseResult*>(h)->examples[i];
  std::memcpy(edges, ex.edges.data(), ex.edges.size() * sizeof(int32_t));
  std::memcpy(args, ex.args.data(), ex.args.size() * sizeof(int32_t));
  std::memcpy(target, ex.target.data(), ex.target.size() * sizeof(int32_t));
}

void ggnn_parse_free(void* h) { delete static_cast<ParseResult*>(h); }

// Sort of n directed edges by (type, dst, src); writes sorted arrays and
// the (n_types+1) exclusive type-offset table.
//
// For node/type ids < 2^26 / 2^12 the sort runs as an LSD radix sort on a
// composed 64-bit key (4 × 16-bit passes, O(n) — ~10× faster than
// comparison sort at 10M+ edges); identical (type,dst,src) triples are
// interchangeable, so key-sort order equals np.lexsort order exactly.
void ggnn_sort_edges(int64_t n, const int32_t* src, const int32_t* dst,
                     const int32_t* typ, int32_t n_types, int32_t* out_src,
                     int32_t* out_dst, int32_t* out_typ,
                     int32_t* out_offsets) {
  int32_t max_id = 0;
  for (int64_t i = 0; i < n; ++i)
    max_id = std::max({max_id, src[i], dst[i]});
  const bool radix_ok = n >= 4096 && max_id < (1 << 26) && n_types < (1 << 12);

  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  if (radix_ok) {
    std::vector<uint64_t> key(n);
    for (int64_t i = 0; i < n; ++i)
      key[i] = (static_cast<uint64_t>(typ[i]) << 52) |
               (static_cast<uint64_t>(dst[i]) << 26) |
               static_cast<uint64_t>(src[i]);
    std::vector<int64_t> tmp(n);
    for (int shift = 0; shift < 64; shift += 16) {
      size_t hist[65536] = {0};
      for (int64_t i = 0; i < n; ++i)
        hist[(key[idx[i]] >> shift) & 0xffff]++;
      size_t sum = 0;
      for (size_t b = 0; b < 65536; ++b) {
        size_t c = hist[b];
        hist[b] = sum;
        sum += c;
      }
      for (int64_t i = 0; i < n; ++i)
        tmp[hist[(key[idx[i]] >> shift) & 0xffff]++] = idx[i];
      idx.swap(tmp);
    }
  } else {
    std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      if (typ[a] != typ[b]) return typ[a] < typ[b];
      if (dst[a] != dst[b]) return dst[a] < dst[b];
      return src[a] < src[b];
    });
  }
  std::vector<int64_t> counts(n_types, 0);
  for (int64_t i = 0; i < n; ++i) {
    out_src[i] = src[idx[i]];
    out_dst[i] = dst[idx[i]];
    out_typ[i] = typ[idx[i]];
    counts[typ[idx[i]]]++;
  }
  out_offsets[0] = 0;
  for (int32_t t = 0; t < n_types; ++t)
    out_offsets[t + 1] = out_offsets[t] + static_cast<int32_t>(counts[t]);
}

// ---- Halo partition plan (mirrors ggnn_tpu/parallel/partition.py) -------

struct HaloPlan {
  int32_t P, T2;
  int64_t n_local, e_local, H;
  // per shard s: sorted (type, dst_local) edges
  std::vector<std::vector<int32_t>> src_g, dst_l, typ_s;
  std::vector<std::vector<int32_t>> type_offsets;     // [P][T2+1]
  std::vector<std::vector<std::vector<int32_t>>> req; // [s][o] sorted unique
  std::vector<std::vector<int64_t>> halo;             // [s] per-edge halo idx
};

void* ggnn_halo_plan(int64_t n_edges, const int32_t* src, const int32_t* dst,
                     const int32_t* typ, int32_t n_shards, int64_t n_local,
                     int32_t n_types) {
  auto* plan = new HaloPlan();
  plan->P = n_shards;
  plan->T2 = n_types;
  plan->n_local = n_local;
  const int32_t P = n_shards;

  plan->src_g.resize(P);
  plan->dst_l.resize(P);
  plan->typ_s.resize(P);
  plan->type_offsets.assign(P, std::vector<int32_t>(n_types + 1, 0));
  plan->req.assign(P, std::vector<std::vector<int32_t>>(P));
  plan->halo.resize(P);

  // bucket edges by dst shard
  std::vector<std::vector<int64_t>> by_shard(P);
  for (int64_t i = 0; i < n_edges; ++i)
    by_shard[dst[i] / n_local].push_back(i);

  int64_t e_local = 1, H = 1;
  for (int32_t s = 0; s < P; ++s) {
    auto& ids = by_shard[s];
    std::stable_sort(ids.begin(), ids.end(), [&](int64_t a, int64_t b) {
      if (typ[a] != typ[b]) return typ[a] < typ[b];
      return dst[a] < dst[b];
    });
    auto& sg = plan->src_g[s];
    auto& dl = plan->dst_l[s];
    auto& ts = plan->typ_s[s];
    sg.reserve(ids.size());
    for (int64_t id : ids) {
      sg.push_back(src[id]);
      dl.push_back(dst[id] - s * static_cast<int32_t>(n_local));
      ts.push_back(typ[id]);
      plan->type_offsets[s][typ[id] + 1]++;
    }
    for (int32_t t = 0; t < n_types; ++t)
      plan->type_offsets[s][t + 1] += plan->type_offsets[s][t];
    e_local = std::max<int64_t>(e_local, static_cast<int64_t>(ids.size()));

    // per-owner request lists (sorted unique local ids); the diagonal is
    // EXCLUDED — self-edges read h_local directly (pool = recv || h_local)
    for (int32_t o = 0; o < P; ++o) {
      if (o == s) continue;
      std::vector<int32_t> loc;
      for (int32_t u : sg)
        if (u / n_local == o) loc.push_back(u - o * static_cast<int32_t>(n_local));
      std::sort(loc.begin(), loc.end());
      loc.erase(std::unique(loc.begin(), loc.end()), loc.end());
      H = std::max<int64_t>(H, static_cast<int64_t>(loc.size()));
      plan->req[s][o] = std::move(loc);
    }
  }
  auto rup = [](int64_t x, int64_t m) { return (x + m - 1) / m * m; };
  plan->e_local = rup(e_local, 8);
  plan->H = rup(std::max<int64_t>(H, 8), 8);

  // halo index per edge: owner * H + rank of (src - owner*n_local) in req;
  // self-edges index past the receive buffer into h_local (P*H + local id)
  for (int32_t s = 0; s < P; ++s) {
    auto& sg = plan->src_g[s];
    auto& hl = plan->halo[s];
    hl.resize(sg.size());
    for (size_t i = 0; i < sg.size(); ++i) {
      int32_t o = sg[i] / static_cast<int32_t>(n_local);
      if (o == s) {
        hl[i] = static_cast<int64_t>(P) * plan->H +
                (sg[i] - s * static_cast<int32_t>(n_local));
        continue;
      }
      const auto& r = plan->req[s][o];
      int64_t pos = std::lower_bound(r.begin(), r.end(),
                                     sg[i] - o * static_cast<int32_t>(n_local)) -
                    r.begin();
      hl[i] = static_cast<int64_t>(o) * plan->H + pos;
    }
  }
  return plan;
}

void ggnn_halo_sizes(void* h, int64_t* e_local, int64_t* halo_size) {
  auto* plan = static_cast<HaloPlan*>(h);
  *e_local = plan->e_local;
  *halo_size = plan->H;
}

// Fill caller-allocated arrays:
//  edge_src_global/edge_src_halo/edge_dst_local/edge_type [P, e_local] i32
//  edge_mask [P, e_local] f32, type_offsets [P, T2+1] i32,
//  halo_send_idx [P, P, H] i32
void ggnn_halo_fill(void* h, int32_t* esg, int32_t* esh, int32_t* edl,
                    int32_t* ety, float* emk, int32_t* tof, int32_t* hsi) {
  auto* plan = static_cast<HaloPlan*>(h);
  const int64_t P = plan->P, E = plan->e_local, H = plan->H;
  std::memset(esg, 0, sizeof(int32_t) * P * E);
  std::memset(esh, 0, sizeof(int32_t) * P * E);
  std::memset(edl, 0, sizeof(int32_t) * P * E);
  std::memset(ety, 0, sizeof(int32_t) * P * E);
  std::memset(emk, 0, sizeof(float) * P * E);
  std::memset(hsi, 0, sizeof(int32_t) * P * P * H);
  for (int64_t s = 0; s < P; ++s) {
    const auto& sg = plan->src_g[s];
    for (size_t i = 0; i < sg.size(); ++i) {
      esg[s * E + i] = sg[i];
      esh[s * E + i] = static_cast<int32_t>(plan->halo[s][i]);
      edl[s * E + i] = plan->dst_l[s][i];
      ety[s * E + i] = plan->typ_s[s][i];
      emk[s * E + i] = 1.0f;
    }
    for (int32_t t = 0; t <= plan->T2; ++t)
      tof[s * (plan->T2 + 1) + t] = plan->type_offsets[s][t];
    for (int64_t o = 0; o < P; ++o) {
      const auto& r = plan->req[s][o];  // owner o sends to requester s
      for (size_t k = 0; k < r.size(); ++k)
        hsi[(o * P + s) * H + k] = r[k];
    }
  }
}

void ggnn_halo_free(void* h) { delete static_cast<HaloPlan*>(h); }

// ---- Windowed block-CSR layout plan (mirrors ops/window_pallas.py) -------
//
// The numpy builder is np.unique/np.add.at-dominated (tens of seconds at
// 8M edges on this 2-core host).  Here ONE LSD radix sort on the composed
// key  ((block·n_wins + win)·window + row%window)·block_rows + dst%block_rows
// yields, in a single sorted pass: per-tile edge counts (dense/spill
// decision), per-(row,dst)-pair run lengths (int8/int4 saturation spill),
// and a cache-local order for filling the count streams (packed nibbles
// written directly — no full-width intermediate).

}  // extern "C"

struct WindowPlan {
  int64_t n = 0, window = 0, block_rows = 0, n_wins = 0, n_blocks = 0;
  std::vector<int64_t> rows, dst;   // input copies
  std::vector<int64_t> ord;         // edge ids sorted by composite key
  std::vector<uint8_t> keep;        // per original edge
  std::vector<int64_t> dense_keys;  // ascending unique keys of kept edges
  std::vector<int64_t> dense_keys_t;  // same, transposed key (if requested)
};

namespace {

// LSD radix sort of `idx` by key(idx[i]), 16-bit digits, passes sized to
// the maximum key (same scheme as ggnn_sort_edges).
template <typename KeyFn>
void radix_by(std::vector<int64_t>& idx, KeyFn key, uint64_t max_key) {
  int bits = 1;
  while (max_key >> bits) ++bits;
  std::vector<int64_t> tmp(idx.size());
  std::vector<size_t> hist(65536);
  for (int shift = 0; shift < bits; shift += 16) {
    std::fill(hist.begin(), hist.end(), 0);
    for (int64_t i : idx) hist[(key(i) >> shift) & 0xffff]++;
    size_t sum = 0;
    for (size_t b = 0; b < 65536; ++b) {
      size_t c = hist[b];
      hist[b] = sum;
      sum += c;
    }
    for (int64_t i : idx) tmp[hist[(key(i) >> shift) & 0xffff]++] = i;
    idx.swap(tmp);
  }
}

}  // namespace

extern "C" {

// Returns nullptr when the composite key would overflow 2^62 (the caller
// checks the same bound first: WindowPlanNative.fits).  max_count: 127 (int8) or 15 (packed int4).
void* ggnn_window_plan(int64_t n, const int64_t* rows, const int64_t* dst,
                       int64_t window, int64_t block_rows, int64_t n_wins,
                       int64_t n_blocks, int64_t min_edges, int32_t max_count,
                       int32_t want_grad) {
  const double comp_max = double(n_blocks) * double(n_wins) * double(window) *
                          double(block_rows);
  if (comp_max >= 4.6e18) return nullptr;  // ~2^62
  auto* p = new WindowPlan();
  p->n = n;
  p->window = window;
  p->block_rows = block_rows;
  p->n_wins = n_wins;
  p->n_blocks = n_blocks;
  p->rows.assign(rows, rows + n);
  p->dst.assign(dst, dst + n);

  const uint64_t tile_span = uint64_t(window) * uint64_t(block_rows);
  auto tile_key = [&](int64_t i) -> uint64_t {
    return uint64_t((dst[i] / block_rows) * n_wins + rows[i] / window);
  };
  auto comp_key = [&](int64_t i) -> uint64_t {
    return tile_key(i) * tile_span +
           uint64_t((rows[i] % window) * block_rows + dst[i] % block_rows);
  };

  p->ord.resize(n);
  std::iota(p->ord.begin(), p->ord.end(), 0);
  radix_by(p->ord, comp_key, uint64_t(comp_max));

  // per-tile-key counts over ALL edges (the dense decision predates the
  // saturation filter — numpy-path semantics), then keep =
  // dense[key] && pair_run <= max_count
  p->keep.assign(n, 0);
  int64_t i = 0;
  while (i < n) {
    uint64_t k = tile_key(p->ord[i]);
    int64_t j = i;  // [i, j): this tile's edges (contiguous in comp order)
    while (j < n && tile_key(p->ord[j]) == k) ++j;
    const bool dense = (j - i) >= min_edges;
    int64_t r = i;
    while (r < j) {  // pair runs within the tile
      uint64_t ck = comp_key(p->ord[r]);
      int64_t r2 = r;
      while (r2 < j && comp_key(p->ord[r2]) == ck) ++r2;
      const uint8_t ok = (r2 - r) <= max_count;
      for (int64_t q = r; q < r2; ++q) p->keep[p->ord[q]] = dense && ok;
      r = r2;
    }
    if (dense) {
      bool any = false;
      for (int64_t q = i; q < j && !any; ++q) any = p->keep[p->ord[q]];
      if (any) p->dense_keys.push_back(int64_t(k));
    }
    i = j;
  }

  if (want_grad) {
    // unique transposed keys (win·n_blocks + block) of kept edges
    std::vector<int64_t> kept;
    kept.reserve(n);
    for (int64_t e = 0; e < n; ++e)
      if (p->keep[e]) kept.push_back(e);
    auto tkey = [&](int64_t i) -> uint64_t {
      return uint64_t((rows[i] / window) * n_blocks + dst[i] / block_rows);
    };
    radix_by(kept, tkey, uint64_t(n_wins) * uint64_t(n_blocks));
    uint64_t prev = ~uint64_t(0);
    for (int64_t e : kept) {
      uint64_t k = tkey(e);
      if (k != prev) p->dense_keys_t.push_back(int64_t(k));
      prev = k;
    }
  }
  return p;
}

void ggnn_window_plan_sizes(void* h, int64_t* n_dense_keys,
                            int64_t* n_dense_keys_t) {
  auto* p = static_cast<WindowPlan*>(h);
  *n_dense_keys = int64_t(p->dense_keys.size());
  *n_dense_keys_t = int64_t(p->dense_keys_t.size());
}

void ggnn_window_plan_export(void* h, uint8_t* keep, int64_t* dense_keys,
                             int64_t* dense_keys_t) {
  auto* p = static_cast<WindowPlan*>(h);
  std::memcpy(keep, p->keep.data(), p->keep.size());
  std::memcpy(dense_keys, p->dense_keys.data(),
              p->dense_keys.size() * sizeof(int64_t));
  if (!p->dense_keys_t.empty())
    std::memcpy(dense_keys_t, p->dense_keys_t.data(),
                p->dense_keys_t.size() * sizeof(int64_t));
}

// Fill the forward count stream c [n_tiles·block_rows, window (or /2)].
// uniq_t: ascending tile keys INCLUDING the per-block dummies the python
// side merges in.  pack: int4 nibble pairs (low = col<W/2, high otherwise).
void ggnn_window_fill_counts(void* h, const int64_t* uniq_t, int64_t n_tiles,
                             int32_t pack, int8_t* c) {
  auto* p = static_cast<WindowPlan*>(h);
  const int64_t W = p->window, BR = p->block_rows;
  const int64_t width = pack ? W / 2 : W;
  std::memset(c, 0, size_t(n_tiles) * BR * width);
  const int64_t* u_end = uniq_t + n_tiles;
  int64_t last_key = -1, last_tile = 0;
  for (int64_t s = 0; s < p->n; ++s) {
    const int64_t e = p->ord[s];
    if (!p->keep[e]) continue;
    const int64_t key = (p->dst[e] / BR) * p->n_wins + p->rows[e] / W;
    if (key != last_key) {
      last_tile = std::lower_bound(uniq_t, u_end, key) - uniq_t;
      last_key = key;
    }
    const int64_t r = last_tile * BR + p->dst[e] % BR;
    const int64_t col = p->rows[e] % W;
    if (pack) {
      uint8_t* b = reinterpret_cast<uint8_t*>(c) + r * width +
                   (col < width ? col : col - width);
      *b += (col < width) ? 1 : 16;
    } else {
      c[r * W + col] += 1;
    }
  }
}

// Fill the transposed (backward) stream ct [n_gt·window, block_rows (or /2)].
void ggnn_window_fill_counts_t(void* h, const int64_t* uniq_gt, int64_t n_gt,
                               int32_t pack, int8_t* ct) {
  auto* p = static_cast<WindowPlan*>(h);
  const int64_t W = p->window, BR = p->block_rows;
  const int64_t width = pack ? BR / 2 : BR;
  std::memset(ct, 0, size_t(n_gt) * W * width);
  const int64_t* u_end = uniq_gt + n_gt;
  int64_t last_key = -1, last_tile = 0;
  for (int64_t s = 0; s < p->n; ++s) {
    const int64_t e = p->ord[s];
    if (!p->keep[e]) continue;
    const int64_t key = (p->rows[e] / W) * p->n_blocks + p->dst[e] / BR;
    if (key != last_key) {
      last_tile = std::lower_bound(uniq_gt, u_end, key) - uniq_gt;
      last_key = key;
    }
    const int64_t r = last_tile * W + p->rows[e] % W;
    const int64_t col = p->dst[e] % BR;
    if (pack) {
      uint8_t* b = reinterpret_cast<uint8_t*>(ct) + r * width +
                   (col < width ? col : col - width);
      *b += (col < width) ? 1 : 16;
    } else {
      ct[r * BR + col] += 1;
    }
  }
}

void ggnn_window_free(void* h) { delete static_cast<WindowPlan*>(h); }

}  // extern "C"

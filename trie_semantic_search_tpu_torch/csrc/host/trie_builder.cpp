// Native CSR trie builder (host C++, built with g++ by the port's native.py).
//
// A copy of the JAX package's native/trie_builder.cpp, unchanged apart from
// comments, so both packages freeze the same arrays by running the same
// code. It produces the frozen layout of index.trie.TrieBuilder.freeze():
//
//   * DFS pre-order node ids, children ordered by token id
//   * CSR edge arrays (edge_offsets / edge_tokens / edge_targets), spans
//     sorted by token for the batched walk's binary search
//   * postings in DFS order + subtree_post_end ranges (prefix matching)
//
// Node storage: a pool of nodes; children as a per-node sorted vector of
// (token, child) — sorted insertion is cheap because legal-text token
// streams revisit hot children (checked-first fast path).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Node {
  std::vector<std::pair<int32_t, int32_t>> children;  // (token, node) sorted
  std::vector<std::pair<int32_t, int32_t>> postings;  // (case_row, para)
  int32_t frequency = 0;
  bool is_end = false;

  int32_t find(int32_t token) const {
    auto it = std::lower_bound(
        children.begin(), children.end(), token,
        [](const std::pair<int32_t, int32_t>& a, int32_t t) { return a.first < t; });
    if (it != children.end() && it->first == token) return it->second;
    return -1;
  }
};

struct TrieBuilder {
  std::vector<Node> pool;
  int64_t num_postings = 0;
  TrieBuilder() { pool.emplace_back(); }
};

}  // namespace

extern "C" {

void* tss_tb_create() { return new TrieBuilder(); }

void tss_tb_free(void* handle) { delete static_cast<TrieBuilder*>(handle); }

void tss_tb_insert(void* handle, const int32_t* tokens, int64_t n,
                   int32_t case_row, int32_t para_idx) {
  if (n <= 0) return;
  auto* tb = static_cast<TrieBuilder*>(handle);
  int32_t cur = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t tok = tokens[i];
    int32_t next = tb->pool[cur].find(tok);
    if (next < 0) {
      next = static_cast<int32_t>(tb->pool.size());
      tb->pool.emplace_back();
      auto& ch = tb->pool[cur].children;  // re-ref after emplace (realloc)
      ch.insert(std::lower_bound(ch.begin(), ch.end(),
                                 std::make_pair(tok, INT32_C(0))),
                {tok, next});
    }
    cur = next;
  }
  tb->pool[cur].is_end = true;
  tb->pool[cur].postings.emplace_back(case_row, para_idx);
  tb->pool[cur].frequency += 1;
  tb->num_postings += 1;
}

// Insert every suffix window of a token sequence (the content-trie build
// inner loop): windows of width `window` starting at 0..min(n, max_windows).
void tss_tb_insert_windows(void* handle, const int32_t* tokens, int64_t n,
                           int64_t window, int64_t max_windows,
                           int32_t case_row, int32_t para_idx) {
  int64_t limit = n < max_windows ? n : max_windows;
  for (int64_t s = 0; s < limit; ++s) {
    int64_t w = (n - s) < window ? (n - s) : window;
    tss_tb_insert(handle, tokens + s, w, case_row, para_idx);
  }
}

// Sizes query: fills [num_nodes, num_edges, num_postings].
void tss_tb_sizes(void* handle, int64_t* out) {
  auto* tb = static_cast<TrieBuilder*>(handle);
  int64_t edges = 0;
  for (const auto& n : tb->pool) edges += static_cast<int64_t>(n.children.size());
  out[0] = static_cast<int64_t>(tb->pool.size());
  out[1] = edges;
  out[2] = tb->num_postings;
}

// Freeze to the DFS pre-order CSR layout (caller allocates via tss_tb_sizes).
void tss_tb_freeze(void* handle, int32_t* edge_offsets, int32_t* edge_tokens,
                   int32_t* edge_targets, int32_t* post_offsets,
                   int32_t* post_case, int32_t* post_para,
                   int32_t* subtree_post_end, uint8_t* is_end,
                   int32_t* frequency) {
  auto* tb = static_cast<TrieBuilder*>(handle);
  const int64_t N = static_cast<int64_t>(tb->pool.size());

  // DFS pre-order numbering (children already token-sorted).
  std::vector<int32_t> order;          // new id -> pool index
  std::vector<int32_t> new_id(N, -1);  // pool index -> new id
  order.reserve(N);
  std::vector<int32_t> stack{0};
  while (!stack.empty()) {
    int32_t p = stack.back();
    stack.pop_back();
    new_id[p] = static_cast<int32_t>(order.size());
    order.push_back(p);
    const auto& ch = tb->pool[p].children;
    for (auto it = ch.rbegin(); it != ch.rend(); ++it) stack.push_back(it->second);
  }

  // CSR fill.
  int64_t e = 0, pp = 0;
  edge_offsets[0] = 0;
  post_offsets[0] = 0;
  for (int64_t i = 0; i < N; ++i) {
    const Node& node = tb->pool[order[i]];
    for (const auto& [tok, child] : node.children) {
      edge_tokens[e] = tok;
      edge_targets[e] = new_id[child];
      ++e;
    }
    edge_offsets[i + 1] = static_cast<int32_t>(e);
    for (const auto& [row, para] : node.postings) {
      post_case[pp] = row;
      post_para[pp] = para;
      ++pp;
    }
    post_offsets[i + 1] = static_cast<int32_t>(pp);
    is_end[i] = node.is_end ? 1 : 0;
    frequency[i] = node.frequency;
  }

  // Subtree sizes via reverse pre-order accumulation: in pre-order, every
  // node appears before its descendants, so sweeping from the end lets each
  // node add its (already final) size to its parent. Parent ids come from
  // the edge arrays.
  std::vector<int64_t> size(N, 1);
  std::vector<int32_t> parent(N, -1);
  for (int64_t i = 0; i < N; ++i)
    for (int32_t k = edge_offsets[i]; k < edge_offsets[i + 1]; ++k)
      parent[edge_targets[k]] = static_cast<int32_t>(i);
  for (int64_t i = N - 1; i > 0; --i) size[parent[i]] += size[i];
  for (int64_t i = 0; i < N; ++i) {
    int64_t span_end = i + size[i] - 1;  // last id in the subtree block
    subtree_post_end[i] = post_offsets[span_end + 1];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sorted-stream CSR construction (the streaming build's spill).
//
// Builds the SAME frozen layout as tss_tb_freeze directly from a
// lexicographically sorted window matrix W [n, L] (int32 token ids, -1
// padding, pads sort before real ids), without ever holding a node pool:
// the sorted order IS the DFS pre-order, so nodes are numbered as they
// first appear and postings land in stream order. Memory is O(output),
// which lets the content index build at corpus scales where the pooled
// builder's resident nodes would grow without bound. Python sorts the spilled windows (np.lexsort,
// stable) and calls count → allocate → fill.

extern "C" {

// Pass 1: number of trie nodes for the sorted window matrix.
int64_t tss_csr_count(const int32_t* W, int64_t n, int64_t L) {
  int64_t nodes = 1;  // root
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* w = W + i * L;
    int64_t depth = 0;
    while (depth < L && w[depth] >= 0) ++depth;
    int64_t cpl = 0;
    if (i > 0) {
      const int32_t* p = W + (i - 1) * L;
      while (cpl < depth && p[cpl] == w[cpl]) ++cpl;
    }
    nodes += depth - cpl;
  }
  return nodes;
}

// Pass 2: fill the CSR arrays (caller allocates; edges = num_nodes - 1,
// postings = n). Produces bit-identical output to tss_tb_freeze over the
// same windows (parity-tested from Python).
void tss_csr_fill(const int32_t* W, const int32_t* rows, const int32_t* paras,
                  int64_t n, int64_t L, int64_t num_nodes,
                  int32_t* edge_offsets, int32_t* edge_tokens,
                  int32_t* edge_targets, int32_t* post_offsets,
                  int32_t* post_case, int32_t* post_para,
                  int32_t* subtree_post_end, uint8_t* is_end,
                  int32_t* frequency) {
  const int64_t N = num_nodes;
  std::vector<int32_t> parent(N, -1);
  std::vector<int32_t> in_token(N, -1);
  std::vector<int32_t> child_count(N, 0);
  std::vector<int32_t> post_count(N, 0);
  std::vector<int32_t> stack(L + 1, 0);  // stack[d] = node id at depth d
  for (int64_t i = 0; i < N; ++i) {
    is_end[i] = 0;
    frequency[i] = 0;
  }

  int32_t next_id = 1;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* w = W + i * L;
    int64_t depth = 0;
    while (depth < L && w[depth] >= 0) ++depth;
    int64_t cpl = 0;
    if (i > 0) {
      const int32_t* p = W + (i - 1) * L;
      while (cpl < depth && p[cpl] == w[cpl]) ++cpl;
    }
    for (int64_t d = cpl; d < depth; ++d) {
      int32_t id = next_id++;
      parent[id] = stack[d];
      in_token[id] = w[d];
      ++child_count[stack[d]];
      stack[d + 1] = id;
    }
    int32_t terminal = stack[depth];
    is_end[terminal] = 1;
    ++frequency[terminal];
    ++post_count[terminal];
    // postings are filled in stream order, which equals node-id order of
    // terminals (sorted stream == DFS pre-order; duplicates adjacent)
    post_case[i] = rows[i];
    post_para[i] = paras[i];
  }

  // edge CSR: children were created in ascending token order per parent
  // (sorted stream), so a stable counting pass by parent keeps spans
  // token-sorted.
  edge_offsets[0] = 0;
  for (int64_t i = 0; i < N; ++i)
    edge_offsets[i + 1] = edge_offsets[i] + child_count[i];
  std::vector<int32_t> fill(N, 0);
  for (int64_t id = 1; id < N; ++id) {
    int32_t p = parent[id];
    int32_t e = edge_offsets[p] + fill[p]++;
    edge_tokens[e] = in_token[id];
    edge_targets[e] = static_cast<int32_t>(id);
  }

  post_offsets[0] = 0;
  for (int64_t i = 0; i < N; ++i)
    post_offsets[i + 1] = post_offsets[i] + post_count[i];

  std::vector<int64_t> size(N, 1);
  for (int64_t i = N - 1; i > 0; --i) size[parent[i]] += size[i];
  for (int64_t i = 0; i < N; ++i) {
    int64_t span_end = i + size[i] - 1;
    subtree_post_end[i] = post_offsets[span_end + 1];
  }
}

}  // extern "C"

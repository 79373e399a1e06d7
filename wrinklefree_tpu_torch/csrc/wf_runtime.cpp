// wf_runtime: native host-side runtime for the wrinklefree_tpu_torch engine.
//
// The port's own copy of the JAX package's csrc/wf_runtime.cpp (the same
// code): refcounted page allocation with a LIFO free list (page 0 is the
// trash page) and the radix prefix tree over full KV pages with LRU
// eviction of unlocked leaves: the bookkeeping the engine runs per request
// on the host. Exposed through a plain C ABI for ctypes; built with g++ at
// first use by wrinklefree_tpu_torch/native/build.py.
//
// Semantics mirror the Python classes exactly
// (wrinklefree_tpu_torch/engine/page_allocator.py, radix_cache.py), except
// that LRU stamps come from a counter instead of time.monotonic();
// tests/test_torch_native.py runs both and compares.

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Page allocator: LIFO free list + refcounts. Page 0 reserved (trash page).
// ---------------------------------------------------------------------------

struct PageAllocator {
  std::vector<int32_t> free_list;  // back = next to hand out
  std::vector<int32_t> refs;
  int32_t num_pages;

  explicit PageAllocator(int32_t n) : refs(n, 0), num_pages(n) {
    free_list.reserve(n - 1);
    // Same order as the Python reference: free list [n-1, ..., 1], pop
    // from the back, so page 1 is handed out first.
    for (int32_t p = n - 1; p >= 1; --p) free_list.push_back(p);
  }

  int64_t num_free() const { return (int64_t)free_list.size(); }

  // Returns 0 on success, -1 if out of pages (nothing allocated).
  int32_t alloc(int32_t n, int32_t* out) {
    if (n > (int32_t)free_list.size()) return -1;
    for (int32_t i = 0; i < n; ++i) {
      int32_t p = free_list.back();
      free_list.pop_back();
      refs[p] = 1;
      out[i] = p;
    }
    return 0;
  }

  int32_t retain(int32_t page) {
    if (page < 0 || page >= num_pages || refs[page] <= 0) return -1;
    refs[page]++;
    return 0;
  }

  int32_t release(int32_t page) {
    if (page == 0) return 0;  // trash page: no-op
    if (page < 0 || page >= num_pages || refs[page] <= 0) return -1;
    if (--refs[page] == 0) free_list.push_back(page);
    return 0;
  }

  int32_t refcount(int32_t page) const {
    if (page < 0 || page >= num_pages) return -1;
    return refs[page];
  }
};

// ---------------------------------------------------------------------------
// Radix prefix tree at KV-page granularity.
// ---------------------------------------------------------------------------

struct RadixNode {
  std::vector<int32_t> chunk;  // page_size tokens
  int32_t page;
  RadixNode* parent;
  std::map<std::vector<int32_t>, RadixNode*> children;
  uint64_t last_used;
  int32_t lock_refs;

  RadixNode(std::vector<int32_t> c, int32_t p, RadixNode* par)
      : chunk(std::move(c)), page(p), parent(par), last_used(0), lock_refs(0) {}
};

struct RadixTree {
  PageAllocator* alloc;  // not owned
  int32_t page_size;
  RadixNode root;
  int64_t num_nodes = 0;
  uint64_t clock = 0;  // monotonic LRU stamp (replaces time.monotonic())

  RadixTree(PageAllocator* a, int32_t ps)
      : alloc(a), page_size(ps), root({}, -1, nullptr) {}

  ~RadixTree() { free_subtree(&root); }

  void free_subtree(RadixNode* n) {
    for (auto& kv : n->children) {
      free_subtree(kv.second);
      delete kv.second;
    }
    n->children.clear();
  }

  // Longest full-page prefix match. Fills out_pages/out_nodes (capacity
  // len/page_size) and returns matched token count.
  int64_t match(const int32_t* tokens, int64_t len, int32_t* out_pages,
                RadixNode** out_nodes, int64_t* out_count) {
    RadixNode* node = &root;
    int64_t i = 0, k = 0;
    std::vector<int32_t> chunk(page_size);
    while (i + page_size <= len) {
      std::memcpy(chunk.data(), tokens + i, page_size * sizeof(int32_t));
      auto it = node->children.find(chunk);
      if (it == node->children.end()) break;
      RadixNode* child = it->second;
      out_pages[k] = child->page;
      out_nodes[k] = child;
      child->last_used = ++clock;
      node = child;
      i += page_size;
      k += 1;
    }
    *out_count = k;
    return i;
  }

  // Insert full pages of a finished sequence; returns pages adopted.
  int64_t insert(const int32_t* tokens, int64_t tok_len, const int32_t* pages,
                 int64_t n_pages) {
    RadixNode* node = &root;
    int64_t adopted = 0;
    int64_t n = n_pages < tok_len / page_size ? n_pages : tok_len / page_size;
    for (int64_t j = 0; j < n; ++j) {
      std::vector<int32_t> chunk(tokens + j * page_size,
                                 tokens + (j + 1) * page_size);
      auto it = node->children.find(chunk);
      RadixNode* child;
      if (it == node->children.end()) {
        int32_t page = pages[j];
        if (alloc->retain(page) != 0) return -1;  // tree's own reference
        child = new RadixNode(chunk, page, node);
        node->children.emplace(std::move(chunk), child);
        num_nodes++;
        adopted++;
      } else {
        child = it->second;
      }
      child->last_used = ++clock;
      node = child;
    }
    return adopted;
  }

  void collect_leaves(RadixNode* n, std::vector<RadixNode*>& out) {
    for (auto& kv : n->children) collect_leaves(kv.second, out);
    if (n != &root && n->children.empty() && n->lock_refs == 0)
      out.push_back(n);
  }

  int64_t evict(int64_t want) {
    int64_t evicted = 0;
    while (evicted < want) {
      std::vector<RadixNode*> leaves;
      collect_leaves(&root, leaves);
      if (leaves.empty()) break;
      RadixNode* victim = leaves[0];
      for (RadixNode* n : leaves)
        if (n->last_used < victim->last_used) victim = n;
      victim->parent->children.erase(victim->chunk);
      alloc->release(victim->page);
      delete victim;
      num_nodes--;
      evicted++;
    }
    return evicted;
  }

  void release_subtree_pages(RadixNode* n) {
    for (auto& kv : n->children) release_subtree_pages(kv.second);
    if (n != &root) alloc->release(n->page);
  }

  void reset() {
    release_subtree_pages(&root);
    free_subtree(&root);
    num_nodes = 0;
  }
};

}  // namespace

extern "C" {

// ---- page allocator --------------------------------------------------------

void* wf_alloc_create(int32_t num_pages) {
  if (num_pages < 2) return nullptr;
  return new PageAllocator(num_pages);
}
void wf_alloc_destroy(void* h) { delete (PageAllocator*)h; }
int64_t wf_alloc_num_free(void* h) { return ((PageAllocator*)h)->num_free(); }
int32_t wf_alloc_alloc(void* h, int32_t n, int32_t* out) {
  return ((PageAllocator*)h)->alloc(n, out);
}
int32_t wf_alloc_retain(void* h, int32_t page) {
  return ((PageAllocator*)h)->retain(page);
}
int32_t wf_alloc_release(void* h, int32_t page) {
  return ((PageAllocator*)h)->release(page);
}
int32_t wf_alloc_refcount(void* h, int32_t page) {
  return ((PageAllocator*)h)->refcount(page);
}

// ---- radix tree -------------------------------------------------------------

void* wf_radix_create(void* alloc_h, int32_t page_size) {
  if (!alloc_h || page_size <= 0) return nullptr;
  return new RadixTree((PageAllocator*)alloc_h, page_size);
}
void wf_radix_destroy(void* h) { delete (RadixTree*)h; }
int64_t wf_radix_match(void* h, const int32_t* tokens, int64_t len,
                       int32_t* out_pages, void** out_nodes,
                       int64_t* out_count) {
  return ((RadixTree*)h)
      ->match(tokens, len, out_pages, (RadixNode**)out_nodes, out_count);
}
void wf_radix_lock(void* h, void** nodes, int64_t n) {
  RadixTree* t = (RadixTree*)h;
  for (int64_t i = 0; i < n; ++i) {
    RadixNode* node = (RadixNode*)nodes[i];
    node->lock_refs++;
    t->alloc->retain(node->page);
  }
}
void wf_radix_unlock(void* h, void** nodes, int64_t n) {
  RadixTree* t = (RadixTree*)h;
  for (int64_t i = 0; i < n; ++i) {
    RadixNode* node = (RadixNode*)nodes[i];
    node->lock_refs--;
    t->alloc->release(node->page);
  }
}
int64_t wf_radix_insert(void* h, const int32_t* tokens, int64_t tok_len,
                        const int32_t* pages, int64_t n_pages) {
  return ((RadixTree*)h)->insert(tokens, tok_len, pages, n_pages);
}
int64_t wf_radix_evict(void* h, int64_t want) {
  return ((RadixTree*)h)->evict(want);
}
int64_t wf_radix_num_cached(void* h) { return ((RadixTree*)h)->num_nodes; }
void wf_radix_reset(void* h) { ((RadixTree*)h)->reset(); }

}  // extern "C"

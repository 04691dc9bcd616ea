// KV page allocator of the paged serving path (host side).
//
// A copy of protoquant_tpu/native/pq_alloc.cpp: O(1) page alloc/free over an
// intrusive free list, all-or-nothing allocation, double frees ignored.
// Exposed as a C ABI for ctypes; protoquant_tpu_torch/native/__init__.py
// builds it with g++ at first use and checks pq_abi_version().

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>

extern "C" {

struct PqAllocator {
  int32_t num_pages;
  int32_t free_head;      // index of first free page, -1 if none
  int32_t num_free;
  int32_t* next;          // free-list links / chain links when allocated
  std::mutex* mu;
};

PqAllocator* pq_alloc_create(int32_t num_pages) {
  auto* a = new (std::nothrow) PqAllocator();
  if (!a) return nullptr;
  a->num_pages = num_pages;
  a->next = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * num_pages));
  if (!a->next) { delete a; return nullptr; }
  for (int32_t i = 0; i < num_pages; ++i) a->next[i] = i + 1;
  if (num_pages > 0) a->next[num_pages - 1] = -1;
  a->free_head = num_pages > 0 ? 0 : -1;
  a->num_free = num_pages;
  a->mu = new std::mutex();
  return a;
}

void pq_alloc_destroy(PqAllocator* a) {
  if (!a) return;
  std::free(a->next);
  delete a->mu;
  delete a;
}

// Allocate n pages into out[0..n). Returns n on success, 0 (and allocates
// nothing) if fewer than n pages are free — all-or-nothing semantics so a
// request never ends up half-admitted.
int32_t pq_alloc_pages(PqAllocator* a, int32_t n, int32_t* out) {
  std::lock_guard<std::mutex> lock(*a->mu);
  if (a->num_free < n) return 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = a->free_head;
    a->free_head = a->next[p];
    a->next[p] = -2;  // mark allocated
    out[i] = p;
  }
  a->num_free -= n;
  return n;
}

void pq_free_pages(PqAllocator* a, const int32_t* pages, int32_t n) {
  std::lock_guard<std::mutex> lock(*a->mu);
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pages[i];
    if (p < 0 || p >= a->num_pages || a->next[p] != -2) continue;  // double-free guard
    a->next[p] = a->free_head;
    a->free_head = p;
    a->num_free += 1;
  }
}

int32_t pq_num_free(const PqAllocator* a) { return a->num_free; }
int32_t pq_num_pages(const PqAllocator* a) { return a->num_pages; }

// ABI version: the Python loader refuses any library whose version doesn't
// match its expectation, so a stale cached binary can never silently shadow
// newer source (the cache key is also a content hash — belt and braces).
int32_t pq_abi_version(void) { return 2; }

}  // extern "C"

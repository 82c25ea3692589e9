// Bounded blocking queue of byte records.
//
// Reference parity: paddle/fluid/framework/blocking_queue.h and the
// LoDTensorBlockingQueue used by the reader op stack
// (paddle/fluid/operators/reader/lod_tensor_blocking_queue.h): bounded
// capacity, blocking push/pop, close() releasing all waiters.  Carries
// opaque byte records (serialized samples) between producer threads
// (file readers / pipe commands) and the Python feed loop.

#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>

#include "common.h"

namespace {

struct Queue {
  std::mutex mu;
  std::condition_variable not_full;
  std::condition_variable not_empty;
  std::deque<std::string> items;
  size_t capacity;
  bool closed = false;
};

}  // namespace

extern "C" {

void pt_free(void* p) { free(p); }

void* pt_queue_create(size_t capacity) {
  auto* q = new Queue();
  q->capacity = capacity == 0 ? 1 : capacity;
  return q;
}

void pt_queue_destroy(void* h) { delete static_cast<Queue*>(h); }

// returns 1 on success, 0 if the queue was closed
int pt_queue_push(void* h, const char* data, size_t len) {
  auto* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_full.wait(lk, [q] { return q->items.size() < q->capacity || q->closed; });
  if (q->closed) return 0;
  q->items.emplace_back(data, len);
  q->not_empty.notify_one();
  return 1;
}

// returns 1 with *out/*len set (caller pt_free's), 0 if closed and drained
int pt_queue_pop(void* h, char** out, size_t* len) {
  auto* q = static_cast<Queue*>(h);
  std::unique_lock<std::mutex> lk(q->mu);
  q->not_empty.wait(lk, [q] { return !q->items.empty() || q->closed; });
  if (q->items.empty()) return 0;
  const std::string& s = q->items.front();
  *len = s.size();
  *out = static_cast<char*>(malloc(s.size() ? s.size() : 1));
  memcpy(*out, s.data(), s.size());
  q->items.pop_front();
  q->not_full.notify_one();
  return 1;
}

size_t pt_queue_size(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->items.size();
}

void pt_queue_close(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->not_empty.notify_all();
  q->not_full.notify_all();
}

int pt_queue_is_closed(void* h) {
  auto* q = static_cast<Queue*>(h);
  std::lock_guard<std::mutex> lk(q->mu);
  return q->closed ? 1 : 0;
}

}  // extern "C"

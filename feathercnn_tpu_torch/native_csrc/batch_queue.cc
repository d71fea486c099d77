// Continuous-batching ingest queue — the serving runtime's native core.
//
// The reference has no serving layer (callers hand one image to
// Net::Forward, [pub] src/net.cpp); continuous image batching across hosts
// is a capability the rebuild adds (BASELINE.json:5,11).  This is the hot
// path of that layer in C++: a mutex+condvar MPMC queue of fixed-size
// image slots.  Producer threads (RPC handlers) submit images; the
// collector thread drains up to `max_batch` of them into one contiguous
// batch buffer (the fixed-shape engine slot), waiting at most `timeout_us`
// for the batch to fill — the classic size-or-deadline batching policy.
//
// Python drives it via ctypes (feathercnn_tpu_torch/native.py); results travel
// back per-ticket through result slots with their own condvar.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Request {
  uint64_t ticket;
  std::vector<uint8_t> payload;
};

struct Result {
  bool ready = false;
  std::vector<uint8_t> payload;
};

struct Queue {
  size_t item_bytes;
  size_t result_bytes;
  uint64_t next_ticket = 1;
  bool closed = false;

  std::mutex mu;
  std::condition_variable cv_submit;   // signalled on submit
  std::condition_variable cv_result;   // signalled on post_results
  std::deque<Request> pending;
  std::unordered_map<uint64_t, Result> results;

  // stats (SURVEY.md §5 metrics): monotonic counters the Python side polls
  uint64_t submitted = 0;
  uint64_t completed = 0;
  uint64_t batches = 0;
  uint64_t max_depth = 0;
};

}  // namespace

extern "C" {

void* bq_create(int64_t item_bytes, int64_t result_bytes) {
  auto* q = new Queue();
  q->item_bytes = (size_t)item_bytes;
  q->result_bytes = (size_t)result_bytes;
  return q;
}

void bq_destroy(void* handle) { delete (Queue*)handle; }

void bq_close(void* handle) {
  auto* q = (Queue*)handle;
  std::lock_guard<std::mutex> lk(q->mu);
  q->closed = true;
  q->cv_submit.notify_all();
  q->cv_result.notify_all();
}

// Submit one item; returns its ticket (0 on error/closed).
uint64_t bq_submit(void* handle, const void* data) {
  auto* q = (Queue*)handle;
  std::lock_guard<std::mutex> lk(q->mu);
  if (q->closed) return 0;
  Request r;
  r.ticket = q->next_ticket++;
  r.payload.assign((const uint8_t*)data,
                   (const uint8_t*)data + q->item_bytes);
  q->pending.push_back(std::move(r));
  q->submitted++;
  if (q->pending.size() > q->max_depth) q->max_depth = q->pending.size();
  q->cv_submit.notify_one();
  return q->pending.back().ticket;
}

// Collect up to max_batch items into `batch_out` (max_batch*item_bytes).
// Blocks until at least one item is available (or closed), then waits up
// to timeout_us for the batch to fill.  Writes tickets into tickets_out.
// Returns the number of items collected (0 if closed and drained).
int64_t bq_collect(void* handle, void* batch_out, uint64_t* tickets_out,
                   int64_t max_batch, int64_t timeout_us) {
  auto* q = (Queue*)handle;
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_submit.wait(lk, [&] { return !q->pending.empty() || q->closed; });
  if (q->pending.empty()) return 0;

  if ((int64_t)q->pending.size() < max_batch && timeout_us > 0) {
    q->cv_submit.wait_for(
        lk, std::chrono::microseconds(timeout_us),
        [&] { return (int64_t)q->pending.size() >= max_batch || q->closed; });
  }

  int64_t n = 0;
  auto* out = (uint8_t*)batch_out;
  while (n < max_batch && !q->pending.empty()) {
    Request& r = q->pending.front();
    memcpy(out + (size_t)n * q->item_bytes, r.payload.data(), q->item_bytes);
    tickets_out[n] = r.ticket;
    q->pending.pop_front();
    n++;
  }
  q->batches++;
  return n;
}

// Post results for a collected batch (n contiguous result slots).
void bq_post_results(void* handle, const uint64_t* tickets,
                     const void* results, int64_t n) {
  auto* q = (Queue*)handle;
  std::lock_guard<std::mutex> lk(q->mu);
  auto* src = (const uint8_t*)results;
  for (int64_t i = 0; i < n; i++) {
    Result& r = q->results[tickets[i]];
    r.payload.assign(src + (size_t)i * q->result_bytes,
                     src + (size_t)(i + 1) * q->result_bytes);
    r.ready = true;
    q->completed++;
  }
  q->cv_result.notify_all();
}

// Wait for a ticket's result; returns 0 on success, -1 on timeout/closed.
int bq_wait_result(void* handle, uint64_t ticket, void* out,
                   int64_t timeout_us) {
  auto* q = (Queue*)handle;
  std::unique_lock<std::mutex> lk(q->mu);
  bool ok = q->cv_result.wait_for(
      lk, std::chrono::microseconds(timeout_us), [&] {
        auto it = q->results.find(ticket);
        return (it != q->results.end() && it->second.ready) || q->closed;
      });
  auto it = q->results.find(ticket);
  if (!ok || it == q->results.end() || !it->second.ready) return -1;
  memcpy(out, it->second.payload.data(), q->result_bytes);
  q->results.erase(it);
  return 0;
}

int64_t bq_depth(void* handle) {
  auto* q = (Queue*)handle;
  std::lock_guard<std::mutex> lk(q->mu);
  return (int64_t)q->pending.size();
}

void bq_stats(void* handle, uint64_t* submitted, uint64_t* completed,
              uint64_t* batches, uint64_t* max_depth) {
  auto* q = (Queue*)handle;
  std::lock_guard<std::mutex> lk(q->mu);
  *submitted = q->submitted;
  *completed = q->completed;
  *batches = q->batches;
  *max_depth = q->max_depth;
}

}  // extern "C"

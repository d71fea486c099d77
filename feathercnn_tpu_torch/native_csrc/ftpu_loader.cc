// .ftpu model loader — the native runtime's Net::InitFromPath analog.
//
// The reference mmaps a FlatBuffers .feathermodel and reads blobs in place
// ([pub] src/net.cpp InitFromPath -> InitFromBuffer).  This loader does the
// same for the .ftpu container (model_format.py): mmap the
// file, parse the tiny JSON header for the tensor index, and hand out
// zero-copy pointers into the weight section.  Exposed to Python via
// ctypes (feathercnn_tpu_torch/native.py); serving restarts page weights in
// lazily instead of re-deserializing.
//
// Built at first use by feathercnn_tpu_torch/native.py (g++, one shared
// library with batch_queue.cc and preprocess.cc).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Tensor {
  uint64_t offset;
  uint64_t nbytes;
  std::string dtype;
  std::vector<int64_t> shape;
};

struct Model {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t size = 0;
  uint64_t data_start = 0;
  std::string header_json;
  std::unordered_map<std::string, Tensor> tensors;
  std::vector<std::string> names;  // stable iteration order
};

// --- minimal JSON scanner (only what the .ftpu header needs) -----------
struct Scanner {
  const char* p;
  const char* end;
  bool fail = false;

  void ws() { while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' ||
                                 *p == '\r')) p++; }
  bool lit(char c) { ws(); if (p < end && *p == c) { p++; return true; }
                     return false; }
  bool peek(char c) { ws(); return p < end && *p == c; }

  std::string str() {
    ws();
    std::string out;
    if (p >= end || *p != '"') { fail = true; return out; }
    p++;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) { p++; }
      out.push_back(*p++);
    }
    if (p < end) p++;
    return out;
  }

  double num() {
    ws();
    char* q = nullptr;
    double v = strtod(p, &q);
    if (q == p) fail = true;
    p = q;
    return v;
  }

  // Skip any JSON value.
  void skip() {
    ws();
    if (p >= end) { fail = true; return; }
    char c = *p;
    if (c == '"') { str(); return; }
    if (c == '{') {
      p++;
      if (lit('}')) return;
      do { str(); lit(':'); skip(); } while (lit(','));
      lit('}');
      return;
    }
    if (c == '[') {
      p++;
      if (lit(']')) return;
      do { skip(); } while (lit(','));
      lit(']');
      return;
    }
    if (strncmp(p, "true", 4) == 0) { p += 4; return; }
    if (strncmp(p, "false", 5) == 0) { p += 5; return; }
    if (strncmp(p, "null", 4) == 0) { p += 4; return; }
    num();
  }
};

size_t dtype_size(const std::string& dt) {
  if (dt == "float64" || dt == "int64" || dt == "uint64") return 8;
  if (dt == "float32" || dt == "int32" || dt == "uint32") return 4;
  if (dt == "float16" || dt == "bfloat16" || dt == "int16") return 2;
  return 1;  // int8/uint8/bool
}

bool parse_tensors(Model* m) {
  // Find the top-level "tensors" key and parse its object.
  Scanner s{m->header_json.c_str(),
            m->header_json.c_str() + m->header_json.size()};
  if (!s.lit('{')) return false;
  if (s.peek('}')) return true;
  do {
    std::string key = s.str();
    if (!s.lit(':')) return false;
    if (key != "tensors") { s.skip(); continue; }
    if (!s.lit('{')) return false;
    if (s.lit('}')) return true;
    do {
      Tensor t;
      std::string name = s.str();
      if (!s.lit(':') || !s.lit('{')) return false;
      do {
        std::string field = s.str();
        s.lit(':');
        if (field == "offset") {
          t.offset = (uint64_t)s.num();
        } else if (field == "dtype") {
          t.dtype = s.str();
        } else if (field == "shape") {
          if (!s.lit('[')) return false;
          if (!s.lit(']')) {
            do { t.shape.push_back((int64_t)s.num()); } while (s.lit(','));
            s.lit(']');
          }
        } else {
          s.skip();
        }
      } while (s.lit(','));
      s.lit('}');
      uint64_t count = 1;
      for (int64_t d : t.shape) count *= (uint64_t)d;
      t.nbytes = count * dtype_size(t.dtype);
      m->names.push_back(name);
      m->tensors.emplace(std::move(name), std::move(t));
    } while (s.lit(','));
    s.lit('}');
  } while (s.lit(','));
  return !s.fail;
}

}  // namespace

extern "C" {

// Returns a handle or nullptr.
void* ftpu_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED,
                    fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }

  auto* m = new Model();
  m->fd = fd;
  m->base = (uint8_t*)base;
  m->size = (size_t)st.st_size;

  if (m->size < 16 || memcmp(m->base, "FTPU", 4) != 0) {
    delete m; munmap(base, (size_t)st.st_size); close(fd); return nullptr;
  }
  uint32_t version;
  uint64_t hlen;
  memcpy(&version, m->base + 4, 4);
  memcpy(&hlen, m->base + 8, 8);
  if (version != 1 || 16 + hlen > m->size) {
    munmap(base, m->size); close(fd); delete m; return nullptr;
  }
  m->header_json.assign((const char*)m->base + 16, hlen);
  m->data_start = (16 + hlen + 63) / 64 * 64;
  if (!parse_tensors(m)) {
    munmap(base, m->size); close(fd); delete m; return nullptr;
  }
  return m;
}

const char* ftpu_header_json(void* handle) {
  return ((Model*)handle)->header_json.c_str();
}

int64_t ftpu_num_tensors(void* handle) {
  return (int64_t)((Model*)handle)->names.size();
}

const char* ftpu_tensor_name(void* handle, int64_t i) {
  auto* m = (Model*)handle;
  if (i < 0 || (size_t)i >= m->names.size()) return nullptr;
  return m->names[(size_t)i].c_str();
}

// Zero-copy pointer into the mmap'd weight section.
const void* ftpu_tensor_data(void* handle, const char* name,
                             int64_t* nbytes_out) {
  auto* m = (Model*)handle;
  auto it = m->tensors.find(name);
  if (it == m->tensors.end()) return nullptr;
  const Tensor& t = it->second;
  if (m->data_start + t.offset + t.nbytes > m->size) return nullptr;
  if (nbytes_out) *nbytes_out = (int64_t)t.nbytes;
  return m->base + m->data_start + t.offset;
}

int ftpu_tensor_info(void* handle, const char* name, char* dtype_out,
                     int64_t dtype_cap, int64_t* shape_out,
                     int64_t* rank_out) {
  auto* m = (Model*)handle;
  auto it = m->tensors.find(name);
  if (it == m->tensors.end()) return -1;
  const Tensor& t = it->second;
  snprintf(dtype_out, (size_t)dtype_cap, "%s", t.dtype.c_str());
  *rank_out = (int64_t)t.shape.size();
  for (size_t i = 0; i < t.shape.size() && i < 16; i++)
    shape_out[i] = t.shape[i];
  return 0;
}

// Advise the kernel to prefetch the whole weight section (serving warmup).
void ftpu_prefetch(void* handle) {
  auto* m = (Model*)handle;
  madvise(m->base, m->size, MADV_WILLNEED);
}

void ftpu_close(void* handle) {
  auto* m = (Model*)handle;
  if (m->base) munmap(m->base, m->size);
  if (m->fd >= 0) close(m->fd);
  delete m;
}

}  // extern "C"

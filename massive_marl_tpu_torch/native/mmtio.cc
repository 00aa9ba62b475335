// mmtio: native experience/dataset IO for massive_marl_tpu.
//
// The reference's only native layer is the external IsaacGym binary; the
// equivalent host-side runtime here is the data path around the TPU: offline
// dataset shards (offrl) and trajectory dumps.  This library provides
// zero-copy mmap'd .npy reads and O_DIRECT-free buffered writes, exposed to
// Python via ctypes (no pybind11 dependency in the image).
//
// .npy format: v1.0 spec (128-byte-aligned header), float32 little-endian,
// C-order - matching the reference's torch->numpy dumps
// (ppo_collect.py:225-233).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapping {
  void* base = nullptr;
  size_t length = 0;
  float* data = nullptr;
  int64_t rows = 0;
  int64_t cols = 0;
};

std::string npy_header(int64_t rows, int64_t cols) {
  char dict[256];
  snprintf(dict, sizeof(dict),
           "{'descr': '<f4', 'fortran_order': False, 'shape': (%lld, %lld), }",
           (long long)rows, (long long)cols);
  std::string d(dict);
  size_t total = 10 + d.size() + 1;           // magic+ver+len + dict + \n
  size_t pad = (64 - (total % 64)) % 64;      // align to 64
  d.append(pad, ' ');
  d.push_back('\n');
  uint16_t hlen = (uint16_t)d.size();
  std::string out;
  out += "\x93NUMPY";
  out.push_back('\x01');
  out.push_back('\x00');
  out.append(reinterpret_cast<char*>(&hlen), 2);
  out += d;
  return out;
}

}  // namespace

extern "C" {

// Write a [rows, cols] float32 array as .npy.  Returns 0 on success.
int mmtio_write_npy(const char* path, const float* data, int64_t rows, int64_t cols) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  std::string hdr = npy_header(rows, cols);
  if (fwrite(hdr.data(), 1, hdr.size(), f) != hdr.size()) { fclose(f); return -2; }
  size_t n = (size_t)rows * (size_t)cols;
  size_t written = fwrite(data, sizeof(float), n, f);
  fclose(f);
  return written == n ? 0 : -3;
}

// Memory-map a float32 .npy file.  Returns an opaque handle (or null).
void* mmtio_open_npy(const char* path, int64_t* rows, int64_t* cols) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  const char* p = static_cast<const char*>(base);
  if (memcmp(p, "\x93NUMPY", 6) != 0) { munmap(base, st.st_size); return nullptr; }
  uint16_t hlen;
  memcpy(&hlen, p + 8, 2);
  std::string dict(p + 10, hlen);
  // parse "shape': (R, C)"
  auto pos = dict.find("'shape':");
  if (pos == std::string::npos) { munmap(base, st.st_size); return nullptr; }
  long long r = 0, c = 1;
  const char* s = dict.c_str() + pos;
  if (sscanf(s, "'shape': (%lld, %lld", &r, &c) < 1) {
    munmap(base, st.st_size);
    return nullptr;
  }
  auto* m = new Mapping;
  m->base = base;
  m->length = st.st_size;
  m->data = reinterpret_cast<float*>(const_cast<char*>(p + 10 + hlen));
  m->rows = r;
  m->cols = c;
  if (rows) *rows = r;
  if (cols) *cols = c;
  return m;
}

const float* mmtio_data(void* handle) {
  return handle ? static_cast<Mapping*>(handle)->data : nullptr;
}

// Gather `n` rows by index into out (n x cols), parallel-friendly hot loop.
int mmtio_gather_rows(void* handle, const int64_t* idx, int64_t n, float* out) {
  if (!handle) return -1;
  auto* m = static_cast<Mapping*>(handle);
  const int64_t c = m->cols;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = idx[i];
    if (r < 0 || r >= m->rows) return -2;
    memcpy(out + i * c, m->data + r * c, c * sizeof(float));
  }
  return 0;
}

void mmtio_close(void* handle) {
  if (!handle) return;
  auto* m = static_cast<Mapping*>(handle);
  munmap(m->base, m->length);
  delete m;
}

}  // extern "C"

// tbevents.cc - native TensorBoard event-file writer.
//
// Replaces the reference's torch.utils.tensorboard SummaryWriter on the
// logging path (reference: agents/algorithms/rl/ppo/ppo.py:79,195-205 and
// agents/algorithms/marl/runner.py:69,257-263) with a dependency-free C++
// implementation of the tfevents on-disk format:
//
//   TFRecord framing:  u64 length | masked-crc32c(length) | payload |
//                      masked-crc32c(payload)
//   payload:           hand-encoded `Event` protobuf
//                      (wall_time=1 double, step=2 int64,
//                       file_version=3 string, summary=5 message;
//                       Summary.value=1 message; Value.tag=1 string,
//                       Value.simple_value=2 float)
//
// The masked CRC is TensorFlow's: rotr15(crc32c(x)) + 0xa282ead8.
// Little-endian host assumed (x86-64 / aarch64 Linux).
//
// Exposed via ctypes (see native/__init__.py); no protobuf / tensorboard /
// torch import needed at train time.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

namespace {

// ---------------------------------------------------------------- crc32c
uint32_t g_crc_table[256];
bool g_crc_ready = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1u) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    g_crc_table[i] = c;
  }
  g_crc_ready = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  if (!g_crc_ready) crc_init();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i)
    c = g_crc_table[(c ^ data[i]) & 0xffu] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

uint32_t masked_crc(const void* data, size_t n) {
  uint32_t crc = crc32c(static_cast<const uint8_t*>(data), n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ------------------------------------------------------- protobuf wire fmt
void put_varint(std::string& s, uint64_t v) {
  while (v >= 0x80u) {
    s.push_back(static_cast<char>(v | 0x80u));
    v >>= 7;
  }
  s.push_back(static_cast<char>(v));
}

void put_key(std::string& s, int field, int wire_type) {
  put_varint(s, (static_cast<uint64_t>(field) << 3) | wire_type);
}

void put_double(std::string& s, int field, double v) {
  put_key(s, field, 1);  // 64-bit
  s.append(reinterpret_cast<const char*>(&v), 8);
}

void put_float(std::string& s, int field, float v) {
  put_key(s, field, 5);  // 32-bit
  s.append(reinterpret_cast<const char*>(&v), 4);
}

void put_int64(std::string& s, int field, long long v) {
  put_key(s, field, 0);  // varint (two's complement for negatives)
  put_varint(s, static_cast<uint64_t>(v));
}

void put_bytes(std::string& s, int field, const char* data, size_t n) {
  put_key(s, field, 2);  // length-delimited
  put_varint(s, n);
  s.append(data, n);
}

struct TBWriter {
  FILE* f;
};

void write_record(FILE* f, const std::string& payload) {
  uint64_t len = payload.size();
  uint8_t hdr[8];
  std::memcpy(hdr, &len, 8);
  uint32_t crc_len = masked_crc(hdr, 8);
  uint32_t crc_data = masked_crc(payload.data(), payload.size());
  std::fwrite(hdr, 1, 8, f);
  std::fwrite(&crc_len, 4, 1, f);
  std::fwrite(payload.data(), 1, payload.size(), f);
  std::fwrite(&crc_data, 4, 1, f);
}

}  // namespace

extern "C" {

// Open a new event file and write the `file_version: "brain.Event:2"` header
// event.  Returns an opaque handle (nullptr on failure).
void* tb_open(const char* path, double wall_time) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  std::string ev;
  put_double(ev, 1, wall_time);
  static const char kVersion[] = "brain.Event:2";
  put_bytes(ev, 3, kVersion, sizeof(kVersion) - 1);
  write_record(f, ev);
  std::fflush(f);
  return new TBWriter{f};
}

void tb_scalar(void* h, const char* tag, float value, long long step,
               double wall_time) {
  TBWriter* w = static_cast<TBWriter*>(h);
  std::string val;  // Summary.Value
  put_bytes(val, 1, tag, std::strlen(tag));
  put_float(val, 2, value);
  std::string summary;  // Summary
  put_bytes(summary, 1, val.data(), val.size());
  std::string ev;  // Event
  put_double(ev, 1, wall_time);
  put_int64(ev, 2, step);
  put_bytes(ev, 5, summary.data(), summary.size());
  write_record(w->f, ev);
}

void tb_flush(void* h) { std::fflush(static_cast<TBWriter*>(h)->f); }

void tb_close(void* h) {
  TBWriter* w = static_cast<TBWriter*>(h);
  std::fclose(w->f);
  delete w;
}

}  // extern "C"

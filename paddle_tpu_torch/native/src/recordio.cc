// RecordIO: chunked record file format with per-chunk CRC.
//
// Reference parity: paddle/fluid/recordio/{header,chunk,writer,scanner}
// (header.h:16-30 magic + compressor enum; chunks of length-prefixed
// records, crc32-checked).  Layout per chunk:
//   u32 magic | u32 compressor(0=none) | u32 num_records | u32 payload_len
//   | u32 crc32(payload) | payload
// payload = concat of (u32 len | bytes) per record.

#include <cstdio>
#include <string>
#include <vector>

#include "common.h"

namespace {

constexpr uint32_t kMagic = 0x50544152;  // "PTAR"
constexpr size_t kChunkBytes = 1 << 20;  // flush threshold

uint32_t crc32_sw(const uint8_t* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f;
  std::string buf;
  uint32_t nrec = 0;

  void flush() {
    if (nrec == 0) return;
    uint32_t head[5] = {kMagic, 0, nrec, static_cast<uint32_t>(buf.size()),
                        crc32_sw(reinterpret_cast<const uint8_t*>(buf.data()),
                                 buf.size())};
    fwrite(head, sizeof(uint32_t), 5, f);
    fwrite(buf.data(), 1, buf.size(), f);
    buf.clear();
    nrec = 0;
  }
};

struct Scanner {
  FILE* f;
  std::vector<std::string> records;
  size_t next = 0;
  bool eof = false;

  bool load_chunk() {
    records.clear();
    next = 0;
    uint32_t head[5];
    if (fread(head, sizeof(uint32_t), 5, f) != 5) {
      eof = true;
      return false;
    }
    if (head[0] != kMagic) { eof = true; return false; }
    std::string payload(head[3], '\0');
    if (fread(&payload[0], 1, head[3], f) != head[3]) {
      eof = true;
      return false;
    }
    if (crc32_sw(reinterpret_cast<const uint8_t*>(payload.data()),
                 payload.size()) != head[4]) {
      eof = true;  // corrupt chunk: stop scanning
      return false;
    }
    size_t off = 0;
    for (uint32_t i = 0; i < head[2]; i++) {
      uint32_t len;
      memcpy(&len, payload.data() + off, 4);
      off += 4;
      records.emplace_back(payload.data() + off, len);
      off += len;
    }
    return true;
  }
};

}  // namespace

extern "C" {

void* pt_recordio_writer_open(const char* path) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int pt_recordio_write(void* h, const char* data, size_t len) {
  auto* w = static_cast<Writer*>(h);
  uint32_t l = static_cast<uint32_t>(len);
  w->buf.append(reinterpret_cast<const char*>(&l), 4);
  w->buf.append(data, len);
  w->nrec++;
  if (w->buf.size() >= kChunkBytes) w->flush();
  return 1;
}

void pt_recordio_writer_close(void* h) {
  auto* w = static_cast<Writer*>(h);
  w->flush();
  fclose(w->f);
  delete w;
}

void* pt_recordio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* s = new Scanner();
  s->f = f;
  return s;
}

// 1 = record returned (caller pt_free's *out), 0 = end of file
int pt_recordio_next(void* h, char** out, size_t* len) {
  auto* s = static_cast<Scanner*>(h);
  while (s->next >= s->records.size()) {
    if (s->eof || !s->load_chunk()) return 0;
  }
  const std::string& r = s->records[s->next++];
  *len = r.size();
  *out = static_cast<char*>(malloc(r.size() ? r.size() : 1));
  memcpy(*out, r.data(), r.size());
  return 1;
}

void pt_recordio_scanner_close(void* h) {
  auto* s = static_cast<Scanner*>(h);
  fclose(s->f);
  delete s;
}

}  // extern "C"

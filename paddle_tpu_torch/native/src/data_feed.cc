// MultiSlot text parser + shell/pipe reader.
//
// Reference parity:
//   - MultiSlotDataFeed text format (paddle/fluid/framework/data_feed.cc,
//     data_feed.h:475): each line holds, per slot in schema order,
//     "<num> <v1> ... <vnum>"; slots are float or int64 (uint64_t in the
//     reference).  Parsing is the CPU hot loop of dataset training
//     (§3.4 HogwildWorker TrainFiles), hence native.
//   - shell/popen pipe_command preprocessing (framework/io/shell.cc,
//     data_set pipe_command): a command's stdout feeds the parser.
//
// Parse result per slot: concatenated values + per-line offsets (the
// LoD/segment boundary array — SURVEY.md §7 hard part (a): ragged batches
// become values+offsets, padded later on the host).

#include <cerrno>
#include <cstdio>
#include <string>
#include <vector>

#include "common.h"

namespace {

// skip spaces/tabs; parse one double; advance p.  returns false at EOL.
inline bool next_tok(const char*& p, const char* end, double* out) {
  while (p < end && (*p == ' ' || *p == '\t')) p++;
  if (p >= end || *p == '\n' || *p == '\r') return false;
  char* q = nullptr;
  *out = strtod(p, &q);
  if (q == p) return false;
  p = q;
  return true;
}

}  // namespace

extern "C" {

// Parse `text` (many newline-separated lines) against a schema of
// num_slots slots; slot_is_float[i] selects float vs int64 storage.
//
// Outputs (all malloc'd, caller pt_free's):
//   fvals[i]  float*  buffer for float slots (else null)
//   ivals[i]  int64*  buffer for int slots (else null)
//   lods[i]   int64*  offsets, length n_lines+1 (lods[i][k] = start of
//             line k's values in the slot buffer — the LoD array)
// Returns number of lines parsed, or -1 on malformed input.
int64_t pt_multislot_parse(const char* text, size_t text_len, int num_slots,
                           const int* slot_is_float, float** fvals,
                           long long** ivals, long long** lods) {
  const char* p = text;
  const char* end = text + text_len;
  std::vector<std::vector<float>> fbuf(num_slots);
  std::vector<std::vector<long long>> ibuf(num_slots);
  std::vector<std::vector<long long>> lod(num_slots);
  for (int i = 0; i < num_slots; i++) lod[i].push_back(0);
  int64_t n_lines = 0;

  while (p < end) {
    // skip blank lines
    while (p < end && (*p == '\n' || *p == '\r')) p++;
    if (p >= end) break;
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') line_end++;
    for (int s = 0; s < num_slots; s++) {
      double num_d;
      if (!next_tok(p, line_end, &num_d)) return -1;
      int64_t num = static_cast<int64_t>(num_d);
      if (num < 0) return -1;
      for (int64_t j = 0; j < num; j++) {
        double v;
        if (!next_tok(p, line_end, &v)) return -1;
        if (slot_is_float[s])
          fbuf[s].push_back(static_cast<float>(v));
        else
          ibuf[s].push_back(static_cast<long long>(v));
      }
      lod[s].push_back(slot_is_float[s]
                           ? static_cast<long long>(fbuf[s].size())
                           : static_cast<long long>(ibuf[s].size()));
    }
    p = line_end;
    n_lines++;
  }

  for (int s = 0; s < num_slots; s++) {
    if (slot_is_float[s]) {
      size_t n = fbuf[s].size();
      fvals[s] = static_cast<float*>(malloc(n * sizeof(float) + 1));
      memcpy(fvals[s], fbuf[s].data(), n * sizeof(float));
      ivals[s] = nullptr;
    } else {
      size_t n = ibuf[s].size();
      ivals[s] = static_cast<long long*>(malloc(n * sizeof(long long) + 1));
      memcpy(ivals[s], ibuf[s].data(), n * sizeof(long long));
      fvals[s] = nullptr;
    }
    lods[s] = static_cast<long long*>(
        malloc(lod[s].size() * sizeof(long long)));
    memcpy(lods[s], lod[s].data(), lod[s].size() * sizeof(long long));
  }
  return n_lines;
}

// ---- shell / pipe_command reader (reference framework/io/shell.cc) ----

void* pt_shell_open(const char* cmd) { return popen(cmd, "r"); }

// read up to cap bytes; returns bytes read (0 = EOF)
int64_t pt_shell_read(void* f, char* buf, int64_t cap) {
  size_t n = fread(buf, 1, static_cast<size_t>(cap), static_cast<FILE*>(f));
  return static_cast<int64_t>(n);
}

int pt_shell_close(void* f) { return pclose(static_cast<FILE*>(f)); }

}  // extern "C"
